"""Crash-consistent checkpointing in ``repro.ckpt``'s layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_<N>/
        MANIFEST.json     tree structure, shapes, dtypes, crc32s
        leaf_<i>.npy      one file per leaf, in JAX's leaf order

Everything is written into ``step_<N>.tmp`` and the directory is renamed
by ``os.replace``: ``latest_step`` only ever sees committed directories.
Every leaf carries the crc32 of its bytes, checked on restore; the newest
``keep`` steps are kept.

bfloat16 leaves are written as ``repro`` writes them: 2-byte words under
the descriptor ``'<V2'`` (what ``np.save`` records for an ml_dtypes
bfloat16 array).  They are read back through the target's dtype (the
words as ``torch.bfloat16``), so neither side needs ``ml_dtypes``.
``repro``'s own ``restore`` cannot cast such a leaf back (ROADMAP Queue
3); float32 and integer checkpoints cross both ways.

``restore(..., device=)`` takes the place of ``repro``'s ``shardings``:
the port runs one device.  ``AsyncCheckpointer`` copies the state to
host memory and writes it on a background thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.params import (is_bf16_numpy, tensor_to_numpy,
                                       tree_flatten, tree_map,
                                       tree_unflatten, treedef_str)

BF16_DESCR = "<V2"


def _host(x) -> np.ndarray:
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _write_leaf(path: str, arr: np.ndarray) -> str:
    """np.save, with a bfloat16 array's header as ``repro``'s; returns
    the manifest's dtype string."""
    if is_bf16_numpy(arr):
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        return BF16_DESCR
    np.save(path, arr)
    return arr.dtype.str


def save(directory: str, step: int, state: Any, keep: int = 3) -> str:
    """Synchronous checkpoint save with atomic commit. Returns the path.
    ``state``'s leaves are tensors or numpy arrays."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, struct = tree_flatten(state)
    manifest = {"step": step, "treedef": treedef_str(struct), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        dtype = _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()),
        })
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit

    # retention
    steps = sorted(all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "MANIFEST.json")):
                out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A leaf's array as ``dtype`` on ``device``: 2-byte words are
    bfloat16, cast from there if the target is another dtype."""
    if is_bf16_numpy(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def restore(directory: str, like: Any, step: Optional[int] = None,
            device: DeviceLike = None) -> Any:
    """Restore into the structure of ``like`` (tensors, ``meta`` tensors
    or TensorSpecs), each leaf in its target's dtype.  Verifies crc32s.
    Leaves go to ``device``; with None, to their target's device (a
    ``meta`` tensor or a TensorSpec has none: the card)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)

    leaves_like, struct = tree_flatten(like)
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target structure has {len(leaves_like)}")
    fixed = resolve_device(device) if device is not None else None

    out = []
    for i, (meta, tgt) in enumerate(zip(manifest["leaves"], leaves_like)):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"checksum mismatch in leaf {i} of {path}")
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != "
                f"target {tuple(tgt.shape)}")
        dev = fixed
        if dev is None:
            on = getattr(tgt, "device", None)
            dev = on if on is not None and on.type != "meta" \
                else resolve_device(None)
        out.append(_to_tensor(arr, tgt.dtype, dev))
    return tree_unflatten(struct, out)


class AsyncCheckpointer:
    """Background-thread checkpointing (overlaps IO with compute)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.saves = 0

    def save(self, step: int, state: Any) -> None:
        self.wait()
        # snapshot to host before returning control to the train loop
        host = tree_map(_host, state)

        def run():
            try:
                save(self.directory, step, host, self.keep)
            except BaseException as e:
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self.saves += 1

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
