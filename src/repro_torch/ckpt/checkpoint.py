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

``restore(..., shardings=)`` is ``repro``'s reshard-on-restore, the
elastic restart path: each leaf goes onto its ``NamedSharding``'s mesh
as a DTensor of which every rank holds its own slice, cut from the full
leaf it read (no collective); a rank holds one whole leaf at a time.
``restore(..., device=)`` places whole leaves on one device.  A state of
DTensors is saved as full leaves, one at a time: every rank gathers the
leaf (``full_tensor()``, a collective), rank 0 writes it, and the next
leaf is gathered only then, so a rank's peak is one whole leaf on the
device and on the host; the others wait at a barrier until the step is
committed.  ``AsyncCheckpointer`` copies a plain state to host memory
and writes it on a background thread; a state of DTensors it saves
synchronously, leaf by leaf (the gathers are collectives every rank
makes on its own thread, and a host copy of the whole state is what
the bound excludes).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models.params import (is_bf16_numpy, tensor_to_numpy,
                                       tree_flatten, tree_map,
                                       tree_unflatten, treedef_str)
from repro_torch.models.sharding import cut_to_shard

BF16_DESCR = "<V2"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _host(x) -> np.ndarray:
    """A leaf as host numpy; a DTensor is gathered whole first (a
    collective: every rank of its mesh calls it)."""
    if _is_dtensor(x):
        x = x.full_tensor()
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _writes(state: Any) -> Tuple[bool, bool]:
    """(the state is on a mesh, this process writes it): on a mesh only
    rank 0 writes."""
    import torch.distributed as dist
    meshed = any(_is_dtensor(x) for x in tree_flatten(state)[0])
    return meshed, not meshed or dist.get_rank() == 0


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
    ``state``'s leaves are tensors, DTensors or numpy arrays; a state on
    a mesh is gathered leaf by leaf on every rank, written by rank 0,
    and every rank returns once it is committed."""
    meshed, writer = _writes(state)
    if not meshed:
        return _save_host(directory, step, state, keep)
    import torch.distributed as dist
    try:
        _save_host(directory, step, state, keep, write=writer)
    finally:
        dist.barrier()
    return os.path.join(directory, f"step_{step:08d}")


def _save_host(directory: str, step: int, state: Any, keep: int,
               write: bool = True) -> str:
    """Write ``state`` leaf by leaf, each made host numpy (gathered, on a
    mesh) just before it is written; with ``write`` False only the
    gathers run (a rank of a mesh other than 0)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if write:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    leaves, struct = tree_flatten(state)
    manifest = {"step": step, "treedef": treedef_str(struct), "leaves": []}
    for i, leaf in enumerate(leaves):
        if not write:
            if _is_dtensor(leaf):
                leaf.full_tensor()          # this rank's part of the gather
            continue
        arr = _host(leaf)
        dtype = _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({
            "shape": list(arr.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()),
        })
        del arr
    if not write:
        return final
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
            device: DeviceLike = None, shardings: Optional[Any] = None
            ) -> Any:
    """Restore into the structure of ``like`` (tensors, ``meta`` tensors
    or TensorSpecs), each leaf in its target's dtype.  Verifies crc32s.
    With ``shardings`` (a tree of ``NamedSharding``s of the same
    structure) every leaf becomes a DTensor on its mesh, this rank
    holding its slice of it: the elastic restart path.  Otherwise leaves
    go to ``device``; with None, to their target's device (a ``meta``
    tensor or a TensorSpec has none: the card)."""
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
    shard_leaves = (tree_flatten(shardings)[0] if shardings is not None
                    else [None] * len(leaves_like))
    if len(shard_leaves) != len(leaves_like):
        raise ValueError(f"{len(shard_leaves)} shardings for "
                         f"{len(leaves_like)} leaves")

    out = []
    for i, (meta, tgt, shd) in enumerate(
            zip(manifest["leaves"], leaves_like, shard_leaves)):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"checksum mismatch in leaf {i} of {path}")
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != "
                f"target {tuple(tgt.shape)}")
        if shd is not None:
            full = _to_tensor(arr, tgt.dtype,
                              resolve_device(shd.mesh.device_type))
            del arr
            out.append(cut_to_shard(full, shd))
            del full
            continue
        dev = fixed
        if dev is None:
            on = getattr(tgt, "device", None)
            dev = on if on is not None and on.type != "meta" \
                else resolve_device(None)
        out.append(_to_tensor(arr, tgt.dtype, dev))
    return tree_unflatten(struct, out)


class AsyncCheckpointer:
    """Background-thread checkpointing (overlaps IO with compute); a
    state of DTensors is saved synchronously, leaf by leaf (``save``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.saves = 0

    def save(self, step: int, state: Any) -> None:
        self.wait()
        self.saves += 1
        if _writes(state)[0]:
            save(self.directory, step, state, self.keep)
            return
        # snapshot to host before returning control to the train loop
        host = tree_map(_host, state)

        def run():
            try:
                _save_host(self.directory, step, host, self.keep)
            except BaseException as e:
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Until the last save is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
