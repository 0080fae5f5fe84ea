"""Parameterized predeployed jobs (§6.1) for the PyTorch port.

The paper compiles the computing job's query plan once, distributes the job
specification to the cluster, and then *invokes* it per batch with only the
new batch as a parameter.  PyTorch runs eagerly, so here a "compile" is the
first use of a (job name, function, operand signature) key: the callable is
resolved and the hand kernels of the operands' device are built (nvcc runs
once per process and source, see repro_torch/kernels).  Later invocations
with the same key go straight to the function.  The counters keep the
reference's contract: a fused chain is ONE apply entry per shape, invoked
per batch.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Depth-first leaves of nested dicts / tuples / lists, returning the
    structure as a string (the role of a pytree's treedef)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        inner = ",".join(f"{k!r}:{_flatten(tree[k], leaves)}" for k in keys)
        return "{" + inner + "}"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(x, leaves) for x in tree)
        return ("(" if isinstance(tree, tuple) else "[") + inner + \
            (")" if isinstance(tree, tuple) else "]")
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def tree_signature(tree: Any) -> Tuple:
    """Hashable (shape, dtype, device) signature of a nested operand tree."""
    leaves: List[Any] = []
    structure = _flatten(tree, leaves)

    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype), x.device.type)
        if hasattr(x, "shape"):
            return (tuple(x.shape), np.dtype(x.dtype).str)
        return (type(x).__name__, repr(x))

    return (tuple(sig(x) for x in leaves), structure)


def _devices(tree: Any) -> List[torch.device]:
    leaves: List[Any] = []
    _flatten(tree, leaves)
    return list({x.device: None for x in leaves
                 if isinstance(x, torch.Tensor)})


class PredeployCache:
    """Entry cache keyed by (job name, function, operand signature)."""

    def __init__(self):
        self._cache: Dict[Tuple, Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()        # lock-name: predeploy
        self.compiles = 0                    # guarded-by: _lock
        self.invocations = 0                 # guarded-by: _lock
        self.compile_s = 0.0                 # guarded-by: _lock
        # per-job-name breakdown: tests pin down that a fused chain is ONE
        # apply entry (one compile per shape) instead of one per stage
        self.by_name: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock

    def _name_stats(self, name: str) -> Dict[str, int]:  # requires-lock: _lock
        s = self.by_name.get(name)
        if s is None:
            s = self.by_name[name] = {"compiles": 0, "invocations": 0}
        return s

    def get(self, name: str, fn: Callable, *operands: Any):
        """Return the entry for ``fn`` at these operand shapes, preparing
        (and 'predeploying') it on first use: on a CUDA device that builds
        every hand kernel, so no batch ever pays an nvcc run.

        The key includes ``fn`` itself, not just ``name``: plan-built
        stages (filters, fused chains) are user closures under auto-
        generated names, and two different predicates that happen to share
        a name must NOT share an entry."""
        key = (name, fn, tree_signature(operands))
        with self._lock:
            exe = self._cache.get(key)
        if exe is not None:
            return exe
        t0 = time.perf_counter()
        if any(d.type == "cuda" for d in _devices(operands)):
            from repro_torch.kernels import build_all
            build_all()
        dt = time.perf_counter() - t0
        with self._lock:
            exe = self._cache.setdefault(key, fn)
            self.compiles += 1
            self.compile_s += dt
            self._name_stats(name)["compiles"] += 1
        return exe

    def invoke(self, name: str, fn: Callable, *operands: Any):
        exe = self.get(name, fn, *operands)
        with self._lock:
            self.invocations += 1
            self._name_stats(name)["invocations"] += 1
        return exe(*operands)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"compiles": self.compiles,
                    "invocations": self.invocations,
                    "compile_s": round(self.compile_s, 3)}
