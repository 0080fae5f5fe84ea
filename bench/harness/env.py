"""Where the benchmark runs: the checkout's root, the caches it keeps
inside the checkout, the modules a run may not load, and the card.

Every path is fixed relative to the checkout, so a second run in the same
checkout finds the kernels the first one built.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SRC = ROOT / "src"
PORT = "repro_torch"

# fixed cache directories inside the checkout (gitignored)
BUILD_DIR = BENCH / "_build" / "kernels"
TRITON_DIR = BENCH / "_build" / "triton"

# top-level module names a run may not hold: JAX, the JAX package the
# port was made from, and the JAX package's benchmarks.  Compared whole:
# "repro_torch" is not "repro".
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare() -> None:
    """Point the port's nvcc builds and any Triton cache into the
    checkout, and put the port's sources on the path.  Raises where the
    checkout holds no port (a directory of the benchmark alone)."""
    if not (SRC / PORT / "__init__.py").is_file():
        raise RuntimeError(f"no {PORT} package under {SRC}: the benchmark "
                           "runs from a checkout of the whole repository")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    TRITON_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD_DIR)
    os.environ["TRITON_CACHE_DIR"] = str(TRITON_DIR)
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    """Raise unless CUDA is there with at least ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the benchmark measures "
                           "the card and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"the cell asks for {n} cards, "
                           f"{torch.cuda.device_count()} are visible")


def device_record(dev, chips: int) -> Dict:
    """The result's ``device`` entry (peak memory read by the caller)."""
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}
