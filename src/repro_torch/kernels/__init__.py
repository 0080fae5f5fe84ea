"""Hand-written CUDA kernels for Hopper, and how they are built and routed.

Each kernel lives in a subpackage: ``csrc/*.cu`` (the CUDA C++ source with a
plain C entry point), ``kernel.py`` (the ctypes wrapper: checks, output
allocation, launch on the current stream, launch counter), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (routing).

Routing is by device, not by mode: a CUDA tensor goes to the hand kernel,
which launches or raises; a CPU or ``meta`` tensor goes to the plain
version.  There is no dispatch-mode switch and no row threshold.

Kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``_build/`` beside this file (or ``$REPRO_TORCH_BUILD_DIR``), one shared
library per source, named by a digest of the source and flags so an edit
rebuilds.  ``build_all`` compiles several sources at once, one ``nvcc``
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

# -Xptxas -v reports each kernel's registers, shared memory and spills
# (kept in CudaKernel.build_log)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def on_cuda(t: torch.Tensor) -> bool:
    """The whole routing rule: CUDA tensors take the hand kernel."""
    return t.device.type == "cuda"


def build_dir() -> Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(d) if d else Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                       "first use and need the CUDA toolkit")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_same_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"kernel operands on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel operands must be on a CUDA device, "
                         f"got {dev}")
    return dev


class CudaKernel:
    """One ``.cu`` source: its build, its C entry points and its launch
    counter.  ``symbols`` maps each exported C function to its ctypes
    argument types; every entry point returns ``cudaGetLastError()``."""

    def __init__(self, name: str, source: Path,
                 symbols: Dict[str, Sequence]):
        self.name = name
        self.source = Path(source)
        self.symbols = dict(symbols)
        self._lib = None
        self.build_log = ""
        self._lock = threading.Lock()  # lock-name: kernel-build blocking-ok
        self._count_lock = threading.Lock()  # lock-name: kernel-count
        self._launches = 0                   # guarded-by: _count_lock

    # ----------------------------------------------------------- building
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_dir() / f"{self.name}-{h.hexdigest()[:16]}.so"

    def compile(self) -> Path:
        """nvcc the source into its shared library unless already built.
        Safe across processes: the library is written under a temporary
        name and renamed into place."""
        so = self.library_path()
        if so.exists():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building kernel {self.name} failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        os.replace(tmp, so)
        return so

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.compile()))
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    # ---------------------------------------------------------- launching
    def launch(self, symbol: str, device: torch.device, *args) -> None:
        """Call one C entry point on ``device``'s current stream (passed
        last), count the launch, and raise on a refused launch."""
        fn = getattr(self.lib(), symbol)
        with torch.cuda.device(device):
            err = fn(*args, _stream(device))
        with self._count_lock:
            self._launches += 1
        if err != 0:
            raise RuntimeError(f"kernel {self.name}.{symbol} launch "
                               f"failed: CUDA error {err}")

    @property
    def launches(self) -> int:
        with self._count_lock:
            return self._launches

    def reset_launches(self) -> None:
        with self._count_lock:
            self._launches = 0


def all_kernels() -> List[CudaKernel]:
    """Every hand kernel of the port (imports are local: importing this
    package must not import the kernel wrappers)."""
    from repro_torch.kernels.hash_probe import kernel as hp
    from repro_torch.kernels.segment_reduce import kernel as sr
    from repro_torch.kernels.spatial_join import kernel as sj
    return [hp.KERNEL, sj.KERNEL, sr.KERNEL]


_build_all_lock = threading.Lock()   # lock-name: kernel-build-all blocking-ok
# feedlint: order kernel-build-all -> kernel-build


def build_all(kernels: Sequence[CudaKernel] = ()) -> List[Path]:
    """Compile every kernel source at once, one nvcc process each, then
    load them.  Raises on the first failed build.  Concurrent callers
    (feed workers) wait for one build instead of racing their own."""
    ks = list(kernels) or all_kernels()
    with _build_all_lock:
        with ThreadPoolExecutor(max_workers=len(ks)) as pool:
            paths = list(pool.map(lambda k: k.compile(), ks))
        for k in ks:
            k.lib()
    return paths


def reset_launch_counts() -> None:
    for k in all_kernels():
        k.reset_launches()


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in all_kernels()}
