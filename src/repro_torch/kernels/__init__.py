"""Hand-written CUDA kernels for Hopper, and how they are built and routed.

Each kernel lives in a subpackage: ``csrc/*.cu`` (the CUDA C++ source with a
plain C entry point), ``kernel.py`` (the ctypes wrapper: checks, output
allocation, launch on the current stream, launch counter), ``ref.py`` (the
plain PyTorch version) and ``ops.py`` (routing).

Routing is by device, not by mode: a CUDA tensor goes to the hand kernel,
which launches or raises; a CPU or ``meta`` tensor goes to the plain
version.  There is no dispatch-mode switch and no row threshold.  A
``DTensor`` is routed by its local shard.  A ``FakeTensor`` on "cuda" (or
a DTensor over one) has no storage to launch on and is routed as ``meta``
is: the dry run traces the plain version over such stand-ins, and
records the site (``note_site``).  A DTensor over real CUDA shards takes
the kernel path, whose operand check refuses it (``check_same_cuda``):
a hand kernel works on one card's plain tensors.

Beside each kernel's launch counter, ``path_stats`` counts which body ran
per dispatch: "kernel" (the hand kernel on the card), "reference" (the
plain version on a CPU or ``meta`` tensor) or "plain_on_card" (the plain
version on the card, outside the kernel's envelope).  The enrichment
operators (core/enrich/dispatch.py) and the models' attention
(models/layers.py) record there.

Kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``_build/`` beside this file (or ``$REPRO_TORCH_BUILD_DIR``), one shared
library per source, named by a digest of the source and flags so an edit
rebuilds.  ``build_all`` compiles several sources at once, one ``nvcc``
process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# -Xptxas -v reports each kernel's registers, shared memory and spills
# (kept in CudaKernel.build_log)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# Hopper's limits the launch plans are made for: the SMs of an H100 SXM
# (the default where no card is asked) and the shared memory one block
# may use (above 48 KB only after cudaFuncSetAttribute)
SM_COUNT = 132
SMEM_BYTES = 232_448


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def on_cuda(t: torch.Tensor) -> bool:
    """The whole routing rule: CUDA tensors take the hand kernel.  A
    ``DTensor`` is routed by its local shard; a ``FakeTensor`` on "cuda"
    holds no storage and takes the plain version, as ``meta`` does."""
    if type(t) not in _PLAIN:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
    if t.device.type != "cuda":
        return False
    if type(t) in _PLAIN:
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return not isinstance(t, FakeTensor)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (read once per device)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


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
    for t in tensors:
        if type(t) not in _PLAIN:
            raise TypeError(f"kernel operands must be plain tensors on one "
                            f"card, got a {type(t).__name__} (pass a "
                            f"DTensor's local shard)")
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
        self._fns: Dict[str, ctypes._CFuncPtr] = {}  # bound at load
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
        """The loaded library, built first if need be; its entry points
        are bound once, here (``_fns`` is filled before ``_lib`` is set,
        so a reader that sees ``_lib`` sees them)."""
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.compile()))
                fns = {}
                for sym, argtypes in self.symbols.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    fns[sym] = fn
                self._fns = fns
                self._lib = lib
            return self._lib

    # ---------------------------------------------------------- launching
    def launch(self, symbol: str, device: torch.device, *args) -> None:
        """Call one C entry point on ``device``'s current stream (passed
        last), count the launch, and raise on a refused launch.  The
        device is entered only when it is not already current."""
        if self._lib is None:
            self.lib()
        fn = self._fns[symbol]
        idx = device.index
        if idx is None or idx == torch.cuda.current_device():
            err = fn(*args, _stream(device))
        else:
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
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.hash_probe import kernel as hp
    from repro_torch.kernels.segment_reduce import kernel as sr
    from repro_torch.kernels.segment_topk import kernel as st
    from repro_torch.kernels.spatial_join import kernel as sj
    return [hp.KERNEL, sj.KERNEL, sr.KERNEL, st.KERNEL, fa.KERNEL]


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


# (op, path) dispatch counters, process-wide and on a per-thread tape
# (QueryStats' kernel-vs-fallback report reads the tape)
_path_lock = threading.Lock()                # lock-name: kernel-paths
_path_hits: Dict[Tuple[str, str], int] = {}  # guarded-by: _path_lock
_tls = threading.local()                     # per-thread path tape


def note_path(op: str, path: str) -> None:
    """Count one dispatch of ``op`` by ``path``."""
    with _path_lock:
        _path_hits[(op, path)] = _path_hits.get((op, path), 0) + 1
    d: Optional[Dict] = getattr(_tls, "paths", None)
    if d is not None:
        d[(op, path)] = d.get((op, path), 0) + 1


def path_stats() -> Dict[Tuple[str, str], int]:
    """(op, path) -> dispatch count; path is "kernel", "reference" or
    "plain_on_card"."""
    with _path_lock:
        return dict(_path_hits)


def reset_path_stats() -> None:
    with _path_lock:
        _path_hits.clear()


def note_site(kernel: str) -> None:
    """Count one call of ``kernel``'s routing function (its ``ops.py``) on
    this thread's site tape, whichever body then runs."""
    d: Optional[Dict] = getattr(_tls, "sites", None)
    if d is not None:
        d[kernel] = d.get(kernel, 0) + 1


def site_tape_start() -> None:
    """Start recording this thread's hand-kernel sites."""
    _tls.sites = {}


def site_tape_stop() -> Dict[str, int]:
    """Stop this thread's site tape and return {kernel: calls}."""
    d = getattr(_tls, "sites", None) or {}
    _tls.sites = None
    return d


def path_tape_start() -> None:
    """Start recording this thread's dispatch paths."""
    _tls.paths = {}


def path_tape_stop() -> Dict[Tuple[str, str], int]:
    """Stop this thread's tape and return its (op, path) counts."""
    d = getattr(_tls, "paths", None) or {}
    _tls.paths = None
    return d
