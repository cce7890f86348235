"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled on first use by `nvcc` for `sm_90a` into
its own shared library with a plain C interface, which `ctypes` loads. Every
exported function launches on the stream it is given and returns
`cudaGetLastError()`; `CudaKernel.launch` raises on a non-zero code. A build
that fails, or a missing `nvcc`, raises: nothing falls back to the plain
PyTorch versions.

Libraries land in `csrc/build/` under a name that carries a digest of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header never loads a stale build. Several
sources build in parallel, one `nvcc` process each (`build`).

Host code of `csrc/` (the resident packer, `flowpack.cc` with
`records.h`) builds the same way with the host C++ compiler
(`build_host`: `g++ -O2 -std=c++17 -shared -fPIC`), keyed on a digest of
the source, the host headers (`csrc/*.h`) and the flags; a missing
compiler or a failed build raises as well.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

#: shared memory one block may use on sm_90 (bytes)
SMEM_LIMIT = 232448

_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchShape(NamedTuple):
    """Grid of a cluster kernel: `clusters` clusters of `cluster` CTAs of
    `threads` threads, each with `smem` bytes of dynamic shared memory."""

    clusters: int
    cluster: int
    threads: int
    smem: int


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def lib_path(source: str) -> Path:
    """Build output of one source, named by a digest of the source, every
    shared header and the flags."""
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources: list[str]) -> dict[str, float]:
    """Compile every source whose library is missing, all at once (one nvcc
    process each, started together). Returns the seconds each build took
    (0.0 for a library that was already there). Raises with the compiler's
    output if any build fails."""
    todo = [s for s in sources if not lib_path(s).exists()]
    secs = {s: 0.0 for s in sources}
    if not todo:
        return secs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        out = lib_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[s] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for s, (p, tmp, out, log) in procs.items():
        rc = p.wait()
        log.close()
        secs[s] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{s} (nvcc rc={rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return secs


def gxx_path() -> str:
    """The host C++ compiler: $CXX (a name on PATH or a path), else g++ on
    PATH."""
    want = os.environ.get("CXX") or "g++"
    found = shutil.which(want)
    if found is None:
        raise RuntimeError(f"host C++ compiler {want!r} not found (set CXX "
                           "or put g++ on PATH); the packer cannot be built")
    return found


def host_lib_path(source: str) -> Path:
    """Build output of one host source, named by a digest of the source,
    every host header and the flags."""
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.h")):
        h.update(header.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_host(source: str) -> Path:
    """Compile a host C++ source of csrc/ with `gxx_path()` unless its
    library is already built; return the library's path. Raises if there
    is no compiler, and with the compiler's output if the build fails."""
    out = host_lib_path(source)
    if out.exists():
        return out
    cxx = gxx_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp),
                           str(CSRC / source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {source} failed ({cxx} rc="
                           f"{proc.returncode}):\n"
                           + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, out)
    return out


def _load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(lib_path(source)))
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One exported C function of a kernel library, with its launch count.

    `launches` rises by one each time `launch` runs the function, and
    nowhere else; callers reset it by assignment. A captured CUDA graph
    (`sketch/capture.py`) takes back the launches its capture counted and
    adds them again at every replay, so the count stays the launches run.
    `instances` lists every kernel made, for that bookkeeping."""

    instances: list["CudaKernel"] = []

    def __init__(self, source: str, symbol: str, n_ptrs: int, n_ints: int):
        CudaKernel.instances.append(self)
        self.source = source
        self.symbol = symbol
        #: argument order of every kernel: pointers, ints, then the stream
        self.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                         + [ctypes.c_void_p])
        self.launches = 0
        self._fn = None

    def load(self) -> None:
        """Build the library if need be, load it and resolve the function;
        raises if it cannot."""
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def launch(self, ptrs: list[torch.Tensor], ints: list[int],
               device: torch.device) -> None:
        self.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*[t.data_ptr() for t in ptrs], *ints, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1


def load_all() -> None:
    """Build every kernel's library (the missing ones in parallel, `build`)
    and load each kernel: an exporter calls it when it makes a ring on a
    CUDA device, so a kernel that cannot build or load raises there, and
    never inside a fold, whose failures the exporter contains."""
    build(sorted({k.source for k in CudaKernel.instances}))
    for k in CudaKernel.instances:
        k.load()


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` — the kernels read raw pointers and trust all four."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, raise otherwise: the
    wrappers take the plain version only for a tensor on the CPU."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
