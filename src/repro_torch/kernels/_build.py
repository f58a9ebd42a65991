"""Build and load the port's hand-written CUDA kernels.

At first use, every ``*/csrc/*.cu`` file under this package is compiled by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and the objects are linked into one shared library with a
plain C interface. The library is loaded with ``ctypes``: each C entry point
takes its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after the launch, which ``check`` turns into an
exception. The build lands in ``kernels/build/`` (listed in ``.gitignore``),
named by a hash of the sources, so a changed source is rebuilt and an
unchanged one is loaded as it is.

Nothing here runs at import: modules that import this one stay importable
without a CUDA toolkit, and ``nvcc`` is only reached when a wrapper is handed
a CUDA tensor.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches of each kernel, counted by its wrapper where it launches it
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last ``load`` spent compiling (0.0 when the library was cached)
build_seconds = 0.0
#: what ``nvcc -Xptxas -v`` printed for each source on the last build
build_log: dict[str, str] = {}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream: void*)
_SIGNATURES = {
    "nbody_repulsion_launch": [_P, _P, _P, _I, _F, _F, _P, _P],
    "grid_far_launch": [_P, _I, _P, _I, _F, _F, _P, _P],
    "neighbor_repulsion_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P,
                                  _P],
    "grid_near_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _L, _L, _I, _P],
    "flash_attention_split_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _L, _L, _I, _I, _I, _P, _P, _P,
                                     _P],
}


def sources() -> list[Path]:
    return sorted(_PKG.glob("*/csrc/*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(_PKG.glob("*/csrc/*.cu*")):
        h.update(p.relative_to(_PKG).as_posix().encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _compile(out: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    tmp = out.parent / f"{out.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, p in procs:
        log, _ = p.communicate()
        build_log[src.name] = log
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    so_tmp = tmp / out.name
    subprocess.run([nvcc, "-shared", "-o", str(so_tmp),
                    *[str(obj) for _, obj, _ in procs]],
                   check=True, capture_output=True, text=True)
    os.replace(so_tmp, out)               # atomic: readers see all or nothing
    shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f"librepro_torch_{_source_hash()}.so"
        if out.exists():
            build_seconds = 0.0
        else:
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what every kernel entry point takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def f32(x) -> float:
    """A float32-rounded Python float (kernel scalars are float32)."""
    return float(torch.tensor(float(x), dtype=torch.float32))


@functools.lru_cache(maxsize=64)
def force_consts(C, L, min_dist) -> tuple[float, float]:
    """``(C·L·L, md·md)`` rounded as float32 arithmetic rounds them — the
    two constants of the force law that every kernel and plain version
    shares. Cached: every force call of a level passes the same three
    numbers, and the wrappers' host work stays off the launch path."""
    c, l, md = (torch.tensor(float(v), dtype=torch.float32)
                for v in (C, L, min_dist))
    return float(c * l * l), float(md * md)
