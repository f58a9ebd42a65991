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
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: launches of each kernel, counted by its wrapper where it launches it
launches: collections.Counter = collections.Counter()
#: the same launches by shape: (name, lanes, n_pad, the kernel's other
#: extents) → count
shape_launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
# the counters are shared by every thread that launches; a capture in
# progress on a thread keeps that thread's launches apart (``capturing``)
_count_lock = threading.Lock()
_capture = threading.local()
_lib: ctypes.CDLL | None = None
#: seconds the last ``load`` spent compiling (0.0 when the library was cached)
build_seconds = 0.0
#: what ``nvcc -Xptxas -v`` printed for each source on the last build
build_log: dict[str, str] = {}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream: void*)
# (the force kernels take a lane count and their constants as a pointer to
# (C·L², md²) of each lane, the split-KV attention route optional pointers
# to kv_len and to the rows' log-sum-exp)
_SIGNATURES = {
    "nbody_repulsion_launch": [_P, _P, _P, _I, _I, _P, _P, _P],
    "grid_far_launch": [_P, _I, _P, _I, _I, _P, _P, _P],
    "neighbor_repulsion_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _P, _P, _P, _P],
    "grid_near_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P],
    "near_field_launch": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                          _P, _I, _P, _P, _P, _P],
    "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _L, _L, _I, _P],
    "flash_attention_split_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _L, _L, _I, _I, _I, _P, _P, _P,
                                     _P, _P, _P],
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


@functools.lru_cache(maxsize=64)
def force_consts(C, L, min_dist) -> tuple[float, float]:
    """``(C·L·L, md·md)`` rounded as float32 arithmetic rounds them — the
    two constants of the force law that every kernel and plain version
    shares. numpy float32 scalars round each product as a float32 tensor
    would, at a fraction of a tensor's host cost: the stress engine passes
    a new C on every iteration. Cached: every force call of a gila level
    passes the same three numbers."""
    c, l, md = np.float32(C), np.float32(L), np.float32(min_dist)
    return float(c * l * l), float(md * md)


def consts_tensor(C, L, min_dist, device) -> torch.Tensor:
    """The force kernels' constants as every wrapper takes them: float32[2]
    = (C·L², md²) on ``device``, rounded by ``force_consts``. The refine
    step hands the kernels a row of its schedule buffer instead."""
    return torch.tensor(force_consts(C, L, min_dist), dtype=torch.float32,
                        device=device)


def count(name: str, *shape: int) -> None:
    """One launch of kernel ``name`` at ``shape``: called by its wrapper
    where it launches the kernel, and nowhere else. Inside ``capturing`` on
    this thread the launch goes to that capture's record instead."""
    made = getattr(_capture, "made", None)
    if made is not None:
        made[0][name] += 1
        made[1][(name, *shape)] += 1
        return
    with _count_lock:
        launches[name] += 1
        shape_launches[(name, *shape)] += 1


@contextlib.contextmanager
def capturing():
    """Around a CUDA-graph capture: the wrappers called inside, on this
    thread, count their launches into a record of their own (a pair of
    ``Counter``s: by kernel, by shape), not into ``launches``, since nothing
    runs then; the record is added once per replay (``replayed``). Launches
    that other threads count meanwhile go to ``launches`` as usual."""
    made = (collections.Counter(), collections.Counter())
    outer = getattr(_capture, "made", None)
    _capture.made = made
    try:
        yield made
    finally:
        _capture.made = outer


def replayed(made: tuple) -> None:
    """Count one replay of a graph whose capture ``capturing`` counted."""
    with _count_lock:
        launches.update(made[0])
        shape_launches.update(made[1])
