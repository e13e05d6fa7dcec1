"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``.  The build happens at first
use, into ``build/kernels/`` at the root of the checkout, from the repo's
sources and nothing else; a library is named by the content hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source or
header rebuilds and an unchanged one is reused.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("moe_gmm", "moe_decode", "flash_decode_paged", "flash_attention",
           "flash_decode", "moe_gmm_quant", "moe_decode_quant",
           "flash_decode_paged_mla", "moe_ffn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
#: nvcc's output of the last build of each source (register / smem report)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in SOURCES}
    err = None
    for n, p in procs.items():
        try:
            _finish(n, p)
        except RuntimeError as e:       # wait for the rest before raising
            err = err or e
    if err is not None:
        raise err
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        _finish(name, _start(name))
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def function(name: str, fn: str, n_ptrs: int, n_ints: int,
             n_floats: int = 0):
    """C function ``int fn(void* x n_ptrs, int x n_ints, float x n_floats,
    void* stream)`` of ``csrc/<name>.cu``, declared once (every pointer and
    the stream as ``c_void_p``, so ctypes never truncates them to 32
    bits)."""
    if fn not in _FNS:
        f = getattr(load(name), fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                      + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FNS[fn] = f
    return _FNS[fn]


def check(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
