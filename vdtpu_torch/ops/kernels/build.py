"""Build and load the hand-written CUDA kernels of the port.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface, which the op wrappers bind with ``ctypes``. Nothing
is compiled when this module is imported: the first call of ``load(name)``
builds (or finds) the library. Libraries are named by a hash of their
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source never loads a stale build, and land in ``build/kernels/`` at the
root of the checkout, which git ignores.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``chip_smoke.py`` calls it so the build is timed as its own phase.
Triton's compile cache goes to ``build/triton/`` (``use_triton_cache_dir``)
unless ``TRITON_CACHE_DIR`` is set, so nothing is written outside the
checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
TRITON_CACHE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "triton")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> (C function name, argtypes); restype is always c_int
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = {
    "flash_fwd": ("vd_flash_fwd",
                  [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _P]),
    "flash_bwd": ("vd_flash_bwd", [_P] * 10 + [_I] * 6 + [_L] * 21 + [_F, _I, _P]),
    "nomax_fwd": ("vd_nomax_fwd",
                  [_P] * 5 + [_L] + [_I] * 5 + [_L] * 12 + [_F, _I, _P]),
    "qconv3": ("vd_qconv3", [_P] * 11 + [_I] * 9 + [_L] * 13 + [_I] * 9 + [_P]),
    "resblock_q": ("vd_resblock_q", [_P] * 20 + [_I] * 6 + [_F] + [_L] * 10 + [_I] * 9 + [_P]),
    "probe_s8mm": ("vd_probe_s8mm", [_P] * 3 + [_I] * 4 + [_P]),
    "gn_silu": ("vd_gn_silu", [_P] * 6),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source name -> nvcc output (registers, spills)


def use_triton_cache_dir() -> None:
    """Call before importing triton: keep its cache inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", TRITON_CACHE_DIR)


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with "
                       "the card (CUDA toolkit under $CUDA_HOME or /usr/local/cuda)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc(name: str) -> subprocess.Popen | None:
    """Start nvcc for one source unless its library exists; returns the process."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]


def build_all() -> None:
    """Compile every source in parallel (one nvcc each) and load the results."""
    with _lock:
        procs = {name: _nvcc(name) for name in SOURCES if name not in _loaded}
        for name, proc in procs.items():
            _finish(name, proc)
            _loaded[name] = _bind(name)


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_lib_path(name))
    fn_name, argtypes = SOURCES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            if name not in _loaded:
                _finish(name, _nvcc(name))
                _loaded[name] = _bind(name)
            lib = _loaded[name]
    return lib
