"""ctypes binding of the native tar reader (``tario.cpp``).

The library is built with ``g++`` at first use, never at import, into
``build/native/`` at the root of the checkout (git ignores it), named by a
hash of the source so an edited source never loads a stale build. A failed
build raises with g++'s log: nothing falls back to another reader here
(``webdataset.tar_samples(use_native=False)`` is the one way to the
standard library's ``tarfile``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tario.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
                         "build", "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtario-{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises with g++'s output if
    the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                                      capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("the native tar reader needs g++ to build "
                                   "(use_native=False reads with tarfile)") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for tario.cpp (rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.tario_open.restype = ctypes.c_void_p
        lib.tario_open.argtypes = [ctypes.c_char_p]
        lib.tario_count.restype = ctypes.c_int64
        lib.tario_count.argtypes = [ctypes.c_void_p]
        lib.tario_name.restype = ctypes.c_char_p
        lib.tario_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_size.restype = ctypes.c_int64
        lib.tario_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_read.restype = ctypes.c_int64
        lib.tario_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.tario_close.restype = None
        lib.tario_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeTarReader:
    """Indexed access to the members of one tar shard."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.tario_open(os.fsencode(path))
        if not self._h:
            raise FileNotFoundError(path)

    def __len__(self) -> int:
        return int(self._lib.tario_count(self._h))

    def name(self, i: int) -> str:
        return self._lib.tario_name(self._h, i).decode()

    def read(self, i: int) -> bytes:
        n = int(self._lib.tario_size(self._h, i))
        buf = ctypes.create_string_buffer(n)
        got = self._lib.tario_read(self._h, i, buf, n)
        if got != n:
            raise IOError(f"short read on member {i}")
        return buf.raw

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tario_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        self.close()
