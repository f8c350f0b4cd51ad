"""The native C++ PNG loader through ctypes (counterpart of
``cistar_tpu/data/native_loader.py``).

Builds the port's own copy of the source, ``cistar_tpu_torch/native/
dataloader.cpp``, at first use with the JAX package's command (``g++ -O3
-march=native -shared -fPIC … -lpng -lpthread``) into
``cistar_tpu_torch/native/build/`` (rebuilt when the source is newer), and
exposes :class:`NativePngLoader`. Without g++ or libpng the build raises,
and the callers (``data/datasets.py::make_cyclegan_dataset``) take the PIL
path. This is host data: no device and no kernel run here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       "native")
SRC = os.path.normpath(os.path.join(_NATIVE, "dataloader.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_NATIVE, "build"))
LIB_PATH = os.path.join(BUILD_DIR, "libcistar_loader.so")

# every caller's values: one grey channel, eight decode threads, and
# Normalize(0.5, 0.5) to [-1, 1]
CHANNELS, N_THREADS, MEAN, STD = 1, 8, 0.5, 0.5

_lib = None


def build() -> str:
    """The library's path, compiled first where it is missing or older
    than the source (into a temporary name, then renamed, so concurrent
    builders never load a half-written file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC)):
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", SRC,
               "-lpng", "-lpthread", "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.loader_get_batch.restype = ctypes.c_int
        lib.loader_get_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float]
        lib.loader_size.restype = ctypes.c_int
        lib.loader_size.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativePngLoader:
    """Threaded native PNG → float32 NHWC batch loader (:data:`N_THREADS`
    threads): ``(x/255 − MEAN) / STD``, bilinearly resized to ``size``²
    with half-pixel centres, PIL's grayscale conversion, one channel."""

    def __init__(self, paths: Sequence[str], size: int):
        lib = _get_lib()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._lib = lib
        self._handle = lib.loader_create(arr, len(paths), size, size,
                                         CHANNELS, N_THREADS)
        self.size = size
        self.n = len(paths)

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        bs = len(indices)
        out = np.empty((bs, self.size, self.size, CHANNELS), np.float32)
        idx = (ctypes.c_int * bs)(*[int(i) for i in indices])
        ok = self._lib.loader_get_batch(
            self._handle, idx, bs,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_float(MEAN), ctypes.c_float(STD))
        if ok != bs:
            raise IOError(f"native loader decoded {ok}/{bs} images")
        return out

    def __len__(self) -> int:
        return self.n

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.loader_destroy(self._handle)
        except Exception:
            pass
