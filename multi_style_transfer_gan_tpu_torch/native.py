"""ctypes bindings of the repo's native host library (``native/mstgan_native.cpp``,
built by ``make -C native``): the port's own copy of what its batch pipeline
uses, so that it imports nothing of the JAX package.

- ``load_library()``: the library with the argtypes of the batch decode
  (``mstgan_decode_canvas_batch``) and save (``mstgan_save_canvas_batch``)
  entry points, building it on first use; None where it does not build
  (no compiler or no libjpeg/libpng headers), and the pipeline then decodes
  and saves with PIL on the host.
- ``available()``: whether it loaded.
- ``save_canvas_batch(...)``: aspect crop, resize back and encode of many
  stylized canvases.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmstgan_native.so")


def _build() -> bool:
    """``make -C native``; False when make is missing, fails or hangs."""
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_SO_PATH)


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        if not os.path.exists(_SO_PATH) and not _build():
            _LIB = False
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _LIB = False
            return None
        lib.mstgan_decode_canvas_batch.restype = ctypes.c_int
        lib.mstgan_decode_canvas_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint8, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.mstgan_save_canvas_batch.restype = ctypes.c_int
        lib.mstgan_save_canvas_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    return load_library() is not None


def save_canvas_batch(batch: np.ndarray, sizes, paths, quality: int = 95,
                      num_threads: int = 4):
    """Save many stylized canvases: aspect crop, resize back to the original
    size when it is <= 1 MP, JPEG/PNG encode (``restore_aspect``'s
    semantics), all native. Returns a bool array; False entries (extensions
    it does not write, unwritable paths) go through the PIL save path. None
    if the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    n = len(paths)
    batch = np.ascontiguousarray(batch, np.uint8)
    if batch.shape[0] != n or batch.shape[3] != 3:
        raise ValueError(f"batch {batch.shape} does not match {n} RGB paths")
    canvas = batch.shape[1]
    whs = np.ascontiguousarray(np.asarray(sizes, np.int32).reshape(n, 2))
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.mstgan_save_canvas_batch(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, canvas,
        whs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), arr, quality,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return ok.astype(bool)
