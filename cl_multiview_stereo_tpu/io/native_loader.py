"""ctypes wrapper over the native C++ batch image loader.

``load_image_array_native`` is a drop-in replacement for
``images.load_image_array`` that decodes the whole camera array with a C++
thread pool (PNG via libpng, JPEG via libjpeg).  The library is compiled
at first use; when that fails, the failure is reported once and loading
goes through ``images.load_image_array`` (the numpy PNG codec) instead.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

from cl_multiview_stereo_tpu.io.images import load_image_array, read_image_list

_lib = None
_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    from cl_multiview_stereo_tpu.native.build import ensure_built

    try:
        lib = ctypes.CDLL(ensure_built())
    except (RuntimeError, OSError) as e:
        _failed = True
        print(
            f"native image loader unavailable, using the numpy PNG codec: {e}",
            file=sys.stderr,
        )
        return None
    lib.mvs_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mvs_probe.restype = ctypes.c_int
    lib.mvs_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mvs_load_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_image_array_native(
    list_path: str, view_num: int | None = None, threads: int | None = None
) -> np.ndarray:
    """Load (V, H, W, 3) uint8 RGB via the C++ loader; numpy codec when the
    library could not be built."""
    lib = _load()
    if lib is None:
        return load_image_array(list_path, view_num)
    paths = read_image_list(list_path, view_num)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mvs_probe(paths[0].encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"probe failed ({rc}) for {paths[0]}")
    n = len(paths)
    out = np.empty((n, h.value, w.value, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    nthreads = threads if threads is not None else min(n, os.cpu_count() or 1)
    rc = lib.mvs_load_batch(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h.value,
        w.value,
        nthreads,
    )
    if rc != 0:
        idx = rc - 100
        raise IOError(
            f"native decode failed for {paths[idx] if 0 <= idx < n else rc}"
        )
    return out
