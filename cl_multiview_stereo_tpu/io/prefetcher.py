"""Native multi-scene prefetching executor.

Streams camera-array scenes through the C++ background decoder
(native/loader.cc ``mvs_prefetcher_*``): while the accelerator computes
scene ``i``, the host thread pool is already decoding scenes ``i+1..i+d``.
The reference blocks its main thread on synchronous loads
(``clMVDE/pipeline.cpp:12``, ``file_handler.cpp:30-57``); this is the
streaming-runtime replacement for production multi-scene serving.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Sequence

import numpy as np

from cl_multiview_stereo_tpu.io.images import load_image, read_image_list


def _lib():
    from cl_multiview_stereo_tpu.io.native_loader import _load

    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib, "_prefetcher_bound"):
        lib.mvs_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mvs_prefetcher_create.restype = ctypes.c_void_p
        lib.mvs_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.mvs_prefetcher_next.restype = ctypes.c_int
        lib.mvs_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        lib.mvs_prefetcher_destroy.restype = None
        lib._prefetcher_bound = True
    return lib


class ScenePrefetcher:
    """Iterate (scene_index, (V, H, W, 3) uint8) with background decoding.

    ``scenes``: list of per-scene image-path lists (all images h x w, all
    scenes the same view count).  ``depth``: scenes decoded ahead.
    Falls back to synchronous loading through the numpy PNG codec when the
    native library is unavailable.
    """

    def __init__(
        self,
        scenes: Sequence[Sequence[str]],
        h: int,
        w: int,
        *,
        depth: int = 2,
        threads: int | None = None,
    ):
        self.scenes = [list(s) for s in scenes]
        self.h, self.w = h, w
        self.views = len(self.scenes[0]) if self.scenes else 0
        for s in self.scenes:
            if len(s) != self.views:
                raise ValueError("all scenes must have the same view count")
        self._lib = _lib()
        self._handle = None
        self._flat = None
        if self._lib is not None and self.scenes:
            flat = [p for s in self.scenes for p in s]
            offsets = np.zeros(len(self.scenes) + 1, np.int32)
            np.cumsum([len(s) for s in self.scenes], out=offsets[1:])
            self._flat = (ctypes.c_char_p * len(flat))(
                *[p.encode() for p in flat]
            )
            self._offsets = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
            self._offsets_arr = offsets  # keep alive
            nthreads = threads or min(self.views, os.cpu_count() or 1)
            self._handle = self._lib.mvs_prefetcher_create(
                self._flat, self._offsets, len(self.scenes), h, w,
                depth, nthreads,
            )

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        if self._handle is None:  # synchronous fallback
            for i, s in enumerate(self.scenes):
                yield i, np.stack([load_image(p) for p in s])
            return
        for _ in range(len(self.scenes)):
            out = np.empty((self.views, self.h, self.w, 3), np.uint8)
            rc = self._lib.mvs_prefetcher_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            )
            if rc == -1:
                return
            if rc < -1:
                bad = -(rc + 1) - 100
                raise IOError(f"prefetcher: decode failed (image {bad})")
            yield rc, out

    def close(self) -> None:
        if self._handle is not None and self._lib is not None:
            self._lib.mvs_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_scenes(pipe, scene_lists: Sequence[str], *, depth: int = 2):
    """Streaming executor: decode ahead with the native prefetcher while the
    jitted pipeline runs each scene on-device.  ``scene_lists`` are data.txt
    paths; yields (scene_index, PipelineArtifacts)."""
    scenes = [read_image_list(p) for p in scene_lists]
    fwd = pipe.jitted()
    with ScenePrefetcher(
        scenes, pipe.geom.img_h, pipe.geom.img_w, depth=depth
    ) as pf:
        for idx, rgb in pf:
            yield idx, fwd(rgb)
