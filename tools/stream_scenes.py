"""Multi-scene streaming throughput.

Streams N scenes through the native C++ prefetcher (io/prefetcher.py:
background thread-pool decode of scene i+1..i+d while the accelerator runs
scene i) and the single-jit pipeline — optionally GSPMD view-sharded over a
mesh (parallel/sharded_pipeline.py; across hosts the (host, view) mesh of
parallel/distributed.make_host_view_mesh drops in, with scene granularity
on the host axis).  The reference blocks its main thread on synchronous
OpenCV loads per scene (clMVDE/pipeline.cpp:12, file_handler.cpp:30-57).

Usage:
  python tools/stream_scenes.py data.txt --repeat 4
  python tools/stream_scenes.py list1.txt list2.txt ... [--mesh N] [--depth 2]

Prints ONE JSON line: scenes, total wall, views/s, MP/s.  With --repeat the
input scene is re-queued R times, each copy with one pixel changed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("lists", nargs="+", help="data.txt-style image lists")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--depth", type=int, default=2, help="prefetch depth")
    ap.add_argument("--mesh", type=int, default=0,
                    help="GSPMD view-shard over N devices (0 = unsharded)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.io.images import load_image, read_image_list
    from cl_multiview_stereo_tpu.io.prefetcher import ScenePrefetcher
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline

    scene_lists = [read_image_list(p) for p in args.lists] * args.repeat
    first = load_image(scene_lists[0][0])
    h, w = first.shape[:2]
    s = SystemSettings()
    if len(scene_lists[0]) != s.view_num:
        raise SystemExit(
            f"scene has {len(scene_lists[0])} views, settings expect {s.view_num}"
        )
    pipe = MVSPipeline.create(w, h, s)

    if args.mesh:
        from cl_multiview_stereo_tpu.parallel.mesh import make_mesh
        from cl_multiview_stereo_tpu.parallel.sharded_pipeline import (
            sharded_pipeline_fn,
        )

        mesh = make_mesh(
            n_view=args.mesh, n_disp=1, devices=jax.devices()[: args.mesh]
        )
        fwd_full = sharded_pipeline_fn(pipe, mesh)
        pull = lambda out: float(jnp.sum(out.ravel()[::4096]))
    else:
        fwd_full = pipe.jitted()
        pull = lambda art: float(jnp.sum(art.disp_full.ravel()[::4096]))

    # warmup/compile on the first scene (not timed)
    rgb0 = np.stack([load_image(p) for p in scene_lists[0]])
    pull(fwd_full(jnp.asarray(rgb0)))

    n_done = 0
    t0 = time.perf_counter()
    with ScenePrefetcher(scene_lists, h, w, depth=args.depth) as pf:
        for idx, rgb in pf:
            # one-pixel perturbation so repeated scenes are distinct inputs
            rgb = jnp.asarray(rgb).at[0, idx % h, idx % w, 0].add(
                np.uint8(idx + 1)
            )
            pull(fwd_full(rgb))
            n_done += 1
    dt = time.perf_counter() - t0

    views = len(scene_lists[0])
    print(
        json.dumps(
            {
                "metric": "stream_views_per_s",
                "scenes": n_done,
                "wall_s": round(dt, 2),
                "value": round(n_done * views / dt, 3),
                "unit": "views/s",
                "mp_per_s": round(n_done * views * h * w / dt / 1e6, 3),
                "prefetch_depth": args.depth,
                "mesh": args.mesh,
            }
        )
    )


if __name__ == "__main__":
    main()
