"""Scaling-efficiency sweep: view-sharded pipeline throughput at 1..N
devices, on a virtual CPU device mesh.

CAVEAT: virtual CPU devices share the same host cores, so per-device
"efficiency" degrades roughly like 1/n by construction — the sweep
validates that the sharded program compiles, runs, and keeps collectives
on the view axis at every mesh size; it measures no device.  Scaling on
real cards is the four-card phase of chip_smoke.py.

Usage:  JAX_PLATFORMS=cpu python -u tools/scaling_sweep.py [--n 8] [--hw 96x128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8, help="max devices (power sweep 1,2,4,..,n)")
    ap.add_argument("--hw", default="96x128", help="per-view HxW")
    ap.add_argument("--json", default=None, help="write results to this path")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.n}"
        ).strip()

    import jax
    import numpy as np

    # always the CPU: n>1 needs the virtual CPU mesh, whatever card the
    # machine has
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.parallel.mesh import make_mesh
    from cl_multiview_stereo_tpu.parallel.sharded_pipeline import sharded_pipeline_fn

    h, w = (int(x) for x in args.hw.split("x"))
    devs_all = jax.devices()
    ns = [n for n in (1, 2, 4, 8, 16, 32) if n <= min(args.n, len(devs_all))]

    results = []
    base_rate = None
    for n in ns:
        # hold per-device work constant (weak scaling): n devices x 2 views
        # each, camera array n wide x 2 tall
        s = SystemSettings(
            array_width=n, array_height=2, spixl_size=8,
            min_disp=2, max_disp=9, inc=1, bl_ratio=1.0,
            kernel_size=8, kernel_step=2, no_prop=2,
        )
        pipe = MVSPipeline.create(w, h, s)
        mesh = make_mesh(n_view=n, n_disp=1, devices=devs_all[:n])
        rgb = np.random.default_rng(0).integers(
            0, 256, size=(s.view_num, h, w, 3), dtype=np.uint8
        )
        fn = sharded_pipeline_fn(pipe, mesh)
        jax.block_until_ready(fn(rgb))  # compile
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(rgb))
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[1]
        rate = s.view_num / dt  # views/s
        per_dev = rate / n
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate
        results.append(
            {"devices": n, "views": s.view_num, "views_per_s": round(rate, 2),
             "per_device": round(per_dev, 2), "efficiency": round(eff, 3)}
        )
        print(
            f"devices={n:3d} views={s.view_num:3d} {rate:8.2f} views/s "
            f"({per_dev:.2f}/dev, eff {eff:5.1%})",
            flush=True,
        )

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
