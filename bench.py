"""Full-pipeline depth throughput on one GPU.

Prints the device and the card's name and power limit, then ONE JSON line:
{"metric": "depth_mp_per_s", "value": N, "unit": "MP/s", "device": {...}}.

Workload: the flagship pipeline (SLIC + superpixel plane-sweep init +
PatchMatch refinement + fusion) at the reference scale: 9 views, 1080p,
31 disparity hypotheses, 5 SLIC iterations, 5 propagation iterations, on a
seeded fronto-parallel synthetic scene.  Refuses to run without a GPU.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.testing import smoke
    from cl_multiview_stereo_tpu.testing.synthetic import fronto_parallel_scene
    from cl_multiview_stereo_tpu.utils.compile_cache import configure_compile_cache

    devices = jax.devices()
    try:
        smoke.require_gpu(devices)
        cards = smoke.query_cards()
    except smoke.SmokeFailure as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    configure_compile_cache()
    dev = devices[0]
    print(f"card: {cards[0][0]}, {cards[0][1]}", flush=True)

    s = SystemSettings()  # reference defaults: 3x3 views, 31 hypotheses
    h, w = 1080, 1920
    rgb, _ = fronto_parallel_scene(
        h, w, array_width=3, array_height=3, disp=40.0, bl_ratio=s.bl_ratio
    )
    fwd = MVSPipeline.create(w, h, s).jitted()
    rgb_dev = jax.device_put(jnp.asarray(rgb), dev)

    jax.block_until_ready(fwd(rgb_dev))  # compile + warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(rgb_dev))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    print(json.dumps({
        "metric": "depth_mp_per_s",
        "value": round(s.view_num * h * w / dt / 1e6, 3),
        "unit": "MP/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
