"""Where the GPU and the CPU backend part on the MVS pipeline.

Runs the one-jit pipeline on the default device and on the CPU backend and
prints stage-by-stage agreement (``testing.smoke.stage_shares``).  Then it
isolates the refinement: both devices start from the SAME context (built
from the CPU run's SLIC / extent / depth-init outputs) and the SAME input
state at every Jacobi sweep, so each sweep's "fresh" disagreement is its
own, next to the "chained" disagreement of the two independent sweep
chains.  Each line also gives the largest relative difference of the
scores (sm, cs) over the superpixels whose disparity agrees.

    python tools/backend_divergence.py [--hw 136x240]

Prints one JSON object per line.  On a machine without a GPU it compares
the CPU with itself, which rehearses the script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _rel(a, b, mask):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float(d[mask].max()) if mask.any() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default="136x240")
    args = ap.parse_args()

    import jax
    import numpy as np

    from cl_multiview_stereo_tpu.config import (
        RefinementSchedule, SystemSettings, build_view_subsets,
    )
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.ops import refine
    from cl_multiview_stereo_tpu.testing import smoke
    from cl_multiview_stereo_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    h, w = (int(x) for x in args.hw.split("x"))
    dev_a, dev_b = jax.devices()[0], jax.devices("cpu")[0]
    s = SystemSettings()
    rgb, _ = smoke.scene(s, h, w, 0)
    pipe = MVSPipeline.create(w, h, s)
    fwd = pipe.jitted()
    art_a = jax.device_get(fwd(jax.device_put(rgb, dev_a)))
    art_b = jax.device_get(fwd(jax.device_put(rgb, dev_b)))
    print(json.dumps({"stage_shares": smoke.stage_shares(art_a, art_b),
                      "devices": [str(dev_a), str(dev_b)]}), flush=True)

    # refinement alone, from one context and one input state per sweep
    sched = RefinementSchedule.create(s)
    view_subset, _ = build_view_subsets(s)
    label_radius = 1 + (2 if s.enforce_connectivity else 0)
    pairs = refine.pairs_from_subsets(view_subset, s.array_width)
    kw0 = dict(
        gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff,
        bl_ratio=sched.bl_ratio, pairs=pairs, spixl_size=s.spixl_size,
        label_radius=label_radius, pair_layout="packed",
    )

    def ctx_on(dev):
        with jax.default_device(dev):
            return refine.make_context(
                art_b.spmap.center, art_b.spmap.color, art_b.disp_init,
                art_b.labels, art_b.extent, art_b.flatness, view_subset,
                s.array_width, spixl_size=s.spixl_size, label_radius=label_radius,
            )

    ctx = {d: jax.device_put(ctx_on(d), d) for d in (dev_a, dev_b)}

    def report(step, ga, gb, fresh):
        agree = np.abs(np.asarray(ga.d) - np.asarray(gb.d)) <= smoke.CMP_ATOL
        print(json.dumps({
            "step": step, "kind": "fresh" if fresh else "chained",
            "d_within": float(agree.mean()),
            "sm_max_rel": _rel(ga.sm, gb.sm, agree),
            "cs_max_rel": _rel(ga.cs, gb.cs, agree),
        }), flush=True)

    init = {
        d: jax.device_get(refine.init_state(
            ctx[d], **kw0, steps=sched.kernel_steps, step_size=sched.sp_kernel_step,
        )) for d in (dev_a, dev_b)
    }
    report("init", init[dev_a], init[dev_b], True)
    chain = dict(init)
    for it in range(sched.no_prop):
        it_kw = dict(kw0, it=it, steps=sched.steps_per_iter[it],
                     step_size=sched.step_size_per_iter[it])
        fresh_a = jax.device_get(refine.propagate_iteration(
            ctx[dev_a], jax.device_put(chain[dev_b], dev_a), **it_kw))
        for d in (dev_a, dev_b):
            chain[d] = jax.device_get(refine.propagate_iteration(
                ctx[d], jax.device_put(chain[d], d), **it_kw))
        report(f"propagate{it}", fresh_a, chain[dev_b], True)
        report(f"propagate{it}", chain[dev_a], chain[dev_b], False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
