"""Smoke run of the MVS pipeline on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the view-sharded phase only

One card, in order:
  device      refuse any backend but the GPU; print the device, JAX, the
              compile cache and the card's name and power limit
  cli_run     3x3 views, 1920x1080, the default ladder 30..60 (31
              hypotheses, 5 SLIC and 5 propagation iterations) through
              ``cli run --checkpoint --ply``; 9 disparity PNGs, a PLY,
              finite in-range disparity, view-0 accuracy against the
              analytic truth
  steady      ``MVSPipeline.jitted()`` on that geometry: compile seconds,
              then three seeded scenes timed to ``block_until_ready``
  gpu_vs_cpu  the same jitted pipeline on the GPU and on the CPU backend,
              3x3 at 240x136
  sfm         ``cli sfm --pose-graph`` at 3x3 960x540, checked against
              ``run_sfm`` on the CPU backend; PIL never imported
With ``--four-cards``: a 4x2 rig at 1920x1080 sharded over a (view=4)
mesh with both pair layouts, against the one-card ``jitted()`` run.

Any failed check exits non-zero before the last line, which is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.  Scenes and
outputs go to ``smoke_out/`` in the checkout (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()


def _report(phase: str, values: dict) -> None:
    """One line per phase, stamped with the seconds since start."""
    stamp = {"t": round(time.perf_counter() - _T0, 1)}
    print(f"{phase}: {json.dumps(dict(stamp, **values))}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the view-sharded phase on four cards")
    ap.add_argument("--workdir", default=os.path.join(REPO, "smoke_out"))
    args = ap.parse_args(argv)

    # the GPU/CPU phases need the CPU backend beside the card's: keep it
    # when the environment names the platforms (the GPU stays the default);
    # JAX reads this when it is first imported
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    sys.path.insert(0, REPO)
    import jax

    from cl_multiview_stereo_tpu.testing import smoke
    from cl_multiview_stereo_tpu.utils.compile_cache import configure_compile_cache

    try:
        devices = jax.devices()
        smoke.require_gpu(devices)
        cache_dir = configure_compile_cache()
        cards = smoke.query_cards()
        dev = devices[0]
        _report("device", {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices), "jax": jax.__version__,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": cache_dir,
        })
        card = f"{cards[0][0]}, {cards[0][1]}"
        for name, power in cards:
            print(f"nvidia-smi: {name}, {power}", flush=True)

        if args.four_cards:
            smoke.check(
                len(devices) >= 4, f"--four-cards needs 4 cards, have {len(devices)}"
            )
            res = smoke.four_card_phase(
                devices[:4], {"array_width": 4, "array_height": 2}, 1080, 1920
            )
            _report("four_cards", dict(res, card=card))
        else:
            _run_one_card(smoke, args.workdir, dev, card)
            smoke.check("PIL" not in sys.modules, "PIL was imported on the main path")
            _report("pil", {"imported": False})
    except smoke.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    _report("done", {})
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}))
    return 0


def _run_one_card(smoke, workdir: str, dev, card: str) -> None:
    import jax

    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline

    s = SystemSettings()  # the reference workload: 3x3 views, 30..60
    h, w = 1080, 1920
    _report("cli_run", smoke.cli_run_phase(workdir, {}, h, w))

    scenes = [smoke.scene(s, h, w, seed)[0] for seed in range(3)]
    res = smoke.steady_phase(MVSPipeline.create(w, h, s), scenes, dev)
    _report("steady", dict(res, card=card))

    small_h, small_w = 136, 240
    rgb, _ = smoke.scene(s, small_h, small_w, 0)
    res = smoke.backend_compare_phase(
        MVSPipeline.create(small_w, small_h, s), rgb, dev, jax.devices("cpu")[0]
    )
    _report("gpu_vs_cpu", res)

    _report("sfm", smoke.sfm_phase(workdir, {}, 540, 960, jax.devices("cpu")[0]))


if __name__ == "__main__":
    sys.exit(main())
