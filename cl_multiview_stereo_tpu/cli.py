"""Command-line entry point.

The reference's app layer is a hardcoded ``main()``
(``clMVDE/clMVDE.cpp:12-43``) wired to ``data.txt``.  This CLI keeps the
same contract (an image-list file drives a full pipeline run) and adds what
the reference lacked: config files, flag overrides, stage artifact dumps,
and checkpointing.

Usage:
    python -m cl_multiview_stereo_tpu.cli run data.txt \
        --config cfg.json --set min_disp=10 --set max_disp=100 \
        --out results/ --dump-stages --cross-check
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cl-mvs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run the full MVS pipeline on an image list")
    run.add_argument("image_list", help="newline-separated image paths (data.txt format)")
    run.add_argument("--config", help="JSON settings file (SystemSettings fields)")
    run.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                     help="override a settings field")
    run.add_argument("--out", default="results", help="output directory")
    run.add_argument("--dump-stages", action="store_true",
                     help="write per-stage PNG artifacts (reference results/ tree)")
    run.add_argument("--checkpoint", action="store_true",
                     help="save stage arrays as npz for resume/inspection")
    run.add_argument("--resume", metavar="NPZ",
                     help="re-enter the pipeline from a --checkpoint npz: "
                          "the deepest stage present is skipped, later "
                          "stages recompute")
    run.add_argument("--cross-check", action="store_true",
                     help="enable the cross-view fusion vote (the reference's "
                          "disabled-but-intended path)")
    run.add_argument("--ply", action="store_true",
                     help="export the fused point cloud as binary PLY")
    run.add_argument("--sfm", action="store_true",
                     help="recover poses with the SfM front-end first and "
                          "feed them into the refinement's generalized "
                          "projection path")

    sfm_p = sub.add_parser(
        "sfm", help="run the SfM front-end (features -> matches -> "
                    "triangulation -> bundle adjustment) and report metrics"
    )
    sfm_p.add_argument("image_list")
    sfm_p.add_argument("--config", help="JSON settings file")
    sfm_p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    sfm_p.add_argument("--out", default="results", help="output directory")
    sfm_p.add_argument("--keypoints", type=int, default=512)
    sfm_p.add_argument("--ba-iters", type=int, default=12)
    sfm_p.add_argument("--pose-graph", action="store_true",
                       help="run the pose-graph backend first (two-view "
                            "relative factors + information-weighted solve) "
                            "and seed the Schur BA from its solution")
    sfm_p.add_argument("--free-rotations", action="store_true",
                       help="optimize rotations too (default: translation-only "
                            "rig gauge matching the reference's camera model)")

    args = ap.parse_args(argv)

    from cl_multiview_stereo_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    from cl_multiview_stereo_tpu.config import SystemSettings
    from cl_multiview_stereo_tpu.io.images import load_image_array, save_gray_png
    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.utils import artifacts

    s = SystemSettings.from_json(args.config) if args.config else SystemSettings()
    if args.set:
        s = s.replace(**_parse_overrides(args.set))

    rgb = load_image_array(args.image_list, s.view_num)
    v, h, w = rgb.shape[:3]
    print(f"loaded {v} views of {w}x{h}")

    if args.cmd == "sfm":
        return _run_sfm_cmd(args, s, rgb)

    pair_deltas = None
    if args.sfm:
        from cl_multiview_stereo_tpu.config import build_view_subsets
        from cl_multiview_stereo_tpu.models.sfm_pipeline import (
            pairs_from_poses,
            run_sfm,
        )

        res = run_sfm(
            rgb, s, baseline=s.sfm_baseline, intrinsics=_intrinsics_from(s, w, h)
        )
        print(
            f"sfm: {res.n_matches} matches, reprojection RMS "
            f"{res.rms_before:.3f} -> {res.rms_after:.3f} px, "
            f"ATE vs grid prior {res.ate_vs_grid:.4f}"
        )
        view_subset, _ = build_view_subsets(s)
        # the same baseline scales both the BA gauge above and the pair
        # deltas here — one knob (s.sfm_baseline), never two literals
        pair_deltas = pairs_from_poses(
            res.t, view_subset, s.sfm_baseline, s.bl_ratio, aa=res.aa
        )

    pipe = MVSPipeline.create(
        w, h, s, cross_check=args.cross_check, pair_deltas=pair_deltas
    )
    t0 = time.perf_counter()
    if getattr(args, "resume", None):
        art = pipe.resume(rgb, args.resume)
    else:
        # one compiled program for the whole pipeline: per-stage dispatch
        # (pipe.run) compiles every stage and each propagate reach on its
        # own, about twice the compile time of the single program
        art = pipe.jitted()(rgb)
    import jax

    jax.block_until_ready(art.disp_full)
    dt = time.perf_counter() - t0
    print(f"pipeline done in {dt:.2f}s ({v * h * w / dt / 1e6:.1f} MP/s incl. compile)")

    os.makedirs(args.out, exist_ok=True)
    lo, hi = float(s.min_disp), float(s.max_disp)
    import numpy as np

    # one device-to-host copy of every view's disparity
    disp_np = np.asarray(jax.device_get(art.disp_full))
    for view in range(v):
        save_gray_png(
            os.path.join(args.out, artifacts.STAGE_DIRS["fusion"], f"disp_{view}.png"),
            disp_np[view], lo, hi,
        )
    if args.dump_stages:
        from cl_multiview_stereo_tpu.io.images import draw_segmentation_lines, save_png

        overlay = draw_segmentation_lines(rgb, np.asarray(art.labels))
        for view in range(v):
            save_png(
                os.path.join(args.out, "0- segmentation", f"seg_{view}.png"),
                overlay[view],
            )
        artifacts.dump_stage_pngs(args.out, "disp_init", art.disp_init, lo, hi)
        artifacts.dump_stage_pngs(args.out, "flatness", art.flatness[..., 0], 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "sm", art.state.sm, 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "cs", art.state.cs, 0.0, 1.0)
        artifacts.dump_stage_pngs(args.out, "propagate", art.state.d, lo, hi)
    if args.ply:
        from cl_multiview_stereo_tpu.io.pointcloud import (
            disparity_to_points,
            save_ply,
        )

        pts, cols = disparity_to_points(
            disp_np, rgb, s.array_width, s.bl_ratio
        )
        save_ply(os.path.join(args.out, "fused.ply"), pts, cols)
        print(f"point cloud: {pts.shape[0]} points")
    if args.checkpoint:
        artifacts.save_checkpoint(
            os.path.join(args.out, "pipeline_state.npz"),
            labels=art.labels,
            center=art.spmap.center,
            color=art.spmap.color,
            count=art.spmap.count,
            disp_init=art.disp_init,
            state_d=art.state.d,
            state_sm=art.state.sm,
            state_cs=art.state.cs,
            state_n=art.state.n,
            disp_full=art.disp_full,
        )
    print(f"results written to {args.out}")
    return 0


def _intrinsics_from(s, w: int, h: int):
    """(fx, fy, cx, cy) from the config's ``sfm_focal``, or None for the
    run_sfm default FOV prior."""
    if s.sfm_focal is None:
        return None
    import numpy as np

    return np.asarray([s.sfm_focal, s.sfm_focal, w / 2.0, h / 2.0], np.float32)


def _run_sfm_cmd(args, s, rgb) -> int:
    """``sfm`` subcommand: front-end + BA, metrics printed, poses saved."""
    import numpy as np

    from cl_multiview_stereo_tpu.models.sfm_pipeline import run_sfm

    h, w = rgb.shape[1:3]
    t0 = time.perf_counter()
    res = run_sfm(
        rgb, s, k=args.keypoints, ba_iters=args.ba_iters,
        fix_rotations=not args.free_rotations,
        baseline=s.sfm_baseline, intrinsics=_intrinsics_from(s, w, h),
        use_pose_graph=args.pose_graph,
    )
    dt = time.perf_counter() - t0
    print(f"sfm done in {dt:.2f}s: {res.n_matches} pairwise matches")
    print(f"reprojection RMS: {res.rms_before:.3f} -> {res.rms_after:.3f} px")
    print(f"ATE vs grid prior: {res.ate_vs_grid:.4f} (baseline units)")
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "sfm_poses.npz")
    np.savez(
        out_path,
        aa=res.aa,
        t=res.t,
        intr=res.intr,
        X=res.X,
        rms_before=res.rms_before,
        rms_after=res.rms_after,
        ate_vs_grid=res.ate_vs_grid,
    )
    print(f"poses written to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
