"""The phases of ``chip_smoke.py``, kept here so CPU tests run them at tiny
sizes through the same code.

Each phase drives the system through the entry points a user calls (the
CLI, ``MVSPipeline.jitted``, ``parallel.sharded_pipeline.run_sharded``),
checks what comes out, raises ``SmokeFailure`` when a check fails, and
returns the numbers it measured for the caller to print.  Nothing here
decides which device to run on: callers pass devices in.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time

import numpy as np

from cl_multiview_stereo_tpu.config import SystemSettings
from cl_multiview_stereo_tpu.testing.synthetic import two_plane_scene

# disparity tolerance of the GPU/CPU and sharded/one-card comparisons, and
# the least share of entries that must meet it (tests/test_refine.py holds
# the propagate mirror to the same 1%)
CMP_ATOL = 1e-3
CMP_MIN_SHARE = 0.99
# pixels within TRUTH_TOL of the analytic disparity, as tests/test_pipeline.py
TRUTH_TOL = 1.5
TRUTH_MIN_SHARE = 0.55
# SfM GPU vs CPU: float order (segment sums, reductions) can move a Harris
# response or a descriptor distance across a top-k or mutual-nearest tie and
# swap a handful of matches out of hundreds; each changes the least-squares
# optimum by about 1/N of itself, so the two runs must agree to 2% relative
# (plus a floor for values near zero)
SFM_RTOL = 0.02
SFM_RMS_ATOL = 0.01  # px
SFM_ATE_ATOL = 1e-3  # baseline units


class SmokeFailure(RuntimeError):
    """A smoke-run check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------- device
def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power limit)], one per card."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, power = line.rpartition(",")
        name, power = name.strip(), power.strip()
        if not sep or not name or not re.fullmatch(r"[0-9.]+ W", power):
            raise SmokeFailure(f"cannot read nvidia-smi line {line!r}")
        cards.append((name, power))
    if not cards:
        raise SmokeFailure("nvidia-smi listed no card")
    return cards


def query_cards() -> list[tuple[str, str]]:
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"cannot run nvidia-smi: {e}") from None
    if proc.returncode != 0:
        raise SmokeFailure(
            f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}"
        )
    return parse_nvidia_smi(proc.stdout)


def require_gpu(devices) -> None:
    """Refuse any backend but the GPU: no result is printed for a CPU run."""
    check(len(devices) > 0, "JAX found no device")
    platform = devices[0].platform
    check(platform == "gpu", f"JAX runs on {platform!r}, not on a GPU")


# --------------------------------------------------------------- helpers
def within_share(a, b, atol: float = CMP_ATOL) -> float:
    """Share of entries with |a - b| <= atol (a non-finite entry never
    agrees)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.mean(np.abs(a - b) <= atol))


def equal_share(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.mean(a == b))


def truth_share(disp: np.ndarray, gt: np.ndarray, margin: int, tol: float) -> float:
    """Share of interior pixels of one view within ``tol`` of the truth,
    leaving out ``margin`` pixels at every border."""
    m = int(margin)
    return within_share(disp[m:-m, m:-m], gt[m:-m, m:-m], tol)


def settings_args(overrides: dict) -> list[str]:
    """``--set key=value`` CLI arguments for SystemSettings overrides."""
    out = []
    for k, v in overrides.items():
        out += ["--set", f"{k}={v}"]
    return out


def write_scene(root: str, rgb: np.ndarray) -> str:
    """Write a (V, H, W, 3) camera array as PNGs plus an image list in the
    reference's format; returns the list's path."""
    from cl_multiview_stereo_tpu.io.images import save_png

    os.makedirs(root, exist_ok=True)
    names = []
    for z in range(rgb.shape[0]):
        names.append(f"view_{z}.png")
        save_png(os.path.join(root, names[-1]), rgb[z])
    list_path = os.path.join(root, "data.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def scene(s: SystemSettings, h: int, w: int, seed: int, disp_bg=32.0, disp_fg=52.0):
    return two_plane_scene(
        h, w, array_width=s.array_width, array_height=s.array_height,
        disp_bg=disp_bg, disp_fg=disp_fg, bl_ratio=s.bl_ratio, seed=seed,
    )


def _fresh(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


# --------------------------------------------------------------- phases
def cli_run_phase(
    workdir: str, overrides: dict, h: int, w: int, *,
    disp_bg: float = 32.0, disp_fg: float = 52.0,
) -> dict:
    """Seeded two-plane scene -> PNGs + list -> ``cli run --checkpoint
    --ply``; checks the written artifacts and the accuracy of view 0."""
    from cl_multiview_stereo_tpu import cli

    s = SystemSettings().replace(**overrides)
    rgb, gt = scene(s, h, w, 0, disp_bg, disp_fg)
    list_path = write_scene(_fresh(os.path.join(workdir, "scene")), rgb)
    out = _fresh(os.path.join(workdir, "run"))
    t0 = time.perf_counter()
    rc = cli.main(
        ["run", list_path, "--out", out, "--checkpoint", "--ply"]
        + settings_args(overrides)
    )
    seconds = time.perf_counter() - t0
    check(rc == 0, f"cli run returned {rc}")
    from cl_multiview_stereo_tpu.utils.artifacts import STAGE_DIRS, load_checkpoint

    pngs = [
        os.path.join(out, STAGE_DIRS["fusion"], f"disp_{z}.png")
        for z in range(s.view_num)
    ]
    ply = os.path.join(out, "fused.ply")
    missing = [p for p in pngs + [ply] if not os.path.exists(p)]
    check(not missing, f"cli run wrote no {missing}")
    disp = load_checkpoint(os.path.join(out, "pipeline_state.npz"))["disp_full"]
    check(disp.shape == (s.view_num, h, w), f"disp_full shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), "disp_full holds non-finite values")
    # fusion rasterizes each superpixel's plane, and a slanted plane
    # extrapolates past the ladder at superpixel edges, so range is a
    # share: every view's pixels inside the ladder (+-1 step), held to the
    # bound the view-0 truth share is held to
    lo, hi = float(disp.min()), float(disp.max())
    in_ladder = float(np.mean(
        (disp >= s.min_disp - s.inc) & (disp <= s.max_disp + s.inc)
    ))
    check(
        in_ladder >= TRUTH_MIN_SHARE,
        f"only {in_ladder:.4f} of disp_full inside the ladder "
        f"{s.min_disp}..{s.max_disp} (min {lo}, max {hi})",
    )
    within1 = truth_share(disp[0], gt, s.max_disp, 1.0)
    within15 = truth_share(disp[0], gt, s.max_disp, TRUTH_TOL)
    check(
        within15 >= TRUTH_MIN_SHARE,
        f"only {within15:.4f} of view-0 interior pixels within "
        f"{TRUTH_TOL} of the truth (need {TRUTH_MIN_SHARE})",
    )
    return {
        "seconds_incl_compile": seconds, "pngs": len(pngs), "ply": True,
        "disp_min": lo, "disp_max": hi, "in_ladder": in_ladder,
        "truth_within_1": within1, "truth_within_1.5": within15,
    }


def steady_phase(pipe, scenes: list, device) -> dict:
    """``pipe.jitted()`` on each scene, each timed to ``block_until_ready``.

    Inputs are placed as the CLI places them (uncommitted, on the default
    device), so this program is the one ``cli run`` compiled and the first
    call may load it from the persistent cache: ``first_call_s`` is compile
    (or cache load) plus one run."""
    import jax

    fwd = pipe.jitted()
    xs = [jax.device_put(x) for x in scenes]
    t0 = time.perf_counter()
    jax.block_until_ready(fwd(xs[0]))
    first_s = time.perf_counter() - t0
    times = []
    for x in xs:
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(x))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    v, h, w = scenes[0].shape[:3]
    stats = device.memory_stats() or {}
    return {
        "first_call_s": first_s, "scene_s": times, "median_s": med,
        "mp_per_s": v * h * w / med / 1e6,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def stage_shares(a, b) -> dict:
    """Agreement of two runs' ``PipelineArtifacts`` (host arrays), stage by
    stage: integer outputs equal, float outputs within ``CMP_ATOL``."""
    return {
        "labels_equal": equal_share(a.labels, b.labels),
        "extent_equal": equal_share(a.extent, b.extent),
        "center_within": within_share(a.spmap.center, b.spmap.center),
        "disp_init_equal": equal_share(a.disp_init, b.disp_init),
        "flatness_within": within_share(a.flatness, b.flatness),
        "state_d_within": within_share(a.state.d, b.state.d),
        "state_n_within": within_share(a.state.n, b.state.n),
        "disp_full_within": within_share(a.disp_full, b.disp_full),
    }


def backend_compare_phase(pipe, rgb: np.ndarray, dev_a, dev_b) -> dict:
    """The same jitted pipeline on two devices (the GPU and the CPU
    reference): ``disp_init`` equal per superpixel, ``state.d`` and
    ``disp_full`` within ``CMP_ATOL``, each in ``CMP_MIN_SHARE``.  The
    returned shares cover every stage, so a failure names where the two
    runs part."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    fwd = pipe.jitted()

    def run_on(d):
        return jax.device_get(fwd(jax.device_put(rgb, d)))

    # the two backends compile and run side by side
    with ThreadPoolExecutor(2) as pool:
        a, b = pool.map(run_on, (dev_a, dev_b))
    shares = stage_shares(a, b)
    failed = [
        k for k in ("disp_init_equal", "state_d_within", "disp_full_within")
        if shares[k] < CMP_MIN_SHARE
    ]
    check(not failed, f"{failed} below {CMP_MIN_SHARE}: {shares}")
    return shares


def sfm_phase(
    workdir: str, overrides: dict, h: int, w: int, cpu_device, *,
    keypoints: int = 512, ba_iters: int = 12,
) -> dict:
    """``cli sfm --pose-graph`` on a seeded scene, checked against a run of
    ``run_sfm`` on ``cpu_device`` over the same images."""
    import jax

    from cl_multiview_stereo_tpu import cli
    from cl_multiview_stereo_tpu.io.images import load_image_array
    from cl_multiview_stereo_tpu.models.sfm_pipeline import run_sfm

    s = SystemSettings().replace(**overrides)
    rgb, _ = scene(s, h, w, 0)
    list_path = write_scene(_fresh(os.path.join(workdir, "sfm_scene")), rgb)
    out = _fresh(os.path.join(workdir, "sfm"))
    rc = cli.main(
        ["sfm", list_path, "--pose-graph", "--out", out,
         "--keypoints", str(keypoints), "--ba-iters", str(ba_iters)]
        + settings_args(overrides)
    )
    check(rc == 0, f"cli sfm returned {rc}")
    with np.load(os.path.join(out, "sfm_poses.npz")) as z:
        rms_before = float(z["rms_before"])
        rms_after = float(z["rms_after"])
        ate = float(z["ate_vs_grid"])
    check(
        rms_after <= rms_before,
        f"BA raised the reprojection RMS {rms_before} -> {rms_after}",
    )
    with jax.default_device(cpu_device):
        ref = run_sfm(
            load_image_array(list_path, s.view_num), s, k=keypoints,
            ba_iters=ba_iters, baseline=s.sfm_baseline, use_pose_graph=True,
        )
    d_rms = abs(rms_after - ref.rms_after)
    d_ate = abs(ate - ref.ate_vs_grid)
    check(
        d_rms <= SFM_RMS_ATOL + SFM_RTOL * abs(ref.rms_after),
        f"rms_after {rms_after} vs CPU {ref.rms_after}",
    )
    check(
        d_ate <= SFM_ATE_ATOL + SFM_RTOL * abs(ref.ate_vs_grid),
        f"ate_vs_grid {ate} vs CPU {ref.ate_vs_grid}",
    )
    return {
        "rms_before": rms_before, "rms_after": rms_after, "ate_vs_grid": ate,
        "cpu_rms_after": ref.rms_after, "cpu_ate_vs_grid": ref.ate_vs_grid,
        "cpu_n_matches": ref.n_matches,
    }


def four_card_phase(devices, overrides: dict, h: int, w: int) -> dict:
    """View-sharded pipeline on a ``(view=len(devices), disp=1)`` mesh, for
    both pair layouts, against the one-card ``jitted()`` run."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu.parallel.mesh import make_mesh
    from cl_multiview_stereo_tpu.parallel.sharded_pipeline import (
        sharded_pipeline_fn,
    )

    s = SystemSettings().replace(**overrides)
    check(
        s.view_num % len(devices) == 0,
        f"{s.view_num} views do not divide over {len(devices)} cards",
    )
    rgb, _ = scene(s, h, w, 0)
    mesh = make_mesh(n_view=len(devices), n_disp=1, devices=devices)
    x_one = jax.device_put(rgb, devices[0])
    x_mesh = jax.device_put(rgb, NamedSharding(mesh, P("view", None, None, None)))
    jobs = {"one_card": (MVSPipeline.create(w, h, s).jitted(), x_one)}
    for layout in ("packed", "view"):
        pipe = MVSPipeline.create(w, h, s, pair_layout=layout)
        jobs[layout] = (sharded_pipeline_fn(pipe, mesh), x_mesh)
    # compiling dominates a cold run: the three programs compile side by side
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = dict(zip(jobs, pool.map(
            lambda job: job[0].lower(job[1]).compile(), jobs.values()
        )))

    def timed(name):
        fn, x = compiled[name], jobs[name][1]
        out = jax.block_until_ready(fn(x))  # first run
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(x))
            times.append(time.perf_counter() - t0)
        return jax.device_get(out), float(np.median(times))

    art, one_s = timed("one_card")
    ref = art.disp_full
    res = {"one_card_s": one_s}
    for layout in ("packed", "view"):
        got, sec = timed(layout)
        share = within_share(got, ref)
        res[f"{layout}_within"] = share
        res[f"{layout}_s"] = sec
        check(
            share >= CMP_MIN_SHARE,
            f"sharded ({layout}) vs one card: {share:.5f} < {CMP_MIN_SHARE}",
        )
    res["peak_bytes_in_use"] = [
        (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices
    ]
    return res
