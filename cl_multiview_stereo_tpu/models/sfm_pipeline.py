"""SfM front-end wired to the MVS pipeline (north-star integration).

The reference has no SfM at all — its camera model is the implicit
rectified grid of ``clcode.cl:1033-1034`` (disparity shift scaled by
``bl_ratio``).  This module runs the full front-end chain on a real scene:

  RGB -> Harris keypoints -> mutual-nearest matching over grid-adjacent
  view pairs -> midpoint triangulation seeded by the grid-rig prior ->
  Schur-complement bundle adjustment -> recovered poses + metrics
  (reprojection RMS before/after, ATE vs the grid prior)

and generalizes the projection path: ``pairs_from_poses`` converts
recovered camera translations back into the per-pair baseline deltas
(dvx, dvy) the refinement consistency term consumes, making the implicit
grid one special case (SURVEY.md section 7.1.6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cl_multiview_stereo_tpu.config import SystemSettings, build_view_subsets
from cl_multiview_stereo_tpu.models import sfm
from cl_multiview_stereo_tpu.models.sfm import rodrigues
from cl_multiview_stereo_tpu.ops.features import harris_keypoints, match_pairs


class SfmResult(NamedTuple):
    aa: np.ndarray  # (V, 3) recovered axis-angle rotations
    t: np.ndarray  # (V, 3) recovered translations
    intr: np.ndarray  # (4,) intrinsics used (fx, fy, cx, cy)
    X: np.ndarray  # (P, 3) triangulated points (weight 0 rows are padding)
    obs_w: np.ndarray  # (N,) observation weights (0 = invalid match slot)
    rms_before: float  # reprojection RMS at the grid-prior seed
    rms_after: float  # reprojection RMS after bundle adjustment
    ate_vs_grid: float  # ATE of recovered translations vs the grid prior
    n_matches: int  # valid pairwise matches used


def _unique_adjacent_pairs(settings: SystemSettings) -> np.ndarray:
    """Grid-adjacent unordered view pairs (a < b) from the same adjacency
    rule as the pipeline's view subsets (pipeline.cpp:130-142)."""
    view_subset, _ = build_view_subsets(settings)
    out = []
    for z in range(view_subset.shape[0]):
        for n in view_subset[z]:
            if n >= 0 and z < n:
                out.append((z, int(n)))
    return np.asarray(out, np.int32)


def _highest_matmul_precision(fn):
    """Trace ``fn`` with float32 matrix products at full float32 precision.

    The SfM products are tiny (6x6 and 3x3 blocks, 512-wide descriptors),
    but a GPU runs a float32 product at its default precision in TF32,
    and a bundle adjustment whose normal equations, Schur complement or
    pose graph are built in TF32 converges to a different result.  One
    scope around each entry point covers every product the SfM code traces
    (``models.sfm``, ``ops.features``) without a flag at each of them.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kw)

    return wrapped


@_highest_matmul_precision
def run_sfm(
    rgb: np.ndarray,
    settings: SystemSettings,
    *,
    baseline: float = 1.0,
    k: int = 512,
    max_matches: int = 256,
    ba_iters: int = 12,
    mesh=None,
    pose_seed: tuple[np.ndarray, np.ndarray] | None = None,
    fix_rotations: bool = True,
    outlier_px: float = 6.0,
    intrinsics: np.ndarray | None = None,
    use_pose_graph: bool = False,
) -> SfmResult:
    """Full SfM on a (V, H, W, 3) uint8 camera-array batch.

    ``baseline`` sets the metric scale of the grid-prior seed (the gauge:
    camera 0 is pinned and the seed keeps the free scale near the prior).
    ``mesh``: optional device mesh — uses the observation-sharded
    distributed BA (``sfm.bundle_adjust_sharded``) when given.
    ``use_pose_graph``: run the pose-graph backend first — per-edge
    two-view BA factors (``sfm.two_view_relative``) over the grid-adjacent
    match graph, a relative-pose solve (``sfm.pose_graph_optimize``, loop
    closures from the grid's 4-cycles), and THAT solution seeds the Schur
    BA.
    """
    v, h, w = rgb.shape[:3]
    s = settings
    assert v == s.view_num, (v, s.view_num)

    gray = jnp.asarray(rgb).astype(jnp.float32) @ jnp.asarray(
        [0.299, 0.587, 0.114], jnp.float32
    )
    kp = harris_keypoints(gray, k=k)
    pairs = _unique_adjacent_pairs(s)
    # a pair cannot hold more mutual matches than keypoints per view (and
    # match_pairs' top_k requires max_matches <= k)
    max_matches = min(max_matches, k)
    matches = match_pairs(kp, jnp.asarray(pairs), max_matches=max_matches)

    # grid-rig prior seed (the reference's implicit camera, made explicit);
    # ``pose_seed`` overrides it (e.g. a noise-perturbed seed in tests —
    # ATE is always reported against the clean grid prior)
    grid_aa, grid_t = sfm.grid_rig_poses(v, s.array_width, baseline, s.bl_ratio)
    aa0, t0 = pose_seed if pose_seed is not None else (grid_aa, grid_t)
    if intrinsics is not None:
        intr = np.asarray(intrinsics, np.float32)
        assert intr.shape == (4,), "intrinsics = (fx, fy, cx, cy)"
    else:
        # default guess when no calibration is configured: f = max(h, w)
        # (a wide-normal FOV prior), principal point at the image center
        f = float(max(h, w))
        intr = np.asarray([f, f, w / 2.0, h / 2.0], np.float32)

    # Track building (shape-static): a 3D point is anchored to the FIRST
    # view's keypoint — point id = a*K + idx_a for a match in pair (a, b).
    # Two pairs (a, b), (a, c) matching the same keypoint of view a then
    # share one point, which couples the pair graph (without this, every
    # match is its own 2-observation point and per-pair scale is a gauge
    # freedom — BA drifts on narrow-FOV rigs).
    n_pair, m = matches.idx.shape[:2]
    pa = np.repeat(pairs[:, 0], m)  # (N/2,)
    pb = np.repeat(pairs[:, 1], m)
    idx = np.asarray(matches.idx).reshape(-1, 2)
    valid = np.asarray(matches.valid).reshape(-1)
    xy = np.asarray(kp.xy)
    uv_a = xy[pa, idx[:, 0]]
    uv_b = xy[pb, idx[:, 1]]

    if use_pose_graph:
        # measured relative factors from each adjacent pair's own matches
        # (two-view BA, vmapped over edges; scale gauged to the seed
        # baseline), then the relative-pose solve from the seed — its
        # output becomes the BA seed below
        edges = jnp.asarray(pairs, jnp.int32)
        rel_seed_aa, rel_seed_t = sfm.relative_from_absolute(
            jnp.asarray(aa0), jnp.asarray(t0), edges
        )
        m_uv_a = xy[pairs[:, 0][:, None], np.asarray(matches.idx)[..., 0]]
        m_uv_b = xy[pairs[:, 1][:, None], np.asarray(matches.idx)[..., 1]]
        rel_aa, rel_t, rel_info = sfm.two_view_relative(
            jnp.asarray(m_uv_a), jnp.asarray(m_uv_b),
            jnp.asarray(np.asarray(matches.valid), jnp.float32),
            jnp.asarray(intr), rel_seed_aa, rel_seed_t,
            fix_rotations=fix_rotations, outlier_px=outlier_px,
        )
        graph = sfm.PoseGraph(
            edges=edges, rel_aa=rel_aa, rel_t=rel_t,
            w_rot=jnp.ones(len(pairs)), w_t=jnp.ones(len(pairs)),
            info=rel_info,
        )
        aa_pg, t_pg = sfm.pose_graph_optimize(
            graph, jnp.asarray(aa0), jnp.asarray(t0)
        )
        aa0, t0 = np.asarray(aa_pg), np.asarray(t_pg)

    X_tri = np.asarray(
        sfm.triangulate(
            jnp.asarray(aa0), jnp.asarray(t0), jnp.asarray(intr),
            jnp.asarray(np.stack([pa, pb], -1), jnp.int32),
            jnp.asarray(uv_a), jnp.asarray(uv_b),
        )
    )
    # guard degenerate triangulations (behind camera / blown up)
    good = valid & np.isfinite(X_tri).all(-1) & (X_tri[:, 2] > 0.1) & (X_tri[:, 2] < 1e6)
    X_tri = np.where(good[:, None], X_tri, 0.0)

    pt_id = (pa * k + idx[:, 0]).astype(np.int32)  # anchored point ids
    n_pt = v * k
    # point init: mean of this point's good triangulations
    acc = np.zeros((n_pt, 3), np.float64)
    cnt = np.zeros((n_pt,), np.float64)
    np.add.at(acc, pt_id, X_tri * good[:, None])
    np.add.at(cnt, pt_id, good.astype(np.float64))
    X0 = np.where(
        cnt[:, None] > 0, acc / np.maximum(cnt[:, None], 1.0), [0.0, 0.0, 1.0]
    )

    obs_cam = np.concatenate([pa, pb]).astype(np.int32)
    obs_pt = np.concatenate([pt_id, pt_id]).astype(np.int32)
    obs_uv = np.concatenate([uv_a, uv_b]).astype(np.float32)
    obs_w = np.concatenate([good, good]).astype(np.float32)

    prob = sfm.BAProblem(
        aa=jnp.asarray(aa0),
        t=jnp.asarray(t0),
        X=jnp.asarray(X0.astype(np.float32)),
        intr=jnp.asarray(intr),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv),
        obs_w=jnp.asarray(obs_w),
    )
    # outlier gate: mutual-nearest matching still passes wrong matches on
    # repetitive texture; anything far off at the seed geometry is an
    # outlier, and one bad match dominates the least-squares objective
    res0 = np.asarray(sfm.residuals(prob))
    bad = np.sqrt((res0 ** 2).sum(-1)) > outlier_px
    obs_w = np.where(bad, 0.0, obs_w).astype(np.float32)
    prob = prob._replace(obs_w=jnp.asarray(obs_w))
    rms_before = float(sfm.rms_error(prob))
    # exact slot width for the blocked Schur assembly: the true maximum
    # observation count per point (every obs slot counts, valid or not)
    max_deg = int(np.bincount(obs_pt, minlength=n_pt).max())
    # default gauge: translation-only rig (the reference's camera model) —
    # narrow-FOV scenes make free rotations degenerate with translations
    if mesh is not None:
        out = sfm.bundle_adjust_sharded(
            prob, mesh, iters=ba_iters, fix_rotations=fix_rotations,
            max_deg=max_deg,
        )
    else:
        out = sfm.bundle_adjust(
            prob, iters=ba_iters, fix_rotations=fix_rotations, max_deg=max_deg
        )
    rms_after = float(sfm.rms_error(out))
    ate = float(sfm.ate(out.t, jnp.asarray(t0)))
    return SfmResult(
        aa=np.asarray(out.aa),
        t=np.asarray(out.t),
        intr=intr,
        X=np.asarray(out.X),
        obs_w=obs_w,
        rms_before=rms_before,
        rms_after=rms_after,
        ate_vs_grid=ate,
        n_matches=int(min((obs_w[: len(pa)] > 0).sum(), (obs_w[len(pa):] > 0).sum())),
    )


@_highest_matmul_precision
def pairs_from_poses(
    t: np.ndarray,
    view_subset: np.ndarray,
    baseline: float,
    bl_ratio: float,
    aa: np.ndarray | None = None,
) -> tuple:
    """Recovered poses -> the static (ref, view, dvx, dvy) pair list the
    refinement consistency term consumes (refine.pairs_from_subsets
    produces the integer-grid special case of this).

    The reference projects view n's sample at ``(x - d*dvx,
    y - bl_ratio*d*dvy)`` (clcode.cl:1033-1034) where dvx/dvy are camera-grid
    deltas.  With explicit poses, the delta is the baseline vector between
    camera centers ``C_i = -R_i^T t_i`` expressed in the reference view's
    frame: ``R_z (C_n - C_z) / baseline``; the vertical component divides
    out the ``bl_ratio`` the scorer multiplies back in.  ``aa`` (axis-angle,
    from a ``fix_rotations=False`` BA run) supplies the rotations; omitted,
    the rig is R = I and centers reduce to ``-t``.
    """
    t = np.asarray(t)
    vs = np.asarray(view_subset)
    if aa is None:
        centers = -t
        rot = np.broadcast_to(np.eye(3, dtype=t.dtype), (t.shape[0], 3, 3))
    else:
        rot = np.asarray(jax.vmap(rodrigues)(jnp.asarray(aa)))
        centers = -np.einsum("vij,vi->vj", rot, t)  # -R^T t
    pairs = []
    for z in range(vs.shape[0]):
        for n_ in vs[z]:
            if n_ < 0:
                continue
            n_ = int(n_)
            delta = rot[z] @ (centers[n_] - centers[z])
            pairs.append((
                z,
                n_,
                float(delta[0] / baseline),
                float(delta[1] / (baseline * bl_ratio)),
            ))
    return tuple(pairs)
