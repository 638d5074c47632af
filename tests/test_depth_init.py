import numpy as np
import pytest

from cl_multiview_stereo_tpu.config import (
    DerivedGeometry,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu.ops import cost_volume, slic, superpixel
from cl_multiview_stereo_tpu.ops.color import rgb_to_lab
from cl_multiview_stereo_tpu.testing import mirror, synthetic


@pytest.fixture(scope="module")
def scene():
    # Tiny 2x2 camera array so the scalar mirror stays tractable.
    s = SystemSettings(
        array_width=2,
        array_height=2,
        spixl_size=8,
        min_disp=4,
        max_disp=11,
        inc=1,
        bl_ratio=1.0,
    )
    views, gt_disp = synthetic.fronto_parallel_scene(
        48, 64, array_width=2, array_height=2, disp=7.0, bl_ratio=1.0, seed=5
    )
    geom = DerivedGeometry.create(64, 48, s)
    lab = np.asarray(rgb_to_lab(views))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    return s, geom, lab, np.asarray(labels), spmap, gt_disp


def test_extent_matches_mirror(scene):
    s, geom, lab, labels, spmap, _ = scene
    got = np.asarray(superpixel.superpixel_extent(labels, spmap.center, geom))
    for v in range(labels.shape[0]):
        want = mirror.superpixel_extent(
            labels[v], np.asarray(spmap.center[v]), s.spixl_size
        )
        np.testing.assert_array_equal(got[v], want, err_msg=f"view {v}")


def test_extent_step(scene):
    s, geom, lab, labels, spmap, _ = scene
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    step = np.asarray(superpixel.extent_step(ext))
    assert step.min() >= 1.0
    # interior superpixels of a dense segmentation have near-full extents
    assert step[:, 2:-2, 2:-2].mean() > 1.5


def test_depth_init_matches_mirror(scene):
    s, geom, lab, labels, spmap, _ = scene
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    disp_levels = build_disp_levels(s)
    subset, counts = build_view_subsets(s)
    got = np.asarray(
        cost_volume.initial_depth_estimation(
            lab,
            spmap.center,
            ext,
            disp_levels,
            subset,
            counts,
            s.array_width,
            s.bl_ratio,
        )
    )
    want = mirror.initial_depth_estimation_v2(
        lab,
        np.asarray(spmap.center),
        np.asarray(ext),
        disp_levels,
        subset,
        counts,
        s.array_width,
        s.bl_ratio,
    )
    agree = (got == want).mean()
    assert agree > 0.98, f"disparity agreement {agree}"


def test_depth_init_recovers_ground_truth(scene):
    s, geom, lab, labels, spmap, gt = scene
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    disp_levels = build_disp_levels(s)
    subset, counts = build_view_subsets(s)
    disp = np.asarray(
        cost_volume.initial_depth_estimation(
            lab, spmap.center, ext, disp_levels, subset, counts, s.array_width, s.bl_ratio
        )
    )
    # ground truth is constant 7.0 everywhere; interior superpixels must hit it
    interior = disp[:, 1:-1, 1:-1]
    assert (np.abs(interior - gt) <= 1.0).mean() > 0.9


def test_plane_sweep_dense_recovers_ground_truth():
    from cl_multiview_stereo_tpu.models import plane_sweep

    s = SystemSettings(
        array_width=2, array_height=1, min_disp=4, max_disp=11, inc=1, bl_ratio=1.0
    )
    views, gt = synthetic.fronto_parallel_scene(
        48, 64, array_width=2, array_height=1, disp=7.0, bl_ratio=1.0, seed=2
    )
    lab = rgb_to_lab(views)
    subset, counts = build_view_subsets(s)
    pairs = plane_sweep.build_pairs(subset, counts, s.array_width)
    disp_levels = tuple(float(d) for d in build_disp_levels(s))
    disp, cost = plane_sweep.plane_sweep_depth(lab, disp_levels, pairs, s.bl_ratio, 2)
    disp = np.asarray(disp)
    # away from the occlusion border, every pixel should hit 7 exactly
    inner = disp[0, 4:-4, 12:-4]
    assert (inner == 7.0).mean() > 0.95


@pytest.mark.parametrize(
    "bl_ratio,inc",
    [(1.0, 1.0), (1.03590, 1.0), (1.03590, 0.5), (0.97, 1.0)],
)
def test_dense_mode_agrees_with_gather(scene, bl_ratio, inc):
    # fractional bl_ratio and a half-step ladder exercise the
    # projected-coordinate truncation semantics (ceil shift + the
    # (-1, 0) -> 0 aliasing, clcode.cl:1034); bl_ratio < 1 shrinks the
    # vertical shifts below the horizontal ones
    s, geom, lab, labels, spmap, _ = scene
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    disp_levels = np.arange(s.min_disp, s.max_disp + inc / 2, inc, dtype=np.float32)
    subset, counts = build_view_subsets(s)
    kw = dict(array_width=s.array_width, bl_ratio=bl_ratio)
    exact = np.asarray(cost_volume.initial_depth_estimation(
        lab, spmap.center, ext, disp_levels, subset, counts, **kw, method="gather"))
    dense = np.asarray(cost_volume.initial_depth_estimation(
        lab, spmap.center, ext, disp_levels, subset, counts, **kw, method="dense",
        neib_hor=s.neib_hor, neib_ver=s.neib_ver))
    agree = (exact == dense).mean()
    assert agree > 0.999, f"dense/gather WTA agreement {agree}"


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (61, 45)])
def test_extent_windowed_equals_walk(hw):
    """The windowed-gather extent (4 wide gathers via row/transpose/shear
    tables) must equal the direct 8*(S-1)-narrow-gather walk BITWISE —
    including non-multiple-of-spixl_size shapes (shear/table edge cases)."""
    import jax.numpy as jnp

    from cl_multiview_stereo_tpu.config import SlicParams, SystemSettings
    from cl_multiview_stereo_tpu.ops import slic
    from cl_multiview_stereo_tpu.ops.color import rgb_to_lab

    h, w = hw
    s = SystemSettings(
        array_width=2, array_height=2, spixl_size=8, min_disp=2, max_disp=6,
        inc=1, bl_ratio=1.0, kernel_size=8, kernel_step=2, no_prop=1,
    )
    rgb, _ = synthetic.two_plane_scene(
        h, w, array_width=2, array_height=2, disp_bg=3.0, disp_fg=5.0,
        bl_ratio=1.0, seed=h,
    )
    geom = DerivedGeometry.create(w, h, s)
    lab = rgb_to_lab(jnp.asarray(rgb))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    a = np.asarray(superpixel.superpixel_extent_walk(labels, spmap.center, geom))
    b = np.asarray(superpixel.superpixel_extent(labels, spmap.center, geom))
    np.testing.assert_array_equal(a, b)
