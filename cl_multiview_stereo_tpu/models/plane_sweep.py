"""Dense per-pixel plane-sweep stereo over the camera-array model.

This is the ``initial_depth_estimation_v2`` cost math
(``clMVDE/clcode.cl:1017-1067``) applied densely at every pixel instead of
per superpixel: for each disparity hypothesis d, each neighbor view's image
is resampled at ``(x - d*dvx, y - bl_ratio*d*dvy)`` (clcode.cl:1033-1034),
the SAD over a box window is aggregated, the per-hypothesis cost is the min
over neighbor views, and WTA picks the disparity.

The disparity ladder is static, so every per-hypothesis shift is
a *compile-time* translation — implemented with pad+slice instead of
gathers.  The whole sweep is a fixed XLA fusion of shifts, absolute
differences and box-filter sums (separable cumulative-sum filter), with no
data-dependent indexing at all.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

_OOB_PENALTY = 30.0
_BIG = 1.0e6


def _resample_axis(img: jax.Array, c: float, axis: int) -> jax.Array:
    """out[i] = img[(int)(i - c)] along ``axis`` with NaN where the
    reference's bounds check fails — the exact clcode.cl:1034,1039
    semantics: truncation of the *projected coordinate*, so the valid
    window is ``-1 < i - c < n`` and an in-window ``i - c`` in (-1, 0)
    reads line 0 (``c`` is static)."""
    import math

    n = img.shape[axis]
    s = int(math.ceil(c))  # in-window trunc(i - c) == i - s, clamped at 0
    lo = int(math.floor(c))  # first valid i
    hi = n - 1 + s  # last valid i
    idx = [np.clip(i - s, 0, n - 1) if lo <= i <= hi else -1 for i in range(n)]
    take = np.asarray([max(j, 0) for j in idx])
    out = jnp.take(img, take, axis=axis)
    bad = np.asarray(idx) < 0
    if bad.any():
        shape = [1] * img.ndim
        shape[axis] = n
        out = jnp.where(jnp.reshape(jnp.asarray(bad), shape), jnp.nan, out)
    return out


def _shift2d(img: jax.Array, cx: float, cy: float) -> jax.Array:
    """out[y, x] = img[(int)(y - cy), (int)(x - cx)] with NaN outside the
    reference's valid window (img: (..., H, W, C))."""
    return _resample_axis(_resample_axis(img, cy, img.ndim - 3), cx, img.ndim - 2)


def _box_sum(x: jax.Array, radius: int) -> jax.Array:
    """Separable (2r+1)^2 box sum with zero padding (x: (..., H, W)).

    Direct shifted adds (rows first, then columns, ascending offset) — the
    same association order as the Pallas kernel, so costs match bitwise and
    WTA ties resolve identically."""
    if radius == 0:
        return x
    k = 2 * radius + 1

    def slide(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        p = jnp.pad(a, pad)
        n = a.shape[axis]
        out = jax.lax.slice_in_dim(p, 0, n, axis=axis)
        for i in range(1, k):
            out = out + jax.lax.slice_in_dim(p, i, i + n, axis=axis)
        return out

    return slide(slide(x, -2), -1)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def plane_sweep_depth(
    lab: jax.Array,  # (V, H, W, 3) Lab images
    disp_levels: tuple[float, ...],
    pairs: tuple[tuple[int, int, int, int], ...],  # (ref, view, dvx, dvy) static
    bl_ratio: float,
    window_radius: int = 2,
) -> tuple[jax.Array, jax.Array]:
    """Dense plane sweep for a static set of (reference, neighbor) pairs.

    Every pixel of every reference view gets a disparity.  ``pairs`` lists,
    per reference view, the neighbor views with their camera-grid deltas;
    the cost per hypothesis is min over that view's pairs.

    Returns (disp (V, H, W) float32, cost (V, H, W) float32 winning cost).
    """
    v, h, w = lab.shape[:3]
    d = len(disp_levels)

    best_cost = jnp.full((v, h, w), _BIG, jnp.float32)
    best_disp = jnp.zeros((v, h, w), jnp.float32)

    for disp in disp_levels:
        per_ref_min = jnp.full((v, h, w), _BIG, jnp.float32)
        for (ref, view, dvx, dvy) in pairs:
            # C cast semantics: the reference truncates the *projected
            # coordinate* (clcode.cl:1034) — folded into _shift2d.
            moved = _shift2d(lab[view], disp * dvx, bl_ratio * disp * dvy)
            sad = jnp.sum(jnp.abs(lab[ref] - moved), axis=-1)
            oob = jnp.isnan(sad)
            sad = jnp.where(oob, _OOB_PENALTY, sad)
            agg = _box_sum(sad, window_radius)
            per_ref_min = per_ref_min.at[ref].min(agg)
        take = per_ref_min < best_cost
        best_cost = jnp.where(take, per_ref_min, best_cost)
        best_disp = jnp.where(take, jnp.float32(disp), best_disp)
    return best_disp, best_cost


def build_pairs(
    view_subset, subset_num, array_width: int
) -> tuple[tuple[int, int, int, int], ...]:
    """Static pair list from the config's view-subset tables."""
    pairs = []
    v = view_subset.shape[0]
    for z in range(v):
        for n in range(int(subset_num[z])):
            view = int(view_subset[z, n])
            dvx = view % array_width - z % array_width
            dvy = view // array_width - z // array_width
            pairs.append((z, view, dvx, dvy))
    return tuple(pairs)
