"""Feature detection, description and matching (north-star extension).

The reference has no SfM front-end at all (SURVEY.md section 0: the camera
model is an implicit rectified grid).  This module supplies the front-end
the north star requires: Harris corners, normalized patch descriptors, and
mutual-nearest matching — all shape-static, batched over views, with the
descriptor-distance matrix as one matrix product.

Design choices:
  * fixed K corners per view (top-K, not thresholding) so every shape is
    static;
  * non-max suppression via 2D max-pool comparison, no sorting loops;
  * matching = one (K, D) x (D, K) matmul per view pair + argmin rows/cols.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    xy: jax.Array  # (V, K, 2) float32 pixel coords (x, y)
    score: jax.Array  # (V, K) float32 Harris response (-inf for padding)
    desc: jax.Array  # (V, K, D) float32 L2-normalized descriptors


def _box(x: jax.Array, r: int) -> jax.Array:
    """(2r+1)^2 box sum over the trailing two axes via separable cumsum."""
    k = 2 * r + 1

    def slide(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r + 1, r)
        c = jnp.cumsum(jnp.pad(a, pad), axis=axis)
        hi = jax.lax.slice_in_dim(c, k, c.shape[axis], axis=axis)
        lo = jax.lax.slice_in_dim(c, 0, c.shape[axis] - k, axis=axis)
        return hi - lo

    return slide(slide(x, -1), -2)


@partial(jax.jit, static_argnames=("k", "nms_radius", "patch"))
def harris_keypoints(
    gray: jax.Array,  # (V, H, W) float32 intensity
    k: int = 512,
    nms_radius: int = 4,
    patch: int = 8,
    harris_k: float = 0.04,
) -> Keypoints:
    """Top-``k`` Harris corners per view with patch descriptors."""
    v, h, w = gray.shape
    gx = (jnp.roll(gray, -1, axis=2) - jnp.roll(gray, 1, axis=2)) * 0.5
    gy = (jnp.roll(gray, -1, axis=1) - jnp.roll(gray, 1, axis=1)) * 0.5
    ixx = _box(gx * gx, 2)
    iyy = _box(gy * gy, 2)
    ixy = _box(gx * gy, 2)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = det - harris_k * tr * tr

    # suppress borders (gradient wrap + patch extraction margin)
    m = max(nms_radius, patch // 2 + 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None]
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None]
    interior = (col >= m) & (row >= m) & (col < w - m) & (row < h - m)
    resp = jnp.where(interior, resp, -jnp.inf)

    # NMS: keep strict local maxima of a (2r+1)^2 window
    rad = nms_radius
    neigh = -jnp.inf * jnp.ones_like(resp)
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            if dx == 0 and dy == 0:
                continue
            neigh = jnp.maximum(neigh, jnp.roll(resp, (-dy, -dx), axis=(1, 2)))
    is_max = resp > neigh
    scores = jnp.where(is_max, resp, -jnp.inf).reshape(v, -1)

    top_s, top_i = jax.lax.top_k(scores, k)  # (V, K)
    ky = (top_i // w).astype(jnp.float32)
    kx = (top_i % w).astype(jnp.float32)
    xy = jnp.stack([kx, ky], axis=-1)

    # patch descriptors: normalized (patch x patch) intensity around each kp
    half = patch // 2
    offs = jnp.arange(-half, half, dtype=jnp.int32)
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")
    py = (top_i // w)[..., None, None] + oy[None, None]
    px = (top_i % w)[..., None, None] + ox[None, None]
    vid = jnp.arange(v, dtype=jnp.int32)[:, None, None, None]
    patches = gray[vid, jnp.clip(py, 0, h - 1), jnp.clip(px, 0, w - 1)]
    d = patches.reshape(v, k, patch * patch)
    d = d - jnp.mean(d, axis=-1, keepdims=True)
    d = d / (jnp.linalg.norm(d, axis=-1, keepdims=True) + 1e-6)
    return Keypoints(xy=xy, score=top_s, desc=d)


class Matches(NamedTuple):
    idx: jax.Array  # (P, M, 2) int32 keypoint indices (in view a, in view b)
    valid: jax.Array  # (P, M) bool


@partial(jax.jit, static_argnames=("max_matches", "ratio"))
def match_pairs(
    kp: Keypoints,
    pairs: jax.Array,  # (P, 2) int32 view-index pairs
    max_matches: int = 256,
    ratio: float = 0.9,
) -> Matches:
    """Mutual-nearest descriptor matching with Lowe ratio test, per pair.

    Distances via one matrix product per pair (descriptors are
    L2-normalized so ``d2 = 2 - 2 * a.b``); ``run_sfm`` traces it at full
    float32 precision.
    """

    def one_pair(pair):
        a, b = pair[0], pair[1]
        da, db = kp.desc[a], kp.desc[b]  # (K, D)
        sim = jnp.dot(da, db.T, preferred_element_type=jnp.float32)  # (K, K)
        # two best similarities per row for the ratio test
        top2, top2_i = jax.lax.top_k(sim, 2)
        best_b = top2_i[:, 0]
        # mutual check
        best_a_of_b = jnp.argmax(sim, axis=0)  # (K,)
        mutual = best_a_of_b[best_b] == jnp.arange(sim.shape[0])
        # ratio on squared distance: d2 = 2 - 2 s
        d1 = 2.0 - 2.0 * top2[:, 0]
        d2 = 2.0 - 2.0 * top2[:, 1]
        good = mutual & (d1 < ratio * ratio * d2)
        good = good & jnp.isfinite(kp.score[a]) & (kp.score[a] > -jnp.inf)
        # take up to max_matches by similarity
        key = jnp.where(good, top2[:, 0], -jnp.inf)
        sel_s, sel_i = jax.lax.top_k(key, max_matches)
        out_idx = jnp.stack([sel_i, best_b[sel_i]], axis=-1).astype(jnp.int32)
        return out_idx, sel_s > -jnp.inf

    idx, valid = jax.vmap(one_pair)(pairs)
    return Matches(idx=idx, valid=valid)
