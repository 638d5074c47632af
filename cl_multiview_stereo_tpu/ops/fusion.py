"""Fusion: plane rasterization and cross-view consistency filtering.

Behavioral spec (``clMVDE/clcode.cl`` + ``depth_refinement.cpp:1318-1470``):
  * ``spixl_to_image`` (cl:1906-1931) — rasterize each superpixel's refined
    plane back to per-pixel disparity: the only fusion stage live in the
    shipping binary (the ``results/8- Fusion`` images).
  * ``project_to_reference_inv`` (cl:1995-2034) — occlusion-aware gather
    warp: for each reference pixel, probe every other view at the
    disparity-shifted location and keep the *largest* disparity (nearest
    surface), with the probe using the evolving maximum sequentially over
    views in index order.
  * ``remove_view_inconsistency`` (cl:2037-2101) — stability vote: a
    candidate disparity earns +-1 votes from per-pixel agreement across the
    warped maps and from cross-view lookups in the unwarped maps; the
    largest stable disparity wins.

The last two sit in a disabled comment block in the reference
(depth_refinement.cpp:1374-1453) whose per-view loop ordering would read
uninitialized planes; here we implement the *intended* pipeline (SURVEY.md
section 7.2 step 6): warp all views first, then vote.  ``cross_check=False``
reproduces exactly what the shipping binary produced.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _cl_round(x: jax.Array) -> jax.Array:
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def select_cell_lookup(
    labels: jax.Array,  # (V, H, W) int32 per-pixel superpixel label
    fields: jax.Array,  # (V, Mh, Mw, C) per-superpixel data
    spixl_size: int,
    radius: int = 1,
    *,
    stacked: bool = True,
) -> jax.Array | list[jax.Array]:
    """Gather-free per-pixel lookup of the owning superpixel's fields.

    ``fields.reshape(-1, C)[labels]`` is one random gather row per pixel
    (18.7M rows at 9x1080p).  But SLIC confines every pixel's label to the
    3x3 cell window around the pixel's own grid cell (the assignment search
    of clcode.cl:461-468 only offers candidates with |cell delta| <= 1, and
    the update drops members outside their cluster's 3S x 3S window), so
    the lookup is a sum of
    ``(2*radius+1)^2`` compare-selects against shifted upsampled cell maps —
    pure fused vector math.  Each ``supress_local_lable`` pass
    (clcode.cl:676-711, +-2 px adoption) widens the bound by one cell:
    ``radius = 1 + number_of_suppress_passes``.

    Exactness: exactly one candidate matches per pixel, and ``x + 0 == x``
    in IEEE fp, so the result is bitwise identical to the gather form.  A
    pixel whose label violates the radius bound (impossible for labels
    produced by ops/slic.segment) yields 0.

    ``stacked=False`` returns the C per-channel ``(V, H, W)`` planes as a
    list instead of one ``(V, H, W, C)`` stack.  Callers that relayout the
    result into a flat gather table MUST take this form and barrier it (see
    ``refine._rasterize_flat``): reshaping the stacked output to ``(N, C)``
    makes XLA propagate the transposed table layout upstream through the
    whole select chain, materializing every per-window match mask as a
    padded ``pred[N,1]`` temporary, enough to run the single-jit program out
    of device memory.
    """
    v, h, w = labels.shape
    mh, mw = fields.shape[1:3]
    c = fields.shape[3]
    s = spixl_size
    cx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None] // s  # (1,H,W)
    cy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None] // s

    # channel-planar accumulation: accumulate per-field (V, H, W) planes
    # (the wide W axis minor, not the tiny C) and stack once at the end
    out = [jnp.zeros((v, h, w), jnp.float32) for _ in range(c)]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            qx = cx + dx
            qy = cy + dy
            inb = (qx >= 0) & (qy >= 0) & (qx < mw) & (qy < mh)
            match = inb & (labels == qy * mw + qx)
            # shifted cell map, upsampled to pixels; roll wraps only at
            # cells where match is already False
            f = jnp.roll(fields, (-dy, -dx), axis=(1, 2))
            for ci in range(c):
                up = jnp.broadcast_to(
                    f[:, :, None, :, None, ci], (v, mh, s, mw, s)
                ).reshape(v, mh * s, mw * s)[:, :h, :w]
                out[ci] = out[ci] + jnp.where(match, up, 0.0)
    if not stacked:
        return out
    return jnp.stack(out, axis=-1)


@partial(jax.jit, static_argnames=("spixl_size", "label_radius"))
def rasterize_planes(
    labels: jax.Array,  # (V, H, W) int32
    centers: jax.Array,  # (V, Mh, Mw, 2)
    state_d: jax.Array,  # (V, Mh, Mw)
    state_n: jax.Array,  # (V, Mh, Mw, 3)
    *,
    spixl_size: int = 8,
    label_radius: int = 1,
) -> jax.Array:
    """``spixl_to_image``: per-pixel disparity from the owning superpixel's
    plane: ``d(p) = (n . (c - p) + nz * d) / nz`` (cl:1928).  Gather-free
    (see ``select_cell_lookup``); bitwise equal to
    ``rasterize_planes_gather``."""
    pack = jnp.concatenate([centers, state_d[..., None], state_n], axis=-1)
    g = select_cell_lookup(labels, pack, spixl_size, label_radius)
    h, w = labels.shape[1:3]
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None].astype(jnp.float32)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None].astype(jnp.float32)
    return (
        g[..., 3] * (g[..., 0] - px) + g[..., 4] * (g[..., 1] - py) + g[..., 5] * g[..., 2]
    ) / g[..., 5]


@jax.jit
def rasterize_planes_gather(
    labels: jax.Array,  # (V, H, W) int32
    centers: jax.Array,  # (V, Mh, Mw, 2)
    state_d: jax.Array,  # (V, Mh, Mw)
    state_n: jax.Array,  # (V, Mh, Mw, 3)
) -> jax.Array:
    """Gather formulation of ``rasterize_planes`` (one packed 6-float row
    per pixel) — kept as the differential-test reference for the select
    path and for label layouts that do not satisfy the radius bound."""
    v, h, w = labels.shape
    mh, mw = centers.shape[1:3]
    vid = jnp.arange(v, dtype=jnp.int32)[:, None, None]
    flat_sp = (vid * (mh * mw) + labels).reshape(-1)
    pack = jnp.concatenate(
        [centers, state_d[..., None], state_n], axis=-1
    ).reshape(-1, 6)
    g = pack[flat_sp].reshape(v, h, w, 6)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None].astype(jnp.float32)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None].astype(jnp.float32)
    return (
        g[..., 3] * (g[..., 0] - px) + g[..., 4] * (g[..., 1] - py) + g[..., 5] * g[..., 2]
    ) / g[..., 5]


@partial(jax.jit, static_argnums=(1, 2))
def project_to_reference_inv(
    disp_full: jax.Array,  # (V, H, W)
    array_width: int,
    bl_ratio: float,
) -> jax.Array:
    """Occlusion-aware inverse warp for every reference view at once
    (cl:1995-2034).  The probe chain is sequential over source views in
    index order, using the evolving maximum — preserved via ``fori_loop``.
    """
    v, h, w = disp_full.shape
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None]
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None]
    ref = jnp.arange(v, dtype=jnp.int32)[:, None, None]
    cam_ref_x = ref % array_width
    cam_ref_y = ref // array_width

    def body(i, min_disp):
        cam_x = i % array_width
        cam_y = i // array_width
        xp = (
            px.astype(jnp.float32)
            - _cl_round(min_disp * (cam_ref_x - cam_x).astype(jnp.float32))
        ).astype(jnp.int32)
        yp = (
            py.astype(jnp.float32)
            - _cl_round(bl_ratio * min_disp * (cam_ref_y - cam_y).astype(jnp.float32))
        ).astype(jnp.int32)
        inb = (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)
        probe = disp_full[i, jnp.clip(yp, 0, h - 1), jnp.clip(xp, 0, w - 1)]
        better = inb & (min_disp < probe) & (i != ref)
        return jnp.where(better, probe, min_disp)

    return jax.lax.fori_loop(0, v, body, disp_full)


@partial(jax.jit, static_argnums=(2, 3, 4))
def remove_view_inconsistency(
    disp_proj: jax.Array,  # (V, H, W) warped-to-reference maps
    disp_full: jax.Array,  # (V, H, W) unwarped per-view maps
    array_width: int,
    bl_ratio: float,
    fuse: float,
) -> jax.Array:
    """Stability vote (cl:2037-2101), evaluated for every reference view.

    Vote rules preserved exactly: warped-map agreement votes with
    ``> fuse -> -1`` / ``<= fuse -> +1`` (cl:2065-2069), cross-view lookup
    votes with ``> fuse -> -1`` / ``< fuse -> +1`` (cl:2087-2091, equality
    abstains); the winner is the largest d with ``stability >= 0``.
    """
    v, h, w = disp_proj.shape
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None]
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None]
    ref = jnp.arange(v, dtype=jnp.int32)[:, None, None]
    cam_ref_x = (ref % array_width).astype(jnp.float32)
    cam_ref_y = (ref // array_width).astype(jnp.float32)

    def cand_body(i, d_est):
        d = disp_proj[i][None]  # candidate from view i, broadcast over refs
        d = jnp.broadcast_to(d, (v, h, w))
        stability = jnp.zeros((v, h, w), jnp.float32)
        # vote 1: agreement among warped maps at the same pixel
        for j in range(v):
            d_check = disp_proj[j][None]
            nz = d_check != 0
            diff = jnp.abs(d_check - d)
            stability = stability + jnp.where(
                nz, jnp.where(diff > fuse, -1.0, 1.0), 0.0
            )
        # vote 2: cross-view lookups in the unwarped maps
        for j in range(v):
            cam_x = float(j % array_width)
            cam_y = float(j // array_width)
            xj = (
                px.astype(jnp.float32) - _cl_round(d * (cam_x - cam_ref_x))
            ).astype(jnp.int32)
            yj = (
                py.astype(jnp.float32)
                - _cl_round(bl_ratio * d * (cam_y - cam_ref_y))
            ).astype(jnp.int32)
            inb = (xj >= 0) & (yj >= 0) & (xj < w) & (yj < h)
            d_check = disp_full[j, jnp.clip(yj, 0, h - 1), jnp.clip(xj, 0, w - 1)]
            diff = jnp.abs(d_check - d)
            vote = jnp.where(diff > fuse, -1.0, 0.0) + jnp.where(diff < fuse, 1.0, 0.0)
            stability = stability + jnp.where(inb, vote, 0.0)
        take = (d != 0) & (stability >= 0) & ((d_est == 0) | (d_est < d))
        return jnp.where(take, d, d_est)

    return jax.lax.fori_loop(
        0, v, lambda i, a: cand_body(i, a), jnp.zeros((v, h, w), jnp.float32)
    )


def fuse_views(
    labels, centers, state_d, state_n, array_width: int, bl_ratio: float, fuse: float,
    *, cross_check: bool = False, spixl_size: int = 8, label_radius: int = 1,
):
    """Full fusion stage.  ``cross_check=False`` matches the shipping
    reference (rasterization only); ``True`` adds the intended warp + vote."""
    disp_full = rasterize_planes(
        labels, centers, state_d, state_n,
        spixl_size=spixl_size, label_radius=label_radius,
    )
    if not cross_check:
        return disp_full
    disp_proj = project_to_reference_inv(disp_full, array_width, bl_ratio)
    return remove_view_inconsistency(
        disp_proj, disp_full, array_width, bl_ratio, fuse
    )
