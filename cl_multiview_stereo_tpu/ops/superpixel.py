"""Superpixel extent (radial footprint) computation.

Behavioral spec: kernel ``find_super_pixel_boundary``
(``clMVDE/clcode.cl:791-855``): from each superpixel's (border-clamped)
center, walk 8 compass rays up to ``spixl_size-1`` steps and record ``i-1``
for the *last* radius ``i`` whose pixel still carries this superpixel's
label.  The result (the reference's ``uchar8 spixl_rep``) is the adaptive
sample footprint used by depth init and the consistency terms.

The walk is a static unrolled loop of gathers over all
``(V, Mh, Mw)`` superpixels at once — radius and direction count are
compile-time constants, so XLA sees a fixed fusion of 8*(S-1) gathers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cl_multiview_stereo_tpu.config import DerivedGeometry

# Compass slot order nw, w, sw, n, s, ne, e, se as (dx, dy)
# (clcode.cl:826-851); shared with testing.mirror.EXTENT_DIRS.
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def clamp_center(cx: jax.Array, cy: jax.Array, w: int, h: int, s: int):
    """Center clamp of clcode.cl:809-819 (keeps the walk in-view)."""
    cx = jnp.where(cx < s, s, cx)
    cx = jnp.where(cx + s > w, cx - s, cx)
    cy = jnp.where(cy < s, s, cy)
    cy = jnp.where(cy + s > h, cy - s, cy)
    return cx, cy


@partial(jax.jit, static_argnums=(2,))
def superpixel_extent_walk(
    labels: jax.Array, centers: jax.Array, geom: DerivedGeometry
) -> jax.Array:
    """Direct form of the 8-direction extent: 8*(S-1) narrow gathers (one
    per radius and compass direction).  Kept as the differential oracle for
    :func:`superpixel_extent` (the windowed-gather form below) — both are
    bitwise equal; this one issues ~30x more gather rows.

    ``labels``: (V, H, W) int32 per-view flat labels;
    ``centers``: (V, Mh, Mw, 2) float32 (x, y).
    Returns (V, Mh, Mw, 8) int32.
    """
    v, h, w = labels.shape
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h

    cx = centers[..., 0].astype(jnp.int32)  # C cast truncates; centers >= 0
    cy = centers[..., 1].astype(jnp.int32)
    cx, cy = clamp_center(cx, cy, w, h, s)

    mxg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)
    myg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)
    own_id = (myg * mw + mxg)[None]  # (1, Mh, Mw)

    vidx = jnp.arange(v, dtype=jnp.int32)[:, None, None]
    ext = jnp.zeros((v, mh, mw, 8), jnp.int32)
    for i in range(1, s):
        for k, (dx, dy) in enumerate(_DIRS):
            px = cx + i * dx
            py = cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            lab_at = labels[vidx, jnp.clip(py, 0, h - 1), jnp.clip(px, 0, w - 1)]
            match = inb & (lab_at == own_id)
            ext = ext.at[..., k].set(jnp.where(match, i - 1, ext[..., k]))
    return ext


def _window_gather_i32(table: jax.Array, row_id: jax.Array, col_start, win: int):
    """Gather ``win``-wide int32 windows at (row_id, col_start) — via
    ALIGNED full-row takes plus a static rotation.

    Rather than a ``lax.gather`` with slice size (1, win) at arbitrary
    column offsets, this takes full rows of a (rows*B, 2*win) OVERLAPPED
    block table; the window is then one of ``win`` static slices of the
    2*win row, picked by a select ladder."""
    rows, cols = table.shape
    b_cnt = -(-cols // win) + 1  # one extra block: the overlap roll's wrap
    pad_c = b_cnt * win - cols
    tp = jnp.pad(table, ((0, 0), (0, pad_c)), constant_values=-1)
    a = tp.reshape(rows, b_cnt, win)
    blocks = jnp.concatenate(
        [a, jnp.roll(a, -1, axis=1)], axis=-1
    )  # (rows, B, 2win): block b spans cols [win*b, win*b + 2win)
    flat = blocks.reshape(rows * b_cnt, 2 * win)
    col_start = jnp.broadcast_to(col_start, row_id.shape)
    b = jnp.clip(col_start // win, 0, b_cnt - 1)
    rot = jnp.clip(col_start - b * win, 0, win - 1)
    w2 = flat[(row_id * b_cnt + b).reshape(-1)].reshape(
        row_id.shape + (2 * win,)
    )
    out = jnp.full(row_id.shape + (win,), -1, table.dtype)
    for s in range(win):
        sl = jax.lax.slice_in_dim(w2, s, s + win, axis=-1)
        out = jnp.where((rot == s)[..., None], sl, out)
    return out


@partial(jax.jit, static_argnums=(2,))
def superpixel_extent(
    labels: jax.Array, centers: jax.Array, geom: DerivedGeometry
) -> jax.Array:
    """8-direction extent via 4 windowed gathers per superpixel.

    Same semantics as :func:`superpixel_extent_walk` (kernel
    ``find_super_pixel_boundary``, clcode.cl:791-855), restructured to
    gather fewer, wider rows: the walk probes pixels on 8 rays of
    length S-1, and each OPPOSING ray pair lies on one straight line
    through the center — one gathered ``2(S-1)+2``-element window along
    that line covers every probe of both directions.  Horizontal windows
    come from the row-major label image, vertical from its transpose, and
    the two diagonal families from column-sheared copies (rows of the
    sheared image are the diagonals).  56 narrow gather rows per
    superpixel become 4 wide ones.
    """
    v, h, w = labels.shape
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h
    r = s - 1
    win = 2 * r + 2  # offsets -r..r (+1 pad keeps the slice power-of-two-ish)

    cx = centers[..., 0].astype(jnp.int32)
    cy = centers[..., 1].astype(jnp.int32)
    cx, cy = clamp_center(cx, cy, w, h, s)

    mxg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)
    myg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)
    own_id = (myg * mw + mxg)[None]  # (1, Mh, Mw)
    vr = jnp.arange(v, dtype=jnp.int32)[:, None, None]

    pad = lambda a, axis_pad: jnp.pad(a, axis_pad, constant_values=-1)

    # --- horizontal: rows of the label image --------------------------------
    t_h = pad(labels, ((0, 0), (0, 0), (r, r + 2))).reshape(v * h, -1)
    w_h = _window_gather_i32(t_h, vr * h + cy, cx, win)  # [..., r+o] = (cx+o, cy)

    # --- vertical: rows of the transpose ------------------------------------
    t_v = pad(jnp.swapaxes(labels, 1, 2), ((0, 0), (0, 0), (r, r + 2)))
    t_v = t_v.reshape(v * w, -1)
    w_v = _window_gather_i32(t_v, vr * w + cx, cy, win)  # [..., r+o] = (cx, cy+o)

    # --- diagonals: rows of column-sheared copies ----------------------------
    # main (dx == dy): pad rows to Wp then re-reshape with row stride Wp+1 —
    # row y of the result is the source row shifted by y, so the (x - y)
    # diagonals become columns; transpose makes them rows.
    lpad = h - 1
    wp = lpad + w + 1
    base = pad(labels, ((0, 0), (0, 0), (lpad, 1)))  # (V, H, Wp)
    flat = pad(base.reshape(v, -1), ((0, 0), (0, h)))
    sh_main = flat[:, : h * (wp + 1)].reshape(v, h, wp + 1)
    # sh_main[v, y, x''] = labels[v, y, x'' + y - lpad]  (junk -1 padding
    # elsewhere); diagonal id x'' = x - y + lpad
    t_dp = pad(jnp.swapaxes(sh_main, 1, 2), ((0, 0), (0, 0), (r, r + 2)))
    t_dp = t_dp.reshape(v * (wp + 1), -1)
    row_dp = vr * (wp + 1) + (cx - cy + lpad)
    w_dp = _window_gather_i32(t_dp, row_dp, cy, win)  # [..., r+o] = (cx+o, cy+o)

    # anti (dx == -dy): row stride Wp-1 shifts row y by -y, so the (x + y)
    # anti-diagonals become columns.  No LEFT pad here — x + y is already
    # non-negative, and a left pad would push the diagonal ids past the
    # stride (reproduced as slot-2/5 mismatches in the differential test).
    wpa = w + h  # stride wpa - 1 = w + h - 1 > max id x + y = w + h - 2
    base_a = pad(labels, ((0, 0), (0, 0), (0, wpa - w)))  # (V, H, Wpa)
    flat_a = base_a.reshape(v, -1)
    sh_anti = flat_a[:, : h * (wpa - 1)].reshape(v, h, wpa - 1)
    # sh_anti[v, y, x''] = labels[v, y, x'' - y]; anti id x'' = x + y
    t_dm = pad(jnp.swapaxes(sh_anti, 1, 2), ((0, 0), (0, 0), (r, r + 2)))
    t_dm = t_dm.reshape(v * (wpa - 1), -1)
    row_dm = vr * (wpa - 1) + (cx + cy)
    w_dm = _window_gather_i32(t_dm, row_dm, cy, win)  # [..., r+o] = (cx-o, cy+o)

    # --- decode: last matching radius - 1 per direction ----------------------
    def ray_ext(window, sign, dx, dy):
        best = jnp.zeros((v, mh, mw), jnp.int32)
        for i in range(1, s):
            px = cx + i * dx
            py = cy + i * dy
            inb = (px >= 0) & (py >= 0) & (px < w) & (py < h)
            match = inb & (window[..., r + sign * i] == own_id)
            best = jnp.where(match, i, best)
        return jnp.maximum(best - 1, 0)

    # _DIRS slot order: nw, w, sw, n, s, ne, e, se as (dx, dy)
    ext = jnp.stack(
        [
            ray_ext(w_dp, -1, -1, -1),  # nw: (cx-i, cy-i)
            ray_ext(w_h, -1, -1, 0),    # w
            ray_ext(w_dm, +1, -1, 1),   # sw: (cx-i, cy+i)
            ray_ext(w_v, -1, 0, -1),    # n
            ray_ext(w_v, +1, 0, 1),     # s
            ray_ext(w_dm, -1, 1, -1),   # ne: (cx+i, cy-i)
            ray_ext(w_h, +1, 1, 0),     # e
            ray_ext(w_dp, +1, 1, 1),    # se
        ],
        axis=-1,
    )
    return ext


def extent_step(ext: jax.Array) -> jax.Array:
    """Adaptive sample-grid step from the extent bounding box
    (clcode.cl:997-1007): step = max(1, 0.25*(bb_near + bb_far)) per axis.

    ``ext``: (..., 8) int32.  Returns (..., 2) float32 (step_x, step_y).
    """
    e = ext.astype(jnp.float32)
    bb_l = jnp.maximum(e[..., 0], jnp.maximum(e[..., 1], e[..., 2]))
    bb_r = jnp.maximum(e[..., 5], jnp.maximum(e[..., 6], e[..., 7]))
    bb_t = jnp.maximum(e[..., 0], jnp.maximum(e[..., 3], e[..., 5]))
    bb_b = jnp.maximum(e[..., 2], jnp.maximum(e[..., 4], e[..., 7]))
    sx = jnp.maximum(1.0, 0.25 * (bb_l + bb_r))
    sy = jnp.maximum(1.0, 0.25 * (bb_t + bb_b))
    return jnp.stack([sx, sy], axis=-1)


# Sample index layout of the consistency terms (clcode.cl:1271-1305): the
# 3x3 grid position (i, j), i outer in -1..1 mapping to x, j inner mapping
# to y, reads extent slot (i+1)*3 + (j+1) from [s0,s1,s2,s3,0,s4,s5,s6,s7].
def consistency_samples(ext: jax.Array) -> jax.Array:
    """Per-superpixel 9-point sample offsets used by the consistency terms.

    Returns (..., 9, 2) int32 offsets (dx, dy) such that sample p is at
    ``center + offset`` — offset = (r*i, r*j) with r the slot radius.
    """
    e = ext
    zeros = jnp.zeros_like(e[..., 0])
    radii = jnp.stack(
        [e[..., 0], e[..., 1], e[..., 2], e[..., 3], zeros, e[..., 4], e[..., 5], e[..., 6], e[..., 7]],
        axis=-1,
    )  # (..., 9) in (i, j) row-major order
    ii = jnp.asarray([-1, -1, -1, 0, 0, 0, 1, 1, 1], jnp.int32)
    jj = jnp.asarray([-1, 0, 1, -1, 0, 1, -1, 0, 1], jnp.int32)
    return jnp.stack([radii * ii, radii * jj], axis=-1)
