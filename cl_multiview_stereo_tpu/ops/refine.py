"""Superpixel plane refinement: flatness, state init, PatchMatch propagation.

Behavioral spec (all ``clMVDE/clcode.cl``):
  * ``compute_flatness``       (cl:1076-1132) — 4-neighbor color variation ->
    ``(exp(-fl*g), 1-exp(-0.25*fl*g))`` weights
  * ``init_smoothness``        (cl:1136-1254) — disparity-agreement score vs
    8 ring neighbors + 4-direction long-range taps at flatness-scaled pitch
  * ``initialize_consistency`` (cl:1260-1357) — cross-view visibility score
    over the 9 extent sample points under fronto-parallel projection
  * ``init_current_state``     (cl:1362-1404) — state = (d, sm, cs, 0,0,1)
  * ``compute_smoothness``     (cl:1407-1525) — like init but extrapolates a
    *candidate plane* (n, d) to each neighbor center
  * ``compute_consistency``    (cl:1528-1631) — plane-interpolates both the
    reference samples and the hit superpixel's stored plane
  * ``update``                 (cl:1635-1673) — PatchMatch propagation move
    with acceptance ``(iter<4 && sm1*similarity>sm0) || cs1*sm1 > sm0*cs0``
  * ``spatialRefinement``      (cl:1687-1723) — plane re-fit through two ring
    neighbors, acceptance ``(iter<4 && sm1>sm0) || sm1*cs1 > sm0*cs0``
  * ``propagate``              (cl:1727-1900) — the per-superpixel move chain
    (8 immediate + 4*steps long-range + 8 refinement moves), Jacobi-swept
    with ping-pong state buffers (depth_refinement.cpp:744-753)

Design — the scoring terms are restructured around what is
*move-independent* within one Jacobi sweep (the input state is frozen, so
almost everything is):

  * smoothness tap positions, tap data (neighbor centers/colors/disparities)
    and the color-similarity weights — including the entire weight
    normalizer — depend only on the input state; they are gathered ONCE per
    iteration into a dense tap cache ``(V, Mh, Mw, T, ch)``.  Each move's
    smoothness is then pure vector math (plane extrapolation + exp + dot),
    no gathers at all.
  * the consistency term's neighbor-view lookup chain
    (pixel -> idx_img -> superpixel -> stored plane -> plane interpolation
    at the hit pixel, cl:1581-1597) is algebraically identical to reading
    the *rasterized* input state (``spixl_to_image`` of state_in) at the
    projected pixel.  We rasterize disparity once per iteration, pack it
    with the per-pixel superpixel color into one flat ``(V*H*W, 4)`` table,
    and each move's consistency is ONE fused gather + vector math.
  * the 8+4*steps ``update``-move candidate planes (neighbor plane
    extrapolated to own center, cl:1649) depend only on the input state,
    so they are pre-gathered as a batch; the move chain itself is a
    ``lax.scan`` whose carry is each superpixel's evolving best plane —
    bitwise the same accept sequence as the reference's per-thread loop.

Parameter conventions: ``gamma``/``alpha`` are the *effective* multipliers
``1/(2*gamma_cfg^2)`` etc. (RefinementSchedule); ``steps``/``step_size`` the
per-iteration decayed reach.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_MARGIN = 0.01
_EPS_SM = 0.000001
_FLT_MIN = 1.1754944e-38  # smallest normal float32
# Moves scored together in one batched gather (bounds the (C, V, Mh, Mw,
# n_views, 9) consistency temporaries to ~C x 100 MB at 1080p x 9 views).
# Import-time constant; the env override exists for memory probes
# (tools/memcheck.py) — changing it mid-process has no effect on already-
# traced programs.
import os as _os

_SCORE_CHUNK = int(_os.environ.get("REFINE_SCORE_CHUNK", "4"))


class RefineState(NamedTuple):
    """The reference's ``float[6]`` per-superpixel state (cl:1398-1403)."""

    d: jax.Array  # (V, Mh, Mw)
    sm: jax.Array  # (V, Mh, Mw)
    cs: jax.Array  # (V, Mh, Mw)
    n: jax.Array  # (V, Mh, Mw, 3)


class RefineContext(NamedTuple):
    """Immutable per-scene arrays shared by every scoring call."""

    center: jax.Array  # (V, Mh, Mw, 2) float32 superpixel centers
    color: jax.Array  # (V, Mh, Mw, 3) float32 superpixel Lab
    disp0: jax.Array  # (V, Mh, Mw) float32 initial disparity (spixl_map.s7)
    labels: jax.Array  # (V, H, W) int32 per-view pixel -> superpixel
    # Consistency sample offsets with the 9-sample axis OFF the minor
    # position, so every per-move intermediate keeps the wide Mw axis minor.
    samples: jax.Array  # (V, Mh, 9, Mw, 2) int32
    fl: jax.Array  # (V, Mh, Mw, 2) float32 flatness weights
    view_subset: jax.Array  # (V, max_n) int32, -1 padded
    dv: jax.Array  # (V, max_n, 2) float32 camera-grid deltas (dvx, dvy)
    ras_color: jax.Array  # (V*H*W, 3) float32 owning superpixel's color/pixel


def make_context(
    center, color, disp0, labels, extent, fl, view_subset, array_width: int,
    *, spixl_size: int = 8, label_radius: int = 1,
) -> RefineContext:
    from cl_multiview_stereo_tpu.ops.fusion import select_cell_lookup
    from cl_multiview_stereo_tpu.ops.superpixel import consistency_samples

    center = jnp.asarray(center)
    color = jnp.asarray(color)
    labels = jnp.asarray(labels)
    v = center.shape[0]
    mh, mw = center.shape[1:3]
    z = jnp.arange(v, dtype=jnp.int32)
    ids = jnp.clip(jnp.asarray(view_subset), 0, v - 1)
    dvx = ((ids % array_width) - (z % array_width)[:, None]).astype(jnp.float32)
    dvy = ((ids // array_width) - (z // array_width)[:, None]).astype(jnp.float32)

    # per-pixel owning-superpixel color, flattened (iteration-independent;
    # gather-free: SLIC labels satisfy the cell-window bound).  Barrier the
    # pixel-layout planes before the flat-table relayout — see
    # select_cell_lookup's stacked=False note.
    planes = select_cell_lookup(
        labels, color, spixl_size, label_radius, stacked=False
    )
    planes = jax.lax.optimization_barrier(tuple(planes))
    ras_color = jnp.concatenate([p.reshape(-1, 1) for p in planes], axis=-1)

    return RefineContext(
        center=center,
        color=color,
        disp0=jnp.asarray(disp0),
        labels=labels,
        samples=jnp.moveaxis(consistency_samples(jnp.asarray(extent)), 3, 2),
        fl=jnp.asarray(fl),
        view_subset=jnp.asarray(view_subset),
        dv=jnp.stack([dvx, dvy], axis=-1),
        ras_color=ras_color,
    )


# ---------------------------------------------------------------------------
# Flatness (cl:1076-1132)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("gamma",))
def compute_flatness(color: jax.Array, gamma: float) -> jax.Array:
    """``color``: (V, Mh, Mw, 3).  Returns (V, Mh, Mw, 2) = (fl, i_fl)."""
    fl = jnp.ones(color.shape[:3], jnp.float32)
    v, mh, mw = color.shape[:3]
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        shifted = jnp.roll(color, shift=(-dy, -dx), axis=(1, 2))
        diff = jnp.sum((shifted - color) ** 2, axis=-1)
        col = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)[None]
        row = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)[None]
        ok = (col + dx >= 0) & (col + dx < mw) & (row + dy >= 0) & (row + dy < mh)
        fl = fl + jnp.where(ok, diff, 0.0)
    return jnp.stack(
        [_f32exp(-fl * gamma), 1.0 - _f32exp(-0.25 * fl * gamma)], axis=-1
    )


# ---------------------------------------------------------------------------
# Iteration cache
# ---------------------------------------------------------------------------


class IterCache(NamedTuple):
    """Move-independent data for one Jacobi sweep (input state frozen)."""

    tap_ax: jax.Array  # (V, Mh, Mw, T) cx - tap_cx
    tap_ay: jax.Array  # (V, Mh, Mw, T) cy - tap_cy
    tap_d: jax.Array  # (V, Mh, Mw, T) input-state disparity at tap
    tap_sim: jax.Array  # (V, Mh, Mw, T) similarity weight (0 if invalid)
    wn: jax.Array  # (V, Mh, Mw) move-independent weight normalizer
    ras: jax.Array  # (V*H*W, 4) packed [state disparity, Lab color] / pixel
    ring_dcx: jax.Array  # (V, Mh, Mw, 8) ring-neighbor cx - cx  (refit moves)
    ring_dcy: jax.Array  # (V, Mh, Mw, 8)
    ring_d: jax.Array  # (V, Mh, Mw, 8) input-state d at ring neighbor
    ring_ok: jax.Array  # (V, Mh, Mw, 8) bool


# Ring neighbor order of the refinement stage (cl:1865-1873), (dx, dy).
_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
# Immediate-neighbor smoothness tap order (cl:1144; order is sum-irrelevant
# but kept for clarity): i (x) outer, j (y) inner.
_IMM = tuple((i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if not (i == 0 and j == 0))


def _rasterize_flat(
    ctx: RefineContext,
    state_d: jax.Array,
    state_n: jax.Array,
    spixl_size: int = 8,
    label_radius: int = 1,
) -> jax.Array:
    """Rasterize the input state to per-pixel disparity (``spixl_to_image``,
    cl:1906-1931) and pack with the per-pixel superpixel color.
    Returns (V*H*W, 4).

    Gather-free: the per-pixel plane lookup uses the SLIC cell-window bound
    (``fusion.select_cell_lookup``) — bitwise equal to the packed-gather
    form without its 18.7M-row gather per iteration at the reference
    config.

    The disparity plane is computed and BARRIERED in pixel ``(V, H, W)``
    layout before the single relayout into the flat gather table: without
    the barrier, XLA propagates the table's transposed ``(N, 1)`` layout
    upstream through the whole select chain and materializes every match
    mask as a padded ``pred[N,1]`` temporary, enough to run the
    single-jit program out of device memory."""
    from cl_multiview_stereo_tpu.ops.fusion import select_cell_lookup

    h, w = ctx.labels.shape[1:3]
    pack = jnp.concatenate([ctx.center, state_d[..., None], state_n], axis=-1)
    g = select_cell_lookup(ctx.labels, pack, spixl_size, label_radius, stacked=False)
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None].astype(jnp.float32)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None].astype(jnp.float32)
    disp = (g[3] * (g[0] - px) + g[4] * (g[1] - py) + g[5] * g[2]) / g[5]
    disp = jax.lax.optimization_barrier(disp)
    return jnp.concatenate([disp.reshape(-1, 1), ctx.ras_color], axis=-1)


def build_cell_cache(
    ctx: RefineContext,
    tgt_d: jax.Array,
    *,
    gamma: float,
    steps: int,
    step_size: float,
):
    """The cell-level (superpixel-grid) part of the sweep cache: smoothness
    tap data + ring-neighbor data.  Split from ``build_cache`` so the
    spatially-sharded path (parallel/spatial.py) can build it on gathered
    cell state while keeping the pixel-level rasterization sharded.

    Returns an ``IterCache`` with ``ras`` unset (zeros placeholder).
    """
    v, mh, mw = tgt_d.shape
    center = ctx.center
    color = ctx.color
    colg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)[None]
    rowg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)[None]

    # tap positions: 8 immediate + 4*steps long-range at flatness pitch
    # (cl:1169 / cl:1437: step_sz = max(1, (int)(fl.x*kss + 0.5)))
    packed = jnp.concatenate([center, color, tgt_d[..., None]], axis=-1)

    # immediate taps sit at STATIC cell offsets: a roll is a relayout-free
    # shift in place of ~2M gather rows; the wrapped border values are
    # exactly the ones masked to sim 0 below
    tap_parts, g_list, ok_list = [], [], []
    for dx, dy in _IMM:
        tap_parts.append(jnp.roll(packed, (-dy, -dx), axis=(1, 2)))
        ok = (colg + dx >= 0) & (rowg + dy >= 0) & (colg + dx < mw) & (rowg + dy < mh)
        g_list.append(gamma)
        ok_list.append(jnp.broadcast_to(ok, tgt_d.shape))

    # long-range taps have data-dependent pitch -> stay a packed gather
    if steps > 0:
        step_sz = jnp.maximum(
            1, (ctx.fl[..., 0] * step_size + 0.5).astype(jnp.int32)
        )
        tx_list, ty_list = [], []
        for i in range(1, steps + 1):
            step = i * step_sz  # (V, Mh, Mw)
            off = step + 1
            for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1)):  # L R U D
                if axis == 0:
                    tx = colg + sign * off
                    ty = jnp.broadcast_to(rowg, tgt_d.shape)
                    ok = (colg > step) if sign < 0 else (colg < mw - step - 1)
                else:
                    tx = jnp.broadcast_to(colg, tgt_d.shape)
                    ty = rowg + sign * off
                    ok = (rowg > step) if sign < 0 else (rowg < mh - step - 1)
                tx_list.append(tx)
                ty_list.append(ty)
                g_list.append(gamma * (1 + i))
                ok_list.append(jnp.broadcast_to(ok, tgt_d.shape))
        tx = jnp.stack(tx_list, axis=-1)  # (V, Mh, Mw, 4*steps)
        ty = jnp.stack(ty_list, axis=-1)
        flat = (
            jnp.arange(v, dtype=jnp.int32)[:, None, None, None] * (mh * mw)
            + jnp.clip(ty, 0, mh - 1) * mw
            + jnp.clip(tx, 0, mw - 1)
        )
        lr = packed.reshape(-1, 6)[flat.reshape(-1)].reshape(v, mh, mw, -1, 6)
        tap = jnp.concatenate(
            [jnp.stack(tap_parts, axis=-2), lr], axis=-2
        )  # (V, Mh, Mw, T, 6)
    else:
        tap = jnp.stack(tap_parts, axis=-2)

    ok = jnp.stack(ok_list, axis=-1)
    gammas = jnp.asarray(g_list, jnp.float32)  # (T,)

    tap_ax = center[..., 0:1] - tap[..., 0]
    tap_ay = center[..., 1:2] - tap[..., 1]
    cdiff = jnp.sum((color[..., None, :] - tap[..., 2:5]) ** 2, axis=-1)
    tap_sim = jnp.where(ok, _f32exp(-cdiff * gammas), 0.0)
    tap_d = tap[..., 5]
    wn = jnp.sum(tap_sim, axis=-1)

    # ring data for the plane-refit moves: static offsets -> rolls too
    rpack = jnp.stack(
        [jnp.roll(packed, (-dy, -dx), axis=(1, 2)) for dx, dy in _RING],
        axis=-2,
    )  # (V, Mh, Mw, 8, 6)
    rtx = jnp.stack([colg + dx for dx, dy in _RING], axis=-1)
    rty = jnp.stack([rowg + dy for dx, dy in _RING], axis=-1)
    rok = (rtx >= 0) & (rty >= 0) & (rtx < mw) & (rty < mh)
    ring_dcx = rpack[..., 0] - center[..., 0:1]
    ring_dcy = rpack[..., 1] - center[..., 1:2]
    ring_d = rpack[..., 5]

    return IterCache(
        tap_ax=tap_ax,
        tap_ay=tap_ay,
        tap_d=tap_d,
        tap_sim=tap_sim,
        wn=wn,
        ras=jnp.zeros((1, 4), jnp.float32),  # filled by build_cache
        ring_dcx=ring_dcx,
        ring_dcy=ring_dcy,
        ring_d=ring_d,
        ring_ok=jnp.broadcast_to(rok, rpack.shape[:4]),
    )


def build_cache(
    ctx: RefineContext,
    tgt_d: jax.Array,
    state_n: jax.Array | None,
    *,
    gamma: float,
    steps: int,
    step_size: float,
    spixl_size: int = 8,
    label_radius: int = 1,
) -> IterCache:
    """Gather every move-independent quantity for one sweep: the cell-level
    tap/ring caches plus the rasterized input state for consistency lookups.

    ``tgt_d``/``state_n``: the frozen input state (initial disparities +
    fronto normals for the init forms).
    """
    cache = build_cell_cache(
        ctx, tgt_d, gamma=gamma, steps=steps, step_size=step_size
    )
    if state_n is None:
        state_n = jnp.zeros(tgt_d.shape + (3,), jnp.float32).at[..., 2].set(1.0)
    ras = _rasterize_flat(ctx, tgt_d, state_n, spixl_size, label_radius)
    return cache._replace(ras=ras)


# ---------------------------------------------------------------------------
# Scoring from the cache
# ---------------------------------------------------------------------------


def smoothness_from_cache(
    cache: IterCache, d0: jax.Array, n0: jax.Array, *, alpha: float
) -> jax.Array:
    """cl:1136-1254 / cl:1407-1525 with all gathers hoisted into the cache.

    ``d_intrp = (n.(c - c_tap) + nz*d0)/nz`` per tap; the weight normalizer
    is move-independent (similarities don't involve the candidate plane).
    """
    nx, ny, nz = n0[..., 0:1], n0[..., 1:2], n0[..., 2:3]
    d_intrp = (nx * cache.tap_ax + ny * cache.tap_ay + nz * d0[..., None]) / nz
    diff = d_intrp - cache.tap_d
    sm = jnp.sum(cache.tap_sim * _f32exp(-diff * diff * alpha), axis=-1)
    return jnp.where(cache.wn > 0, sm / cache.wn, _EPS_SM)


def _f32exp(x: jax.Array) -> jax.Array:
    """exp() flushed to zero below the smallest normal float32, as
    ``testing.mirror.f32exp``.  XLA:CPU flushes denormals and XLA:GPU keeps
    them, so without this an underflowing similarity weight is 0 on one
    backend and a denormal on the other — enough to flip a smoothness
    normalizer between its ``_EPS_SM`` floor and ~1 and to change accept
    decisions."""
    e = jnp.exp(x)
    return jnp.where(e < _FLT_MIN, 0.0, e)


def _cl_round(x: jax.Array) -> jax.Array:
    """OpenCL round(): half away from zero."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def pairs_from_subsets(view_subset, array_width: int) -> tuple:
    """Static packed (ref, view, dvx, dvy) pair list from a concrete
    ``(V, max_n)`` -1-padded subset table, in the reference's enumeration
    order (pipeline.cpp:130-142).  Pass this through jit boundaries as a
    static argument — the arrays inside a traced context are tracers."""
    import numpy as np

    vs = np.asarray(view_subset)
    pairs = []
    for z in range(vs.shape[0]):
        for k in range(vs.shape[1]):
            if vs[z, k] >= 0:
                n = int(vs[z, k])
                pairs.append((
                    z,
                    n,
                    float(n % array_width - z % array_width),
                    float(n // array_width - z // array_width),
                ))
    return tuple(pairs)


def pairs_from_context(ctx: RefineContext) -> tuple:
    """Like ``pairs_from_subsets`` but reads the context's tables — only
    valid when the context holds concrete arrays (not under tracing)."""
    import numpy as np

    vs = np.asarray(ctx.view_subset)
    dv = np.asarray(ctx.dv)
    pairs = []
    for z in range(vs.shape[0]):
        for k in range(vs.shape[1]):
            if vs[z, k] >= 0:
                pairs.append(
                    (z, int(vs[z, k]), float(dv[z, k, 0]), float(dv[z, k, 1]))
                )
    return tuple(pairs)


def consistency_from_cache(
    ctx: RefineContext,
    cache: IterCache,
    d0: jax.Array,
    n0: jax.Array,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
    img_hw: tuple[int, int] | None = None,
    ras_rows=None,
    pair_layout: str = "packed",
) -> jax.Array:
    """cl:1260-1357 / cl:1528-1631: the stored-plane interpolation at the
    projected pixel equals the rasterized input state there, so the whole
    cross-view chain is one packed gather.

    The neighbor-view axis is a *packed static pair list* (``pairs``, from
    ``pairs_from_context``), not a padded (V, max_n) table: padding slots
    would spend half the gathered points on masked work at the reference's
    3x3 geometry.  Per-view aggregation sums pairs
    in subset order with static slices — same floating-point order as the
    reference's per-thread loop (cl:1312-1348).

    ``img_hw``/``ras_rows``: for the spatially-sharded path
    (parallel/spatial.py) — ``cache.ras`` then holds only pixel rows
    ``[row_lo, row_lo + rows_ext)`` of each view (a halo-extended block) and
    projections outside that window count as out-of-frame.

    ``pair_layout``: ``"packed"`` (default) evaluates the static pair list
    as one (P, ...) batch — fewest gather rows, but under GSPMD view
    sharding every (P, ...) temporary is REPLICATED per device (the memory
    wall of the 7x7 2K rig).  ``"view"`` regroups the
    pairs by ref view into <= Pv slots and accumulates slot-by-slot: every
    temporary keeps the leading view axis (so it SHARDS with the view
    mesh) and peaks at one (V, Mh, 9, Mw) slab instead of (P, Mh, 9, Mw).
    Bitwise-equal to "packed" (slot order == subset order per view; padded
    slots contribute exact zeros; tests/test_refine.py).
    """
    import numpy as np

    h, w = img_hw if img_hw is not None else ctx.labels.shape[1:3]
    v = d0.shape[0]
    center = ctx.center
    out_shape = d0.shape

    if len(pairs) == 0:
        return jnp.full(out_shape, _MARGIN, jnp.float32)
    if pair_layout == "view":
        return _consistency_viewpairs(
            ctx, cache, d0, n0, gamma=gamma, alpha=alpha, fuse=fuse,
            bl_ratio=bl_ratio, pairs=pairs, img_hw=img_hw, ras_rows=ras_rows,
        )
    assert pair_layout == "packed", pair_layout

    refs = np.asarray([p[0] for p in pairs], np.int32)
    nbrs = jnp.asarray([p[1] for p in pairs], jnp.int32)
    dvx = jnp.asarray([p[2] for p in pairs], jnp.float32)[:, None, None, None]
    dvy = jnp.asarray([p[3] for p in pairs], jnp.float32)[:, None, None, None]
    bounds = np.searchsorted(refs, np.arange(v + 1))
    refs_j = jnp.asarray(refs)
    take = lambda a: jnp.take(a, refs_j, axis=0)

    # sample axis lives at position -2 throughout (see RefineContext.samples)
    cx = center[..., 0][:, :, None, :]  # (V, Mh, 1, Mw)
    cy = center[..., 1][:, :, None, :]
    sx = cx.astype(jnp.int32) + ctx.samples[..., 0]  # (V, Mh, 9, Mw)
    sy = cy.astype(jnp.int32) + ctx.samples[..., 1]

    nx = n0[..., 0][:, :, None, :]
    ny = n0[..., 1][:, :, None, :]
    nz = n0[..., 2][:, :, None, :]
    d_intrp = (
        nx * (cx - sx.astype(jnp.float32))
        + ny * (cy - sy.astype(jnp.float32))
        + nz * d0[:, :, None, :]
    ) / nz  # (V, Mh, 9, Mw)

    # pair axis: (P, Mh, 9, Mw)
    sxp = take(sx)
    syp = take(sy)
    dip = take(d_intrp)
    xp = sxp - _cl_round(dip * dvx).astype(jnp.int32)
    yp = syp - _cl_round(bl_ratio * dip * dvy).astype(jnp.int32)
    inb = (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)

    viewb = nbrs[:, None, None, None]
    if ras_rows is None:
        flat = (
            viewb * (h * w) + jnp.clip(yp, 0, h - 1) * w + jnp.clip(xp, 0, w - 1)
        )  # (P, Mh, 9, Mw)
    else:
        row_lo, rows_ext = ras_rows
        inb = inb & (yp >= row_lo) & (yp < row_lo + rows_ext)
        yloc = jnp.clip(yp - row_lo, 0, rows_ext - 1)
        flat = viewb * (rows_ext * w) + yloc * w + jnp.clip(xp, 0, w - 1)
    g = cache.ras[flat.reshape(-1)].reshape(flat.shape + (4,))

    diff = g[..., 0] - dip
    when_visible = (jnp.abs(diff) < fuse).astype(jnp.float32)
    inbf = inb.astype(jnp.float32)
    visible = jnp.sum(inbf * when_visible * _f32exp(-diff * diff * alpha), axis=2)
    visib_sum = jnp.sum(inbf * when_visible, axis=2)
    occl_sum = jnp.sum(inbf * (1.0 - when_visible), axis=2)
    colp = take(ctx.color)  # (P, Mh, Mw, 3)
    cdiff = sum(
        (g[..., 1 + c] - colp[..., c][:, :, None, :]) ** 2 for c in range(3)
    )
    visibility = jnp.sum(inbf * _f32exp(-cdiff * gamma), axis=2)
    num = jnp.sum(inbf, axis=2)  # (P, Mh, Mw)

    contrib = jnp.where(
        visib_sum > 0,
        (visib_sum / jnp.maximum(num, 1.0))
        * (visibility / jnp.maximum(visib_sum, 1e-30))
        * (visible / jnp.maximum(visib_sum, 1e-30)),
        0.0,
    )
    contrib = contrib + jnp.where(occl_sum > 0, 0.5 * take(ctx.fl[..., 1]), 0.0)
    has = (num > 0).astype(jnp.float32)

    # per-view aggregation in subset order (static slices, sequential adds)
    cons_rows, cnt_rows = [], []
    zero = jnp.zeros(out_shape[1:], jnp.float32)
    for z in range(v):
        lo, hi = int(bounds[z]), int(bounds[z + 1])
        if lo == hi:
            cons_rows.append(zero)
            cnt_rows.append(zero)
            continue
        acc, cnt = contrib[lo], has[lo]
        for p in range(lo + 1, hi):
            acc = acc + contrib[p]
            cnt = cnt + has[p]
        cons_rows.append(acc)
        cnt_rows.append(cnt)
    consistency = jnp.stack(cons_rows)
    view_counter = jnp.stack(cnt_rows)
    return jnp.where(
        view_counter > 0,
        jnp.maximum(_MARGIN, consistency / jnp.maximum(view_counter, 1.0)),
        _MARGIN,
    )


def _viewpair_tables(pairs: tuple, v: int):
    """Static pair list -> per-ref-view slot tables (V, Pv): neighbor id,
    baseline deltas, validity.  Slot order within a view preserves the
    subset (pair-list) order, so a slot-ordered accumulation reproduces the
    reference's per-view floating-point sum exactly."""
    import numpy as np

    by_view: list[list] = [[] for _ in range(v)]
    for p in pairs:
        by_view[int(p[0])].append(p)
    pv = max((len(b) for b in by_view), default=1) or 1
    nbr = np.zeros((v, pv), np.int32)
    dvx = np.zeros((v, pv), np.float32)
    dvy = np.zeros((v, pv), np.float32)
    val = np.zeros((v, pv), np.bool_)
    for z, b in enumerate(by_view):
        for k, p in enumerate(b):
            nbr[z, k] = int(p[1])
            dvx[z, k] = float(p[2])
            dvy[z, k] = float(p[3])
            val[z, k] = True
    return pv, nbr, dvx, dvy, val


def _consistency_viewpairs(
    ctx: RefineContext,
    cache: IterCache,
    d0: jax.Array,
    n0: jax.Array,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    pairs: tuple,
    img_hw: tuple[int, int] | None = None,
    ras_rows=None,
) -> jax.Array:
    """``pair_layout="view"`` body of :func:`consistency_from_cache` — see
    there for semantics.  Every array keeps the leading view axis, so the
    whole scorer shards over a ``view`` mesh axis with per-device temps
    ~(V/n) * Mh * 9 * Mw per slot instead of the packed form's replicated
    (P, Mh, 9, Mw) slabs (the memory layout of the 7x7 2K rig)."""
    import numpy as np

    h, w = img_hw if img_hw is not None else ctx.labels.shape[1:3]
    v = d0.shape[0]
    center = ctx.center
    out_shape = d0.shape
    pv, nbr, dvx, dvy, val = _viewpair_tables(pairs, v)

    cx = center[..., 0][:, :, None, :]  # (V, Mh, 1, Mw)
    cy = center[..., 1][:, :, None, :]
    sx = cx.astype(jnp.int32) + ctx.samples[..., 0]  # (V, Mh, 9, Mw)
    sy = cy.astype(jnp.int32) + ctx.samples[..., 1]
    nx = n0[..., 0][:, :, None, :]
    ny = n0[..., 1][:, :, None, :]
    nz = n0[..., 2][:, :, None, :]
    dip = (
        nx * (cx - sx.astype(jnp.float32))
        + ny * (cy - sy.astype(jnp.float32))
        + nz * d0[:, :, None, :]
    ) / nz  # (V, Mh, 9, Mw)

    cons = jnp.zeros(out_shape, jnp.float32)
    cnt = jnp.zeros(out_shape, jnp.float32)
    for k in range(pv):
        dvx_k = jnp.asarray(dvx[:, k])[:, None, None, None]
        dvy_k = jnp.asarray(dvy[:, k])[:, None, None, None]
        nbr_k = jnp.asarray(nbr[:, k])[:, None, None, None]
        val_k = jnp.asarray(val[:, k])[:, None, None]  # (V, 1, 1) bool
        xp = sx - _cl_round(dip * dvx_k).astype(jnp.int32)
        yp = sy - _cl_round(bl_ratio * dip * dvy_k).astype(jnp.int32)
        inb = (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)
        if ras_rows is None:
            flat = (
                nbr_k * (h * w)
                + jnp.clip(yp, 0, h - 1) * w
                + jnp.clip(xp, 0, w - 1)
            )
        else:
            row_lo, rows_ext = ras_rows
            inb = inb & (yp >= row_lo) & (yp < row_lo + rows_ext)
            yloc = jnp.clip(yp - row_lo, 0, rows_ext - 1)
            flat = nbr_k * (rows_ext * w) + yloc * w + jnp.clip(xp, 0, w - 1)
        g = cache.ras[flat.reshape(-1)].reshape(flat.shape + (4,))

        diff = g[..., 0] - dip
        when_visible = (jnp.abs(diff) < fuse).astype(jnp.float32)
        inbf = inb.astype(jnp.float32)
        visible = jnp.sum(
            inbf * when_visible * _f32exp(-diff * diff * alpha), axis=2
        )
        visib_sum = jnp.sum(inbf * when_visible, axis=2)
        occl_sum = jnp.sum(inbf * (1.0 - when_visible), axis=2)
        cdiff = sum(
            (g[..., 1 + c] - ctx.color[..., c][:, :, None, :]) ** 2
            for c in range(3)
        )
        visibility = jnp.sum(inbf * _f32exp(-cdiff * gamma), axis=2)
        num = jnp.sum(inbf, axis=2)  # (V, Mh, Mw)

        contrib = jnp.where(
            visib_sum > 0,
            (visib_sum / jnp.maximum(num, 1.0))
            * (visibility / jnp.maximum(visib_sum, 1e-30))
            * (visible / jnp.maximum(visib_sum, 1e-30)),
            0.0,
        )
        contrib = contrib + jnp.where(occl_sum > 0, 0.5 * ctx.fl[..., 1], 0.0)
        has = (num > 0).astype(jnp.float32)
        # where (not multiply): a padded slot's garbage gather may be NaN
        cons = cons + jnp.where(val_k, contrib, 0.0)
        cnt = cnt + jnp.where(val_k, has, 0.0)
    return jnp.where(
        cnt > 0,
        jnp.maximum(_MARGIN, cons / jnp.maximum(cnt, 1.0)),
        _MARGIN,
    )


# ---------------------------------------------------------------------------
# State init (cl:1362-1404)
# ---------------------------------------------------------------------------


def init_state(
    ctx: RefineContext,
    *,
    pairs: tuple | None = None,
    **kw,
) -> RefineState:
    """``init_current_state``: score the initial fronto-parallel planes.

    ``pairs`` (static) defaults to the context's subset tables — the context
    must then hold concrete arrays (pass ``pairs`` explicitly when tracing).
    """
    if pairs is None:
        pairs = pairs_from_context(ctx)
    return _init_state(ctx, pairs=pairs, **kw)


@partial(
    jax.jit,
    static_argnames=(
        "gamma", "alpha", "fuse", "bl_ratio", "steps", "step_size", "pairs",
        "spixl_size", "label_radius", "pair_layout",
    ),
)
def _init_state(
    ctx: RefineContext,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    steps: int,
    step_size: float,
    pairs: tuple,
    spixl_size: int = 8,
    label_radius: int = 1,
    pair_layout: str = "packed",
) -> RefineState:
    d0 = ctx.disp0
    n0 = jnp.zeros(d0.shape + (3,), jnp.float32).at[..., 2].set(1.0)
    cache = build_cache(
        ctx, ctx.disp0, None, gamma=gamma, steps=steps, step_size=step_size,
        spixl_size=spixl_size, label_radius=label_radius,
    )
    sm = smoothness_from_cache(cache, d0, n0, alpha=alpha)
    cs = consistency_from_cache(
        ctx, cache, d0, n0, gamma=gamma, alpha=alpha, fuse=fuse,
        bl_ratio=bl_ratio, pairs=pairs, pair_layout=pair_layout,
    )
    return RefineState(d=d0, sm=sm, cs=cs, n=n0)


# ---------------------------------------------------------------------------
# Propagation (cl:1727-1900)
# ---------------------------------------------------------------------------


def _update_move_offsets(
    steps: int, step_size: float, mw: int, mh: int
) -> list[tuple[int, int]]:
    """Static (dx, dy) offsets of the ``update`` moves, in reference order:
    8 immediate (i outer = x, j inner = y, cl:1768), then per reach step
    UP, DOWN, LEFT, RIGHT at pitch ``(int)step_size`` (cl:1791-1857).

    Moves whose offset exceeds the map can never pass the bounds guard
    (cl:1797-1842), so they are dropped at trace time — behaviorally exact
    and, notably, at the reference's own configuration (pitch 328 on a
    240x135 map) *every* long-range move is degenerate this way."""
    offs = list(_IMM)
    pitch = int(step_size)
    for i in range(1, steps + 1):
        off = i * pitch + 1
        offs += [(0, -off), (0, off), (-off, 0), (off, 0)]
    return [(dx, dy) for dx, dy in offs if abs(dx) < mw and abs(dy) < mh]


def _cross(v1, v2):
    """Device ``cross_product_test`` (cl:1676-1685) — NOT the buggy host
    ``crossVec3f`` (file_handler.cpp:167)."""
    return (
        v1[1] * v2[2] - v1[2] * v2[1],
        v2[0] * v1[2] - v1[0] * v2[2],
        v1[0] * v2[1] - v1[1] * v2[0],
    )


def gather_update_moves(
    ctx: RefineContext, state_in: RefineState, offs, gamma: float
):
    """Pre-gather the ``update``-move candidate planes (cl:1649): each
    offset's neighbor plane extrapolated to the home center, plus the
    color-similarity factor and validity.  Input-state-only, so one packed
    gather serves the whole move chain.

    Returns (d_adopt, n1x, n1y, n1z, sim, ok), each (V, Mh, Mw, M).
    """
    v, mh, mw = state_in.d.shape
    center = ctx.center
    colg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)[None]
    rowg = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)[None]
    dxs = jnp.asarray([o[0] for o in offs], jnp.int32)
    dys = jnp.asarray([o[1] for o in offs], jnp.int32)
    tx = colg[..., None] + dxs  # (V, Mh, Mw, M)
    ty = rowg[..., None] + dys
    ok_m = (tx >= 0) & (ty >= 0) & (tx < mw) & (ty < mh)
    # every move offset is STATIC (the long-range pitch is compile-time,
    # _update_move_offsets), so the neighbor-plane "gather" is a stack of
    # rolls — no gather rows at all; wrapped border reads are exactly the
    # ok_m-masked entries
    packed = jnp.concatenate(
        [center, ctx.color, state_in.d[..., None], state_in.n], axis=-1
    )  # [cx, cy, r, g, b, d, nx, ny, nz]
    nb = jnp.stack(
        [jnp.roll(packed, (-dy, -dx), axis=(1, 2)) for dx, dy in offs],
        axis=-2,
    )  # (V, Mh, Mw, M, 9)
    n1x, n1y, n1z = nb[..., 6], nb[..., 7], nb[..., 8]
    d_adopt = (
        n1x * (nb[..., 0] - center[..., 0:1])
        + n1y * (nb[..., 1] - center[..., 1:2])
        + n1z * nb[..., 5]
    ) / n1z  # (V, Mh, Mw, M)
    sim_m = _f32exp(
        -jnp.sum((ctx.color[..., None, :] - nb[..., 2:5]) ** 2, axis=-1) * gamma
    )
    return d_adopt, n1x, n1y, n1z, sim_m, ok_m


def propagate_iteration(
    ctx: RefineContext,
    state_in: RefineState,
    it: int,
    *,
    pairs: tuple | None = None,
    **kw,
) -> RefineState:
    """One Jacobi sweep: every superpixel walks the move table, rescoring
    candidate planes against the *input* state (ping-pong semantics of
    depth_refinement.cpp:744-753).

    ``pairs`` (static) defaults to the context's subset tables — pass it
    explicitly when the context is being traced.
    """
    if pairs is None:
        pairs = pairs_from_context(ctx)
    return _propagate_iteration(ctx, state_in, it, pairs=pairs, **kw)


@partial(
    jax.jit,
    static_argnames=(
        "it", "gamma", "alpha", "fuse", "bl_ratio", "steps", "step_size",
        "pairs", "spixl_size", "label_radius", "pair_layout",
    ),
)
def _propagate_iteration(
    ctx: RefineContext,
    state_in: RefineState,
    it: int,
    *,
    gamma: float,
    alpha: float,
    fuse: float,
    bl_ratio: float,
    steps: int,
    step_size: float,
    pairs: tuple,
    spixl_size: int = 8,
    label_radius: int = 1,
    pair_layout: str = "packed",
) -> RefineState:
    v, mh, mw = state_in.d.shape
    center = ctx.center
    greedy = it < 4  # cl:1663 / cl:1713

    cache = build_cache(
        ctx, state_in.d, state_in.n, gamma=gamma, steps=steps, step_size=step_size,
        spixl_size=spixl_size, label_radius=label_radius,
    )

    # ---- pre-gather update-move candidates (input-state-only) -------------
    offs = _update_move_offsets(steps, step_size, mw, mh)
    d_adopt, n1x, n1y, n1z, sim_m, ok_m = gather_update_moves(
        ctx, state_in, offs, gamma
    )

    score_kw = dict(
        gamma=gamma, alpha=alpha, fuse=fuse, bl_ratio=bl_ratio, pairs=pairs
    )

    # Key scheduling fact: every candidate's (sm1, cs1) depends only on the
    # candidate plane and the frozen input state — NOT on the accept chain.
    # Score all moves in parallel (chunked so the (C, V, Mh, Mw, n, 9)
    # consistency temporaries stay bounded), then run the cheap sequential
    # acceptance chain (cl:1779-1891) over the precomputed scores.
    def _score_batch(d_c, n_c):
        """d_c: (M, V, Mh, Mw); n_c: (M, V, Mh, Mw, 3) -> (sm1, cs1)."""
        m = d_c.shape[0]
        # "view" pair layout is the memory-constrained sharded path (the
        # 7x7 2K rig): one move at a time bounds the per-device refinement
        # temporaries to one move's worth (tools/memcheck.py)
        chunk = 1 if pair_layout == "view" else _SCORE_CHUNK
        pad = (-m) % chunk
        if pad:
            d_c = jnp.concatenate([d_c, d_c[:pad]], axis=0)
            n_c = jnp.concatenate([n_c, n_c[:pad]], axis=0)
        dcs = d_c.reshape((-1, chunk) + d_c.shape[1:])
        ncs = n_c.reshape((-1, chunk) + n_c.shape[1:])

        def body(_, xs):
            dci, nci = xs
            sm1 = jax.vmap(
                lambda d, n: smoothness_from_cache(cache, d, n, alpha=alpha)
            )(dci, nci)
            cs1 = jax.vmap(
                lambda d, n: consistency_from_cache(
                    ctx, cache, d, n, pair_layout=pair_layout, **score_kw
                )
            )(dci, nci)
            return 0, (sm1, cs1)

        _, ys = jax.lax.scan(body, 0, (dcs, ncs))
        sm1 = ys[0].reshape((-1,) + d_c.shape[1:])[:m]
        cs1 = ys[1].reshape((-1,) + d_c.shape[1:])[:m]
        return sm1, cs1

    mv = lambda a: jnp.moveaxis(a, -1, 0)  # move axis leads
    n_c_upd = jnp.stack([mv(n1x), mv(n1y), mv(n1z)], axis=-1)  # (M, V, Mh, Mw, 3)
    sm1_upd, cs1_upd = _score_batch(mv(d_adopt), n_c_upd)

    def update_body(carry, xs):
        d0, sm0, cs0, n0x, n0y, n0z = carry
        d_c, n_cx, n_cy, n_cz, sim, valid, sm1, cs1 = xs
        accept = valid & (
            (greedy & (sm1 * sim > sm0)) | (cs1 * sm1 > sm0 * cs0)
        )
        return (
            jnp.where(accept, d_c, d0),
            jnp.where(accept, sm1, sm0),
            jnp.where(accept, cs1, cs0),
            jnp.where(accept, n_cx, n0x),
            jnp.where(accept, n_cy, n0y),
            jnp.where(accept, n_cz, n0z),
        ), None

    xs = (
        mv(d_adopt),
        mv(n1x),
        mv(n1y),
        mv(n1z),
        mv(sim_m),
        mv(ok_m),
        sm1_upd,
        cs1_upd,
    )
    carry = (
        state_in.d,
        state_in.sm,
        state_in.cs,
        state_in.n[..., 0],
        state_in.n[..., 1],
        state_in.n[..., 2],
    )
    carry, _ = jax.lax.scan(update_body, carry, xs)

    # ---- spatial refinement moves --------------------------------------
    # d0 is frozen after the update phase (refinement re-fits only the
    # normal, cl:1699-1713), so all 8 candidate normals and their scores
    # are computable in parallel too.
    d0_fix = carry[0]

    def make_refit(r):
        r2 = (r + 1) % 8
        take = lambda a: jnp.take(a, r, axis=-1)
        take2 = lambda a: jnp.take(a, r2, axis=-1)
        v1 = (take(cache.ring_dcx), take(cache.ring_dcy), take(cache.ring_d) - d0_fix)
        v2 = (take2(cache.ring_dcx), take2(cache.ring_dcy), take2(cache.ring_d) - d0_fix)
        cx_, cy_, cz_ = _cross(v1, v2)
        norm = jnp.sqrt(cx_ * cx_ + cy_ * cy_ + cz_ * cz_)
        n_c = jnp.stack([cx_ / norm, cy_ / norm, cz_ / norm], axis=-1)
        valid = take(cache.ring_ok) & take2(cache.ring_ok)
        return n_c, valid

    refits = [make_refit(r) for r in range(8)]
    n_c_ref = jnp.stack([n for n, _ in refits], axis=0)  # (8, V, Mh, Mw, 3)
    ok_ref = jnp.stack([v for _, v in refits], axis=0)
    sm1_ref, cs1_ref = _score_batch(
        jnp.broadcast_to(d0_fix[None], (8,) + d0_fix.shape), n_c_ref
    )

    def refine_body(carry, xs):
        d0, sm0, cs0, n0x, n0y, n0z = carry
        n_c, valid, sm1, cs1 = xs
        accept = valid & ((greedy & (sm1 > sm0)) | (sm1 * cs1 > sm0 * cs0))
        return (
            d0,
            jnp.where(accept, sm1, sm0),
            jnp.where(accept, cs1, cs0),
            jnp.where(accept, n_c[..., 0], n0x),
            jnp.where(accept, n_c[..., 1], n0y),
            jnp.where(accept, n_c[..., 2], n0z),
        ), None

    carry, _ = jax.lax.scan(refine_body, carry, (n_c_ref, ok_ref, sm1_ref, cs1_ref))
    d0, sm0, cs0, n0x, n0y, n0z = carry
    return RefineState(d=d0, sm=sm0, cs=cs0, n=jnp.stack([n0x, n0y, n0z], axis=-1))


def refine(
    ctx: RefineContext,
    schedule,
    *,
    pairs: tuple | None = None,
    jit: bool = True,
    spixl_size: int = 8,
    label_radius: int = 1,
    pair_layout: str = "packed",
) -> RefineState:
    """Full refinement: init state, then ``no_prop`` Jacobi sweeps with
    decaying reach (depth_refinement.cpp:105-106, 767-769)."""
    if pairs is None:
        pairs = pairs_from_context(ctx)
    kw0 = dict(
        gamma=schedule.gamma_eff,
        alpha=schedule.alpha_eff,
        fuse=schedule.fuse_eff,
        bl_ratio=schedule.bl_ratio,
        pairs=pairs,
        spixl_size=spixl_size,
        label_radius=label_radius,
        pair_layout=pair_layout,
    )
    del jit  # stage functions are module-level jits (stable cache keys)
    state = init_state(
        ctx, **kw0, steps=schedule.kernel_steps, step_size=schedule.sp_kernel_step
    )
    for it in range(schedule.no_prop):
        state = propagate_iteration(
            ctx,
            state,
            it=it,
            **kw0,
            steps=schedule.steps_per_iter[it],
            step_size=schedule.step_size_per_iter[it],
        )
    return state
