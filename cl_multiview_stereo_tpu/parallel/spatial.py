"""Depth-slab and spatial-tile sharding for the cost-volume sweep.

The reference has no inter-device parallelism at all (SURVEY.md section 2.3:
one OpenCL device, `devices[0]` everywhere).  These are the
scaling strategies the framework adds on top of the view-parallel pipeline
(parallel/sharded_pipeline.py):

* **Depth-slab sharding (the TP analog)** — the disparity-hypothesis axis of
  the cost volume is sharded over a mesh axis: each device sweeps a contiguous
  slab of the ladder, reduces it locally with winner-take-all, and the
  per-slab winners are combined with one tiny ``all_gather`` (cost + disp
  per superpixel).  Ties resolve to the lowest disparity exactly like the
  reference's ascending strict-``<`` scan (clcode.cl:1059-1067) because
  slabs are contiguous ascending and argmin takes the first occurrence.

* **Spatial row-tile sharding with halo exchange (the SP analog)** — the
  dense per-pixel sweep (models/plane_sweep.py) is sharded by image rows:
  each device owns an H/n row band of every view and exchanges
  ``max_shift + box_radius`` halo rows with its mesh neighbors via
  ``lax.ppermute`` before sweeping locally.  The vertical projection reach
  is statically bounded by the ladder (``ceil(bl_ratio*max_disp*neib_ver)``),
  so the halo is exact — the sharded result is bitwise identical to the
  unsharded sweep.

Both run under ``shard_map`` so the collectives are explicit.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

_OOB_PENALTY = 30.0
_BIG = 1.0e6


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def halo_exchange_rows(x: jax.Array, halo: int, axis_name: str, row_axis: int = 0):
    """Extend a row-sharded block with ``halo`` rows from each mesh neighbor.

    ``x``: this device's (..., rows, ...) block.  Returns a block with
    ``2*halo`` extra rows; rows beyond the global edges are zero-filled
    (callers overwrite them if other semantics are needed).

    Single-hop ``ppermute`` when ``halo <= rows``; falls back to
    ``all_gather`` + window slice when the halo spans multiple neighbor
    blocks (correct but costs the full array).
    """
    if halo == 0:
        return x
    n = jax.lax.psum(1, axis_name)
    rows = x.shape[row_axis]
    if halo > rows:
        full = jax.lax.all_gather(x, axis_name, axis=row_axis, tiled=True)
        pad = [(0, 0)] * x.ndim
        pad[row_axis] = (halo, halo)
        full = jnp.pad(full, pad)
        t = jax.lax.axis_index(axis_name)
        start = [0] * x.ndim
        start[row_axis] = t * rows
        sizes = list(x.shape)
        sizes[row_axis] = rows + 2 * halo
        return jax.lax.dynamic_slice(full, start, sizes)
    top = jax.lax.slice_in_dim(x, 0, halo, axis=row_axis)
    bot = jax.lax.slice_in_dim(x, rows - halo, rows, axis=row_axis)
    # from_above[i] = bot of device i-1; from_below[i] = top of device i+1
    from_above = jax.lax.ppermute(
        bot, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_below = jax.lax.ppermute(
        top, axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    return jnp.concatenate([from_above, x, from_below], axis=row_axis)


# ---------------------------------------------------------------------------
# Depth-slab sharded superpixel depth init (TP analog)
# ---------------------------------------------------------------------------


def disp_sharded_depth_init(
    lab: jax.Array,  # (V, H, W, 3)
    centers: jax.Array,  # (V, Mh, Mw, 2)
    step: jax.Array,  # (V, Mh, Mw, 2)
    disp_levels: np.ndarray,  # concrete ascending ladder
    subset_num: np.ndarray,
    mesh: Mesh,
    array_width: int,
    bl_ratio: float,
    *,
    axis: str = "disp",
    neib_hor: int = 1,
    neib_ver: int = 1,
) -> jax.Array:
    """Superpixel plane-sweep depth init with the hypothesis ladder sharded
    over ``mesh`` axis ``axis``.  Exact same result as the unsharded
    ``initial_depth_estimation`` (dense method): each device sweeps its slab,
    WTA-reduces locally, and the winners are all-gathered and argmin-reduced.

    The ladder length must divide the mesh axis size evenly (pad the ladder
    with repeats of the last level if needed — repeated levels can never win
    a strict-``<`` tie against the first occurrence).
    """
    from cl_multiview_stereo_tpu.ops.cost_volume import superpixel_cost_volume_dense

    n = mesh.shape[axis]
    disp_levels = np.asarray(disp_levels, np.float32)
    d = len(disp_levels)
    pad = (-d) % n
    if pad:
        disp_levels = np.concatenate([disp_levels, np.repeat(disp_levels[-1], pad)])
    max_abs = float(np.max(np.abs(disp_levels))) if len(disp_levels) else 0.0

    def local_sweep(lab_l, centers_l, step_l, ladder_l):
        vol = superpixel_cost_volume_dense(
            lab_l, centers_l, step_l, ladder_l,
            array_width, bl_ratio, neib_hor, neib_ver, max_abs,
        )  # (V, Dl, Mh, Mw)
        idx = jnp.argmin(vol, axis=1)
        best_cost = jnp.min(vol, axis=1)
        best_disp = ladder_l[idx]
        # combine slab winners: first-occurrence argmin over the gathered
        # slab axis == global ascending-scan tie semantics
        costs = jax.lax.all_gather(best_cost, axis)  # (n, V, Mh, Mw)
        disps = jax.lax.all_gather(best_disp, axis)
        k = jnp.argmin(costs, axis=0)
        return jnp.take_along_axis(disps, k[None], axis=0)[0]

    spec_rep = P()
    fn = shard_map(
        local_sweep,
        mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep, P(axis)),
        out_specs=spec_rep,
        check_vma=False,
    )
    disp = fn(lab, centers, step, jnp.asarray(disp_levels))
    has_views = jnp.asarray(subset_num) > 0
    return jnp.where(has_views[:, None, None], disp, 0.0)


# ---------------------------------------------------------------------------
# Spatially row-tiled dense sweep with halo exchange (SP analog)
# ---------------------------------------------------------------------------


def _col_resample(img: jax.Array, c: float, w: int):
    """Static column shift with the reference's projected-coordinate
    truncation (clcode.cl:1034): out[..., x, :] = img[..., (int)(x - c), :],
    plus the valid-window mask ``-1 < x - c < w``.  Mirrors
    models/plane_sweep._resample_axis but returns the mask separately."""
    s = int(math.ceil(c))
    idx = np.clip(np.arange(w) - s, 0, w - 1)
    out = jnp.take(img, idx, axis=-2)
    x = np.arange(w, dtype=np.float64)
    ok = (x - c > -1.0) & (x - c < w)
    return out, jnp.asarray(ok)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _spatial_sweep_shardmap(
    lab: jax.Array,
    disp_levels: tuple[float, ...],
    pairs: tuple[tuple[int, int, int, int], ...],
    bl_ratio: float,
    window_radius: int,
    mesh_and_axis,
    n_tiles: int,
):
    mesh, axis = mesh_and_axis
    v, h, w = lab.shape[:3]
    bh = h // n_tiles
    r = window_radius
    max_sy = max(
        (abs(int(math.ceil(bl_ratio * d * dvy))) for d in disp_levels
         for (_, _, _, dvy) in pairs),
        default=0,
    )
    halo = max_sy + r

    def tile_fn(blk):  # (V, bh, W, 3) this device's row band of every view
        t = jax.lax.axis_index(axis)
        r0 = t * bh
        ext = halo_exchange_rows(blk, halo, axis, row_axis=1)
        # edge-replicate semantics for global row -1 (the reference's
        # truncation maps a valid coordinate in (-1, 0) to row 0); rows
        # past the bottom stay zero — they are always masked invalid
        g_ext = r0 - halo + jnp.arange(bh + 2 * halo)
        row0 = jax.lax.dynamic_slice_in_dim(ext, halo, 1, axis=1)
        ext = jnp.where((g_ext < 0)[None, :, None, None], row0, ext)

        # SAD rows needed: core +- r
        gy = (r0 - r + jnp.arange(bh + 2 * r)).astype(jnp.float32)
        ref_in_img = (gy >= 0) & (gy <= h - 1)  # (bh+2r,)

        best_cost = jnp.full((v, bh, w), _BIG, jnp.float32)
        best_disp = jnp.zeros((v, bh, w), jnp.float32)
        for d in disp_levels:
            per_ref = jnp.full((v, bh + 2 * r, w), _BIG, jnp.float32)
            for (ref, view, dvx, dvy) in pairs:
                cy = bl_ratio * d * dvy
                cx = d * dvx
                sy = int(math.ceil(cy))
                ref_rows = jax.lax.dynamic_slice_in_dim(
                    ext[ref], halo - r, bh + 2 * r, axis=0
                )
                nbr_rows = jax.lax.dynamic_slice_in_dim(
                    ext[view], halo - r - sy, bh + 2 * r, axis=0
                )
                nbr_rows, col_ok = _col_resample(nbr_rows, cx, w)
                sad = jnp.sum(jnp.abs(ref_rows - nbr_rows), axis=-1)
                # exact projected-row validity: -1 < y - cy < h
                row_ok = (gy - cy > -1.0) & (gy - cy < h)
                ok = row_ok[:, None] & col_ok[None, :]
                sad = jnp.where(ok, sad, _OOB_PENALTY)
                # rows outside the reference image contribute 0 (the
                # unsharded box filter zero-pads outside the image)
                sad = jnp.where(ref_in_img[:, None], sad, 0.0)
                # box: rows from the extended band (ascending offset order
                # matches plane_sweep._box_sum for bitwise-equal ties)
                acc = jnp.zeros((bh, w), jnp.float32)
                for k in range(2 * r + 1):
                    acc = acc + jax.lax.slice_in_dim(sad, k, k + bh, axis=0)
                padc = jnp.pad(acc, ((0, 0), (r, r)))
                agg = jnp.zeros((bh, w), jnp.float32)
                for k in range(2 * r + 1):
                    agg = agg + jax.lax.slice_in_dim(padc, k, k + w, axis=1)
                per_ref = per_ref.at[ref, r : bh + r].min(agg)
            core = per_ref[:, r : bh + r]
            take = core < best_cost
            best_cost = jnp.where(take, core, best_cost)
            best_disp = jnp.where(take, jnp.float32(d), best_disp)
        return best_disp, best_cost

    fn = shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(P(None, axis, None, None),),
        out_specs=(P(None, axis, None), P(None, axis, None)),
        check_vma=False,
    )
    return fn(lab)


# ---------------------------------------------------------------------------
# Spatially-sharded PatchMatch refinement with halo exchange (SP analog)
# ---------------------------------------------------------------------------


def spatial_refine(
    ctx,
    schedule,
    mesh: Mesh,
    *,
    axis: str = "tile",
    halo_disp: float | None | str = None,
):
    """PatchMatch state init + propagation (ops/refine.py) with the
    superpixel grid and the rasterized consistency table sharded by rows
    over ``mesh`` axis ``axis`` (SURVEY.md section 5's propagate-stencil
    halo-exchange plan).

    Per Jacobi sweep each device:
      * all-gathers the *cell-level* input state (d, n — a few MB even at
        49 views: tiny) and builds the tap/move caches for its
        own superpixel rows;
      * rasterizes only its own pixel rows of the input state and extends
        them with ``ppermute`` halo exchange — the (V, H, W, 4) table is
        the pipeline's largest array and the real sharding win;
      * scores and accepts moves for its own superpixel rows only.

    ``halo_disp``: bound on |plane-extrapolated disparity| used to size the
    pixel halo (``ceil(bl_ratio * halo_disp * neib_ver)`` rows).  ``None``
    sizes the halo to the full image — bitwise identical to the unsharded
    ``refine.refine`` (the halo then falls back to an all-gather); a finite
    bound keeps exchange single-hop and only differs for degenerate planes
    whose extrapolation exceeds the bound.  The default is ``None`` (exact;
    the repo rule is exactness first) — perf-sensitive call sites opt into
    ``"auto"`` explicitly.  ``"auto"`` derives a bound from the scene
    itself: ``1.5 * max|disp0| + spixl_size`` — initial disparities are
    ladder values, accepted planes interpolate neighbor-center disparities
    (same range) and the consistency samples sit within one superpixel of
    the center, so sample-point extrapolations stay well inside 1.5x the
    ladder for any non-degenerate plane (the acceptance rule rejects wild
    planes: their projected samples leave the frame and consistency
    collapses to the 0.01 floor).  Note ``spixl_size`` is a pixel-space
    quantity added to a disparity-space bound: deliberate slack covering a
    consistency sample's offset from its superpixel center times a
    worst-case unit plane slope.  Verified against exact mode on the
    reference-config fixture in tests/test_spatial_sharding.py.

    Requires ``Mh % n == 0`` and ``H % n == 0``.  Returns a full
    ``RefineState`` (gathered).
    """
    from cl_multiview_stereo_tpu.ops import refine as R

    v, mh, mw = ctx.disp0.shape
    h, w = ctx.labels.shape[1:3]
    n = mesh.shape[axis]
    if mh % n or h % n:
        raise ValueError(f"map rows {mh} / image rows {h} not divisible by {n}")
    bh = mh // n
    bhp = h // n
    if halo_disp == "auto":
        spixl = max(1, h // max(mh, 1))
        disp_max = float(np.max(np.abs(np.asarray(ctx.disp0))))
        if not math.isfinite(disp_max):
            raise ValueError("halo_disp='auto' requires finite ctx.disp0")
        # pixel-space slack (+ spixl) on a disparity-space bound: see docstring
        halo_disp = 1.5 * disp_max + spixl
    if halo_disp is None:
        halo_pix = h  # exact mode: window always covers the full image
    else:
        # max vertical projection reach of a consistency sample plus the
        # sample's own offset from its superpixel row (extent < spixl_size
        # plus the center's possible drift within its cell window)
        dvy_max = float(np.max(np.abs(np.asarray(ctx.dv[..., 1]))))
        reach = math.ceil(abs(schedule.bl_ratio) * float(halo_disp) * dvy_max)
        halo_pix = int(reach) + 4 * (h // max(mh, 1)) + 1

    pairs = R.pairs_from_context(ctx)  # static; ctx is concrete here
    kw0 = dict(
        gamma=schedule.gamma_eff,
        alpha=schedule.alpha_eff,
        fuse=schedule.fuse_eff,
        bl_ratio=schedule.bl_ratio,
    )

    def _slice_rows(a, t, rows):
        start = [0] * a.ndim
        start[1] = t * rows
        sizes = list(a.shape)
        sizes[1] = rows
        return jax.lax.dynamic_slice(a, start, sizes)

    def shard_fn(labels_blk, ctx_rep):
        # ``ctx_rep``: the full immutable context, replicated on every
        # device (all cell-level arrays are small; only labels and the
        # rasterized table are sharded).
        ctx = ctx_rep
        t = jax.lax.axis_index(axis)
        r0p = t * bhp  # first pixel row of this block

        # block-local immutable context (cell rows t*bh : t*bh+bh)
        ctx_blk = ctx._replace(
            center=_slice_rows(ctx.center, t, bh),
            color=_slice_rows(ctx.color, t, bh),
            disp0=_slice_rows(ctx.disp0, t, bh),
            samples=_slice_rows(ctx.samples, t, bh),
            fl=_slice_rows(ctx.fl, t, bh),
        )
        # per-pixel owning-superpixel color for this block's rows (labels
        # are global flat cell ids, so index the full color table)
        flat_sp = (
            jnp.arange(v, dtype=jnp.int32)[:, None, None] * (mh * mw) + labels_blk
        ).reshape(-1)
        ras_color_blk = ctx.color.reshape(-1, 3)[flat_sp]

        def rasterize_blk(d_full, n_full):
            vid = jnp.arange(v, dtype=jnp.int32)[:, None, None]
            # one packed 6-float gather per pixel (gather cost is per row)
            pack = jnp.concatenate(
                [ctx.center, d_full[..., None], n_full], axis=-1
            ).reshape(-1, 6)
            g = pack[flat_sp].reshape(v, bhp, w, 6)
            px = jax.lax.broadcasted_iota(jnp.int32, (bhp, w), 1)[None].astype(
                jnp.float32
            )
            py = (
                r0p + jax.lax.broadcasted_iota(jnp.int32, (bhp, w), 0)[None]
            ).astype(jnp.float32)
            disp = (
                g[..., 3] * (g[..., 0] - px)
                + g[..., 4] * (g[..., 1] - py)
                + g[..., 5] * g[..., 2]
            ) / g[..., 5]
            return jnp.concatenate(
                [disp.reshape(v, bhp, w, 1), ras_color_blk.reshape(v, bhp, w, 3)],
                axis=-1,
            )

        def make_ras_window(d_full, n_full):
            ras_blk = rasterize_blk(d_full, n_full)  # (V, bhp, W, 4)
            ext = halo_exchange_rows(ras_blk, min(halo_pix, h), axis, row_axis=1)
            rows_ext = ext.shape[1]
            row_lo = r0p - min(halo_pix, h)
            return ext.reshape(-1, 4), row_lo, rows_ext

        def block_cache(d_full, steps, step_size):
            cache = R.build_cell_cache(
                ctx, d_full, gamma=kw0["gamma"], steps=steps, step_size=step_size
            )
            return jax.tree_util.tree_map(
                lambda a: _slice_rows(a, t, bh) if a.ndim >= 3 else a, cache
            )

        def score(cache_blk, ras, row_lo, rows_ext, d0, n0):
            sm = R.smoothness_from_cache(cache_blk, d0, n0, alpha=kw0["alpha"])
            cs = R.consistency_from_cache(
                ctx_blk,
                cache_blk._replace(ras=ras),
                d0,
                n0,
                **kw0,
                pairs=pairs,
                img_hw=(h, w),
                ras_rows=(row_lo, rows_ext),
            )
            return sm, cs

        # ---- state init (cl:1362-1404) on the block ----------------------
        d_full0 = ctx.disp0
        n_full0 = jnp.zeros(d_full0.shape + (3,), jnp.float32).at[..., 2].set(1.0)
        cache0 = block_cache(
            d_full0, schedule.kernel_steps, schedule.sp_kernel_step
        )
        ras0, lo0, re0 = make_ras_window(d_full0, n_full0)
        d_blk = ctx_blk.disp0
        n_blk = jnp.zeros(d_blk.shape + (3,), jnp.float32).at[..., 2].set(1.0)
        sm_blk, cs_blk = score(cache0, ras0, lo0, re0, d_blk, n_blk)

        # ---- propagation sweeps ------------------------------------------
        for it in range(schedule.no_prop):
            steps = schedule.steps_per_iter[it]
            step_size = schedule.step_size_per_iter[it]
            greedy = it < 4  # cl:1663 / cl:1713

            d_full = jax.lax.all_gather(d_blk, axis, axis=1, tiled=True)
            n_full = jax.lax.all_gather(n_blk, axis, axis=1, tiled=True)
            state_full = R.RefineState(
                d=d_full,
                sm=jnp.zeros_like(d_full),  # sm/cs of others never read
                cs=jnp.zeros_like(d_full),
                n=n_full,
            )
            cache_blk = block_cache(d_full, steps, step_size)
            ras, row_lo, rows_ext = make_ras_window(d_full, n_full)

            offs = R._update_move_offsets(steps, step_size, mw, mh)
            d_ad, n1x, n1y, n1z, sim_m, ok_m = R.gather_update_moves(
                ctx, state_full, offs, kw0["gamma"]
            )
            blk = lambda a: _slice_rows(a, t, bh)
            d_ad, n1x, n1y, n1z, sim_m, ok_m = (
                blk(d_ad), blk(n1x), blk(n1y), blk(n1z), blk(sim_m), blk(ok_m)
            )

            def update_body(carry, xs):
                d0, sm0, cs0, n0x, n0y, n0z = carry
                d_c, ncx, ncy, ncz, sim, valid = xs
                n_c = jnp.stack([ncx, ncy, ncz], axis=-1)
                sm1, cs1 = score(cache_blk, ras, row_lo, rows_ext, d_c, n_c)
                accept = valid & (
                    (greedy & (sm1 * sim > sm0)) | (cs1 * sm1 > sm0 * cs0)
                )
                return (
                    jnp.where(accept, d_c, d0),
                    jnp.where(accept, sm1, sm0),
                    jnp.where(accept, cs1, cs0),
                    jnp.where(accept, ncx, n0x),
                    jnp.where(accept, ncy, n0y),
                    jnp.where(accept, ncz, n0z),
                ), None

            mv = lambda a: jnp.moveaxis(a, -1, 0)
            carry = (d_blk, sm_blk, cs_blk, n_blk[..., 0], n_blk[..., 1], n_blk[..., 2])
            carry, _ = jax.lax.scan(
                update_body, carry,
                (mv(d_ad), mv(n1x), mv(n1y), mv(n1z), mv(sim_m), mv(ok_m)),
            )

            def refine_body(carry, r):
                d0, sm0, cs0, n0x, n0y, n0z = carry
                r2 = (r + 1) % 8
                take = lambda a: jnp.take(a, r, axis=-1)
                take2 = lambda a: jnp.take(a, r2, axis=-1)
                c = cache_blk
                v1 = (take(c.ring_dcx), take(c.ring_dcy), take(c.ring_d) - d0)
                v2 = (take2(c.ring_dcx), take2(c.ring_dcy), take2(c.ring_d) - d0)
                cx_, cy_, cz_ = R._cross(v1, v2)
                norm = jnp.sqrt(cx_ * cx_ + cy_ * cy_ + cz_ * cz_)
                n_c = jnp.stack([cx_ / norm, cy_ / norm, cz_ / norm], axis=-1)
                sm1, cs1 = score(cache_blk, ras, row_lo, rows_ext, d0, n_c)
                valid = take(c.ring_ok) & take2(c.ring_ok)
                accept = valid & (
                    (greedy & (sm1 > sm0)) | (sm1 * cs1 > sm0 * cs0)
                )
                return (
                    d0,
                    jnp.where(accept, sm1, sm0),
                    jnp.where(accept, cs1, cs0),
                    jnp.where(accept, n_c[..., 0], n0x),
                    jnp.where(accept, n_c[..., 1], n0y),
                    jnp.where(accept, n_c[..., 2], n0z),
                ), None

            carry, _ = jax.lax.scan(refine_body, carry, jnp.arange(8))
            d_blk, sm_blk, cs_blk, n0x, n0y, n0z = carry
            n_blk = jnp.stack([n0x, n0y, n0z], axis=-1)

        return d_blk, sm_blk, cs_blk, n_blk

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(None, axis, None), P()),
        out_specs=(
            P(None, axis, None),
            P(None, axis, None),
            P(None, axis, None),
            P(None, axis, None, None),
        ),
        check_vma=False,
    )
    # big per-pixel arrays must not ride in replicated: labels go through
    # the sharded arg, ras colors are rebuilt per block
    ctx_small = ctx._replace(
        labels=jnp.zeros((1, 1, 1), jnp.int32),
        ras_color=jnp.zeros((1, 3), jnp.float32),
    )
    d, sm, cs, nrm = jax.jit(fn)(ctx.labels, ctx_small)
    return R.RefineState(d=d, sm=sm, cs=cs, n=nrm)


def spatial_plane_sweep(
    lab: jax.Array,
    disp_levels,
    pairs: tuple[tuple[int, int, int, int], ...],
    bl_ratio: float,
    mesh: Mesh,
    *,
    axis: str = "tile",
    window_radius: int = 2,
):
    """Dense per-pixel plane sweep with image rows sharded over ``mesh``
    axis ``axis`` and halo exchange via ``ppermute`` — bitwise identical to
    ``models.plane_sweep.plane_sweep_depth``.

    Requires ``H % n_tiles == 0`` and a block height of at least
    ``max_vertical_shift + window_radius`` rows.
    Returns (disp (V, H, W), cost (V, H, W)).
    """
    n_tiles = mesh.shape[axis]
    h = lab.shape[1]
    if h % n_tiles:
        raise ValueError(f"image height {h} not divisible by {n_tiles} tiles")
    return _spatial_sweep_shardmap(
        jnp.asarray(lab),
        tuple(float(d) for d in np.asarray(disp_levels)),
        pairs,
        float(bl_ratio),
        int(window_radius),
        (mesh, axis),
        n_tiles,
    )
