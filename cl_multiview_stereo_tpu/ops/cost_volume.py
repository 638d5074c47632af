"""Plane-sweep photo-consistency depth initialization.

Behavioral spec: kernel ``initial_depth_estimation_v2``
(``clMVDE/clcode.cl:972-1069``), the live depth-init core: per superpixel,
a 5x5 adaptive sample grid (pitch from the extent bounding box) is swept
over the disparity ladder; for each hypothesis d and each neighbor view the
cost is the SAD of Lab colors between the reference sample and its
projection ``(x - d*dvx, y - bl_ratio*d*dvy)`` (clcode.cl:1033-1034), with
an out-of-frame penalty of 30 per sample (clcode.cl:1037-1042); the
per-hypothesis cost is the *min* over neighbor views (clcode.cl:1054-1055)
and the winner-take-all disparity is written to the superpixel record
(clcode.cl:1059-1067).

Design:
  * all views are processed in one jitted call instead of the reference's
    per-view host loop (photo_consistency.cpp:133-140);
  * the cost volume lives in ``(V, D, Mh, Mw)`` layout so the minor axis
    is the wide superpixel-column axis, not the 31-deep hypothesis axis;
  * accumulation runs as ``lax.scan`` over neighbor slots and sample points
    (8 x 25 steps), keeping only O(V*D*Mh*Mw) live temporaries instead of
    an unrolled graph of hundreds;
  * images are gathered channel-planar ``(3, V, H, W)`` so gather outputs
    keep a wide trailing axis;
  * ties (equal costs) resolve to the lowest disparity index, identical to
    the reference's strict-``<`` ascending scan.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cl_multiview_stereo_tpu.ops.superpixel import extent_step

_OOB_PENALTY = 30.0
_BIG = 1.0e6

_SAMPLE_OFFSETS = tuple((i, j) for i in range(-2, 3) for j in range(-2, 3))


@partial(jax.jit, static_argnums=(5, 6))
def superpixel_cost_volume(
    lab: jax.Array,  # (V, H, W, 3)
    centers: jax.Array,  # (V, Mh, Mw, 2)
    step: jax.Array,  # (V, Mh, Mw, 2) adaptive sample pitch
    disp_levels: jax.Array,  # (D,) float32
    view_subset: jax.Array,  # (V, max_n) int32, -1 padded
    array_width: int,
    bl_ratio: float,
) -> jax.Array:
    """Build the per-superpixel cost volume, min-reduced over neighbor views.

    Returns (V, D, Mh, Mw) float32 costs (lower = better); views with an
    empty neighbor subset hold ``_BIG``.
    """
    v, h, w = lab.shape[:3]
    mh, mw = centers.shape[1:3]
    d = disp_levels.shape[0]
    max_n = view_subset.shape[1]

    labp = jnp.moveaxis(lab, -1, 0)  # (3, V, H, W) channel-planar

    z = jnp.arange(v, dtype=jnp.int32)
    cam_x = z % array_width
    cam_y = z // array_width

    valid_n = view_subset >= 0  # (V, max_n)
    view_ids_c = jnp.clip(view_subset, 0, v - 1)
    dvx_all = ((view_ids_c % array_width) - cam_x[:, None]).astype(jnp.float32)
    dvy_all = ((view_ids_c // array_width) - cam_y[:, None]).astype(jnp.float32)

    dl = disp_levels.astype(jnp.float32)  # (D,)
    cxf = centers[..., 0]  # (V, Mh, Mw)
    cyf = centers[..., 1]
    sample_ij = jnp.asarray(_SAMPLE_OFFSETS, jnp.float32)  # (25, 2)

    vid = jnp.arange(v, dtype=jnp.int32)[:, None, None]  # (V,1,1)

    def slot_body(vol, n):
        view_n = view_ids_c[:, n]  # (V,)
        # per-hypothesis projection shifts, (V, D)
        shift_x = dl[None, :] * dvx_all[:, n][:, None]
        shift_y = bl_ratio * dl[None, :] * dvy_all[:, n][:, None]

        def sample_body(acc, ij):
            i, j = ij[0], ij[1]
            xr = (cxf + i * step[..., 0]).astype(jnp.int32)  # C trunc cast
            yr = (cyf + j * step[..., 1]).astype(jnp.int32)
            ref_inb = (xr >= 0) & (yr >= 0) & (xr < w) & (yr < h)
            xrc = jnp.clip(xr, 0, w - 1)
            yrc = jnp.clip(yr, 0, h - 1)
            c_ref = labp[:, vid, yrc, xrc]  # (3, V, Mh, Mw)

            xp = (
                xr[:, None].astype(jnp.float32) - shift_x[:, :, None, None]
            ).astype(jnp.int32)  # (V, D, Mh, Mw)
            yp = (
                yr[:, None].astype(jnp.float32) - shift_y[:, :, None, None]
            ).astype(jnp.int32)
            proj_inb = (xp >= 0) & (yp >= 0) & (xp < w) & (yp < h)
            xpc = jnp.clip(xp, 0, w - 1)
            ypc = jnp.clip(yp, 0, h - 1)
            view_b = view_n[:, None, None, None]
            c_proj = labp[:, view_b, ypc, xpc]  # (3, V, D, Mh, Mw)

            sad = jnp.sum(jnp.abs(c_ref[:, :, None] - c_proj), axis=0)
            ok = ref_inb[:, None] & proj_inb
            return acc + jnp.where(ok, sad, _OOB_PENALTY), None

        acc0 = jnp.zeros((v, d, mh, mw), jnp.float32)
        acc, _ = jax.lax.scan(sample_body, acc0, sample_ij)
        slot_valid = valid_n[:, n][:, None, None, None]
        return jnp.minimum(vol, jnp.where(slot_valid, acc, _BIG)), None

    vol0 = jnp.full((v, d, mh, mw), _BIG, jnp.float32)
    vol, _ = jax.lax.scan(slot_body, vol0, jnp.arange(max_n, dtype=jnp.int32))
    return vol


def _shift2d_nan(img: jax.Array, sx: int, sy: int) -> jax.Array:
    """out[..., y, x, :] = img[..., y-sy, x-sx, :] with NaN outside."""
    h, w = img.shape[-3], img.shape[-2]
    py0, py1 = max(sy, 0), max(-sy, 0)
    px0, px1 = max(sx, 0), max(-sx, 0)
    pad = [(0, 0)] * (img.ndim - 3) + [(py0, py1), (px0, px1), (0, 0)]
    padded = jnp.pad(img, pad, constant_values=jnp.nan)
    return jax.lax.slice(
        padded,
        [0] * (img.ndim - 3) + [py1, px1, 0],
        list(img.shape[:-3]) + [py1 + h, px1 + w, img.shape[-1]],
    )


def _trunc_int(x: float) -> int:
    import math

    return int(math.trunc(x))


@partial(jax.jit, static_argnums=(4, 5, 6, 7, 8, 9, 10))
def superpixel_cost_volume_dense(
    lab: jax.Array,  # (V, H, W, 3)
    centers: jax.Array,  # (V, Mh, Mw, 2)
    step: jax.Array,  # (V, Mh, Mw, 2)
    disp_levels: jax.Array,  # (D,)
    array_width: int,
    bl_ratio: float,
    neib_hor: int = 1,
    neib_ver: int = 1,
    max_abs_disp: float = 256.0,
    deltas_subset: tuple | None = None,  # restrict to these (gx, gy) deltas
    wide_rows: bool = True,
    # wide_rows=True (single-device default): gd-minor SAD tables + one
    # wide row gather per (cell, sample); its python-chunked table builds
    # REPLICATE under GSPMD view sharding (terabytes per device for the
    # 7x7 2K rig).  wide_rows=False is the per-hypothesis narrow-gather
    # form the sharded pipeline uses.
) -> jax.Array:
    """Shift-plane formulation of the same cost volume: for each camera-grid
    delta g and hypothesis d, the projected image is an integer shift of the
    neighbor view (clcode.cl:1034 with the coordinate truncation folded into
    the shift), so the per-(g, d) SAD plane is a dynamic slice of a
    pre-padded image pair — no gathers in the sweep itself; the 25 adaptive
    samples then read all delta-planes with ONE channel-packed row gather
    per hypothesis.  The hypothesis loop is a ``lax.scan`` (one compiled
    body regardless of ladder length).

    Exactness: the reference truncates the *projected coordinate*
    ``(int)(x - c)`` (clcode.cl:1034), which for any in-bounds result equals
    ``x - ceil(c)``, and its bounds check admits ``x - c`` in ``(-1, 0)``
    (truncates to 0).  Both are reproduced: images are edge-replicate padded
    (so index ``-1`` reads column/row 0) and validity is an exact float
    test ``-1 < x - c < size`` applied per sample.  Returns (V, D, Mh, Mw);
    views with no valid neighbor hold ``_BIG``.
    """
    import numpy as np

    v, h, w = lab.shape[:3]
    mh, mw = centers.shape[1:3]

    ah = array_width
    av = v // array_width

    deltas = [
        (gx, gy)
        for gx in range(-neib_hor, neib_hor + 1)
        for gy in range(-neib_ver, neib_ver + 1)
        if not (gx == 0 and gy == 0)
    ]
    if deltas_subset is not None:
        deltas = [g for g in deltas if g in deltas_subset]
    if not deltas:
        return jnp.full(
            (v, disp_levels.shape[0], mh, mw), _BIG, jnp.float32
        )
    z = np.arange(v)
    zx, zy = z % ah, z // ah
    valid = np.stack(
        [
            (0 <= zx + gx) & (zx + gx < ah) & (0 <= zy + gy) & (zy + gy < av)
            for gx, gy in deltas
        ],
        axis=-1,
    )  # (V, G)
    valid_j = jnp.asarray(valid)

    # max |shift| per axis over the ladder (static bound, passed by the
    # dispatcher from the concrete config ladder)
    max_sx = int(np.ceil(max_abs_disp * neib_hor)) + 1
    max_sy = int(np.ceil(bl_ratio * max_abs_disp * neib_ver)) + 1

    # ONE pre-padded image stack; edge-replicate so index -1 reads row/col 0
    # (the reference's (int) cast maps (-1, 0) to 0, clcode.cl:1034,1039) —
    # validity is decided by the float test below, never by padding content.
    # The per-delta view roll happens INSIDE the hypothesis loop on the
    # (V, h, w, 3) slice: rolling before padding kept 8 full padded copies
    # (~2.1 GB at 9x1080p) live across the whole scan in the single-jit
    # program; spatial padding commutes with the view roll, so the values
    # are identical.
    padded_all = jnp.pad(
        lab, ((0, 0), (max_sy, max_sy), (max_sx, max_sx), (0, 0)), mode="edge"
    )

    # reference-sample positions (d-independent)
    cxf, cyf = centers[..., 0], centers[..., 1]
    offs = jnp.asarray(_SAMPLE_OFFSETS, jnp.float32)  # (25, 2)
    xr = (cxf[..., None] + offs[:, 0] * step[..., 0:1]).astype(jnp.int32)
    yr = (cyf[..., None] + offs[:, 1] * step[..., 1:2]).astype(jnp.int32)
    ref_ok = (xr >= 0) & (yr >= 0) & (xr < w) & (yr < h)  # (V, Mh, Mw, 25)
    flat_ref = (
        jnp.arange(v, dtype=jnp.int32)[:, None, None, None] * (h * w)
        + jnp.clip(yr, 0, h - 1) * w
        + jnp.clip(xr, 0, w - 1)
    ).reshape(-1)
    xrf = xr.astype(jnp.float32)  # (V, Mh, Mw, 25)
    yrf = yr.astype(jnp.float32)
    gxs = jnp.asarray([gx for gx, _ in deltas], jnp.float32)  # (G,)
    gys = jnp.asarray([gy for _, gy in deltas], jnp.float32)

    if not wide_rows:
        def per_d(carry, d):
            planes = []
            for g, (gx, gy) in enumerate(deltas):
                dz = gy * ah + gx
                # in-bounds trunc(xr - c) == xr - ceil(c) for ALL c (the result
                # is >= 0, so trunc == floor == xr - ceil(c))
                sx = jnp.ceil(d * gx).astype(jnp.int32)
                sy = jnp.ceil(bl_ratio * d * gy).astype(jnp.int32)
                # out[z, y, x] = view[z + dz][y - sy, x - sx]: slice first (all
                # views), then roll the view axis — both transient per (d, g)
                shifted = jax.lax.dynamic_slice(
                    padded_all,
                    (0, max_sy - sy, max_sx - sx, 0),
                    (v, h, w, 3),
                )
                shifted = jnp.roll(shifted, -dz, axis=0)  # row z holds view z+dz
                planes.append(jnp.sum(jnp.abs(lab - shifted), axis=-1))
            table = jnp.stack(planes, axis=-1).reshape(-1, len(deltas))
            g25 = table[flat_ref].reshape(v, mh, mw, 25, len(deltas))
            # exact projected-coordinate validity: (int)(x - c) lands in
            # [0, size) iff  -1 < x - c < size  (clcode.cl:1039)
            cx_ = d * gxs  # (G,)
            cy_ = bl_ratio * d * gys
            px = xrf[..., None] - cx_
            py = yrf[..., None] - cy_
            proj_ok = (px > -1.0) & (px < w) & (py > -1.0) & (py < h)
            ok = ref_ok[..., None] & proj_ok  # (V, Mh, Mw, 25, G)
            acc = jnp.sum(jnp.where(ok, g25, _OOB_PENALTY), axis=3)
            best = jnp.min(jnp.where(valid_j[:, None, None, :], acc, _BIG), axis=-1)
            return carry, best

        _, vols = jax.lax.scan(per_d, 0, disp_levels.astype(jnp.float32))
        return jnp.moveaxis(vols, 0, 1)  # (V, D, Mh, Mw)  # (V, D, Mh, Mw)

    # ---- wide-row restructure --------------------------------------------
    # The form above gathers the per-delta SAD table once PER HYPOTHESIS
    # (31 x 7.3 M rows of 8 f32 — 226 M narrow rows per 9x1080p scene).  A
    # (V*H*W, G*Dc) gd-minor table instead serves ALL hypotheses of a
    # D-chunk with ONE ~kB row per (cell, sample), so the gather count
    # drops 31x.  D is chunked so only one table (~3.6 GB at the reference
    # scale) plus its scan stack is live at a time.
    d_all = disp_levels.astype(jnp.float32)
    d_num = d_all.shape[0]
    n_g = len(deltas)
    d_chunk = max(1, -(-d_num // max(1, -(-(n_g * d_num) // 128))))
    pad_d = (-d_num) % d_chunk
    if pad_d:
        d_all = jnp.concatenate([d_all, d_all[-1:].repeat(pad_d)], axis=0)
    n_chunks = (d_num + pad_d) // d_chunk

    # per-sample leading layouts for the accumulation scan
    mv = lambda a: jnp.moveaxis(a, -1, 0)  # (25, V, Mh, Mw)
    flat25_v = mv(
        jnp.clip(yr, 0, h - 1) * w + jnp.clip(xr, 0, w - 1)
    )  # per-VIEW pixel offset (the view base is added per view chunk)

    # The SAD table is indexed by the REFERENCE pixel only (a sample of
    # view z reads rows of view z), so the view axis chunks exactly —
    # bounding the (stack + table) peak to a few views' worth.
    v_chunk = max(1, min(v, -(-3 * 2073600 // (h * w))))
    n_vc = -(-v // v_chunk)

    def build_step_views(v0, n_views):
        def build_step(_, d):
            planes = []
            for g, (gx, gy) in enumerate(deltas):
                dz = gy * ah + gx
                # in-bounds trunc(xr - c) == xr - ceil(c) for ALL c (the
                # result is >= 0, so trunc == floor == xr - ceil(c))
                sx = jnp.ceil(d * gx).astype(jnp.int32)
                sy = jnp.ceil(bl_ratio * d * gy).astype(jnp.int32)
                # out[z, y, x] = view[z + dz][y - sy, x - sx]: slice first
                # (all views), then roll the view axis
                shifted = jax.lax.dynamic_slice(
                    padded_all,
                    (0, max_sy - sy, max_sx - sx, 0),
                    (v, h, w, 3),
                )
                shifted = jnp.roll(shifted, -dz, axis=0)
                sad = jnp.sum(
                    jnp.abs(
                        lab[v0 : v0 + n_views] - shifted[v0 : v0 + n_views]
                    ),
                    axis=-1,
                )
                planes.append(sad)
            return 0, jnp.stack(planes, axis=-1).reshape(-1, n_g)

        return build_step

    vols = []
    for c in range(n_chunks):
        dl_c = jax.lax.dynamic_slice_in_dim(d_all, c * d_chunk, d_chunk)
        # projection shifts for every (d, g) of this chunk, gd-minor to
        # match the table's row layout [d0g0, d0g1, ..., d1g0, ...]
        cx_gd = (dl_c[:, None] * gxs[None, :]).reshape(-1)  # (Dc*G,)
        cy_gd = (bl_ratio * dl_c[:, None] * gys[None, :]).reshape(-1)

        bests = []
        for vc in range(n_vc):
            v0 = vc * v_chunk
            n_views = min(v_chunk, v - v0)
            _, slabs = jax.lax.scan(
                build_step_views(v0, n_views), 0, dl_c
            )  # (Dc, Vc*H*W, G)
            table = jnp.moveaxis(slabs, 0, 1).reshape(-1, d_chunk * n_g)
            table = jax.lax.optimization_barrier(table)

            vbase = (
                jnp.arange(n_views, dtype=jnp.int32) * (h * w)
            )[:, None, None]  # chunk-local view row base
            xs_vc = (
                (flat25_v[:, v0 : v0 + n_views] + vbase[None]).reshape(25, -1),
                mv(xrf)[:, v0 : v0 + n_views],
                mv(yrf)[:, v0 : v0 + n_views],
                mv(ref_ok)[:, v0 : v0 + n_views],
            )

            def per_sample(acc, xs):
                flat_s, xrf_s, yrf_s, ok_s = xs
                rows = table[flat_s].reshape(
                    n_views, mh, mw, d_chunk * n_g
                )
                # exact projected-coordinate validity: (int)(x - c) lands
                # in [0, size) iff  -1 < x - c < size  (clcode.cl:1039)
                px = xrf_s[..., None] - cx_gd
                py = yrf_s[..., None] - cy_gd
                ok = (
                    ok_s[..., None]
                    & (px > -1.0) & (px < w) & (py > -1.0) & (py < h)
                )
                return acc + jnp.where(ok, rows, _OOB_PENALTY), None

            acc0 = jnp.zeros((n_views, mh, mw, d_chunk * n_g), jnp.float32)
            acc, _ = jax.lax.scan(per_sample, acc0, xs_vc)
            acc = acc.reshape(n_views, mh, mw, d_chunk, n_g)
            best = jnp.min(
                jnp.where(
                    valid_j[v0 : v0 + n_views, None, None, None, :],
                    acc, _BIG,
                ),
                axis=-1,
            )  # (Vc, Mh, Mw, Dc)
            bests.append(jax.lax.optimization_barrier(best))
        vols.append(jnp.moveaxis(jnp.concatenate(bests, axis=0), -1, 1))
    vol = jnp.concatenate(vols, axis=1)[:, :d_num]  # (V, D, Mh, Mw)
    return vol


def wta_disparity(
    vol: jax.Array, disp_levels: jax.Array, subset_num: jax.Array
) -> jax.Array:
    """Winner-take-all over the hypothesis axis (clcode.cl:1059-1067).

    ``vol``: (V, D, Mh, Mw).  Strict-``<`` ascending scan == argmin with
    first-tie-wins.  Views with no neighbors keep the reference's
    never-updated 0.0 (clcode.cl:1014).
    """
    idx = jnp.argmin(vol, axis=1)
    disp = jnp.asarray(disp_levels)[idx]
    has_views = jnp.asarray(subset_num) > 0
    return jnp.where(has_views[:, None, None], disp, 0.0)


def initial_depth_estimation(
    lab: jax.Array,
    centers: jax.Array,
    extent: jax.Array,
    disp_levels,  # concrete (numpy) ladder — parameterizes static shifts
    view_subset: jax.Array,
    subset_num: jax.Array,
    array_width: int,
    bl_ratio: float,
    method: str = "gather",
    neib_hor: int = 1,
    neib_ver: int = 1,
    dense_wide_rows: bool = True,
) -> jax.Array:
    """Full depth init: extent -> adaptive step -> cost volume -> WTA.

    ``method``: ``"gather"`` is the direct per-sample gather form;
    ``"dense"`` the shift-plane formulation (same exact semantics).
    ``disp_levels`` must be concrete (numpy): it
    sets the static padding bound even when the caller is being traced.
    Returns (V, Mh, Mw) float32 initial disparity (the reference's
    ``spixl_map.s7``).
    """
    import numpy as np

    disp_levels = np.asarray(disp_levels)
    step = extent_step(extent)
    if method == "dense":
        max_abs = float(np.max(np.abs(disp_levels))) if len(disp_levels) else 0.0
        vol = superpixel_cost_volume_dense(
            lab, centers, step, jnp.asarray(disp_levels, jnp.float32),
            array_width, bl_ratio, neib_hor, neib_ver, max_abs,
            None, dense_wide_rows,
        )
    else:
        vol = superpixel_cost_volume(
            lab, centers, step, disp_levels, view_subset, array_width, bl_ratio
        )
    return wta_disparity(vol, disp_levels, subset_num)
