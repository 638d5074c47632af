"""SLIC superpixel segmentation — vectorized jnp implementation.

Behavioral spec: the live SLIC path of the reference
(``clMVDE/clSLIC.cpp:67-122`` sequencing kernels from ``clMVDE/clcode.cl``):

  init_cluster_centers (clcode.cl:259-294)
  find_center_association (clcode.cl:447-520)          # gSLICr 4-candidate
  repeat no_iter times:
      update_cluster_center + finalize_reduction_result (clcode.cl:533-773)
      find_center_association
  [optional] supress_local_lable x2 ping-pong (clcode.cl:676-711)

Design deltas (SURVEY.md section 7.1):
  * views are a vmapped axis; all views segment in a single jitted call
    instead of the reference's host loop (pipeline.cpp:76-95);
  * the workgroup-local tree reduction of the update stage (clcode.cl:582-597)
    becomes a dense ``segment_sum`` over per-view labels — identical math,
    association-order-free because the summands are averages;
  * everything is shape-static: labels are per-view flat indices
    ``row*Mw + col`` in int32, superpixel state is a SoA pytree.

Quirks preserved for parity (see testing/mirror.py):
  * candidate-window parity swap: the x-derived half-cell parity offsets the
    *y* cluster coordinate and vice versa (clcode.cl:461-479);
  * ties resolve to the first candidate in the reference's loop order;
  * clusters that lose all members in an update round get center/color/count
    zeroed, not held (clcode.cl:731-771);
  * the update only counts members inside the cluster's 3S x 3S search
    window (clcode.cl:558-566).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cl_multiview_stereo_tpu.config import DerivedGeometry, SlicParams


class SuperpixelMap(NamedTuple):
    """SoA replacement for the reference's ``float8 spixl_map`` record
    (clcode.cl:285-293): s0=id (implicit here: ``row*Mw+col``), s12=center,
    s345=Lab color, s6=count, s7=disparity.

    All arrays are leading-``(V, Mh, Mw)``.
    """

    center: jax.Array  # (V, Mh, Mw, 2) float32, (x, y)
    color: jax.Array  # (V, Mh, Mw, 3) float32 Lab
    count: jax.Array  # (V, Mh, Mw) float32
    disp: jax.Array  # (V, Mh, Mw) float32


def init_cluster_centers(lab: jax.Array, geom: DerivedGeometry) -> SuperpixelMap:
    """Seed centers on the regular grid (clcode.cl:259-294).

    ``lab``: (V, H, W, 3).
    """
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    col = jnp.arange(geom.map_w, dtype=jnp.int32)
    row = jnp.arange(geom.map_h, dtype=jnp.int32)
    cx = col * s + s // 2
    cy = row * s + s // 2
    # Border pull-in with the reference's `>` comparison (clcode.cl:273-277).
    cx = jnp.where(cx > w, (col * s + w) // 2, cx)
    cy = jnp.where(cy > h, (row * s + h) // 2, cy)
    cxg, cyg = jnp.meshgrid(cx, cy, indexing="xy")  # (Mh, Mw)
    center = jnp.stack([cxg, cyg], axis=-1).astype(jnp.float32)
    sample_y = jnp.clip(cyg, 0, h - 1)
    sample_x = jnp.clip(cxg, 0, w - 1)
    color = lab[:, sample_y, sample_x, :]  # (V, Mh, Mw, 3)
    center = jnp.broadcast_to(center[None], (v, geom.map_h, geom.map_w, 2))
    count = jnp.zeros((v, geom.map_h, geom.map_w), jnp.float32)
    disp = jnp.zeros((v, geom.map_h, geom.map_w), jnp.float32)
    return SuperpixelMap(center=center, color=color, count=count, disp=disp)


def _upsample_map(field: jax.Array, p: int, q: int, h: int, w: int, s: int):
    """Dense candidate-field construction: returns per-pixel
    ``field[v, row//s + p, col//s + q]`` as a (V, H, W, C) array plus a
    validity mask — built from a static map shift + block repeat, so the
    whole SLIC assignment needs NO gathers (everything fuses to elementwise
    selects).  The channel-packed form is kept here; a channel-planar
    variant is the alternative to time against it."""
    v, mh, mw = field.shape[:3]
    rolled = jnp.roll(field, shift=(-p, -q), axis=(1, 2))
    colm = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)
    rowm = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)
    okm = (colm + q >= 0) & (colm + q < mw) & (rowm + p >= 0) & (rowm + p < mh)
    up = jnp.repeat(jnp.repeat(rolled, s, axis=1), s, axis=2)[:, :h, :w]
    okp = jnp.repeat(jnp.repeat(okm[None], s, axis=1), s, axis=2)[:, :h, :w]
    return up, okp


def find_center_association(
    lab: jax.Array, spmap: SuperpixelMap, geom: DerivedGeometry, p: SlicParams
) -> jax.Array:
    """Assignment step (clcode.cl:447-520): each pixel picks the nearest of 4
    candidate clusters chosen by half-cell parity.  Returns (V, H, W) int32
    per-view labels.

    The candidate cluster coordinate is a *static* function of the pixel
    coordinate (home cell + half-cell parity + {-1,0}), so each candidate's
    center/color fields are parity-selected upsampled maps — no gathers.
    """
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h

    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cx = col // s
    cy = row // s
    # half-cell parity: dx from the column, dy from the row
    dxp = ((col % s) + s // 2) // s  # (H, W) in {0, 1}
    dyp = ((row % s) + s // 2) // s

    packed = jnp.concatenate(
        [spmap.center, spmap.color], axis=-1
    )  # (V, Mh, Mw, 5)

    best = jnp.full((v, h, w), jnp.inf, jnp.float32)
    best_id = jnp.full((v, h, w), -1, jnp.int32)

    colf = col.astype(jnp.float32)
    rowf = row.astype(jnp.float32)

    # Distance to cluster (cy + a, cx + b) per static cell shift (a, b):
    # each upsampled 5-channel field map has exactly ONE consumer here, so
    # XLA fuses it into the distance arithmetic instead of materializing
    # nine 370 MB (V, H, W, 5) temps (~3.3 GB at 9x1080p if all nine were
    # live at once).  Only the nine (V, H, W) float32 distance planes
    # persist.
    dists: dict[tuple[int, int], jax.Array] = {}
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            fld, ok = _upsample_map(packed, a, b, h, w, s)
            color_d = jnp.sum((lab - fld[..., 2:5]) ** 2, axis=-1)
            space_d = (colf - fld[..., 0]) ** 2 + (rowf - fld[..., 1]) ** 2
            dist = jnp.sqrt(
                color_d * p.max_color_dist
                + p.color_weight * space_d * p.max_xy_dist
            )
            dists[(a, b)] = jnp.where(ok, dist, jnp.inf)

    # Loop order of clcode.cl:475-479: i in {dx-1, dx} offsets y, j in
    # {dy-1, dy} offsets x (parity swap quirk preserved); first strict
    # minimum wins.  Per pixel the candidate at step (i_off, j_off) is the
    # cell shift (dxp + i_off, dyp + j_off) — a parity select among four of
    # the nine precomputed distance planes.
    my = dxp[None] == 1
    mx = dyp[None] == 1
    for i_off in (-1, 0):
        for j_off in (-1, 0):
            d00 = dists[(i_off, j_off)]
            d01 = dists[(i_off, j_off + 1)]
            d10 = dists[(i_off + 1, j_off)]
            d11 = dists[(i_off + 1, j_off + 1)]
            dist = jnp.where(
                my, jnp.where(mx, d11, d10), jnp.where(mx, d01, d00)
            )
            qy = jnp.clip(cy + dxp + i_off, 0, mh - 1)
            qx = jnp.clip(cx + dyp + j_off, 0, mw - 1)
            cand_id = (qy * mw + qx)[None]
            take = dist < best
            best = jnp.where(take, dist, best)
            best_id = jnp.where(take, cand_id, best_id)
    return best_id


def update_cluster_centers(
    lab: jax.Array, labels: jax.Array, spmap: SuperpixelMap, geom: DerivedGeometry
) -> SuperpixelMap:
    """Cluster stats update (clcode.cl:533-773) as a per-view segment sum.

    Members outside their cluster's 3S x 3S search window are dropped, and
    empty clusters are zeroed — both for parity with the device reduction.
    Disparity is carried through untouched (finalize writes s0..s6 only).
    """
    v, h, w = lab.shape[:3]
    s = geom.spixl_size
    mw, mh = geom.map_w, geom.map_h
    n_seg = mw * mh

    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    gx = labels % mw
    gy = labels // mw

    # Scatter-free reduction: a pixel inside its cluster's 3S x 3S window
    # necessarily carries a label within +-1 cell of its home cell, so the
    # per-label scatter becomes a 9-class one-hot multiply + per-cell block
    # sum + 9 static shifts (all dense).  Membership
    # outside the window (|cell delta| > 1) is exactly the window-drop
    # semantics of the device reduction (clcode.cl:558-566).
    rel_x = gx - col[None] // s  # (V, H, W) in {-1, 0, 1} when in-window
    rel_y = gy - row[None] // s

    # Channel-PLANAR accumulation: six (V, H, W) planes keep the wide W
    # axis minor (a (V, H, W, 6) operand would put the 6-wide channel axis
    # minor), and the whole update fuses to selects + block sums.
    colf = jnp.broadcast_to(col.astype(jnp.float32)[None], (v, h, w))
    rowf = jnp.broadcast_to(row.astype(jnp.float32)[None], (v, h, w))
    planes = (
        lab[..., 0], lab[..., 1], lab[..., 2],
        colf, rowf, jnp.ones((v, h, w), jnp.float32),
    )  # Lab, x, y, count

    hp = mh * s
    wp = mw * s
    colm = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)[None]
    rowm = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)[None]
    sums = [jnp.zeros((v, mh, mw), jnp.float32) for _ in range(6)]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sel = ((rel_x == dx) & (rel_y == dy)).astype(jnp.float32)
            # members with home cell (cy, cx) belong to cluster
            # (cy + dy, cx + dx): shift the block sums accordingly
            okm = (
                (colm - dx >= 0)
                & (colm - dx < mw)
                & (rowm - dy >= 0)
                & (rowm - dy < mh)
            )
            for c, plane in enumerate(planes):
                contrib = jnp.pad(
                    plane * sel, ((0, 0), (0, hp - h), (0, wp - w))
                )
                # two-stage block sum: a direct (V, mh, s, mw, s) reshape
                # puts s = 8 on the minor axis; row sums first keep the
                # wide Wp axis minor throughout
                rows_s = contrib.reshape(v, mh, s, wp).sum(axis=2)
                block = rows_s.reshape(v, mh, mw, s).sum(axis=3)
                shifted = jnp.roll(block, shift=(dy, dx), axis=(1, 2))
                sums[c] = sums[c] + jnp.where(okm, shifted, 0.0)
    n = sums[5]
    nz = n > 0
    denom = jnp.where(nz, n, 1.0)
    color = jnp.where(
        nz[..., None], jnp.stack(sums[0:3], axis=-1) / denom[..., None], 0.0
    )
    center = jnp.where(
        nz[..., None], jnp.stack(sums[3:5], axis=-1) / denom[..., None], 0.0
    )
    count = jnp.where(nz, n, 0.0)
    return SuperpixelMap(center=center, color=color, count=count, disp=spmap.disp)


@jax.jit
def compute_edges(lab: jax.Array) -> jax.Array:
    """Edge magnitude for the optional edge-snap path
    (``edge_compute_alternative``, clcode.cl:161-195): 3x3 Sobel on Lab with
    border-replicate neighbor reads, ``edge = sqrt(sum_ch(DX^2 + DY^2))``.

    Two deviations from the committed kernel, both on the intended-semantics
    side (SURVEY.md Appendix): the committed loop also stores the *center*
    pixel, overflowing its 8-entry array and shifting the Sobel taps — the
    commented-out skip-center branch (clcode.cl:179-182) restores the classic
    Sobel implemented here; and the result goes to a separate edge image, not
    back into ``cvt_img`` (the clcode.cl:194 aliasing bug).

    ``lab``: (V, H, W, 3).  Returns (V, H, W) float32.
    """
    padded = jnp.pad(lab, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = lab.shape[1:3]

    def at(dx: int, dy: int) -> jax.Array:
        return jax.lax.dynamic_slice(
            padded, (0, 1 + dy, 1 + dx, 0), (lab.shape[0], h, w, 3)
        )

    dxc = (
        -at(-1, -1) + at(1, -1) - 2.0 * at(-1, 0) + 2.0 * at(1, 0)
        - at(-1, 1) + at(1, 1)
    )
    dyc = (
        -at(-1, -1) - 2.0 * at(0, -1) - at(1, -1)
        + at(-1, 1) + 2.0 * at(0, 1) + at(1, 1)
    )
    return jnp.sqrt(jnp.sum(dxc * dxc + dyc * dyc, axis=-1))


# Ring scan order of ``apply_edge_alternative`` (clcode.cl:215) — identical
# to the refinement stage's ring (refine._RING).
_EDGE_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))


@jax.jit
def apply_edge_snap(
    lab: jax.Array, edges: jax.Array, spmap: SuperpixelMap
) -> SuperpixelMap:
    """Edge-snap (``apply_edge_alternative``, clcode.cl:204-248): move each
    cluster center to the strictly-lowest-edge pixel among its 8 neighbors
    (running strict ``<`` in ring order: the first minimum wins ties) and
    adopt that pixel's Lab color.
    """
    v, h, w = edges.shape
    cx = spmap.center[..., 0].astype(jnp.int32)
    cy = spmap.center[..., 1].astype(jnp.int32)
    vid = jnp.arange(v, dtype=jnp.int32)[:, None, None]
    cxs = jnp.clip(cx, 0, w - 1)
    cys = jnp.clip(cy, 0, h - 1)
    best_edge = edges[vid, cys, cxs]
    best_x, best_y = cx, cy
    changed = jnp.zeros(cx.shape, bool)
    for dx, dy in _EDGE_RING:
        nx = cx + dx
        ny = cy + dy
        inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
        ne = edges[vid, jnp.clip(ny, 0, h - 1), jnp.clip(nx, 0, w - 1)]
        take = inb & (ne < best_edge)
        best_edge = jnp.where(take, ne, best_edge)
        best_x = jnp.where(take, nx, best_x)
        best_y = jnp.where(take, ny, best_y)
        changed = changed | take
    new_color = lab[vid, jnp.clip(best_y, 0, h - 1), jnp.clip(best_x, 0, w - 1)]
    center = jnp.where(
        changed[..., None],
        jnp.stack([best_x, best_y], axis=-1).astype(jnp.float32),
        spmap.center,
    )
    color = jnp.where(changed[..., None], new_color, spmap.color)
    return SuperpixelMap(
        center=center, color=color, count=spmap.count, disp=spmap.disp
    )


@jax.jit
def suppress_local_labels(labels: jax.Array) -> jax.Array:
    """Connectivity vote (clcode.cl:676-711): adopt the last-seen (row-major
    5x5 scan) differing label when >= 16 of 25 neighbors differ.  2-px border
    passes through.  Applied per view; call twice for the reference's
    ping-pong (clSLIC.cpp:390-410).
    """
    v, h, w = labels.shape
    diff_count = jnp.zeros((v, h, w), jnp.int32)
    diff_label = jnp.full((v, h, w), -1, jnp.int32)
    for j in range(-2, 3):
        for i in range(-2, 3):
            nl = jnp.roll(labels, shift=(-j, -i), axis=(1, 2))
            ne = nl != labels
            diff_count = diff_count + ne.astype(jnp.int32)
            diff_label = jnp.where(ne, nl, diff_label)
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)[None]
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)[None]
    interior = (col > 1) & (row > 1) & (col < w - 2) & (row < h - 2)
    return jnp.where(interior & (diff_count >= 16), diff_label, labels)


from functools import partial


@partial(jax.jit, static_argnums=(1, 2))
def segment(
    lab: jax.Array, geom: DerivedGeometry, p: SlicParams
) -> tuple[jax.Array, SuperpixelMap]:
    """Full SLIC sequence for all views at once (clSLIC.cpp:84-104).

    ``lab``: (V, H, W, 3) CIELab images.
    Returns (labels (V, H, W) int32, SuperpixelMap).
    """
    spmap = init_cluster_centers(lab, geom)
    if p.edge_enable:
        spmap = apply_edge_snap(lab, compute_edges(lab), spmap)
    labels = find_center_association(lab, spmap, geom, p)
    for _ in range(p.no_iter):
        spmap = update_cluster_centers(lab, labels, spmap, geom)
        labels = find_center_association(lab, spmap, geom, p)
    if p.enforce_connectivity:
        labels = suppress_local_labels(labels)
        labels = suppress_local_labels(labels)
    return labels, spmap
