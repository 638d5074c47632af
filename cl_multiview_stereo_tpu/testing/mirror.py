"""Pure-numpy scalar mirrors of the reference OpenCL kernels.

Each function here re-derives, in plain Python loops, the math of one live
device kernel from ``clMVDE/clcode.cl`` (citations inline).  They are the
behavioral spec the vectorized jnp/Pallas ops are differential-tested
against — the same host-mirror-vs-device pattern the reference used
(``photo_consistency.cpp:212-236``, ``depth_refinement.cpp:197-228,405-451``),
made deterministic and pytest-friendly.

Array layout conventions (the framework's, not the reference's):
  * images: ``(V, H, W, C)`` numpy arrays;
  * superpixel grids: ``(V, Mh, Mw, C)``;
  * labels: per-view flat superpixel index ``row * Mw + col`` in ``(V, H, W)``.

C semantics mirrored exactly: int casts truncate toward zero, ``round()`` is
half-away-from-zero (OpenCL round), loop iteration order matters for
first-strict-minimum winners.
"""

from __future__ import annotations

import math

import numpy as np


def f32exp(x: float) -> float:
    """float32 + flush-to-zero exp(): the device computes similarities in
    float32 and XLA flushes denormals, so exp(-large) is exactly 0 below
    the min normal (1.18e-38); the float64 mirror must reproduce that or it
    keeps tiny weights the device never sees."""
    if x <= -700:
        return 0.0
    v = float(np.float32(math.exp(x)))
    return v if v >= 1.1754944e-38 else 0.0


def c_int(x: float) -> int:
    """C-style (int) cast: truncate toward zero."""
    return int(np.trunc(x))


def cl_round(x: float) -> float:
    """OpenCL round(): half away from zero."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


# ---------------------------------------------------------------------------
# Color: rgb2lab (clcode.cl:21-59)
# ---------------------------------------------------------------------------


def rgb2lab_pixel(r: float, g: float, b: float) -> tuple[float, float, float]:
    """Scalar mirror of device ``rgb2lab`` (clcode.cl:21-59). r,g,b in 0..255."""
    _r, _g, _b = r * 0.0039216, g * 0.0039216, b * 0.0039216
    x = _r * 0.412453 + _g * 0.357580 + _b * 0.180423
    y = _r * 0.212671 + _g * 0.715160 + _b * 0.072169
    z = _r * 0.019334 + _g * 0.119193 + _b * 0.950227
    eps, kappa = 0.008856, 903.3
    xr, yr, zr = x / 0.950456, y / 1.0, z / 1.088754

    def f(t: float) -> float:
        return t ** (1.0 / 3.0) if t > eps else (kappa * t + 16.0) / 116.0

    fx, fy, fz = f(xr), f(yr), f(zr)
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB -> Lab, elementwise mirror of kernel ``cvt`` (clcode.cl:125-151)."""
    out = np.zeros(rgb.shape[:-1] + (3,), dtype=np.float64)
    flat_in = rgb.reshape(-1, 3)
    flat_out = out.reshape(-1, 3)
    for i in range(flat_in.shape[0]):
        r, g, b = float(flat_in[i, 0]), float(flat_in[i, 1]), float(flat_in[i, 2])
        flat_out[i] = rgb2lab_pixel(r, g, b)
    return out


# ---------------------------------------------------------------------------
# SLIC: init_cluster_centers (clcode.cl:259-294)
# ---------------------------------------------------------------------------


def slic_init_centers(
    lab: np.ndarray, map_w: int, map_h: int, spixl_size: int
) -> dict[str, np.ndarray]:
    """Mirror of ``init_cluster_centers`` for one view.

    ``lab``: (H, W, 3).  Returns dict of center (Mh, Mw, 2) [x, y], color
    (Mh, Mw, 3), count (Mh, Mw).

    Border clamp quirk preserved: centers past the image edge are pulled to
    ``(col*S + img_size)/2`` using a ``>`` (not ``>=``) comparison
    (clcode.cl:273-277), which can still index one past the valid range for
    images whose size is an exact multiple of S — the reference relies on
    that never happening for its inputs; we clamp the final sample index
    (the only defined behavior available to us) while keeping the stored
    center coordinates identical.
    """
    h, w = lab.shape[:2]
    center = np.zeros((map_h, map_w, 2), dtype=np.float64)
    color = np.zeros((map_h, map_w, 3), dtype=np.float64)
    count = np.zeros((map_h, map_w), dtype=np.float64)
    for row in range(map_h):
        for col in range(map_w):
            cx = col * spixl_size + spixl_size // 2
            cy = row * spixl_size + spixl_size // 2
            if cx > w:
                cx = (col * spixl_size + w) // 2
            if cy > h:
                cy = (row * spixl_size + h) // 2
            center[row, col] = (cx, cy)
            color[row, col] = lab[min(cy, h - 1), min(cx, w - 1)]
    return {"center": center, "color": color, "count": count}


# ---------------------------------------------------------------------------
# SLIC: find_center_association (clcode.cl:447-520)
# ---------------------------------------------------------------------------


def slic_distance(
    pix: np.ndarray,
    px: int,
    py: int,
    c_center: np.ndarray,
    c_color: np.ndarray,
    weight: float,
    space_norm: float,
    color_norm: float,
) -> float:
    """Mirror of ``slic_distance_function`` (clcode.cl:422-438).

    Note the normalizer naming is swapped at the call site: the kernel passes
    ``max_xy_dist`` (spatial normalizer) and ``max_color_dist``; distance =
    sqrt(color_dist^2 * color_norm + weight * space_dist^2 * space_norm)
    where ``weight`` is ``slic_color_weight`` applied to the *spatial* term
    (clcode.cl:433 with clSLIC.cpp:282-284).
    """
    cd = float(np.sum((pix - c_color) ** 2))
    sd = (px - c_center[0]) ** 2 + (py - c_center[1]) ** 2
    return math.sqrt(cd * color_norm + weight * sd * space_norm)


def slic_assign(
    lab: np.ndarray,
    centers: dict[str, np.ndarray],
    spixl_size: int,
    weight: float,
    space_norm: float,
    color_norm: float,
) -> np.ndarray:
    """Mirror of ``find_center_association`` for one view (clcode.cl:447-520).

    Returns (H, W) int64 labels (per-view flat index ``row*Mw + col``).

    The live path uses the gSLICr half-cell-parity trick restricted to a 2x2
    candidate window — with the reference's quirk preserved: the loop
    variable derived from the x-parity (``deltaX``) offsets the *y* cluster
    coordinate and vice versa (clcode.cl:475-479).  Ties resolve to the
    first candidate in loop order (strict ``<``, clcode.cl:487).
    """
    h, w = lab.shape[:2]
    map_h, map_w = centers["center"].shape[:2]
    labels = np.zeros((h, w), dtype=np.int64)
    for row in range(h):
        for col in range(w):
            cx = col // spixl_size
            cy = row // spixl_size
            dx = (col + spixl_size // 2) // spixl_size - cx
            dy = (row + spixl_size // 2) // spixl_size - cy
            best = 1e18
            best_id = -1
            for i in range(-1 + dx, dx + 1):  # offsets the y coordinate
                for j in range(-1 + dy, dy + 1):  # offsets the x coordinate
                    qx = cx + j
                    qy = cy + i
                    if 0 <= qx < map_w and 0 <= qy < map_h:
                        d = slic_distance(
                            lab[row, col],
                            col,
                            row,
                            centers["center"][qy, qx],
                            centers["color"][qy, qx],
                            weight,
                            space_norm,
                            color_norm,
                        )
                        if d < best:
                            best = d
                            best_id = qy * map_w + qx
            labels[row, col] = best_id
    return labels


# ---------------------------------------------------------------------------
# SLIC: update_cluster_center + finalize_reduction_result (clcode.cl:533-773)
# ---------------------------------------------------------------------------


def slic_update(
    lab: np.ndarray,
    labels: np.ndarray,
    centers: dict[str, np.ndarray],
    spixl_size: int,
) -> dict[str, np.ndarray]:
    """Mirror of the two-stage cluster update for one view.

    The device restricts each cluster's member search to the 3S x 3S window
    starting at ``(group_x*S - S, group_y*S - S)`` (clcode.cl:558-566) before
    reducing; members outside that window are dropped even if labeled with
    the cluster.  ``finalize_reduction_result`` then averages, zeroing
    center/color/count when a cluster has no members in the window
    (clcode.cl:731-771).  Disparity (s7) is untouched.
    """
    h, w = lab.shape[:2]
    map_h, map_w = centers["center"].shape[:2]
    out_center = np.zeros_like(centers["center"])
    out_color = np.zeros_like(centers["color"])
    out_count = np.zeros(centers["center"].shape[:2], dtype=np.float64)
    for gy in range(map_h):
        for gx in range(map_w):
            spixel_idx = gy * map_w + gx
            px_start = gx * spixl_size - spixl_size
            py_start = gy * spixl_size - spixl_size
            s_xy = np.zeros(2)
            s_color = np.zeros(3)
            n = 0.0
            for oy in range(3 * spixl_size):
                for ox in range(3 * spixl_size):
                    px = px_start + ox
                    py = py_start + oy
                    if 0 <= px < w and 0 <= py < h and labels[py, px] == spixel_idx:
                        s_color += lab[py, px]
                        s_xy += (px, py)
                        n += 1.0
            if n != 0:
                out_center[gy, gx] = s_xy / n
                out_color[gy, gx] = s_color / n
                out_count[gy, gx] = n
    return {"center": out_center, "color": out_color, "count": out_count}


# ---------------------------------------------------------------------------
# SLIC: edge path — edge_compute_alternative (clcode.cl:161-195, intended
# skip-center Sobel semantics) + apply_edge_alternative (clcode.cl:204-248)
# ---------------------------------------------------------------------------


def edge_compute(lab: np.ndarray) -> np.ndarray:
    """Mirror of the *intended* edge kernel for one view: classic 3x3 Sobel
    over the 8 clamped neighbors (center skipped, the commented branch at
    clcode.cl:179-182), ``edge = sqrt(sum_ch(DX^2 + DY^2))``."""
    h, w = lab.shape[:2]
    out = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            c = {}
            for yo in (-1, 0, 1):
                for xo in (-1, 0, 1):
                    if xo == 0 and yo == 0:
                        continue
                    cx = min(max(x + xo, 0), w - 1)
                    cy = min(max(y + yo, 0), h - 1)
                    c[(xo, yo)] = lab[cy, cx].astype(np.float64)
            dx = (
                -c[(-1, -1)] + c[(1, -1)] - 2 * c[(-1, 0)] + 2 * c[(1, 0)]
                - c[(-1, 1)] + c[(1, 1)]
            )
            dy = (
                -c[(-1, -1)] - 2 * c[(0, -1)] - c[(1, -1)]
                + c[(-1, 1)] + 2 * c[(0, 1)] + c[(1, 1)]
            )
            out[y, x] = np.sqrt(np.sum(dx * dx + dy * dy))
    return out


# Ring scan order of apply_edge_alternative (clcode.cl:215).
EDGE_RING = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))


def apply_edge(
    lab: np.ndarray, edges: np.ndarray, center: np.ndarray, color: np.ndarray
):
    """Mirror of ``apply_edge_alternative`` for one view: snap each center to
    the strictly-lowest-edge 8-neighbor (running ``<`` in ring order) and
    adopt its color.  Mutates copies; returns (center, color)."""
    h, w = edges.shape
    mh, mw = center.shape[:2]
    center = center.copy()
    color = color.copy()
    for gy in range(mh):
        for gx in range(mw):
            cx, cy = int(center[gy, gx, 0]), int(center[gy, gx, 1])
            edge_val = edges[cy, cx]
            best = None
            for dx, dy in EDGE_RING:
                nx, ny = cx + dx, cy + dy
                if 0 <= nx < w and 0 <= ny < h and edges[ny, nx] < edge_val:
                    edge_val = edges[ny, nx]
                    best = (nx, ny)
            if best is not None:
                center[gy, gx] = best
                color[gy, gx] = lab[best[1], best[0]]
    return center, color


# ---------------------------------------------------------------------------
# SLIC: supress_local_lable connectivity vote (clcode.cl:676-711)
# ---------------------------------------------------------------------------


def slic_suppress_labels(labels: np.ndarray) -> np.ndarray:
    """Mirror of ``supress_local_lable`` for one view: if >= 16 of the 5x5
    neighborhood carry a different label, adopt the last-seen different label
    (row-major scan order, clcode.cl:697-708).  Borders (2 px) pass through.
    """
    h, w = labels.shape
    out = labels.copy()
    for y in range(h):
        for x in range(w):
            if x <= 1 or y <= 1 or x >= w - 2 or y >= h - 2:
                continue
            clable = labels[y, x]
            diff_count = 0
            diff_label = -1
            for j in range(-2, 3):
                for i in range(-2, 3):
                    nl = labels[y + j, x + i]
                    if nl != clable:
                        diff_label = nl
                        diff_count += 1
            if diff_count >= 16:
                out[y, x] = diff_label
    return out


# ---------------------------------------------------------------------------
# Superpixel extent: find_super_pixel_boundary (clcode.cl:791-855)
# ---------------------------------------------------------------------------

# Compass order of the 8 extent slots: nw, w, sw, n, s, ne, e, se
# (clcode.cl:826-851).
EXTENT_DIRS = np.array(
    [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)],
    dtype=np.int64,
)  # (dx, dy)


def boundary_clamped_center(cx: int, cy: int, w: int, h: int, s: int) -> tuple[int, int]:
    """Center clamp of clcode.cl:809-819."""
    if cx < s:
        cx += s - cx
    if cx + s > w:
        cx -= s
    if cy < s:
        cy += s - cy
    if cy + s > h:
        cy -= s
    return cx, cy


def superpixel_extent(
    labels: np.ndarray, centers_xy: np.ndarray, spixl_size: int
) -> np.ndarray:
    """Mirror of ``find_super_pixel_boundary`` for one view.

    ``labels``: (H, W) per-view flat labels; ``centers_xy``: (Mh, Mw, 2).
    Returns (Mh, Mw, 8) int64 extents.

    Semantics preserved: the walk records ``i-1`` for the *last* radius i at
    which the probed pixel still carries this superpixel's label (matches
    need not be contiguous, clcode.cl:826-851); reads happen at the clamped
    center so they stay in-view; the bound conditions apply to the
    *unclamped* step, and the stored value saturates at ``spixl_size-2``.
    """
    h, w = labels.shape
    map_h, map_w = centers_xy.shape[:2]
    out = np.zeros((map_h, map_w, 8), dtype=np.int64)
    for my in range(map_h):
        for mx in range(map_w):
            sp_idx = my * map_w + mx
            cx, cy = c_int(centers_xy[my, mx, 0]), c_int(centers_xy[my, mx, 1])
            cx, cy = boundary_clamped_center(cx, cy, w, h, spixl_size)
            for i in range(1, spixl_size):
                for k, (dx, dy) in enumerate(EXTENT_DIRS):
                    px, py = cx + i * dx, cy + i * dy
                    if 0 <= px < w and 0 <= py < h and labels[py, px] == sp_idx:
                        out[my, mx, k] = i - 1
    return out


# ---------------------------------------------------------------------------
# Depth init: initial_depth_estimation_v2 (clcode.cl:972-1069)
# ---------------------------------------------------------------------------


def extent_step_scalar(ext8: np.ndarray) -> tuple[float, float]:
    """Adaptive sample pitch from the extent bbox (clcode.cl:997-1007)."""
    bb_l = max(ext8[0], ext8[1], ext8[2])
    bb_r = max(ext8[5], ext8[6], ext8[7])
    bb_t = max(ext8[0], ext8[3], ext8[5])
    bb_b = max(ext8[2], ext8[4], ext8[7])
    return max(1.0, 0.25 * (bb_l + bb_r)), max(1.0, 0.25 * (bb_t + bb_b))


def initial_depth_estimation_v2(
    lab: np.ndarray,          # (V, H, W, 3)
    centers: np.ndarray,      # (V, Mh, Mw, 2)
    extent: np.ndarray,       # (V, Mh, Mw, 8)
    disp_levels: np.ndarray,  # (D,)
    view_subset: np.ndarray,  # (V, V) -1 padded
    subset_num: np.ndarray,   # (V,)
    array_width: int,
    bl_ratio: float,
) -> np.ndarray:
    """Scalar mirror of the live depth-init kernel (clcode.cl:972-1069).

    Returns (V, Mh, Mw) float64 disparity.
    """
    v, h, w = lab.shape[:3]
    map_h, map_w = centers.shape[1:3]
    out = np.zeros((v, map_h, map_w), dtype=np.float64)
    for z in range(v):
        ref_x, ref_y = z % array_width, z // array_width
        for my in range(map_h):
            for mx in range(map_w):
                sx, sy = extent_step_scalar(extent[z, my, mx])
                cx, cy = centers[z, my, mx]
                cost_est, disp_est = 1.0e6, 0.0
                for d in disp_levels:
                    min_val = 1.0e6
                    for n in range(subset_num[z]):
                        view = int(view_subset[z, n])
                        dvx = view % array_width - ref_x
                        dvy = view // array_width - ref_y
                        val = 0.0
                        for i in range(-2, 3):
                            for j in range(-2, 3):
                                xr = c_int(cx + i * sx)
                                yr = c_int(cy + j * sy)
                                xp = c_int(xr - d * dvx)
                                yp = c_int(yr - bl_ratio * d * dvy)
                                if (
                                    0 <= xr < w and 0 <= yr < h
                                    and 0 <= xp < w and 0 <= yp < h
                                ):
                                    val += float(
                                        np.sum(np.abs(lab[z, yr, xr] - lab[view, yp, xp]))
                                    )
                                else:
                                    val += 30.0
                        if val < min_val:
                            min_val = val
                    if min_val < cost_est:
                        cost_est = min_val
                        disp_est = float(d)
                out[z, my, mx] = disp_est
    return out


# ---------------------------------------------------------------------------
# Refinement: compute_flatness (clcode.cl:1076-1132)
# ---------------------------------------------------------------------------


def compute_flatness(color: np.ndarray, gamma: float) -> np.ndarray:
    """``color``: (V, Mh, Mw, 3) superpixel colors.  Returns (V, Mh, Mw, 2)."""
    v, mh, mw = color.shape[:3]
    out = np.zeros((v, mh, mw, 2), dtype=np.float64)
    for z in range(v):
        for y in range(mh):
            for x in range(mw):
                c0 = color[z, y, x]
                fl = 1.0
                for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
                    x1, y1 = x + dx, y + dy
                    if 0 <= x1 < mw and 0 <= y1 < mh:
                        c1 = color[z, y1, x1]
                        fl += float(np.sum((c1 - c0) ** 2))
                out[z, y, x, 0] = math.exp(-fl * gamma)
                out[z, y, x, 1] = 1.0 - math.exp(-0.25 * fl * gamma)
    return out


# ---------------------------------------------------------------------------
# Refinement scoring (clcode.cl:1136-1254, 1407-1525, 1260-1357, 1528-1631)
# ---------------------------------------------------------------------------


def smoothness_scalar(
    center, color, tgt_d, fl_x, z, y, x, d0, n0, gamma, alpha, steps, step_size
):
    """Unified scalar smoothness: ``init_smoothness`` (fronto candidate /
    initial disparities) and ``compute_smoothness`` (candidate plane vs the
    state buffer) share this exact math."""
    mh, mw = center.shape[1:3]
    cx, cy = center[z, y, x]
    c0 = color[z, y, x]
    nx, ny, nz = n0
    sm = 0.0
    wn = 0.0
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            if i == 0 and j == 0:
                continue
            x1, y1 = x + i, y + j
            if 0 <= x1 < mw and 0 <= y1 < mh:
                cc = color[z, y1, x1]
                diff = math.sqrt(float(np.sum((cc - c0) ** 2)))
                sim = f32exp(-diff * diff * gamma)
                d_intrp = (
                    nx * (cx - center[z, y1, x1, 0])
                    + ny * (cy - center[z, y1, x1, 1])
                    + nz * d0
                ) / nz
                dd = d_intrp - tgt_d[z, y1, x1]
                sm += sim * f32exp(-dd * dd * alpha)
                wn += sim
    step_sz = max(1, c_int(fl_x * step_size + 0.5))
    for i in range(1, steps + 1):
        gamma_i = gamma * (1 + i)
        step = i * step_sz
        taps = []
        if x > step:
            taps.append((x - step - 1, y))
        if x < mw - step - 1:
            taps.append((x + step + 1, y))
        if y > step:
            taps.append((x, y - step - 1))
        if y < mh - step - 1:
            taps.append((x, y + step + 1))
        for x1, y1 in taps:
            cc = color[z, y1, x1]
            diff = math.sqrt(float(np.sum((cc - c0) ** 2)))
            sim = f32exp(-diff * diff * gamma_i)
            d_extp = (
                nx * (cx - center[z, y1, x1, 0])
                + ny * (cy - center[z, y1, x1, 1])
                + nz * d0
            ) / nz
            dd = d_extp - tgt_d[z, y1, x1]
            sm += sim * f32exp(-dd * dd * alpha)
            wn += sim
    return sm / wn if wn > 0 else 0.000001


def consistency_scalar(
    center, color, tgt_d, tgt_n, labels, samples9, fl_y, view_subset, subset_num,
    z, y, x, d0, n0, gamma, alpha, fuse, bl_ratio, array_width, img_h, img_w,
):
    """Unified scalar consistency (init and candidate-plane forms).

    ``samples9``: (9, 2) int offsets; ``tgt_n`` may be None for the init
    form (fronto-parallel stored planes -> d_intrp_proj == d_proj).
    """
    mh, mw = center.shape[1:3]
    cx, cy = center[z, y, x]
    c0 = color[z, y, x]
    nx, ny, nz = n0
    cam_x, cam_y = z % array_width, z // array_width
    consistency = 0.0
    view_counter = 0
    for k in range(subset_num[z]):
        view = int(view_subset[z, k])
        dvx = view % array_width - cam_x
        dvy = view // array_width - cam_y
        visib_sum = occl_sum = num = visibility = visible = 0.0
        for sidx in range(9):
            sxp = c_int(cx) + int(samples9[sidx, 0])
            syp = c_int(cy) + int(samples9[sidx, 1])
            d_intrp = (nx * (cx - sxp) + ny * (cy - syp) + nz * d0) / nz
            xp = sxp - c_int(cl_round(d_intrp * dvx))
            yp = syp - c_int(cl_round(bl_ratio * d_intrp * dvy))
            if 0 <= xp < img_w and 0 <= yp < img_h:
                idx_proj = int(labels[view, yp, xp])
                pmx, pmy = idx_proj % mw, idx_proj // mw
                d_proj = tgt_d[view, pmy, pmx]
                if tgt_n is None:
                    d_intrp_proj = d_proj
                else:
                    npx, npy, npz = tgt_n[view, pmy, pmx]
                    cpx, cpy = center[view, pmy, pmx]
                    d_intrp_proj = (
                        npx * (cpx - xp) + npy * (cpy - yp) + npz * d_proj
                    ) / npz
                diff = d_intrp_proj - d_intrp
                wv = 1.0 if abs(diff) < fuse else 0.0
                visible += wv * f32exp(-diff * diff * alpha)
                visib_sum += wv
                occl_sum += 1.0 - wv
                cp = color[view, pmy, pmx]
                cd = math.sqrt(float(np.sum((cp - c0) ** 2)))
                visibility += f32exp(-cd * cd * gamma)
                num += 1.0
        if num > 0:
            view_counter += 1
            if visib_sum > 0:
                consistency += (visib_sum / num) * (visibility / visib_sum) * (
                    visible / visib_sum
                )
            if occl_sum > 0:
                consistency += 0.5 * fl_y
    if view_counter > 0:
        return max(0.01, consistency / view_counter)
    return 0.01


def samples9_from_extent(ext8: np.ndarray) -> np.ndarray:
    """Sample offsets from extent slots (clcode.cl:1271-1305): slot order
    [s0,s1,s2,s3,0,s4,s5,s6,s7] over (i,j) row-major, offset=(r*i, r*j)."""
    radii = [ext8[0], ext8[1], ext8[2], ext8[3], 0, ext8[4], ext8[5], ext8[6], ext8[7]]
    out = np.zeros((9, 2), dtype=np.int64)
    idx = 0
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            out[idx] = (radii[idx] * i, radii[idx] * j)
            idx += 1
    return out


def init_state(
    center, color, disp0, labels, extent, fl, view_subset, subset_num,
    gamma, alpha, fuse, bl_ratio, steps, step_size, array_width, img_h, img_w,
):
    """Mirror of ``init_current_state`` (cl:1362-1404): fronto-parallel
    planes scored with the init forms.  Returns dict d, sm, cs, n."""
    v, mh, mw = disp0.shape
    sm = np.zeros((v, mh, mw))
    cs = np.zeros((v, mh, mw))
    for z in range(v):
        for y in range(mh):
            for x in range(mw):
                d = disp0[z, y, x]
                sm[z, y, x] = smoothness_scalar(
                    center, color, disp0, fl[z, y, x, 0], z, y, x, d,
                    (0.0, 0.0, 1.0), gamma, alpha, steps, step_size,
                )
                cs[z, y, x] = consistency_scalar(
                    center, color, disp0, None, labels,
                    samples9_from_extent(extent[z, y, x]), fl[z, y, x, 1],
                    view_subset, subset_num, z, y, x, d, (0.0, 0.0, 1.0),
                    gamma, alpha, fuse, bl_ratio, array_width, img_h, img_w,
                )
    n = np.zeros((v, mh, mw, 3))
    n[..., 2] = 1.0
    return {"d": disp0.astype(np.float64).copy(), "sm": sm, "cs": cs, "n": n}


def _cross3(a, b):
    """Device ``cross_product_test`` (cl:1676-1685)."""
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            b[0] * a[2] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def propagate(
    center, color, state, labels, extent, fl, view_subset, subset_num,
    it, gamma, alpha, fuse, bl_ratio, steps, step_size, array_width, img_h, img_w,
):
    """Mirror of kernel ``propagate`` (cl:1727-1900): one Jacobi sweep.

    ``state``: dict with d, sm, cs, n read-only (the input buffer).
    Returns the output-buffer dict.
    """
    v, mh, mw = state["d"].shape
    out = {
        "d": state["d"].copy(),
        "sm": state["sm"].copy(),
        "cs": state["cs"].copy(),
        "n": state["n"].copy(),
    }
    sd, sn = state["d"], state["n"]

    def score(z, y, x, d_cand, n_cand):
        smv = smoothness_scalar(
            center, color, sd, fl[z, y, x, 0], z, y, x, d_cand, n_cand,
            gamma, alpha, steps, step_size,
        )
        csv = consistency_scalar(
            center, color, sd, sn, labels,
            samples9_from_extent(extent[z, y, x]), fl[z, y, x, 1],
            view_subset, subset_num, z, y, x, d_cand, n_cand,
            gamma, alpha, fuse, bl_ratio, array_width, img_h, img_w,
        )
        return smv, csv

    ring = ((-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1))
    greedy = it < 4
    for z in range(v):
        for y in range(mh):
            for x in range(mw):
                d0 = float(sd[z, y, x])
                sm0 = float(state["sm"][z, y, x])
                cs0 = float(state["cs"][z, y, x])
                n0 = tuple(float(t) for t in sn[z, y, x])
                c0 = color[z, y, x]
                cx, cy = center[z, y, x]

                def try_update(x1, y1):
                    nonlocal d0, sm0, cs0, n0
                    n1 = tuple(float(t) for t in sn[z, y1, x1])
                    d1 = float(sd[z, y1, x1])
                    ccx, ccy = center[z, y1, x1]
                    d_adopt = (
                        n1[0] * (ccx - cx) + n1[1] * (ccy - cy) + n1[2] * d1
                    ) / n1[2]
                    diff = math.sqrt(float(np.sum((c0 - color[z, y1, x1]) ** 2)))
                    sim = f32exp(-diff * diff * gamma)
                    sm1, cs1 = score(z, y, x, d_adopt, n1)
                    if (greedy and sm1 * sim > sm0) or cs1 * sm1 > sm0 * cs0:
                        d0, sm0, cs0, n0 = d_adopt, sm1, cs1, n1

                # 1. immediate neighbors (i = dx outer, j = dy inner)
                for i in (-1, 0, 1):
                    for j in (-1, 0, 1):
                        if i == 0 and j == 0:
                            continue
                        x1, y1 = x + i, y + j
                        if 0 <= x1 < mw and 0 <= y1 < mh:
                            try_update(x1, y1)
                # 2. long-range taps: UP, DOWN, LEFT, RIGHT per reach step
                pitch = c_int(step_size)
                for i in range(1, steps + 1):
                    off = i * pitch
                    if y > off:
                        try_update(x, y - off - 1)
                    if y < mh - off - 1:
                        try_update(x, y + off + 1)
                    if x > off:
                        try_update(x - off - 1, y)
                    if x < mw - off - 1:
                        try_update(x + off + 1, y)
                # 3. spatial refinement over ring pairs
                for r in range(8):
                    x1, y1 = x + ring[r][0], y + ring[r][1]
                    x2, y2 = x + ring[(r + 1) % 8][0], y + ring[(r + 1) % 8][1]
                    if not (0 <= x1 < mw and 0 <= y1 < mh and 0 <= x2 < mw and 0 <= y2 < mh):
                        continue
                    v1 = np.array(
                        [center[z, y1, x1, 0] - cx, center[z, y1, x1, 1] - cy, sd[z, y1, x1] - d0]
                    )
                    v2 = np.array(
                        [center[z, y2, x2, 0] - cx, center[z, y2, x2, 1] - cy, sd[z, y2, x2] - d0]
                    )
                    cr = _cross3(v1, v2)
                    nrm = float(np.linalg.norm(cr))
                    if nrm == 0:
                        continue  # normalize(0) -> NaN -> never accepted
                    n1 = tuple(cr / nrm)
                    sm1, cs1 = score(z, y, x, d0, n1)
                    if (greedy and sm1 > sm0) or sm1 * cs1 > sm0 * cs0:
                        sm0, cs0, n0 = sm1, cs1, n1
                out["d"][z, y, x] = d0
                out["sm"][z, y, x] = sm0
                out["cs"][z, y, x] = cs0
                out["n"][z, y, x] = n0
    return out


# ---------------------------------------------------------------------------
# Fusion (clcode.cl:1906-1931, 1995-2034, 2037-2101)
# ---------------------------------------------------------------------------


def rasterize_planes(labels, center, state_d, state_n):
    """Mirror of ``spixl_to_image``."""
    v, h, w = labels.shape
    mh, mw = center.shape[1:3]
    out = np.zeros((v, h, w))
    for z in range(v):
        for y in range(h):
            for x in range(w):
                idx = int(labels[z, y, x])
                mx, my = idx % mw, idx // mw
                nx, ny, nz = state_n[z, my, mx]
                cx, cy = center[z, my, mx]
                d = state_d[z, my, mx]
                out[z, y, x] = (nx * (cx - x) + ny * (cy - y) + nz * d) / nz
    return out


def project_to_reference_inv(disp_full, array_width, bl_ratio):
    """Mirror of ``project_to_reference_inv`` (clcode.cl:1995-2034): per
    reference pixel, probe every other view at the disparity-shifted
    location with the *evolving* maximum, in view-index order."""
    v, h, w = disp_full.shape
    out = np.empty_like(disp_full)
    for ref in range(v):
        rx, ry = ref % array_width, ref // array_width
        for y in range(h):
            for x in range(w):
                min_disp = disp_full[ref, y, x]
                for i in range(v):
                    if i == ref:
                        continue
                    cx, cy = i % array_width, i // array_width
                    xp = int(x - cl_round(min_disp * (rx - cx)))
                    yp = int(y - cl_round(bl_ratio * min_disp * (ry - cy)))
                    if 0 <= xp < w and 0 <= yp < h:
                        cur = disp_full[i, yp, xp]
                        if min_disp < cur:
                            min_disp = cur
                out[ref, y, x] = min_disp
    return out


def remove_view_inconsistency(disp_proj, disp_full, array_width, bl_ratio, fuse):
    """Mirror of ``remove_view_inconsistency`` (clcode.cl:2037-2101): the
    cross-view stability vote, largest stable disparity wins."""
    v, h, w = disp_proj.shape
    out = np.zeros_like(disp_proj)
    for ref in range(v):
        rx, ry = ref % array_width, ref // array_width
        for y in range(h):
            for x in range(w):
                d_est = 0.0
                for i in range(v):
                    d = disp_proj[i, y, x]
                    if d == 0:
                        continue
                    stability = 0.0
                    for j in range(v):
                        d_check = disp_proj[j, y, x]
                        if d_check != 0:
                            stability += 1.0 if abs(d_check - d) <= fuse else -1.0
                    for j in range(v):
                        cx, cy = j % array_width, j // array_width
                        xj = int(x - cl_round(d * (cx - rx)))
                        yj = int(y - cl_round(bl_ratio * d * (cy - ry)))
                        if 0 <= xj < w and 0 <= yj < h:
                            diff = abs(disp_full[j, yj, xj] - d)
                            if diff > fuse:
                                stability -= 1.0
                            elif diff < fuse:
                                stability += 1.0
                    if stability >= 0 and (d_est == 0 or d_est < d):
                        d_est = d
                out[ref, y, x] = d_est
    return out
