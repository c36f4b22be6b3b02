"""Obstacle operators on dense tensors: the counterpart of
``cup2d_tpu.ops.obstacle`` for the uniform step.

Every cell of a fixed-size window around a body gathers its signed
distance to the body's closed surface polygon and its deformation velocity
from the nearest midline node (a dense [cells x edges] computation with
min/argmin reductions), in place of the reference's scatter into 6x6 cell
neighbourhoods (main.cpp:4271-4463 PutFishOnBlocks, 3911-3969
PutChiOnGrid, 4488-4630 the integrals and the udef de-meaning). The sign
is the polygon's crossing parity, positive inside.

The JAX package computes all of this as XLA code outside its Pallas
kernels, so the port writes it as plain PyTorch: the same expressions in
the same order, reduced in the field dtype. Window origins are host ints
(``Simulation._shape_inputs`` clips them into the grid), so the window
scatters are slices; like ``lax.dynamic_slice`` they clamp an origin that
would put the window past the edge (after wrapping a negative one).

The forest evaluates the same geometry on host-packed tables
(``pack_polygon_segments``: one [E, 6] row per polygon edge;
``pack_midline``: one [Nm, 9] row per midline node), built in f64 numpy
with the CoM already subtracted, then cast to the field dtype:
``polygon_sdf_seg`` and ``midline_udef_packed`` read them on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .stencil import shift

_EPS = 2.220446049250313e-16  # reference EPS (f64 machine eps, main.cpp:27)


def polygon_sdf(px, py, poly):
    """Signed distance of points (px, py) [...] to the closed polygon
    ``poly`` [E, 2], positive inside. Points and polygon should share a
    local origin for f32 accuracy (the caller subtracts the window
    centre)."""
    ax, ay = poly[:, 0], poly[:, 1]
    bx, by = torch.roll(poly[:, 0], -1), torch.roll(poly[:, 1], -1)
    ex, ey = bx - ax, by - ay
    elen2 = ex * ex + ey * ey

    pax = px[..., None] - ax
    pay = py[..., None] - ay
    t = torch.clamp((pax * ex + pay * ey) / (elen2 + _EPS), 0.0, 1.0)
    dx = pax - t * ex
    dy = pay - t * ey
    d2 = torch.amin(dx * dx + dy * dy, dim=-1)

    # crossing-parity inside test (+x ray)
    cond = (ay > py[..., None]) != (by > py[..., None])
    xint = ax + (py[..., None] - ay) * ex / torch.where(ey == 0, 1.0, ey)
    crossings = torch.sum(cond & (px[..., None] < xint), dim=-1)
    inside = (crossings % 2) == 1
    d = torch.sqrt(d2)
    return torch.where(inside, d, -d)


def pack_polygon_segments(poly: np.ndarray) -> np.ndarray:
    """polygon_sdf's per-edge quantities of the closed polygon ``poly``
    [E, 2] as one [E, 6] table (ax, ay, ex, ey, 1/(|e|^2 + eps),
    1/ey with ey = 0 read as 1). numpy f64 in and out; the caller casts
    to the field dtype."""
    ax, ay = poly[:, 0], poly[:, 1]
    bx = np.roll(poly[:, 0], -1)
    by = np.roll(poly[:, 1], -1)
    ex, ey = bx - ax, by - ay
    elen2 = ex * ex + ey * ey
    inv_l2 = 1.0 / (elen2 + _EPS)
    inv_ey = 1.0 / np.where(ey == 0, 1.0, ey)
    return np.stack([ax, ay, ex, ey, inv_l2, inv_ey], axis=1)


def polygon_sdf_seg(px, py, seg):
    """polygon_sdf on a packed segment table (``pack_polygon_segments``):
    the same geometry and sign, the divisions replaced by the packed
    reciprocals. px, py [...]; seg [E, 6]; returns [...]."""
    ax, ay = seg[:, 0], seg[:, 1]
    ex, ey = seg[:, 2], seg[:, 3]
    inv_l2, inv_ey = seg[:, 4], seg[:, 5]
    pax = px[..., None] - ax
    pay = py[..., None] - ay
    t = torch.clamp((pax * ex + pay * ey) * inv_l2, 0.0, 1.0)
    dx = pax - t * ex
    dy = pay - t * ey
    d2 = torch.amin(dx * dx + dy * dy, dim=-1)
    cond = (ay > py[..., None]) != ((ay + ey) > py[..., None])
    xint = ax + (py[..., None] - ay) * ex * inv_ey
    crossings = torch.sum(cond & (px[..., None] < xint), dim=-1)
    inside = (crossings % 2) == 1
    d = torch.sqrt(d2)
    return torch.where(inside, d, -d)


def pack_midline(mid_r, mid_v, mid_nor, mid_vnor, width) -> np.ndarray:
    """The midline's per-node fields as one [Nm, 9] table (rx, ry, vx, vy,
    nx, ny, vnx, vny, width), so that the nearest-node lookup is one
    gather. numpy in and out."""
    return np.concatenate([
        np.asarray(mid_r), np.asarray(mid_v), np.asarray(mid_nor),
        np.asarray(mid_vnor), np.asarray(width)[:, None]], axis=1)


def midline_udef_packed(px, py, mid):
    """midline_udef on a packed [Nm, 9] node table (``pack_midline``): the
    nearest node (the first on a tie, as ``jnp.argmin``), then one
    gather. Returns [2, ...]."""
    dx = px[..., None] - mid[:, 0]
    dy = py[..., None] - mid[:, 1]
    i = torch.argmin(dx * dx + dy * dy, dim=-1)
    m = mid[i]                                   # [..., 9]
    w = torch.minimum(torch.maximum((px - m[..., 0]) * m[..., 4]
                                    + (py - m[..., 1]) * m[..., 5],
                                    -m[..., 8]), m[..., 8])
    ux = m[..., 2] + w * m[..., 6]
    uy = m[..., 3] + w * m[..., 7]
    return torch.stack([ux, uy], dim=0)


def midline_udef(px, py, mid_r, mid_v, mid_nor, mid_vnor, width):
    """Deformation velocity at points (px, py): the nearest midline node
    i* (the first one on a tie, as ``jnp.argmin``), the normal offset
    w = clamp(<p - r_i*, n_i*>, +-width_i*), udef = v_i* + w vn_i*
    (main.cpp:4326-4330 surface, 4403-4437 interior). Returns [2, ...]."""
    dx = px[..., None] - mid_r[:, 0]
    dy = py[..., None] - mid_r[:, 1]
    i = torch.argmin(dx * dx + dy * dy, dim=-1)
    rx = mid_r[i, 0]
    ry = mid_r[i, 1]
    nx = mid_nor[i, 0]
    ny = mid_nor[i, 1]
    wi = width[i]
    w = torch.minimum(torch.maximum((px - rx) * nx + (py - ry) * ny, -wi),
                      wi)
    ux = mid_v[i, 0] + w * mid_vnor[i, 0]
    uy = mid_v[i, 1] + w * mid_vnor[i, 1]
    return torch.stack([ux, uy], dim=0)


def chi_from_sdf(sdf_lab, dist_own, h):
    """The reference's PutChiOnGrid (main.cpp:3938-3958): 0/1 deeper than
    +-h, and in the band the regularized gradient ratio
    <grad max(0, d), grad d> / |grad d|^2 on the COMBINED sdf, so that
    overlapping bodies interact through it.

    sdf_lab: [wy+2, wx+2] combined sdf with one ghost; dist_own: [wy, wx]
    this shape's own sdf; returns chi [wy, wx]."""
    sp_x = shift(sdf_lab, 1, 0, 1)
    sm_x = shift(sdf_lab, 1, 0, -1)
    sp_y = shift(sdf_lab, 1, 1, 0)
    sm_y = shift(sdf_lab, 1, -1, 0)
    grad_ix = torch.clamp_min(sp_x, 0.0) - torch.clamp_min(sm_x, 0.0)
    grad_iy = torch.clamp_min(sp_y, 0.0) - torch.clamp_min(sm_y, 0.0)
    grad_ux = sp_x - sm_x
    grad_uy = sp_y - sm_y
    grad_usq = grad_ux * grad_ux + grad_uy * grad_uy + _EPS
    ratio = (grad_ix * grad_ux + grad_iy * grad_uy) / grad_usq
    return torch.where(dist_own > h, 1.0,
                       torch.where(dist_own < -h, 0.0, ratio))


def window_coords(ox: int, oy: int, wx: int, wy: int, h, dtype, device):
    """Cell-centre coordinates of the wx x wy window whose lower-left cell
    is (ox, oy): x[j, i] and y[j, i], each [wy, wx]."""
    x = (torch.arange(ox, ox + wx, dtype=torch.float64, device=device)
         + 0.5).to(dtype) * h
    y = (torch.arange(oy, oy + wy, dtype=torch.float64, device=device)
         + 0.5).to(dtype) * h
    return x[None, :].expand(wy, wx), y[:, None].expand(wy, wx)


def _origin(field, wy: int, wx: int, oy: int, ox: int):
    """The origin of a wy x wx window in ``field`` as ``lax.dynamic_slice``
    takes it: a negative index counts from the end, then the origin is
    clamped so that the window fits."""
    ny, nx = field.shape[-2:]
    oy, ox = int(oy), int(ox)
    oy, ox = oy + ny if oy < 0 else oy, ox + nx if ox < 0 else ox
    return min(max(oy, 0), ny - wy), min(max(ox, 0), nx - wx)


def window_of(field, wy: int, wx: int, oy: int, ox: int):
    """The [..., wy, wx] view of ``field`` at (oy, ox), clamped to fit."""
    oy, ox = _origin(field, wy, wx, oy, ox)
    return field[..., oy:oy + wy, ox:ox + wx]


def scatter_window_max(field, win, oy: int, ox: int):
    """field[oy:oy+wy, ox:ox+wx] = max(field slice, win), in place (the
    reference's max-combining of dist and chi across shapes); returns
    ``field``."""
    cur = window_of(field, *win.shape[-2:], oy, ox)
    cur.copy_(torch.maximum(cur, win))
    return field


def scatter_window_set(field, win, oy: int, ox: int):
    """Write the [..., wy, wx] window into [..., Ny, Nx] ``field`` at
    (oy, ox), in place; returns ``field``."""
    window_of(field, *win.shape[-2:], oy, ox).copy_(win)
    return field


def shape_integrals(chi, udef, xrel, yrel, hsq):
    """The 7 penalization-frame integrals (main.cpp:4489-4533): (x, y, m,
    j, u, v, a), with u, v and a already normalized by m, m and j.
    xrel/yrel are cell centres minus the CoM. 0-dim tensors."""
    w = chi * hsq
    m = torch.sum(w)
    x = torch.sum(w * xrel)
    y = torch.sum(w * yrel)
    j = torch.sum(w * (xrel * xrel + yrel * yrel))
    u = torch.sum(w * udef[0])
    v = torch.sum(w * udef[1])
    a = torch.sum(w * (xrel * udef[1] - yrel * udef[0]))
    # a body thinner than a cell can have zero chi mass: zero mean motion
    # rather than NaN in every field downstream
    u = torch.where(m > 0, u / (m + _EPS), 0.0)
    v = torch.where(m > 0, v / (m + _EPS), 0.0)
    a = torch.where(j > 0, a / (j + _EPS), 0.0)
    return x, y, m, j, u, v, a


def penalization_integrals(vel, chi, udef, xrel, yrel, lamdt, hsq):
    """The 7 sums of the rigid-momentum system (main.cpp:6647-6692):
    F = h^2 Xlamdt / (1 + Xlamdt), Xlamdt = lambda dt where chi >= 0.5.
    Returns (PM, PJ, PX, PY, UM, VM, AM), 0-dim tensors."""
    xlamdt = torch.where(chi >= 0.5, lamdt, 0.0)
    f = hsq * xlamdt / (1.0 + xlamdt)
    udx = vel[0] - udef[0]
    udy = vel[1] - udef[1]
    pm = torch.sum(f)
    pj = torch.sum(f * (xrel * xrel + yrel * yrel))
    px = torch.sum(f * xrel)
    py = torch.sum(f * yrel)
    um = torch.sum(f * udx)
    vm = torch.sum(f * udy)
    am = torch.sum(f * (xrel * udy - yrel * udx))
    return pm, pj, px, py, um, vm, am


def solve_rigid_momentum(pm, pj, px, py, um, vm, am):
    """Solve [[PM, 0, -PY], [0, PM, PX], [-PY, PX, PJ]] (u, v, w) =
    (UM, VM, AM) (main.cpp:6691-6703) in closed form, normalized by PM:
    the matrix is then [[1, 0, a], [0, 1, b], [a, b, c]], whose Schur
    complement is the scalar c - a^2 - b^2. Returns [3]; zero for a body
    with no penalized cells."""
    s = 1.0 / (pm + _EPS)
    a = -py * s
    b = px * s
    # the ridge keeps the omega row regular when PM = PJ = 0
    c = pj * s + 1e-30
    r0, r1, r2 = um * s, vm * s, am * s
    w = (r2 - a * r0 - b * r1) / (c - a * a - b * b + _EPS)
    sol = torch.stack([r0 - a * w, r1 - b * w, w])
    return torch.where(pm > 0, sol, torch.zeros_like(sol))
