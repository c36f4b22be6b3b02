"""Stencil operator library: the physics operators as plain PyTorch
functions over whole tensors, the counterpart of ``cup2d_tpu.ops.stencil``.

Array convention (as in the JAX package): fields padded with ``g`` ghost
cells on each side of the last two axes are ``[..., Ny + 2g, Nx + 2g]``;
operators return interior tensors ``[..., Ny, Nx]``. Axis -2 is y, axis
-1 is x, and velocity carries a component axis of size 2 (u, v) just
before them. Every operator is leading-dim agnostic. Differences are
"undivided" (no 1/h) where the reference uses them.

Association order follows the JAX functions term for term, so the f64
results agree to rounding and the f32 WENO path keeps the bit-trick
reciprocal. The free-slip ghost paint (``pad_scalar``/``pad_vector``)
lives here too, because the plain twin of the substage kernel
(``hopper_kernels``) needs it; ``uniform`` re-exports it where the JAX
package defines it.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def dt_from_umax(umax, h, nu, cfl):
    """CFL/diffusive timestep (main.cpp:6579-6595):
    min(0.25 h^2/(nu + 0.25 h umax), cfl h/(umax + 1e-8))."""
    dt_diff = 0.25 * h * h / (nu + 0.25 * h * umax)
    return torch.minimum(dt_diff, cfl * h / (umax + 1e-8))


def shift(lab: torch.Tensor, g: int, dy: int, dx: int) -> torch.Tensor:
    """Interior view displaced by (dy, dx); |dy|,|dx| <= g."""
    ny = lab.shape[-2] - 2 * g
    nx = lab.shape[-1] - 2 * g
    return lab[..., g + dy:g + dy + ny, g + dx:g + dx + nx]


# ---------------------------------------------------------------------------
# Free-slip ghost paint (uniform.py:66-97 of the JAX package)
# ---------------------------------------------------------------------------

def pad_scalar(p: torch.Tensor, g: int) -> torch.Tensor:
    """[..., Ny, Nx] -> [..., Ny+2g, Nx+2g], zero-Neumann copy of the
    wall-adjacent cell (edge-mode pad)."""
    top = p[..., :1, :].expand(*p.shape[:-2], g, p.shape[-1])
    bot = p[..., -1:, :].expand(*p.shape[:-2], g, p.shape[-1])
    q = torch.cat([top, p, bot], dim=-2)
    left = q[..., :, :1].expand(*q.shape[:-1], g)
    right = q[..., :, -1:].expand(*q.shape[:-1], g)
    return torch.cat([left, q, right], dim=-1)


def pad_vector(v: torch.Tensor, g: int) -> torch.Tensor:
    """[..., 2, Ny, Nx] -> [..., 2, Ny+2g, Nx+2g], free-slip mirror
    (zeroth order, like the reference): every y-ghost row equals the edge
    row with v negated; x-ghost columns then copy the y-completed edge
    column with u negated, so a corner is (-u, -v) of the corner cell.
    The whole field is the slab that owns both walls."""
    return pad_vector_slab(v, v.new_zeros(v.shape[:-1] + (2 * g,)), g,
                           True, True)


def pad_vector_slab(v: torch.Tensor, aux: torch.Tensor, g: int,
                    is_lo: bool, is_hi: bool) -> torch.Tensor:
    """``pad_vector`` on one x slab [..., 2, Ny, w] of a split field: aux
    [..., 2, Ny, 2g] holds the g columns left of the slab ([..., :g], the
    left neighbour's last) and the g right of it ([..., g:]). The y ghost
    rows are painted over those columns too, as the neighbour paints them;
    the x ghosts are painted only on the sides the slab owns, over the
    y-completed edge column. Every value is the one ``pad_vector`` of the
    whole field puts at the same place."""
    ext = torch.cat([aux[..., :g], v, aux[..., g:]], dim=-1)
    out = F.pad(ext, (0, 0, g, g))
    out[..., 0:1, :g, :] = ext[..., 0:1, :1, :]
    out[..., 1:2, :g, :] = -ext[..., 1:2, :1, :]
    out[..., 0:1, -g:, :] = ext[..., 0:1, -1:, :]
    out[..., 1:2, -g:, :] = -ext[..., 1:2, -1:, :]
    if is_lo:
        out[..., 0:1, :, :g] = -out[..., 0:1, :, g:g + 1]
        out[..., 1:2, :, :g] = out[..., 1:2, :, g:g + 1]
    if is_hi:
        out[..., 0:1, :, -g:] = -out[..., 0:1, :, -g - 1:-g]
        out[..., 1:2, :, -g:] = out[..., 1:2, :, -g - 1:-g]
    return out


# ---------------------------------------------------------------------------
# WENO5 (reference main.cpp:162-208)
# ---------------------------------------------------------------------------

_WENO_EPS = 1e-6
_WENO_TINY = 1e-35
_RCP_MAGIC = 0x7EF311C3


def _sq(x):
    return x * x


def _weno5_weights(b1, b2, b3, g1, g2, g3):
    """Max-normalized weights: the r_i = (b_i + eps)/b_max live in (0, 1],
    so the cross products cannot overflow. In f32 the normalizer is the
    bit-trick approximate reciprocal (the weights are exactly invariant
    to a common factor in the r_i); f64 keeps the exact divide."""
    bmax = torch.maximum(torch.maximum(b1, b2), b3) + _WENO_EPS
    if bmax.dtype == torch.float32:
        m = (_RCP_MAGIC - bmax.view(torch.int32)).view(torch.float32)
    else:
        m = 1.0 / bmax
    r1 = (b1 + _WENO_EPS) * m
    r2 = (b2 + _WENO_EPS) * m
    r3 = (b3 + _WENO_EPS) * m
    s1, s2, s3 = r1 * r1, r2 * r2, r3 * r3
    n1 = g1 * (s2 * s3)
    n2 = g2 * (s1 * s3)
    n3 = g3 * (s1 * s2)
    den = (n1 + n3) + n2
    ok = den > _WENO_TINY
    aux = 1.0 / torch.where(ok, den, torch.ones_like(den))
    w1 = torch.where(ok, n1 * aux, torch.full_like(den, g1))
    w2 = torch.where(ok, n2 * aux, torch.full_like(den, g2))
    w3 = torch.where(ok, n3 * aux, torch.full_like(den, g3))
    return w1, w2, w3


def _smoothness(um2, um1, u, up1, up2):
    b1 = (13.0 / 12.0 * _sq((um2 + u) - 2 * um1)
          + 0.25 * _sq((um2 + 3 * u) - 4 * um1))
    b2 = 13.0 / 12.0 * _sq((um1 + up1) - 2 * u) + 0.25 * _sq(um1 - up1)
    b3 = (13.0 / 12.0 * _sq((u + up2) - 2 * up1)
          + 0.25 * _sq((3 * u + up2) - 4 * up1))
    return b1, b2, b3


def weno5_plus(um2, um1, u, up1, up2):
    """Upwind-biased flux reconstruction, wind > 0 (main.cpp:162-180)."""
    b1, b2, b3 = _smoothness(um2, um1, u, up1, up2)
    w1, w2, w3 = _weno5_weights(b1, b2, b3, 0.1, 0.6, 0.3)
    f1 = (11.0 / 6.0) * u + ((1.0 / 3.0) * um2 - (7.0 / 6.0) * um1)
    f2 = (5.0 / 6.0) * u + ((-1.0 / 6.0) * um1 + (1.0 / 3.0) * up1)
    f3 = (1.0 / 3.0) * u + ((5.0 / 6.0) * up1 - (1.0 / 6.0) * up2)
    return (w1 * f1 + w3 * f3) + w2 * f2


def weno5_minus(um2, um1, u, up1, up2):
    """Upwind-biased flux reconstruction, wind < 0 (main.cpp:181-201)."""
    b1, b2, b3 = _smoothness(um2, um1, u, up1, up2)
    w1, w2, w3 = _weno5_weights(b1, b2, b3, 0.3, 0.6, 0.1)
    f1 = (1.0 / 3.0) * u + ((-1.0 / 6.0) * um2 + (5.0 / 6.0) * um1)
    f2 = (5.0 / 6.0) * u + ((1.0 / 3.0) * um1 - (1.0 / 6.0) * up1)
    f3 = (11.0 / 6.0) * u + ((-7.0 / 6.0) * up1 + (1.0 / 3.0) * up2)
    return (w1 * f1 + w3 * f3) + w2 * f2


def weno_derivative(wind, um3, um2, um1, u, up1, up2, up3):
    """Undivided upwind WENO5 derivative (main.cpp:202-208). Uses the
    mirror identity weno5_minus(a,b,c,d,e) == weno5_plus(e,d,c,b,a):
    the stencil arguments are selected by wind sign first, so only two
    reconstructions run. The test is strict: wind == 0 takes the minus
    branch."""
    pos = wind > 0

    def sel(a, b):
        return torch.where(pos, a, b)

    t1 = weno5_plus(sel(um2, up3), sel(um1, up2), sel(u, up1),
                    sel(up1, u), sel(up2, um1))
    t2 = weno5_plus(sel(um3, up2), sel(um2, up1), sel(um1, u),
                    sel(u, um1), sel(up1, um2))
    return t1 - t2


# ---------------------------------------------------------------------------
# Advection-diffusion RHS (KernelAdvectDiffuse, main.cpp:5441-5503)
# ---------------------------------------------------------------------------

def advect_diffuse_rhs(vlab: torch.Tensor, g: int, h, nu, dt):
    """RHS in the reference's block scaling, ``afac*(u·∇)u + dfac*lap(u)``
    with afac = -dt*h, dfac = nu*dt. vlab: [..., 2, Ny+2g, Nx+2g], g >= 3;
    returns [..., 2, Ny, Nx]."""
    return advect_diffuse_core(vlab, g, -dt * h, nu * dt)


def advect_diffuse_core(vlab: torch.Tensor, g: int, afac, dfac):
    """Same with the scale factors precomputed (scalars, or tensors that
    broadcast against [..., 2, Ny, Nx] for per-member factors)."""
    if g < 3:
        raise ValueError(f"WENO5 needs g >= 3 ghost cells, got {g}")
    u = shift(vlab, g, 0, 0)
    wind_u = u[..., 0:1, :, :]
    wind_v = u[..., 1:2, :, :]
    dx = weno_derivative(
        wind_u,
        shift(vlab, g, 0, -3), shift(vlab, g, 0, -2), shift(vlab, g, 0, -1),
        u,
        shift(vlab, g, 0, 1), shift(vlab, g, 0, 2), shift(vlab, g, 0, 3),
    )
    dy = weno_derivative(
        wind_v,
        shift(vlab, g, -3, 0), shift(vlab, g, -2, 0), shift(vlab, g, -1, 0),
        u,
        shift(vlab, g, 1, 0), shift(vlab, g, 2, 0), shift(vlab, g, 3, 0),
    )
    lap = (
        shift(vlab, g, 0, 1) + shift(vlab, g, 0, -1)
        + shift(vlab, g, 1, 0) + shift(vlab, g, -1, 0)
        - 4.0 * u
    )
    return afac * (wind_u * dx + wind_v * dy) + dfac * lap


def heun_substage(vold, cfac, rhs, ih2):
    """One Heun stage update ``vold + cfac * rhs * ih2``."""
    return vold + cfac * rhs * ih2


# ---------------------------------------------------------------------------
# Fused-BC forms of the linear operators: zero-ghost shifts plus a rank-1
# edge correction, on unpadded fields
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _edge_ones(n: int, dtype, device, lo=1.0, hi=1.0) -> torch.Tensor:
    """Length-n line that is ``lo`` at index 0, ``hi`` at n-1, else 0.
    Memoized per (n, dtype, device, lo, hi), and never written to by its
    callers: building it on every operator call cost the multigrid cycle
    thousands of tiny launches per step on the card."""
    i = torch.arange(n, device=device)
    return torch.where(i == 0, lo, torch.where(i == n - 1, hi, 0.0)).to(
        dtype)


def _zshift(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[j, i] = p[j + dy, i + dx], zero outside (|dy|, |dx| <= 1)."""
    ny, nx = p.shape[-2], p.shape[-1]
    out = torch.zeros_like(p)
    out[..., max(-dy, 0):ny - max(dy, 0), max(-dx, 0):nx - max(dx, 0)] = \
        p[..., max(dy, 0):ny + min(dy, 0), max(dx, 0):nx + min(dx, 0)]
    return out


@functools.lru_cache(maxsize=256)
def _slab_edge_ones(n: int, dtype, device, lo=0.0, hi=0.0) -> torch.Tensor:
    """The edge line of an x slab: ``lo`` at index 0, ``hi`` at n-1, else
    0; a slab that owns no wall on a side passes 0 for it (a one-column
    slab owning one wall gets that wall's value). Memoized like
    ``_edge_ones``, whose values it equals on a slab that owns both walls
    and is at least two columns wide."""
    i = torch.arange(n, device=device)
    return (torch.where(i == 0, lo, 0.0)
            + torch.where(i == n - 1, hi, 0.0)).to(dtype)


def _halo_x(p: torch.Tensor, aux: torch.Tensor):
    """(xp, xm) of a slab p [..., Ny, w]: the field shifted by one column
    either way, the missing column taken from aux [..., Ny, 2] (the
    columns right of the slab in aux[..., 1], left of it in aux[..., 0])."""
    xp = torch.cat([p[..., 1:], aux[..., 1:2]], dim=-1)
    xm = torch.cat([aux[..., 0:1], p[..., :-1]], dim=-1)
    return xp, xm


# the all-Neumann pressure signs and the free-slip divergence coefficients
# (bc.pressure_signs, bc.divergence_coeffs of the free-slip table)
NEUMANN_SIGNS = (1.0, 1.0, 1.0, 1.0)
FREE_SLIP_COEFFS = (1.0, -1.0, 1.0, -1.0)


def laplacian5_neumann(p: torch.Tensor) -> torch.Tensor:
    """Undivided 5-point Laplacian with zero-Neumann walls on an unpadded
    [..., Ny, Nx] field."""
    ny, nx = p.shape[-2], p.shape[-1]
    ex = _edge_ones(nx, p.dtype, p.device)
    ey = _edge_ones(ny, p.dtype, p.device)
    return (
        _zshift(p, 0, 1) + _zshift(p, 0, -1)
        + _zshift(p, 1, 0) + _zshift(p, -1, 0)
        + p * ((ey[:, None] + ex[None, :]) - 4.0)
    )


def inv_diag_neumann(ny: int, nx: int, dtype, device) -> torch.Tensor:
    """1/(-4 + wall-side count): the Jacobi diagonal of
    ``laplacian5_neumann`` as a [Ny, Nx] field (the slab that owns both
    walls), memoized like ``_edge_ones`` (one per multigrid level and
    dtype)."""
    return inv_diag_bc_slab(ny, nx, dtype, device, NEUMANN_SIGNS, True,
                            True)


def _slab_signs(signs, is_lo: bool, is_hi: bool):
    """A table's per-face values (x_lo, x_hi, y_lo, y_hi) as one x slab
    sees them: the x faces only on the sides the slab owns, 0 elsewhere."""
    x_lo, x_hi, y_lo, y_hi = (float(s) for s in signs)
    return (x_lo if is_lo else 0.0, x_hi if is_hi else 0.0, y_lo, y_hi)


def laplacian5_bc_slab(p: torch.Tensor, aux: torch.Tensor, signs,
                       is_lo: bool, is_hi: bool,
                       py: bool = False) -> torch.Tensor:
    """``laplacian5_bc`` on one x slab [..., Ny, w] of a split field:
    aux [..., Ny, 2] holds the neighbours' edge columns (zeros at a wall;
    along a periodic x the ring's, and the slab owns no wall); ``signs`` =
    (sx_lo, sx_hi, sy_lo, sy_hi), the y signs on every slab, the x signs
    only on the sides the slab owns; ``py`` (a periodic y, signs 0 there)
    wraps the y shifts inside the slab. Terms in the whole-field order, so
    a split field's slabs give its Laplacian bit for bit."""
    ny, w = p.shape[-2], p.shape[-1]
    sx_lo, sx_hi, sy_lo, sy_hi = _slab_signs(signs, is_lo, is_hi)
    ex = _slab_edge_ones(w, p.dtype, p.device, sx_lo, sx_hi)
    ey = _edge_ones(ny, p.dtype, p.device, lo=sy_lo, hi=sy_hi)
    xp, xm = _halo_x(p, aux)
    return (
        xp + xm
        + _shift_bc(p, 1, 0, False, py) + _shift_bc(p, -1, 0, False, py)
        + p * ((ey[:, None] + ex[None, :]) - 4.0)
    )


@functools.lru_cache(maxsize=256)
def inv_diag_bc_slab(ny: int, w: int, dtype, device, signs, is_lo: bool,
                     is_hi: bool) -> torch.Tensor:
    """``inv_diag_bc`` of one x slab: the x-wall signs only on the sides
    the slab owns."""
    sx_lo, sx_hi, sy_lo, sy_hi = _slab_signs(signs, is_lo, is_hi)
    ex = _slab_edge_ones(w, dtype, device, sx_lo, sx_hi)
    ey = _edge_ones(ny, dtype, device, lo=sy_lo, hi=sy_hi)
    return 1.0 / (ey[:, None] + ex[None, :] - 4.0)


def divergence_freeslip(v: torch.Tensor) -> torch.Tensor:
    """Undivided central divergence with free-slip mirror walls, unpadded
    [..., 2, Ny, Nx] input: the mirrored normal component adds +u at the
    low wall and -u at the high wall."""
    u = v[..., 0, :, :]
    w = v[..., 1, :, :]
    ny, nx = u.shape[-2], u.shape[-1]
    gx = _edge_ones(nx, v.dtype, v.device, lo=1.0, hi=-1.0)
    gy = _edge_ones(ny, v.dtype, v.device, lo=1.0, hi=-1.0)
    return (
        _zshift(u, 0, 1) - _zshift(u, 0, -1)
        + u * gx[None, :]
        + _zshift(w, 1, 0) - _zshift(w, -1, 0)
        + w * gy[:, None]
    )


def divergence_bc_slab(v: torch.Tensor, aux: torch.Tensor, coeffs,
                       is_lo: bool, is_hi: bool,
                       py: bool = False) -> torch.Tensor:
    """``divergence_bc`` on one x slab [..., 2, Ny, w]: aux [..., 2, Ny, 2]
    holds the neighbours' edge columns (only u's are read); ``coeffs`` =
    (cx_lo, cx_hi, cy_lo, cy_hi) (bc.divergence_coeffs), the x ones only
    on the sides the slab owns; ``py`` wraps the y shifts. Terms in the
    whole-field order."""
    u = v[..., 0, :, :]
    w = v[..., 1, :, :]
    ny, nxl = u.shape[-2], u.shape[-1]
    cx_lo, cx_hi, cy_lo, cy_hi = _slab_signs(coeffs, is_lo, is_hi)
    gx = _slab_edge_ones(nxl, v.dtype, v.device, cx_lo, cx_hi)
    gy = _edge_ones(ny, v.dtype, v.device, lo=cy_lo, hi=cy_hi)
    xp, xm = _halo_x(u, aux[..., 0, :, :])
    return (
        xp - xm
        + u * gx[None, :]
        + _shift_bc(w, 1, 0, False, py) - _shift_bc(w, -1, 0, False, py)
        + w * gy[:, None]
    )


def divergence_rhs_fused(v, udef, chi, h, dt):
    """Pressure RHS (h/2dt)[div(u*) - chi div(u_def)], unpadded inputs."""
    fac = 0.5 * h / dt
    return (fac * divergence_freeslip(v)
            - (fac * chi) * divergence_freeslip(udef))


def pressure_gradient_update_fused(p: torch.Tensor, h, dt) -> torch.Tensor:
    """h^2-scaled velocity increment -(dt h / 2) grad p with Neumann
    ghosts (one-sided differences at the walls), unpadded input."""
    ny, nx = p.shape[-2], p.shape[-1]
    gx = _edge_ones(nx, p.dtype, p.device, lo=-1.0, hi=1.0)
    gy = _edge_ones(ny, p.dtype, p.device, lo=-1.0, hi=1.0)
    pfac = -0.5 * dt * h
    dpx = (_zshift(p, 0, 1) - _zshift(p, 0, -1)) + p * gx[None, :]
    dpy = (_zshift(p, 1, 0) - _zshift(p, -1, 0)) + p * gy[:, None]
    return pfac * torch.stack([dpx, dpy], dim=-3)


def pressure_gradient_slab(p: torch.Tensor, aux: torch.Tensor,
                           is_lo: bool, is_hi: bool,
                           grad_signs=None, py: bool = False) -> torch.Tensor:
    """The undivided gradient (dpx, dpy) [..., 2, Ny, w] of one x slab of
    the pressure, as ``pressure_gradient_update_fused`` (Neumann) or, with
    a table's ``grad_signs`` (sx_lo, sx_hi, sy_lo, sy_hi),
    ``pressure_gradient_update_bc`` and the correction epilogue form it
    before scaling: aux [..., Ny, 2] holds the neighbours' edge columns;
    the one-sided wall terms (-s at a low wall, +s at a high one) apply in
    x only on the sides the slab owns; ``py`` wraps the y shifts."""
    ny, w = p.shape[-2], p.shape[-1]
    sx_lo, sx_hi, sy_lo, sy_hi = _slab_signs(grad_signs or NEUMANN_SIGNS,
                                             is_lo, is_hi)
    gx = _slab_edge_ones(w, p.dtype, p.device, -sx_lo if is_lo else 0.0,
                         sx_hi)
    gy = _edge_ones(ny, p.dtype, p.device, lo=-sy_lo, hi=sy_hi)
    xp, xm = _halo_x(p, aux)
    dpx = (xp - xm) + p * gx[None, :]
    dpy = ((_shift_bc(p, 1, 0, False, py) - _shift_bc(p, -1, 0, False, py))
           + p * gy[:, None])
    return torch.stack([dpx, dpy], dim=-3)


# ---------------------------------------------------------------------------
# Per-face forms of the fused-BC operators (bc.py): the same zero-ghost
# shifts and rank-1 edge terms with the table's edge coefficients
# (bc.pressure_signs, bc.divergence_coeffs). ``px``/``py`` (bc.periodic_axes)
# make the shifts along a periodic axis wrap; their coefficients are 0.
# All-Neumann coefficients give the free-slip forms above bit for bit.
# ---------------------------------------------------------------------------

def _shift_bc(p: torch.Tensor, dy: int, dx: int, px: bool,
              py: bool) -> torch.Tensor:
    """Unit shift, wrapped along a periodic axis, zero-ghost otherwise."""
    if (dx != 0 and px) or (dy != 0 and py):
        return torch.roll(p, shifts=(-dy, -dx), dims=(-2, -1))
    return _zshift(p, dy, dx)


def laplacian5_bc(p: torch.Tensor, sx_lo: float, sx_hi: float,
                  sy_lo: float, sy_hi: float, px: bool = False,
                  py: bool = False) -> torch.Tensor:
    """Undivided 5-point Laplacian with per-face pressure-ghost signs
    (+1 Neumann, -1 Dirichlet, 0 periodic with the wrap shift): the wall
    diagonal is -4 plus the adjacent faces' signs."""
    ny, nx = p.shape[-2], p.shape[-1]
    ex = _edge_ones(nx, p.dtype, p.device, lo=sx_lo, hi=sx_hi)
    ey = _edge_ones(ny, p.dtype, p.device, lo=sy_lo, hi=sy_hi)

    def zs(dy, dx):
        return _shift_bc(p, dy, dx, px, py)
    return (
        zs(0, 1) + zs(0, -1) + zs(1, 0) + zs(-1, 0)
        + p * ((ey[:, None] + ex[None, :]) - 4.0)
    )


@functools.lru_cache(maxsize=256)
def inv_diag_bc(ny: int, nx: int, dtype, device, signs) -> torch.Tensor:
    """1/(-4 + the adjacent faces' signs): the Jacobi diagonal of
    ``laplacian5_bc`` with ``signs`` = (sx_lo, sx_hi, sy_lo, sy_hi);
    all-(+1) gives ``inv_diag_neumann``'s values. Memoized like
    ``_edge_ones``."""
    sx_lo, sx_hi, sy_lo, sy_hi = signs
    ex = _edge_ones(nx, dtype, device, lo=sx_lo, hi=sx_hi)
    ey = _edge_ones(ny, dtype, device, lo=sy_lo, hi=sy_hi)
    return 1.0 / (ey[:, None] + ex[None, :] - 4.0)


def divergence_bc(v: torch.Tensor, cx_lo: float, cx_hi: float,
                  cy_lo: float, cy_hi: float, px: bool = False,
                  py: bool = False) -> torch.Tensor:
    """Undivided central divergence with per-face edge coefficients on
    the wall-normal component (bc.divergence_coeffs). The constant of
    prescribed wall-normal velocities (bc.divergence_affine_bc) is the
    caller's, so this stays linear in ``v``."""
    u = v[..., 0, :, :]
    w = v[..., 1, :, :]
    ny, nx = u.shape[-2], u.shape[-1]
    gx = _edge_ones(nx, v.dtype, v.device, lo=cx_lo, hi=cx_hi)
    gy = _edge_ones(ny, v.dtype, v.device, lo=cy_lo, hi=cy_hi)

    def su(dy, dx):
        return _shift_bc(u, dy, dx, px, py)

    def sw(dy, dx):
        return _shift_bc(w, dy, dx, px, py)
    return (
        su(0, 1) - su(0, -1) + u * gx[None, :]
        + sw(1, 0) - sw(-1, 0) + w * gy[:, None]
    )


def pressure_gradient_update_bc(p: torch.Tensor, h, dt, sx_lo: float,
                                sx_hi: float, sy_lo: float, sy_hi: float,
                                px: bool = False,
                                py: bool = False) -> torch.Tensor:
    """``pressure_gradient_update_fused`` with per-face signs: the edge
    coefficient is -s at the low wall and +s at the high wall."""
    ny, nx = p.shape[-2], p.shape[-1]
    gx = _edge_ones(nx, p.dtype, p.device, lo=-sx_lo, hi=sx_hi)
    gy = _edge_ones(ny, p.dtype, p.device, lo=-sy_lo, hi=sy_hi)
    pfac = -0.5 * dt * h

    def zs(dy, dx):
        return _shift_bc(p, dy, dx, px, py)
    dpx = (zs(0, 1) - zs(0, -1)) + p * gx[None, :]
    dpy = (zs(1, 0) - zs(-1, 0)) + p * gy[:, None]
    return pfac * torch.stack([dpx, dpy], dim=-3)


# ---------------------------------------------------------------------------
# Lab forms of the projection operators (the forest assembles ghost labs)
# ---------------------------------------------------------------------------

def divergence(vlab: torch.Tensor, g: int) -> torch.Tensor:
    """Undivided central divergence of a vector lab
    [..., 2, Ny+2g, Nx+2g] -> [..., Ny, Nx] (pressure_rhs,
    main.cpp:6105-6139)."""
    if g < 1:
        raise ValueError(f"divergence needs g >= 1 ghost cells, got {g}")
    return (
        shift(vlab, g, 0, 1)[..., 0, :, :] - shift(vlab, g, 0, -1)[..., 0, :, :]
        + shift(vlab, g, 1, 0)[..., 1, :, :] - shift(vlab, g, -1, 0)[..., 1, :, :]
    )


def laplacian5(plab: torch.Tensor, g: int) -> torch.Tensor:
    """Undivided 5-point Laplacian of a scalar lab [..., Ny+2g, Nx+2g]."""
    if g < 1:
        raise ValueError(f"laplacian5 needs g >= 1 ghost cells, got {g}")
    return (
        shift(plab, g, 0, 1) + shift(plab, g, 0, -1)
        + shift(plab, g, 1, 0) + shift(plab, g, -1, 0)
        - 4.0 * shift(plab, g, 0, 0)
    )


def pressure_gradient_update(plab: torch.Tensor, g: int, h, dt):
    """h^2-scaled velocity increment -(dt h / 2) grad p [..., 2, Ny, Nx]
    from a pressure lab [..., Ny+2g, Nx+2g] (pressureCorrectionKernel,
    main.cpp:6021-6043)."""
    if g < 1:
        raise ValueError(f"pressure_gradient_update needs g >= 1 ghost "
                         f"cells, got {g}")
    pfac = -0.5 * dt * h
    dpx = shift(plab, g, 0, 1) - shift(plab, g, 0, -1)
    dpy = shift(plab, g, 1, 0) - shift(plab, g, -1, 0)
    return pfac * torch.stack([dpx, dpy], dim=-3)


# ---------------------------------------------------------------------------
# Vorticity (KernelVorticity, main.cpp:3343-3366)
# ---------------------------------------------------------------------------

def vorticity(vlab: torch.Tensor, g: int, h):
    """omega = dv/dx - du/dy, central differences; vlab [..., 2, Ny+2g,
    Nx+2g]."""
    if g < 1:
        raise ValueError(f"vorticity needs g >= 1 ghost cells, got {g}")
    i2h = 0.5 / h
    du_dy = (shift(vlab, g, 1, 0)[..., 0, :, :]
             - shift(vlab, g, -1, 0)[..., 0, :, :])
    dv_dx = (shift(vlab, g, 0, 1)[..., 1, :, :]
             - shift(vlab, g, 0, -1)[..., 1, :, :])
    return i2h * (dv_dx - du_dy)
