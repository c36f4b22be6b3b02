"""Surface force and power diagnostics: the counterpart of
``cup2d_tpu.ops.forces`` on the uniform grid.

The reference's KernelComputeForces (main.cpp:5573-5746) and
ComputeSurfaceNormals (3774-3830) as one gather pass: surface cells come
from the combined chi/sdf gradients (the delta-function weight D); each
probes up to 4 cells along its outward normal for fluid (chi < 0.01),
takes one-sided 5th-order velocity derivatives there, Taylor-corrects
them back to the surface cell and accumulates the traction (viscous
nu/h grad u . n plus pressure n), torque, the thrust/drag split along the
body velocity, lift and the output and deformation powers: the 19
per-shape components of main.cpp:7188-7284.

``surface_forces_block`` evaluates every stencil at every cell and then
drops the ones past the lab edge with ``torch.where``, as the JAX package
does with ``jnp.where``. JAX clamps an out-of-range gather index (after
wrapping a negative one); torch would raise, and on the card assert, so
every lab index goes through ``_jax_index`` first: the dropped values are
the JAX package's, and nothing reads outside the lab.

The forest's ``surface_forces_blocks`` runs the same core batched over a
leading block axis (JAX ``vmap``s it): each block's indices are clamped
inside its own lab, each block's partial sums are taken over its cells,
then summed over the blocks.
"""

from __future__ import annotations

import torch

from .stencil import pad_scalar

_EPS = 2.220446049250313e-16

# 5th-order one-sided first-derivative coefficients (main.cpp:5579-5584)
_C = (-137.0 / 60.0, 5.0, -5.0, 10.0 / 3.0, -5.0 / 4.0, 1.0 / 5.0)

FORCE_KEYS = (
    "perimeter", "circulation", "forcex", "forcey", "forcex_P", "forcey_P",
    "forcex_V", "forcey_V", "torque", "torque_P", "torque_V",
    "drag", "thrust", "lift", "Pout", "PoutBnd", "defPower", "defPowerBnd",
    "PoutNew",
)


def _jax_index(idx, n: int):
    """A gather index as JAX's indexing takes it: a negative index counts
    from the end, then the index is clamped into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def surface_forces_block(velp, pres, chip, sdfp, udef, own_sdf, xc, yc,
                         com, uvw, nu, h, G):
    """Force reduction over ONE ghost-padded tile, or over a batch of
    tiles with a leading axis [N, ...] (the forest's blocks).

    velp: [(N,) 2, L, L'] velocity lab; chip/sdfp: [(N,) L, L'] combined
    chi/sdf labs; pres/own_sdf: [(N,) ny, nx] interiors; udef: [(N,) 2,
    ny, nx] the shape's own deformation velocity; xc/yc: [(N,) ny, nx]
    cell centres; h the tile's spacing (a float), or [N] per block.
    Returns the 18 sums (0-dim tensors, or [N] per-block partial sums);
    ``_finish`` adds PoutNew.
    """
    ny, nx = pres.shape[-2:]
    ly, lx = chip.shape[-2:]
    dev = pres.device
    iy, ix = torch.meshgrid(torch.arange(ny, device=dev),
                            torch.arange(nx, device=dev), indexing="ij")
    batched = pres.dim() == 3
    if batched:
        # each block gathers from its own lab: the block index leads
        # every gather; component-first vectors as in the tile form
        blk = (torch.arange(pres.shape[0], device=dev)[:, None, None],)
        velp = velp.transpose(0, 1)
        udef = udef.transpose(0, 1)
        h = h[:, None, None]
        cells = (-2, -1)
    else:
        blk = ()
        cells = None

    def at_s(lab, yy, xx):
        return lab[blk + (_jax_index(yy + G, ly), _jax_index(xx + G, lx))]

    def at_v(yy, xx):
        return velp[(slice(None),) + blk
                    + (_jax_index(yy + G, ly), _jax_index(xx + G, lx))]

    # --- surface detection (ComputeSurfaceNormals, main.cpp:3786-3810) ---
    grad_hx = at_s(chip, iy, ix + 1) - at_s(chip, iy, ix - 1)
    grad_hy = at_s(chip, iy + 1, ix) - at_s(chip, iy - 1, ix)
    i2h = 0.5 / h
    grad_ux = i2h * (at_s(sdfp, iy, ix + 1) - at_s(sdfp, iy, ix - 1))
    grad_uy = i2h * (at_s(sdfp, iy + 1, ix) - at_s(sdfp, iy - 1, ix))
    grad_usq = grad_ux * grad_ux + grad_uy * grad_uy + _EPS
    d_w = (0.5 * h) * (grad_hx * grad_ux + grad_hy * grad_uy) / grad_usq
    norm_x = -d_w * grad_ux
    norm_y = -d_w * grad_uy
    mask = ((grad_hx * grad_hx + grad_hy * grad_hy) >= 1e-12) \
        & (torch.abs(d_w) > _EPS) & (own_sdf > -4.0 * h)

    nmag = torch.sqrt(norm_x * norm_x + norm_y * norm_y) + _EPS
    dx_u = norm_x / nmag
    dy_u = norm_y / nmag

    # --- probe walk along the normal to fluid (main.cpp:5619-5632): a
    # step is taken only while its +-1 neighbourhood stays inside the lab
    # (the reference's inrange gate); torch.round rounds half to even, as
    # jnp.rint ---
    px_i = ix
    py_i = iy
    done = torch.zeros_like(mask)
    for k in range(5):
        cx = ix + torch.round(k * dx_u).to(ix.dtype)
        cy = iy + torch.round(k * dy_u).to(iy.dtype)
        inb = (cx - 1 >= -G) & (cx + 1 <= nx + G - 1) \
            & (cy - 1 >= -G) & (cy + 1 <= ny + G - 1)
        take = inb & ~done
        px_i = torch.where(take, cx, px_i)
        py_i = torch.where(take, cy, py_i)
        done = done | (take & (at_s(chip, cy, cx) < 0.01))

    sx = torch.where(norm_x > 0, 1, -1)
    sy = torch.where(norm_y > 0, 1, -1)

    def deriv_1d(axis):
        """One-sided first derivative at the probe, 5th, 2nd or 1st order
        by the distance to the lab edge (main.cpp:5640-5696), per
        component."""
        if axis == 0:
            def off(k):
                return at_v(py_i, px_i + k * sx)
            pos, s_, n_ = px_i, sx, nx
        else:
            def off(k):
                return at_v(py_i + k * sy, px_i)
            pos, s_, n_ = py_i, sy, ny
        in5 = (pos + 5 * s_ >= -G) & (pos + 5 * s_ <= n_ + G - 1)
        in2 = (pos + 2 * s_ >= -G) & (pos + 2 * s_ <= n_ + G - 1)
        d5 = sum(c * off(k) for k, c in enumerate(_C))
        d2 = -1.5 * off(0) + 2.0 * off(1) - 0.5 * off(2)
        d1 = off(1) - off(0)
        return s_ * torch.where(in5, d5, torch.where(in2, d2, d1))

    dveldx = deriv_1d(0)
    dveldy = deriv_1d(1)
    dveldx2 = at_v(py_i, px_i - 1) - 2.0 * at_v(py_i, px_i) \
        + at_v(py_i, px_i + 1)
    dveldy2 = at_v(py_i - 1, px_i) - 2.0 * at_v(py_i, px_i) \
        + at_v(py_i + 1, px_i)

    def d2nd(kx):
        return (-1.5 * at_v(py_i, px_i + kx * sx)
                + 2.0 * at_v(py_i + sy, px_i + kx * sx)
                - 0.5 * at_v(py_i + 2 * sy, px_i + kx * sx))
    dveldxdy = (sx * sy) * (-0.5 * d2nd(2) + 2.0 * d2nd(1)
                            - 1.5 * d2nd(0))

    tx = (ix - px_i)
    ty = (iy - py_i)
    du_dx = dveldx[0] + dveldx2[0] * tx + dveldxdy[0] * ty
    dv_dx = dveldx[1] + dveldx2[1] * tx + dveldxdy[1] * ty
    du_dy = dveldy[0] + dveldy2[0] * ty + dveldxdy[0] * tx
    dv_dy = dveldy[1] + dveldy2[1] * ty + dveldxdy[1] * tx

    # --- traction and reductions (main.cpp:5700-5745) ---
    nuoh = nu / h
    fxv = nuoh * (du_dx * norm_x + du_dy * norm_y)
    fyv = nuoh * (dv_dx * norm_x + dv_dy * norm_y)
    fxp = -pres * norm_x
    fyp = -pres * norm_y
    fxt = fxv + fxp
    fyt = fyv + fyp

    here = at_v(iy, ix)
    u_here = here[0]
    v_here = here[1]
    vel_norm = torch.sqrt(uvw[0] ** 2 + uvw[1] ** 2)
    unit_x = torch.where(vel_norm > 0, uvw[0] / (vel_norm + _EPS), 0.0)
    unit_y = torch.where(vel_norm > 0, uvw[1] / (vel_norm + _EPS), 0.0)

    rx = xc - com[0]
    ry = yc - com[1]

    force_par = fxt * unit_x + fyt * unit_y
    force_perp = fxt * unit_y - fyt * unit_x
    pow_out = fxt * u_here + fyt * v_here
    pow_def = fxt * udef[0] + fyt * udef[1]

    def red(q):
        q = torch.where(mask, q, 0.0)
        return torch.sum(q) if cells is None else torch.sum(q, dim=cells)

    return {
        "perimeter": red(nmag - _EPS),
        "circulation": red(norm_x * v_here - norm_y * u_here),
        "forcex": red(fxt),
        "forcey": red(fyt),
        "forcex_P": red(fxp),
        "forcey_P": red(fyp),
        "forcex_V": red(fxv),
        "forcey_V": red(fyv),
        "torque": red(rx * fyt - ry * fxt),
        "torque_P": red(rx * fyp - ry * fxp),
        "torque_V": red(rx * fyv - ry * fxv),
        "thrust": red(0.5 * (force_par + torch.abs(force_par))),
        "drag": -red(0.5 * (force_par - torch.abs(force_par))),
        "lift": red(force_perp),
        "Pout": red(pow_out),
        "PoutBnd": red(torch.clamp_max(pow_out, 0.0)),
        "defPower": red(pow_def),
        "defPowerBnd": red(torch.clamp_max(pow_def, 0.0)),
    }


def _finish(sums, uvw):
    out = dict(sums)
    out["PoutNew"] = out["forcex"] * uvw[0] + out["forcey"] * uvw[1]
    return out


# the per-block sums of ``surface_forces_block``, in its order
BLOCK_SUM_KEYS = (
    "perimeter", "circulation", "forcex", "forcey", "forcex_P", "forcey_P",
    "forcex_V", "forcey_V", "torque", "torque_P", "torque_V",
    "thrust", "drag", "lift", "Pout", "PoutBnd", "defPower", "defPowerBnd",
)


def surface_forces_block_sums(*args, **kw) -> tuple:
    """``surface_forces_block``'s per-block sums as a tuple in
    ``BLOCK_SUM_KEYS`` order."""
    out = surface_forces_block(*args, **kw)
    return tuple(out[k] for k in BLOCK_SUM_KEYS)


def surface_forces_blocks(velp, pres, chip, sdfp, udef, own_sdf, xc, yc,
                          com, uvw, nu, h, G=4, apply=None):
    """Forest path: the core over [N] blocks at once (velp [N, 2, L, L],
    labs [N, L, L], interiors [N, ...], udef [N, 2, BS, BS], h [N]; com,
    uvw and nu shared), each block's partial sums then summed over the
    blocks. ``apply(fn, *args, **kw)`` runs the per-block core (each
    block reads its own lab only: ``parallel.shard_halo.per_shard`` runs
    it once per shard of split blocks). Returns the 19 ``FORCE_KEYS`` as
    0-dim tensors."""
    sums = (apply or _call)(surface_forces_block_sums, velp, pres, chip,
                            sdfp, udef, own_sdf, xc, yc, com, uvw, nu, h,
                            G)
    return _finish({k: torch.sum(v) for k, v in zip(BLOCK_SUM_KEYS, sums)},
                   uvw)


def _call(fn, *args, **kw):
    return fn(*args, **kw)


def surface_forces(vel, pres, chi, sdf, udef, own_sdf, com, uvw, nu, h):
    """Uniform-grid wrapper: one tile with G = 10 ghosts (edge-padded
    scalars, the free-slip mirror of the velocity, VectorLab,
    main.cpp:3127). vel/udef [2, Ny, Nx], the rest [Ny, Nx]; returns the
    19 ``FORCE_KEYS`` as 0-dim tensors."""
    ny, nx = chi.shape
    G = 10  # the probe walk (<= 4) and 5-cell stencils away from walls
    chip = pad_scalar(chi, G)
    sdfp = pad_scalar(sdf, G)
    velp = pad_scalar(vel, G)
    sgnx = torch.ones(nx + 2 * G, dtype=vel.dtype, device=vel.device)
    sgnx[:G] = -1
    sgnx[nx + G:] = -1
    sgny = torch.ones(ny + 2 * G, dtype=vel.dtype, device=vel.device)
    sgny[:G] = -1
    sgny[ny + G:] = -1
    velp = torch.stack([velp[0] * sgnx[None, :], velp[1] * sgny[:, None]])

    x = (torch.arange(nx, dtype=vel.dtype, device=vel.device) + 0.5) * h
    y = (torch.arange(ny, dtype=vel.dtype, device=vel.device) + 0.5) * h
    xc = x[None, :].expand(ny, nx)
    yc = y[:, None].expand(ny, nx)
    sums = surface_forces_block(velp, pres, chip, sdfp, udef, own_sdf,
                                xc, yc, com, uvw, nu, h, G)
    return _finish(sums, uvw)
