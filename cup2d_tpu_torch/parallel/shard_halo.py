"""Slab mesh, split fields and the explicit halo exchange of the x-split
uniform step: the counterpart of the uniform half of
``cup2d_tpu.parallel.shard_halo`` and of the partitioning that the JAX
package leaves to GSPMD.

A field split over a ``SlabMesh`` of D shards is a ``Slabs``: D
contiguous tensors ``[..., Ny, Nx/D]``, slab d on ``mesh.devices[d]``
holding the global columns ``[d*Nx/D, (d+1)*Nx/D)``. One process drives
every shard (a single-controller mesh); devices may repeat, so four
shards can share one card or eight the CPU. Data crosses shards in two
ways only:

1. ``exchange_x``, the edge-column exchange (the reference's pair of
   ``lax.ppermute``s): shard d's left halo is shard d-1's last g columns,
   its right halo shard d+1's first g; wall shards receive zeros there.
   Copies are ``copy_`` without a host synchronization, so a peer copy
   follows the producer's stream. A multi-host backend plugs in here.
   The halo sweep needs none where every slab lies on one device: one
   launch sweeps them all, each slab reading its neighbours' edge
   columns in place (``sweep_slabs``).
2. The global reductions (``slab_reducers``, ``slab_sum``,
   ``slab_mean``, ``slab_linf``): per-shard partials in the dtype that
   ``poisson._reducers`` uses, combined in shard order on
   ``mesh.devices[0]``, where every scalar of a step lives.

Every stencil the step applies to a split field is written out here: the
JAX package's GSPMD partitioner inserted the halo exchanges of its
shifted slices and the all-reduces of its reductions implicitly. The
per-slab arithmetic is the whole-field arithmetic term for term
(``ops.stencil``'s ``*_slab`` forms, the halo kernels), so a split field
gives the whole field's values bit for bit; only the reductions' order
differs.
"""

from __future__ import annotations

import math

import torch

from ..bc import periodic_axes
from ..ops.hopper_kernels import (HALO_MAX_SLABS, _substage_facs,
                                  advect_substage_halo, jacobi_halo_sweep,
                                  jacobi_halo_sweep_plain,
                                  jacobi_halo_sweep_slabs)
from ..ops.stencil import (FREE_SLIP_COEFFS, NEUMANN_SIGNS,
                           divergence_bc_slab, laplacian5_bc_slab,
                           pressure_gradient_slab)

WENO_HALO = 3
# a multigrid level stays split while its slab is at least this wide;
# narrower levels are gathered onto mesh.devices[0] (see level_meshes)
MIN_SPLIT_WIDTH = 8

# the halo-kernel sweeps of overlap_jacobi_sweeps (one per sweep and
# level) and the edge-column exchanges made for them; a run that sets
# both to 0 reads them against the kernel's launch count
sweep_stats = {"sweeps": 0, "exchanges": 0}


def canonical_device(d) -> torch.device:
    """``d`` with its index: a bare ``cuda`` is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class SlabMesh:
    """D shards along x: shard d lives on ``devices[d]``. Devices may
    repeat (several shards on one card, or on the CPU)."""

    def __init__(self, devices):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("SlabMesh: no devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"SlabMesh({[str(d) for d in self.devices]})"


def _scalar_on(s, device):
    if torch.is_tensor(s):
        return s.to(device, non_blocking=True)
    return s


class Slabs:
    """A field split along x over ``mesh``: ``parts[d]`` on
    ``mesh.devices[d]``. Arithmetic with another ``Slabs`` of the same
    mesh, a number or a 0-d tensor is slab by slab (a 0-d tensor is moved
    to each slab's device), so the solvers' vector updates run unchanged.
    ``device`` is ``mesh.devices[0]``, where reductions land."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts, mesh: SlabMesh):
        self.parts = list(parts)
        self.mesh = mesh

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    @property
    def shape(self) -> torch.Size:
        s = self.parts[0].shape
        return s[:-1] + (sum(p.shape[-1] for p in self.parts),)

    def map(self, fn, *others) -> "Slabs":
        """``fn`` slab by slab, over this field and ``others`` (Slabs of
        the same mesh)."""
        return Slabs([fn(p, *(o.parts[d] for o in others))
                      for d, p in enumerate(self.parts)], self.mesh)

    def _bin(self, other, op) -> "Slabs":
        if isinstance(other, Slabs):
            return Slabs([op(p, o) for p, o in zip(self.parts, other.parts)],
                         self.mesh)
        return Slabs([op(p, _scalar_on(other, p.device))
                      for p in self.parts], self.mesh)

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    # an IEEE product does not depend on the operands' order
    __rmul__ = __mul__

    def to(self, dtype) -> "Slabs":
        return Slabs([p.to(dtype) for p in self.parts], self.mesh)

    def zeros_like(self) -> "Slabs":
        return Slabs([torch.zeros_like(p) for p in self.parts], self.mesh)


def split_x(t: torch.Tensor, mesh: SlabMesh) -> Slabs:
    """Split a whole field [..., Nx] into ``mesh.size`` contiguous slabs,
    each copied to its device."""
    nx = t.shape[-1]
    D = mesh.size
    if nx % D:
        raise ValueError(f"Nx={nx} not divisible by the mesh size {D}")
    w = nx // D
    parts = []
    for d, dev in enumerate(mesh.devices):
        p = torch.empty(t.shape[:-1] + (w,), dtype=t.dtype, device=dev)
        p.copy_(t[..., d * w:(d + 1) * w])
        parts.append(p)
    return Slabs(parts, mesh)


def gather_x(s: Slabs, device=None) -> torch.Tensor:
    """The whole field of a split one, on ``device`` (default
    ``mesh.devices[0]``)."""
    dev = s.device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in s.parts], dim=-1)


def reshard(s: Slabs, mesh: SlabMesh) -> Slabs:
    """The same field over another mesh: gathered onto a one-device mesh,
    or split from one."""
    if mesh is s.mesh:
        return s
    if mesh.size == 1:
        return Slabs([gather_x(s, mesh.devices[0])], mesh)
    return split_x(gather_x(s), mesh)


def exchange_x(s: Slabs, g: int) -> list:
    """The edge-column exchange: per shard an aux tensor [..., 2g] whose
    first g columns are the left neighbour's last g (zeros on shard 0)
    and whose last g are the right neighbour's first g (zeros on the last
    shard)."""
    parts = s.parts
    D = len(parts)
    if any(p.shape[-1] < g for p in parts):
        raise ValueError(f"exchange_x: slab widths "
                         f"{[p.shape[-1] for p in parts]} < halo {g}")
    out = []
    for d, p in enumerate(parts):
        shape = p.shape[:-1] + (2 * g,)
        if D == 1:
            out.append(p.new_zeros(shape))
            continue
        aux = p.new_empty(shape)
        if d > 0:
            aux[..., :g].copy_(parts[d - 1][..., -g:], non_blocking=True)
        else:
            aux[..., :g].zero_()
        if d < D - 1:
            aux[..., g:].copy_(parts[d + 1][..., :g], non_blocking=True)
        else:
            aux[..., g:].zero_()
        out.append(aux)
    return out


def _walls(s: Slabs):
    D = len(s.parts)
    return [(d == 0, d == D - 1) for d in range(D)]


# ---------------------------------------------------------------------------
# global reductions: per-shard partials, combined in shard order
# ---------------------------------------------------------------------------

def _combine(partials, device):
    acc = partials[0].to(device)
    for p in partials[1:]:
        acc = acc + p.to(device)
    return acc


def slab_sum(a: Slabs, dtype=None) -> torch.Tensor:
    """Sum of a split field (accumulated in ``dtype``, default its own)."""
    return _combine([torch.sum(p, dtype=dtype) for p in a.parts], a.device)


def slab_mean(a: Slabs) -> torch.Tensor:
    """Mean accumulated in f64 (``poisson.project_correct`` takes its
    means so): the f32 value does not hang on the summation order."""
    return (slab_sum(a, torch.float64) / math.prod(a.shape)).to(a.dtype)


def slab_linf(a: Slabs) -> torch.Tensor:
    """max |a|: exact in any order."""
    m = [torch.amax(torch.abs(p)).to(a.device) for p in a.parts]
    acc = m[0]
    for x in m[1:]:
        acc = torch.maximum(acc, x)
    return acc


def slab_all_finite(*fields: Slabs) -> torch.Tensor:
    flags = [torch.isfinite(p).all().to(f.device)
             for f in fields for p in f.parts]
    acc = flags[0]
    for x in flags[1:]:
        acc = acc & x
    return acc


def slab_reducers(dt_, sum_dtype):
    """``poisson._reducers`` for split fields: (dot, linf, zeros_like),
    dot products accumulated per shard in ``sum_dtype`` (default the
    field dtype) and combined in shard order."""
    sd = sum_dtype or dt_

    def dot(a, c):
        if sd == dt_:
            return _combine([torch.sum(x * y)
                             for x, y in zip(a.parts, c.parts)], a.device)
        return _combine([torch.sum(x * y, dtype=sd)
                         for x, y in zip(a.parts, c.parts)],
                        a.device).to(dt_)

    return dot, slab_linf, Slabs.zeros_like


# ---------------------------------------------------------------------------
# the split stencils of the step (what GSPMD partitioned in the reference)
# ---------------------------------------------------------------------------

def laplacian5_bc_x(p: Slabs, signs=None) -> Slabs:
    """``ops.stencil.laplacian5_bc`` of a split field (``signs`` a table's
    (sx_lo, sx_hi, sy_lo, sy_hi) pressure signs; None: all Neumann, i.e.
    ``laplacian5_neumann``): one edge column exchanged, then
    ``laplacian5_bc_slab`` on every shard (the x-wall diagonal on the wall
    shards only). GSPMD partitioned the whole-field form's shifted slices
    into the same exchange."""
    signs = NEUMANN_SIGNS if signs is None else signs
    aux = exchange_x(p, 1)
    return Slabs([laplacian5_bc_slab(part, aux[d], signs, lo, hi)
                  for d, (part, (lo, hi))
                  in enumerate(zip(p.parts, _walls(p)))], p.mesh)


def divergence_bc_x(v: Slabs, h, dt, coeffs=None,
                    affine: Slabs = None) -> Slabs:
    """The obstacle-free pressure RHS (h/2dt) [div(u*) + affine] of a split
    velocity (``UniformGrid.poisson_rhs`` with chi None): one edge column
    of u exchanged, then ``divergence_bc_slab`` with a table's
    ``coeffs`` (bc.divergence_coeffs; None: free-slip) on every shard, the
    x wall terms on the wall shards only; ``affine`` is the table's
    constant term of prescribed wall-normal velocities
    (bc.divergence_affine_bc, split like the field), added scaled as the
    whole-field RHS adds it."""
    coeffs = FREE_SLIP_COEFFS if coeffs is None else coeffs
    aux = exchange_x(v, 1)
    div = Slabs([divergence_bc_slab(part, aux[d], coeffs, lo, hi)
                 for d, (part, (lo, hi))
                 in enumerate(zip(v.parts, _walls(v)))], v.mesh)
    fac = 0.5 * h / dt
    b = fac * div
    if affine is not None:
        b = b + fac * affine
    return b


def project_correct_x(x: Slabs, pres_old: Slabs, vel: Slabs, h, dt,
                      remove_mean: bool = True, grad_signs=None):
    """The projection epilogue of ``poisson.project_correct`` on split
    fields, written out as plain per-slab code (the correction kernel has
    no split form, as in the JAX package, whose mesh keeps the XLA
    epilogue): pres = ((x - mean x) + pres_old) - mean pres_old (zero
    means where not ``remove_mean``: a table with an outflow face keeps
    the pressure level), then one edge column of pres exchanged and vel +=
    (pfac grad(pres)) / h^2 with pfac = -dt h / 2, the one-sided wall terms
    signed by the table's ``grad_signs`` (None: Neumann) and on the wall
    shards only in x (``pressure_gradient_update_bc``). Returns (vel,
    pres)."""
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    if remove_mean:
        mx, mp = slab_mean(x), slab_mean(pres_old)
    else:
        mx = mp = torch.zeros((), dtype=x.dtype, device=x.device)
    pfac = -0.5 * dt * h
    ih2 = 1.0 / (h * h)
    pres = Slabs([((xp - mx.to(xp.device)) + pp) - mp.to(xp.device)
                  for xp, pp in zip(x.parts, pres_old.parts)], x.mesh)
    aux = exchange_x(pres, 1)
    out = []
    for d, (pp, vp, (lo, hi)) in enumerate(zip(pres.parts, vel.parts,
                                               _walls(pres))):
        dv = pfac.to(pp.device) * pressure_gradient_slab(pp, aux[d], lo, hi,
                                                         grad_signs)
        out.append(vp + dv * ih2)
    return Slabs(out, vel.mesh), pres


def fused_advect_heun_sharded(vel: Slabs, h, nu, dt, bc=None,
                              bf16: bool = False) -> Slabs:
    """Both Heun substages on a split velocity [..., 2, Ny, w] per slab:
    each substage exchanges three edge columns (in the storage dtype),
    then runs the halo-mode substage (``advect_substage_halo``: the kernel
    on the card, its twin on the CPU) on every shard, wall shards painting
    their x ghosts. dt is a scalar or shaped like the leading dims. ``bc``
    a non-periodic ``BCTable`` (None or free-slip: the free-slip form):
    every shard paints the table's y ghosts over its halo columns too, the
    parabolic profile at its global columns (col0 = d w of the whole
    width), and its x ghosts on the walls it owns; the facs carry the raw
    dt (the outflow speed). A periodic table refuses (its wrap would need a
    ring exchange; ROADMAP queue 1 item 8). ``bf16`` (f32 state only), as
    ``hopper_kernels.fused_advect_heun``: substage 1 reads a bf16 copy of
    every slab and writes bf16, substage 2 reads that and the copy and
    writes the f32 state; both exchange their halos in bf16."""
    if bc is not None and bc.is_free_slip:
        bc = None
    if bc is not None and any(periodic_axes(bc)):
        raise NotImplementedError(
            f"fused_advect_heun_sharded: boundary table {bc.token!r}: "
            "periodic faces have no split form (ROADMAP queue 1 item 8)")
    if any(p.shape[-1] < WENO_HALO for p in vel.parts):
        raise ValueError(
            f"fused_advect_heun_sharded: slab width "
            f"{vel.parts[0].shape[-1]} < the WENO halo {WENO_HALO}")
    p0 = vel.parts[0]
    if bf16 and p0.dtype != torch.float32:
        raise ValueError(f"fused_advect_heun_sharded(bf16=True): {p0.dtype} "
                         "state; the bf16 tier needs f32 state")
    lead = p0.shape[:-3]
    L = math.prod(lead)
    facs = _substage_facs(dt, float(h), nu, lead, L, p0.dtype, vel.device,
                          with_dt=bc is not None)
    facs = [facs.to(p.device) for p in vel.parts]
    ih2 = 1.0 / (float(h) * float(h))
    walls = _walls(vel)
    nx_tot = vel.shape[-1]
    col0 = [0]
    for p in vel.parts[:-1]:
        col0.append(col0[-1] + p.shape[-1])
    v0 = Slabs([p.reshape((L,) + p.shape[-3:]) for p in vel.parts],
               vel.mesh)

    def sub(stage, vold, cfac, out_dtype=None):
        aux = exchange_x(stage, WENO_HALO)
        return Slabs([advect_substage_halo(
            p, None if vold is None else vold.parts[d], aux[d], facs[d],
            cfac, ih2, lo, hi, out_dtype, bc, float(h), col0[d], nx_tot)
            for d, (p, (lo, hi)) in enumerate(zip(stage.parts, walls))],
            stage.mesh)

    if bf16:
        vb = v0.to(torch.bfloat16)
        v2 = sub(sub(vb, None, 0.5), vb, 1.0, torch.float32)
    else:
        v2 = sub(sub(v0, None, 0.5), v0, 1.0)
    return Slabs([p.reshape(q.shape) for p, q in zip(v2.parts, vel.parts)],
                 vel.mesh)


def sweep_slabs(e, r: Slabs, omega: float, from_zero: bool = False,
                edge_signs=None) -> Slabs:
    """One sweep of a split field whose slabs all lie on one device: one
    ``jacobi_halo_sweep_slabs`` launch for every slab (its twin on the
    CPU), each slab reading its neighbours' edge columns in place, so no
    exchange runs."""
    sweep_stats["sweeps"] += 1
    return Slabs(jacobi_halo_sweep_slabs(None if from_zero else e.parts,
                                         r.parts, omega, from_zero,
                                         edge_signs), r.mesh)


def sweep_exchanged(e, r: Slabs, omega: float, from_zero: bool = False,
                    edge_signs=None, fused: bool = True) -> Slabs:
    """One sweep as the JAX package runs it per shard: one edge column
    exchanged (none from zero), then ``jacobi_halo_sweep`` on every slab,
    one launch each (``fused=False``: its plain twin)."""
    sweep = jacobi_halo_sweep if fused else jacobi_halo_sweep_plain
    walls = _walls(r)
    if from_zero:
        aux, eparts = [None] * len(r.parts), [None] * len(r.parts)
    else:
        aux, eparts = exchange_x(e, 1), e.parts
    if fused:
        sweep_stats["sweeps"] += 1
        sweep_stats["exchanges"] += not from_zero
    return Slabs([sweep(ep, rp, aux[d], omega, lo, hi, from_zero,
                        edge_signs)
                  for d, (ep, rp, (lo, hi))
                  in enumerate(zip(eparts, r.parts, walls))], r.mesh)


def overlap_jacobi_sweeps(e, r: Slabs, omega: float, n: int,
                          from_zero: bool = False, fused: bool = True,
                          edge_signs=None) -> Slabs:
    """n damped-Jacobi sweeps e + omega (r - lap e) inv_d on split fields
    [Ny, w] per slab, one sweep at a time (each needs fresh neighbour
    columns, so the chain cannot block sweeps in time), the halo kernel's
    signed form with a table's ``edge_signs``. The mesh chooses the form:
    where every slab lies on one device (at most ``HALO_MAX_SLABS`` of
    them), ``sweep_slabs``, one launch a sweep; on slabs of several
    devices ``sweep_exchanged``, an exchange and a launch per slab.
    ``fused=False`` takes the plain twin per slab, as the bf16
    preconditioner cycle takes plain sweeps. ``from_zero`` makes the
    first sweep omega r inv_d."""
    one = len(set(r.mesh.devices)) == 1 and r.mesh.size <= HALO_MAX_SLABS
    for k in range(n):
        fz = from_zero and k == 0
        if fused and one:
            e = sweep_slabs(e, r, omega, fz, edge_signs)
        else:
            e = sweep_exchanged(e, r, omega, fz, edge_signs, fused)
    return e


def level_meshes(shapes, mesh: SlabMesh) -> list:
    """The mesh of every multigrid level (finest first): ``mesh`` while
    the level stays split, else the one-device mesh of
    ``mesh.devices[0]``. A level stays split while the finer level's slab
    width is even (so the 2x2 restriction and the repeat prolongation
    stay local to a slab) and its own slab is at least
    ``MIN_SPLIT_WIDTH`` columns wide. Narrower levels gather: there a
    sweep is a few hundred cells per slab, and D launches plus an
    exchange per sweep cost more than the sweep. Every transfer is
    pointwise, so either form gives the solo cycle's values bit for
    bit."""
    D = mesh.size
    ny0, nx0 = shapes[0]
    if nx0 % D:
        raise ValueError(f"Nx={nx0} not divisible by the mesh size {D}")
    one = SlabMesh(mesh.devices[:1]) if D > 1 else mesh
    out = [mesh]
    split = True
    for lvl in range(1, len(shapes)):
        w_prev = shapes[lvl - 1][1] // D
        split = (split and w_prev % 2 == 0
                 and shapes[lvl][1] // D >= MIN_SPLIT_WIDTH)
        out.append(mesh if split else one)
    return out
