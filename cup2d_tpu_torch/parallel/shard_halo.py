"""Slab mesh, split fields and the explicit halo exchange of the x-split
uniform step, and the split block ranges of the forest: the counterpart
of ``cup2d_tpu.parallel.shard_halo`` and of the partitioning that the JAX
package leaves to GSPMD. The forest half (``Blocks``, ``ShardTables``,
``ShardPoissonOp``, ``ShardFluxCorr``, the surface exchange plan) is
described where it begins, below.

A field split over a ``SlabMesh`` of D shards is a ``Slabs``: contiguous
tensors ``[..., Ny, Nx/D]``, slab d holding the global columns
``[d*Nx/D, (d+1)*Nx/D)``. A mesh is driven by one process (a
single-controller mesh: every shard local, devices may repeat, so four
shards can share one card or eight the CPU) or by every rank of a
``torch.distributed`` world (``SlabMesh.over_world``, brought up by
``parallel.launch``): rank r owns a contiguous range of shards, all on its
one device (its card, or the CPU), and a split field holds its local parts
only, in ``mesh.local`` order; another rank's part is absent. Data crosses
shards in two ways only:

1. ``exchange_x``, the edge-column exchange (the reference's pair of
   ``lax.ppermute``s): shard d's left halo is shard d-1's last g columns,
   its right halo shard d+1's first g; wall shards receive zeros there,
   and along a periodic x the shards close into a ring (shard 0's left
   neighbour is the last shard; one shard is its own neighbour).
   Between local shards a halo is a ``copy_`` without a host
   synchronization, so a peer copy follows the producer's stream; between
   ranks the edge columns go through one ``batch_isend_irecv`` a call
   (NCCL on cards, gloo on the CPU). The halo sweep needs none where every
   slab lies on one device of one process: one launch sweeps them all,
   each slab reading its neighbours' edge columns in place
   (``sweep_slabs``).
2. The global reductions (``slab_reducers``, ``slab_sum``,
   ``slab_mean``, ``slab_linf``): per-shard partials in the dtype that
   ``poisson._reducers`` uses, combined in shard order on ``mesh.home``
   (the first local shard's device), where every scalar of a step lives.
   Under a world the partials are all-gathered first (``all_shards``), so
   every rank adds the same terms in the same order and holds the same
   bits: the same dt, residuals and verdicts, so every host branch agrees.
   The forest's full sums (``block_sum``) take the partials of fixed
   16-block groups instead, whose order does not depend on the mesh.
   ``comm_stats`` counts the all-gathers by what they carry
   (``COMM_KINDS``).

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
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..bc import periodic_axes
from ..flux import _structured_lap
from ..halo import _paint_regions, _weighted, filter_face_rows
from ..ops.hopper_kernels import (HALO_MAX_SLABS, _signs, _substage_facs,
                                  _wrap_axes,
                                  advect_substage_halo,
                                  fused_block_jacobi_update, group_sum,
                                  jacobi_halo_sweep,
                                  jacobi_halo_sweep_plain,
                                  jacobi_halo_sweep_slabs)
from ..ops.stencil import (FREE_SLIP_COEFFS, NEUMANN_SIGNS,
                           divergence_bc_slab, laplacian5_bc_slab,
                           pressure_gradient_slab)

WENO_HALO = 3
# a multigrid level stays split while its slab is at least this wide;
# narrower levels are gathered onto mesh.home (see level_meshes)
MIN_SPLIT_WIDTH = 8

# the halo-kernel sweeps of overlap_jacobi_sweeps (one per sweep and
# level) and the edge-column exchanges made for them; a run that sets
# both to 0 reads them against the kernel's launch count
sweep_stats = {"sweeps": 0, "exchanges": 0}

# what an all-gather carries (``all_shards``' ``kind``): reduction partials,
# the block-Jacobi preconditioner's operand (none since it runs per shard),
# the forest's two-level and FAS image transfers and base solve, the
# regrid's tags and migration (slot fields, the shaped start's blend), the
# forest's surface exchange in "allgather" mode, the uniform step's
# gathered multigrid levels, and whole fields (dumps, checkpoints, tests)
COMM_KINDS = ("reductions", "preconditioner", "transfers", "regrid",
              "surface", "levels", "state")

# the traffic between ranks since the counts were last zeroed
# (``reset_comm_stats``): all-gathers (the bytes every rank receives, its
# own part included), in total and by kind (``allgathers.<kind>``,
# ``allgather_bytes.<kind>``), and point-to-point messages (edge columns,
# surface blocks; the bytes this rank sends). A single-controller mesh has
# no such traffic; there ``local_gathers.<kind>`` and
# ``local_gather_bytes.<kind>`` count the same joins, made by copies onto
# the home device (every part's bytes)
comm_stats: dict = {}


def reset_comm_stats() -> None:
    """Zero every count of ``comm_stats``."""
    comm_stats.clear()
    comm_stats.update(allgathers=0, allgather_bytes=0, p2p_messages=0,
                      p2p_bytes=0)
    for k in COMM_KINDS:
        for key in ("allgathers", "allgather_bytes", "local_gathers",
                    "local_gather_bytes"):
            comm_stats[f"{key}.{k}"] = 0


reset_comm_stats()


def comm_by_kind(stats: Optional[dict] = None, local: bool = False
                 ) -> dict:
    """{kind: (all-gathers, bytes)} of ``stats`` (default ``comm_stats``;
    any dict of its keys, e.g. per-step means); with ``local`` the joins
    of a single-controller mesh instead."""
    st = comm_stats if stats is None else stats
    a, b = ("local_gathers", "local_gather_bytes") if local else \
        ("allgathers", "allgather_bytes")
    return {k: (st[f"{a}.{k}"], st[f"{b}.{k}"]) for k in COMM_KINDS}


# how many times this process's world was re-formed
# (``parallel.launch.reinit_distributed``); a world's mesh records the
# count it was built under, so a mesh over the re-formed world is told
# from one over the world that was lost
world_epoch = 0


def canonical_device(d) -> torch.device:
    """``d`` with its index: a bare ``cuda`` is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class SlabMesh:
    """D shards along x (the forest: D block ranges). Built from devices,
    one process drives every shard: shard d lives on ``devices[d]``, and
    devices may repeat (several shards on one card, or on the CPU).
    ``SlabMesh.over_world`` builds the mesh of a ``torch.distributed``
    world instead: shard d belongs to rank ``owners[d]`` (contiguous
    ranges in rank order), every shard of a rank lies on that rank's one
    device, and ``devices[d]`` is None for a shard of another rank, so
    nothing is ever placed there. ``local`` lists this process's shards
    (every shard on a single-controller mesh) and ``home`` is the device
    of the first of them, where reductions and scalars land."""

    def __init__(self, devices):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("SlabMesh: no devices")
        self.owners = (0,) * len(self.devices)
        self.rank = 0
        self.world = 1
        self.distributed = False
        self.local = tuple(range(len(self.devices)))

    @classmethod
    def over_world(cls, n_shards: int, device) -> "SlabMesh":
        """``n_shards`` shards over the ranks of the default process group,
        ``n_shards / world_size`` of them on each rank's ``device``."""
        ws, r = dist.get_world_size(), dist.get_rank()
        if n_shards < 1 or n_shards % ws:
            raise ValueError(f"a mesh of {n_shards} shards over {ws} ranks: "
                             "the shard count must be a positive multiple "
                             "of the world size")
        per = n_shards // ws
        dev = canonical_device(device)
        mesh = cls.__new__(cls)
        mesh.owners = tuple(d // per for d in range(n_shards))
        mesh.devices = tuple(dev if o == r else None for o in mesh.owners)
        mesh.rank = r
        mesh.world = ws
        mesh.distributed = True
        mesh.local = tuple(range(r * per, (r + 1) * per))
        mesh.epoch = world_epoch
        return mesh

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[self.local[0]]

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[d] for d in self.local)

    @property
    def all_local(self) -> bool:
        """Every shard belongs to this process."""
        return len(self.local) == self.size

    def __repr__(self) -> str:
        if self.distributed:
            return (f"SlabMesh({self.size} shards over {self.world} ranks, "
                    f"rank {self.rank}: {list(self.local)} on {self.home})")
        return f"SlabMesh({[str(d) for d in self.devices]})"


def check_remesh(old: SlabMesh, new: SlabMesh) -> None:
    """The re-mesh rule: a single-controller mesh may be replaced by any
    other single-controller mesh, a world's mesh by another over the same
    ranks (say with another number of shards a rank), or by one over the
    world that ``parallel.launch.reinit_distributed`` formed from the
    survivors since (the elastic recovery: ``remesh`` then reads nothing
    through the lost world). Any other mesh over other ranks, or a change
    between a single controller and a world, raises: such a mesh needs the
    world re-formed first."""
    same = (old.distributed == new.distributed
            and (not old.distributed
                 or (old.world == new.world and old.rank == new.rank
                     and set(old.owners) == set(new.owners))))
    if same or world_reformed(old, new):
        return
    raise NotImplementedError(
        f"re-mesh from {old} onto {new}: a mesh over other ranks needs the "
        "world re-formed over them first (parallel.launch."
        "reinit_distributed)")


def world_reformed(old: SlabMesh, new: SlabMesh) -> bool:
    """``new`` is a mesh over the world re-formed since ``old``'s world
    was built: ``old``'s collectives died with that world."""
    return (old.distributed and new.distributed
            and getattr(new, "epoch", 0) > getattr(old, "epoch", 0))


def all_shards(parts, mesh: SlabMesh, device=None,
               kind: str = "state") -> list:
    """Every shard's tensor, in shard order, on ``device`` (default
    ``mesh.home``), from this process's ``parts`` (one per local shard,
    or one per local shard and field; under a world as many on every rank,
    each of one shape and dtype): the parts moved there
    on a single-controller mesh, else one all-gather of every rank's
    stacked parts (gathered on ``home``, the rank's own device, so NCCL
    sees its card), counted in ``comm_stats`` under ``kind`` (one of
    ``COMM_KINDS``). A collective under a world: every rank calls it in
    the same order."""
    dev = mesh.home if device is None else torch.device(device)
    if not mesh.distributed:
        comm_stats[f"local_gathers.{kind}"] += 1
        comm_stats[f"local_gather_bytes.{kind}"] += sum(
            p.numel() * p.element_size() for p in parts)
        return [p.to(dev) for p in parts]
    x = torch.stack([p.to(mesh.home) for p in parts])
    flag = x.dtype == torch.bool
    if flag:
        x = x.to(torch.uint8)
    bufs = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(bufs, x)
    nbytes = mesh.world * x.numel() * x.element_size()
    comm_stats["allgathers"] += 1
    comm_stats["allgather_bytes"] += nbytes
    comm_stats[f"allgathers.{kind}"] += 1
    comm_stats[f"allgather_bytes.{kind}"] += nbytes
    out = torch.cat(bufs)
    if flag:
        out = out.to(torch.bool)
    return list(out.to(dev).unbind(0))


def _send_recv(msgs) -> None:
    """One ``batch_isend_irecv`` over ``msgs`` ((send, peer, tensor, tag),
    contiguous tensors), waited on. Every rank lists its messages in one
    global order, so the sends and receives of each pair of ranks match
    in order (NCCL ignores the tags; gloo matches them)."""
    if not msgs:
        return
    ops = []
    for send, peer, t, tag in msgs:
        ops.append(dist.P2POp(dist.isend if send else dist.irecv, t, peer,
                              tag=tag))
        if send:
            comm_stats["p2p_messages"] += 1
            comm_stats["p2p_bytes"] += t.numel() * t.element_size()
    for w in dist.batch_isend_irecv(ops):
        w.wait()


def _scalar_on(s, device):
    if torch.is_tensor(s):
        return s.to(device, non_blocking=True)
    return s


class Slabs:
    """A field split along x over ``mesh``: ``parts[i]`` is the slab of
    shard ``mesh.local[i]``, on that shard's device (every slab on a
    single-controller mesh; a rank's own under a world). Arithmetic with
    another ``Slabs`` of the same mesh, a number or a 0-d tensor is slab by
    slab (a 0-d tensor is moved to each slab's device), so the solvers'
    vector updates run unchanged. ``device`` is ``mesh.home``, where
    reductions land; ``shape`` is the whole field's."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts, mesh: SlabMesh):
        self.parts = list(parts)
        self.mesh = mesh

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def shape(self) -> torch.Size:
        s = self.parts[0].shape
        if self.mesh.distributed:
            return s[:-1] + (s[-1] * self.mesh.size,)
        return s[:-1] + (sum(p.shape[-1] for p in self.parts),)

    def map(self, fn, *others) -> "Slabs":
        """``fn`` slab by slab, over this field and ``others`` (Slabs of
        the same mesh)."""
        return Slabs([fn(p, *(o.parts[i] for o in others))
                      for i, p in enumerate(self.parts)], self.mesh)

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

    def clone(self) -> "Slabs":
        """Fresh copies of every slab (the snapshot ring's form)."""
        return Slabs([p.clone() for p in self.parts], self.mesh)


def split_x(t: torch.Tensor, mesh: SlabMesh) -> Slabs:
    """Split a whole field [..., Nx] into ``mesh.size`` contiguous slabs
    and keep this process's, each copied to its device."""
    nx = t.shape[-1]
    D = mesh.size
    if nx % D:
        raise ValueError(f"Nx={nx} not divisible by the mesh size {D}")
    w = nx // D
    parts = []
    for d in mesh.local:
        p = torch.empty(t.shape[:-1] + (w,), dtype=t.dtype,
                        device=mesh.devices[d])
        p.copy_(t[..., d * w:(d + 1) * w])
        parts.append(p)
    return Slabs(parts, mesh)


def gather_x(s: Slabs, device=None, kind: str = "state") -> torch.Tensor:
    """The whole field of a split one, on ``device`` (default
    ``mesh.home``); an all-gather (of ``kind``) under a world."""
    return torch.cat(all_shards(s.parts, s.mesh, device, kind), dim=-1)


def reshard(s: Slabs, mesh: SlabMesh) -> Slabs:
    """The same field over another mesh: gathered onto a one-device mesh,
    or split from one."""
    if mesh is s.mesh:
        return s
    if mesh.size == 1:
        return Slabs([gather_x(s, mesh.devices[0], "levels")], mesh)
    return split_x(gather_x(s, kind="levels"), mesh)


def permute_slabs(s: Slabs, src_of) -> Slabs:
    """A new field whose slab j holds slab ``src_of(j)``'s contents, as
    fresh tensors on slab j's device: a copy between local shards (a peer
    copy between cards of one process), a message between ranks through
    ``_send_recv``, listed by source slab in one global order on every
    rank (a collective under a world: every rank calls it)."""
    mesh = s.mesh
    D = mesh.size
    pos = {d: i for i, d in enumerate(mesh.local)}
    out = [None] * len(mesh.local)
    msgs = []
    for j in range(D):
        i = src_of(j)
        if i in pos and j in pos:
            src = s.parts[pos[i]]
            out[pos[j]] = src.to(mesh.devices[j], copy=True)
        elif i in pos:
            msgs.append((True, mesh.owners[j], s.parts[pos[i]], i))
        elif j in pos:
            ref = s.parts[pos[j]]
            out[pos[j]] = ref.new_empty(ref.shape)
            msgs.append((False, mesh.owners[i], out[pos[j]], i))
    _send_recv(msgs)
    return Slabs(out, mesh)


def _neighbours(d: int, D: int, ring: bool):
    """Shard d's (left, right) neighbours, None at a wall."""
    left = d - 1 if d > 0 else (D - 1 if ring else None)
    right = d + 1 if d < D - 1 else (0 if ring else None)
    return left, right


def exchange_x(s: Slabs, g: int, ring: bool = False) -> list:
    """The edge-column exchange: per local shard an aux tensor [..., 2g]
    whose first g columns are the left neighbour's last g (zeros on shard
    0) and whose last g are the right neighbour's first g (zeros on the
    last shard). ``ring`` (a periodic x): the first and the last shard are
    neighbours, so shard 0 receives the last shard's last g columns and
    the last shard shard 0's first g; one shard receives its own. A
    neighbour of another rank sends its columns through ``_send_recv``:
    per slab boundary in global order, each side sends its edge and
    receives the other's."""
    mesh = s.mesh
    parts = s.parts
    D = mesh.size
    if any(p.shape[-1] < g for p in parts):
        raise ValueError(f"exchange_x: slab widths "
                         f"{[p.shape[-1] for p in parts]} < halo {g}")
    pos = {d: i for i, d in enumerate(mesh.local)}
    out = []
    for i, d in enumerate(mesh.local):
        p = parts[i]
        shape = p.shape[:-1] + (2 * g,)
        if D == 1 and not ring:
            out.append(p.new_zeros(shape))
            continue
        aux = p.new_empty(shape)
        left, right = _neighbours(d, D, ring)
        if left is None:
            aux[..., :g].zero_()
        elif left in pos:
            aux[..., :g].copy_(parts[pos[left]][..., -g:], non_blocking=True)
        if right is None:
            aux[..., g:].zero_()
        elif right in pos:
            aux[..., g:].copy_(parts[pos[right]][..., :g], non_blocking=True)
        out.append(aux)
    if mesh.all_local:
        return out
    msgs, landing = [], []
    for b in range(D if ring else D - 1):
        lo, hi = b, (b + 1) % D
        if mesh.owners[lo] == mesh.owners[hi]:
            continue
        if lo in pos:      # my right halo is hi's first g columns
            i = pos[lo]
            buf = parts[i].new_empty(out[i].shape[:-1] + (g,))
            msgs += [(True, mesh.owners[hi],
                      parts[i][..., -g:].contiguous(), 2 * b),
                     (False, mesh.owners[hi], buf, 2 * b + 1)]
            landing.append((out[i][..., g:], buf))
        if hi in pos:      # my left halo is lo's last g columns
            i = pos[hi]
            buf = parts[i].new_empty(out[i].shape[:-1] + (g,))
            msgs += [(True, mesh.owners[lo],
                      parts[i][..., :g].contiguous(), 2 * b + 1),
                     (False, mesh.owners[lo], buf, 2 * b)]
            landing.append((out[i][..., :g], buf))
    _send_recv(msgs)
    for dst, buf in landing:
        dst.copy_(buf)
    return out


def _walls(s: Slabs, ring: bool = False):
    """Per local shard (owns the low x wall, owns the high x wall): the
    first and the last shard, or none along a periodic x (``ring``)."""
    D = s.mesh.size
    return [(d == 0 and not ring, d == D - 1 and not ring)
            for d in s.mesh.local]


# ---------------------------------------------------------------------------
# global reductions: per-shard partials, combined in shard order
# ---------------------------------------------------------------------------

def _combine(partials, mesh: SlabMesh, op=torch.add):
    """The partials of every shard folded by ``op`` in shard order: sums
    in that order on every rank; max, min, and, or exact in any."""
    acc, *rest = all_shards(partials, mesh, kind="reductions")
    for p in rest:
        acc = op(acc, p)
    return acc


def slab_sum(a: Slabs, dtype=None) -> torch.Tensor:
    """Sum of a split field (accumulated in ``dtype``, default its own)."""
    return _combine([torch.sum(p, dtype=dtype) for p in a.parts], a.mesh)


def slab_mean(a: Slabs) -> torch.Tensor:
    """Mean accumulated in f64 (``poisson.project_correct`` takes its
    means so): the f32 value does not hang on the summation order."""
    return (slab_sum(a, torch.float64) / math.prod(a.shape)).to(a.dtype)


def slab_linf(a: Slabs) -> torch.Tensor:
    """max |a|: exact in any order."""
    return _combine([torch.amax(torch.abs(p)) for p in a.parts],
                         a.mesh, torch.maximum)


def slab_all_finite(*fields: Slabs) -> torch.Tensor:
    mesh = fields[0].mesh
    return _combine([torch.isfinite(p).all() for f in fields
                     for p in f.parts], mesh, torch.logical_and)


def slab_member_finite(*fields: Slabs) -> torch.Tensor:
    """Per member of split member stacks [B, ..., w]: every value of every
    field finite ([B] on ``mesh.home``)."""
    return _combine([torch.isfinite(p).flatten(1).all(1)
                     for f in fields for p in f.parts], fields[0].mesh,
                    torch.logical_and)


def slab_reducers(dt_, sum_dtype):
    """``poisson._reducers`` for split fields: (dot, linf, zeros_like),
    dot products accumulated per shard in ``sum_dtype`` (default the
    field dtype) and combined in shard order."""
    sd = sum_dtype or dt_

    def dot(a, c):
        if sd == dt_:
            return _combine([torch.sum(x * y)
                             for x, y in zip(a.parts, c.parts)], a.mesh)
        return _combine([torch.sum(x * y, dtype=sd)
                         for x, y in zip(a.parts, c.parts)],
                        a.mesh).to(dt_)

    return dot, slab_linf, Slabs.zeros_like


# ---------------------------------------------------------------------------
# the split stencils of the step (what GSPMD partitioned in the reference)
# ---------------------------------------------------------------------------

def laplacian5_bc_x(p: Slabs, signs=None,
                    periodic=(False, False)) -> Slabs:
    """``ops.stencil.laplacian5_bc`` of a split field (``signs`` a table's
    (sx_lo, sx_hi, sy_lo, sy_hi) pressure signs; None: all Neumann, i.e.
    ``laplacian5_neumann``): one edge column exchanged, then
    ``laplacian5_bc_slab`` on every shard (the x-wall diagonal on the wall
    shards only). ``periodic`` the table's (px, py): a periodic x
    exchanges on the ring and owns no wall, a periodic y wraps inside
    every slab. GSPMD partitioned the whole-field form's shifted slices
    into the same exchange."""
    signs = NEUMANN_SIGNS if signs is None else signs
    px, py = periodic
    aux = exchange_x(p, 1, px)
    return Slabs([laplacian5_bc_slab(part, aux[d], signs, lo, hi, py)
                  for d, (part, (lo, hi))
                  in enumerate(zip(p.parts, _walls(p, px)))], p.mesh)


def divergence_bc_x(v: Slabs, h, dt, coeffs=None,
                    affine: Slabs = None, periodic=(False, False)) -> Slabs:
    """The obstacle-free pressure RHS (h/2dt) [div(u*) + affine] of a split
    velocity (``UniformGrid.poisson_rhs`` with chi None): one edge column
    of u exchanged, then ``divergence_bc_slab`` with a table's
    ``coeffs`` (bc.divergence_coeffs; None: free-slip) on every shard, the
    x wall terms on the wall shards only; ``affine`` is the table's
    constant term of prescribed wall-normal velocities
    (bc.divergence_affine_bc, split like the field), added scaled as the
    whole-field RHS adds it. ``periodic`` as in ``laplacian5_bc_x``. dt
    is a scalar, or [B, 1, 1] for a member stack [B, 2, Ny, w]."""
    coeffs = FREE_SLIP_COEFFS if coeffs is None else coeffs
    px, py = periodic
    aux = exchange_x(v, 1, px)
    div = Slabs([divergence_bc_slab(part, aux[d], coeffs, lo, hi, py)
                 for d, (part, (lo, hi))
                 in enumerate(zip(v.parts, _walls(v, px)))], v.mesh)
    fac = 0.5 * h / dt
    b = fac * div
    if affine is not None:
        b = b + fac * affine
    return b


def slab_member_sum(a: Slabs, dtype=None) -> torch.Tensor:
    """Per member of a split member stack [B, ..., w]: the sum over every
    axis but the first ([B] on ``mesh.home``), accumulated per shard
    in ``dtype`` (default its own) and combined in shard order."""
    return _combine([torch.sum(p, dim=tuple(range(1, p.dim())),
                               dtype=dtype) for p in a.parts], a.mesh)


def slab_member_reducers(dt_, sum_dtype):
    """``poisson._member_reducers`` for split member stacks [B, ..., w] (a
    fleet on slabs): (dot, linf, zeros_like, where), dot and linf per
    member as [B, 1, ..., 1] on ``mesh.home`` (dots accumulated per
    shard in ``sum_dtype``, default the field dtype, and combined in
    shard order; maxima exact in any order), ``where`` slab by slab where
    a branch is split (a [B, 1, ...] condition moved to each slab's
    device), else ``torch.where``."""
    sd = sum_dtype or dt_

    def keep(p, a):
        return p.reshape(p.shape[:1] + (1,) * (a.dim() - 1))

    def dot(a, c):
        acc = slab_member_sum(a * c, None if sd == dt_ else sd)
        return keep(acc if sd == dt_ else acc.to(dt_), a.parts[0])

    def linf(a):
        return keep(_combine(
            [torch.amax(torch.abs(p), dim=tuple(range(1, p.dim())))
             for p in a.parts], a.mesh, torch.maximum), a.parts[0])

    def zeros_like(a):
        return a.zeros_like() if isinstance(a, Slabs) else torch.zeros_like(a)

    def where(c, a, b):
        ref = a if isinstance(a, Slabs) else b
        if not isinstance(ref, Slabs):
            return torch.where(c, a, b)

        def part(x, d, dev):
            return x.parts[d] if isinstance(x, Slabs) else _scalar_on(x, dev)
        return Slabs([torch.where(_scalar_on(c, p.device),
                                  part(a, d, p.device), part(b, d, p.device))
                      for d, p in enumerate(ref.parts)], ref.mesh)

    return dot, linf, zeros_like, where


def project_correct_x(x: Slabs, pres_old: Slabs, vel: Slabs, h, dt,
                      remove_mean: bool = True, grad_signs=None,
                      periodic=(False, False), members: bool = False):
    """The projection epilogue of ``poisson.project_correct`` on split
    fields, written out as plain per-slab code (the correction kernel has
    no split form, as in the JAX package, whose mesh keeps the XLA
    epilogue): pres = ((x - mean x) + pres_old) - mean pres_old (zero
    means where not ``remove_mean``: a table with an outflow face keeps
    the pressure level), then one edge column of pres exchanged and vel +=
    (pfac grad(pres)) / h^2 with pfac = -dt h / 2, the one-sided wall terms
    signed by the table's ``grad_signs`` (None: Neumann) and on the wall
    shards only in x (``pressure_gradient_update_bc``); ``periodic`` as in
    ``laplacian5_bc_x``. ``members`` (a fleet on slabs: x, pres_old
    [B, Ny, w], vel [B, 2, Ny, w], dt a scalar or [B]): the means per
    member, as ``project_correct(mean_axes=(-2, -1))``. Returns (vel,
    pres)."""
    px, py = periodic
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    n = math.prod(x.shape[-2:])
    if not remove_mean:
        mx = mp = torch.zeros((), dtype=x.dtype, device=x.device)
    elif members:
        mx, mp = ((slab_member_sum(a, torch.float64) / n).to(a.dtype)
                  .reshape(-1, 1, 1) for a in (x, pres_old))
    else:
        mx, mp = slab_mean(x), slab_mean(pres_old)
    pfac = -0.5 * dt * h
    if members:
        pfac = pfac.reshape(-1, 1, 1, 1)
    ih2 = 1.0 / (h * h)
    pres = Slabs([((xp - mx.to(xp.device)) + pp) - mp.to(xp.device)
                  for xp, pp in zip(x.parts, pres_old.parts)], x.mesh)
    aux = exchange_x(pres, 1, px)
    out = []
    for d, (pp, vp, (lo, hi)) in enumerate(zip(pres.parts, vel.parts,
                                               _walls(pres, px))):
        dv = pfac.to(pp.device) * pressure_gradient_slab(pp, aux[d], lo, hi,
                                                         grad_signs, py)
        out.append(vp + dv * ih2)
    return Slabs(out, vel.mesh), pres


def fused_advect_heun_sharded(vel: Slabs, h, nu, dt, bc=None,
                              bf16: bool = False) -> Slabs:
    """Both Heun substages on a split velocity [..., 2, Ny, w] per slab:
    each substage exchanges three edge columns (in the storage dtype),
    then runs the halo-mode substage (``advect_substage_halo``: the kernel
    on the card, its twin on the CPU) on every shard, wall shards painting
    their x ghosts. dt is a scalar or shaped like the leading dims. ``bc``
    a ``BCTable`` (None or free-slip: the free-slip form): every shard
    paints the table's y ghosts over its halo columns too, the parabolic
    profile at its global columns (col0 = d w of the whole width), and its
    x ghosts on the walls it owns; the facs carry the raw dt (the outflow
    speed). A periodic table runs the substage's wrap form: a periodic x
    exchanges on the ring (every shard interior), a periodic y wraps the
    rows inside every slab. ``bf16`` (f32 state only, no periodic table),
    as ``hopper_kernels.fused_advect_heun``: substage 1 reads a bf16 copy
    of every slab and writes bf16, substage 2 reads that and the copy and
    writes the f32 state; both exchange their halos in bf16."""
    if bc is not None and bc.is_free_slip:
        bc = None
    px = bc is not None and periodic_axes(bc)[0]
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
    walls = _walls(vel, px)
    nx_tot = vel.shape[-1]
    col0 = [d * p0.shape[-1] for d in vel.mesh.local]
    v0 = Slabs([p.reshape((L,) + p.shape[-3:]) for p in vel.parts],
               vel.mesh)

    def sub(stage, vold, cfac, out_dtype=None):
        aux = exchange_x(stage, WENO_HALO, px)
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


def _ring(edge_signs) -> bool:
    """A periodic x: the sweep's x sign pair is a periodic axis's (0, 0)
    (``bc.pressure_signs``), so the slabs close into a ring."""
    return edge_signs is not None and _wrap_axes(_signs(edge_signs))[0]


def sweep_slabs(e, r: Slabs, omega: float, from_zero: bool = False,
                edge_signs=None) -> Slabs:
    """One sweep of a split field whose slabs all lie on one device: one
    ``jacobi_halo_sweep_slabs`` launch for every slab (its twin on the
    CPU), each slab reading its neighbours' edge columns in place, so no
    exchange runs (on the ring where ``edge_signs`` make x periodic, y
    wrapped where they make y periodic)."""
    sweep_stats["sweeps"] += 1
    return Slabs(jacobi_halo_sweep_slabs(None if from_zero else e.parts,
                                         r.parts, omega, from_zero,
                                         edge_signs), r.mesh)


def sweep_exchanged(e, r: Slabs, omega: float, from_zero: bool = False,
                    edge_signs=None, fused: bool = True) -> Slabs:
    """One sweep as the JAX package runs it per shard: one edge column
    exchanged (none from zero), then ``jacobi_halo_sweep`` on every slab,
    one launch each (``fused=False``: its plain twin); on the ring, with no
    wall shard, where ``edge_signs`` make x periodic."""
    sweep = jacobi_halo_sweep if fused else jacobi_halo_sweep_plain
    ring = _ring(edge_signs)
    walls = _walls(r, ring)
    if from_zero:
        aux, eparts = [None] * len(r.parts), [None] * len(r.parts)
    else:
        aux, eparts = exchange_x(e, 1, ring), e.parts
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
    where every slab lies on one device of this process (at most
    ``HALO_MAX_SLABS`` of them), ``sweep_slabs``, one launch a sweep; on
    slabs of several devices or ranks ``sweep_exchanged``, an exchange and
    a launch per local slab.
    ``fused=False`` takes the plain twin per slab, as the bf16
    preconditioner cycle takes plain sweeps. ``from_zero`` makes the
    first sweep omega r inv_d. A periodic table's ``edge_signs`` (a (0, 0)
    pair on a periodic axis) close the slabs into a ring along x and wrap
    the rows along y, in both forms."""
    mesh = r.mesh
    one = (mesh.all_local and len(set(mesh.devices)) == 1
           and mesh.size <= HALO_MAX_SLABS)
    for k in range(n):
        fz = from_zero and k == 0
        if fused and one:
            e = sweep_slabs(e, r, omega, fz, edge_signs)
        else:
            e = sweep_exchanged(e, r, omega, fz, edge_signs, fused)
    return e


def level_meshes(shapes, mesh: SlabMesh) -> list:
    """The mesh of every multigrid level (finest first): ``mesh`` while
    the level stays split, else the one-device mesh of ``mesh.home``
    (under a world every rank gathers the level and sweeps it whole,
    the same bits on every rank). A level stays split while the finer level's slab
    width is even (so the 2x2 restriction and the repeat prolongation
    stay local to a slab) and its own slab is at least
    ``MIN_SPLIT_WIDTH`` columns wide. Narrower levels gather: there a
    sweep is a few hundred cells per slab, and D launches plus an
    exchange per sweep cost more than the sweep. Every transfer is
    pointwise, so either form gives the solo cycle's values bit for
    bit. Along a periodic x the ring holds on every level: a gathered
    level is one slab whose neighbour on either side is itself, and 2x
    coarsening keeps a slab edge on a slab edge."""
    D = mesh.size
    ny0, nx0 = shapes[0]
    if nx0 % D:
        raise ValueError(f"Nx={nx0} not divisible by the mesh size {D}")
    one = SlabMesh([mesh.home]) if D > 1 else mesh
    out = [mesh]
    split = True
    for lvl in range(1, len(shapes)):
        w_prev = shapes[lvl - 1][1] // D
        split = (split and w_prev % 2 == 0
                 and shapes[lvl][1] // D >= MIN_SPLIT_WIDTH)
        out.append(mesh if split else one)
    return out


# ---------------------------------------------------------------------------
# The forest on a mesh: contiguous SFC block ranges per device
# (the forest half of cup2d_tpu/parallel/shard_halo.py, :67-484, :750-1084)
# ---------------------------------------------------------------------------
# Device d owns the ordered blocks [dB, (d+1)B) of the padded block axis
# (B = n_pad / D). A gather source of device d's rows lives in the index
# space [its own B blocks ++ the surface blocks it receives]; a scatter
# destination is a cell of its own B labs, or one trailing scratch cell
# where the pad rows write zeros. The surface exchange plan is the JAX
# package's: per nonzero shard offset, each sender packs the own blocks
# that offset's consumer reads, and the receiver appends them in offset
# order ("ppermute", one copy per sending pair), or every device receives
# every owner's surface set ("allgather"). Between shards of one process a
# "send" is an index_select on the sender's device and a copy to the
# receiver's (none where the shards share a device); between ranks the
# packed sets travel by point-to-point messages, one batch a call
# ("ppermute"), or by one all-gather ("allgather").

_FULL_SUM = {torch.sum, torch.Tensor.sum}
_FULL_MAX = {torch.amax, torch.Tensor.amax, torch.max, torch.Tensor.max}
_FULL_MIN = {torch.amin, torch.Tensor.amin, torch.min, torch.Tensor.min}
_FULL_ALL = {torch.all, torch.Tensor.all}
_FULL_ANY = {torch.any, torch.Tensor.any}
_REDUCTIONS = _FULL_SUM | _FULL_MAX | _FULL_MIN | _FULL_ALL | _FULL_ANY
# reductions with no combined form (refused without ``dim``) and host
# reads or writes with no per-shard meaning (always refused)
_NO_COMBINE = {torch.mean, torch.Tensor.mean, torch.prod, torch.Tensor.prod,
               torch.norm, torch.Tensor.norm, torch.argmax,
               torch.Tensor.argmax, torch.argmin, torch.Tensor.argmin}
_REFUSED = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
            torch.Tensor.__setitem__}
# ops that take a dim (its position among the arguments, its default) and
# along the block axis would select, move or combine one shard's blocks
# only: refused there
_ALONG = {}
for _fns, _pos, _default in (
        ((torch.cat, torch.concat, torch.concatenate), 1, 0),
        ((torch.index_select, torch.Tensor.index_select, torch.gather,
          torch.Tensor.gather, torch.narrow, torch.Tensor.narrow,
          torch.flip, torch.Tensor.flip, torch.cumsum, torch.Tensor.cumsum,
          torch.index_add, torch.Tensor.index_add, torch.index_copy,
          torch.Tensor.index_copy, torch.index_fill, torch.Tensor.index_fill,
          torch.scatter, torch.Tensor.scatter, torch.scatter_add,
          torch.Tensor.scatter_add, torch.unbind, torch.Tensor.unbind), 1,
         0),
        ((torch.split, torch.Tensor.split, torch.chunk, torch.Tensor.chunk,
          torch.take_along_dim, torch.Tensor.take_along_dim), 2, 0),
        # roll without dims rolls the flattened tensor
        ((torch.roll, torch.Tensor.roll), 2, None)):
    for _f in _fns:
        _ALONG[_f] = (_pos, _default)
# reshapes: refused where no dim of the result keeps the block axis
_RESHAPES = {torch.reshape, torch.Tensor.reshape, torch.Tensor.view,
             torch.flatten, torch.Tensor.flatten, torch.ravel,
             torch.Tensor.ravel, torch.Tensor.reshape_as,
             torch.Tensor.view_as}
_NEW_DIM = {torch.stack, torch.unsqueeze, torch.Tensor.unsqueeze}
_SWAPS = {torch.transpose, torch.Tensor.transpose, torch.swapaxes,
          torch.Tensor.swapaxes, torch.swapdims, torch.Tensor.swapdims}
_PERMUTES = {torch.permute, torch.Tensor.permute}


def _part_of(obj, i: int, dev: torch.device):
    """Argument ``obj`` as local shard i sees it: its part for ``Blocks``,
    a plain tensor on that shard's device, sequences element by
    element."""
    if isinstance(obj, Blocks):
        return obj.parts[i]
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev, non_blocking=True)
    if type(obj) in (list, tuple):
        return type(obj)(_part_of(o, i, dev) for o in obj)
    return obj


def _wrap(outs, mesh, axis=0):
    o0 = outs[0]
    if isinstance(o0, torch.Tensor):
        return Blocks(outs, mesh, axis)
    if isinstance(o0, tuple):
        return tuple(Blocks([o[i] for o in outs], mesh, axis)
                     for i in range(len(o0)))
    raise TypeError(f"a per-shard call returned {type(o0).__name__}, not a "
                    "tensor: no per-shard meaning")


def _per_part(fn, args, kwargs, mesh) -> list:
    """``fn`` once per local shard, on each shard's view of the
    arguments."""
    return [fn(*_part_of(args, i, dev),
               **{k: _part_of(v, i, dev) for k, v in kwargs.items()})
            for i, dev in enumerate(mesh.local_devices)]


def per_shard(fn, *args, **kwargs):
    """``fn`` once per local shard when an argument is ``Blocks`` (each
    call sees its shard's part and every plain tensor on that shard's device),
    else once. The form for the hand kernels' wrappers, which launch once
    a call."""
    first = _first_blocks((args, tuple(kwargs.values())))
    if first is None:
        return fn(*args, **kwargs)
    outs = _per_part(fn, args, kwargs, first.mesh)
    return _wrap(outs, first.mesh,
                 _axis_after(fn, args, kwargs, first, outs[0]))


def _dims(d, ndim: int):
    """A dim argument as a set of non-negative dims, or None where it is
    not one (absent, a dtype, a tensor)."""
    if isinstance(d, int) and not isinstance(d, bool):
        return {d % ndim}
    if (isinstance(d, (tuple, list)) and d
            and all(isinstance(x, int) for x in d)):
        return {x % ndim for x in d}
    return None


def _reduce_dims(args, kwargs, ndim: int):
    """The dims a reduction reduces, or None for a full reduction."""
    dim = kwargs.get("dim")
    if dim is None and len(args) > 1:
        dim = args[1]
    return _dims(dim, ndim)


def _full_reduction(func, args, kwargs) -> bool:
    if len(args) > 1 and isinstance(args[1], (torch.Tensor, Blocks)):
        return False                  # max(a, b): elementwise
    return _reduce_dims(args, kwargs, max(args[0].dim(), 1)) is None


def _first_blocks(objs):
    """The first ``Blocks`` among ``objs`` (sequences searched) whose block
    axis is known, else the first at all, else None."""
    found = []

    def walk(o):
        if isinstance(o, Blocks):
            found.append(o)
        elif type(o) in (list, tuple):
            for x in o:
                walk(x)
    walk(objs)
    return next((b for b in found if b.axis is not None),
                found[0] if found else None)


def _refuse(func, why: str):
    raise TypeError(f"{getattr(func, '__name__', func)} {why} of split "
                    "blocks: it would act on one shard's blocks only; "
                    "gather first")


def _index_axis(idx, ax: int, nd: int):
    """The block axis of ``x[idx]`` for an ``x`` whose block axis is
    ``ax``; refused where ``idx`` selects along it. None where advanced
    indexing places the result's dims."""
    if not isinstance(idx, tuple):
        idx = (idx,)

    def width(i):
        if i is None or i is Ellipsis:
            return 0
        if (isinstance(i, (torch.Tensor, Blocks))
                and i.dtype == torch.bool):
            return i.dim()
        return 1
    used = sum(width(i) for i in idx)
    at, out = 0, 0
    for i in idx:
        if i is Ellipsis:
            k = nd - used
            if at <= ax < at + k:
                return out + ax - at
            at += k
            out += k
            continue
        if i is None:
            out += 1
            continue
        w = width(i)
        if at <= ax < at + w:
            if isinstance(i, slice) and i == slice(None):
                return out
            _refuse(torch.Tensor.__getitem__, "along the block axis")
        if isinstance(i, slice):
            out += 1
        elif not isinstance(i, int):
            return None
        at += w
    return out + ax - at


def _axis_after(func, args, kwargs, first, out):
    """The block axis of ``func``'s per-shard result ``out`` (a part),
    given the block axis of its first split argument ``first``; refuses
    ops that act along that axis. None where it cannot be told."""
    ax = first.axis
    if ax is None:
        return None
    nd = first.dim()
    B = first.parts[0].shape[ax]
    dims = ((func in _REDUCTIONS or func in _NO_COMBINE)
            and not isinstance(args[1] if len(args) > 1 else None,
                               (torch.Tensor, Blocks))
            and _reduce_dims(args, kwargs, nd))
    if dims:
        if ax in dims:
            _refuse(func, "along the block axis")
        keep = kwargs.get("keepdim", len(args) > 2 and args[2] is True)
        return ax if keep else ax - sum(d < ax for d in dims)
    if func in _ALONG:
        pos, default = _ALONG[func]
        d = kwargs.get("dim", kwargs.get(
            "dims", args[pos] if len(args) > pos else default))
        if d is None:
            _refuse(func, "over the flattened blocks")
        if ax in _dims(d, nd):
            _refuse(func, "along the block axis")
    elif func in _NEW_DIM:
        d = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return ax + 1 if d % (nd + 1) <= ax else ax
    elif func in _SWAPS:
        d0, d1 = (x % nd for x in (tuple(args[1:3]) or (kwargs["dim0"],
                                                         kwargs["dim1"])))
        return d1 if ax == d0 else d0 if ax == d1 else ax
    elif func in _PERMUTES:
        order = args[1] if len(args) == 2 else args[1:]
        order = list(kwargs.get("dims", order))
        return [x % nd for x in order].index(ax)
    elif func is torch.Tensor.__getitem__:
        return _index_axis(args[1], ax, nd)
    part = out[0] if isinstance(out, tuple) else out
    if not isinstance(part, torch.Tensor):
        return None
    # elementwise and broadcasting ops keep the axis counted from the
    # right; otherwise the one dim of the block count, if it is one
    shape = part.shape
    right = part.dim() - (nd - ax)
    if 0 <= right < part.dim() and shape[right] == B:
        return right
    hits = [i for i, n in enumerate(shape) if n == B]
    if len(hits) == 1:
        return hits[0]
    if func in _RESHAPES and not hits:
        _refuse(func, "merging the block axis")
    return None


class Blocks:
    """A tensor of the forest's ordered block layout split over a mesh:
    ``parts[i]``, on the device of shard d = ``mesh.local[i]``, holds the
    ordered blocks [dB, (d+1)B) (every part the same shape; under a world
    only this rank's shards have parts). Any torch function or tensor
    method applied to it runs once per shard (``__torch_function__``),
    with plain tensors moved to each shard's device, so the forest's
    block-local step code runs unchanged on split operands; ``shape`` is
    the per-shard shape. A full reduction lands on ``mesh.home``, where
    every scalar of a step lives (on every rank, from an all-gather of
    the partials under a world): ``amax``/``max``, ``amin``/``min``,
    ``all`` and ``any`` without ``dim`` combine the shards' partials (exact
    in any order). ``sum`` without ``dim`` refuses: the forest's full sums
    go through ``block_sum``, whose group partials each shard computes on
    its own and whose order is the solo forest's, so that a split sum is
    the unsplit one bit for bit (a sum of per-shard partials in shard
    order would part the forest's stalled startup solves from the unsplit
    run's: they amplify a last-bit difference into an O(1) one within 14
    canonical steps). ``axis`` is the block axis of each part (0 for the
    ordered layout, 1 for a stack of per-shape fields), followed through
    every op: an op that acts along it (a reduction or ``cat`` over it, an
    index, ``index_select``, ``gather`` or ``narrow`` on it, a reshape that
    merges it) would see one shard's blocks only and raises
    ``TypeError``; None where an op's result cannot tell (no check then).
    Cross-block reads go through ``ShardTables``, ``ShardPoissonOp``,
    ``ShardFluxCorr`` or ``gather_blocks``."""

    __slots__ = ("parts", "mesh", "axis")
    __hash__ = None

    def __init__(self, parts, mesh: SlabMesh, axis: Optional[int] = 0):
        self.parts = list(parts)
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _REFUSED or (func in _NO_COMBINE
                                and _full_reduction(func, args, kwargs)):
            raise TypeError(f"{getattr(func, '__name__', func)} on split "
                            "blocks has no per-shard form: gather first")
        full = func in _REDUCTIONS and _full_reduction(func, args, kwargs)
        if full and func in _FULL_SUM:
            raise TypeError(
                "a full sum of split blocks has no per-shard form of the "
                "solo run's order: use parallel.shard_halo.block_sum (the "
                "forest's group partials), or gather first")
        first = _first_blocks((args, tuple(kwargs.values())))
        mesh = first.mesh
        outs = _per_part(func, args, kwargs, mesh)
        if not full:
            return _wrap(outs, mesh,
                         _axis_after(func, args, kwargs, first, outs[0]))
        # max, min, all, any: exact in any order
        op = (torch.maximum if func in _FULL_MAX else
              torch.minimum if func in _FULL_MIN else
              torch.logical_and if func in _FULL_ALL else torch.logical_or)
        return _combine(outs, mesh, op)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        attr = getattr(torch.Tensor, name)
        if callable(attr):
            return lambda *a, **k: Blocks.__torch_function__(
                attr, (Blocks,), (self,) + a, k)
        return _wrap([getattr(p, name) for p in self.parts], self.mesh,
                     None)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    def dim(self) -> int:
        return self.parts[0].dim()

    def __bool__(self):
        raise TypeError("the truth value of split blocks is ambiguous")

    def __repr__(self) -> str:
        return (f"Blocks({self.mesh.size} x {tuple(self.shape)}, "
                f"{self.dtype})")


def _binop(name):
    op = getattr(torch.Tensor, name)

    def method(self, *other):
        return Blocks.__torch_function__(op, (Blocks,), (self,) + other)
    method.__name__ = name
    return method


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
              "__matmul__", "__neg__", "__abs__", "__invert__", "__and__",
              "__or__", "__gt__", "__ge__", "__lt__", "__le__", "__eq__",
              "__ne__", "__getitem__"):
    setattr(Blocks, _name, _binop(_name))


def split_blocks(x: torch.Tensor, mesh: SlabMesh) -> Blocks:
    """Split an ordered [n_pad, ...] tensor into ``mesh.size`` contiguous
    block ranges and keep this process's, each on its device (a view
    where it already lies there)."""
    n = x.shape[0]
    D = mesh.size
    if n % D:
        raise ValueError(f"{n} blocks not divisible by the mesh size {D}")
    B = n // D
    return Blocks([x[d * B:(d + 1) * B].to(mesh.devices[d]).contiguous()
                   for d in mesh.local], mesh)


def gather_blocks(b: Blocks, device=None, kind: str = "state"
                  ) -> torch.Tensor:
    """The whole ordered tensor of split blocks, joined along their block
    axis, on ``device`` (default ``mesh.home``); an all-gather (of
    ``kind``) under a world."""
    if b.axis is None:
        raise TypeError("split blocks whose block axis is unknown: gather "
                        "them before the op that hid it")
    return torch.cat(all_shards(b.parts, b.mesh, device, kind), dim=b.axis)


# ordered blocks per reduction group: 1,024 cells at BS 8; n_pad (a power
# of two, at least 128) over D <= 8 shards gives whole groups per shard
GROUP_BLOCKS = 16


def _group_partials(a, c, acc, axis: int) -> torch.Tensor:
    """The [P, G] group partials of one local tensor whose block axis
    ``axis`` holds G whole groups (P the product of the dims before it):
    each group's values (with c: its products) summed by ``group_sum``'s
    tree in ``acc``."""
    if c is not None:
        a, c = torch.broadcast_tensors(a, c)
    shape = a.shape
    n = shape[axis]
    if n % GROUP_BLOCKS:
        raise ValueError(f"{n} blocks along axis {axis}: a full forest "
                         f"reduction takes whole groups of {GROUP_BLOCKS}")
    P = math.prod(shape[:axis])
    G = n // GROUP_BLOCKS
    rows = (P * G, GROUP_BLOCKS * math.prod(shape[axis + 1:]))
    a = a.contiguous().reshape(rows)
    if c is not None:
        c = c.contiguous().reshape(rows)
    return group_sum(a, c, acc).reshape(P, G)


def block_sum(a, c=None, dtype=None, axis: int = 0):
    """The full sum of a forest operand over its ordered blocks (with
    ``c``, of the products a * c, each rounded in a's dtype), accumulated
    in ``dtype`` (default a's): the partials of the groups of
    ``GROUP_BLOCKS`` consecutive blocks (``group_sum``: one fixed tree a
    group), then one ``torch.sum`` of them, in block order, on the home
    device. Split ``Blocks`` compute their own groups' partials on their
    devices, and only the partial vectors are gathered (one all-gather
    under a world, P x n_pad / 16 values), so a split forest adds the solo
    forest's terms in its order, bit for bit, and every rank holds the
    same bits. ``axis`` is a plain tensor's block axis (``Blocks`` know
    theirs). The one form of every full reduction of the forest: the
    solves' dots, the projection's means, the energy, the obstacle and
    force integrals."""
    b = a if isinstance(a, Blocks) else c if isinstance(c, Blocks) else None
    acc = dtype or a.dtype
    if b is None:
        return torch.sum(_group_partials(a, c, acc, axis))
    if b.axis is None:
        raise TypeError("split blocks whose block axis is unknown: a full "
                        "sum needs it")
    ax = b.axis
    parts = _per_part(lambda x, y=None: _group_partials(x, y, acc, ax),
                      (a,) if c is None else (a, c), {}, b.mesh)
    return torch.sum(torch.cat(all_shards(parts, b.mesh, kind="reductions"),
                               dim=1))


def block_reducers(dt_, sum_dtype):
    """``poisson._reducers`` of the forest's ordered blocks, split or
    whole: (dot, linf, zeros_like). A dot is ``block_sum``'s dot form in
    ``sum_dtype`` (default the field dtype), cast back to the field dtype;
    linf combines the shards' maxima. The solo and the split forest take
    the same dots bit for bit."""
    def dot(a, c):
        return block_sum(a, c, sum_dtype or dt_).to(dt_)

    def linf(a):
        return torch.amax(torch.abs(a))

    return dot, linf, torch.zeros_like


def _pad_bucket(n: int, lo: int) -> int:
    return max(lo, 1 << max(0, (n - 1)).bit_length())


def _build_exchange_plan(remote_by_d, D: int, B: int, n_pad: int,
                         mode: str):
    """The surface exchange plan from each consumer's remote-block set
    (``cup2d_tpu/parallel/shard_halo.py:140-199``): (offsets, S, pack,
    perms, g2surf). ``pack`` holds one [D, S_o] own-block index array per
    offset (one [D, S] array under "allgather"), ``perms`` per offset the
    (sender, receiver) pairs that send, and g2surf[d, gblk] the position
    of remote block gblk in consumer d's received surface (-1 if not
    received). Buckets are per offset; ``S`` is the largest. Shared by the
    halo gather, the flux-correction deposits and the structured Poisson
    operator, so their plans cannot drift."""
    if mode == "allgather":
        surf_lists: list = [[] for _ in range(D)]
        surf_pos: dict = {}
        for d in range(D):
            for gblk in remote_by_d[d].tolist():
                if gblk not in surf_pos:
                    surf_pos[gblk] = len(surf_lists[gblk // B])
                    surf_lists[gblk // B].append(gblk)
        S = _pad_bucket(max((len(x) for x in surf_lists), default=1), 4)
        pack0 = np.zeros((D, S), np.int32)
        for e, lst in enumerate(surf_lists):
            pack0[e, :len(lst)] = np.asarray(lst, np.int64) - e * B
        g2surf = np.full((D, n_pad), -1, np.int64)
        for gblk, p in surf_pos.items():
            g2surf[:, gblk] = (gblk // B) * S + p
        return (), S, (pack0,), (), g2surf
    send: dict = {}
    for d in range(D):
        for gblk in remote_by_d[d].tolist():
            e = gblk // B
            send.setdefault((e, d - e), []).append(gblk)
    offsets = tuple(sorted({o for (_, o) in send}))
    S_per = [_pad_bucket(max((len(v) for (e, o), v in send.items()
                              if o == off), default=1), 4)
             for off in offsets]
    off_base = np.concatenate([[0], np.cumsum(S_per)]).astype(np.int64)
    pack = tuple(np.zeros((D, s), np.int32) for s in S_per)
    senders = tuple(tuple(sorted(e for (e, o) in send if o == off))
                    for off in offsets)
    g2surf = np.full((D, n_pad), -1, np.int64)
    for (e, o), lst in send.items():
        oi = offsets.index(o)
        pack[oi][e, :len(lst)] = np.asarray(lst, np.int64) - e * B
        for p, gblk in enumerate(lst):
            g2surf[e + o, gblk] = off_base[oi] + p
    perms = tuple(tuple((e, e + offsets[oi]) for e in srcs)
                  for oi, srcs in enumerate(senders))
    return offsets, max(S_per, default=0), pack, perms, g2surf


def _halo_remote_by_d(t, n_pad: int, D: int):
    """Each consumer device's remote-block demand of a halo table set
    (zero-weight K-padding entries create none), and the derived row and
    device arrays: (remote_by_d, zmask, dev_s, dev_g, src_blk, idx_blk).
    The one derivation behind ``shard_tables`` and
    ``exchange_padding_stats``."""
    B = n_pad // D
    bs = t.L - 2 * t.g
    bs2 = bs * bs
    LL = t.L * t.L
    src = np.asarray(t.src_ord, np.int64)
    idx = np.asarray(t.idx_ord, np.int64)
    zmask = (np.asarray(t.w) == 0).all(axis=2)
    dev_s = (np.asarray(t.dest_s, np.int64) // LL) // B
    dev_g = (np.asarray(t.dest, np.int64) // LL) // B
    src_blk = src // bs2
    idx_blk = idx // bs2
    remote_by_d = []
    for d in range(D):
        ref = np.concatenate([
            src_blk[dev_s == d],
            idx_blk[dev_g == d][~zmask[dev_g == d]],
        ])
        remote_by_d.append(
            np.unique(ref[(ref < d * B) | (ref >= (d + 1) * B)]))
    return remote_by_d, zmask, dev_s, dev_g, src_blk, idx_blk


def _index(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=dev)


def _pack_parts(pack, mesh: SlabMesh) -> list:
    """Per shard e, its send index tensors (one per offset) on e's device;
    None for another rank's shard."""
    return [None if dev is None else [_index(p[e], dev) for p in pack]
            for e, dev in enumerate(mesh.devices)]


def _exchange_surface(parts, t) -> list:
    """The surface exchange of one split operand (``parts[i]`` [B, ...] of
    local shard ``mesh.local[i]``, on its device): per local receiver the
    received surface blocks [R, ...] on its device, to append after its
    own B blocks. "ppermute": per offset, the pairs that send copy their
    packed blocks (a message between ranks, in the plan's global order,
    one batch a call); a receiver outside an offset's pairs gets zeros in
    that slot. "allgather": every owner's packed surface set, in owner
    order (one all-gather under a world)."""
    mesh = t.mesh
    pos = {d: i for i, d in enumerate(mesh.local)}
    tail = parts[0].shape[1:]
    if t.mode == "allgather":
        bufs = [parts[i].index_select(0, t.pack_dev[e][0])
                for i, e in enumerate(mesh.local)]
        whole = torch.cat(all_shards(bufs, mesh, kind="surface"))
        return [whole.to(mesh.devices[d]) for d in mesh.local]
    chunks = [[] for _ in mesh.local]
    msgs, tag = [], 0
    for oi, off in enumerate(t.offsets):
        size = t.pack[oi].shape[1]
        tags = {}
        for e, r in t.perms[oi]:
            tags[e] = tag
            tag += 1
            if e in pos and r not in pos:
                msgs.append((True, mesh.owners[r], parts[pos[e]]
                             .index_select(0, t.pack_dev[e][oi]), tags[e]))
        for i, d in enumerate(mesh.local):
            e = d - off
            if e not in tags:
                chunks[i].append(parts[i].new_zeros((size,) + tail))
            elif e in pos:
                buf = parts[pos[e]].index_select(0, t.pack_dev[e][oi])
                chunks[i].append(buf.to(mesh.devices[d]))
            else:
                buf = parts[i].new_empty((size,) + tail)
                msgs.append((False, mesh.owners[e], buf, tags[e]))
                chunks[i].append(buf)
    _send_recv(msgs)
    return [torch.cat(c) if c else parts[i].new_zeros((0,) + tail)
            for i, c in enumerate(chunks)]


class _LabRows(NamedTuple):
    """One device's halo rows on its device (lab destinations split into
    (block, cell); block B is the scratch block)."""

    src_l: torch.Tensor
    sign_l: torch.Tensor
    sl_blk: torch.Tensor
    sl_cell: torch.Tensor
    idx_l: torch.Tensor
    w_l: torch.Tensor        # [dim, G, K]
    gl_blk: torch.Tensor
    gl_cell: torch.Tensor
    src_r: torch.Tensor
    sign_r: torch.Tensor
    sr_blk: torch.Tensor
    sr_cell: torch.Tensor
    idx_r: torch.Tensor
    w_r: torch.Tensor
    gr_blk: torch.Tensor
    gr_cell: torch.Tensor
    fc_nb: torch.Tensor      # [n_regions, B]
    fc_mask: torch.Tensor


class ShardTables(NamedTuple):
    """Per-device halo tables (``cup2d_tpu/parallel/shard_halo.py:67-137``):
    the host leaves are the JAX package's, stacked [D, ...] (numpy);
    ``rows`` holds each device's rows as tensors on its device and
    ``pack_dev`` each device's send indices. Rows are split by surface
    dependence: the ``_l`` sets read only the device's own blocks, the
    ``_r`` sets at least one received block. With the face-copy structure
    (``fc_nb``/``fc_mask``), same-level strips whose neighbour lives on the
    same shard are painted by block-row writes, and their rows are
    filtered out of the tables (``halo.filter_face_rows``); faces whose
    neighbour lies on another shard keep their gather rows."""

    pack: tuple
    src_l: np.ndarray
    sign_l: np.ndarray
    dest_sl: np.ndarray
    idx_l: np.ndarray
    w_l: np.ndarray
    dest_l: np.ndarray
    src_r: np.ndarray
    sign_r: np.ndarray
    dest_sr: np.ndarray
    idx_r: np.ndarray
    w_r: np.ndarray
    dest_r: np.ndarray
    fc_nb: np.ndarray
    fc_mask: np.ndarray
    mesh: SlabMesh
    B: int
    S: int
    L: int
    g: int
    dim: int
    offsets: tuple
    mode: str
    n_regions: int
    perms: tuple
    rows: tuple
    pack_dev: list

    def assemble(self, x: Blocks) -> Blocks:
        return _assemble_sharded(x, self)


def shard_tables(t, n_pad: int, mesh: SlabMesh, dtype,
                 mode: str = "ppermute", fc=None,
                 corners: bool = True) -> ShardTables:
    """Split (unpadded, host) ``HaloTables`` into per-device rows behind a
    surface exchange plan (``cup2d_tpu/parallel/shard_halo.py:236-389``).
    ``n_pad`` must divide by the mesh size. ``fc`` = (nb, mask) from
    ``halo.build_face_copy`` turns on the shard-local face-copy paint for
    pairs of blocks on one shard; ``corners`` as the set's
    tensoriality. ``dtype`` is the field dtype of the device rows."""
    D = mesh.size
    if n_pad % D:
        raise ValueError(f"n_pad {n_pad} not divisible by the mesh size {D}")
    B = n_pad // D
    L, g, dim = t.L, t.g, t.dim
    bs = L - 2 * g
    bs2 = bs * bs
    LL = L * L

    n_regions = 0
    if fc is not None:
        nb_g, mask_g = np.asarray(fc[0]), np.asarray(fc[1])
        n_regions = 8 if corners else 4
        # paint only pairs whose blocks share a shard; masked-out nb
        # entries are gathered then zeroed, so 0 is a safe index
        own_dev = np.arange(n_pad, dtype=np.int64) // B
        same_shard = (nb_g.astype(np.int64) // B) == own_dev[None, :]
        mask_loc = np.where(same_shard, mask_g, 0)
        t = filter_face_rows(t, mask_loc, corners)
        fc_nb_ = np.where(mask_loc > 0, nb_g - (own_dev * B)[None, :],
                          0).astype(np.int32)
        fc_nb_ = fc_nb_[:n_regions].T.reshape(D, B, n_regions) \
            .transpose(0, 2, 1).copy()
        fc_mask_ = mask_loc[:n_regions].T.reshape(D, B, n_regions) \
            .transpose(0, 2, 1).copy()
    else:
        fdt = np.asarray(t.sign).dtype
        fc_nb_ = np.zeros((D, 0, B), np.int32)
        fc_mask_ = np.zeros((D, 0, B), fdt)

    dest_s = np.asarray(t.dest_s, np.int64)
    src = np.asarray(t.src_ord, np.int64)
    sign = np.asarray(t.sign)
    dest = np.asarray(t.dest, np.int64)
    idx = np.asarray(t.idx_ord, np.int64)
    w = np.asarray(t.w)
    K = idx.shape[1]

    (remote_by_d, zmask, dev_s, dev_g,
     src_blk, idx_blk) = _halo_remote_by_d(t, n_pad, D)
    offsets, S, pack, perms, g2surf = _build_exchange_plan(
        remote_by_d, D, B, n_pad, mode)

    def remap_cells(cells, d, dead_local=None):
        blk = cells // bs2
        off = cells % bs2
        local = (blk >= d * B) & (blk < (d + 1) * B)
        sidx = g2surf[d, np.clip(blk, 0, n_pad - 1)]
        out = np.where(local, (blk - d * B) * bs2 + off,
                       (B + sidx) * bs2 + off)
        bad = (~local) & (sidx < 0)
        if dead_local is not None:
            out = np.where(dead_local, 0, out)
            bad &= ~dead_local
        if bad.any():
            raise AssertionError("gather source missing from surface set")
        return out

    # a row is local iff every live gather source is an own block
    def local_s(rows, d):
        blk = src_blk[rows]
        return (blk >= d * B) & (blk < (d + 1) * B)

    def local_g(rows, d):
        blk = idx_blk[rows]
        own = (blk >= d * B) & (blk < (d + 1) * B)
        return (own | zmask[rows]).all(axis=1)

    rs_by_d = [np.nonzero(dev_s == d)[0] for d in range(D)]
    rg_by_d = [np.nonzero(dev_g == d)[0] for d in range(D)]
    rs_l = [r[local_s(r, d)] for d, r in enumerate(rs_by_d)]
    rs_r = [r[~local_s(r, d)] for d, r in enumerate(rs_by_d)]
    rg_l = [r[local_g(r, d)] for d, r in enumerate(rg_by_d)]
    rg_r = [r[~local_g(r, d)] for d, r in enumerate(rg_by_d)]

    scratch = B * LL
    fdt = sign.dtype

    def pack_rows(rows_by_d, kind):
        G = _pad_bucket(max(len(r) for r in rows_by_d), 4)
        pk_src = np.zeros((D, G) + ((K,) if kind == "g" else ()), np.int32)
        pk_wgt = np.zeros((D, G) + ((K, dim) if kind == "g" else (dim,)),
                          fdt)
        pk_dst = np.full((D, G), scratch, np.int32)
        for d, r in enumerate(rows_by_d):
            n = len(r)
            if kind == "s":
                pk_src[d, :n] = remap_cells(src[r], d)
                pk_wgt[d, :n] = sign[r]
                pk_dst[d, :n] = dest_s[r] - d * B * LL
            else:
                pk_src[d, :n] = remap_cells(
                    idx[r], d, dead_local=zmask[r]).reshape(n, K)
                pk_wgt[d, :n] = w[r]
                pk_dst[d, :n] = dest[r] - d * B * LL
        return pk_src, pk_wgt, pk_dst

    src_l_, sign_l_, dest_sl_ = pack_rows(rs_l, "s")
    src_r_, sign_r_, dest_sr_ = pack_rows(rs_r, "s")
    idx_l_, w_l_, dest_l_ = pack_rows(rg_l, "g")
    idx_r_, w_r_, dest_r_ = pack_rows(rg_r, "g")

    def fl(a, dev):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    # the device rows pad K as halo.pad_tables does, so that a shard's
    # weighted sums add the same terms in the same order as the whole
    # table's
    kp = max(4, 1 << max(0, K - 1).bit_length())

    def padk(a):
        out = np.zeros(a.shape[:2] + (kp,) + a.shape[3:], a.dtype)
        out[:, :, :K] = a
        return out

    idx_lp, w_lp, idx_rp, w_rp = (padk(a) for a in (idx_l_, w_l_, idx_r_,
                                                     w_r_))
    rows = []
    for d, dev in enumerate(mesh.devices):
        if dev is None:          # another rank's shard
            rows.append(None)
            continue

        def split(dst):
            dst = np.asarray(dst[d], np.int64)
            return _index(dst // LL, dev), _index(dst % LL, dev)
        sl = split(dest_sl_)
        gl = split(dest_l_)
        sr = split(dest_sr_)
        gr = split(dest_r_)
        rows.append(_LabRows(
            _index(src_l_[d], dev), fl(sign_l_[d], dev), *sl,
            _index(idx_lp[d], dev),
            fl(np.ascontiguousarray(np.moveaxis(w_lp[d], -1, 0)), dev), *gl,
            _index(src_r_[d], dev), fl(sign_r_[d], dev), *sr,
            _index(idx_rp[d], dev),
            fl(np.ascontiguousarray(np.moveaxis(w_rp[d], -1, 0)), dev), *gr,
            _index(fc_nb_[d], dev), fl(fc_mask_[d], dev)))

    return ShardTables(
        pack=pack,
        src_l=src_l_, sign_l=sign_l_, dest_sl=dest_sl_,
        idx_l=idx_l_, w_l=w_l_, dest_l=dest_l_,
        src_r=src_r_, sign_r=sign_r_, dest_sr=dest_sr_,
        idx_r=idx_r_, w_r=w_r_, dest_r=dest_r_,
        fc_nb=fc_nb_, fc_mask=fc_mask_,
        mesh=mesh, B=B, S=S, L=L, g=g, dim=dim,
        offsets=offsets, mode=mode, n_regions=n_regions, perms=perms,
        rows=tuple(rows), pack_dev=_pack_parts(pack, mesh))


def _assemble_sharded(x: Blocks, t: ShardTables) -> Blocks:
    """[n_pad, dim, BS, BS] split blocks -> their [.., dim, L, L] labs,
    per shard (``cup2d_tpu/parallel/shard_halo.py:424-481``): the surface
    exchange first, then the lab interiors, the shard-local face-copy
    paint and the local rows, which read the shard's own blocks only, then
    the rows that read the received surface."""
    B, L, g, dim = t.B, t.L, t.g, t.dim
    bs = L - 2 * g
    recvs = _exchange_surface(x.parts, t)
    out = []
    for i, (d, x_loc) in enumerate(zip(x.mesh.local, x.parts)):
        rw = t.rows[d]
        flat_l = x_loc.transpose(0, 1).reshape(dim, -1)
        simple_l = flat_l[:, rw.src_l].T * rw.sign_l
        general_l = _weighted(flat_l, rw.idx_l, rw.w_l)
        labs = x_loc.new_zeros((B + 1, dim, L, L))     # + scratch block
        labs[:B, :, g:g + bs, g:g + bs] = x_loc
        if t.n_regions:
            _paint_regions(x_loc, labs[:B], rw.fc_nb, rw.fc_mask, g, bs,
                           t.n_regions == 8)
        lf = labs.view(B + 1, dim, L * L)
        lf[rw.sl_blk, :, rw.sl_cell] = simple_l
        lf[rw.gl_blk, :, rw.gl_cell] = general_l
        blocks = torch.cat([x_loc, recvs[i]], dim=0)
        flat = blocks.transpose(0, 1).reshape(dim, -1)
        lf[rw.sr_blk, :, rw.sr_cell] = flat[:, rw.src_r].T * rw.sign_r
        lf[rw.gr_blk, :, rw.gr_cell] = _weighted(flat, rw.idx_r, rw.w_r)
        out.append(labs[:B])
    return Blocks(out, x.mesh)


def exchange_padding_stats(t, n_pad: int, D: int,
                           mode: str = "ppermute") -> dict:
    """Host-only audit of the surface exchange plan at any device count
    (``cup2d_tpu/parallel/shard_halo.py:484-518``): the blocks the
    per-offset buffers carry (the sending pairs times their buckets, or
    D x S gathered) against the distinct real sends."""
    if n_pad % D:
        raise ValueError(f"n_pad {n_pad} not divisible by {D}")
    B = n_pad // D
    remote_by_d = _halo_remote_by_d(t, n_pad, D)[0]
    offsets, S, pack, perms, _ = _build_exchange_plan(
        remote_by_d, D, B, n_pad, mode)
    real_blocks = sum(len(r) for r in remote_by_d)
    if mode == "allgather":
        padded_blocks = D * S
    else:
        padded_blocks = sum(len(perms[oi]) * pack[oi].shape[1]
                            for oi in range(len(offsets)))
    return {
        "D": D, "B": B, "S": S, "offsets": offsets,
        "real_blocks": real_blocks,
        "padded_blocks": padded_blocks,
        "ratio": padded_blocks / max(real_blocks, 1),
    }


# ---------------------------------------------------------------------------
# the structured Poisson operator across shards
# ---------------------------------------------------------------------------

_POIS_ROWS = ("nba", "nbb", "m_same", "m_coarse", "m_fine", "m_wall", "par")


class ShardPoissonOp(NamedTuple):
    """Per-device rows of ``flux.PoissonOp`` behind the surface exchange
    (``cup2d_tpu/parallel/shard_halo.py:750-797``): the host leaves are the
    JAX package's ([D, 4, B] rows, the [BS, BS] maps), ``dev`` holds each
    device's rows and maps as tensors on its device. Its two block-row
    gathers per face read [own B blocks ++ received surface]; the strip
    math is ``flux._structured_lap``, the one body shared with the
    single-device apply. ``nba`` marks it as the structured operator."""

    pack: tuple
    nba: np.ndarray
    nbb: np.ndarray
    m_same: np.ndarray
    m_coarse: np.ndarray
    m_fine: np.ndarray
    m_wall: np.ndarray
    par: np.ndarray
    wc0: np.ndarray
    wc1: np.ndarray
    mcl: np.ndarray
    mfr: np.ndarray
    d2own: np.ndarray
    mesh: SlabMesh
    B: int
    S: int
    bs: int
    offsets: tuple
    mode: str
    perms: tuple
    dev: tuple            # per device: (rows tuple, mats tuple)
    pack_dev: list

    def apply(self, x: Blocks) -> Blocks:
        return _poisson_apply_sharded(x, self)


def shard_poisson_op(op, n_pad: int, mesh: SlabMesh, dtype,
                     mode: str = "ppermute") -> ShardPoissonOp:
    """Split a host ``flux.PoissonOp`` into per-device rows and a surface
    exchange plan (``cup2d_tpu/parallel/shard_halo.py:800-865``). Surface
    demand: the live (non-wall, non-pad) neighbour positions of each
    device's rows outside its shard."""
    D = mesh.size
    if n_pad % D:
        raise ValueError(f"n_pad {n_pad} not divisible by the mesh size {D}")
    B = n_pad // D
    nba = np.asarray(op.nba, np.int64)
    nbb = np.asarray(op.nbb, np.int64)
    m_same = np.asarray(op.m_same)
    m_coarse = np.asarray(op.m_coarse)
    m_fine = np.asarray(op.m_fine)
    m_wall = np.asarray(op.m_wall)
    par = np.asarray(op.par)
    live_a = (m_same + m_coarse + m_fine) > 0
    live_b = m_fine > 0

    remote_by_d = []
    for d in range(D):
        sl = slice(d * B, (d + 1) * B)
        refs = np.concatenate([nba[:, sl][live_a[:, sl]],
                               nbb[:, sl][live_b[:, sl]]])
        remote_by_d.append(
            np.unique(refs[(refs < d * B) | (refs >= (d + 1) * B)]))

    offsets, S, pack, perms, g2surf = _build_exchange_plan(
        remote_by_d, D, B, n_pad, mode)

    def remap(pos, live, d):
        local = (pos >= d * B) & (pos < (d + 1) * B)
        sidx = g2surf[d, np.clip(pos, 0, n_pad - 1)]
        out = np.where(local, pos - d * B, B + sidx)
        out = np.where(live, out, 0)
        if (live & ~local & (sidx < 0)).any():
            raise AssertionError("gather source missing from surface set")
        return out

    nba_l = np.zeros((D, 4, B), np.int32)
    nbb_l = np.zeros((D, 4, B), np.int32)
    for d in range(D):
        sl = slice(d * B, (d + 1) * B)
        nba_l[d] = remap(nba[:, sl], live_a[:, sl], d)
        nbb_l[d] = remap(nbb[:, sl], live_b[:, sl], d)

    def per_dev(a):
        return np.ascontiguousarray(
            np.asarray(a).reshape(4, D, B).transpose(1, 0, 2))

    host = dict(nba=nba_l, nbb=nbb_l, m_same=per_dev(m_same),
                m_coarse=per_dev(m_coarse), m_fine=per_dev(m_fine),
                m_wall=per_dev(m_wall), par=per_dev(par))
    mats = tuple(np.asarray(getattr(op, k))
                 for k in ("wc0", "wc1", "mcl", "mfr", "d2own"))
    dev = []
    for d, device in enumerate(mesh.devices):
        if device is None:       # another rank's shard
            dev.append(None)
            continue
        rows = tuple(
            _index(host[k][d], device) if k in ("nba", "nbb") else
            torch.as_tensor(host[k][d], device=device).to(dtype)
            for k in _POIS_ROWS)
        dev.append((rows, tuple(torch.as_tensor(m, device=device).to(dtype)
                                for m in mats)))
    return ShardPoissonOp(pack, *(host[k] for k in _POIS_ROWS), *mats,
                          mesh=mesh, B=B, S=S, bs=int(mats[0].shape[0]),
                          offsets=offsets, mode=mode, perms=perms,
                          dev=tuple(dev), pack_dev=_pack_parts(pack, mesh))


def _poisson_apply_sharded(x: Blocks, t: ShardPoissonOp) -> Blocks:
    """A(x) for split [.., BS, BS] blocks: the surface exchange, then the
    shared strip math per shard over [own ++ received]
    (``cup2d_tpu/parallel/shard_halo.py:940-965``)."""
    recvs = _exchange_surface(x.parts, t)
    out = []
    for i, (d, x_loc) in enumerate(zip(x.mesh.local, x.parts)):
        rows, mats = t.dev[d]
        blocks = torch.cat([x_loc, recvs[i]], dim=0)
        out.append(_structured_lap(x_loc, blocks, *rows, mats))
    return Blocks(out, x.mesh)


def overlap_block_jacobi_sweeps(e: Blocks, r: Blocks, p_inv: torch.Tensor,
                                t: ShardPoissonOp, n: int) -> Blocks:
    """``n`` composite block-Jacobi sweeps e += P_inv (r - A e) on split
    blocks (``cup2d_tpu/parallel/shard_halo.py:868-937``), the finest
    smoother of the sharded forest's FAS cycle. Each sweep exchanges the
    surface once, then per shard runs ``flux._structured_lap`` over [own ++
    received] and ``hopper_kernels.fused_block_jacobi_update`` on its
    [B, BS, BS] rows (the kernel on the card, its twin on the CPU): the
    unoverlapped composition term for term."""
    p_inv_d = [p_inv.to(dev) for dev in e.mesh.local_devices]
    for _ in range(n):
        recvs = _exchange_surface(e.parts, t)
        out = []
        for i, (d, e_loc, r_loc) in enumerate(zip(e.mesh.local, e.parts,
                                                  r.parts)):
            rows, mats = t.dev[d]
            blocks = torch.cat([e_loc, recvs[i]], dim=0)
            lap = _structured_lap(e_loc, blocks, *rows, mats)
            out.append(fused_block_jacobi_update(e_loc, r_loc, lap,
                                                 p_inv_d[i]))
        e = Blocks(out, e.mesh)
    return e


# ---------------------------------------------------------------------------
# flux correction (fine-face deposits -> coarse rows) across shards
# ---------------------------------------------------------------------------

class ShardFluxCorr(NamedTuple):
    """Per-device flux-correction rows (``cup2d_tpu/parallel/
    shard_halo.py:968-1000``). Deposit index space per device: [B own
    blocks ++ received surface blocks] x 4 faces x BS; value destinations:
    its B x BS x BS cells ++ one scratch cell. Each device's rows keep the
    two segments of ``flux.FluxCorrTables``: ``n_first[d]`` rows with each
    destination's first row, then the second face of corner cells and the
    padding, so neither ``index_add`` repeats a real destination."""

    pack: tuple
    dest: np.ndarray     # [D, M]
    cidx: np.ndarray
    fidx1: np.ndarray
    fidx2: np.ndarray
    valid: np.ndarray
    n_first: tuple
    mesh: SlabMesh
    B: int
    S: int
    bs: int
    offsets: tuple
    mode: str
    perms: tuple
    dev: tuple            # per device: (dest, cidx, fidx1, fidx2, valid)
    pack_dev: list

    def apply(self, values: Blocks, deposits: Blocks) -> Blocks:
        return _apply_corr_sharded(values, deposits, self)


def shard_flux_corr(corr, n_pad: int, mesh: SlabMesh, bs: int, dtype,
                    mode: str = "ppermute") -> ShardFluxCorr:
    """Split unpadded host ``FluxCorrTables`` by owning coarse block
    (``cup2d_tpu/parallel/shard_halo.py:1003-1055``). The host rows are in
    ``flux.build_flux_corr``'s two-segment order, so each device's rows,
    taken in that order, are its first segment and then its second."""
    D = mesh.size
    if n_pad % D:
        raise ValueError(f"n_pad {n_pad} not divisible by the mesh size {D}")
    B = n_pad // D
    bs2 = bs * bs
    fb = 4 * bs
    dest = np.asarray(corr.dest, np.int64)
    cidx = np.asarray(corr.cidx, np.int64)
    f1 = np.asarray(corr.fidx1, np.int64)
    f2 = np.asarray(corr.fidx2, np.int64)
    valid_rows = np.asarray(corr.valid) > 0
    dest, cidx, f1, f2 = (a[valid_rows] for a in (dest, cidx, f1, f2))
    first = np.arange(len(dest)) < corr.n_first
    dev = (dest // bs2) // B

    remote_by_d = []
    for d in range(D):
        ref = np.concatenate([a[dev == d] // fb for a in (cidx, f1, f2)])
        remote_by_d.append(
            np.unique(ref[(ref < d * B) | (ref >= (d + 1) * B)]))

    offsets, S, pack, perms, g2surf = _build_exchange_plan(
        remote_by_d, D, B, n_pad, mode)

    def remap_dep(cells, d):
        blk = cells // fb
        off = cells % fb
        local = (blk >= d * B) & (blk < (d + 1) * B)
        sidx = g2surf[d, np.clip(blk, 0, n_pad - 1)]
        if ((~local) & (sidx < 0)).any():
            raise AssertionError("deposit source missing from surface set")
        return np.where(local, (blk - d * B) * fb + off,
                        (B + sidx) * fb + off)

    M = _pad_bucket(max(int((dev == d).sum()) for d in range(D)), 4)
    scratch = B * bs2
    pk_dest = np.full((D, M), scratch, np.int32)
    pk_c = np.zeros((D, M), np.int32)
    pk_f1 = np.zeros((D, M), np.int32)
    pk_f2 = np.zeros((D, M), np.int32)
    # lint: allow[host-sync] -- a 0-d tensor on the CPU, made only to name dtype's numpy dtype: no card memory is read
    pk_v = np.zeros((D, M), torch.empty((), dtype=dtype).numpy().dtype)
    n_first = []
    for d in range(D):
        r = np.nonzero(dev == d)[0]
        n = len(r)
        n_first.append(int(first[r].sum()))
        pk_dest[d, :n] = dest[r] - d * B * bs2
        pk_c[d, :n] = remap_dep(cidx[r], d)
        pk_f1[d, :n] = remap_dep(f1[r], d)
        pk_f2[d, :n] = remap_dep(f2[r], d)
        pk_v[d, :n] = 1.0
    rows = tuple(
        (_index(pk_dest[d], device), _index(pk_c[d], device),
         _index(pk_f1[d], device), _index(pk_f2[d], device),
         torch.as_tensor(pk_v[d], device=device).to(dtype))
        if device is not None else None
        for d, device in enumerate(mesh.devices))
    return ShardFluxCorr(
        pack=pack, dest=pk_dest, cidx=pk_c, fidx1=pk_f1, fidx2=pk_f2,
        valid=pk_v, n_first=tuple(n_first), mesh=mesh, B=B, S=S, bs=bs,
        offsets=offsets, mode=mode, perms=perms, dev=rows,
        pack_dev=_pack_parts(pack, mesh))


def _apply_corr_sharded(values: Blocks, deposits: Blocks,
                        t: ShardFluxCorr) -> Blocks:
    """``flux.apply_flux_corr`` on split blocks: the deposits' surface
    exchange, then per shard the two-segment ``index_add`` into its cells
    plus one scratch cell (``cup2d_tpu/parallel/shard_halo.py:1058-1084``)."""
    recvs = _exchange_surface(deposits.parts, t)
    out = []
    for i, (d, v_loc, d_loc) in enumerate(zip(
            values.mesh.local, values.parts, deposits.parts)):
        dest, cidx, f1, f2, valid = t.dev[d]
        k = t.n_first[d]
        dep = torch.cat([d_loc, recvs[i]], dim=0)
        if v_loc.dim() == 4:
            n, dim, bs, _ = v_loc.shape
            df = dep.reshape(-1, dim)
            corr = valid[:, None] * (df[cidx] + df[f1] + df[f2])
            flat = torch.cat([v_loc.permute(0, 2, 3, 1).reshape(-1, dim),
                              v_loc.new_zeros((1, dim))])
            flat = flat.index_add(0, dest[:k], corr[:k])
            flat = flat.index_add(0, dest[k:], corr[k:])[:-1]
            out.append(flat.reshape(n, bs, bs, dim).permute(0, 3, 1, 2))
        else:
            df = dep.reshape(-1)
            corr = valid * (df[cidx] + df[f1] + df[f2])
            flat = torch.cat([v_loc.reshape(-1), v_loc.new_zeros(1)])
            flat = flat.index_add(0, dest[:k], corr[:k])
            flat = flat.index_add(0, dest[k:], corr[k:])[:-1]
            out.append(flat.reshape(v_loc.shape))
    return Blocks(out, values.mesh)
