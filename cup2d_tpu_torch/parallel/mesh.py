"""Slab mesh and the x-split uniform step: the counterpart of
``cup2d_tpu.parallel.mesh``.

The JAX package splits the x axis of every field over a device mesh with
a ``NamedSharding`` and lets XLA's SPMD partitioner insert the halo
exchanges and all-reduces. Here D slabs, each a tensor on its own
``torch.device``, are driven by one process (devices may repeat: four
shards on one card, eight on the CPU; several cards in one process get
peer copies) or by the ranks of a ``torch.distributed`` world
(``parallel.launch``; each rank owns D / world_size slabs on its device),
and ``parallel.shard_halo`` writes every exchange and reduction out.
``ShardedUniformSim`` runs the same numerics and host loop as
``UniformSim`` on that layout, under any boundary table (a periodic x
closes the slabs into a ring); ``fleet.FleetSim(mesh=)`` places a fleet
on a mesh of either kind. ``ShardedUniformSim.remesh`` re-splits a
run onto another mesh (``shard_halo.check_remesh``: the same controller,
the same ranks, or the world that ``parallel.launch.reinit_distributed``
formed from the survivors of a lost one), which is what
``resilience.StepGuard.elastic_recover`` does after a host loss.
``host_ring_shift`` moves every host's block of slabs to its ring
neighbour, the exchange of the host-redundant mirror tier
(``io.mirror_snapshot``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..uniform import FlowState, UniformSim, check_card_f64
from .shard_halo import (Slabs, SlabMesh, check_remesh, gather_x,
                         permute_slabs, split_x, world_reformed)

__all__ = ["ShardedUniformSim", "SlabMesh", "host_ring_shift", "make_mesh",
           "shard_state", "unshard_state"]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> SlabMesh:
    """A 1-D mesh along x. ``devices`` defaults to every visible CUDA
    device and must be given without a card; it may repeat a device, e.g.
    ``make_mesh(devices=["cuda:0"] * 4)``. ``n_devices`` takes the first
    n and raises when there are fewer. This is a single-controller mesh
    even under a ``torch.distributed`` world; the mesh over a world's
    ranks is ``parallel.launch.world_mesh``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[...] (e.g. ['cpu'] * 4) to "
                "build a slab mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return SlabMesh(devices)


def host_ring_shift(x: Slabs, n_hosts: int) -> Slabs:
    """The mirror exchange (``cup2d_tpu/parallel/mesh.py:179-205``): the
    D slabs of ``x`` grouped into ``n_hosts`` contiguous hosts of D/H
    slabs, every slab's contents move to slot (i + D/H) % D, so host h's
    columns land on host h+1 and the whole field is ``roll(x, +Nx/H)``
    along x. Fresh tensors (``shard_halo.permute_slabs``: a copy on one
    card, a peer copy across cards, a message across ranks); no host
    read. Raises ``ValueError`` where H < 2 or H does not divide D."""
    n_dev = x.mesh.size
    if n_hosts < 2 or n_dev % n_hosts != 0:
        raise ValueError(
            f"host ring needs >=2 hosts dividing the mesh "
            f"(n_hosts={n_hosts}, devices={n_dev})")
    dph = n_dev // n_hosts
    return permute_slabs(x, lambda j: (j - dph) % n_dev)


def shard_state(state: FlowState, mesh: SlabMesh) -> FlowState:
    """Split every field of a whole FlowState along x over ``mesh``."""
    return FlowState(*(split_x(f, mesh) for f in state))


def unshard_state(state: FlowState, device=None) -> FlowState:
    """The whole fields of a split FlowState on one device (for tests and
    dumps; the step never gathers a fine-level field); all-gathers under
    a world."""
    return FlowState(*(gather_x(f, device) for f in state))


class ShardedUniformSim(UniformSim):
    """``UniformSim`` on a slab mesh: the state lives x-split over
    ``mesh`` (no fine-level field is ever whole on one device during a
    step), the advection runs the halo-mode substage kernel per shard,
    the FAS solver smooths its split levels with the halo Jacobi kernel
    per sweep and shard, and the reductions combine per-shard partials.
    Under ``CUP2D_PREC=bf16`` the grid's latch carries through
    ``attach_mesh``: both substages run the halo kernel's bf16 form (halos
    exchanged in bf16) and the FAS cycle its bf16 legs; the split step
    equals the solo bf16 step bit for bit. A boundary table (``bc``, any
    that ``UniformSim`` takes) carries through too: the halo substage
    paints its ghosts per shard, the split hierarchy sweeps with the signed
    halo sweep, and the split step equals the solo step under the table as
    it does free-slip. So does a periodic table (``cases.periodic_table``,
    ``periodic_channel_table``): a periodic x exchanges on a ring of slabs,
    a periodic y wraps inside every slab (the halo kernels' wrap forms),
    and the doubly-periodic mean removal combines per-shard partials in
    f64; fftd refuses, as in the JAX package. The step's diagnostics carry
    the same keys as ``UniformSim``'s."""

    def __init__(self, cfg: SimConfig, mesh: SlabMesh,
                 level: Optional[int] = None, bc=None):
        check_card_f64(mesh.home, cfg.dtype,
                       "ShardedUniformSim, the x-split step (kernels 3 and 7)")
        super().__init__(cfg, level, device=mesh.home, bc=bc)
        self.mesh = mesh
        self.grid.attach_mesh(mesh)
        self.state = shard_state(self.state, mesh)

    def set_state(self, state: FlowState) -> None:
        """Split a whole state over the mesh and take it."""
        self.state = shard_state(state, self.mesh)

    def remesh(self, mesh: SlabMesh) -> None:
        """Re-split the run onto ``mesh`` in place
        (``cup2d_tpu/parallel/mesh.py:126-160``): the state gathered and
        split anew (``attach_mesh`` rebuilds the split hierarchy), a
        cached device dt moved to the new home. Onto a mesh over a world
        re-formed since this one's was lost (``shard_halo.world_reformed``)
        nothing is read through the lost world: the state is zeroed, for
        the caller to restore (``elastic_recover``'s disk rung). Raises
        ``ValueError`` (``attach_mesh``) where Nx does not divide by the
        new mesh's size or its home is not the grid's device, and
        ``NotImplementedError`` for a mesh over other ranks of a live
        world (``shard_halo.check_remesh``). The steps that follow equal
        those of a sim built on ``mesh`` from this state."""
        check_remesh(self.mesh, mesh)
        lost = world_reformed(self.mesh, mesh)
        whole = (self.grid.zero_state() if lost
                 else unshard_state(self.state))
        self.grid.attach_mesh(mesh)
        self.mesh = mesh
        self.state = shard_state(whole, mesh)
        if lost:
            self._next_dt = None
        elif torch.is_tensor(self._next_dt):
            self._next_dt = self._next_dt.to(mesh.home)
