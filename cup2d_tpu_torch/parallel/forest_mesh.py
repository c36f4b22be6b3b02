"""The adaptive forest on a device mesh: the counterpart of
``cup2d_tpu.parallel.forest_mesh`` (``ShardedAMRSim``, :47).

The reference partitions the SFC-ordered blocks into contiguous per-rank
ranges and plans the halo messages by hand (main.cpp:5205-5424 load
balance, 909-2142 communication). The JAX package keeps that policy and
leaves the mechanism to GSPMD; here every cross-device read is written
out (``parallel.shard_halo``). One process drives a ``SlabMesh`` of D
devices (devices may repeat: four shards on one card, or on the CPU), or
the ranks of a ``torch.distributed`` world drive one each
(``SlabMesh.over_world``: every rank's shards on its one device). Shard d
owns the ordered blocks [dB, (d+1)B) of the padded block axis,
B = n_pad / D.

Split per device (``shard_halo.Blocks``): the ordered working state
(velocity, pressure, chi), every per-step operand of the hot loop (the
per-block h, h^2, mask and cell centres, labs, RHS, deposits, the Krylov
and FAS composite-level vectors, the obstacle fields of the shaped step)
and the hot-loop tables: the halo sets (``ShardTables``, with the
shard-local face-copy paint), the Poisson operator (``ShardPoissonOp``,
or the lab-table form under ``CUP2D_POIS=tables``) and the flux
correction (``ShardFluxCorr``). The lab RHS runs kernel 4 once per shard
on that shard's labs; the block-Jacobi preconditioner P_inv r runs kernel
8 once per shard on its rows (``AMRSim._precond``: one f32 FMA chain a
row, so a shard's rows take the solo forest's bits), and under fas the
composite smoother runs kernel 8 once per shard and sweep
(``overlap_block_jacobi_sweeps``). Every full reduction over the ordered
blocks (the Krylov dots, the projection's means, the energy, the
obstacle and force integrals) is ``shard_halo.block_sum``: each shard
sums its own groups of 16 blocks (``group_sum.cu``, one fixed tree a
group) and only the group partials travel to ``mesh.home``, where one
``torch.sum`` adds them in block order. The solo ``AMRSim`` sums the same
groups in the same order, so the split forest is the solo forest bit for
bit, through the stalled startup solves too; under a world every rank
adds the same partials. Max, min, all and any combine the shards'
partials (exact in any order).

Whole on ``mesh.home`` (under a world: on every rank, computed there
replicated from all-gathered operands, so every rank holds the same
bits): the slot-layout fields (the regrid's truth, read by the
prolongation and restriction through the replicated ``vec1t`` / ``sca1t``
sets), the two-level and FAS transfer images and the DCT base solve (each
transfer gathers its ordered operand there and splits its result back;
``shard_halo.comm_stats`` counts their bytes as "transfers"), a shape's
window SDF and deformation velocity (each shard then scatters the rows
that land in its range), and every scalar. The regrid's tags are one
all-gathered vector (``AMRSim.adapt`` through ``_gather``), so every rank
commits the same topology.

Regrid-time migration is re-placement: after a topology change the
ordered state is gathered from the slot fields and split anew. Where the
shards would not each hold whole reduction groups (n_pad not divisible by
16 D; D = 3, or more shards than n_pad / 16), the tables stay whole and
the step runs as ``AMRSim`` on ``devices[0]`` (the reference's replicated
fallback). ``remesh`` re-places a run onto another mesh of the same
controller or ranks, or onto the world re-formed from the survivors of a
lost one (``parallel.launch.reinit_distributed``); the SFC partition
re-splits by construction, which is what
``resilience.StepGuard.elastic_recover`` relies on after a host loss.
``CUP2D_SHARD_EXCHANGE`` (ppermute | allgather) is latched once per sim.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ..amr import AMRSim, _raster_neg, _window_sdf_udef
from ..config import SimConfig
from ..flux import (build_flux_corr, build_poisson_structured,
                    build_poisson_tables)
from ..halo import lab_tables, pad_tables
from .shard_halo import (GROUP_BLOCKS, Blocks, ShardPoissonOp, SlabMesh,
                         check_remesh, exchange_padding_stats, gather_blocks,
                         world_reformed,
                         overlap_block_jacobi_sweeps, shard_flux_corr,
                         shard_poisson_op, shard_tables, split_blocks)

__all__ = ["ShardedAMRSim"]

# the per-block operands of the hot loop, split after every rebuild
_SPLIT_ATTRS = ("_h", "_h3", "_hflat", "_hsq_flat", "_maskv", "_xc", "_yc")


def _exchange_mode() -> str:
    """The surface exchange mode, read once per sim: the halo sets, the
    operator and the deposits of one rebuild must share it."""
    mode = os.environ.get("CUP2D_SHARD_EXCHANGE", "ppermute")
    if mode not in ("ppermute", "allgather"):
        raise ValueError(f"CUP2D_SHARD_EXCHANGE={mode!r}: expected "
                         "ppermute|allgather")
    return mode


class ShardedAMRSim(AMRSim):
    """``AMRSim`` whose ordered block axis is split over ``mesh`` (a
    ``parallel.mesh.SlabMesh``): the same numerics and host driver, with
    or without shapes; see the module docstring for what is split."""

    def __init__(self, cfg: SimConfig, mesh: SlabMesh,
                 shapes: Optional[Sequence] = None):
        self.mesh = mesh
        self._exchange = _exchange_mode()
        self._split = False
        # halo bytes of one hot-loop vector exchange (the metrics stream)
        self._comm_stats = None
        super().__init__(cfg, shapes=shapes, device=mesh.home)

    # -- placement -------------------------------------------------------
    def remesh(self, mesh: SlabMesh) -> None:
        """Re-place the forest onto ``mesh`` in place
        (``cup2d_tpu/parallel/forest_mesh.py:67-112``): the tables are
        rebuilt for the new mesh although the topology did not move (every
        per-device plan, the operator, the flux correction; the replicated
        fallback where the new shards would not each hold whole reduction
        groups), the per-block operands split anew, and the ordered working
        state gathered and split over the new mesh, its key re-anchored.
        The slot fields stay whole on the home device. A rebuild that is no
        topology change keeps the padding's hysteresis and the two-level
        trigger as they were. Onto a mesh over a world re-formed since this
        one's was lost (``shard_halo.world_reformed``) nothing is read
        through the lost world: the ordered state is dropped, for the
        caller to restore (``elastic_recover``'s disk rung). Raises
        ``ValueError`` where the new home is not the sim's device,
        ``NotImplementedError`` for a mesh over other ranks of a live world
        (``shard_halo.check_remesh``)."""
        check_remesh(self.mesh, mesh)
        if mesh.home != self.device:
            raise ValueError(f"re-mesh onto {mesh}: its home is not the "
                             f"sim's device {self.device}")
        if world_reformed(self.mesh, mesh):
            self._ord = None
        whole = None if self._ord is None else {
            k: self._gather(v) for k, v in self._ord.items()}
        kept = (self._npad_quiet, self._coarse_on, self._last_iters)
        self.mesh = mesh
        self._npad_quiet = 0
        self._tables_version = -1      # force the rebuild
        self._refresh()
        self._npad_quiet, self._coarse_on, self._last_iters = kept
        self._pinv_zero = None
        if whole is not None:
            self._ord = {k: self._put_ordered(v) for k, v in whole.items()}
            self._ord_key = (self.forest.version, self.forest.fields.wver)

    def _refresh_impl(self):
        super()._refresh_impl()
        if self._split:
            for name in _SPLIT_ATTRS:
                setattr(self, name,
                        split_blocks(getattr(self, name), self.mesh))

    def _put_ordered(self, x):
        return split_blocks(x, self.mesh) if self._split else x

    @staticmethod
    def _gather(x):
        """The whole ordered tensor (the regrid's tags, the migration, the
        slot fields): an all-gather of kind "regrid" under a world."""
        return gather_blocks(x, kind="regrid") if isinstance(x, Blocks) \
            else x

    # -- tables ----------------------------------------------------------
    def _finalize_tables(self, raw: dict, n_pad: int, fc) -> dict:
        """The hot-loop sets become per-device rows behind a surface
        exchange plan, same-level faces within a shard painted by
        block-row writes; the regrid sets ``vec1t``/``sca1t`` stay whole
        (``cup2d_tpu/parallel/forest_mesh.py:138-177``). Also refreshes
        ``_comm_stats`` from the ``vec3`` plan."""
        D = self.mesh.size
        # whole reduction groups on every shard, or the replicated fallback
        self._split = n_pad % (D * GROUP_BLOCKS) == 0
        if not self._split:
            self._comm_stats = None
            return super()._finalize_tables(raw, n_pad, fc)
        out = {}
        for k, t in raw.items():
            if k in ("vec1t", "sca1t"):
                out[k] = lab_tables(pad_tables(t, n_pad), self.device,
                                    self.dtype)
                continue
            kw = {}
            if fc is not None and k in self._FAST_SETS:
                kw = dict(fc=fc, corners=self._FAST_SETS[k])
            out[k] = shard_tables(t, n_pad, self.mesh, self.dtype,
                                  mode=self._exchange, **kw)
        st = exchange_padding_stats(raw["vec3"], n_pad, D,
                                    mode=self._exchange)
        blk = 2 * self.cfg.bs * self.cfg.bs * self.forest.np_dtype.itemsize
        self._comm_stats = {"halo_real_bytes": st["real_blocks"] * blk,
                            "halo_padded_bytes": st["padded_blocks"] * blk}
        return out

    def _build_pois(self, topo, n_pad: int):
        """The structured operator split per device, or the lab-table
        form behind the same exchange plan under ``CUP2D_POIS=tables``
        (``cup2d_tpu/parallel/forest_mesh.py:179-197``)."""
        if not self._split:
            return super()._build_pois(topo, n_pad)
        if self._pois_mode == "tables":
            t = build_poisson_tables(self.forest, self._order, topo=topo)
            return shard_tables(t, n_pad, self.mesh, self.dtype,
                                mode=self._exchange)
        op = build_poisson_structured(self.forest, self._order, n_pad,
                                      topo=topo)
        return shard_poisson_op(op, n_pad, self.mesh, self.dtype,
                                mode=self._exchange)

    def _finalize_corr(self, topo, n_pad: int):
        if not self._split:
            return super()._finalize_corr(topo, n_pad)
        raw = build_flux_corr(self.forest, self._order, topo=topo)
        return shard_flux_corr(raw, n_pad, self.mesh, self.cfg.bs,
                               self.dtype, mode=self._exchange)

    # -- whole-image transfers -----------------------------------------
    def _coarse_transfers(self, tcoarse):
        deposit, interp = super()._coarse_transfers(tcoarse)
        if not self._split:
            return deposit, interp
        n_pad = self._npad_hwm

        def _deposit(rp):
            return deposit(gather_blocks(rp, kind="transfers"))

        def _interp(ec, like):
            zeros = ec.new_zeros((n_pad,) + tuple(like.shape[1:]))
            return split_blocks(interp(ec, zeros), self.mesh)

        return _deposit, _interp

    def _fas_transfers(self, tcoarse):
        paint_fine, base_solve, extract_all = super()._fas_transfers(
            tcoarse)
        if not self._split:
            return paint_fine, base_solve, extract_all

        def _paint(rdiv):
            return paint_fine(gather_blocks(rdiv, kind="transfers"))

        def _base(rdiv, racc):
            return base_solve(gather_blocks(rdiv, kind="transfers"), racc)

        def _extract(ec, es):
            return split_blocks(extract_all(ec, es), self.mesh)

        return _paint, _base, _extract

    def _fas_block_smoother(self, A, tpois=None):
        """The composite smoother on the mesh: each sweep one surface
        exchange, then per shard the structured strip math and the
        block-Jacobi kernel (``shard_halo.overlap_block_jacobi_sweeps``,
        ``cup2d_tpu/parallel/forest_mesh.py:249-281``). Other operator
        forms keep ``AMRSim``'s smoother."""
        if not isinstance(tpois, ShardPoissonOp):
            return super()._fas_block_smoother(A, tpois)
        p_inv = self.p_inv

        def smooth(e, r, n, from_zero=False):
            if from_zero and n > 0:
                e = self._precond(r)
                n -= 1
            if n > 0:
                e = overlap_block_jacobi_sweeps(e, r, p_inv, tpois, n)
            return e

        return smooth

    # -- the shaped step -------------------------------------------------
    def _window_raster(self, inp, N: int):
        """A shape's window SDF and deformation velocity, evaluated once
        on ``mesh.home``; each local shard keeps the window rows in its own
        block range (a shard-local scatter, no exchange;
        ``cup2d_tpu/parallel/forest_mesh.py:199-241``). Rows outside a
        shard's range go to its scratch row B with the sentinel (or 0),
        so the repeated destination always takes one value."""
        if not self._split:
            return super()._window_raster(inp, N)
        bs = self.cfg.bs
        dtype = self.dtype
        neg = _raster_neg(self.cfg)
        B = self._npad_hwm // self.mesh.size
        d, ud = _window_sdf_udef(inp, bs, dtype)
        pos = inp["pos"]
        sdf_p, ud_p, wm_p = [], [], []
        for k, dev in zip(self.mesh.local, self.mesh.local_devices):
            mine = (pos >= k * B) & (pos < (k + 1) * B)
            lpos = torch.where(mine, pos - k * B, B).to(dev)
            wm3 = mine[:, None, None]
            sdf_k = torch.full((B + 1, bs, bs), neg, dtype=dtype, device=dev)
            sdf_k.index_copy_(0, lpos, torch.where(wm3, d, neg).to(dev))
            ud_k = torch.zeros((2, B + 1, bs, bs), dtype=dtype, device=dev)
            ud_k.index_copy_(1, lpos,
                             torch.where(wm3[None], ud, 0.0).to(dev))
            wm_k = torch.zeros((B + 1,), dtype=dtype, device=dev)
            wm_k.index_copy_(0, lpos, mine.to(dtype).to(dev))
            sdf_p.append(sdf_k[:B])
            ud_p.append(ud_k[:, :B])
            wm_p.append(wm_k[:B])
        return (Blocks(sdf_p, self.mesh), Blocks(ud_p, self.mesh, axis=1),
                Blocks(wm_p, self.mesh))
