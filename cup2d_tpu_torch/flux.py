"""Coarse-fine conservation: the makeFlux Poisson closure and the flux
correction, the counterpart of ``cup2d_tpu.flux``.

1. **Variable-resolution Poisson operator** (main.cpp:5916-5997
   interpolate/makeFlux/D1/D2, assembled into rows at 7031-7115), in the
   structured per-face form: every ghost of the closure is face-local, so
   the operator needs two block-row gathers per face plus fixed [BS, BS]
   tangential maps built once from the D1/D2 tables
   (``build_poisson_structured`` on the host, ``poisson_apply_structured``
   on the device). ``CUP2D_POIS=tables`` takes the lab-table form
   instead: ghost expressions that make ``laplacian5`` of an assembled
   lab the same matrix (``_PoissonLabBuilder``, ``build_poisson_tables``,
   built by ``halo.build_tables``; ``cup2d_tpu/flux.py:79-243``).

2. **Flux correction for stencil kernels** (main.cpp:513-517 BlockCase,
   1392-1849 prepare0/fillcases). Every block computes its 4 face-deposit
   vectors from its assembled lab, and a topology-only index table built
   once per regrid adds [own coarse deposit + the fine pair] into the
   affected coarse edge cells (``build_flux_corr``, ``apply_flux_corr``).

Host builders are the port's own copy of the JAX package's numpy code;
``poisson_op`` and ``flux_corr`` move their results to the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .forest import Forest
from .halo import Expr, HaloTables, _TopoIndex, build_tables

# face order = the reference's BlockCase d[0..3] (main.cpp:513-517)
_FACES = ((-1, 0), (1, 0), (0, -1), (0, 1))  # Xm, Xp, Ym, Yp


# ---------------------------------------------------------------------------
# 1. The Poisson operator in structured (per-face strip) form
# ---------------------------------------------------------------------------

# D1/D2 tangential stencils at a coarse cell (main.cpp:5916-5959): keyed
# by (is_backward, is_forward); offsets are tangential steps within the
# coarse block. The BS/2 splits keep the stencil inside the half-face a
# single fine block abuts.
_D1 = {
    "bd": ((-2, 1.0 / 8.0), (-1, -1.0 / 2.0), (0, 3.0 / 8.0)),
    "fd": ((2, -1.0 / 8.0), (1, 1.0 / 2.0), (0, -3.0 / 8.0)),
    "ct": ((-1, -1.0 / 8.0), (1, 1.0 / 8.0)),
}
_D2 = {
    "bd": ((-2, 1.0 / 32.0), (-1, -1.0 / 16.0), (0, 1.0 / 32.0)),
    "fd": ((2, 1.0 / 32.0), (1, -1.0 / 16.0), (0, 1.0 / 32.0)),
    "ct": ((-1, 1.0 / 32.0), (1, 1.0 / 32.0), (0, -1.0 / 16.0)),
}


def _dkind(t: int, bs: int) -> str:
    if t == bs - 1 or t == bs // 2 - 1:
        return "bd"
    if t == 0 or t == bs // 2:
        return "fd"
    return "ct"


# ---------------------------------------------------------------------------
# 1a. The Poisson operator as a lab-ghost builder (CUP2D_POIS=tables)
# ---------------------------------------------------------------------------

def _fine_subface(cx: int, cy: int, l: int, bi: int, bj: int, t: int,
                  bs: int):
    """For coarse block (l, bi, bj), face (cx, cy), face cell t: the
    finer neighbor block key covering that cell and the tangential index
    of the first of its two subface cells (the reference's Zchild +
    neiFine1/neiFine2 addressing, main.cpp:5825-5914). Shared by the
    Poisson closure and the flux-correction table so the two stay
    index-consistent by construction."""
    half = 1 if t >= bs // 2 else 0
    if cx != 0:
        a = 1 if cx < 0 else 0
        fb = (l + 1, 2 * (bi + cx) + a, 2 * bj + half)
    else:
        b_ = 1 if cy < 0 else 0
        fb = (l + 1, 2 * bi + half, 2 * (bj + cy) + b_)
    return fb, 2 * (t % (bs // 2))


class _PoissonLabBuilder:
    """Ghost expressions making `laplacian5(lab)` the reference's
    variable-resolution Poisson operator. Same constructor/`block_ghosts`
    contract as `halo._LabBuilder` so `build_tables` grouping reuses it.
    """

    def __init__(self, forest, g: int, tensorial: bool, dim: int):
        assert g == 1 and dim == 1
        self.f = forest
        self.bs = forest.bs
        self.g = 1
        self.dim = 1

    def _cell(self, slot, cy, cx, w=1.0):
        return Expr({(slot, cy, cx): np.full(1, w)})

    def _tang(self, slot, edge_n, tc, table, xface: bool) -> Expr:
        """D1/D2 expression at coarse cell (normal index edge_n,
        tangential index tc), tangential steps within block `slot`."""
        e = Expr()
        for d, w in table[_dkind(tc, self.bs)]:
            cy, cx = (tc + d, edge_n) if xface else (edge_n, tc + d)
            e.add(self._cell(slot, cy, cx), w)
        return e

    def block_ghosts(self, slot: int):
        f = self.f
        bs = self.bs
        l = int(f.level[slot])
        bi = int(f.bi[slot])
        bj = int(f.bj[slot])
        nbx, nby = f.nblocks_at(l)
        out: dict[tuple[int, int], Expr] = {}

        for face, (cx, cy) in enumerate(_FACES):
            xface = cx != 0
            ni, nj = bi + cx, bj + cy
            wall = not (0 <= ni < nbx and 0 <= nj < nby)
            # own edge coords along the face, as (cy, cx) builders
            edge_n = (0 if cx < 0 else bs - 1) if xface else \
                     (0 if cy < 0 else bs - 1)

            def own(t, depth=0):
                n = edge_n + (1 if (cx < 0 or cy < 0) else -1) * depth
                return (t, n) if xface else (n, t)

            def lab_of(t):
                if xface:
                    lx = 0 if cx < 0 else bs + 1
                    return (t + 1, lx)
                ly = 0 if cy < 0 else bs + 1
                return (ly, t + 1)

            if wall:
                # zero-Neumann wall: ghost = edge cell, flux = 0
                # (the reference skips boundary faces entirely,
                # main.cpp:7104 isBoundary)
                for t in range(bs):
                    oy, ox = own(t)
                    out[lab_of(t)] = self._cell(slot, oy, ox)
                continue

            rel = f.owner_relation(l, ni, nj)
            if rel == 0:
                ns = f.slot(l, ni, nj)
                n_edge = (bs - 1 if cx < 0 else 0) if xface else \
                         (bs - 1 if cy < 0 else 0)
                for t in range(bs):
                    cyx = (t, n_edge) if xface else (n_edge, t)
                    out[lab_of(t)] = self._cell(ns, *cyx)
            elif rel == -2:
                # fine side of a fine-coarse interface: interpolated
                # ghost (interpolate(), signInt=+1, main.cpp:5943-5960)
                cs = f.slot(l - 1, ni // 2, nj // 2)
                assert cs >= 0
                c_edge = (bs - 1 if cx < 0 else 0) if xface else \
                         (bs - 1 if cy < 0 else 0)
                par = (bj & 1) if xface else (bi & 1)
                for t in range(bs):
                    tc = t // 2 + par * (bs // 2)
                    ccyx = (tc, c_edge) if xface else (c_edge, tc)
                    st = -1.0 if t % 2 == 0 else 1.0
                    e = Expr()
                    e.add(self._cell(slot, *own(t)), 2.0 / 3.0)
                    e.add(self._cell(slot, *own(t, 1)), -1.0 / 5.0)
                    e.add(self._cell(cs, *ccyx), 8.0 / 15.0)
                    e.add(self._tang(cs, c_edge, tc, _D1, xface),
                          st * 8.0 / 15.0)
                    e.add(self._tang(cs, c_edge, tc, _D2, xface),
                          8.0 / 15.0)
                    out[lab_of(t)] = e
            elif rel == -1:
                # coarse side: flux replacement by the two fine subfaces
                # (makeFlux -1 branch; the paired D1 terms cancel,
                # leaving -16/15 D2, main.cpp:5997-6013)
                fe_close = bs - 1 if (cx < 0 or cy < 0) else 0
                fe_far = fe_close + (-1 if fe_close == bs - 1 else 1)
                for t in range(bs):
                    fb, tf0 = _fine_subface(cx, cy, l, bi, bj, t, bs)
                    fs = f.slot(*fb)
                    assert fs >= 0
                    e = Expr()
                    e.add(self._cell(slot, *own(t)), 1.0 - 16.0 / 15.0)
                    for tf in (tf0, tf0 + 1):
                        ccyx = (tf, fe_close) if xface else (fe_close, tf)
                        fcyx = (tf, fe_far) if xface else (fe_far, tf)
                        e.add(self._cell(fs, *ccyx), 1.0 / 3.0)
                        e.add(self._cell(fs, *fcyx), 1.0 / 5.0)
                    e.add(self._tang(slot, edge_n, t, _D2, xface),
                          -16.0 / 15.0)
                    out[lab_of(t)] = e
            else:  # pragma: no cover - 2:1 balance guarantees a neighbor
                raise AssertionError("missing neighbor on balanced forest")
        return out


def build_poisson_tables(forest: Forest, order: np.ndarray,
                         topo=None) -> HaloTables:
    """g=1 scalar tables: `laplacian5(assemble_labs_ordered(x, t), 1)`
    is the reference's variable-resolution Poisson matrix A."""
    return build_tables(forest, order, 1, False, 1, topo=topo,
                        builder_cls=_PoissonLabBuilder)



class PoissonOp(NamedTuple):
    """Structured makeFlux operator tables, numpy on the host
    (``build_poisson_structured``) or tensors on the device
    (``poisson_op``).

    Per face f in the _FACES order, arrays over the padded ordered
    block axis: ``nba[f]``/``nbb[f]`` gather source rows (fine-case
    halves; equal otherwise), ``m_same/m_coarse/m_fine/m_wall[f]`` the
    case one-hots, ``par[f]`` the coarse-interpolation parity, plus the
    static [BS, BS] tangential matrices."""

    nba: object       # [4, n_pad] ordered positions
    nbb: object       # [4, n_pad]
    m_same: object    # [4, n_pad] field dtype
    m_coarse: object  # [4, n_pad]
    m_fine: object    # [4, n_pad]
    m_wall: object    # [4, n_pad]
    par: object       # [4, n_pad] field dtype (0.0 / 1.0)
    wc0: object       # [BS, BS] coarse-ghost strip map, parity 0
    wc1: object       # [BS, BS] parity 1
    mcl: object       # [2, BS, BS] fine close-col maps per half
    mfr: object       # [2, BS, BS] fine far-col maps per half
    d2own: object     # [BS, BS] own-edge D2 map (coarse side)


def _structured_matrices(bs: int):
    """The static tangential maps of the makeFlux closure, from the
    _D1/_D2 tables. Row t of each matrix holds the weights over the
    gathered 8-strip for ghost cell t."""
    wc = np.zeros((2, bs, bs))
    for par in (0, 1):
        for t in range(bs):
            tc = t // 2 + par * (bs // 2)
            st = -1.0 if t % 2 == 0 else 1.0
            wc[par, t, tc] += 8.0 / 15.0
            for d, w in _D1[_dkind(tc, bs)]:
                wc[par, t, tc + d] += st * (8.0 / 15.0) * w
            for d, w in _D2[_dkind(tc, bs)]:
                wc[par, t, tc + d] += (8.0 / 15.0) * w
    mcl = np.zeros((2, bs, bs))
    mfr = np.zeros((2, bs, bs))
    for half in (0, 1):
        for t in range(half * (bs // 2), (half + 1) * (bs // 2)):
            tf0 = 2 * (t % (bs // 2))
            for tf in (tf0, tf0 + 1):
                mcl[half, t, tf] += 1.0 / 3.0
                mfr[half, t, tf] += 1.0 / 5.0
    d2own = np.zeros((bs, bs))
    for t in range(bs):
        for d, w in _D2[_dkind(t, bs)]:
            d2own[t, t + d] += w
    return wc[0], wc[1], mcl, mfr, d2own


def build_poisson_structured(forest: Forest, order: np.ndarray,
                             n_pad: int, topo=None) -> PoissonOp:
    """Host build of the structured operator (vectorized over the dense
    topology index; a few [n_pad] arrays per face — no per-cell rows)."""
    bs = forest.bs
    n_real = len(order)
    assert n_pad > n_real
    if topo is None:
        topo = _TopoIndex(forest, order)
    lv = forest.level[order].astype(np.int64)
    biv = forest.bi[order].astype(np.int64)
    bjv = forest.bj[order].astype(np.int64)
    ordpos_of = np.full(forest.capacity, n_real, np.int64)
    ordpos_of[order] = np.arange(n_real)
    fdt = forest.np_dtype

    nba = np.full((4, n_pad), n_real, np.int32)
    nbb = np.full((4, n_pad), n_real, np.int32)
    masks = np.zeros((4, 4, n_pad), fdt)   # [case, face, n_pad]
    par = np.zeros((4, n_pad), fdt)
    for face, (cx, cy) in enumerate(_FACES):
        rel = topo.rel_at(lv, biv + cx, bjv + cy)
        wall = rel == -3          # off-domain: zero-flux face
        same = rel == 0
        coarse = rel == -2
        fine = rel == -1
        masks[3, face, :n_real][wall] = 1.0
        masks[0, face, :n_real][same] = 1.0
        masks[1, face, :n_real][coarse] = 1.0
        masks[2, face, :n_real][fine] = 1.0
        s_same = topo.slot_at(lv, biv + cx, bjv + cy)
        s_coarse = topo.slot_at(lv - 1, (biv + cx) >> 1, (bjv + cy) >> 1)
        if cx != 0:
            a = 1 if cx < 0 else 0
            fa_i = 2 * (biv + cx) + a
            fa_j = 2 * bjv
            fb_j = 2 * bjv + 1
            s_fa = topo.slot_at(lv + 1, fa_i, fa_j)
            s_fb = topo.slot_at(lv + 1, fa_i, fb_j)
            par[face, :n_real] = (bjv & 1).astype(fdt)
        else:
            b_ = 1 if cy < 0 else 0
            fa_j = 2 * (bjv + cy) + b_
            s_fa = topo.slot_at(lv + 1, 2 * biv, fa_j)
            s_fb = topo.slot_at(lv + 1, 2 * biv + 1, fa_j)
            par[face, :n_real] = (biv & 1).astype(fdt)
        a_slot = np.where(same, s_same,
                          np.where(coarse, s_coarse,
                                   np.where(fine, s_fa, -1)))
        b_slot = np.where(fine, s_fb, a_slot)
        nba[face, :n_real] = np.where(
            a_slot >= 0, ordpos_of[np.maximum(a_slot, 0)], n_real)
        nbb[face, :n_real] = np.where(
            b_slot >= 0, ordpos_of[np.maximum(b_slot, 0)], n_real)

    wc0, wc1, mcl, mfr, d2own = _structured_matrices(bs)
    return PoissonOp(
        nba=nba, nbb=nbb,
        m_same=masks[0], m_coarse=masks[1],
        m_fine=masks[2], m_wall=masks[3],
        par=par,
        wc0=wc0.astype(fdt), wc1=wc1.astype(fdt),
        mcl=mcl.astype(fdt), mfr=mfr.astype(fdt),
        d2own=d2own.astype(fdt),
    )


def poisson_op(op: PoissonOp, device, dtype) -> PoissonOp:
    """The host operator on ``device``: gather rows as int64, the rest
    in the field dtype."""
    def put(name, a):
        t = torch.as_tensor(np.asarray(a), device=device)
        return t.long() if name in ("nba", "nbb") else t.to(dtype)

    return PoissonOp(**{k: put(k, v) for k, v in op._asdict().items()})


def poisson_apply_structured(x: torch.Tensor, op: PoissonOp) -> torch.Tensor:
    """A(x) for [n_pad, BS, BS] ordered x: within-block 5-point part
    plus the four per-face ghost strips (case-selected linear maps of
    gathered neighbour strips). Per-device rows
    (``parallel.shard_halo.ShardPoissonOp``) apply themselves."""
    if hasattr(op, "apply"):
        return op.apply(x)
    return _structured_lap(
        x, x, op.nba, op.nbb, op.m_same, op.m_coarse, op.m_fine,
        op.m_wall, op.par, (op.wc0, op.wc1, op.mcl, op.mfr, op.d2own))


def _structured_lap(x_own, x_src, nba, nbb, m_same, m_coarse, m_fine,
                    m_wall, par, mats) -> torch.Tensor:
    """The strip math of the structured makeFlux operator: ghost strips
    are [BS, N] (blocks last), the tangential maps apply to them as
    [BS, BS] @ [BS, N] products, and the strips close the 5-point sum of
    the [N, BS, BS] blocks by concatenation along the cell axes. Those products
    must run in full f32 on the card: a truncated (TF32) pass corrupts
    the D1/D2 weights enough to destroy the two-level correction (the
    JAX package measured 8 -> 121 Krylov iterations with its bf16 pass).
    ``AMRSim`` sets ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    wc0, wc1, mcl, mfr, d2own = mats
    bs = x_own.shape[1]
    xt = x_own.permute(1, 2, 0)                   # [y, x, N]
    mm = torch.matmul

    c23, c15, c1615 = 2.0 / 3.0, 1.0 / 5.0, 16.0 / 15.0

    def ghost(face):
        """[BS, N] ghost strip (tangential index first)."""
        cx, cy = _FACES[face]
        At = x_src[nba[face]].permute(1, 2, 0)    # [y, x, N]
        Bt = x_src[nbb[face]].permute(1, 2, 0)
        if cx != 0:
            own_e = xt[:, 0, :] if cx < 0 else xt[:, bs - 1, :]
            own_e1 = xt[:, 1, :] if cx < 0 else xt[:, bs - 2, :]
            n_edge = bs - 1 if cx < 0 else 0
            far = bs - 2 if cx < 0 else 1
            sA = At[:, n_edge, :]
            far_a = At[:, far, :]
            close_b, far_b = Bt[:, n_edge, :], Bt[:, far, :]
        else:
            own_e = xt[0, :, :] if cy < 0 else xt[bs - 1, :, :]
            own_e1 = xt[1, :, :] if cy < 0 else xt[bs - 2, :, :]
            n_edge = bs - 1 if cy < 0 else 0
            far = bs - 2 if cy < 0 else 1
            sA = At[n_edge, :, :]
            far_a = At[far, :, :]
            close_b, far_b = Bt[n_edge, :, :], Bt[far, :, :]
        # same-level copy
        g_same = sA
        # fine side of a coarse neighbour: strip map per parity
        gc0 = mm(wc0, sA)
        gc1 = mm(wc1, sA)
        pf = par[face][None, :]
        g_coarse = (c23 * own_e - c15 * own_e1
                    + (1.0 - pf) * gc0 + pf * gc1)
        # coarse side of finer neighbours: subface sums + own D2
        # (sA doubles as the fine close-column: same edge slice)
        g_fine = ((1.0 - c1615) * own_e
                  + mm(mcl[0], sA) + mm(mfr[0], far_a)
                  + mm(mcl[1], close_b) + mm(mfr[1], far_b)
                  - c1615 * mm(d2own, own_e))
        return (m_same[face][None, :] * g_same
                + m_coarse[face][None, :] * g_coarse
                + m_fine[face][None, :] * g_fine
                + m_wall[face][None, :] * own_e)

    # the 5-point sum in the blocks-first order of x, so the result is a
    # dense [N, BS, BS] stack; the [BS, N] ghost strips go in transposed
    gw, ge, gs, gn = (ghost(f).T for f in range(4))
    x = x_own
    xw = torch.cat([gw[:, :, None], x[:, :, :-1]], dim=2)
    xe = torch.cat([x[:, :, 1:], ge[:, :, None]], dim=2)
    xs_ = torch.cat([gs[:, None, :], x[:, :-1, :]], dim=1)
    xn = torch.cat([x[:, 1:, :], gn[:, None, :]], dim=1)
    return xw + xe + xs_ + xn - 4.0 * x


# ---------------------------------------------------------------------------
# 2. Flux-correction index tables + per-kernel face deposits
# ---------------------------------------------------------------------------

class FluxCorrTables(NamedTuple):
    """Correction rows: value[dest] += valid * (D[cidx] + D[fidx1] +
    D[fidx2]), where D is a [n_active * 4 * BS, dim] face-deposit array.
    One row per coarse edge cell face that abuts a finer neighbour (the
    reference's fillcase0+fillcase1 combination). The first ``n_first``
    rows hold each destination's first row; the rest hold the second
    face of corner cells, then the padding to a power-of-two bucket
    (``valid`` = 0, dest pointing at a dead pad-row cell). Numpy from
    ``build_flux_corr``, tensors from ``flux_corr``."""

    dest: object     # [M] into ordered cell layout [n_active*BS*BS]
    cidx: object     # [M] coarse block's own face deposit
    fidx1: object    # [M] fine subface deposits (the pair)
    fidx2: object    # [M]
    valid: object    # [M] 1.0 real row / 0.0 padding
    n_first: int     # rows of the first segment


def build_flux_corr(forest: Forest, order: np.ndarray,
                    n_pad: int = 0, topo=None) -> FluxCorrTables:
    """Topology-only; shared by every corrected kernel (the per-kernel
    physics lives in the deposit arrays). ``n_pad`` > len(order) enables
    row padding (pad rows target the first pad block's cell 0, which the
    caller's mask discards). Rows are built vectorized per face over the
    dense topology index."""
    bs = forest.bs
    n_real = len(order)
    if topo is None:
        topo = _TopoIndex(forest, order)
    lv = forest.level[order].astype(np.int64)
    biv = forest.bi[order].astype(np.int64)
    bjv = forest.bj[order].astype(np.int64)
    ordpos_of = np.full(forest.capacity, -1, np.int64)
    ordpos_of[order] = np.arange(n_real)
    k_arr = np.arange(n_real, dtype=np.int64)
    t = np.arange(bs, dtype=np.int64)
    half = (t >= bs // 2).astype(np.int64)
    tf0 = 2 * (t % (bs // 2))
    dest_p, cidx_p, f1_p = [], [], []
    for face, (cx, cy) in enumerate(_FACES):
        finer = topo.rel_at(lv, biv + cx, bjv + cy) == -1
        if not finer.any():
            continue
        km = k_arr[finer]
        lm, bim, bjm = lv[finer], biv[finer], bjv[finer]
        # fine neighbour block per (member, t)
        if cx != 0:
            fbi = 2 * (bim[:, None] + cx) + (1 if cx < 0 else 0)
            fbj = 2 * bjm[:, None] + half[None, :]
            cell = t[None, :] * bs + (0 if face == 0 else bs - 1)
        else:
            fbi = 2 * bim[:, None] + half[None, :]
            fbj = 2 * (bjm[:, None] + cy) + (1 if cy < 0 else 0)
            cell = (0 if face == 2 else bs - 1) * bs + t[None, :]
        slots = topo.slot_at(lm[:, None] + 1, fbi, fbj)
        assert (slots >= 0).all(), "2:1 balance violated at a face"
        kf = ordpos_of[slots]
        opp = face ^ 1
        dest_p.append((km[:, None] * (bs * bs) + cell).ravel())
        cidx_p.append(((km[:, None] * 4 + face) * bs + t[None, :]).ravel())
        f1_p.append(((kf * 4 + opp) * bs + tf0[None, :]).ravel())
    cat = (lambda ps: np.concatenate(ps)
           if ps else np.zeros(0, np.int64))
    dest, cidx, f1 = cat(dest_p), cat(cidx_p), cat(f1_p)
    m_real = len(dest)
    # a corner cell takes two faces: the first row of each destination
    # goes in the first segment, the second in the second, each in face
    # order, so neither segment repeats a real destination
    first = np.zeros(m_real, bool)
    first[np.unique(dest, return_index=True)[1]] = True
    perm = np.concatenate([np.nonzero(first)[0], np.nonzero(~first)[0]])
    dest, cidx, f1 = dest[perm], cidx[perm], f1[perm]
    n_first = int(first.sum())
    assert len(np.unique(dest[n_first:])) == m_real - n_first, \
        "a cell takes more than two correction rows"
    if n_pad:
        assert n_pad > n_real
        m = max(64, 1 << max(0, (m_real - 1)).bit_length())
        dead = n_real * bs * bs
        dest = np.concatenate([dest, np.full(m - m_real, dead, np.int64)])
        cidx = np.concatenate([cidx, np.zeros(m - m_real, np.int64)])
        f1 = np.concatenate([f1, np.zeros(m - m_real, np.int64)])
    valid = np.zeros(len(dest), np.float32)
    valid[:m_real] = 1.0
    return FluxCorrTables(dest=dest, cidx=cidx, fidx1=f1, fidx2=f1 + 1,
                          valid=valid, n_first=n_first)


def flux_corr(t: FluxCorrTables, device, dtype) -> FluxCorrTables:
    """The host correction rows on ``device`` (indices int64, ``valid``
    in the field dtype)."""
    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return FluxCorrTables(
        dest=ix(t.dest), cidx=ix(t.cidx), fidx1=ix(t.fidx1),
        fidx2=ix(t.fidx2),
        valid=torch.as_tensor(t.valid, device=device).to(dtype),
        n_first=t.n_first)


def apply_flux_corr(values: torch.Tensor, deposits: torch.Tensor,
                    t: FluxCorrTables) -> torch.Tensor:
    """values: [N, BS, BS] or [N, dim, BS, BS] kernel output (ordered);
    deposits: [N, 4, BS] or [N, 4, BS, dim] from a ``*_deposits`` helper.
    Returns the corrected values (the reference's fillcases add). The add
    is one ``index_add`` per row segment: within a segment no real
    destination repeats, and the pad rows add exact zeros to one dead
    cell, so the card's atomics give the same bits on every run and a
    corner cell sums its two faces in row order, as the reference's
    scatter does. Per-device rows (``parallel.shard_halo.ShardFluxCorr``)
    apply themselves."""
    if hasattr(t, "apply"):
        return t.apply(values, deposits)
    k = t.n_first
    if values.dim() == 3:
        flat = values.reshape(-1)
        d = deposits.reshape(-1)
        corr = t.valid * (d[t.cidx] + d[t.fidx1] + d[t.fidx2])
        out = flat.index_add(0, t.dest[:k], corr[:k])
        return out.index_add(0, t.dest[k:], corr[k:]).reshape(values.shape)
    n, dim, bs, _ = values.shape
    flat = values.permute(0, 2, 3, 1).reshape(-1, dim)
    d = deposits.reshape(-1, dim)
    corr = t.valid[:, None] * (d[t.cidx] + d[t.fidx1] + d[t.fidx2])
    out = flat.index_add(0, t.dest[:k], corr[:k])
    out = out.index_add(0, t.dest[k:], corr[k:])
    return out.reshape(n, bs, bs, dim).permute(0, 3, 1, 2)


def _face_pairs(lab: torch.Tensor, g: int, bs: int):
    """(this, ghost) slices per face of [..., L, L] labs; the face axis
    runs along the block edge (length BS)."""
    return (
        (lab[..., g:g + bs, g], lab[..., g:g + bs, g - 1]),        # Xm
        (lab[..., g:g + bs, g + bs - 1], lab[..., g:g + bs, g + bs]),  # Xp
        (lab[..., g, g:g + bs], lab[..., g - 1, g:g + bs]),        # Ym
        (lab[..., g + bs - 1, g:g + bs], lab[..., g + bs, g:g + bs]),  # Yp
    )


def diffusive_deposits(vlab: torch.Tensor, g: int, dfac) -> torch.Tensor:
    """KernelAdvectDiffuse deposits (main.cpp:5504-5570): dfac*(this -
    ghost) per component; only the diffusive flux is corrected, the WENO
    advective term is not. vlab [N, 2, L, L] -> [N, 4, BS, 2]."""
    bs = vlab.shape[-1] - 2 * g
    rows = [dfac * (t - gh) for (t, gh) in _face_pairs(vlab, g, bs)]
    return torch.stack(rows, dim=1).transpose(2, 3)  # [N,4,BS,2]


def divergence_deposits(vlab: torch.Tensor, ulab, chi, facDiv) -> torch.Tensor:
    """pressure_rhs deposits (main.cpp:6152-6207): +-facDiv*(vn_this +
    vn_ghost) minus the chi*udef counterpart; vn is the face-normal
    component. facDiv = 0.5*h/dt per block, shaped [N] (or scalar).
    vlab/ulab [N, 2, L, L], chi [N, BS, BS] -> [N, 4, BS]."""
    g = 1
    bs = vlab.shape[-1] - 2
    fd = torch.as_tensor(facDiv, dtype=vlab.dtype, device=vlab.device)
    fd = fd.reshape(-1, 1) if fd.dim() else fd
    pairs = _face_pairs(vlab, g, bs)
    upairs = _face_pairs(ulab, g, bs) if ulab is not None else None
    chi_edge = (chi[:, :, 0], chi[:, :, bs - 1],
                chi[:, 0, :], chi[:, bs - 1, :]) if chi is not None else None
    rows = []
    for f in range(4):
        comp = 0 if f < 2 else 1
        sgn = 1.0 if f % 2 == 0 else -1.0
        t, gh = pairs[f]
        val = t[:, comp] + gh[:, comp]
        if upairs is not None:
            ut, ugh = upairs[f]
            val = val - chi_edge[f] * (ut[:, comp] + ugh[:, comp])
        rows.append(sgn * fd * val)
    return torch.stack(rows, dim=1)


def gradient_deposits(plab: torch.Tensor, pfac) -> torch.Tensor:
    """pressureCorrectionKernel deposits (main.cpp:6055-6103):
    +-pfac*(this + ghost) in the face-normal component only; pfac =
    -0.5*dt*h per block [N]. plab [N, L, L] -> [N, 4, BS, 2]."""
    bs = plab.shape[-1] - 2
    pf = torch.as_tensor(pfac, dtype=plab.dtype, device=plab.device)
    pf = pf.reshape(-1, 1) if pf.dim() else pf
    out = []
    for f, (t, gh) in enumerate(_face_pairs(plab, 1, bs)):
        sgn = 1.0 if f % 2 == 0 else -1.0
        val = sgn * pf * (t + gh)
        zero = torch.zeros_like(val)
        out.append(torch.stack([val, zero] if f < 2 else [zero, val],
                               dim=-1))
    return torch.stack(out, dim=1)  # [N, 4, BS, 2]
