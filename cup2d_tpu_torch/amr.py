"""Adaptive simulation on the block forest, obstacle-free: the counterpart
of ``cup2d_tpu.amr.AMRSim`` (the reference's adapt(), main.cpp:4657-5440,
and its hot loop, 6576-7290).

host (numpy, per regrid)          device (torch, per step)
-------------------------------   ---------------------------------------
tagging decisions + 2:1 sweeps    vorticity tags (lab + reduction)
slot alloc/release, SFC order     WENO5 Heun advection-diffusion over all
halo gather-table rebuild           blocks (``fused_lab_rhs``), diffusive
flux-correction rows                fluxes corrected at level interfaces
two-level / FAS transfer maps     makeFlux variable-resolution pressure
                                    solve (BiCGSTAB with block-Jacobi and
                                    the two-level coarse correction, or
                                    the forest FAS hierarchy with
                                    ``fused_block_jacobi_update``)
                                  prolongation / restriction of regrids

Tables and maps are built on the host once per regrid and moved to the
device then, not once per step. The solvers are host loops reading one or
two device flags per iteration (``poisson.bicgstab``/``mg_solve``), so
they take the JAX loop's branches and match its iteration counts.

Device policy: ``AMRSim`` runs on ``cuda`` unless given ``device="cpu"``;
without a card and without a device it raises. The card runs f32 state
only. On the card the two forest kernels always run, on the CPU their
plain twins. ``torch.backends.cuda.matmul.allow_tf32`` is set False on the
card: the structured operator's strip maps, the DCT base solve and the
block-Jacobi GEMM are full-f32 products in the reference.

Environment, latched once per sim as the reference does: ``CUP2D_POIS``
(unset/structured: BiCGSTAB + block-Jacobi with the iters>15 two-level
trigger; fft: the two-level correction always on in its mg2 form;
fas/fas-f: the forest FAS hierarchy as the production solver) and
``CUP2D_TWOLEVEL`` (additive|mult|mg2, forcing one two-level form). Not
ported yet, and refused with a ValueError: ``CUP2D_POIS=tables``,
``CUP2D_PREC=bf16`` (the bf16 FAS ladder legs) and shapes (the shaped
step). ``fftd`` and non-free-slip boundary tables refuse as in the
reference.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import SimConfig
from .flux import (apply_flux_corr, build_flux_corr,
                   build_poisson_structured, diffusive_deposits,
                   divergence_deposits, flux_corr, gradient_deposits,
                   poisson_apply_structured, poisson_op)
from .forest import Forest
from .halo import (_TopoIndex, assemble_labs, assemble_labs_ordered,
                   build_face_copy, build_tables, lab_tables,
                   make_fast_tables, pad_tables)
from .ops.hopper_kernels import fused_block_jacobi_update, fused_lab_rhs
from .ops.stencil import (divergence, dt_from_umax, heun_substage,
                          pressure_gradient_update, vorticity)
from .poisson import (ForestFASCycle, _down2_mean, _up2_bilinear,
                      apply_block_precond_blocks, bicgstab,
                      block_precond_matrix, coarse_neumann_solve_dct,
                      dct_neumann_operators, mg_solve)
from .uniform import resolve_device

__all__ = ["AMRSim", "multilevel_forest", "vortex_forest"]

_FREE_SLIP_TOKEN = "fs,fs,fs,fs"
_QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))   # child (I, J) order


def _tiles_img(entry, rp, bs: int):
    """Paint one level's uniform image from ordered block rows by one
    block-row gather (own/ownm: the owning row and its 0/1 mask per
    tile). Shared by the two-level transfers and the FAS ladder."""
    own, ownm, _, _ = entry
    nty, ntx = own.shape
    img = rp[own.reshape(-1)] * ownm.reshape(-1)[:, None, None]
    return img.reshape(nty, ntx, bs, bs).permute(0, 2, 1, 3) \
              .reshape(nty * bs, ntx * bs)


def _extract_tiles(a, entry, e, bs: int):
    """Adjoint of _tiles_img: gather each active block's tile out of a
    level image and add it into the ordered-block accumulator ``e``."""
    own, _, tid, selp = entry
    nty, ntx = own.shape
    tiles = a.reshape(nty, bs, ntx, bs).permute(0, 2, 1, 3) \
             .reshape(nty * ntx, bs, bs)
    return e + tiles[tid] * selp[:, None, None]


class AMRSim:
    """Adaptive flow solver on the block forest, obstacle-free."""

    def __init__(self, cfg: SimConfig, shapes: Optional[Sequence] = None,
                 bc=None, device=None):
        self.cfg = cfg
        token = getattr(bc, "token", bc)
        if token not in (None, _FREE_SLIP_TOKEN):
            raise ValueError(
                f"AMRSim does not support non-free-slip BC tables "
                f"({token}): the forest gather-table ghost rows are linear "
                "sign-flips (free-slip/Neumann only)")
        pois = os.environ.get("CUP2D_POIS", "structured")
        if pois == "fftd":
            raise ValueError(
                "CUP2D_POIS=fftd is a uniform-family solve (FFT "
                "diagonalization over a periodic single-level box); the "
                "forest has no periodic gather-table ghosts")
        if pois == "tables":
            raise ValueError(
                "CUP2D_POIS=tables (the lab-table form of the forest "
                "Poisson operator) is not ported yet: use "
                "structured|fft|fas|fas-f")
        if pois not in ("structured", "fft", "fas", "fas-f"):
            raise ValueError(f"CUP2D_POIS={pois!r}: expected "
                             "structured|tables|fft|fas|fas-f")
        twolevel = os.environ.get("CUP2D_TWOLEVEL")
        if twolevel not in (None, "additive", "mult", "mg2"):
            raise ValueError(f"CUP2D_TWOLEVEL={twolevel!r}: "
                             "expected additive|mult|mg2")
        prec = os.environ.get("CUP2D_PREC", "") or "f32"
        if prec == "bf16":
            raise ValueError(
                "CUP2D_PREC=bf16 (bf16 storage of the forest FAS ladder "
                "legs) is not ported yet; unset it")
        if prec != "f32":
            raise ValueError(f"CUP2D_PREC={prec!r}: expected f32|bf16")
        if shapes is None:
            shapes = cfg.parse_shapes()
        if len(shapes):
            raise ValueError(
                f"shapes ({len(shapes)} given): the shaped forest step "
                "(rasterization, penalization, collisions, forces) is not "
                "ported yet; pass shapes=[]")
        self._pois_mode = pois
        self._twolevel_form = twolevel
        self.shapes = []
        self.device = resolve_device(device)
        self.forest = Forest(cfg, self.device)
        self.dtype = self.forest.dtype
        if self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise ValueError(
                    f"dtype {cfg.dtype} on {self.device}: the card runs "
                    "f32 state only (f64 runs on device='cpu')")
            # the strip maps, the DCT solve and the block-Jacobi GEMM are
            # full-f32 products in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
        self.forest.add_field("vel", 2)
        self.forest.add_field("pres", 1)
        self.time = 0.0
        self.step_count = 0
        self.p_inv = self._tensor(block_precond_matrix(cfg.bs))
        # f32 fields take their Krylov dot products in f64
        self.sum_dtype = (torch.float64 if self.dtype == torch.float32
                          else None)
        self._tables_version = -1
        self._tables = {}
        self._order = None
        # SFC-ordered compact working state ([n_pad, dim, BS, BS] per
        # field): the truth between regrids; the slot-layout fields are
        # synced lazily (sync_fields). _ord_key = (topology version,
        # fields write-version) detects external slot writes.
        self._ord = None
        self._ord_key = None
        self._ord_dirty = False
        # sticky block-axis padding (see _refresh_impl)
        self._npad_hwm = 128
        self._npad_floor = 128
        self._npad_quiet = 0
        self._coarse_cw = None
        self._next_umax = None      # device scalar; survives regrids
        self._next_umax_version = -1
        # production two-level trigger: engaged when the last production
        # solve took > 15 iterations, kept until the next topology change
        self._last_iters = 0
        self._coarse_on = False
        self._force_exact = False

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def reserve_blocks(self, n: int):
        """Pre-size the padded block axis for ``n`` active blocks."""
        self._npad_floor = max(
            self._npad_floor, 1 << max(0, int(n)).bit_length())
        self._npad_hwm = max(self._npad_hwm, self._npad_floor)

    # ------------------------------------------------------------------
    # topology-dependent cached state
    # ------------------------------------------------------------------
    def _refresh(self):
        if self._tables_version != self.forest.version:
            self._refresh_impl()

    def _refresh_impl(self):
        f = self.forest
        self._order = f.order()
        n_real = len(self._order)
        # the block axis is padded to a power-of-two bucket strictly
        # above n_real, so pad rows exist as dead scatter targets for the
        # table padding. The bucket is a sticky high-water mark: it steps
        # down one power of two only after the forest has stayed at a
        # quarter of it for 10 consecutive rebuilds.
        n_bucket = max(128, 1 << n_real.bit_length())
        if n_bucket >= self._npad_hwm:
            self._npad_hwm = n_bucket
            self._npad_quiet = 0
        elif 4 * n_bucket <= self._npad_hwm \
                and self._npad_hwm > self._npad_floor:
            self._npad_quiet += 1
            if self._npad_quiet >= 10:
                self._npad_hwm //= 2
                self._npad_quiet = 0
        else:
            self._npad_quiet = 0
        n_pad = self._npad_hwm
        if not f._free:
            f._grow()
        # pad rows gather an inactive slot: stale but finite data that
        # the mask zeroes
        pad_slot = f._free[-1]
        order_p = np.concatenate([
            self._order, np.full(n_pad - n_real, pad_slot, np.int32)])
        self._n_real = n_real
        self._mask = np.arange(n_pad) < n_real

        # one dense topology index shared by every table build
        topo = _TopoIndex(f, self._order)
        raw = {
            "vec3": build_tables(f, self._order, 3, True, 2, topo=topo),
            "vec1": build_tables(f, self._order, 1, False, 2, topo=topo),
            "sca1": build_tables(f, self._order, 1, False, 1, topo=topo),
            "vec1t": build_tables(f, self._order, 1, True, 2, topo=topo),
            "sca1t": build_tables(f, self._order, 1, True, 1, topo=topo),
        }
        fc = build_face_copy(f, self._order, n_pad, topo)
        self._tables = self._finalize_tables(raw, n_pad, fc)
        self._tables["pois"] = poisson_op(
            build_poisson_structured(f, self._order, n_pad, topo=topo),
            self.device, self.dtype)
        self._corr = flux_corr(
            build_flux_corr(f, self._order, n_pad=n_pad, topo=topo),
            self.device, self.dtype)
        # topology changed: the two-level trigger re-arms from scratch,
        # iteration evidence included (it described the old forest).
        # Startup (steps < 10) always uses the coarse maps; production
        # builds them lazily on the trigger.
        self._coarse_on = False
        self._last_iters = 0
        if self.step_count >= 10:
            self._coarse_cw = None
        else:
            self._build_coarse_maps(n_pad, n_real)

        h = f.h_per_block(self._order)
        hp = np.concatenate([h, np.ones(n_pad - n_real)])
        hsqp = np.concatenate([h * h, np.zeros(n_pad - n_real)])
        self._h = self._tensor(hp.reshape(-1, 1, 1, 1))
        self._hsq_flat = self._tensor(hsqp.reshape(-1, 1, 1))
        self._maskv = self._tensor(self._mask.reshape(-1, 1, 1, 1))
        self._order_j = self._index(order_p)
        self._tables_version = f.version

    def _build_coarse_maps(self, n_pad: int, n_real: int):
        """Host build of the two-level transfer structure, moved to the
        device: per active level, the owning ordered row of every tile of
        a uniform level image (``own``, with its 0/1 mask ``ownm``) and
        each block's tile index (``tid``, with ``selp``). Levels at or
        below the coarse level c keep full-domain images; finer levels
        are cropped to one shared window around their active tiles,
        padded by 2 coarse cells (the bilinear ladder's reach) and snapped
        to an alignment that keeps every fine level tile-aligned."""
        f = self.forest
        c = self._coarse_level = max(0, min(3, f.cfg.level_max - 1))
        bs_ = f.bs
        ncx = f.cfg.bpdx * bs_ << c
        ncy = f.cfg.bpdy * bs_ << c
        self._coarse_shape = (ncy, ncx)
        self._coarse_h2 = float(f.cfg.h_at(c)) ** 2
        fdt = f.np_dtype
        lvo = f.level[self._order].astype(np.int64)
        bio = f.bi[self._order].astype(np.int64)
        bjo = f.bj[self._order].astype(np.int64)
        active = sorted(int(v) for v in np.unique(lvo))
        fine_act = [l for l in active if l > c]
        crop = None
        if fine_act:
            align = 1
            for l in fine_act:
                align = math.lcm(align, bs_ // math.gcd(bs_, 1 << (l - c)))
            cj0 = ci0 = 1 << 30
            cj1 = ci1 = -1
            for l in fine_act:
                sel = lvo == l
                den = 1 << (l - c)       # level-l cells per coarse cell
                cj0 = min(cj0, int(bjo[sel].min()) * bs_ // den)
                ci0 = min(ci0, int(bio[sel].min()) * bs_ // den)
                cj1 = max(cj1, -(-(int(bjo[sel].max()) + 1) * bs_ // den))
                ci1 = max(ci1, -(-(int(bio[sel].max()) + 1) * bs_ // den))
            cj0 = max(0, cj0 - 2) // align * align
            ci0 = max(0, ci0 - 2) // align * align
            cj1 = -(-min(ncy, cj1 + 2) // align) * align
            ci1 = -(-min(ncx, ci1 + 2) // align) * align
            crop = (cj0, cj1, ci0, ci1)

        def entry(sel, tix, nty, ntx):
            # tiles owned by no level-l block gather the first pad row
            # (n_real < n_pad) and are zeroed by ownm
            own = np.full(nty * ntx, n_real, np.int64)
            own[tix] = np.nonzero(sel)[0]
            ownm = np.zeros(nty * ntx, fdt)
            ownm[tix] = 1.0
            tid = np.zeros(n_pad, np.int64)
            tid[:n_real][sel] = tix
            selp = np.zeros(n_pad, fdt)
            selp[:n_real][sel] = 1.0
            return (self._index(own.reshape(nty, ntx)),
                    self._tensor(ownm.reshape(nty, ntx)),
                    self._index(tid), self._tensor(selp))

        per_level, fine = {}, {}
        for l in active:
            sel = lvo == l
            if l <= c:
                ntx, nty = f.cfg.bpdx << l, f.cfg.bpdy << l
                per_level[l] = entry(sel, bjo[sel] * ntx + bio[sel],
                                     nty, ntx)
            else:
                cj0, cj1, ci0, ci1 = crop
                sc = 1 << (l - c)
                ntyw = (cj1 - cj0) * sc // bs_
                ntxw = (ci1 - ci0) * sc // bs_
                tix = ((bjo[sel] - cj0 * sc // bs_) * ntxw
                       + (bio[sel] - ci0 * sc // bs_))
                fine[l] = entry(sel, tix, ntyw, ntxw)
        cw = {"lev": per_level,
              "dct": tuple(self._tensor(a) for a in
                           dct_neumann_operators(ncy, ncx, dtype=fdt))}
        if fine:
            cw["levf"] = fine
            cw["crop"] = (crop[0], crop[2])   # window origin, coarse cells
        self._coarse_cw = cw

    # the hot-loop table sets that take the same-level face-copy path;
    # vec1t/sca1t are regrid-only and stay plain. Non-tensorial g=1 sets
    # never fill lab corners, so their paint is face-only.
    _FAST_SETS = {"vec3": True, "vec1": False, "sca1": False}

    def _finalize_tables(self, raw: dict, n_pad: int, fc) -> dict:
        out = {}
        for k, t in raw.items():
            if k in self._FAST_SETS:
                host = make_fast_tables(t, fc[0], fc[1], n_pad,
                                        corners=self._FAST_SETS[k])
            else:
                host = pad_tables(t, n_pad)
            out[k] = lab_tables(host, self.device, self.dtype)
        return out

    # ------------------------------------------------------------------
    # ordered working state
    # ------------------------------------------------------------------
    def _ordered_state(self) -> dict:
        f = self.forest
        self._refresh()
        key = (f.version, f.fields.wver)
        if self._ord_key == key and self._ord is not None:
            return self._ord
        if self._ord_dirty:
            raise RuntimeError(
                "slot fields were written while the ordered working "
                "state held newer data; call sync_fields() before "
                "writing forest.fields")
        if self._ord_key is not None and self._ord_key[0] == f.version \
                and self._ord_key != key:
            # same topology, fields rewritten externally: the cached
            # end-state umax describes the overwritten field
            self._next_umax = None
        self._ord = {name: fld[self._order_j]
                     for name, fld in f.fields.items()}
        self._ord_key = key
        return self._ord

    def sync_fields(self):
        """Write the ordered working state back into the slot-layout
        fields (regrids, dumps and tests read slots). No-op when in
        sync. The slot tensors are updated in place."""
        if not self._ord_dirty:
            return
        f = self.forest
        order = self._index(self._order)
        for name, x in self._ord.items():
            fld = f.fields[name]
            fld[order] = x[:self._n_real]
            f.fields[name] = fld
        self._ord_key = (f.version, f.fields.wver)
        self._ord_dirty = False

    def fields(self) -> dict:
        """Slot-layout fields, guaranteed current."""
        self.sync_fields()
        return self.forest.fields

    def _set_ordered(self, **updates):
        self._ord = {**self._ord, **updates}
        self._ord_dirty = True

    def load_forest(self, blocks: dict, fields: dict):
        """Replace the topology by ``blocks`` ({(level, i, j): slot}) and
        the fields by slot-layout arrays indexed by those slots (name ->
        [capacity, dim, BS, BS]); fields not given restart at zero. The
        port assigns its own slots."""
        f = self.forest
        self.sync_fields()
        for key in list(f.blocks):
            f.release(*key)
        keys = list(blocks)
        src = np.asarray([blocks[k] for k in keys], np.int64)
        dst = self._index([f.allocate(*k) for k in keys])
        for name in list(f.fields):
            out = torch.zeros_like(f.fields[name])
            if name in fields:
                out[dst] = self._tensor(np.asarray(fields[name])[src])
            f.fields[name] = out
        self._ord = None
        self._ord_key = None
        self._next_umax = None

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------
    def _advect_rk2(self, vel, h, dt, t3, corr, maskv):
        """Heun RK2 advection-diffusion with per-block h; diffusive face
        fluxes corrected at level interfaces after each stage
        (main.cpp:6607-6642). ``maskv`` zeroes the pad rows each stage."""
        nu = self.cfg.nu
        ih2 = 1.0 / (h * h)
        vold = vel * maskv
        v = vold
        for c in (0.5, 1.0):
            lab = assemble_labs_ordered(v if c == 1.0 else vel, t3)
            rhs = fused_lab_rhs(lab, h, nu, dt)
            rhs = apply_flux_corr(
                rhs, diffusive_deposits(lab, 3, nu * dt), corr)
            v = heun_substage(vold, c, rhs, ih2) * maskv
        return v

    def _pressure_project(self, v, pres, dt, h, hsq, t1v, t1s, tpois,
                          corr, tcoarse, exact_poisson, maskv):
        """deltap Poisson solve and projection (main.cpp:7007-7187) with
        the flux-corrected divergence RHS and the makeFlux operator.
        Returns (v_new, p_new, res, div_linf)."""
        cfg = self.cfg
        ih2 = 1.0 / (h * h)
        pord = pres[:, 0] * maskv[:, 0]          # [N,BS,BS]
        vlab = assemble_labs_ordered(v, t1v)
        fac = 0.5 * h[:, 0] / dt
        b = fac * divergence(vlab, 1)
        b = apply_flux_corr(
            b, divergence_deposits(vlab, None, None, fac[:, 0, 0]), corr)
        # max |div u| of the pre-projection velocity, from the RHS
        div_linf = torch.amax(
            torch.abs(b) * maskv[:, 0] * (dt / (h[:, 0] * h[:, 0])))

        def A(x):
            return poisson_apply_structured(x, tpois)

        # initial-guess subtraction through A itself
        b = b - A(pord)

        def M(r):
            return apply_block_precond_blocks(r, self.p_inv)

        if tcoarse is not None:
            dctops = tcoarse["dct"]
            cih2 = torch.where(hsq > 0,
                               1.0 / torch.where(hsq > 0, hsq, 1.0), 0.0)
            _deposit, _interp = self._coarse_transfers(tcoarse)
            # production solves: the additive form; startup (exact)
            # solves: multiplicative; CUP2D_POIS=fft: mg2 (pre-smooth,
            # spectral correction, post-smooth)
            form = self._twolevel_form or (
                "mult" if exact_poisson else
                ("mg2" if self._pois_mode == "fft" else "additive"))
            if form == "additive":
                def M(r):
                    rc = _deposit(r * cih2)
                    ec = coarse_neumann_solve_dct(
                        rc, dctops, self._coarse_h2)
                    return _interp(ec, r) + apply_block_precond_blocks(
                        r, self.p_inv)
            elif form == "mg2":
                def M(r):
                    e = apply_block_precond_blocks(r, self.p_inv)
                    r1 = r - A(e)
                    rc = _deposit(r1 * cih2)
                    ec = coarse_neumann_solve_dct(
                        rc, dctops, self._coarse_h2)
                    e = e + _interp(ec, r)
                    return e + apply_block_precond_blocks(
                        r - A(e), self.p_inv)
            else:
                def M(r):
                    rc = _deposit(r * cih2)
                    ec = coarse_neumann_solve_dct(
                        rc, dctops, self._coarse_h2)
                    e = _interp(ec, r)
                    return e + apply_block_precond_blocks(
                        r - A(e), self.p_inv)

        if self._pois_mode in ("fas", "fas-f") and not exact_poisson:
            # the forest FAS hierarchy as the production solver;
            # exact solves keep Krylov as the backstop
            paint_fine, base_solve, extract_all = \
                self._fas_transfers(tcoarse)
            mgc = ForestFASCycle(
                A, self._fas_block_smoother(A), paint_fine, base_solve,
                extract_all, cih2)
            res = mg_solve(
                A, b, mgc,
                tol=cfg.poisson_tol, tol_rel=cfg.poisson_tol_rel,
                max_cycles=cfg.max_poisson_iterations,
                fmg=self._pois_mode == "fas-f")
        else:
            # cold startup solves start from x0 = M(b), which removes the
            # global pressure modes before the Krylov iteration; exact
            # mode converges three orders past the production target
            x0 = None
            if exact_poisson and tcoarse is not None:
                x0 = M(b)
            res = bicgstab(
                A, b, M=M, x0=x0,
                tol=1e-3 * cfg.poisson_tol if exact_poisson
                else cfg.poisson_tol,
                tol_rel=1e-3 * cfg.poisson_tol_rel if exact_poisson
                else cfg.poisson_tol_rel,
                max_iter=cfg.max_poisson_iterations,
                max_restarts=100 if exact_poisson
                else cfg.max_poisson_restarts,
                sum_dtype=self.sum_dtype,
                refresh_every=10 if exact_poisson else 50,
                stall_iters=15 if exact_poisson else 120,
                stall_rtol=0.99 if exact_poisson else 0.999,
            )

        # volume-weighted mean removal (main.cpp:7120-7173)
        wsum = torch.sum(hsq) * cfg.bs ** 2
        dp = res.x - torch.sum(res.x * hsq) / wsum
        p_new = dp + pord - torch.sum(pord * hsq) / wsum

        # projection with per-block h, gradient fluxes corrected
        # (pressureCorrectionKernel + fillcases, main.cpp:7174-7187)
        plab = assemble_labs_ordered(p_new[:, None], t1s)
        dv = pressure_gradient_update(plab[:, 0], 1, h, dt)
        pfac = -0.5 * dt * h[:, 0, 0, 0]
        dv = apply_flux_corr(dv, gradient_deposits(plab[:, 0], pfac), corr)
        v = (v + dv * ih2) * maskv
        return v, p_new[:, None], res, div_linf

    def _coarse_transfers(self, tcoarse):
        """The two-level transfer pair (deposit: ordered blocks -> coarse
        image; interp: coarse image -> ordered blocks). Level images
        chain by 2x mean / bilinear steps; levels finer than c live in
        the cropped window."""
        lev = tcoarse["lev"]
        levf = tcoarse.get("levf", {})
        ncy, ncx = self._coarse_shape
        c = self._coarse_level
        bs = self.cfg.bs
        if levf:
            l0 = min(levf)
            sc0 = 1 << (l0 - c)
            hw, ww = levf[l0][0].shape
            wHc, wWc = hw * bs // sc0, ww * bs // sc0   # window, coarse
            oy, ox = tcoarse["crop"]

        def _deposit(rp):
            rc = rp.new_zeros((ncy, ncx))
            for l in sorted(lev):               # levels <= c
                img = _tiles_img(lev[l], rp, bs)
                # coarser than c: spread the cell's unit deposit
                # uniformly over its coarse footprint
                for _ in range(c - l):
                    img = img.repeat_interleave(2, 0) \
                             .repeat_interleave(2, 1) * 0.25
                rc = rc + img
            for l in sorted(levf):              # levels > c, cropped
                img = _tiles_img(levf[l], rp, bs)
                # each fine cell deposits its area fraction 4^(c-l)
                for _ in range(l - c):
                    img = _down2_mean(img)
                rc[oy:oy + wHc, ox:ox + wWc] += img
            return rc

        def _interp(ec, like):
            # images are kept only for levels with active blocks; gap
            # levels still take their ladder step
            e = torch.zeros_like(like)
            if c in lev:
                e = _extract_tiles(ec, lev[c], e, bs)
            a = ec
            for l in range(c - 1, (min(lev) if lev else c) - 1, -1):
                a = _down2_mean(a)
                if l in lev:
                    e = _extract_tiles(a, lev[l], e, bs)
            if levf:
                a = ec[oy:oy + wHc, ox:ox + wWc]
                for l in range(c + 1, max(levf) + 1):
                    a = _up2_bilinear(a)
                    if l in levf:
                        e = _extract_tiles(a, levf[l], e, bs)
            return e

        return _deposit, _interp

    def _fas_transfers(self, tcoarse):
        """Transfer closures of the forest FAS hierarchy, from the same
        maps as the two-level preconditioner: (paint_fine, base_solve,
        extract_all), see ``poisson.ForestFASCycle``."""
        lev = tcoarse["lev"]
        levf = tcoarse.get("levf", {})
        ncy, ncx = self._coarse_shape
        c = self._coarse_level
        bs = self.cfg.bs
        ch2 = self._coarse_h2
        dctops = tcoarse["dct"]
        lf = max(levf) if levf else c
        if levf:
            l0 = min(levf)
            sc0 = 1 << (l0 - c)
            hw, ww = levf[l0][0].shape
            wHc, wWc = hw * bs // sc0, ww * bs // sc0
            oy, ox = tcoarse["crop"]

        def paint_fine(rdiv):
            imgs = []
            for l in range(lf, c, -1):  # finest ladder level first
                if l in levf:
                    img = _tiles_img(levf[l], rdiv, bs) \
                        * (ch2 / 4 ** (l - c))
                else:
                    sc = 1 << (l - c)
                    img = rdiv.new_zeros((wHc * sc, wWc * sc))
                imgs.append(img)
            return imgs

        def base_solve(rdiv, racc):
            rc = rdiv.new_zeros((ncy, ncx))
            for l in sorted(lev):       # levels <= c, full domain
                img = _tiles_img(lev[l], rdiv, bs)
                # rdiv is pointwise: a cell coarser than c replicates its
                # value over its footprint
                for _ in range(c - l):
                    img = img.repeat_interleave(2, 0).repeat_interleave(2, 1)
                rc = rc + img
            awin = None
            if racc is not None:
                rc[oy:oy + wHc, ox:ox + wWc] += racc / ch2
            ec = coarse_neumann_solve_dct(rc, dctops, ch2)
            if levf:
                awin = ec[oy:oy + wHc, ox:ox + wWc]
            return ec, awin

        def extract_all(ec, es):
            e = None
            for i, l in enumerate(range(lf, c, -1)):
                if l in levf:
                    base = ec.new_zeros((self._npad_hwm, bs, bs)) \
                        if e is None else e
                    e = _extract_tiles(es[i], levf[l], base, bs)
            if e is None:
                e = ec.new_zeros((self._npad_hwm, bs, bs))
            if c in lev:
                e = _extract_tiles(ec, lev[c], e, bs)
            a = ec
            for l in range(c - 1, (min(lev) if lev else c) - 1, -1):
                a = _down2_mean(a)
                if l in lev:
                    e = _extract_tiles(a, lev[l], e, bs)
            return e

        return paint_fine, base_solve, extract_all

    def _fas_block_smoother(self, A):
        """Composite-level smoother of the forest FAS cycle: damped
        block-Jacobi sweeps e += P_inv (r - A e). Each sweep's update is
        ``fused_block_jacobi_update`` (the kernel on the card); the
        from-zero head is a bare ``apply_block_precond_blocks``."""
        p_inv = self.p_inv

        def smooth(e, r, n, from_zero=False):
            if from_zero and n > 0:
                e = apply_block_precond_blocks(r, p_inv)
                n -= 1
            for _ in range(n):
                e = fused_block_jacobi_update(e, r, A(e), p_inv)
            return e

        return smooth

    def _precond_cycles(self, res, tcoarse, exact_poisson) -> int:
        """Coarse-correction cycles of one solve: FAS iterations are
        cycles; flexible BiCGSTAB applies M twice per iteration, plus the
        x0 = M(b) of exact cold starts; 0 without the two-level maps."""
        if self._pois_mode in ("fas", "fas-f") and not exact_poisson:
            return res.iters
        if tcoarse is None:
            return 0
        return 2 * res.iters + (1 if exact_poisson else 0)

    @property
    def poisson_mode(self) -> str:
        """The production solve path: bicgstab+jacobi |
        bicgstab+twolevel | bicgstab+fft | fas+forest | fas-f+forest."""
        if self._pois_mode == "fft":
            return "bicgstab+fft"
        if self._pois_mode in ("fas", "fas-f"):
            return self._pois_mode + "+forest"
        return ("bicgstab+twolevel" if self._coarse_on
                else "bicgstab+jacobi")

    @property
    def smoother_tier(self) -> str:
        """"strip" when the FAS composite smoother runs the block-Jacobi
        kernel (fas modes on the card), else "xla" (the plain
        composition, as in the reference's XLA tier)."""
        if self._pois_mode in ("fas", "fas-f") \
                and self.device.type == "cuda":
            return "strip"
        return "xla"

    def _energy(self, v, hsq):
        vv = v.to(self.sum_dtype) if self.sum_dtype is not None else v
        return 0.5 * torch.sum(vv * vv * hsq[:, None].to(vv.dtype))

    @staticmethod
    def _finite_flag(v, p_new, maskv):
        return torch.isfinite(v).all() & torch.isfinite(
            torch.where(maskv > 0, p_new, 0.0)).all()

    def _step_impl(self, vel, pres, dt, h, hsq, maskv, t3, t1v, t1s,
                   tpois, corr, tcoarse, exact_poisson=False):
        v = self._advect_rk2(vel, h, dt, t3, corr, maskv)
        v, p_new, res, div_linf = self._pressure_project(
            v, pres, dt, h, hsq, t1v, t1s, tpois, corr, tcoarse,
            exact_poisson, maskv)
        diag = {
            "poisson_iters": res.iters,
            "poisson_residual": res.residual,
            "poisson_stalled": res.stalled,
            "poisson_converged": res.converged,
            "finite": self._finite_flag(v, p_new, maskv),
            "umax": torch.amax(torch.abs(v)),
            "energy": self._energy(v, hsq),
            "div_linf": div_linf,
            "precond_cycles": self._precond_cycles(
                res, tcoarse, exact_poisson),
        }
        return v, p_new, diag

    def _vorticity_impl(self, vel, h, t1v):
        """Per-block Linf of vorticity (the refinement tag,
        main.cpp:4671-4688)."""
        lab = assemble_labs_ordered(vel, t1v)
        w = vorticity(lab, 1, h[:, 0])             # [N, BS, BS]
        return torch.amax(torch.abs(w), dim=(-1, -2))

    def _prolong_impl(self, field, parents, order, t):
        """Parent blocks -> [R, 4, dim, BS, BS] children by the
        reference's 2nd-order Taylor prolongation (main.cpp:5002-5028),
        from tensorial g=1 labs (corner ghosts for the xy term)."""
        lab = assemble_labs(field, order, t)[parents]   # [R, dim, L, L]
        bs = self.cfg.bs

        def at(dy, dx):
            return lab[..., 1 + dy:bs + 1 + dy, 1 + dx:bs + 1 + dx]

        l00, lp0, lm0 = at(0, 0), at(0, 1), at(0, -1)
        l0p, l0m = at(1, 0), at(-1, 0)
        lpp, lmm, lpm, lmp = at(1, 1), at(-1, -1), at(-1, 1), at(1, -1)
        x = 0.5 * (lp0 - lm0)
        y = 0.5 * (l0p - l0m)
        x2 = (lp0 + lm0) - 2.0 * l00
        y2 = (l0p + l0m) - 2.0 * l00
        xy = 0.25 * ((lpp + lmm) - (lpm + lmp))
        base = l00 + 0.03125 * (x2 + y2)
        fine = lab.new_zeros(lab.shape[:2] + (2 * bs, 2 * bs))
        # fine block of child (I, J): rows 2j(+1), cols 2i(+1)
        fine[..., 0::2, 0::2] = base - 0.25 * x - 0.25 * y + 0.0625 * xy
        fine[..., 0::2, 1::2] = base + 0.25 * x - 0.25 * y - 0.0625 * xy
        fine[..., 1::2, 0::2] = base - 0.25 * x + 0.25 * y - 0.0625 * xy
        fine[..., 1::2, 1::2] = base + 0.25 * x + 0.25 * y + 0.0625 * xy
        return torch.stack([fine[..., :bs, :bs], fine[..., :bs, bs:],
                            fine[..., bs:, :bs], fine[..., bs:, bs:]],
                           dim=1)

    # ------------------------------------------------------------------
    # host driver
    # ------------------------------------------------------------------
    def _dt_from_umax(self, umax, hmin):
        return dt_from_umax(umax, hmin, self.cfg.nu, self.cfg.cfl)

    def _hmin(self) -> torch.Tensor:
        """Finest active spacing, in the forest dtype."""
        return torch.tensor(
            self.cfg.h_at(int(self.forest.level[self._order].max())),
            dtype=self.dtype, device=self.device)

    def compute_dt(self) -> float:
        # masked: ordered pad rows carry stale (finite) data
        umax = torch.amax(
            torch.abs(self._ordered_state()["vel"]) * self._maskv)
        return float(self._dt_from_umax(umax, self._hmin()))

    def _use_coarse(self, exact: bool):
        """Coarse-correction maps for the next solve: always for the
        startup (exact) solves; for production, engaged when the last
        solve took > 15 iterations and kept until the next topology
        change; always under fft, fas and fas-f. Built lazily."""
        if not exact:
            if self._pois_mode in ("fft", "fas", "fas-f"):
                self._coarse_on = True
            if not self._coarse_on and self._last_iters > 15:
                self._coarse_on = True
            if not self._coarse_on:
                return None
        if self._coarse_cw is None:
            self._build_coarse_maps(self._npad_hwm, self._n_real)
        return self._coarse_cw

    def step_once(self, dt: Optional[float] = None) -> dict:
        """One step: dt from the cached end-state umax of the previous
        step (x1.05 after a regrid, the prolongation-overshoot guard) or
        a fresh reduction; the reference's exact solves for the first 10
        steps. Returns the step diagnostics as host values."""
        self._refresh()
        f = self.forest
        ordf = self._ordered_state()
        if dt is None:
            if self._next_umax is not None:
                fac = (1.0 if self._next_umax_version == f.version
                       else 1.05)
                dt = float(self._dt_from_umax(fac * self._next_umax,
                                              self._hmin()))
            else:
                dt = self.compute_dt()
        exact = self.step_count < 10 or self._force_exact
        dt_dev = torch.tensor(dt, dtype=self.dtype, device=self.device)
        vel, pres, diag = self._step_impl(
            ordf["vel"], ordf["pres"], dt_dev, self._h, self._hsq_flat,
            self._maskv, self._tables["vec3"], self._tables["vec1"],
            self._tables["sca1"], self._tables["pois"], self._corr,
            self._use_coarse(exact), exact_poisson=exact)
        self._set_ordered(vel=vel, pres=pres)
        self._next_umax = diag["umax"]
        self._next_umax_version = f.version
        if not exact:
            # exact-startup counts converge deeper with another M and
            # must not trip the production trigger
            self._last_iters = diag["poisson_iters"]
        diag = {k: (v.item() if torch.is_tensor(v) else v)
                for k, v in diag.items()}
        diag["dt"] = float(dt)
        self.time += dt
        self.step_count += 1
        return diag

    # -- regrid --------------------------------------------------------
    def adapt(self) -> bool:
        """Tag / 2:1-balance / refine / coarsen (main.cpp:4657-5440).
        Returns whether the topology changed."""
        self._refresh()
        f = self.forest
        cfg = self.cfg
        ordf = self._ordered_state()
        tags = self._vorticity_impl(
            ordf["vel"], self._h, self._tables["vec1"]).cpu().numpy()
        tags = tags[:self._n_real]
        order = self._order
        # 1 = refine, -1 = compress, 0 = leave
        lv = f.level[order].astype(np.int64)
        biv = f.bi[order].astype(np.int64)
        bjv = f.bj[order].astype(np.int64)
        st = np.where(
            (tags > cfg.rtol) & (lv < cfg.level_max - 1), 1,
            np.where((tags < cfg.ctol) & (lv > 0), -1, 0)).astype(np.int8)
        return self._commit_states(lv, biv, bjv, st)

    def _commit_states(self, lv, biv, bjv, st) -> bool:
        """2:1 state fixing, refine/compress extraction, one regrid.
        Returns whether anything changed."""
        if not st.any():
            return False
        self._fix_states(lv, biv, bjv, st)
        refine = [(int(lv[k]), int(biv[k]), int(bjv[k]))
                  for k in np.nonzero(st == 1)[0]]
        groups = self._compress_groups(lv, biv, bjv, st)
        if not refine and not groups:
            return False
        self._apply_regrid(refine, groups)
        return True

    def _fix_states(self, lv, biv, bjv, st):
        """2:1 balance sweeps on ``st`` in place (the pure-Python body;
        the JAX package's native C helper is not ported)."""
        state = {(int(lv[k]), int(biv[k]), int(bjv[k])): int(st[k])
                 for k in range(len(st))}
        self._fix_states_py(state)
        for k in range(len(st)):
            st[k] = state[(int(lv[k]), int(biv[k]), int(bjv[k]))]

    def _fix_states_py(self, state):
        """Finest level first (main.cpp:4734-4861): a block with a
        refining finer neighbour must refine; compressing next to a finer
        or refining neighbour must stay."""
        f = self.forest
        cfg = self.cfg
        for m in range(cfg.level_max - 1, -1, -1):
            for key in list(state.keys()):
                l, i, j = key
                if l != m or state[key] == 1 or l == cfg.level_max - 1:
                    continue
                nbx, nby = f.nblocks_at(l)
                for cx in (-1, 0, 1):
                    for cy in (-1, 0, 1):
                        if cx == 0 and cy == 0:
                            continue
                        ni, nj = i + cx, j + cy
                        if not (0 <= ni < nbx and 0 <= nj < nby):
                            continue
                        if f.owner_relation(l, ni, nj) != -1:
                            continue
                        if state[key] == -1:
                            state[key] = 0
                        # any refining finer neighbour forces refinement
                        for (a, b) in [(0, 0), (0, 1), (1, 0), (1, 1)]:
                            ck = (l + 1, 2 * ni + a, 2 * nj + b)
                            if state.get(ck, 0) == 1:
                                state[key] = 1
                                break
                        if state[key] == 1:
                            break
                    if state[key] == 1:
                        break
            # compressing next to a same-level refining neighbour
            for key in list(state.keys()):
                l, i, j = key
                if l != m or state[key] != -1:
                    continue
                for cx in (-1, 0, 1):
                    for cy in (-1, 0, 1):
                        if cx == 0 and cy == 0:
                            continue
                        nk = (l, i + cx, j + cy)
                        if nk in state and state[nk] == 1:
                            state[key] = 0
                            break
                    if state[key] == 0:
                        break

    @staticmethod
    def _compress_groups(lv, biv, bjv, st):
        """Sibling groups whose 4 blocks all exist and want compression
        (main.cpp:4826-4861): a parent with four compressing children."""
        cand = np.nonzero(st == -1)[0]
        if len(cand) == 0:
            return []
        parents = np.stack(
            [lv[cand], biv[cand] >> 1, bjv[cand] >> 1], axis=1)
        uniq, counts = np.unique(parents, axis=0, return_counts=True)
        groups = []
        for l, pi, pj in uniq[counts == 4]:
            i0, j0 = 2 * int(pi), 2 * int(pj)
            groups.append([(int(l), i0 + a, j0 + b)
                           for a in (0, 1) for b in (0, 1)])
        return groups

    def _apply_regrid(self, refine_keys, groups):
        """Refinement and compression of every field (refinement
        main.cpp:4960-5033, compression 5055-5194). All gathers read the
        pre-regrid fields, so refine writes cannot corrupt compress
        reads. Unlike the reference, nothing is padded: the port compiles
        nothing per shape."""
        f = self.forest
        self.sync_fields()
        ordpos = {int(s): k for k, s in enumerate(self._order)}
        parents = [ordpos[f.blocks[k]] for k in refine_keys]
        sib_slots = [[f.blocks[(l, i0 + a, j0 + b)] for (a, b) in _QUAD]
                     for (l, i0, j0) in (g[0] for g in groups)]
        child_slots = []
        for (l, i, j) in refine_keys:
            f.release(l, i, j)
            child_slots += [f.allocate(l + 1, 2 * i + a, 2 * j + b)
                            for (a, b) in _QUAD]
        parent_slots = []
        for sibs in groups:
            l, i0, j0 = sibs[0]
            for (a, b) in _QUAD:
                f.release(l, i0 + a, j0 + b)
            parent_slots.append(f.allocate(l - 1, i0 // 2, j0 // 2))
        f.fields.update(self._regrid_apply_impl(
            dict(f.fields), self._order_j, self._index(parents),
            self._index(child_slots), self._index(sib_slots),
            self._index(parent_slots), self._tables["vec1t"],
            self._tables["sca1t"]))

    def _regrid_apply_impl(self, fields, order, parents, child_slots,
                           sib_slots, parent_slots, tv, ts):
        """Per field: Taylor prolongation of the refined parents into the
        child slots, then 4->1 averaging of the compression groups into
        the parent slots."""
        out = {}
        for name, field in fields.items():
            new = field.clone()
            if len(parents):
                t = tv if field.shape[1] == 2 else ts
                p = self._prolong_impl(field, parents, order, t)
                new[child_slots] = p.reshape((-1,) + p.shape[2:])
            if len(parent_slots):
                d = field[sib_slots]   # [G, 4, dim, BS, BS]
                restr = 0.25 * (
                    d[..., 0::2, 0::2] + d[..., 1::2, 0::2]
                    + d[..., 0::2, 1::2] + d[..., 1::2, 1::2])
                row0 = torch.cat([restr[:, 0], restr[:, 1]], dim=-1)
                row1 = torch.cat([restr[:, 2], restr[:, 3]], dim=-1)
                new[parent_slots] = torch.cat([row0, row1], dim=-2)
            out[name] = new
        return out

    def run(self, tend: float, max_steps: int = 10**9) -> dict:
        """Step to ``tend``, adapting every step up to step 10 and every
        ``adapt_steps`` after (the reference's schedule)."""
        diag = {}
        while self.time < tend and self.step_count < max_steps:
            if (self.step_count <= 10
                    or self.step_count % self.cfg.adapt_steps == 0):
                self.adapt()
            diag = self.step_once()
        return diag


# ---------------------------------------------------------------------------
# Synthetic vortex forests (the JAX package's scale-proof and
# multilevel A/B states, rewritten here)
# ---------------------------------------------------------------------------

def _block_centres(sim):
    """Cell-centre coordinates [n, BS, BS] of the active blocks in SFC
    order, and that order."""
    f = sim.forest
    order = f.order()
    bs = sim.cfg.bs
    h = sim.cfg.h0 / (1 << f.level[order]).astype(np.float64)
    x0 = f.bi[order].astype(np.float64) * bs * h
    y0 = f.bj[order].astype(np.float64) * bs * h
    ar = np.arange(bs) + 0.5
    X = np.broadcast_to(
        x0[:, None, None] + ar[None, None, :] * h[:, None, None],
        (len(order), bs, bs))
    Y = np.broadcast_to(
        y0[:, None, None] + ar[None, :, None] * h[:, None, None],
        (len(order), bs, bs))
    return X, Y, order


def _write_velocity(sim, order, u, v):
    f = sim.forest
    vals = np.zeros((f.capacity, 2, sim.cfg.bs, sim.cfg.bs))
    vals[order, 0] = u
    vals[order, 1] = v
    f.fields["vel"] = torch.as_tensor(vals, device=sim.device).to(
        sim.dtype)


def _vortex(X, Y, cx, cy, gam, sig):
    """Lamb-Oseen-like vortex of circulation ``gam`` and core ``sig``."""
    dx, dy = X - cx, Y - cy
    r2 = dx * dx + dy * dy
    ut = gam / (2 * np.pi * np.sqrt(r2 + 1e-8)) \
        * (1 - np.exp(-r2 / (2 * sig ** 2)))
    th = np.arctan2(dy, dx)
    return -ut * np.sin(th), ut * np.cos(th)


def vortex_forest(target: int = 10000, level_max: int = 8,
                  level_start: int = 6, rtol: float = 0.05,
                  dtype: str = "float32", device=None,
                  seed: int = 7) -> AMRSim:
    """The 1e4-block regime of the canonical domain (bpdx 2, bpdy 1,
    extent 4): a uniform ``level_start`` grid (8,192 blocks at 6) seeded
    with 8 strong vortices at centres from ``np.random.default_rng(seed)``
    and adapted by the production vorticity tags until ``target`` blocks
    are active (or the tags stop refining). Compression is off
    (ctol = -1). The step counter is left at 0, so the first 10 steps are
    the exact startup solves."""
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=level_max,
                    level_start=level_start, extent=4.0, dtype=dtype,
                    nu=4e-5, cfl=0.5, rtol=rtol, ctol=-1.0,
                    poisson_tol=1e-3, poisson_tol_rel=1e-2,
                    max_poisson_iterations=1000, adapt_steps=5)
    sim = AMRSim(cfg, shapes=[], device=device)
    X, Y, order = _block_centres(sim)
    rng = np.random.default_rng(seed)
    centres = rng.uniform([0.5, 0.3], [3.5, 1.7], size=(8, 2))
    u = np.zeros(X.shape)
    v = np.zeros(X.shape)
    for cx, cy in centres:
        du, dv = _vortex(X, Y, cx, cy, 0.8, 0.03)
        u += du
        v += dv
    _write_velocity(sim, order, u, v)
    while len(sim.forest.blocks) < target and sim.adapt():
        pass
    return sim


def _seed_multilevel(sim):
    X, Y, order = _block_centres(sim)
    xs, ys = np.pi * X, np.pi * Y
    u = 0.2 * np.sin(xs) * np.cos(ys)
    v = -0.2 * np.cos(xs) * np.sin(ys)
    for cx, cy, sg, g in ((0.31, 0.62, 0.030, 0.8),
                          (0.68, 0.37, 0.045, -0.6)):
        du, dv = _vortex(X, Y, cx, cy, g, sg)
        u = u + du
        v = v + dv
    _write_velocity(sim, order, u, v)


def multilevel_forest(bpd: int = 4, level_start: int = 1,
                      level_max: int = 5, dtype: str = "float64",
                      tol: float = 1e-3, tol_rel: float = 1e-2,
                      rtol: float = 30.0, rounds: int = 4,
                      device=None) -> AMRSim:
    """A small multilevel forest on the unit square: a Taylor-Green
    background plus two vortices, refined by the production vorticity
    tags for up to ``rounds`` adapts (re-seeded analytically after each,
    so fine blocks carry their own-resolution content). Levels span both
    sides of the coarse base level c = min(3, level_max - 1). The step
    counter is set to 20, past the exact startup solves."""
    cfg = SimConfig(bpdx=bpd, bpdy=bpd, level_max=level_max,
                    level_start=level_start, extent=1.0, nu=4e-5,
                    cfl=0.5, dtype=dtype, rtol=rtol, ctol=-1.0,
                    poisson_tol=tol, poisson_tol_rel=tol_rel,
                    max_poisson_iterations=2000)
    sim = AMRSim(cfg, shapes=[], device=device)
    _seed_multilevel(sim)
    for _ in range(rounds):
        if not sim.adapt():
            break
        _seed_multilevel(sim)
    sim.step_count = 20
    return sim
