"""Adaptive simulation on the block forest, with or without immersed
obstacles: the counterpart of ``cup2d_tpu.amr.AMRSim`` (the reference's
adapt(), main.cpp:4657-5440, and its hot loop, 6576-7290).

host (numpy, per regrid)          device (torch, per step)
-------------------------------   ---------------------------------------
tagging decisions + 2:1 sweeps    vorticity + chi tags (lab + reduction)
slot alloc/release, SFC order     SDF/udef rasterization of each shape's
halo gather-table rebuild           window blocks, chi from the combined
window block selection              sdf lab, integrals, udef de-meaning
shape kinematics (models/)        WENO5 Heun advection-diffusion over all
flux-correction rows                blocks (``fused_lab_rhs``), diffusive
two-level / FAS transfer maps       fluxes corrected at level interfaces
                                  rigid momentum solve, collisions,
                                    implicit penalization (ops/obstacle,
                                    ops/collision)
                                  makeFlux variable-resolution pressure
                                    solve (BiCGSTAB with block-Jacobi and
                                    the two-level coarse correction, or
                                    the forest FAS hierarchy with
                                    ``fused_block_jacobi_update``)
                                  surface forces per block (G = 4 labs)
                                  prolongation / restriction of regrids

Tables and maps are built on the host once per regrid and moved to the
device then, not once per step. The solvers are host loops reading one or
two device flags per iteration (``poisson.bicgstab``/``mg_solve``), so
they take the JAX loop's branches and match its iteration counts.

With shapes (``make_shapes(cfg)`` when none are given), a step is the
JAX package's megastep: rasterize, flow, the next dt from this step's
umax and, every ``compute_forces_every`` steps, the force pass; then ONE
stacked copy to the host (uvw, CoM, mass, inertia, the next dt, the
diagnostics and the forces). An ``adapt()`` reads the fused tags once and
``initialize()`` reads its all-zero check once. ``initialize()`` climbs
from the coarsest grid toward the bodies, rasterizes and adapts up to
levelMax rounds, then blends the initial velocity with the deformation
velocity by chi.

Device policy: ``AMRSim`` runs on ``cuda`` unless given ``device="cpu"``;
without a card and without a device it raises. The card runs f32 state
only. On the card the two forest kernels always run, on the CPU their
plain twins. ``torch.backends.cuda.matmul.allow_tf32`` is set False on the
card: the structured operator's strip maps, the DCT base solve and the
block-Jacobi GEMM are full-f32 products in the reference.

Environment, latched once per sim as the reference does: ``CUP2D_POIS``
(unset/structured: BiCGSTAB + block-Jacobi with the iters>15 two-level
trigger, on the structured per-face operator; tables: the same solver on
the lab-table form of the operator, ``flux.build_poisson_tables``; fft:
the two-level correction always on in its mg2 form; fas/fas-f: the forest
FAS hierarchy as the production solver), ``CUP2D_TWOLEVEL``
(additive|mult|mg2, forcing one two-level form) and ``CUP2D_PREC`` (bf16,
with fas|fas-f and f32 state only: the FAS cycle's window-image ladder
legs in bf16, ``poisson.ForestFASCycle(leg_dtype=)``).
``async_diag`` (set by ``resilience.StepGuard(lag=True)``) makes the
obstacle-free step read nothing: dt stays a device scalar and the guard's
lagged verdict settles the clock; the shaped step verdicts eagerly.
``timers`` (item 9) refuses when set.
``fftd`` and non-free-slip boundary tables refuse as in the reference.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import native
from .config import SimConfig
from .flux import (apply_flux_corr, build_flux_corr,
                   build_poisson_structured, build_poisson_tables,
                   diffusive_deposits, divergence_deposits, flux_corr,
                   gradient_deposits, poisson_apply_structured, poisson_op)
from .forest import Forest
from .halo import (_TopoIndex, _bucket, assemble_labs,
                   assemble_labs_ordered, build_face_copy, build_tables,
                   lab_tables, make_fast_tables, pad_tables)
from .ops.collision import merged_overlap_integrals, \
    pairwise_collision_update
from .ops.forces import surface_forces_blocks
from .ops.hopper_kernels import fused_block_jacobi_update, fused_lab_rhs
from .ops.obstacle import (chi_from_sdf, midline_udef_packed, pack_midline,
                           pack_polygon_segments, penalization_integrals,
                           polygon_sdf_seg, shape_integrals,
                           solve_rigid_momentum)
from .ops.stencil import (divergence, dt_from_umax, heun_substage,
                          laplacian5, pressure_gradient_update, vorticity)
from .parallel.shard_halo import per_shard
from .poisson import (ForestFASCycle, _down2_mean, _reducers, _up2_bilinear,
                      apply_block_precond_blocks, bicgstab,
                      block_precond_matrix, coarse_neumann_solve_dct,
                      dct_neumann_operators, mg_solve)
from .shapes_host import ShapeHostMixin, pull, pull_diag
from .sim import make_shapes
from .uniform import resolve_device

__all__ = ["AMRSim", "ObstacleForestFields", "multilevel_forest",
           "vortex_forest"]

_FREE_SLIP_TOKEN = "fs,fs,fs,fs"
_QUAD = ((0, 0), (1, 0), (0, 1), (1, 1))   # child (I, J) order


class ObstacleForestFields(NamedTuple):
    """Per-step obstacle state on the forest, in the SFC-ordered block
    layout (the reference's per-shape Obstacle blocks and global chi/tmp
    grids, main.cpp:3283-3342). Vector fields are component-first, as the
    penalization and collision operators index [0]/[1]."""

    chi: torch.Tensor      # [N, BS, BS] combined (max over shapes)
    sdf: torch.Tensor      # [N, BS, BS] combined signed distance
    chi_s: torch.Tensor    # [S, N, BS, BS]
    sdf_s: torch.Tensor    # [S, N, BS, BS]
    udef_s: torch.Tensor   # [S, 2, N, BS, BS] de-meaned deformation vel
    com: torch.Tensor      # [S, 2] chi-corrected centres of mass
    mass: torch.Tensor     # [S]
    inertia: torch.Tensor  # [S]


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


def _raster_neg(cfg) -> float:
    """The "far outside" SDF sentinel of the window raster: -extent, which
    fails the forces' surface-band gate own_sdf > -4h at every h."""
    return -float(cfg.extent)


def _window_sdf_udef(inp, bs: int, dtype):
    """One shape's SDF and deformation velocity over its window blocks
    ([P, BS, BS] and [2, P, BS, BS]) from the window-block origins and
    spacings in ``inp`` and the packed body-frame tables (``seg``,
    ``mid``; the CoM already subtracted on the host in f64)
    (PutFishOnBlocks, main.cpp:3774-3990)."""
    ar = torch.arange(bs, dtype=dtype, device=inp["wh"].device) + 0.5
    wh = inp["wh"][:, None, None]
    xw = inp["wx0"][:, None, None] + ar[None, None, :] * wh
    yw = inp["wy0"][:, None, None] + ar[None, :, None] * wh
    com = inp["com"]
    px = xw - com[0]
    py = yw - com[1]
    d = polygon_sdf_seg(px, py, inp["seg"])
    ud = midline_udef_packed(px, py, inp["mid"])
    return d, ud


# the float operands of one shape's window raster, in buffer order
_RASTER_KEYS = ("wx0", "wy0", "wh", "seg", "mid", "com")


class AMRSim(ShapeHostMixin):
    """Adaptive flow solver on the block forest, with or without immersed
    obstacles (the reference's only mode is with)."""

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
        if pois not in ("structured", "tables", "fft", "fas", "fas-f"):
            raise ValueError(f"CUP2D_POIS={pois!r}: expected "
                             "structured|tables|fft|fas|fas-f")
        twolevel = os.environ.get("CUP2D_TWOLEVEL")
        if twolevel not in (None, "additive", "mult", "mg2"):
            raise ValueError(f"CUP2D_TWOLEVEL={twolevel!r}: "
                             "expected additive|mult|mg2")
        # the forest's one CUP2D_PREC reading: bf16 storage of the FAS
        # cycle's window-image ladder legs only (cup2d_tpu/amr.py:224-252)
        prec = os.environ.get("CUP2D_PREC", "") or "f32"
        if prec not in ("f32", "bf16"):
            raise ValueError(f"CUP2D_PREC={prec!r}: expected f32|bf16")
        self._fas_leg_dtype = None
        if prec == "bf16":
            if pois not in ("fas", "fas-f"):
                raise ValueError(
                    "CUP2D_PREC=bf16 on the forest selects the bf16-leg FAS "
                    "tier and requires CUP2D_POIS=fas|fas-f (got "
                    f"CUP2D_POIS={pois!r}): the forest has no bf16 "
                    "advection tier, so the latch would otherwise relabel "
                    "an f32 run.")
            if cfg.dtype != "float32":
                raise ValueError(
                    f"CUP2D_PREC=bf16 needs f32 solver state (got "
                    f"{cfg.dtype}): the bf16 legs accumulate in f32; an "
                    "f64 outer loop would cast through f32 silently.")
            self._fas_leg_dtype = torch.bfloat16
        self._pois_mode = pois
        self._twolevel_form = twolevel
        self.device = resolve_device(device)
        if shapes is None:
            shapes = make_shapes(cfg)
        self.shapes = list(shapes)
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
        if self.shapes:
            self.forest.add_field("chi", 1)
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
        # raster window capacity per shape (blocks), grown in powers of two
        self._wcap = [16] * len(self.shapes)
        self.compute_forces_every = 1   # 0 disables the diagnostics pass
        self.force_log: Optional[object] = None  # file-like, CSV rows
        # host seconds of each phase of the last shaped step
        self.phase_seconds: dict = {}
        # cumulative regrid activity (the metrics stream reports deltas)
        self._n_refined = 0
        self._n_coarsened = 0
        # the shaped step's next dt (host float, from the previous step's
        # umax on the device) and its topology version
        self._next_dt = None
        self._next_dt_version = -1
        # end-state umax: a device scalar after an obstacle-free step, a
        # host float after a shaped one; survives regrids
        self._next_umax = None
        self._next_umax_version = -1
        # production two-level trigger: engaged when the last production
        # solve took > 15 iterations, kept until the next topology change
        self._last_iters = 0
        self._coarse_on = False
        self._force_exact = False
        # the lagged verdict (resilience.StepGuard, lag=True): the
        # obstacle-free step keeps dt and its diagnostics on the device
        # and leaves the clock to the guard; the shaped step ignores it
        self.async_diag = False

    @property
    def timers(self):
        return None

    @timers.setter
    def timers(self, value) -> None:
        if value is not None:
            raise NotImplementedError(
                "timers (profiling.PhaseTimers) are not ported yet "
                "(ROADMAP queue 1 item 9); read phase_seconds instead")

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
        if self.shapes:
            # chi tags (g = 4 scalar) and forces (g = 4 vector)
            raw["sca4t"] = build_tables(f, self._order, 4, True, 1,
                                        topo=topo)
            raw["vec4t"] = build_tables(f, self._order, 4, True, 2,
                                        topo=topo)
        fc = build_face_copy(f, self._order, n_pad, topo)
        self._tables = self._finalize_tables(raw, n_pad, fc)
        self._tables["pois"] = self._build_pois(topo, n_pad)
        self._corr = self._finalize_corr(topo, n_pad)
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
        self._h3 = self._tensor(hp.reshape(-1, 1, 1))
        self._hflat = self._tensor(hp)
        self._hsq_flat = self._tensor(hsqp.reshape(-1, 1, 1))
        self._maskv = self._tensor(self._mask.reshape(-1, 1, 1, 1))
        self._order_j = self._index(order_p)
        # cell centres per active block (f64 on the host, then the field
        # dtype), for the obstacle operators
        bs = f.bs
        ar = np.arange(bs) + 0.5
        x0 = f.bi[self._order].astype(np.float64) * bs * h
        y0 = f.bj[self._order].astype(np.float64) * bs * h
        xc = np.zeros((n_pad, bs, bs))
        yc = np.zeros((n_pad, bs, bs))
        xc[:n_real] = x0[:, None, None] + ar[None, None, :] * h[:, None, None]
        yc[:n_real] = y0[:, None, None] + ar[None, :, None] * h[:, None, None]
        self._xc = self._tensor(xc)
        self._yc = self._tensor(yc)
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

    # the hot-loop table sets that take the same-level face-copy path
    # (the g = 4 tensorial sets of the chi tags and the force pass too);
    # vec1t/sca1t are regrid-only and stay plain. Non-tensorial g=1 sets
    # never fill lab corners, so their paint is face-only.
    _FAST_SETS = {"vec3": True, "vec1": False, "sca1": False,
                  "sca4t": True, "vec4t": True}

    # table placement hooks (parallel.forest_mesh.ShardedAMRSim splits the
    # hot-loop sets into per-device rows behind a surface exchange plan)
    def _finalize_tables(self, raw: dict, n_pad: int, fc) -> dict:
        out = {}
        for k, t in raw.items():
            if fc is not None and k in self._FAST_SETS:
                host = make_fast_tables(t, fc[0], fc[1], n_pad,
                                        corners=self._FAST_SETS[k])
            else:
                host = pad_tables(t, n_pad)
            out[k] = lab_tables(host, self.device, self.dtype)
        return out

    def _build_pois(self, topo, n_pad: int):
        """The Poisson operator (``cup2d_tpu/amr.py:671-683``): the
        structured per-face form, or under ``CUP2D_POIS=tables`` the
        lab-table form (padded plain tables, no face-copy path)."""
        if self._pois_mode == "tables":
            t = build_poisson_tables(self.forest, self._order, topo=topo)
            return lab_tables(pad_tables(t, n_pad), self.device, self.dtype)
        return poisson_op(
            build_poisson_structured(self.forest, self._order, n_pad,
                                     topo=topo), self.device, self.dtype)

    def _finalize_corr(self, topo, n_pad: int):
        """The flux-correction rows (``cup2d_tpu/amr.py:685-687``)."""
        return flux_corr(
            build_flux_corr(self.forest, self._order, n_pad=n_pad,
                            topo=topo), self.device, self.dtype)

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
            # end-state umax and next dt describe the overwritten field
            self._next_dt = None
            self._next_umax = None
        self._ord = {name: self._put_ordered(fld[self._order_j])
                     for name, fld in f.fields.items()}
        self._ord_key = key
        return self._ord

    def _put_ordered(self, x):
        """Placement hook of an ordered [n_pad, ...] tensor
        (``parallel.forest_mesh.ShardedAMRSim`` splits it over its
        mesh)."""
        return x

    @staticmethod
    def _gather(x):
        """The whole ordered tensor of a placed one (identity here)."""
        return x

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
            fld[order] = self._gather(x)[:self._n_real]
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
        self._next_dt = None
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
            rhs = per_shard(fused_lab_rhs, lab, h, nu, dt)
            rhs = apply_flux_corr(
                rhs, diffusive_deposits(lab, 3, nu * dt), corr)
            v = heun_substage(vold, c, rhs, ih2) * maskv
        return v

    def _pressure_project(self, v, pres, dt, h, hsq, t1v, t1s, tpois,
                          corr, tcoarse, exact_poisson, maskv,
                          chi=None, udef_b=None):
        """deltap Poisson solve and projection (main.cpp:7007-7187) with
        the flux-corrected divergence RHS and the makeFlux operator;
        ``chi``/``udef_b`` ([N, BS, BS], [N, 2, BS, BS]) add the
        -chi div(u_def) obstacle term and its flux deposits.
        Returns (v_new, p_new, res, div_linf)."""
        cfg = self.cfg
        ih2 = 1.0 / (h * h)
        pord = pres[:, 0] * maskv[:, 0]          # [N,BS,BS]
        vlab = assemble_labs_ordered(v, t1v)
        fac = 0.5 * h[:, 0] / dt
        b = fac * divergence(vlab, 1)
        ulab = None
        if udef_b is not None:
            ulab = assemble_labs_ordered(udef_b, t1v)
            b = b - fac * chi * divergence(ulab, 1)
        b = apply_flux_corr(
            b, per_shard(divergence_deposits, vlab, ulab, chi,
                         fac[:, 0, 0]), corr)
        # max |div u| of the pre-projection velocity, from the RHS
        div_linf = torch.amax(
            torch.abs(b) * maskv[:, 0] * (dt / (h[:, 0] * h[:, 0])))

        if hasattr(tpois, "nba"):
            # the structured per-face operator (one device or per device)
            def A(x):
                return poisson_apply_structured(x, tpois)
        else:
            # CUP2D_POIS=tables: laplacian5 of the makeFlux-ghost lab
            def A(x):
                return laplacian5(assemble_labs_ordered(x[:, None], tpois),
                                  1)[:, 0]

        # initial-guess subtraction through A itself
        b = b - A(pord)
        reducers = self._reducers()
        M = self._precond

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
                    return _interp(ec, r) + self._precond(r)
            elif form == "mg2":
                def M(r):
                    e = self._precond(r)
                    r1 = r - A(e)
                    rc = _deposit(r1 * cih2)
                    ec = coarse_neumann_solve_dct(
                        rc, dctops, self._coarse_h2)
                    e = e + _interp(ec, r)
                    return e + self._precond(r - A(e))
            else:
                def M(r):
                    rc = _deposit(r * cih2)
                    ec = coarse_neumann_solve_dct(
                        rc, dctops, self._coarse_h2)
                    e = _interp(ec, r)
                    return e + self._precond(r - A(e))

        if self._pois_mode in ("fas", "fas-f") and not exact_poisson:
            # the forest FAS hierarchy as the production solver;
            # exact solves keep Krylov as the backstop
            paint_fine, base_solve, extract_all = \
                self._fas_transfers(tcoarse)
            mgc = ForestFASCycle(
                A, self._fas_block_smoother(A, tpois), paint_fine,
                base_solve, extract_all, cih2,
                leg_dtype=self._fas_leg_dtype)
            res = mg_solve(
                A, b, mgc,
                tol=cfg.poisson_tol, tol_rel=cfg.poisson_tol_rel,
                max_cycles=cfg.max_poisson_iterations,
                fmg=self._pois_mode == "fas-f", reducers=reducers)
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
                reducers=reducers,
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
        dv = apply_flux_corr(
            dv, per_shard(gradient_deposits, plab[:, 0], pfac), corr)
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

    @staticmethod
    def _reducers():
        """The solves' (dot, linf, zeros_like) factory
        (``poisson._reducers``)."""
        return _reducers

    def _precond(self, r):
        """z = P_inv r per block: the block-Jacobi preconditioner's GEMM
        (``poisson.apply_block_precond_blocks``)."""
        return apply_block_precond_blocks(r, self.p_inv)

    def _fas_block_smoother(self, A, tpois=None):
        """Composite-level smoother of the forest FAS cycle: damped
        block-Jacobi sweeps e += P_inv (r - A e). Each sweep's update is
        ``fused_block_jacobi_update`` (the kernel on the card); the
        from-zero head is a bare ``apply_block_precond_blocks``."""
        p_inv = self.p_inv

        def smooth(e, r, n, from_zero=False):
            if from_zero and n > 0:
                e = self._precond(r)
                n -= 1
            for _ in range(n):
                e = per_shard(fused_block_jacobi_update, e, r, A(e), p_inv)
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
        composition, as in the reference's XLA tier); a "+bf16" suffix
        when the window-image ladder legs store bf16
        (``cup2d_tpu/amr.py:1265-1277``)."""
        base = "xla"
        if self._pois_mode in ("fas", "fas-f") \
                and self.device.type == "cuda":
            base = "strip"
        if self._fas_leg_dtype is not None:
            return base + "+bf16"
        return base

    @property
    def kernel_tier(self) -> str:
        """What runs the lab RHS: ``hopper`` (the CUDA kernel, on the
        card) or ``plain`` (its twin, on the CPU)."""
        return "hopper" if self.device.type == "cuda" else "plain"

    @property
    def prec_mode(self) -> str:
        """The field dtype (the forest has no bf16 storage tier)."""
        return {torch.float32: "f32", torch.float64: "f64"}[self.dtype]

    @property
    def bc_table(self) -> str:
        """The free-slip token: the forest takes no other table."""
        return _FREE_SLIP_TOKEN

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

    # ------------------------------------------------------------------
    # device step with obstacles (the reference hot loop 6607-7187)
    # ------------------------------------------------------------------
    def _flow_impl(self, vel, pres, obs, prescribed, dt, h, hsq, maskv,
                   xc, yc, t3, t1v, t1s, tpois, corr, tcoarse,
                   exact_poisson=False):
        """Advection, the rigid momentum solve per free shape, the
        collision impulses, the implicit penalization and the projection
        with the obstacle term. Returns (v, p_new, uvw [S, 3], diag); the
        diagnostics stay on the device."""
        cfg = self.cfg
        S = len(self.shapes)
        v = self._advect_rk2(vel, h, dt, t3, corr, maskv)
        v_cf = v.transpose(0, 1)   # component-first [2, N, BS, BS]

        # rigid momentum solve per shape (main.cpp:6643-6704)
        uvw = []
        for k in range(S):
            if self.shapes[k].free:
                xr = xc - obs.com[k, 0]
                yr = yc - obs.com[k, 1]
                sums = penalization_integrals(
                    v_cf, obs.chi_s[k], obs.udef_s[k], xr, yr,
                    cfg.lam * dt, hsq)
                uvw.append(solve_rigid_momentum(*sums))
            else:
                uvw.append(prescribed[k])
        uvw = torch.stack(uvw)

        # shape-shape collisions (main.cpp:6705-6943): opponent-merged
        # overlap integrals, then the pairwise impulses on the device
        if S > 1:
            colls = merged_overlap_integrals(
                obs.chi_s, obs.sdf_s, obs.udef_s, uvw, obs.com, xc, yc)
            lengths = self._tensor([s.length for s in self.shapes])
            uvw = pairwise_collision_update(
                colls, uvw, obs.mass, obs.inertia, obs.com, lengths)
            # prescribed-motion shapes are immovable: restore them
            for k in range(S):
                if not self.shapes[k].free:
                    uvw[k] = prescribed[k]

        # implicit penalization update, the winner shape per cell (the
        # first on a tie) (main.cpp:6944-6979)
        win = torch.argmax(obs.chi_s, dim=0)
        us = torch.zeros_like(v_cf)
        for k in range(S):
            xr = xc - obs.com[k, 0]
            yr = yc - obs.com[k, 1]
            usk = torch.stack([
                uvw[k, 0] - uvw[k, 2] * yr + obs.udef_s[k, 0],
                uvw[k, 1] + uvw[k, 2] * xr + obs.udef_s[k, 1],
            ])
            us = torch.where(win == k, usk, us)
        alpha = torch.where(obs.chi > 0.5, 1.0 / (1.0 + cfg.lam * dt), 1.0)
        v_cf = alpha * v_cf + (1.0 - alpha) * us
        v = v_cf.transpose(0, 1)

        udef = self._combined_udef(obs)  # [2, N, BS, BS]
        v, p_new, res, div_linf = self._pressure_project(
            v, pres, dt, h, hsq, t1v, t1s, tpois, corr, tcoarse,
            exact_poisson, maskv, chi=obs.chi, udef_b=udef.transpose(0, 1))
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
        return v, p_new, uvw, diag

    def _megastep_impl(self, vel, pres, inputs, prescribed, dt, hmin, h,
                       hsq, maskv, xc, yc, t3, t1v, t1s, tpois, t4v, t4s,
                       corr, tcoarse, exact_poisson=False,
                       with_forces=False):
        """Rasterize, flow, the next dt from this step's end-state umax
        (the arithmetic of ``compute_dt``) and, with ``with_forces``, the
        force pass. Returns (vel, pres, chi [N, 1, BS, BS], scalars,
        forces); scalars = (uvw, com, mass, inertia, dt_next, diag)."""
        obs = self._rasterize_impl(inputs, xc, yc, h[:, 0], hsq, t1s)
        vel, pres, uvw, diag = self._flow_impl(
            vel, pres, obs, prescribed, dt, h, hsq, maskv, xc, yc, t3,
            t1v, t1s, tpois, corr, tcoarse, exact_poisson=exact_poisson)
        dt_next = self._dt_from_umax(diag["umax"], hmin)
        forces = None
        self._t_forces = time.perf_counter()   # phase_seconds' boundary
        if with_forces:
            forces = self._forces_impl(vel, pres, obs, uvw, t4v, t4s,
                                       h[:, 0, 0, 0], xc, yc)
        scalars = (uvw, obs.com, obs.mass, obs.inertia, dt_next, diag)
        return vel, pres, obs.chi[:, None], scalars, forces

    @staticmethod
    def _combined_udef(obs: ObstacleForestFields) -> torch.Tensor:
        """The deformation velocity of the pressure RHS and the initial
        blend: the sum over shapes at cells where that shape's chi ties or
        wins the combined chi (main.cpp:6980-7006; ties sum)."""
        return torch.sum(
            torch.where((obs.chi_s >= obs.chi)[:, None], obs.udef_s, 0.0),
            dim=0)

    # ------------------------------------------------------------------
    # device: rasterization, chi, integrals (ongrid, main.cpp:4208-4630)
    # ------------------------------------------------------------------
    def _rasterize_impl(self, inputs, xc, yc, h3, hsq, t1s):
        N = xc.shape[0]
        S = len(self.shapes)

        # per-shape window rasterization, scattered into block layout
        sdf = torch.full_like(xc, _raster_neg(self.cfg))
        per = []
        for k in range(S):
            inp = inputs[k]
            sdf_k, udef_k, wm_k = self._window_raster(inp, N)
            sdf = torch.maximum(sdf, sdf_k)
            per.append((sdf_k, udef_k, wm_k, inp["com"]))

        # chi from the COMBINED sdf lab at each block's own h
        # (PutChiOnGrid, main.cpp:3911-3969)
        slab = assemble_labs_ordered(sdf[:, None], t1s)[:, 0]
        chi = torch.zeros_like(xc)
        chi_s, sdf_s, udef_s = [], [], []
        coms, masses, inertias = [], [], []
        for k in range(S):
            sdf_k, udef_k, wm_k, com = per[k]
            chi_k = chi_from_sdf(slab, sdf_k, h3)

            # CoM correction (main.cpp:4468-4487); zero-mass guard
            m0 = torch.sum(chi_k * hsq)
            dcx = torch.sum(chi_k * hsq * (xc - com[0]))
            dcy = torch.sum(chi_k * hsq * (yc - com[1]))
            safe = torch.where(m0 > 0, m0, 1.0)
            com_n = com + torch.where(
                m0 > 0, torch.stack([dcx, dcy]) / safe, 0.0)

            # integrals and udef de-meaning (main.cpp:4488-4560), masked
            # to the window blocks
            xr = xc - com_n[0]
            yr = yc - com_n[1]
            _, _, m, j, iu, iv, ia = shape_integrals(
                chi_k, udef_k, xr, yr, hsq)
            corr = torch.stack([iu - ia * yr, iv + ia * xr])
            ud = wm_k[None, :, None, None] * (udef_k - corr)

            chi = torch.maximum(chi, chi_k)
            chi_s.append(chi_k)
            sdf_s.append(sdf_k)
            udef_s.append(ud)
            coms.append(com_n)
            masses.append(m)
            inertias.append(j)

        return ObstacleForestFields(
            chi=chi, sdf=sdf,
            chi_s=torch.stack(chi_s), sdf_s=torch.stack(sdf_s),
            udef_s=torch.stack(udef_s),
            com=torch.stack(coms), mass=torch.stack(masses),
            inertia=torch.stack(inertias))

    def _window_raster(self, inp, N: int):
        """SDF and deformation velocity of one shape over its window
        blocks, written into the ordered block layout (the PutFishOnBlocks
        gather form, main.cpp:3774-3990). Padding windows (pos = -1) all
        go to row N of an [N + 1, ...] buffer, which is then dropped: row
        N is written once per padding window, every time with the same
        value (the sentinel, or 0), so the repeated destination is
        deterministic on the card too; real windows are distinct blocks.
        Returns (sdf [N, BS, BS], udef [2, N, BS, BS], window mask [N])."""
        bs = self.cfg.bs
        dtype = self.dtype
        dev = inp["pos"].device
        neg = _raster_neg(self.cfg)
        pos = inp["pos"]                 # [P], -1 = padding
        wmask = pos >= 0
        d, ud = _window_sdf_udef(inp, bs, dtype)
        spos = torch.where(wmask, pos, N)
        wm3 = wmask[:, None, None]
        sdf_k = torch.full((N + 1, bs, bs), neg, dtype=dtype, device=dev)
        sdf_k.index_copy_(0, spos, torch.where(wm3, d, neg))
        udef_k = torch.zeros((2, N + 1, bs, bs), dtype=dtype, device=dev)
        udef_k.index_copy_(1, spos, torch.where(wm3[None], ud, 0.0))
        wm_k = torch.zeros((N + 1,), dtype=dtype, device=dev)
        wm_k.index_copy_(0, spos, wmask.to(dtype))
        return sdf_k[:N], udef_k[:, :N], wm_k[:N]

    # ------------------------------------------------------------------
    # device: tags
    # ------------------------------------------------------------------
    def _chi_tag_impl(self, chi_o, t4s, finest):
        """GradChiOnTmp (main.cpp:4631-4656): any positive chi in the
        block's padded window forces refinement (offset 4 at the finest
        level, where it only blocks compression, else 2). chi_o
        [N, 1, BS, BS] ordered; finest [N] bool; returns [N] bool."""
        lab = assemble_labs_ordered(chi_o, t4s)[:, 0]      # [N, L, L]
        c = torch.clamp(lab, 0.0, 1.0)
        has4 = torch.amax(c, dim=(-1, -2)) > 0.0
        has2 = torch.amax(c[:, 2:-2, 2:-2], dim=(-1, -2)) > 0.0
        return torch.where(finest, has4, has2)

    def _tags_impl(self, vel, chi_o, h, t1v, t4s, finest):
        """The refinement tags: the max of the vorticity Linf and the
        GradChiOnTmp marker (2 Rtol where chi is present), the two
        computeA passes of adapt() (main.cpp:4659-4661) in one."""
        w = self._vorticity_impl(vel, h, t1v)
        has = self._chi_tag_impl(chi_o, t4s, finest)
        return torch.maximum(w, torch.where(has, 2.0 * self.cfg.rtol, 0.0))

    # ------------------------------------------------------------------
    # device: surface force diagnostics (main.cpp:7188-7284)
    # ------------------------------------------------------------------
    def _forces_impl(self, vel, pres, obs, uvw, t4v, t4s, hflat, xc, yc):
        """The 19 force diagnostics per shape, each a batched pass over
        every block's G = 4 labs (``surface_forces_blocks``)."""
        velp = assemble_labs_ordered(vel, t4v)                 # [N,2,L,L]
        chip = assemble_labs_ordered(obs.chi[:, None], t4s)[:, 0]
        sdfp = assemble_labs_ordered(obs.sdf[:, None], t4s)[:, 0]
        pord = pres[:, 0]
        return [surface_forces_blocks(
            velp, pord, chip, sdfp, obs.udef_s[k].transpose(0, 1),
            obs.sdf_s[k], xc, yc, obs.com[k], uvw[k], self.cfg.nu, hflat,
            G=4, apply=per_shard) for k in range(len(self.shapes))]

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
    # host: obstacle bookkeeping
    # ------------------------------------------------------------------
    def _shape_inputs(self) -> list:
        """Per shape, the blocks intersecting its padded bounding box (the
        reference's AreaSegment-AABB block intersection,
        main.cpp:4208-4269) as window positions ``pos`` padded with -1 to
        the shape's capacity, the window blocks' origins and spacings,
        the packed body-frame segment and midline tables and the CoM. The
        capacity grows in powers of two; every shape's float operands go
        to the device in one copy, and the positions in another."""
        cfg = self.cfg
        f = self.forest
        order = self._order
        bs = cfg.bs
        h = cfg.h0 / (1 << f.level[order]).astype(np.float64)
        x0 = f.bi[order] * bs * h
        y0 = f.bj[order] * bs * h
        x1 = x0 + bs * h
        y1 = y0 + bs * h
        host, poss = [], []
        for k, s in enumerate(self.shapes):
            r = self._raster_radius(s)
            cx, cy = s.com
            hit = (x1 > cx - r) & (x0 < cx + r) \
                & (y1 > cy - r) & (y0 < cy + r)
            idx = np.nonzero(hit)[0]
            if len(idx) > self._wcap[k]:
                self._wcap[k] = max(
                    16, 1 << int(np.ceil(np.log2(len(idx) * 1.3))))
            pos = np.full(self._wcap[k], -1, np.int64)
            pos[:len(idx)] = idx
            wx0 = np.zeros(self._wcap[k])
            wy0 = np.zeros(self._wcap[k])
            wh = np.ones(self._wcap[k])
            wx0[:len(idx)] = x0[idx]
            wy0[:len(idx)] = y0[idx]
            wh[:len(idx)] = h[idx]
            mid_r, mid_v, mid_nor, mid_vnor = s.midline_comp_frame()
            com = np.asarray(s.com, np.float64)
            # the body-frame tables: the CoM subtracted here, in f64
            seg = pack_polygon_segments(s.surface_polygon() - com)
            mid = pack_midline(mid_r - com, mid_v, mid_nor, mid_vnor,
                               s.width)
            host.append(dict(zip(_RASTER_KEYS, (wx0, wy0, wh, seg, mid,
                                                com))))
            poss.append(pos)
        if not host:
            return []
        buf = self._tensor(np.concatenate(
            [np.asarray(a, np.float64).ravel() for arrays in host
             for a in arrays.values()]))
        pbuf = self._index(np.concatenate(poss))
        out, at, pat = [], 0, 0
        for arrays, pos in zip(host, poss):
            inp = {}
            for key, a in arrays.items():
                a = np.asarray(a)
                inp[key] = buf[at:at + a.size].view(a.shape)
                at += a.size
            inp["pos"] = pbuf[pat:pat + len(pos)]
            pat += len(pos)
            out.append(inp)
        return out

    def _rasterize(self) -> ObstacleForestFields:
        self._refresh()
        return self._rasterize_impl(
            self._shape_inputs(), self._xc, self._yc, self._h3,
            self._hsq_flat, self._tables["sca1"])

    def _write_chi(self, obs: ObstacleForestFields):
        """The real blocks' chi into the slot-layout field."""
        f = self.forest
        fld = f.fields["chi"].clone()
        fld[self._index(self._order)] = \
            self._gather(obs.chi)[:self._n_real, None]
        f.fields["chi"] = fld

    def _raster_radius(self, s) -> float:
        """Half-extent of a shape's raster window (the AreaSegment AABB
        padding, main.cpp:4237), for window selection and capacity."""
        return 0.625 * s.length + 12.0 * self.cfg.min_h

    @staticmethod
    def _shape_bbox(s):
        """Axis-aligned bbox of the shape's surface polygon (valid after
        advect/midline)."""
        poly = s.surface_polygon()
        return poly.min(axis=0), poly.max(axis=0)

    def _window_blocks_estimate(self, s) -> int:
        """Finest-level blocks covering shape ``s``'s raster window."""
        cfg = self.cfg
        h_fin = cfg.h_at(cfg.level_max - 1)
        r = self._raster_radius(s)
        return int(np.ceil(2.0 * r / (cfg.bs * h_fin))) ** 2

    def _body_blocks_estimate(self, s) -> int:
        """Finest-level blocks of the chi-tag region around shape ``s``:
        the bbox of its surface polygon padded by the tag's 4-cell ghost
        window."""
        cfg = self.cfg
        bh = cfg.bs * cfg.h_at(cfg.level_max - 1)
        pad = 8.0 * cfg.min_h
        lo, hi = self._shape_bbox(s)
        lb = int(np.ceil((float(hi[0] - lo[0]) + pad) / bh)) + 1
        wb = int(np.ceil((float(hi[1] - lo[1]) + pad) / bh)) + 1
        return lb * wb

    def _estimate_blocks(self, coarse_start: bool) -> int:
        """Estimate of the init climb's peak block count: from the
        coarsest grid, background plus 2.5x each shape's body blocks;
        from levelStart, the uniform levelStart grid on top."""
        cfg = self.cfg
        est = cfg.bpdx * cfg.bpdy
        if not coarse_start:
            est += cfg.bpdx * cfg.bpdy << (2 * cfg.level_start)
        for s in self.shapes:
            est += int(2.5 * self._body_blocks_estimate(s))
        return est

    def _refine_toward_shapes(self) -> bool:
        """The init climb's bootstrap: refine every block below
        level_max - 1 whose footprint, padded by the chi tag's 4-cell
        window, meets a shape's bounding box (host geometry; works where
        the body is thinner than a cell and chi is empty)."""
        f = self.forest
        cfg = self.cfg
        self._refresh()
        order = self._order
        lv = f.level[order].astype(np.int64)
        biv = f.bi[order].astype(np.int64)
        bjv = f.bj[order].astype(np.int64)
        h = cfg.h0 / (1 << lv).astype(np.float64)
        bs = cfg.bs
        pad = 8.0 * h   # 4 ghost cells x one-level-finer margin
        x0 = biv * bs * h - pad
        x1 = (biv + 1) * bs * h + pad
        y0 = bjv * bs * h - pad
        y1 = (bjv + 1) * bs * h + pad
        hit = np.zeros(len(order), bool)
        for s in self.shapes:
            (bx0, by0), (bx1, by1) = self._shape_bbox(s)
            hit |= (x1 > bx0) & (x0 < bx1) & (y1 > by0) & (y0 < by1)
        st = np.where(hit & (lv < cfg.level_max - 1), 1, 0).astype(np.int8)
        return self._commit_states(lv, biv, bjv, st)

    def initialize(self):
        """The reference's startup (main.cpp:6542-6575): when the fields
        are all zero, climb from the coarsest grid toward the bodies;
        then up to levelMax rounds of {rasterize; adapt}; then the
        initial velocity u (1 - chi) + udef chi. The window capacities
        and the padded block axis are sized from block estimates
        first."""
        if not self.shapes:
            self._initialized = True
            return
        cfg = self.cfg
        f = self.forest
        for s in self.shapes:
            s.advect(0.0, cfg.extents)
            s.midline(0.0)
        # one stacked read for every field
        (nonzero,) = pull(torch.stack([torch.any(v != 0)
                                       for v in f.fields.values()]))
        allzero = not nonzero.any()
        # ctol <= 0 disables compression: a climb from above would keep
        # the levelStart background, so only then is the grid different
        coarse = allzero and cfg.level_start > 0 and cfg.ctol > 0
        self.reserve_blocks(self._estimate_blocks(coarse))
        for k, s in enumerate(self.shapes):
            want = int(2.6 * self._window_blocks_estimate(s)) + 16
            self._wcap[k] = max(self._wcap[k], _bucket(want, lo=16))
        if coarse:
            for key in list(f.blocks):
                f.release(*key)
            for j in range(cfg.bpdy):
                for i in range(cfg.bpdx):
                    f.allocate(0, i, j)
            for _ in range(cfg.level_max + 2):
                if not self._refine_toward_shapes():
                    break
        for _ in range(cfg.level_max):
            obs = self._rasterize()
            self._write_chi(obs)
            if not self.adapt():
                break
        obs = self._rasterize()
        self._write_chi(obs)
        self._sync_shape_scalars(obs)
        vel = f.fields["vel"][self._order_j]
        udef = self._gather(self._combined_udef(obs).transpose(0, 1))
        chi_b = self._gather(obs.chi[:, None])
        fld = f.fields["vel"].clone()
        fld[self._index(self._order)] = \
            (vel * (1.0 - chi_b) + udef * chi_b)[:self._n_real]
        f.fields["vel"] = fld
        self._initialized = True

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
        return float(pull(self._dt_from_umax(umax, self._hmin()))[0])

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
        steps. Returns the step diagnostics as host values, read in one
        copy; without shapes under ``async_diag``, unread (dt stays the
        device scalar it was computed as) and the clock left alone."""
        self._refresh()
        if self.shapes:
            return self._step_shaped(dt)
        f = self.forest
        ordf = self._ordered_state()
        if dt is None:
            if self._next_umax is not None:
                fac = (1.0 if self._next_umax_version == f.version
                       else 1.05)
                dt = self._dt_from_umax(fac * self._next_umax,
                                        self._hmin())
                if not self.async_diag:
                    dt = float(pull(dt)[0])
            else:
                dt = self.compute_dt()
        exact = self.step_count < 10 or self._force_exact
        dt_dev = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        vel, pres, diag = self._step_impl(
            ordf["vel"], ordf["pres"], dt_dev, self._h, self._hsq_flat,
            self._maskv, self._tables["vec3"], self._tables["vec1"],
            self._tables["sca1"], self._tables["pois"], self._corr,
            self._use_coarse(exact), exact_poisson=exact)
        self._set_ordered(vel=vel, pres=pres)
        self._next_umax = diag["umax"]
        self._next_umax_version = f.version
        if not exact:
            # the production two-level trigger, from the solver's count (a
            # host int: the solvers read their flags on the host).
            # Exact-startup counts converge deeper with another M and must
            # not trip it.
            self._last_iters = int(diag["poisson_iters"])
        if self.async_diag:
            # no read: the guard's lagged verdict pulls the diagnostics
            # and settles the clock from the dt used
            diag["dt"] = dt_dev
            self.step_count += 1
            return diag
        diag, _ = pull_diag(diag)
        diag["dt"] = float(dt)
        self.time += dt
        self.step_count += 1
        return diag

    def _step_shaped(self, dt: Optional[float]) -> dict:
        """The shaped step (main.cpp:6576-7290): dt from the previous
        step's device dt (capped by the gait), host kinematics, then the
        megastep and the step's one read of the device. phase_seconds
        holds its host seconds: "kinematics"; "megastep" (rasterize and
        flow, ending at the solver's last flag read); "forces" (the force
        pass, the step's one read, which waits for it, and the log)."""
        f = self.forest
        cfg = self.cfg
        if not getattr(self, "_initialized", False):
            self.initialize()
            self._refresh()
        # an external slot write drops the cached dt before it is used
        self._ordered_state()
        if dt is None:
            if self._next_dt is not None \
                    and self._next_dt_version == f.version:
                dt = min(self._next_dt, self._kinematic_dt_cap())
            elif self._next_umax is not None:
                # after a regrid: the same water on a new grid; the 1.05
                # factor bounds the prolongation's overshoot of umax
                dt = min(float(pull(self._dt_from_umax(
                    torch.tensor(1.05 * float(self._next_umax),
                                 dtype=self.dtype, device=self.device),
                    self._hmin()))[0]), self._kinematic_dt_cap())
            else:
                dt = min(self.compute_dt(), self._kinematic_dt_cap())
        t0 = time.perf_counter()

        # ongrid host part (main.cpp:3992-4207)
        for s in self.shapes:
            s.advect(dt, cfg.extents)
            s.midline(self.time)
        t1 = time.perf_counter()
        inputs = self._shape_inputs()
        prescribed = self._tensor([[s.u, s.v, s.omega]
                                   for s in self.shapes])
        exact = self.step_count < 10 or self._force_exact
        with_forces = bool(self.compute_forces_every
                           and self.step_count % self.compute_forces_every
                           == 0)
        hmin = self._hmin()
        ordf = self._ordered_state()
        dt_dev = torch.tensor(dt, dtype=self.dtype, device=self.device)
        tb = self._tables
        vel, pres, chi_new, scalars, forces = self._megastep_impl(
            ordf["vel"], ordf["pres"], inputs, prescribed, dt_dev, hmin,
            self._h, self._hsq_flat, self._maskv, self._xc, self._yc,
            tb["vec3"], tb["vec1"], tb["sca1"], tb["pois"], tb["vec4t"],
            tb["sca4t"], self._corr, self._use_coarse(exact),
            exact_poisson=exact, with_forces=with_forces)
        t2 = self._t_forces
        self._set_ordered(vel=vel, pres=pres, chi=chi_new)
        uvw, com, mass, inertia, dt_next, diag = scalars
        extra = [uvw, com, mass, inertia, dt_next]
        if with_forces:
            extra.append(self.stack_forces(forces))
        # the one read of the step
        diag, vals = pull_diag(diag, *extra)
        diag["dt"] = float(dt)
        uvw_np, com_np, mass_np, inertia_np, dt_next_np = vals[:5]
        self._sync_shape_scalars_np(com_np, mass_np, inertia_np)
        for k, s in enumerate(self.shapes):
            if s.free:
                s.u, s.v, s.omega = (float(c) for c in uvw_np[k])
        self._next_dt = float(dt_next_np)
        self._next_dt_version = f.version
        self._next_umax = float(diag["umax"])
        self._next_umax_version = f.version
        if not exact:
            # the production two-level trigger, fed from this read
            self._last_iters = int(diag["poisson_iters"])
        if with_forces:
            self._record_forces_np(vals[5])
        t3 = time.perf_counter()
        self.phase_seconds = {"kinematics": t1 - t0, "megastep": t2 - t1,
                              "forces": t3 - t2}
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
        if self.shapes and "chi" in f.fields:
            # the fused vorticity and chi tags, one read
            finest = np.zeros(len(self._mask), bool)
            finest[:self._n_real] = \
                f.level[self._order] == cfg.level_max - 1
            tags = self._tags_impl(
                ordf["vel"], ordf["chi"], self._h, self._tables["vec1"],
                self._tables["sca4t"],
                self._put_ordered(torch.as_tensor(finest,
                                                  device=self.device)))
        else:
            tags = self._vorticity_impl(
                ordf["vel"], self._h, self._tables["vec1"])
        # back in the field dtype: the thresholds compare as before
        (tags_np,) = pull(self._gather(tags))
        tags = tags_np.astype(self.forest.np_dtype)[:self._n_real]
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
        """2:1 balance sweeps on ``st`` (int8) in place: the native C
        helper (``native.fix_states``, the JAX package's
        ``cup2d_tpu/native/amr_host.c``)."""
        cfg = self.cfg
        native.fix_states(lv, biv, bjv, st, cfg.level_max, cfg.bpdx,
                          cfg.bpdy)

    def _fix_states_py(self, state):
        """The native helper's Python twin, on a {(l, i, j): state} dict
        (the tests hold the helper to it). Finest level first
        (main.cpp:4734-4861): a block with a refining finer neighbour must
        refine; compressing next to a finer or refining neighbour must
        stay."""
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
        self._n_refined += len(refine_keys)
        self._n_coarsened += len(groups)

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
