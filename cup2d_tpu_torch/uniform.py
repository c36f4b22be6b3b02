"""Uniform-grid execution path on dense tensors: the counterpart of
``cup2d_tpu.uniform`` for the obstacle-free box, free-slip or under any
boundary table (``bc.py``: no-slip walls with a moving lid, Dirichlet
inflow, convective outflow, periodic axes).

One step (main.cpp:6576-7290): CFL dt control, two-stage Heun
advection-diffusion (WENO5 + central diffusion, ``fused_advect_heun``),
the deltap pressure projection (divergence RHS minus lap(pold), the
Poisson solve, ``project_correct``) and the step diagnostics.

Device policy: ``UniformGrid`` and ``UniformSim`` run on ``cuda`` unless
the caller passes ``device="cpu"``; with no device given and no card they
raise. Both devices run f32 or f64 state: the kernels of the one-card step
(2, 5, 6) have f64 forms. On the card the split step and ``CUP2D_POIS=
fftd`` take f32 state only (kernels 3, 7 and ``tridiag.cu`` have no f64
form yet: ``check_card_f64``). On the card the Hopper kernels always run
(there is no kernel-tier switch), on the CPU their plain twins.

Boundary tables (``bc=``, a ``bc.BCTable``): the free-slip table runs the
free-slip code unchanged. Any other validated table paints its ghosts in
the substage kernel, carries its per-face pressure signs through the
Poisson operator, the multigrid hierarchy and the correction kernel, and
its divergence coefficients (plus the constant of prescribed wall-normal
velocities) through the Poisson RHS; a table with an outflow face keeps
the pressure mean. A periodic axis (the doubly-periodic box, the periodic
channel) wraps every shift of those operators, and the three kernels run
their wrap forms (the JAX package runs such tables on its XLA chains
only); a periodic table takes no bf16 tier.

``UniformGrid.attach_mesh`` splits the step along x over a slab mesh
(``parallel.mesh.ShardedUniformSim`` drives it), free-slip or under any
table: the advection runs the halo-mode substage per shard (its
boundary-table form under a table, its wrap form under a periodic one),
the multigrid cycles run on split fields (the signed halo sweep under a
table, its y-wrap form where y is periodic), a periodic x exchanges on a
ring of slabs, the epilogue is plain per-slab code and the reductions
combine per-shard partials (``parallel.shard_halo``). The obstacle terms
of ``step`` (a shaped fleet's frozen solids) split too: the penalization
runs slab by slab and the chi-weighted RHS term exchanges one edge column
of u_def.

Environment, read once per ``UniformGrid``: ``CUP2D_POIS`` selects the
solver (""/structured/tables/fft: bicgstab + MG, fas: MG cycles, fas-f:
the same opened by an F-cycle, fftd: the FFT-diagonalized direct solve of
a table with a periodic axis, ``poisson.fft_diag_solve``);
``CUP2D_PREC`` selects the storage of the kernels' operands: f32 (the
default) or bf16, the JAX package's bf16 tier (there it also needs
``CUP2D_PALLAS=1``; the port has no kernel-tier switch, so the latch alone
selects it). Under bf16 both Heun substages run their bf16 kernel forms
(solo, with any non-periodic table, or per slab on a mesh) and the FAS
solver's cycle runs bf16 legs through the bf16 sweep-chain and halo-sweep
forms, its outer loop keeping the f32 true residual; the default solver's
bf16 preconditioner cycle and the f32 correction epilogue are as under
f32. bf16 needs f32 state and ny a multiple of 16, as the JAX package's
``fused_tier_supported(prec="bf16")`` (its TPU-only ``nx % 128`` rule does
not apply), and refuses otherwise.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import tracing
from .bc import (FREE_SLIP, BCTable, divergence_affine_bc,
                 divergence_coeffs, pad_vector_bc, periodic_axes,
                 pressure_signs)
from .config import SimConfig
from .ops.hopper_kernels import fused_advect_heun
from .ops.stencil import (divergence_bc, divergence_freeslip,
                          divergence_rhs_fused, dt_from_umax, laplacian5_bc,
                          laplacian5_neumann, pad_scalar, pad_vector,
                          vorticity)
from .parallel.shard_halo import (canonical_device, divergence_bc_x,
                                  fused_advect_heun_sharded, laplacian5_bc_x,
                                  project_correct_x, slab_all_finite,
                                  slab_linf, slab_reducers, slab_sum,
                                  split_x)
from .poisson import (FFTDiagPlan, MultigridPreconditioner, _reducers,
                      apply_block_precond, bicgstab, block_precond_matrix,
                      fft_diag_solve, mg_solve, project_correct)
from .shapes_host import pull, pull_diag

__all__ = ["FlowState", "UniformGrid", "UniformSim", "bench_state",
           "pad_scalar", "pad_vector", "resolve_device",
           "taylor_green_state"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


# the ROADMAP entry of the paths that refuse f64 state on the card
F64_NEXT_SLICE = ("ROADMAP.md queue 2, note (c): the f64 forms of kernels 3 "
                  "and 7 and of tridiag.cu are the next slice")


def check_card_f64(device, dtype, what: str) -> None:
    """Refuse f64 state on the card for ``what``, a path that launches a
    kernel with no f64 form (the halo substage and sweep of the split
    step, ``tridiag.cu`` of fftd). Called at construction, before anything
    is allocated; f64 runs such paths on ``device="cpu"``."""
    if isinstance(dtype, str):
        dtype = _DTYPES.get(dtype, dtype)
    if torch.device(device).type == "cuda" and dtype == torch.float64:
        raise ValueError(
            f"{what} at float64 on {device}: a kernel it launches has no "
            f"f64 form ({F64_NEXT_SLICE}); run it at float32, or at "
            "float64 on device='cpu'")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no card and no device
    given raises instead of dropping to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (plain twins of the kernels)")
        return torch.device("cuda")
    return torch.device(device)


class FlowState(NamedTuple):
    """Per-step state (the reference's field grids, main.cpp:3264-3278).
    ``us`` is the full solid velocity targeted by penalization, ``udef``
    the deformation-only part in the pressure RHS; ``pres`` at entry to a
    step is the previous pressure."""

    vel: torch.Tensor    # [2, Ny, Nx]
    pres: torch.Tensor   # [Ny, Nx]
    chi: torch.Tensor    # [Ny, Nx]
    us: torch.Tensor     # [2, Ny, Nx]
    udef: torch.Tensor   # [2, Ny, Nx]


def taylor_green_state(grid) -> FlowState:
    """Taylor-Green vortex compatible with the free-slip box (zero normal
    velocity at all walls), decaying as exp(-2 nu pi^2 (1/Lx^2 + 1/Ly^2) t)."""
    x, y = grid.cell_centers()
    lx, ly = grid.cfg.extents
    u = np.sin(np.pi * x / lx) * np.cos(np.pi * y / ly)
    v = -(ly / lx) * np.cos(np.pi * x / lx) * np.sin(np.pi * y / ly)
    return grid.zero_state()._replace(vel=grid.tensor(np.stack([u, v])))


def bench_state(grid) -> FlowState:
    """The benchmark's initial velocity (``bench.bench_state`` of the JAX
    package): a shear-layer pair, a mid-scale mode and a non-solenoidal
    mode at a fixed 64 cells per wavelength, so the Poisson load does not
    fade with resolution. Normal components vanish at the walls."""
    x, y = grid.cell_centers()
    lx, ly = grid.cfg.extents
    xs, ys = np.pi * x / lx, np.pi * y / ly
    m = max(grid.nx // 64, 32)
    u = (np.sin(xs) * np.cos(ys)
         + 0.25 * np.sin(8 * xs) * np.cos(8 * ys)
         + 0.3 * np.sin(m * xs) * np.sin(m * ys))
    v = (-np.cos(xs) * np.sin(ys)
         + 0.25 * np.sin(16 * ys) * np.sin(16 * xs)
         + 0.3 * np.sin(m * ys) * np.sin(m * xs))
    return grid.zero_state()._replace(vel=grid.tensor(np.stack([u, v])))


class UniformGrid:
    """Geometry and operators for one uniform resolution."""

    def __init__(self, cfg: SimConfig, level: Optional[int] = None,
                 device=None, bc=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype {cfg.dtype!r}: expected float32|float64")
        self.dtype = _DTYPES[cfg.dtype]
        bc = FREE_SLIP if bc is None else bc
        if not isinstance(bc, BCTable):
            raise TypeError(
                f"bc={bc!r}: expected a cup2d_tpu_torch.bc.BCTable "
                "(convert.bc_from_fields carries a JAX table over)")
        self.bc = bc.validate()
        prec = os.environ.get("CUP2D_PREC", "") or "f32"
        if prec not in ("f32", "bf16"):
            raise ValueError(f"CUP2D_PREC={prec!r}: expected f32|bf16")
        self.bf16 = prec == "bf16"
        if self.bf16 and any(periodic_axes(self.bc)):
            faces = [n for n, f in zip(("x_lo", "x_hi", "y_lo", "y_hi"),
                                       self.bc) if f.kind == "periodic"]
            raise ValueError(
                f"CUP2D_PREC=bf16: BCTable ({self.bc.token}) faces "
                f"{', '.join(faces)} have kind 'periodic', which the bf16 "
                "tier has no form of (the JAX package's bf16 tier needs "
                "CUP2D_PALLAS=1, which refuses periodic tables); drop "
                "CUP2D_PREC for this table")
        pois = os.environ.get("CUP2D_POIS", "")
        if pois not in ("", "structured", "tables", "fft", "fas", "fas-f",
                        "fftd"):
            raise ValueError(
                f"CUP2D_POIS={pois!r}: expected "
                "structured|tables|fft|fas|fas-f|fftd")
        self.solver_mode = ("fftd" if pois == "fftd"
                            else "fas" if pois in ("fas", "fas-f")
                            else "bicgstab")
        self.fas_fmg = pois == "fas-f"
        if self.solver_mode == "fftd":
            check_card_f64(self.device, self.dtype,
                           "CUP2D_POIS=fftd (tridiag.cu takes complex64)")
        lvl = cfg.level_start if level is None else level
        self.level = lvl
        self.nx = cfg.bpdx * cfg.bs << lvl
        self.ny = cfg.bpdy * cfg.bs << lvl
        self.h = cfg.h_at(lvl)
        if self.bf16 and (self.dtype != torch.float32 or self.ny < 16
                          or self.ny % 16):
            raise ValueError(
                f"CUP2D_PREC=bf16 unsupported for this grid ({cfg.dtype} "
                f"{self.ny}x{self.nx}): the bf16 tier needs f32 state and "
                "ny % 16 == 0")
        # the table's per-face operator coefficients; None on the free-slip
        # table, whose consumers take the free-slip code unchanged
        if self.bc.is_free_slip:
            self._psigns = self._dcoeffs = self._div_affine = None
        else:
            self._psigns = pressure_signs(self.bc)
            self._dcoeffs = divergence_coeffs(self.bc)
            self._div_affine = divergence_affine_bc(
                self.bc, self.ny, self.nx, self.dtype, self.device)
        # the periodic axes (px, py): wrap shifts in the operator, the
        # divergence, the gradient and the hierarchy
        self._paxes = periodic_axes(self.bc)
        if self.solver_mode == "fftd":
            if not any(self._paxes):
                raise ValueError(
                    f"CUP2D_POIS=fftd needs at least one periodic "
                    f"direction, got BCTable ({self.bc.token}): the FFT "
                    "diagonalizes a periodic axis's second difference; run "
                    "wall-only boxes under bicgstab/fas")
            self._fft_plan = FFTDiagPlan(self.ny, self.nx, self.dtype,
                                         *self._paxes, self._psigns,
                                         device=self.device)
        else:
            self._fft_plan = None
        if self.device.type == "cuda":
            # the block preconditioner's GEMM stays in full f32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.p_inv = self.tensor(block_precond_matrix(cfg.bs))
        self.mesh = None
        self._div_affine_x = None
        self.mg = self._multigrid()
        # f32 fields take their Krylov dot products in f64 (the JAX
        # package does so whenever x64 is on)
        self.sum_dtype = (torch.float64 if self.dtype == torch.float32
                          else None)

    def _multigrid(self) -> MultigridPreconditioner:
        fas = self.solver_mode == "fas"
        return MultigridPreconditioner(
            self.ny, self.nx, self.dtype,
            cycle_dtype=self.dtype if fas else None, fused_smoother=fas,
            mesh=self.mesh, edge_signs=self._psigns,
            leg_dtype=torch.bfloat16 if fas and self.bf16 else None,
            periodic=self._paxes)

    def attach_mesh(self, mesh) -> None:
        """Split the step along x over ``mesh`` (a ``SlabMesh`` whose home
        device, its first local shard's, is this grid's): the fields it
        takes and returns are then ``Slabs``. The advection runs the halo-mode substage per shard,
        the multigrid hierarchy (the FAS solver's and the bf16
        preconditioner's) is rebuilt on split fields, the projection
        epilogue is plain per-slab code (the correction kernel stays off,
        as in the JAX package), and every reduction combines per-shard
        partials. The bf16 storage tier carries over: the halo substage
        runs its bf16 form and the FAS hierarchy, rebuilt here, its bf16
        legs. So does the boundary table: the halo substage paints its
        ghosts, the hierarchy and the Laplacian carry its pressure signs,
        the RHS its divergence coefficients and affine term (split here
        once) and the epilogue its gradient signs and mean rule. A periodic
        table carries over too: a periodic x closes the slabs into a ring
        (``shard_halo.exchange_x(ring=True)``, no wall shard), a periodic y
        wraps the rows inside every slab (the y-wrap forms of the halo
        kernels), and the doubly-periodic mean removal combines per-shard
        partials in f64. So do the obstacle terms of ``step``: chi, us
        and udef are ``Slabs`` too, the penalization runs per slab and the
        RHS adds chi div(u_def) in the split form. fftd refuses (its
        transforms and scans are whole-array), as in the JAX package; Nx
        must divide by the mesh size."""
        check_card_f64(self.device, self.dtype,
                       "the x-split step (kernels 3 and 7)")
        if self.solver_mode == "fftd":
            raise ValueError(
                "CUP2D_POIS=fftd cannot attach a device mesh: the x-split "
                "shards the FFT transform axis (periodic x) or the "
                "tridiagonal scan axis (periodic y); run sharded periodic "
                "cases under bicgstab/fas")
        if self.nx % mesh.size:
            raise ValueError(f"Nx={self.nx} not divisible by mesh size "
                             f"{mesh.size}")
        if mesh.home != canonical_device(self.device):
            raise ValueError(f"mesh {mesh} does not start on the grid's "
                             f"device {self.device}")
        self.mesh = mesh
        self._div_affine_x = (None if self._div_affine is None
                              else split_x(self._div_affine, mesh))
        self.mg = self._multigrid()

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def cell_centers(self):
        x = (np.arange(self.nx) + 0.5) * self.h
        y = (np.arange(self.ny) + 0.5) * self.h
        return np.meshgrid(x, y, indexing="xy")

    def zero_state(self) -> FlowState:
        def z(*lead):
            return torch.zeros(*lead, self.ny, self.nx, dtype=self.dtype,
                               device=self.device)

        return FlowState(vel=z(2), pres=z(), chi=z(), us=z(2), udef=z(2))

    # -- dt control (main.cpp:6579-6595) --
    def dt_from_umax(self, umax) -> torch.Tensor:
        return dt_from_umax(
            torch.as_tensor(umax, dtype=self.dtype, device=self.device),
            torch.tensor(self.h, dtype=self.dtype, device=self.device),
            self.cfg.nu, self.cfg.cfl)

    def _linf(self, a, members: bool = False) -> torch.Tensor:
        """max |a|; ``members``: one per member of a fleet's velocity
        [B, 2, Ny, Nx] (over its last three axes)."""
        if members:
            return torch.amax(torch.abs(a), dim=(-3, -2, -1))
        if self.mesh is not None:
            return slab_linf(a)
        return torch.amax(torch.abs(a))

    def compute_dt(self, vel: torch.Tensor,
                   members: bool = False) -> torch.Tensor:
        """The CFL dt of ``vel``; ``members``: a [B] row of a fleet's
        velocity [B, 2, Ny, Nx], each the solo dt of its member."""
        return self.dt_from_umax(self._linf(vel, members))

    def laplacian(self, p: torch.Tensor) -> torch.Tensor:
        """The undivided Poisson operator with the table's pressure rows."""
        if self.mesh is not None:
            return laplacian5_bc_x(p, self._psigns, self._paxes)
        if self._psigns is None:
            return laplacian5_neumann(p)
        return laplacian5_bc(p, *self._psigns, *self._paxes)

    def pad_vector_field(self, v: torch.Tensor, g: int,
                         dt=None) -> torch.Tensor:
        """Velocity ghost paint per the table (``dt`` feeds the outflow
        speed; None extrapolates at c = 0)."""
        return pad_vector_bc(v, g, self.bc, self.h, dt)

    def poisson_rhs(self, vel, chi, udef, dt) -> torch.Tensor:
        """(h/2dt)[div u* - chi div u_def] with the table's edge
        coefficients and the constant of prescribed wall-normal velocities;
        ``chi=None`` drops the obstacle term. On a mesh the fields are
        ``Slabs`` and the split form (``shard_halo.divergence_bc_x``) adds
        the same terms in the same order. A fleet passes member stacks
        and dt as [B, 1, 1]."""
        if self.mesh is not None:
            return divergence_bc_x(vel, self.h, dt, self._dcoeffs,
                                   self._div_affine_x, self._paxes,
                                   chi=chi, udef=udef)
        if self._dcoeffs is None:
            if chi is None:
                return (0.5 * self.h / dt) * divergence_freeslip(vel)
            return divergence_rhs_fused(vel, udef, chi, self.h, dt)
        fac = 0.5 * self.h / dt
        b = fac * divergence_bc(vel, *self._dcoeffs, *self._paxes)
        if self._div_affine is not None:
            b = b + fac * self._div_affine
        if chi is not None:
            b = b - (fac * chi) * divergence_bc(udef, *self._dcoeffs,
                                                *self._paxes)
        return b

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return apply_block_precond(r, self.p_inv, self.cfg.bs)

    @property
    def bc_table(self) -> str:
        """The boundary table's token, e.g. ``ns,ns,ns,ns(1,0)``."""
        return self.bc.token

    @property
    def kernel_tier(self) -> str:
        """What runs the kernels' work: ``hopper`` (the CUDA kernels, on
        the card) or ``plain`` (their twins, on the CPU), ``-bf16`` under
        the bf16 storage tier, with the table's token suffixed for a table
        other than free-slip, as the JAX package stamps its fused tier
        (``pallas-fused-bf16+bc(...)``):
        ``hopper-bf16+bc(ns,ns,ns,ns(1,0))``, ``hopper+bc(pd,pd,pd,pd)``
        (the wrap forms; the JAX package stamps ``xla`` there)."""
        tier = "hopper" if self.device.type == "cuda" else "plain"
        if self.bf16:
            tier += "-bf16"
        if not self.bc.is_free_slip:
            return f"{tier}+bc({self.bc.token})"
        return tier

    @property
    def prec_mode(self) -> str:
        """Storage precision of the advection kernels' operands: ``bf16``
        under the bf16 tier, else the state's (``f32``, ``f64``)."""
        if self.bf16:
            return "bf16"
        return {torch.float32: "f32", torch.float64: "f64"}[self.dtype]

    @property
    def smoother_tier(self) -> str:
        """The sweep chains' label (``MultigridPreconditioner.smoother_tier``):
        ``strip`` (the fused smoother, fas) or ``xla`` (plain code, the
        default solver's cycle), ``+bf16`` on bf16 legs."""
        return self.mg.smoother_tier

    @property
    def poisson_mode(self) -> str:
        """``fftd`` (the doubly-periodic spectral divide), ``fftd+tridiag``
        (one periodic axis: per-mode Thomas systems), ``fas``/``fas-f``,
        or ``bicgstab+mg``/``bicgstab``."""
        if self.solver_mode == "fftd":
            return "fftd" if all(self._paxes) else "fftd+tridiag"
        if self.solver_mode == "fas":
            return "fas-f" if self.fas_fmg else "fas"
        return "bicgstab+mg" if self.cfg.precond else "bicgstab"

    def pressure_solve(self, rhs: torch.Tensor, exact: bool = False):
        """Solve lap(dp) = rhs (undivided). ``exact`` is the reference's
        first-10-steps override (main.cpp:7028-7030): tol 0 with 100
        restarts, exiting through the stall detector at the precision
        floor; it always runs Krylov under fas. fftd is one direct solve
        either way (an exact request reports its floor as ``stalled``)."""
        cfg = self.cfg
        if self.solver_mode == "fftd":
            return fft_diag_solve(
                self.laplacian, rhs, self._fft_plan,
                tol=0.0 if exact else cfg.poisson_tol,
                tol_rel=0.0 if exact else cfg.poisson_tol_rel)
        reducers = _reducers if self.mesh is None else slab_reducers
        if self.solver_mode == "fas" and not exact:
            return mg_solve(
                self.laplacian, rhs, self.mg,
                tol=cfg.poisson_tol, tol_rel=cfg.poisson_tol_rel,
                max_cycles=cfg.max_poisson_iterations, fmg=self.fas_fmg,
                reducers=reducers)
        return bicgstab(
            self.laplacian, rhs,
            M=self.mg if cfg.precond else None,
            tol=0.0 if exact else cfg.poisson_tol,
            tol_rel=0.0 if exact else cfg.poisson_tol_rel,
            max_iter=cfg.max_poisson_iterations,
            max_restarts=100 if exact else cfg.max_poisson_restarts,
            sum_dtype=self.sum_dtype,
            refresh_every=10 if exact else 50,
            stall_iters=20 if exact else 120,
            stall_rtol=0.99 if exact else 0.999,
            reducers=reducers,
        )

    def advect_heun(self, vel: torch.Tensor, dt) -> torch.Tensor:
        """Two-stage Heun advection-diffusion (main.cpp:6607-6642), both
        substages through the substage kernel (its boundary-table form for
        a table other than free-slip; its twin on the CPU), or through the
        halo-mode substage per shard on a mesh; their bf16 forms under the
        bf16 tier."""
        if self.mesh is not None:
            return fused_advect_heun_sharded(vel, self.h, self.cfg.nu, dt,
                                             bc=self.bc, bf16=self.bf16)
        return fused_advect_heun(vel, self.h, self.cfg.nu, dt, bc=self.bc,
                                 bf16=self.bf16)

    def project(self, vel, pres_old, chi, udef, dt, exact_poisson=False):
        """deltap solve and correction (main.cpp:7007-7187). Returns (vel,
        pres, solver_result, div_linf), div_linf the max |div| of the
        pre-projection velocity in physical units. A table with an outflow
        face keeps the pressure mean (its Dirichlet row fixes the
        level)."""
        h = self.h
        b = self.poisson_rhs(vel, chi, udef, dt)
        div_linf = self._linf(b) * (dt / (h * h))
        b = b - self.laplacian(pres_old)
        res = self.pressure_solve(b, exact=exact_poisson)
        if self.mesh is not None:
            vel, pres = project_correct_x(
                res.x, pres_old, vel, h, dt,
                remove_mean=self.bc.all_neumann, grad_signs=self._psigns,
                periodic=self._paxes)
        else:
            vel, pres = project_correct(
                res.x, pres_old, vel, h, dt,
                remove_mean=self.bc.all_neumann, grad_signs=self._psigns,
                periodic=self._paxes)
        return vel, pres, res, div_linf

    def precond_cycles(self, res, exact):
        """Hierarchy cycles of one solve: FAS iterations are cycles,
        flexible BiCGSTAB applies M twice per iteration, the direct solve
        none; per member (a [B] tensor) for a member-axis solve's
        ``res``."""
        none = (torch.zeros_like(res.iters) if torch.is_tensor(res.iters)
                else 0)
        if self.solver_mode == "fftd":
            return none
        if self.solver_mode == "fas" and not exact:
            return res.iters
        if self.cfg.precond:
            return 2 * res.iters
        return none

    def step_diag(self, vel, pres, res, div_linf=None,
                  exact=False) -> dict:
        """Step diagnostics; tensor values stay on the device."""
        umax = self._linf(vel)
        vv = vel.to(self.sum_dtype) if self.sum_dtype is not None else vel
        if self.mesh is not None:
            energy = 0.5 * self.h * self.h * slab_sum(vv * vv)
            finite = slab_all_finite(vel, pres)
        else:
            energy = 0.5 * self.h * self.h * torch.sum(vv * vv)
            finite = torch.isfinite(vel).all() & torch.isfinite(pres).all()
        return {
            "poisson_iters": res.iters,
            "poisson_residual": res.residual,
            "poisson_stalled": res.stalled,
            "poisson_converged": res.converged,
            "finite": finite,
            "umax": umax,
            "energy": energy,
            "div_linf": div_linf,
            "precond_cycles": self.precond_cycles(res, exact),
            "dt_next": self.dt_from_umax(umax),
        }

    def penalize(self, vel, chi, us, dt):
        """The Brinkman penalization's implicit update (main.cpp:6961-6977):
        alpha vel + (1 - alpha) us with alpha = 1/(1 + lam dt) inside the
        solid (chi > 0.5), else 1. Fields whole or ``Slabs`` (slab by
        slab); a fleet passes member stacks and dt as [B, 1, 1]."""
        a = 1.0 / (1.0 + self.cfg.lam * dt)

        def one(v, c, u):
            alpha = torch.where(c > 0.5, a.to(c.device),
                                torch.ones_like(c)).unsqueeze(-3)
            return alpha * v + (1.0 - alpha) * u
        if self.mesh is not None:
            return vel.map(one, chi, us)
        return one(vel, chi, us)

    def step(self, state: FlowState, dt, exact_poisson: bool = False,
             obstacle_terms: bool = True) -> tuple[FlowState, dict]:
        """One projection step, whole or split along x on a mesh.
        ``obstacle_terms=False`` drops the penalization update and the
        chi*div(u_def) RHS term, identically zero without shapes."""
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        vel = self.advect_heun(state.vel, dt)
        if obstacle_terms:
            vel = self.penalize(vel, state.chi, state.us, dt)
        vel, pres, res, div_linf = self.project(
            vel, state.pres,
            state.chi if obstacle_terms else None,
            state.udef if obstacle_terms else None, dt, exact_poisson)
        return state._replace(vel=vel, pres=pres), \
            self.step_diag(vel, pres, res, div_linf, exact=exact_poisson)

    def vorticity_field(self, vel: torch.Tensor) -> torch.Tensor:
        return vorticity(self.pad_vector_field(vel, 1), 1, self.h)


class UniformSim:
    """Host-side driver of the obstacle-free step: time and step
    counters, cached next dt; ``case`` names the catalog entry that built
    it (``cases.py``)."""

    def __init__(self, cfg: SimConfig, level: Optional[int] = None,
                 device=None, bc=None):
        self.grid = UniformGrid(cfg, level, device=device, bc=bc)
        self.case: Optional[str] = None
        self.cfg = cfg
        self.state = self.grid.zero_state()
        self.time = 0.0
        self.step_count = 0
        self.shapes: list = []          # obstacle-free by construction
        self.force_log = None
        self._next_dt = None
        self._force_exact = False
        self.async_diag = False
        # profiling.PhaseTimers, opt-in; this driver opens no phase (as
        # cup2d_tpu/uniform.py:676)
        self.timers = None

    @property
    def poisson_mode(self) -> str:
        return self.grid.poisson_mode

    @property
    def bc_table(self) -> str:
        return self.grid.bc_table

    @property
    def kernel_tier(self) -> str:
        return self.grid.kernel_tier

    @property
    def prec_mode(self) -> str:
        return self.grid.prec_mode

    @property
    def smoother_tier(self) -> str:
        return self.grid.smoother_tier

    def step_once(self, dt: Optional[float] = None):
        """One step with the reference's exact solves for the first 10
        steps, the cached dt_next of the previous step, and one pull of
        the diagnostics to the host; under ``async_diag`` the tensor
        diagnostics (including the dt used) stay on the device and the
        clock is left to the caller."""
        g = self.grid
        if dt is None:
            if self._next_dt is not None:
                dt = self._next_dt
            else:
                with tracing.label("uniform.dt"):
                    dt = float(pull(g.compute_dt(self.state.vel))[0])
        exact = self.step_count < 10 or self._force_exact
        dt_dev = torch.as_tensor(dt, dtype=g.dtype, device=g.device)
        with tracing.label("uniform.step"):
            self.state, diag = g.step(self.state, dt_dev,
                                      exact_poisson=exact,
                                      obstacle_terms=False)
        if self.async_diag:
            diag["dt"] = dt_dev
            self._next_dt = diag["dt_next"]
            self.step_count += 1
            return diag
        diag, _ = pull_diag(diag)
        diag["dt"] = float(dt)
        self._next_dt = float(diag["dt_next"])
        self.time += float(dt)
        self.step_count += 1
        return diag

    def advance(self, n_steps: int = 1, tend: Optional[float] = None,
                exact_first_steps: bool = False):
        """``n_steps`` steps at the CFL dt (clipped to land on ``tend``);
        ``exact_first_steps`` mirrors the reference's tol-0 solves for
        steps < 10."""
        diag = {}
        for _ in range(n_steps):
            if tend is not None and self.time >= tend:
                break
            dt = float(pull(self.grid.compute_dt(self.state.vel))[0])
            if tend is not None:
                dt = min(dt, tend - self.time + 1e-15)
            exact = exact_first_steps and self.step_count < 10
            self.state, diag = self.grid.step(
                self.state, dt, exact_poisson=exact, obstacle_terms=False)
            self.time += dt
            self.step_count += 1
        return diag
