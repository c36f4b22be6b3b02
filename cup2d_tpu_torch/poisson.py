"""Matrix-free pressure-Poisson solvers: the counterpart of
``cup2d_tpu.poisson`` for the uniform box (Neumann, or a boundary table's
per-face signs) and the forest.

* ``block_precond_matrix`` / ``apply_block_precond``: the reference's
  block-Jacobi preconditioner (main.cpp:6451-6488) as a batched GEMM.
* ``MultigridPreconditioner``: the geometric V-cycle (damped-Jacobi
  smoothing, 2x2 sum restriction, nearest prolongation). Under an f32
  Krylov solve the cycle runs in bf16 (a preconditioner only shapes the
  error); as the FAS solver it runs at solver precision, or with bf16
  legs (``leg_dtype``, ``CUP2D_PREC=bf16``), and its sweep chains go
  through ``hopper_kernels.fused_jacobi_sweeps``. With a slab mesh it runs
  on x-split fields (``parallel.shard_halo``).
* ``bicgstab``: flexible BiCGSTAB with the reference's Linf criterion,
  breakdown restarts, periodic true-residual refresh and the L2 stall
  exit.
* ``mg_solve``: repeated V-cycles (optionally opened by an F-cycle) with
  the true residual.
* ``project_correct``: the projection epilogue, through
  ``hopper_kernels.fused_correction`` (with a boundary table's pressure
  signs, its periodic axes, and, for an outflow table, without the mean
  removal).
* ``FFTDiagPlan`` / ``fft_diag_solve``: the FFT-diagonalized direct solve
  of a table with a periodic axis (``CUP2D_POIS=fftd``): a spectral divide
  on the doubly-periodic box, per-mode tridiagonal systems along the wall
  axis otherwise (``hopper_kernels.tridiag_scan``). The transforms are
  ``torch.fft``, as the JAX package's are ``jnp.fft`` outside any kernel.
* The forest's pieces: ``apply_block_precond_blocks``, the DCT-II exact
  Neumann base solve (``dct_neumann_operators``,
  ``coarse_neumann_solve_dct``), the image ladder steps and
  ``ForestFASCycle``.

The JAX package runs both solvers as on-device ``lax.while_loop``s. Here
they are host loops that read the iteration's few control bits from the
device once or twice per iteration, so they take exactly the branches the
JAX loop takes and their iteration counts are equal. The member forms read
one stacked flag row an iteration (``_member_flags``); on a member-placed
fleet across processes that read is one all-gather of the ranks' [k, B/D]
flag stacks in member order and then one ``pull`` on every rank (counted
once in each process's ``device_gets``, the all-gather in
``shard_halo.comm_stats`` under "reductions"), so every rank takes the same
refresh, restart and stall branches.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .ops.hopper_kernels import (_signs, _wrap_axes, fused_correction,
                                 fused_jacobi_sweeps, jacobi_sweeps_plain,
                                 tridiag_scan)
from .ops.stencil import laplacian5_bc, laplacian5_neumann
from . import tracing
from .parallel.shard_halo import (Blocks, all_shards, laplacian5_bc_x,
                                  level_meshes, overlap_jacobi_sweeps,
                                  reshard)
from .shapes_host import pull


def block_precond_matrix(bs: int, dtype=np.float64) -> np.ndarray:
    """P_inv = -inv(A_local), the negated inverse of the bs^2 x bs^2
    single-block 5-point Laplacian with homogeneous Dirichlet truncation
    at the block edge (reference getA_local main.cpp:46-57)."""
    n = bs * bs
    ii = np.arange(n)
    xi, yi = ii % bs, ii // bs
    a = np.zeros((n, n), dtype=np.float64)
    dx = np.abs(xi[:, None] - xi[None, :])
    dy = np.abs(yi[:, None] - yi[None, :])
    a[(dx + dy) == 1] = -1.0
    np.fill_diagonal(a, 4.0)
    return (-np.linalg.inv(a)).astype(dtype)


def apply_block_precond(r: torch.Tensor, p_inv: torch.Tensor,
                        bs: int) -> torch.Tensor:
    """z = P_inv r per bs x bs tile of a [..., Ny, Nx] field (batched
    GEMM). The product runs in full f32 on the card: the caller
    (``UniformGrid``) sets ``torch.backends.cuda.matmul.allow_tf32 =
    False``."""
    ny, nx = r.shape[-2], r.shape[-1]
    nby, nbx = ny // bs, nx // bs
    lead = r.shape[:-2]
    tiles = r.reshape(*lead, nby, bs, nbx, bs)
    tiles = tiles.transpose(-3, -2).reshape(*lead, nby, nbx, bs * bs)
    z = tiles @ p_inv.T
    z = z.reshape(*lead, nby, nbx, bs, bs).transpose(-3, -2)
    return z.reshape(r.shape)


def apply_block_precond_blocks(r: torch.Tensor,
                               p_inv: torch.Tensor) -> torch.Tensor:
    """Same, for block-forest layout [N, bs, bs]."""
    n, bs, _ = r.shape
    return (r.reshape(n, bs * bs) @ p_inv.T).reshape(n, bs, bs)


class MultigridPreconditioner:
    """V(nu1, nu2)-cycle for lap(e) = r on a [Ny, Nx] all-Neumann grid, or
with ``edge_signs`` a boundary table's (sx_lo, sx_hi, sy_lo, sy_hi)
pressure signs (bc.pressure_signs): the signed Laplacian and Jacobi
diagonal on every level (a face's kind survives coarsening), in the plain
cycle and in the fused sweep chains alike.

    Undivided operators throughout; the restricted residual is the 2x2
    SUM (x4 of the mean) because the undivided coarse operator is 4x the
    fine one. ``cycle_dtype=None`` under an f32 solver gives the bf16
    preconditioner cycle; the FAS solver passes its own dtype.
    ``leg_dtype`` (bf16 under ``CUP2D_PREC=bf16`` with the FAS solver)
    takes precedence: the cycle's storage (smoothing, residuals,
    transfers) is bf16 and its output the solver's dtype, while
    ``mg_solve``'s outer loop keeps the true residual at solver precision.
    ``fused_smoother`` sends every sweep chain through the
    ``fused_jacobi_sweeps`` wrapper (kernel on the card, twin on the
    CPU); otherwise the chains are plain tensor code, as the XLA chains
    are in the JAX package. The Jacobi diagonal (``_inv_diag`` in the JAX
    package) is ``ops.stencil.inv_diag_neumann``, shared with the twin.

    ``mesh`` (a ``SlabMesh``) runs the cycle on x-split fields
    (``Slabs``). The JAX package splits only its finest level by hand
    (``overlap_levels=1``) and leaves the coarser ones to GSPMD; here every
    level is written out, and ``shard_halo.level_meshes`` chooses per
    level between two forms: split halo sweeps (each sweep exchanges one
    edge column, then sweeps every slab: the halo kernel under
    ``fused_smoother``, its plain twin in the bf16 cycle) while the slabs
    stay even and at least ``MIN_SPLIT_WIDTH`` wide, and below that the
    level gathered onto ``mesh.home`` (a one-shard mesh, the same
    sweeps without an exchange), where D launches and an exchange per
    sweep of a few hundred cells cost more than the sweep. Sweeps,
    restriction and prolongation are pointwise, so the split cycle equals
    the solo one bit for bit. A table's ``edge_signs`` carry through both
    forms (the signed halo sweep on every split or gathered level; the
    JAX package instead drops its split smoother for a signed hierarchy
    and lets GSPMD partition the signed strip sweeps).

    ``periodic`` (bc.periodic_axes) makes the operator's shifts wrap along
    a periodic axis at every level (periodicity survives 2x coarsening),
    whose ``edge_signs`` are 0, so the Jacobi diagonal keeps the interior
    -4 there; the fused chains run the sweep kernel's wrap form. It needs
    the table's ``edge_signs``. On a mesh the split levels exchange on a
    ring of slabs along a periodic x (a level gathered onto one device is
    its own neighbour) and wrap the rows inside every slab along a
    periodic y (the halo sweep's y-wrap form under ``fused_smoother``)."""

    def __init__(self, ny: int, nx: int, dtype, nu1: int = 2,
                 nu2: int = 2, coarsest: int = 16, omega: float = 0.8,
                 cycle_dtype=None, fused_smoother: bool = False,
                 mesh=None, edge_signs=None, leg_dtype=None,
                 periodic=(False, False)):
        self.periodic = (bool(periodic[0]), bool(periodic[1]))
        if any(self.periodic):
            if edge_signs is None:
                raise ValueError(
                    "MultigridPreconditioner: periodic axes need the "
                    "boundary table's edge_signs (bc.pressure_signs, 0 on "
                    "the periodic faces); the all-Neumann default would "
                    "paint wall corrections over the wrap rows")
        self.edge_signs = (None if edge_signs is None
                           else tuple(float(x) for x in edge_signs))
        self.nu1 = nu1
        self.nu2 = nu2
        self.omega = omega
        self.leg_dtype = leg_dtype
        self.dtype = leg_dtype or cycle_dtype or (
            torch.bfloat16 if dtype == torch.float32 else dtype)
        self.out_dtype = dtype
        self.fused_smoother = fused_smoother
        self.shapes = []
        while ny >= coarsest and nx >= coarsest \
                and ny % 2 == 0 and nx % 2 == 0:
            self.shapes.append((ny, nx))
            ny //= 2
            nx //= 2
        self.shapes.append((ny, nx))
        self.meshes = (None if mesh is None
                       else level_meshes(self.shapes, mesh))

    @property
    def smoother_tier(self) -> str:
        """The JAX package's label of the sweep chains: ``strip`` where they
        run through the fused smoother (its ``fused_jacobi_sweeps``; here
        ``fused_smoother``), else ``xla`` (plain code), with ``+bf16``
        where the legs are bf16 (``leg_dtype``, or a bf16 cycle on the
        fused smoother). The default solver's bf16 preconditioner cycle
        keeps the bare ``xla``."""
        base = "strip" if self.fused_smoother else "xla"
        if self.dtype == torch.bfloat16 and (self.leg_dtype is not None
                                             or base == "strip"):
            return base + "+bf16"
        return base

    def _lap(self, p):
        if self.meshes is not None:
            return laplacian5_bc_x(p, self.edge_signs, self.periodic)
        if self.edge_signs is not None:
            return laplacian5_bc(p, *self.edge_signs, *self.periodic)
        return laplacian5_neumann(p)

    def _smooth(self, e, r, lvl, n, from_zero=False):
        if self.meshes is not None:
            return overlap_jacobi_sweeps(e, r, self.omega, n, from_zero,
                                         fused=self.fused_smoother,
                                         edge_signs=self.edge_signs)
        if self.fused_smoother:
            return fused_jacobi_sweeps(e, r, self.omega, n, from_zero,
                                       self.edge_signs)
        return jacobi_sweeps_plain(e, r, self.omega, n, from_zero,
                                   self.edge_signs, self.periodic)

    def __call__(self, r):
        return self._cycle(r.to(self.dtype), 0).to(self.out_dtype)

    def fcycle(self, r):
        """One F-cycle: recurse to the coarsest level first, prolongate
        each coarse solution as the finer level's initial guess, then one
        V-cycle relaxation there (the opening move of ``fmg``)."""
        return self._fcycle(r.to(self.dtype), 0).to(self.out_dtype)

    @staticmethod
    def _restrict(res):
        rows = res[..., 0::2, :] + res[..., 1::2, :]
        return rows[..., :, 0::2] + rows[..., :, 1::2]

    @staticmethod
    def _prolong(ec):
        return ec.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    def _down(self, res, lvl):
        """Restrict level ``lvl`` to ``lvl + 1``, gathering first where the
        coarser level runs on fewer shards."""
        if self.meshes is None:
            return self._restrict(res)
        return reshard(res, self.meshes[lvl + 1]).map(self._restrict)

    def _up(self, ec, lvl):
        """Prolong level ``lvl + 1`` to ``lvl``, splitting after where the
        finer level runs on more shards."""
        if self.meshes is None:
            return self._prolong(ec)
        return reshard(ec.map(self._prolong), self.meshes[lvl])

    def _fcycle(self, r, lvl):
        if lvl == len(self.shapes) - 1:
            return self._smooth(None, r, lvl, 24, from_zero=True)
        ec = self._fcycle(self._down(r, lvl), lvl + 1)
        return self._cycle(r, lvl, e0=self._up(ec, lvl))

    def _cycle(self, r, lvl, e0=None):
        if lvl == len(self.shapes) - 1:
            # coarsest: enough sweeps to wash out the local modes; the
            # constant mode is the outer solver's job
            if e0 is not None:
                return self._smooth(e0, r, lvl, 24)
            return self._smooth(None, r, lvl, 24, from_zero=True)
        if e0 is not None:
            e = self._smooth(e0, r, lvl, self.nu1)
        else:
            e = self._smooth(None, r, lvl, self.nu1, from_zero=True)
        rc = self._down(r - self._lap(e), lvl)
        e = e + self._up(self._cycle(rc, lvl + 1), lvl)
        return self._smooth(e, r, lvl, self.nu2)


class BiCGSTABResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float      # Linf of the best residual seen
    converged: bool
    stalled: bool        # exited via the stall detector


def _member_reducers(dt_, sum_dtype):
    """(dot, linf, zeros_like, where) of member stacks [B, ...]: one value
    per member over axes 1.., kept as [B, 1, ..., 1]; dot products
    accumulate in ``sum_dtype`` (default the field dtype). The split-field
    counterpart is ``parallel.shard_halo.slab_member_reducers``."""
    sd = sum_dtype or dt_

    def dot(a, c):
        dims = tuple(range(1, a.ndim))
        if sd == dt_:
            return torch.sum(a * c, dim=dims, keepdim=True)
        return torch.sum(a * c, dim=dims, keepdim=True, dtype=sd).to(dt_)

    def linf(a):
        return torch.amax(torch.abs(a), dim=tuple(range(1, a.ndim)),
                          keepdim=True)

    return dot, linf, torch.zeros_like, torch.where


def _member_flags(*masks) -> np.ndarray:
    """For each of ``masks`` (member masks, [B, ...] whole or split
    ``Blocks`` along the members) whether any member's entry is set, as
    host bools in one ``pull``. Split masks are joined first: each shard's
    [k, B/D] stack, one all-gather in member order under a world (copies
    onto the home device on one process), so every rank reads the same
    bits and takes the same host branch."""
    first = next((m for m in masks if isinstance(m, Blocks)), None)
    if first is None:
        flags = torch.stack([m.any() for m in masks])
    else:
        parts = [torch.stack([m.parts[i].reshape(-1) for m in masks])
                 for i in range(len(first.parts))]
        flags = torch.cat(all_shards(parts, first.mesh, kind="reductions"),
                          dim=1).any(dim=1)
    return pull(flags)[0].astype(bool)


def _reducers(dt_, sum_dtype):
    """(dot, linf, zeros_like) of whole fields; dot products accumulate in
    ``sum_dtype`` (default the field dtype). They run as the member form
    on a one-member view, so that a one-member fleet sums in the order of
    the solo solve on every device. The split-field counterpart is
    ``parallel.shard_halo.slab_reducers``."""
    mdot, mlinf, _, _ = _member_reducers(dt_, sum_dtype)

    def dot(a, c):
        return mdot(a.unsqueeze(0), c.unsqueeze(0)).reshape(())

    def linf(a):
        return mlinf(a.unsqueeze(0)).reshape(())

    return dot, linf, torch.zeros_like


def bicgstab(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    M: Callable[[torch.Tensor], torch.Tensor] | None = None,
    x0: torch.Tensor | None = None,
    tol: float = 1e-3,
    tol_rel: float = 1e-2,
    max_iter: int = 1000,
    max_restarts: int = 0,
    sum_dtype=None,
    refresh_every: int = 50,
    stall_iters: int = 120,
    stall_rtol: float = 0.999,
    reducers=_reducers,
    member_axis: bool = False,
) -> BiCGSTABResult:
    """Preconditioned flexible BiCGSTAB (reference cuda.cu:403-548).

    Converges on Linf(r) <= max(tol, tol_rel * Linf(r0)). Inner products
    accumulate in ``sum_dtype`` (default: b's dtype). A serious breakdown
    restarts with rhat = r while ``max_restarts`` lasts; every
    ``refresh_every`` iterations since the last restart the recursive
    residual is replaced by the true residual of the current iterate
    (re-grounding the best-iterate tracking too), and the L2 norm sampled
    at those refreshes drives the stall exit: no ``stall_rtol`` gain for
    ``stall_iters`` iterations ends the solve with the best iterate.
    ``reducers(dtype, sum_dtype)`` gives (dot, linf, zeros_like): the
    whole-field ones, or ``shard_halo.slab_reducers`` for split fields;
    with ``member_axis`` it gives the member forms (dot, linf, zeros_like,
    where): ``_member_reducers`` by default, or
    ``shard_halo.slab_member_reducers`` for split member stacks.

    ``member_axis`` (the fleet, ``fleet.FleetSim``): b [B, Ny, Nx] holds B
    independent systems solved in one loop. Every reduction is per member,
    each decision a [B] mask on the device, and the loop runs while any
    member is unconverged; a converged member's whole iteration state is
    frozen (``torch.where``), so the sweeps run for the slowest member are
    bit-exact identity for it. One stacked flag read an iteration; the
    true-residual refresh's operator applications run only when a member
    asks for one. ``iters``, ``residual``, ``converged`` and ``stalled``
    come back as [B] device tensors. One member gives the solo solve's
    iterate bit for bit."""
    tracing.note_component("poisson.bicgstab")
    if M is None:
        M = lambda v: v  # noqa: E731
    if member_axis:
        return _bicgstab_members(
            A, b, M, x0, tol, tol_rel, max_iter, max_restarts, sum_dtype,
            refresh_every, stall_iters, stall_rtol,
            _member_reducers if reducers is _reducers else reducers)
    dt_ = b.dtype
    dot, linf, zeros_like = reducers(dt_, sum_dtype)

    if x0 is None:
        # A(0) = 0: the initial residual is b
        x = zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    norm0 = linf(r)
    target = torch.maximum(torch.tensor(tol, dtype=dt_, device=b.device),
                           tol_rel * norm0)
    one = torch.ones_like(norm0)
    rhat = r
    p = zeros_like(b)
    v = zeros_like(b)
    rho = alpha = omega = one
    x_opt, norm_opt = x, norm0
    best_l2 = torch.sqrt(dot(r, r))
    it = restarts = best_it = impr_it = 0
    done = bool(pull(norm0 <= target)[0])
    eps = torch.tensor(1e-21 if dt_ == torch.float64 else 1e-30, dtype=dt_,
                       device=b.device)

    while not done and it < max_iter:
        rho_probe = dot(rhat, r)
        norm_r = torch.sqrt(dot(r, r))
        norm_rhat = torch.sqrt(dot(rhat, rhat))
        can_restart = restarts < max_restarts
        refresh = (it - best_it) >= refresh_every
        # a serious breakdown restarts with rhat = r (cuda.cu:457-477);
        # it matters only where it can restart or give up
        breakdown = (can_restart or not refresh) and bool(pull(
            torch.abs(rho_probe) < (1e-16 * norm_r * norm_rhat + eps))[0])
        do_restart = (breakdown and can_restart) or refresh
        give_up = breakdown and not can_restart and not refresh

        if refresh:
            r = b - A(x)
            n_true = linf(r)
            n_opt_true = linf(b - A(x_opt))
            if bool(pull(n_true <= n_opt_true)[0]):
                x_opt, norm_opt = x, n_true
            else:
                norm_opt = n_opt_true
        if do_restart:
            rhat = r
            rho_new = dot(rhat, r)
            beta = torch.zeros_like(rho_new)
        else:
            rho_new = rho_probe
            beta = (rho_new / (rho + eps)) * (alpha / (omega + eps))
        p = r + beta * (p - omega * v)
        z = M(p)
        v = A(z)
        alpha = rho_new / (dot(rhat, v) + eps)
        h = x + alpha * z
        sres = r - alpha * v
        zs = M(sres)
        t = A(zs)
        omega = dot(t, sres) / (dot(t, t) + eps)
        x = h + omega * zs
        r = sres - omega * t
        rho = rho_new

        norm = linf(r)
        l2_now = torch.sqrt(dot(r, r))
        (flags,) = pull(torch.stack([norm < norm_opt, norm <= target,
                                     l2_now < stall_rtol * best_l2]))
        better, reached, gain = (bool(f) for f in flags)
        if better:
            x_opt, norm_opt = x, norm
        if refresh:
            if gain:
                impr_it = it
            best_l2 = torch.minimum(best_l2, l2_now)
        if breakdown and can_restart:
            restarts += 1
        if do_restart:
            best_it = it
        stalled = (it - impr_it) >= stall_iters
        done = reached or give_up or stalled
        it += 1

    # one read: the comparisons of the f32/f64 scalars are exact on the
    # host in float64
    final_norm, norm_opt, target = (float(v) for v in pull(
        linf(r), norm_opt, target))
    use_x = final_norm <= norm_opt
    residual = final_norm if use_x else norm_opt
    converged = residual <= target
    stalled = not converged and (it - impr_it) >= stall_iters
    return BiCGSTABResult(x=x if use_x else x_opt, iters=it,
                          residual=residual, converged=converged,
                          stalled=stalled)


def _bicgstab_members(A, b, M, x0, tol, tol_rel, max_iter, max_restarts,
                      sum_dtype, refresh_every, stall_iters, stall_rtol,
                      reducers=_member_reducers):
    """``bicgstab(member_axis=True)``: the JAX package's member-masked
    loop body, with its ``lax.cond`` on "any member refreshes" as the one
    host branch. The counters are per-member device tensors; the host
    keeps the loop counter and reads, once an iteration, whether any
    member is still running and whether any refreshes next."""
    dt_ = b.dtype
    dot, linf, zeros_like, where = reducers(dt_, sum_dtype)
    if x0 is None:
        x = zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    norm0 = linf(r)
    target = torch.maximum(torch.tensor(tol, dtype=dt_, device=b.device),
                           tol_rel * norm0)
    one = torch.ones_like(norm0)
    zi = torch.zeros(norm0.shape, dtype=torch.int64, device=b.device)
    eps = torch.tensor(1e-21 if dt_ == torch.float64 else 1e-30, dtype=dt_,
                       device=b.device)
    rhat = r
    p = zeros_like(b)
    v = zeros_like(b)
    rho = alpha = omega = one
    x_opt, norm_opt = x, norm0
    best_l2 = torch.sqrt(dot(r, r))
    restarts = best_it = impr_it = it_m = zi
    done = norm0 <= target
    it = 0
    running = bool(_member_flags(~done)[0])
    any_refresh = False      # it - best_it = 0 < refresh_every at it = 0

    def keep(frozen, old, new):
        return where(frozen, old, new)

    while running and it < max_iter:
        frozen = done
        rho_probe = dot(rhat, r)
        norm_r = torch.sqrt(dot(r, r))
        norm_rhat = torch.sqrt(dot(rhat, rhat))
        breakdown = torch.abs(rho_probe) < (1e-16 * norm_r * norm_rhat + eps)
        can_restart = restarts < max_restarts
        # a frozen member's refresh is masked: its state is discarded
        refresh = ((it - best_it) >= refresh_every) & ~frozen
        do_restart = (breakdown & can_restart) | refresh
        give_up = breakdown & ~can_restart & ~refresh
        r0, x_opt0, norm_opt0 = r, x_opt, norm_opt
        if any_refresh:
            r_t = b - A(x)
            n_true = linf(r_t)
            n_opt_true = linf(b - A(x_opt))
            take_x = n_true <= n_opt_true
            r0 = where(refresh, r_t, r)
            x_opt0 = where(refresh, where(take_x, x, x_opt), x_opt)
            norm_opt0 = torch.where(
                refresh, torch.where(take_x, n_true, n_opt_true), norm_opt)
        rhat_n = where(do_restart, r0, rhat)
        rho_n = torch.where(do_restart, dot(rhat_n, r0), rho_probe)
        beta = torch.where(do_restart, torch.zeros_like(rho_n),
                           (rho_n / (rho + eps)) * (alpha / (omega + eps)))
        p_n = r0 + beta * (p - omega * v)
        z = M(p_n)
        v_n = A(z)
        alpha_n = rho_n / (dot(rhat_n, v_n) + eps)
        hh = x + alpha_n * z
        sres = r0 - alpha_n * v_n
        zs = M(sres)
        t = A(zs)
        omega_n = dot(t, sres) / (dot(t, t) + eps)
        x_n = hh + omega_n * zs
        r_n = sres - omega_n * t
        norm = linf(r_n)
        better = norm < norm_opt0
        x_opt_n = where(better, x_n, x_opt0)
        norm_opt_n = torch.where(better, norm, norm_opt0)
        l2_now = torch.sqrt(dot(r_n, r_n))
        improved = refresh & (l2_now < stall_rtol * best_l2)
        best_l2_n = torch.where(refresh, torch.minimum(best_l2, l2_now),
                                best_l2)
        impr_it_n = torch.where(improved, it, impr_it)
        stalled = (it - impr_it_n) >= stall_iters
        done_n = (norm <= target) | give_up | stalled
        restarts_n = restarts + (breakdown & can_restart).to(torch.int64)
        best_it_n = torch.where(do_restart, it, best_it)
        # a member converged at loop entry keeps its whole state
        x, r = keep(frozen, x, x_n), keep(frozen, r, r_n)
        rhat, p, v = (keep(frozen, rhat, rhat_n), keep(frozen, p, p_n),
                      keep(frozen, v, v_n))
        rho, alpha, omega = (keep(frozen, rho, rho_n),
                             keep(frozen, alpha, alpha_n),
                             keep(frozen, omega, omega_n))
        restarts = keep(frozen, restarts, restarts_n)
        x_opt = keep(frozen, x_opt, x_opt_n)
        norm_opt = keep(frozen, norm_opt, norm_opt_n)
        best_it = keep(frozen, best_it, best_it_n)
        best_l2 = keep(frozen, best_l2, best_l2_n)
        impr_it = keep(frozen, impr_it, impr_it_n)
        it_m = keep(frozen, it_m, it_m + 1)
        done = frozen | done_n
        it += 1
        running, any_refresh = (bool(f) for f in _member_flags(
            ~done, ((it - best_it) >= refresh_every) & ~done))

    final_norm = linf(r)
    use_x = final_norm <= norm_opt
    converged = torch.minimum(final_norm, norm_opt) <= target
    # stall classification against the member's own counter: the loop
    # counter runs on after a member froze
    stalled = ~converged & ((it_m - impr_it) >= stall_iters)
    return BiCGSTABResult(
        x=where(use_x, x, x_opt),
        iters=it_m.reshape(-1).to(torch.int32),
        residual=torch.where(use_x, final_norm, norm_opt).reshape(-1),
        converged=converged.reshape(-1), stalled=stalled.reshape(-1))


def mg_solve(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    mg: MultigridPreconditioner,
    x0: torch.Tensor | None = None,
    tol: float = 1e-3,
    tol_rel: float = 1e-2,
    max_cycles: int = 50,
    stall_cycles: int = 4,
    stall_rtol: float = 0.999,
    fmg: bool = False,
    reducers=_reducers,
    member_axis: bool = False,
) -> BiCGSTABResult:
    """Solve A x = b by repeated multigrid cycles x += mg(b - A x) with the
    true residual each cycle; same result contract and criterion as
    ``bicgstab``, ``iters`` counting cycles. ``fmg`` opens with one
    F-cycle (counted). ``stall_cycles`` consecutive cycles without a
    ``stall_rtol`` gain over the running best end the solve ``stalled``.
    ``reducers`` as in ``bicgstab`` (the member forms with
    ``member_axis``). ``member_axis``: b [B, Ny, Nx], B
    systems in one cycle loop (the cycle takes the leading axis), a
    converged member frozen by ``torch.where`` while the loop runs for the
    others, one flag read a cycle, and [B] device results, as in
    ``bicgstab``."""
    tracing.note_component("poisson.mg_solve")
    if member_axis:
        return _mg_solve_members(
            A, b, mg, x0, tol, tol_rel, max_cycles, stall_cycles, stall_rtol,
            fmg, _member_reducers if reducers is _reducers else reducers)
    _, linf, zeros_like = reducers(b.dtype, None)
    if x0 is None:
        x = zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    norm0 = linf(r)
    target = torch.maximum(
        torch.tensor(tol, dtype=b.dtype, device=b.device), tol_rel * norm0)
    it = 0
    if fmg:
        x = x + mg.fcycle(r)
        r = b - A(x)
        it = 1
    norm = linf(r)
    best = norm
    no_impr = 0
    done = bool(pull(norm <= target)[0])
    while not done and it < max_cycles:
        x = x + mg(r)
        r = b - A(x)
        norm = linf(r)
        (flags,) = pull(torch.stack([norm < stall_rtol * best,
                                     norm <= target]))
        improved, reached = (bool(f) for f in flags)
        best = torch.minimum(best, norm)
        no_impr = 0 if improved else no_impr + 1
        done = reached or no_impr >= stall_cycles
        it += 1
    norm, target = (float(v) for v in pull(norm, target))
    converged = norm <= target
    return BiCGSTABResult(x=x, iters=it, residual=norm,
                          converged=converged,
                          stalled=not converged and no_impr >= stall_cycles)


def _mg_solve_members(A, b, mg, x0, tol, tol_rel, max_cycles, stall_cycles,
                      stall_rtol, fmg, reducers=_member_reducers):
    """``mg_solve(member_axis=True)``, the JAX package's member-masked
    cycle loop."""
    _, linf, zeros_like, where = reducers(b.dtype, None)
    if x0 is None:
        x = zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)
    norm0 = linf(r)
    target = torch.maximum(
        torch.tensor(tol, dtype=b.dtype, device=b.device), tol_rel * norm0)
    it_m = torch.zeros(norm0.shape, dtype=torch.int64, device=b.device)
    it = 0
    if fmg:
        x = x + mg.fcycle(r)
        r = b - A(x)
        it, it_m = 1, it_m + 1
    norm = linf(r)
    best = norm
    no_impr = torch.zeros_like(it_m)
    done = norm <= target
    running = bool(_member_flags(~done)[0])
    while running and it < max_cycles:
        frozen = done
        x_n = x + mg(r)
        r_n = b - A(x_n)
        norm_n = linf(r_n)
        improved = norm_n < stall_rtol * best
        best_n = torch.minimum(best, norm_n)
        no_impr_n = torch.where(improved, torch.zeros_like(no_impr),
                                no_impr + 1)
        done_n = (norm_n <= target) | (no_impr_n >= stall_cycles)
        x = where(frozen, x, x_n)
        r = where(frozen, r, r_n)
        norm = torch.where(frozen, norm, norm_n)
        best = torch.where(frozen, best, best_n)
        no_impr = torch.where(frozen, no_impr, no_impr_n)
        it_m = torch.where(frozen, it_m, it_m + 1)
        done = frozen | done_n
        it += 1
        running = bool(_member_flags(~done)[0])
    converged = norm <= target
    stalled = ~converged & (no_impr >= stall_cycles)
    return BiCGSTABResult(x=x, iters=it_m.reshape(-1).to(torch.int32),
                          residual=norm.reshape(-1),
                          converged=converged.reshape(-1),
                          stalled=stalled.reshape(-1))


# ---------------------------------------------------------------------------
# The FFT-diagonalized direct solve (CUP2D_POIS=fftd)
# ---------------------------------------------------------------------------

class FFTDiagPlan:
    """Host-precomputed plan of the FFT-diagonalized direct solve of the
    undivided per-face Laplacian of a table with a periodic axis (the JAX
    package's ``FFTDiagPlan``): the real FFT along a periodic axis turns
    its wrap second difference into the per-mode eigenvalues
    lam(k) = 2 cos(2 pi k / n) - 2.

    * ``px and py`` (the doubly-periodic box): 2-D real FFT, pointwise
      divide by lam_y(m) + lam_x(k), inverse FFT; the (0, 0) mode is pinned
      to 0, so the solution is exactly mean-free.
    * one periodic axis: the real FFT along it, then per mode a
      tridiagonal system along the wall axis (unit off-diagonals, diagonal
      lam(k) - 2 plus the wall sign on the edge rows), solved by the
      Thomas algorithm as two first-order scans batched over modes and
      members (``hopper_kernels.tridiag_scan``). The elimination
      coefficients depend on the fixed diagonal alone and are computed
      here in f64 numpy. A table periodic in y only runs as the transposed
      x-periodic problem. With Neumann walls on both sides the k = 0 mode
      is singular: its right-hand side is made mean-free and row 0 pinned
      to x = 0, which solves the original system exactly for a mean-free
      right-hand side; a Dirichlet wall needs no pin.

    The transforms are whole-array along their axes, so there is no split
    form (``UniformGrid.attach_mesh`` refuses fftd)."""

    def __init__(self, ny: int, nx: int, dtype, px: bool, py: bool,
                 edge_signs, device=None):
        if not (px or py):
            raise ValueError(
                "FFTDiagPlan needs at least one periodic direction (got "
                "px=False, py=False): with walls on all four faces there "
                "is nothing to diagonalize; use bicgstab/mg_solve")
        self.ny, self.nx = ny, nx
        self.px, self.py = bool(px), bool(py)
        self.dtype = dtype

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)
        sx_lo, sx_hi, sy_lo, sy_hi = edge_signs
        if px and py:
            lx = 2.0 * np.cos(2.0 * np.pi * np.arange(nx // 2 + 1) / nx) - 2.0
            ly = 2.0 * np.cos(2.0 * np.pi * np.arange(ny) / ny) - 2.0
            lam = ly[:, None] + lx[None, :]
            mask = lam < -1e-12
            self.ilam = dev(np.where(mask, 1.0 / np.where(mask, lam, 1.0),
                                     0.0))
            self.pin = True     # the zeroed (0, 0) mode is the pin
            return
        if px:
            n_t, n_s, s_lo, s_hi = nx, ny, sy_lo, sy_hi
        else:
            n_t, n_s, s_lo, s_hi = ny, nx, sx_lo, sx_hi
        nk = n_t // 2 + 1
        lam = 2.0 * np.cos(2.0 * np.pi * np.arange(nk) / n_t) - 2.0
        d = np.tile(lam[None, :], (n_s, 1)) - 2.0
        d[0, :] += s_lo
        d[-1, :] += s_hi
        c = np.ones((n_s, nk))
        c[-1, :] = 0.0
        self.pin = s_lo == 1.0 and s_hi == 1.0
        if self.pin:
            # the singular k = 0 all-Neumann mode: row 0 -> identity
            d[0, 0] = 1.0
            c[0, 0] = 0.0
        # forward elimination on the fixed matrix (unit subdiagonal):
        # denom_j = d_j - cp_{j-1}, cp_j = c_j / denom_j
        denom = np.empty((n_s, nk))
        cp = np.empty((n_s, nk))
        denom[0] = d[0]
        cp[0] = c[0] / denom[0]
        for j in range(1, n_s):
            denom[j] = d[j] - cp[j - 1]
            cp[j] = c[j] / denom[j]
        self.cp = dev(cp)
        self.inv_denom = dev(1.0 / denom)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Direct solve of lap(x) = b (the undivided per-face operator);
        leading axes (members) ride the same transforms."""
        if self.px and self.py:
            F = torch.fft.rfft2(b)
            x = torch.fft.irfft2(F * self.ilam, s=(self.ny, self.nx))
            return x.to(b.dtype)
        swap = not self.px       # py only: the transposed px-only problem
        if swap:
            b = b.transpose(-1, -2)
        n_t = b.shape[-1]
        bh = torch.fft.rfft(b, dim=-1)           # [..., n_s, nk]
        if self.pin:
            # mean-free k = 0 column, then pin its row 0
            col0 = bh[..., :, 0]
            bh[..., :, 0] = col0 - torch.mean(col0, dim=-1, keepdim=True)
            bh[..., 0, 0] = 0.0
        lead, (n_s, nk) = bh.shape[:-2], bh.shape[-2:]
        xt = tridiag_scan(bh.reshape(-1, n_s, nk).contiguous(),
                          self.inv_denom, self.cp)
        x = torch.fft.irfft(xt.reshape(*lead, n_s, nk), n=n_t, dim=-1)
        if swap:
            x = x.transpose(-1, -2).contiguous()
        return x.to(b.dtype)


def fft_diag_solve(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    plan: FFTDiagPlan,
    tol: float = 1e-3,
    tol_rel: float = 1e-2,
    member_axis: bool = False,
) -> BiCGSTABResult:
    """One direct solve with the iterative solvers' result contract:
    ``x`` from ``plan.solve``, ``residual`` the true Linf residual of that
    x, ``converged`` against their criterion Linf(r) <= max(tol, tol_rel *
    Linf(b)), ``iters`` 1, ``stalled`` = not converged (a tol-0 exact
    request reports the direct solve's precision floor there, as
    ``bicgstab``'s stall exit does). ``member_axis``: b [B, Ny, Nx] holds
    B independent systems solved through one transform; iters, residual,
    converged and stalled are then [B] tensors."""
    tracing.note_component("poisson.fft_diag_solve")
    x = plan.solve(b)
    r = b - A(x)
    if member_axis:
        dims = tuple(range(1, b.ndim))
        residual = torch.amax(torch.abs(r), dim=dims)
        bnorm = torch.amax(torch.abs(b), dim=dims)
    else:
        residual = torch.amax(torch.abs(r))
        bnorm = torch.amax(torch.abs(b))
    target = torch.maximum(torch.tensor(tol, dtype=b.dtype, device=b.device),
                           tol_rel * bnorm)
    converged = residual <= target
    if member_axis:
        return BiCGSTABResult(
            x=x, iters=torch.ones_like(converged, dtype=torch.int32),
            residual=residual, converged=converged, stalled=~converged)
    residual, target = (float(v) for v in pull(residual, target))
    ok = residual <= target
    return BiCGSTABResult(x=x, iters=1, residual=residual,
                          converged=ok, stalled=not ok)


# ---------------------------------------------------------------------------
# The spectral base solve and the forest-native FAS hierarchy
# ---------------------------------------------------------------------------

def dct_neumann_operators(ncy: int, ncx: int, dtype=np.float32):
    """Host operators of the matmul form of the exact Neumann solve:
    DCT-II basis matrices (forward, and the exact inverse from the
    orthogonality weights) and the reciprocal eigenvalue grid with the
    constant nullspace mode zeroed. The basis is cos(pi k (i+0.5)/n) with
    eigenvalues 2cos(pi k/n) - 2 per axis."""
    def fwd(n):
        k = np.arange(n)[:, None]
        i = np.arange(n)[None, :]
        return np.cos(np.pi * k * (i + 0.5) / n)

    cyf = fwd(ncy)
    cxf = fwd(ncx)
    # exact inverse from DCT-II row orthogonality: row norms are n (k=0)
    # and n/2 (k>0)
    wy = np.full(ncy, 2.0 / ncy)
    wy[0] = 1.0 / ncy
    wx = np.full(ncx, 2.0 / ncx)
    wx[0] = 1.0 / ncx
    cyi = (cyf * wy[:, None]).T
    cxi = (cxf * wx[:, None]).T
    ky = 2.0 * np.cos(np.pi * np.arange(ncy) / ncy) - 2.0
    kx = 2.0 * np.cos(np.pi * np.arange(ncx) / ncx) - 2.0
    lam = ky[:, None] + kx[None, :]
    ilam = np.where(lam < -1e-12, 1.0 / np.where(lam < -1e-12, lam, 1.0),
                    0.0)
    return (cyf.astype(dtype), cyi.astype(dtype),
            cxf.astype(dtype), cxi.astype(dtype), ilam.astype(dtype))


def coarse_neumann_solve_dct(rc: torch.Tensor, ops, h2) -> torch.Tensor:
    """Exact solve of the undivided 5-point Neumann Laplacian as 4
    matmuls (see dct_neumann_operators), returning e * h2 with the
    constant mode projected out. The products run in full f32 on the
    card (TF32 off, set by ``AMRSim``): a truncated pass would corrupt the
    cosine bases."""
    cyf, cyi, cxf, cxi, ilam = ops
    F = (cyf @ rc) @ cxf.T
    return h2 * ((cyi @ (F * ilam)) @ cxi.T)


def _up2_bilinear(a: torch.Tensor) -> torch.Tensor:
    """Cell-centred 2x bilinear upsample of a [H, W] image with edge
    clamp: fine centres sit at quarter offsets, so the separable weights
    are (3/4, 1/4)."""
    def up1(v):
        vm = torch.cat([v[:1], v[:-1]], dim=0)
        vp = torch.cat([v[1:], v[-1:]], dim=0)
        even = 0.75 * v + 0.25 * vm
        odd = 0.75 * v + 0.25 * vp
        return torch.stack([even, odd], dim=1).reshape(
            2 * v.shape[0], *v.shape[1:])
    return up1(up1(a).T).T


def _down2_mean(a: torch.Tensor) -> torch.Tensor:
    """2x2 mean coarsening of a [H, W] image (each fine cell carries
    weight 1/4)."""
    rows = a[0::2, :] + a[1::2, :]
    return 0.25 * (rows[:, 0::2] + rows[:, 1::2])


def _img_lap_neumann(a: torch.Tensor) -> torch.Tensor:
    """Undivided 5-point Laplacian of a [H, W] image with zero-gradient
    (edge-replicate) ghosts: a window edge is a domain wall or a
    refinement interface, where zero-gradient extrapolation suits the
    smooth error the coarser rungs carry."""
    p = torch.nn.functional.pad(a[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    return (p[2:, 1:-1] + p[:-2, 1:-1]
            + p[1:-1, 2:] + p[1:-1, :-2]) - 4.0 * a


class ForestFASCycle:
    """One multigrid cycle over the composite forest's own refinement
    levels: the ``mg`` object of ``mg_solve`` for the forest's
    ``CUP2D_POIS=fas|fas-f`` production solve (a linear problem, so FAS
    reduces to the correction scheme).

    Levels, finest first: the composite level (all active blocks at
    their own resolution, damped block-Jacobi through ``smooth_blocks``);
    one window image per forest level above the coarse level c (painted
    by ``paint_fine``, smoothed by damped Jacobi on ``_img_lap_neumann``,
    walked by 2x sum / bilinear steps); the uniform base level c, solved
    exactly by the DCT-II solve (``base_solve``). The transfer closures
    come from ``AMRSim._fas_transfers``. ``__call__`` runs a V-cycle
    (block pre-smooth first); ``fcycle`` opens base level first (no
    pre-smooth) for cold right-hand sides.

    ``leg_dtype`` (bf16 under ``CUP2D_PREC=bf16``; the JAX package's
    ``ForestFASCycle``, ``cup2d_tpu/poisson.py:1153-1230``) is the storage
    dtype of the window-image ladder legs only: one downcast per painted
    level, the V-down and V-up smooths, restrictions and prolongations in
    it, the restricted RHS cast back up at the door of the base solve
    (which stays at solver precision), and the level errors cast back up
    before ``extract_all``. The composite block smooth and ``mg_solve``'s
    true residual stay at solver precision. None: every leg at solver
    precision."""

    def __init__(self, A, smooth_blocks, paint_fine, base_solve,
                 extract_all, cih2, nu_img: int = 2,
                 omega: float = 0.8, nu_pre: int = 1, nu_post: int = 1,
                 leg_dtype=None):
        self.A = A
        self.smooth_blocks = smooth_blocks
        self.paint_fine = paint_fine
        self.base_solve = base_solve
        self.extract_all = extract_all
        self.cih2 = cih2
        self.nu_img = nu_img
        self.omega = omega
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.leg_dtype = leg_dtype

    def _img_smooth(self, e, r, n: int, from_zero: bool = False):
        # damped Jacobi on the Neumann-ghost window image; interior
        # diagonal of the undivided 5-point operator is -4
        if from_zero and n > 0:
            e = (-0.25 * self.omega) * r
            n -= 1
        for _ in range(n):
            e = e - 0.25 * self.omega * (r - _img_lap_neumann(e))
        return e

    def _cycle(self, r, pre: bool):
        if pre:
            e = self.smooth_blocks(None, r, self.nu_pre, from_zero=True)
            r1 = r - self.A(e)
        else:
            e = None
            r1 = r
        rdiv = r1 * self.cih2            # divided residual per block
        rimgs = self.paint_fine(rdiv)    # finest -> c+1, undivided
        legs = self.leg_dtype
        if legs is not None:
            rimgs = [R.to(legs) for R in rimgs]
        # V-down over the window-image levels: smooth, restrict the
        # smoothed residual one ladder step, fold in the next level's
        # own deposit (undivided restriction = sum of 4)
        es, accs = [], []
        racc = None
        for R in rimgs:
            racc = R if racc is None else R + racc
            accs.append(racc)
            el = self._img_smooth(None, racc, self.nu_img, from_zero=True)
            es.append(el)
            res = racc - _img_lap_neumann(el)
            rows = res[0::2, :] + res[1::2, :]
            racc = rows[:, 0::2] + rows[:, 1::2]
        # exact spectral base solve (folds the <= c deposits of rdiv in);
        # awin = the window slice of the base correction
        if legs is not None and racc is not None:
            racc = racc.to(rdiv.dtype)
        ec, awin = self.base_solve(rdiv, racc)
        # V-up: prolongate, add the stored level error, post-smooth
        # against the stored accumulated RHS
        if legs is not None and rimgs:
            awin = awin.to(legs)
        for i in range(len(rimgs) - 1, -1, -1):
            a = _up2_bilinear(awin) + es[i]
            awin = self._img_smooth(a, accs[i], self.nu_img)
            es[i] = awin
        if legs is not None:
            es = [el.to(rdiv.dtype) for el in es]
        corr = self.extract_all(ec, es)
        e = corr if e is None else e + corr
        return self.smooth_blocks(e, r, self.nu_post)

    def __call__(self, r):
        return self._cycle(r, pre=True)

    def fcycle(self, r):
        # coarse-first opening for cold right-hand sides (fas-f)
        return self._cycle(r, pre=False)


def project_correct(x, pres_old, vel, h, dt, remove_mean=True,
                    grad_signs=None, periodic=None, mean_axes=None):
    """Projection epilogue: ``pres = (x - mean x) + pres_old - mean
    pres_old`` and ``vel += -dt/(2h) grad_neumann(pres) / h^2``, the means
    taken here (accumulated in f64, so that their f32 value does not hang
    on the summation order: the x-split step's per-shard partials give the
    same) and the rest in ``fused_correction``. ``remove_mean=False`` (a
    table with an outflow face: its Dirichlet row fixes the level) passes
    zero means; ``grad_signs`` is the table's pressure signs (None: the
    Neumann gradient); ``periodic`` its (px, py) (bc.periodic_axes; None:
    no periodic axis), along which the gradient wraps (the correction
    kernel's wrap form, which reads those axes from the signs' (0, 0)
    pairs: a ``periodic`` that disagrees with them refuses). x, pres_old
    [..., Ny, Nx]; vel [..., 2, Ny, Nx]; dt a scalar. ``mean_axes=(-2,
    -1)`` (the fleet): x, pres_old [B, Ny, Nx], the means per member and
    dt a scalar or a [B] row, so the kernel takes one ``scal`` row a
    member. The whole-field means run as one member's, so a one-member
    fleet takes the solo epilogue's means. Returns (vel, pres)."""
    paxes = (False, False) if grad_signs is None else _wrap_axes(
        _signs(grad_signs))
    if tuple(map(bool, periodic or (False, False))) != paxes:
        raise ValueError(f"project_correct: periodic {periodic} with signs "
                         f"{grad_signs}: a periodic axis has the signs "
                         "(0, 0), a wall axis +1 or -1")
    if mean_axes is not None and tuple(mean_axes) != (-2, -1):
        raise ValueError(f"project_correct: mean_axes {mean_axes}: expected "
                         "None (whole field) or (-2, -1) (per member)")
    ny, nx = x.shape[-2:]
    L = math.prod(x.shape[:-2])
    rows = L if mean_axes is not None else 1
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)

    def mean(a):
        if not remove_mean:
            return torch.zeros(rows, dtype=a.dtype, device=a.device)
        return torch.mean(a.reshape(rows, -1, nx), dim=(-2, -1),
                          dtype=torch.float64).to(a.dtype)

    pfac = (-0.5 * dt * h).broadcast_to((rows,))
    scal = torch.stack([mean(x), mean(pres_old), pfac], dim=-1)
    scal = scal.expand(L, 3).contiguous()
    pres, velc = fused_correction(
        x.reshape(L, ny, nx), pres_old.reshape(L, ny, nx),
        vel.reshape(L, 2, ny, nx), scal, 1.0 / (h * h), grad_signs)
    return velc.reshape(vel.shape), pres.reshape(x.shape)
