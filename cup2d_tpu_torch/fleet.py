"""Fleets and the serving pool, the counterpart of ``cup2d_tpu.fleet``.

``FleetSim`` advances B independent obstacle-free uniform cases in one
member-batched step:

- the state is one ``FlowState`` with a leading member axis [B, ...];
  the substage pair (``hopper_kernels.fused_advect_heun``), the
  correction epilogue (``poisson.project_correct(mean_axes=(-2, -1))``)
  and, under fas, the sweep chains (``fused_jacobi_sweeps``) launch once
  for all members, each with a dt per member;
- each member runs at its own dt: a [B] device row chained from each
  member's end-state umax, the clocks in ``times`` (host, float64),
  settled through the step's one stacked diagnostic read;
- the members' pressure solves run in one loop
  (``poisson.bicgstab``/``mg_solve(member_axis=True)``, or one batched
  ``fft_diag_solve``), a converged member frozen while the others go on;
- supervision is per member (``resilience.FleetStepGuard``): a bad member
  restores only its slice of the snapshot ring and replays solo through
  ``member_step_once``; the healthy members never rewind.

With B = 1 a ``FleetSim`` is a ``UniformSim`` bit for bit (the solvers'
whole-field reductions run as one member's, ``poisson._reducers``), with
no more device reads a step. With B > 1 each member follows its solo run
to rounding: the per-member reductions may sum in another order than the
whole-field ones on a many-threaded CPU or on the card.

``FleetServer`` serves client sessions (``FleetRequest``) through the
fixed-B pool: a per-slot active mask (``FleetSim.set_active``: dead slots
ride the step select-frozen), admission from a state or a session
checkpoint (``io.save_member_checkpoint``), retirement at each session's
horizon with its checkpoint, eviction by the guard's per-member ladder,
and the schema-v7 gauges. Slot writes build new fleet tensors
(``index_copy``), so no snapshot or caller ever sees a slot change under
it, and build no kernel: churn costs no kernel build.

A fleet places itself on a slab mesh (``mesh=``, ``placement=``,
``member_cells_cap=``) by the JAX package's policy: whole members along
the mesh (``"member"``: ``shard_halo.Blocks`` along the member axis, the
kernels launched once a device for its B/D members) or every member split
along x (``"spatial"``: ``shard_halo.Slabs``, the x-split step with the
member axis riding the halo kernels). Checkpoints, dumps and session
checkpoints keep the global layout, so a placed fleet restarts unplaced
and the other way round; the guard and the server drive a placed fleet
through its member accessors, its solo member steps on the member's own
device (or split, on spatial placement).

A mesh over a ``torch.distributed`` world (``parallel.launch.world_mesh``)
places the fleet across processes. Every rank runs the same host schedule
and enters every collective in one global order: a rank builds, places and
steps only its own shards' members (member placement) or its own x slabs
of every member (spatial); the per-member reductions combine their shard
partials in shard order through ``shard_halo.all_shards``, so every rank
holds the same bits and the fleet is the one-process placed fleet bit for
bit. A member's slice (``member_state``) is one all-gather of each shard's
slot at the member's local index, whole on every rank; a slot write
(``set_member_state``, ``admit_member``) changes the owning rank's shard
only. The host state (clocks, mask, dt row, counters) is the same on every
rank.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import tracing
from .config import SimConfig
from .ops.hopper_kernels import fused_advect_heun
from .parallel.shard_halo import (Blocks, Slabs, _part_of, _wrap,
                                  all_shards, canonical_device,
                                  gather_blocks,
                                  project_correct_x, slab_member_finite,
                                  slab_member_reducers, slab_member_sum,
                                  split_blocks, split_x)
from .poisson import (BiCGSTABResult, bicgstab, fft_diag_solve, mg_solve,
                      project_correct)
from .profiling import NULL_TIMERS
from .shapes_host import pull
from .uniform import (FlowState, UniformGrid, check_card_f64,
                      taylor_green_state)

__all__ = ["FleetRequest", "FleetServer", "FleetSim", "FlowState",
           "stack_states", "taylor_green_fleet"]


def stack_states(states) -> FlowState:
    """Stack per-member FlowStates into one fleet state [B, ...]."""
    return FlowState(*(torch.stack(list(leaves))
                       for leaves in zip(*states)))


def taylor_green_fleet(grid, members: int, amp0: float = 1.0,
                       decay: float = 0.8) -> FlowState:
    """B Taylor-Green vortices at geometrically decaying amplitudes
    (member m scaled by ``amp0 * decay**m``): each member has its own umax
    and so its own CFL dt."""
    base = taylor_green_state(grid)
    return stack_states([
        base._replace(vel=base.vel * (amp0 * decay ** m))
        for m in range(members)])


def _host_diag(diag: dict) -> dict:
    """The step's [B] diagnostics in one ``pull``: numpy arrays, bool and
    integer rows in their kinds, the rest float64."""
    keys = [k for k, v in diag.items() if torch.is_tensor(v)]
    vals = pull(*(diag[k] for k in keys))
    out = dict(diag)
    for k, v in zip(keys, vals):
        dt = diag[k].dtype
        out[k] = (v.astype(bool) if dt == torch.bool
                  else v.astype(np.int64) if not dt.is_floating_point
                  else v)
    return out


class _PerDevice:
    """A member-placed fleet's view of a per-device operator: ``fn(grid,
    *parts)`` once per local shard of its ``Blocks`` arguments (every
    plain tensor moved to the shard's device; under a world this rank's
    shards only), with the grid of that shard's device
    (``FleetSim._grid_on``); the results are ``Blocks`` along the member
    axis."""

    def __init__(self, sim, fn):
        self.sim = sim
        self.fn = fn

    def __call__(self, *args):
        mesh = self.sim.mesh
        outs = [self.fn(self.sim._grid_on(dev), *_part_of(args, i, dev))
                for i, dev in enumerate(mesh.local_devices)]
        return _wrap(outs, mesh, 0)


class _PerDeviceMG:
    """The multigrid cycle of a member-placed fleet: each shard's members
    through its device's hierarchy (``__call__`` and ``fcycle``, what the
    member-axis solvers call)."""

    def __init__(self, sim):
        self._cycle = _PerDevice(sim, lambda g, r: g.mg(r))
        self.fcycle = _PerDevice(sim, lambda g, r: g.mg.fcycle(r))

    def __call__(self, r):
        return self._cycle(r)


class FleetSim:
    """Host driver of a B-member fleet: the shared step counter, the
    per-member clocks and the member-batched step. Its driver contract is
    ``UniformSim``'s (``step_once``, ``async_diag``, ``_force_exact``,
    ``_next_dt``), with [B] diagnostics; ``resilience.FleetStepGuard``
    supervises it per member.

    ``shaped``: per-member obstacle fields (chi, us, udef) ride the member
    axis as frozen solids, penalized as ``UniformGrid.step`` does. ``bc``:
    the one boundary table of every member. ``device``: ``cuda`` unless
    ``cpu`` is given (no card and no device raises).

    Placement (``mesh``, a ``parallel.mesh.SlabMesh``, whose first device
    is the fleet's; ``device`` may then only name that one), the JAX
    package's policy and errors: ``"member"`` puts whole members along the
    mesh, B/D a device (the state's fields are ``shard_halo.Blocks`` along
    the member axis; every kernel launches once a device at L = B/D, each
    member's reductions stay on its device, the member solvers' loop flags
    are one read an iteration and the diagnostics one stacked read a
    step); ``"spatial"`` splits every member along x as
    ``ShardedUniformSim`` does (the fields are ``shard_halo.Slabs`` of
    [B, ..., Nx/D]; the halo kernels run at L = B, the epilogue is the
    plain split one, as the JAX package keeps its XLA epilogue there);
    a mesh over a world (``parallel.launch.world_mesh``) places the fleet
    across the ranks in either way (see the module docstring);
    ``"auto"`` takes member placement where B divides by the mesh size
    and one member has at most ``member_cells_cap`` cells, else spatial.
    Without a mesh ``placement`` is ``"single"``. The dt row, the clocks,
    the active mask and the diagnostics stay whole on the first device;
    ``set_state`` takes a whole fleet state (the global layout of
    checkpoints and dumps) and places it. A shaped fleet takes either
    placement: its chi, us and udef are placed like the flow fields."""

    def __init__(self, cfg: SimConfig, level: Optional[int] = None,
                 members: int = 1, shaped: bool = False, bc=None,
                 device=None, mesh=None, placement: str = "auto",
                 member_cells_cap: int = 1 << 22):
        if members < 1:
            raise ValueError(f"need members >= 1, got {members}")
        self.cfg = cfg
        self.members = int(members)
        self.shaped = bool(shaped)
        self.mesh = mesh
        lvl = cfg.level_start if level is None else level
        nx = cfg.bpdx * cfg.bs << lvl
        ny = cfg.bpdy * cfg.bs << lvl
        if mesh is not None:
            if device is not None and \
                    canonical_device(device) != mesh.home:
                raise ValueError(
                    f"FleetSim: device {device} and mesh {mesh}: pass a "
                    "mesh or a device, not both (the mesh's first device "
                    "is the fleet's)")
            device = mesh.home
            ndev = mesh.size
            if placement == "auto":
                placement = ("member"
                             if members % ndev == 0
                             and nx * ny <= member_cells_cap
                             else "spatial")
            if placement == "member" and members % ndev != 0:
                raise ValueError(
                    f"member placement needs members ({members}) "
                    f"divisible by mesh size {ndev}")
            if placement == "spatial" and nx % ndev != 0:
                raise ValueError(
                    f"spatial placement needs Nx={nx} divisible by "
                    f"mesh size {ndev}")
            if placement not in ("member", "spatial"):
                raise ValueError(f"placement {placement!r}: expected "
                                 "auto|member|spatial")
        else:
            placement = "single"
        if placement == "spatial":
            check_card_f64(device, cfg.dtype, "a fleet on spatial placement "
                           "(the x-split step's kernels 3 and 7)")
        self.placement = placement
        self.grid = UniformGrid(cfg, level, device=device, bc=bc)
        g = self.grid
        if placement == "spatial":
            g.attach_mesh(mesh)
        # one grid a device of a member-placed fleet (its operators'
        # tensors live there), the fleet's own on the first
        self._grids = {g.device: g}
        self._per = self.members
        if placement == "member":
            self._per //= mesh.size
            for d in mesh.local_devices:
                self._grid_on(d)
        self.state = self._place(stack_states(
            [g.zero_state() for _ in range(self.members)]))
        self.times = np.zeros(self.members, dtype=np.float64)
        self.time = 0.0           # min over live members (loop condition)
        self.step_count = 0       # shared: one step for every member
        # the slot-pool mask (FleetServer): host truth and its device
        # copy, pushed only when it changes; None steps unmasked
        self.active_mask = np.ones(self.members, dtype=bool)
        self._active: Optional[torch.Tensor] = None
        self.shapes: list = []
        self.case: Optional[str] = None
        self.force_log = None
        self._next_dt: Optional[torch.Tensor] = None   # [B], device
        self._force_exact = False
        self.async_diag = False
        # profiling.PhaseTimers, opt-in: one "step" phase
        # (cup2d_tpu/fleet.py:499-519)
        self.timers = None
        # one index tensor a slot, made once: slot gathers and scatters
        # take it as an operand; ``_rows`` index the whole [B] rows on the
        # first device, ``_idx`` the fields (a member-placed slot's index
        # on its own device)
        self._rows = [torch.tensor([m], dtype=torch.long, device=g.device)
                      for m in range(self.members)]
        self._idx = self._rows if placement != "member" else [
            torch.tensor([m % self._per], dtype=torch.long,
                         device=self._member_device(m))
            for m in range(self.members)]

    # -- telemetry latches (the grid's) ---------------------------------
    @property
    def poisson_mode(self) -> str:
        return self.grid.poisson_mode

    @property
    def kernel_tier(self) -> str:
        return self.grid.kernel_tier

    @property
    def prec_mode(self) -> str:
        return self.grid.prec_mode

    @property
    def smoother_tier(self) -> str:
        return self.grid.smoother_tier

    @property
    def bc_table(self) -> str:
        return self.grid.bc_table

    # -- placement --------------------------------------------------------
    def _member_device(self, m: int) -> torch.device:
        """Where member ``m``'s slice lives: its shard's device (member
        placement; the rank's own device for another rank's member, where
        ``member_state`` gathers it), else the fleet's."""
        if self.placement == "member":
            return self.mesh.devices[m // self._per] or self.mesh.home
        return self.grid.device

    def _grid_on(self, device) -> UniformGrid:
        """The fleet's grid on ``device`` (one a device of the mesh, built
        with the fleet's: the same configuration, table and latches)."""
        device = canonical_device(device)
        g = self._grids.get(device)
        if g is None:
            g0 = self.grid
            g = UniformGrid(self.cfg, g0.level, device=device, bc=g0.bc)
            self._grids[device] = g
        return g

    def _place(self, state: FlowState) -> FlowState:
        """A whole fleet state [B, ...] in this fleet's layout."""
        if self.placement == "member":
            return FlowState(*(split_blocks(f, self.mesh) for f in state))
        if self.placement == "spatial":
            return FlowState(*(split_x(f, self.mesh) for f in state))
        return state

    def set_state(self, state: FlowState) -> None:
        """Take a whole fleet state [B, ...] (on the fleet's first device,
        in its dtype) and place it."""
        self.state = self._place(state)

    def _member_linf(self, a) -> torch.Tensor:
        """max |a| per member of a fleet field in this layout: [B] on the
        first device."""
        if isinstance(a, Slabs):
            _, linf, _, _ = slab_member_reducers(a.dtype, None)
            return linf(a).reshape(-1)
        m = torch.amax(torch.abs(a), dim=tuple(range(1, a.dim())))
        return gather_blocks(m) if isinstance(m, Blocks) else m

    # -- the member-batched step ----------------------------------------
    def _dt(self, vel) -> torch.Tensor:
        """Per-member CFL dt [B] of the fleet velocity [B, 2, Ny, Nx]."""
        if self.placement == "single":
            return self.grid.compute_dt(vel, members=True)
        return self.grid.dt_from_umax(self._member_linf(vel))

    def _pressure_solve(self, rhs: torch.Tensor, exact: bool):
        """``UniformGrid.pressure_solve`` with the member axis: the same
        tolerances, refresh and stall policy and solver path. A
        member-placed fleet applies the operator and the cycle per device
        (``_PerDevice``), a spatial one reduces across its slabs
        (``shard_halo.slab_member_reducers``)."""
        g = self.grid
        cfg = self.cfg
        A, M, red = g.laplacian, g.mg, {}
        if self.placement == "member":
            A = _PerDevice(self, lambda gd, x: gd.laplacian(x))
            M = _PerDeviceMG(self)
        elif self.placement == "spatial":
            red = {"reducers": slab_member_reducers}
        if g.solver_mode == "fftd":
            def fftd(gd, b):
                return tuple(fft_diag_solve(
                    gd.laplacian, b, gd._fft_plan,
                    tol=0.0 if exact else cfg.poisson_tol,
                    tol_rel=0.0 if exact else cfg.poisson_tol_rel,
                    member_axis=True))
            if self.placement == "member":
                return BiCGSTABResult(*_PerDevice(self, fftd)(rhs))
            return BiCGSTABResult(*fftd(g, rhs))
        if g.solver_mode == "fas" and not exact:
            return mg_solve(
                A, rhs, M,
                tol=cfg.poisson_tol, tol_rel=cfg.poisson_tol_rel,
                max_cycles=cfg.max_poisson_iterations, fmg=g.fas_fmg,
                member_axis=True, **red)
        return bicgstab(
            A, rhs,
            M=M if cfg.precond else None,
            tol=0.0 if exact else cfg.poisson_tol,
            tol_rel=0.0 if exact else cfg.poisson_tol_rel,
            max_iter=cfg.max_poisson_iterations,
            max_restarts=100 if exact else cfg.max_poisson_restarts,
            sum_dtype=g.sum_dtype,
            refresh_every=10 if exact else 50,
            stall_iters=20 if exact else 120,
            stall_rtol=0.99 if exact else 0.999,
            member_axis=True, **red)

    def _step_impl(self, state: FlowState, dt: torch.Tensor, active=None,
                   exact_poisson: bool = False):
        """One step of every member: Heun advection-diffusion and the
        deltap projection, obstacle-free unless ``shaped``. ``dt`` is [B].

        ``active`` (None or a [B] bool tensor, the slot-pool mask): dead
        slots ride the step, their dt set to 1 so their lanes stay finite,
        their rows of the Poisson RHS zeroed (so the member solvers mark
        them done at iteration 0) and every output select-frozen to the
        input; their clock increment is 0. An all-True mask is the
        unmasked step bit for bit.

        Member placement runs this code on ``Blocks``: dt and the mask
        split along the members, the grid's operators and the kernels per
        device, the diagnostics gathered onto the first device. Spatial
        placement runs ``_step_spatial``."""
        if self.placement == "spatial":
            return self._step_spatial(state, dt, active, exact_poisson)
        g = self.grid
        h = g.h
        placed = self.placement == "member"
        if placed:
            dt = split_blocks(dt, self.mesh)
            if active is not None:
                active = split_blocks(active, self.mesh)
        dt_req = dt

        def on(fn):
            # a grid operation, per device where the members are placed
            return _PerDevice(self, fn) if placed else \
                (lambda *a: fn(g, *a))
        if active is not None:
            dt = torch.where(active, dt, torch.ones_like(dt))
        dt3 = dt[:, None, None]
        vel = on(lambda gd, v, d: fused_advect_heun(
            v, h, gd.cfg.nu, d, bc=gd.bc, bf16=gd.bf16))(state.vel, dt)
        if self.shaped:
            # Brinkman penalization on the member axis, the scalar chain
            # of UniformGrid.step's obstacle terms
            vel = on(lambda gd, *a: gd.penalize(*a))(
                vel, state.chi, state.us, dt3)
            b = on(lambda gd, *a: gd.poisson_rhs(*a))(
                vel, state.chi, state.udef, dt3)
        else:
            b = on(lambda gd, v, d: gd.poisson_rhs(v, None, None, d))(
                vel, dt3)
        div_linf = torch.amax(torch.abs(b), dim=(-2, -1)) * (dt / (h * h))
        b = b - on(lambda gd, p: gd.laplacian(p))(state.pres)
        if active is not None:
            b = torch.where(active[:, None, None], b, torch.zeros_like(b))
        res = self._pressure_solve(b, exact_poisson)
        vel, pres = on(lambda gd, x, p, v, d: project_correct(
            x, p, v, h, d, mean_axes=(-2, -1),
            remove_mean=gd.bc.all_neumann, grad_signs=gd._psigns,
            periodic=gd._paxes))(res.x, state.pres, vel, dt)
        if active is not None:
            vel = torch.where(active[:, None, None, None], vel, state.vel)
            pres = torch.where(active[:, None, None], pres, state.pres)
            div_linf = torch.where(active, div_linf,
                                   torch.zeros_like(div_linf))
        umax = torch.amax(torch.abs(vel), dim=(-3, -2, -1))
        vv = vel.to(g.sum_dtype) if g.sum_dtype is not None else vel
        energy = 0.5 * h * h * torch.sum(vv * vv, dim=(-3, -2, -1))
        finite = (torch.isfinite(vel).flatten(1).all(1)
                  & torch.isfinite(pres).flatten(1).all(1))
        if placed:
            res = res._replace(x=None, **{
                k: gather_blocks(getattr(res, k))
                for k in ("iters", "residual", "converged", "stalled")})
            umax, energy, finite, div_linf, dt_req = (
                gather_blocks(t) for t in (umax, energy, finite, div_linf,
                                           dt_req))
            if active is not None:
                active = gather_blocks(active)
        return state._replace(vel=vel, pres=pres), self._diag(
            res, exact_poisson, umax, energy, finite, div_linf, dt_req,
            active)

    def _diag(self, res, exact, umax, energy, finite, div_linf, dt_req,
              active):
        """The step's [B] diagnostics, whole on the first device."""
        g = self.grid
        diag = {
            "poisson_iters": res.iters,
            "poisson_residual": res.residual,
            "poisson_stalled": res.stalled,
            "poisson_converged": res.converged,
            "finite": finite,
            "umax": umax,
            "energy": energy,
            "div_linf": div_linf,
            "precond_cycles": g.precond_cycles(res, exact),
            "dt_next": g.dt_from_umax(umax),
        }
        if active is not None:
            # a dead slot advances by exactly 0.0
            diag["dt"] = torch.where(active, dt_req,
                                     torch.zeros_like(dt_req))
        return diag

    def _step_spatial(self, state: FlowState, dt: torch.Tensor, active,
                      exact_poisson: bool):
        """``_step_impl`` on fields split along x (``Slabs`` of
        [B, ..., Nx/D]): the split step of ``ShardedUniformSim`` with the
        member axis riding along (the halo kernels at L = B, a dt per
        member in their facs), a shaped fleet's penalization slab by slab
        and its chi-weighted RHS in the split form, the member solvers on
        ``slab_member_reducers``, the split epilogue's means per member,
        and every per-member reduction combined across the slabs onto the
        first device."""
        g = self.grid
        h = g.h
        _, _, _, where = slab_member_reducers(g.dtype, None)
        dt_req = dt
        if active is not None:
            dt = torch.where(active, dt, torch.ones_like(dt))
        vel = g.advect_heun(state.vel, dt)
        dt3 = dt[:, None, None]
        if self.shaped:
            vel = g.penalize(vel, state.chi, state.us, dt3)
            b = g.poisson_rhs(vel, state.chi, state.udef, dt3)
        else:
            b = g.poisson_rhs(vel, None, None, dt3)
        div_linf = self._member_linf(b) * (dt / (h * h))
        b = b - g.laplacian(state.pres)
        if active is not None:
            b = where(active[:, None, None], b, b.zeros_like())
        res = self._pressure_solve(b, exact_poisson)
        vel, pres = project_correct_x(
            res.x, state.pres, vel, h, dt, remove_mean=g.bc.all_neumann,
            grad_signs=g._psigns, periodic=g._paxes, members=True)
        if active is not None:
            vel = where(active[:, None, None, None], vel, state.vel)
            pres = where(active[:, None, None], pres, state.pres)
            div_linf = torch.where(active, div_linf,
                                   torch.zeros_like(div_linf))
        umax = self._member_linf(vel)
        vv = vel.to(g.sum_dtype) if g.sum_dtype is not None else vel
        energy = 0.5 * h * h * slab_member_sum(vv * vv)
        finite = slab_member_finite(vel, pres)
        res = res._replace(x=None)
        return state._replace(vel=vel, pres=pres), self._diag(
            res, exact_poisson, umax, energy, finite, div_linf, dt_req,
            active)

    # -- the driver contract (StepGuard's) ------------------------------
    def step_once(self, dt=None):
        """One step of the fleet. ``dt``: None (the chained per-member
        device dt), a scalar (every member) or a [B] row. One stacked
        diagnostic read for the whole fleet, or none under
        ``async_diag`` (the diagnostics and the dt used stay on the
        device, the clocks are the caller's)."""
        g = self.grid
        if dt is None:
            if self._next_dt is not None:
                dt = self._next_dt
            else:
                with tracing.label("fleet.dt"):
                    dt = self._dt(self.state.vel)
        dt_dev = torch.as_tensor(dt, dtype=g.dtype, device=g.device)
        if dt_dev.ndim == 0:
            dt_dev = dt_dev.expand(self.members).contiguous()
        exact = self.step_count < 10 or self._force_exact
        timers = self.timers or NULL_TIMERS
        with timers.phase("step"):
            with tracing.label("fleet.step"):
                self.state, diag = self._step_impl(
                    self.state, dt_dev, self._active, exact_poisson=exact)
            if "dt" not in diag:
                diag["dt"] = dt_dev   # every slot advanced by the dt it ran
            self._next_dt = diag["dt_next"]
            if self.async_diag:
                # with timers on the phase still fences (the cost of
                # profiling, as on the other drivers)
                timers.fence("step", self.state.vel)
                self.step_count += 1
                return diag
            diag = _host_diag(diag)   # the phase's natural fence
        self.times = self.times + np.asarray(diag["dt"], np.float64)
        self.time = self._fleet_time()
        self.step_count += 1
        return diag

    def _fleet_time(self) -> float:
        """The loop-condition clock: the min over live slots (a retired
        slot's frozen clock must not hold the fleet back); an empty pool
        takes the min over all."""
        act = self.active_mask
        if act.all() or not act.any():
            return float(self.times.min())
        return float(self.times[act].min())

    def set_active(self, mask) -> None:
        """Install the per-slot active mask (the server's). From the first
        call on the step runs masked, full occupancy included, where the
        all-True selects are identity. The device copy is pushed only
        when the pattern changes."""
        m = np.asarray(mask, dtype=bool)
        if m.shape != (self.members,):
            raise ValueError(
                f"active mask shape {m.shape} != ({self.members},)")
        if self._active is not None and np.array_equal(m, self.active_mask):
            return
        self.active_mask = m.copy()
        self._active = torch.as_tensor(self.active_mask,
                                       device=self.grid.device)

    # -- per-member access (guard rewind, server admit and retire) ------
    # Every write builds new fleet tensors (index_copy out of place): the
    # tensors a snapshot, a caller or a diag holds never change.
    def _member_of(self, a, m: int):
        """Member ``m``'s slice of a fleet field in this layout (new
        tensors): on its device (member placement), split along x
        (spatial), or whole."""
        idx = self._idx[m]
        if isinstance(a, Blocks):
            if a.mesh.distributed:
                # every shard's slot at m's local index, one all-gather;
                # shard m // per's is member m, whole on every rank
                return all_shards(
                    [p.index_select(0, idx)[0] for p in a.parts], a.mesh,
                    kind="state")[m // self._per]
            return a.parts[m // self._per].index_select(0, idx)[0]
        if isinstance(a, Slabs):
            return Slabs([p.index_select(0, idx.to(p.device))[0]
                          for p in a.parts], a.mesh)
        return a.index_select(0, idx)[0]

    def _with_member(self, a, m: int, v):
        """The fleet field ``a`` with member ``m``'s slice replaced by
        ``v`` (a solo field, whole or in this layout's form)."""
        idx = self._idx[m]
        if isinstance(a, Slabs):
            if not isinstance(v, Slabs):
                v = split_x(torch.as_tensor(v, dtype=a.dtype,
                                            device=a.device), a.mesh)
            return Slabs([p.index_copy(0, idx.to(p.device),
                                       q.to(p.dtype)[None])
                          for p, q in zip(a.parts, v.parts)], a.mesh)
        if isinstance(a, Blocks):
            d = m // self._per
            if d not in a.mesh.local:
                return a          # another rank's member: its owner writes
            parts = list(a.parts)
            i = a.mesh.local.index(d)
            p = parts[i]
            parts[i] = p.index_copy(0, idx, torch.as_tensor(
                v, dtype=p.dtype, device=p.device)[None])
            return Blocks(parts, a.mesh, a.axis)
        return a.index_copy(0, idx, torch.as_tensor(v, dtype=a.dtype,
                                                    device=a.device)[None])

    def member_state(self, m: int, state=None) -> FlowState:
        """Member ``m``'s slice of ``state`` (default the fleet's; a
        snapshot payload dict too) as a solo FlowState of new tensors: on
        the member's device, split along x on spatial placement. A
        collective on a member-placed fleet across processes (every rank
        gets the member whole)."""
        state = self.state if state is None else state
        if isinstance(state, dict):
            state = FlowState(**state)
        return FlowState(*(self._member_of(a, m) for a in state))

    def set_member_state(self, m: int, st: FlowState) -> None:
        """Install a solo FlowState (whole, or in the layout
        ``member_state`` gives) into member ``m``'s slice; every other
        member's values pass through unchanged. Across processes only the
        rank that owns the member's shard (member placement) or each
        rank's own slabs (spatial) change."""
        self.state = FlowState(*(self._with_member(a, m, v)
                                 for a, v in zip(self.state, st)))

    def _member_grid(self, m: int) -> UniformGrid:
        return self._grid_on(self._member_device(m))

    def _ensure_next_dt(self) -> torch.Tensor:
        if self._next_dt is None:
            # the other lanes get the dt step_once would compute from the
            # current velocities
            self._next_dt = self._dt(self.state.vel)
        return self._next_dt

    def set_member_next_dt(self, m: int, dt_next) -> None:
        """Member ``m``'s chained dt, the others' unchanged."""
        nd = self._ensure_next_dt()
        v = torch.as_tensor(dt_next, dtype=nd.dtype, device=nd.device)
        self._next_dt = nd.index_copy(0, self._rows[m], v.reshape(1))

    def admit_member(self, m: int, st: FlowState, next_dt=None) -> None:
        """Install ``st`` into slot ``m`` with its chained dt. ``next_dt``
        None or <= 0 (the JAX package's "fresh dt" sentinel) takes the CFL
        dt of the admitted velocity, ``grid.compute_dt`` of the solo
        slice, computed on the device."""
        nd = self._ensure_next_dt()
        self.set_member_state(m, st)
        if next_dt is None or not float(next_dt) > 0:
            v = self._member_grid(m).compute_dt(
                self.member_state(m).vel).to(nd.device)
        else:
            v = torch.as_tensor(float(next_dt), dtype=nd.dtype,
                                device=nd.device)
        self._next_dt = nd.index_copy(0, self._rows[m], v.reshape(1))

    def member_step_once(self, m: int, dt=None, exact: bool = False):
        """Advance only member ``m`` one step through the solo step
        (``UniformGrid.step``: on the member's own device, or split along
        x on spatial placement), the guard's replay and retry path. The
        shared counter, the fleet dt cache and the clocks are the
        caller's. Returns the solo diagnostics (device tensors), with
        ``dt``."""
        g = self._member_grid(m)
        st = self.member_state(m)
        if dt is None:
            with tracing.label("fleet.solo_dt"):
                dt = float(pull(g.compute_dt(st.vel))[0])
        with tracing.label("fleet.solo_ladder"):
            st, diag = g.step(st, torch.as_tensor(dt, dtype=g.dtype,
                                                  device=g.device),
                              exact_poisson=bool(exact),
                              obstacle_terms=self.shaped)
        self.set_member_state(m, st)
        diag = dict(diag)
        diag["dt"] = float(dt)
        return diag

    def seed_taylor_green(self, amp0: float = 1.0,
                          decay: float = 0.8) -> None:
        """The CLI fleet's t = 0 state: the amplitude-laddered
        Taylor-Green ensemble (each member its own umax and dt)."""
        self.set_state(taylor_green_fleet(self.grid, self.members, amp0,
                                          decay))


# ---------------------------------------------------------------------------
# the serving pool
# ---------------------------------------------------------------------------

@dataclass
class FleetRequest:
    """One client session waiting for a slot. ``state`` (a solo
    FlowState at clock ``t0``) or ``checkpoint`` (a session directory of
    ``io.save_member_checkpoint``, which resumes the session bit-exact:
    state, clock and chained dt) gives the admitted state. The session
    retires once its clock reaches ``t_end``; ``next_dt`` overrides its
    first dt (else the checkpoint's, else a fresh CFL dt). ``bc``: the
    session's expected boundary table; admission refuses a pool built
    with another (None: whatever the pool runs)."""
    client_id: str
    state: Optional[FlowState] = None
    checkpoint: Optional[str] = None
    t0: float = 0.0
    t_end: float = float("inf")
    next_dt: Optional[float] = None
    bc: Optional[object] = None


class FleetServer:
    """Continuous batching over a ``FleetSim`` slot pool: a fixed-B pool
    stepped under the per-slot active mask. Finished members retire (their
    session checkpoint lands in ``session_dir``), members whose recovery
    ladder is exhausted are evicted (the guard's ``on_member_abort``), and
    free slots refill from the queue. A live member's trajectory does not
    depend on its co-members' churn: its lane is elementwise independent,
    and dead lanes change only values no live lane reads.

    ``member_admit``/``member_retire``/``member_evict`` events go to
    ``event_log``; the schema-v7 gauges come from ``telemetry_fields``;
    with ``clients_dir`` the metrics recorder writes one JSONL stream a
    client (``profiling.ClientStreams``); ``latency`` is a
    ``tracing.ServingLatency`` or None."""

    def __init__(self, sim: FleetSim, *, guard=None,
                 session_dir: Optional[str] = None, event_log=None,
                 clients_dir: Optional[str] = None,
                 clients_rotate_mb=None, latency=None):
        self.sim = sim
        self.guard = guard
        if guard is not None:
            # the eviction rung: an exhausted per-member ladder frees the
            # slot instead of raising
            guard.on_member_abort = self._on_member_abort
        self.session_dir = session_dir
        self.event_log = event_log
        self.latency = latency
        self.queue: deque = deque()
        self.active = np.zeros(sim.members, dtype=bool)
        self.t_end = np.full(sim.members, np.inf)
        self.client: list = [None] * sim.members
        self.admitted = 0
        self.retired = 0
        self.evicted = 0
        self.step_clients: list = [None] * sim.members
        self.clients = None
        if clients_dir is not None:
            from .profiling import ClientStreams
            self.clients = ClientStreams(clients_dir,
                                         rotate_mb=clients_rotate_mb)
        # eviction re-zeroes its slot (an aborted member's NaNs must not
        # reach the masked step's diagnostic rows); a retirement leaves
        # its final, finite state parked under the mask
        self._zero = sim.grid.zero_state()
        # slot changes mark the mask dirty; step() pushes it once a cycle
        self._mask_dirty = False
        sim.set_active(self.active)

    # -- client API ------------------------------------------------------
    def submit(self, req: FleetRequest) -> None:
        """Enqueue a session; it is admitted at the next free slot."""
        if self.latency is not None:
            self.latency.on_submit(req.client_id)
        self.queue.append(req)

    def client_of(self, m: int):
        """The client in slot ``m`` (None when free)."""
        return self.client[m]

    @property
    def occupancy(self) -> float:
        return float(self.active.sum()) / self.sim.members

    def telemetry_fields(self) -> dict:
        """The schema-v7 serving gauges (host state only)."""
        return {
            "active_members": int(self.active.sum()),
            "occupancy": round(self.occupancy, 6),
            "admitted": int(self.admitted),
            "evicted": int(self.evicted),
            "queue_depth": len(self.queue),
        }

    def close(self) -> None:
        if self.clients is not None:
            self.clients.close()

    # -- slot lifecycle ---------------------------------------------------
    def _emit(self, **fields) -> None:
        if self.event_log is not None:
            self.event_log.emit(**fields)

    def _fill_slots(self) -> int:
        n = 0
        for m in range(self.sim.members):
            if not self.queue:
                break
            if not self.active[m]:
                self._admit(m, self.queue.popleft())
                n += 1
        return n

    def _admit(self, slot: int, req: FleetRequest) -> None:
        with tracing.span("admit", member=slot, client=str(req.client_id)):
            self._admit_inner(slot, req)
        if self.latency is not None:
            self.latency.on_admit(req.client_id)

    def _admit_inner(self, slot: int, req: FleetRequest) -> None:
        sim = self.sim
        if req.bc is not None and req.bc != sim.grid.bc:
            raise ValueError(
                f"request {req.client_id!r}: session BCTable "
                f"({req.bc.token}) does not match the pool's "
                f"({sim.grid.bc.token}); submit it to a pool built "
                "with that table")
        meta: dict = {}
        if req.checkpoint is not None:
            from .io import load_member_checkpoint
            st, meta = load_member_checkpoint(req.checkpoint, sim.grid)
        else:
            st = req.state
        if st is None:
            raise ValueError(
                f"request {req.client_id!r}: neither state nor "
                "checkpoint provided")
        t0 = float(meta.get("time", req.t0))
        sim.times[slot] = t0
        nd = req.next_dt if req.next_dt is not None \
            else meta.get("next_dt")
        sim.admit_member(slot, st, nd)
        self.active[slot] = True
        self._mask_dirty = True
        self.client[slot] = req.client_id
        self.t_end[slot] = float(req.t_end)
        self.admitted += 1
        if self.guard is not None:
            # the slot's watchdog history was the previous occupant's
            self.guard.reset_member_watchdog(slot)
        self._emit(event="member_admit", member=slot,
                   client=req.client_id, t0=t0, t_end=float(req.t_end))

    def _free_slot(self, slot: int, zero: bool = False) -> None:
        if zero:
            self.sim.set_member_state(slot, self._zero)
        self.active[slot] = False
        self._mask_dirty = True
        self.client[slot] = None
        self.t_end[slot] = np.inf

    def _retire(self, slot: int) -> None:
        cid = self.client[slot]
        with tracing.span("retire", member=slot, client=str(cid)):
            ckpt = None
            if self.session_dir is not None:
                from .io import save_member_checkpoint
                ckpt = os.path.join(self.session_dir, str(cid))
                save_member_checkpoint(ckpt, self.sim, slot)
            t_done = float(self.sim.times[slot])
            self._free_slot(slot)
            self.retired += 1
            if self.clients is not None:
                self.clients.close(cid)
            self._emit(event="member_retire", member=slot, client=cid,
                       t=t_done, checkpoint=ckpt)

    def _on_member_abort(self, m: int, reason: str, step: int) -> None:
        """The guard's eviction hook: free and zero the slot and count
        it. The guard re-anchors its ring right after, on the zeroed slot
        and the healthy members' live states."""
        cid = self.client[m]
        with tracing.span("evict", member=m, client=str(cid),
                          reason=reason):
            self._free_slot(m, zero=True)
            self.evicted += 1
            # now, not at the next cycle: the guard is mid-step
            self.sim.set_active(self.active)
            self._mask_dirty = False
            if self.clients is not None:
                self.clients.close(cid)
            self._emit(event="member_evict", member=m, client=cid,
                       reason=reason, step=step)

    # -- the serving loop ---------------------------------------------
    def step(self) -> Optional[dict]:
        """One serving cycle: refill free slots, step the pool, retire the
        members whose clocks reached their horizon. Returns the step
        record (None when the pool is empty and nothing is queued)."""
        if self._fill_slots() and self.guard is not None:
            # a fresh anchor after admissions: a rewind must restore the
            # admitted state, never the slot's previous contents
            self.guard.reanchor()
        if not self.active.any():
            return None
        if self._mask_dirty:
            # one mask push a cycle, however many slots flipped
            self.sim.set_active(self.active)
            self._mask_dirty = False
        lat = self.latency
        t0 = time.perf_counter() if lat is not None else 0.0
        rec = (self.guard.step() if self.guard is not None
               else self.sim.step_once())
        # the slots' occupants during this step: a retiree's last row
        # must still reach its client stream
        self.step_clients = list(self.client)
        if lat is not None:
            lat.on_step(self.step_clients, time.perf_counter() - t0)
        done = np.flatnonzero(self.active & (self.sim.times >= self.t_end))
        for m in done:
            self._retire(int(m))   # the mask push waits for the next cycle
        return rec

    def park_all(self) -> int:
        """Retire every live member now (the CLI's preemption path), each
        with its session checkpoint; the queue is left to the caller.
        Returns the number parked."""
        live = np.flatnonzero(self.active)
        for m in live:
            self._retire(int(m))
        if live.size:
            self.sim.set_active(self.active)
        return int(live.size)

    def drain(self, *, max_steps: Optional[int] = None) -> int:
        """Serve until the queue is empty and every slot has retired (or
        ``max_steps`` cycles). Returns the number of steps taken."""
        n = 0
        while self.queue or self.active.any():
            if max_steps is not None and n >= max_steps:
                break
            if self.step() is None:
                break
            n += 1
        return n
