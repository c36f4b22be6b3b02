"""The shaped uniform step: obstacles and flow on the uniform grid, the
counterpart of ``cup2d_tpu.sim``.

The reference time step (main.cpp:6576-7290) split between the host and
the device as the JAX package splits it:

host (numpy f64, per step)       device (torch, per step)
---------------------------      -------------------------------------
rigid advection of shapes        SDF/udef window rasterization (gather)
midline kinematics (models/)     chi from sdf, integrals, udef de-mean
CoM/d_gm bookkeeping             advection-diffusion (Heun substages)
                                 penalization momentum solve (3x3)
                                 collision impulses
                                 implicit penalization velocity update
                                 pressure Poisson solve + projection
                                 surface forces (diagnostics)

``_rasterize_impl`` is the reference's ongrid device part
(main.cpp:4208-4630), ``_flow_step_impl`` the rest of the loop
(main.cpp:6607-7187) and ``_forces_impl`` the force diagnostics
(main.cpp:7188-7284). The flow step's kernel work runs through the
port's kernels: the substage kernel twice (its boundary-table form under
a table), the correction kernel once (signed under a table) and, under
``CUP2D_POIS=fas``, the sweep-chain kernel; everything else is plain
PyTorch, as it is XLA code in the JAX package.

A step reads the device three times, each read one stacked copy:
(com, mass, inertia) after rasterizing, (uvw, diagnostics) after the flow
step, and the S x 19 forces when they are logged. The shapes' arrays go
to the device in one copy a step, and ``prescribed`` and dt in one each.

Under ``async_diag`` (set by ``resilience.StepGuard(lag=True)``) the
obstacle-free branch reads nothing: its diagnostics, the dt it used and
dt_next stay on the device and the guard's lagged verdict settles the
clock. The shaped branch verdicts eagerly whatever the flag. The guard's
escalation rung sets ``_force_exact`` (an exact solve for one attempt).

Device policy as ``UniformGrid``: ``cuda`` unless ``device="cpu"`` is
given; no card and no device raises. ``timers`` (a
``profiling.PhaseTimers``, opt-in) times the JAX package's phases: "dt",
"flow", "kinematics", "rasterize", "forces"; each ends with a ``fence`` of
its tensors (none under ``async_diag``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import tracing
from .config import SimConfig
from .models import DiskShape, FishShape
from .ops.collision import merged_overlap_integrals, \
    pairwise_collision_update
from .ops.forces import surface_forces
from .ops.obstacle import (chi_from_sdf, midline_udef,
                           penalization_integrals, polygon_sdf,
                           scatter_window_max, scatter_window_set,
                           shape_integrals, solve_rigid_momentum,
                           window_coords, window_of)
from .ops.stencil import pad_scalar
from .profiling import NULL_TIMERS
from .shapes_host import ShapeHostMixin, pull, pull_diag
from .uniform import FlowState, UniformGrid

__all__ = ["ObstacleFields", "Simulation", "make_shapes"]

_INPUT_KEYS = ("poly", "mid_r", "mid_v", "mid_nor", "mid_vnor", "width",
               "com")
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class ObstacleFields(NamedTuple):
    """Per-step obstacle state on the device (the reference's per-shape
    Obstacle blocks and global chi/tmp grids, main.cpp:3283-3342)."""

    chi: torch.Tensor      # [Ny, Nx] combined (max over shapes)
    sdf: torch.Tensor      # [Ny, Nx] combined signed distance
    chi_s: torch.Tensor    # [S, Ny, Nx]
    sdf_s: torch.Tensor    # [S, Ny, Nx] per-shape signed distance
    udef_s: torch.Tensor   # [S, 2, Ny, Nx] de-meaned deformation velocity
    com: torch.Tensor      # [S, 2] chi-corrected centres of mass
    mass: torch.Tensor     # [S]
    inertia: torch.Tensor  # [S]


def make_shapes(cfg: SimConfig) -> list:
    """Shape objects from the reference-style -shapes string."""
    out = []
    for d in cfg.parse_shapes():
        if d["kind"] == "disk":
            out.append(DiskShape(d["radius"], d["xpos"], d["ypos"]))
        else:
            out.append(FishShape(
                d["length"], d["xpos"], d["ypos"], d["angle"],
                cfg.min_h, period=d["T"],
            ))
    return out


class Simulation(ShapeHostMixin):
    """Uniform-grid simulation with immersed obstacles. ``bc`` is a
    ``bc.BCTable`` (None: the free-slip box); ``device`` as
    ``UniformGrid``."""

    def __init__(self, cfg: SimConfig, shapes: Optional[Sequence] = None,
                 level: Optional[int] = None, bc=None, device=None):
        self.cfg = cfg
        self.grid = UniformGrid(cfg, level, device=device, bc=bc)
        self.shapes = list(shapes) if shapes is not None else make_shapes(cfg)
        self.case: Optional[str] = None  # case-registry tag (cases.py)
        self.time = 0.0
        self.step_count = 0
        self.state = self.grid.zero_state()
        g = self.grid
        # static window per shape: the body diagonal plus the 4h safety
        # the reference adds to segment AABBs (main.cpp:4237), clamped per
        # axis so that a body wider than the domain's y extent keeps its
        # full x coverage
        self._wins = []
        for s in self.shapes:
            w = int(np.ceil(1.25 * s.length / g.h)) + 12
            self._wins.append((min(w, g.nx), min(w, g.ny)))
        x, y = g.cell_centers()
        self._xy = (g.tensor(x), g.tensor(y))
        self._lengths = g.tensor([s.length for s in self.shapes])
        self.compute_forces_every = 1   # 0 disables the diagnostics pass
        self.force_log: Optional[object] = None  # file-like, CSV rows
        self._next_dt: Optional[float] = None  # from last step's umax
        self._force_exact = False
        # host seconds of each phase of the last shaped step; each phase
        # ends at its own read of the device, so the device time it
        # queued is inside it
        self.phase_seconds: dict = {}
        # the lagged verdict (resilience.StepGuard, lag=True): the
        # obstacle-free branch keeps its diagnostics, the dt it used and
        # dt_next on the device and leaves the clock to the guard; the
        # shaped branch ignores it (its uvw/CoM read feeds the next step's
        # host kinematics)
        self.async_diag = False
        # profiling.PhaseTimers, opt-in: "dt", "flow", "kinematics",
        # "rasterize", "forces" (cup2d_tpu/sim.py:404-500)
        self.timers = None

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

    # ------------------------------------------------------------------
    # device: rasterization, chi, integrals (ongrid, main.cpp:4208-4630)
    # ------------------------------------------------------------------
    def _rasterize_impl(self, inputs) -> ObstacleFields:
        g = self.grid
        h = g.h
        dtype, dev = g.dtype, g.device
        np_dt = _NP_DTYPES[dtype]
        hsq = h * h
        S = len(self.shapes)

        sdf = torch.full((g.ny, g.nx), -1.0, dtype=dtype, device=dev)
        sdf_wins, udef_wins = [], []
        for k in range(S):
            inp = inputs[k]
            wx, wy = self._wins[k]
            ox, oy = inp["ox"], inp["oy"]
            x, y = window_coords(ox, oy, wx, wy, h, dtype, dev)
            # local origin at the window centre for f32 accuracy
            cx = float(np_dt(ox + 0.5 * wx) * np_dt(h))
            cy = float(np_dt(oy + 0.5 * wy) * np_dt(h))
            poly = inp["poly"]
            poly = torch.stack([poly[:, 0] - cx, poly[:, 1] - cy], dim=1)
            d = polygon_sdf(x - cx, y - cy, poly)
            mid_r = inp["mid_r"]
            mid_r = torch.stack([mid_r[:, 0] - cx, mid_r[:, 1] - cy], dim=1)
            ud = midline_udef(x - cx, y - cy, mid_r, inp["mid_v"],
                              inp["mid_nor"], inp["mid_vnor"], inp["width"])
            sdf_wins.append(d)
            udef_wins.append(ud)
            sdf = scatter_window_max(sdf, d, oy, ox)

        sdf_lab = pad_scalar(sdf, 1)
        chi = torch.zeros((g.ny, g.nx), dtype=dtype, device=dev)
        chi_s = torch.zeros((S, g.ny, g.nx), dtype=dtype, device=dev)
        # the background sentinel must fail the surface-band gate
        # own_sdf > -4h of the forces at every h: -extent does
        sdf_s = torch.full((S, g.ny, g.nx), -float(self.cfg.extent),
                           dtype=dtype, device=dev)
        udef_s = torch.zeros((S, 2, g.ny, g.nx), dtype=dtype, device=dev)
        coms, masses, inertias = [], [], []
        for k in range(S):
            inp = inputs[k]
            wx, wy = self._wins[k]
            ox, oy = inp["ox"], inp["oy"]
            # the window plus one ghost of the combined sdf (the padded
            # field's (oy, ox) is the unpadded (oy - 1, ox - 1))
            lab = window_of(sdf_lab, wy + 2, wx + 2, oy, ox)
            chi_w = chi_from_sdf(lab, sdf_wins[k], h)
            x, y = window_coords(ox, oy, wx, wy, h, dtype, dev)

            # CoM correction (main.cpp:4468-4487); zero-mass guard for
            # under-resolved bodies
            m0 = torch.sum(chi_w * hsq)
            dcx = torch.sum(chi_w * hsq * (x - inp["com"][0]))
            dcy = torch.sum(chi_w * hsq * (y - inp["com"][1]))
            safe = torch.where(m0 > 0, m0, 1.0)
            com = inp["com"] + torch.where(
                m0 > 0, torch.stack([dcx, dcy]) / safe, 0.0)

            # integrals and udef de-meaning (main.cpp:4488-4560)
            xr = x - com[0]
            yr = y - com[1]
            _, _, m, j, iu, iv, ia = shape_integrals(
                chi_w, udef_wins[k], xr, yr, hsq)
            ud = udef_wins[k] - torch.stack([iu - ia * yr, iv + ia * xr])

            scatter_window_set(chi_s[k], chi_w, oy, ox)
            scatter_window_set(sdf_s[k], sdf_wins[k], oy, ox)
            scatter_window_set(udef_s[k], ud, oy, ox)
            chi = torch.maximum(chi, chi_s[k])
            coms.append(com)
            masses.append(m)
            inertias.append(j)

        return ObstacleFields(
            chi=chi, sdf=sdf, chi_s=chi_s, sdf_s=sdf_s, udef_s=udef_s,
            com=torch.stack(coms), mass=torch.stack(masses),
            inertia=torch.stack(inertias))

    # ------------------------------------------------------------------
    # device: one flow step (main.cpp:6607-7187)
    # ------------------------------------------------------------------
    def _flow_step_impl(self, state: FlowState, obs: ObstacleFields,
                        prescribed_uvw, dt, exact_poisson=False):
        """Advection, the rigid momentum solve per free shape, the
        collision impulses, the implicit penalization and the projection.
        Returns (new_state, uvw [S, 3], diag); the diagnostics stay on
        the device."""
        g = self.grid
        cfg = self.cfg
        h = g.h
        S = len(self.shapes)
        x, y = self._xy
        dt = torch.as_tensor(dt, dtype=g.dtype, device=g.device)

        vel = g.advect_heun(state.vel, dt)

        # rigid momentum solve per shape (main.cpp:6643-6704)
        uvw = []
        for k in range(S):
            if self.shapes[k].free:
                xr = x - obs.com[k, 0]
                yr = y - obs.com[k, 1]
                sums = penalization_integrals(
                    vel, obs.chi_s[k], obs.udef_s[k], xr, yr,
                    cfg.lam * dt, h * h)
                uvw.append(solve_rigid_momentum(*sums))
            else:
                uvw.append(prescribed_uvw[k])
        uvw = (torch.stack(uvw) if S else
               torch.zeros((0, 3), dtype=g.dtype, device=g.device))

        # shape-shape collisions (main.cpp:6705-6943): chi-overlap
        # integrals per shape, merged over opponents, then pairwise e = 1
        # impulses applied in pair order
        if S > 1:
            colls = merged_overlap_integrals(
                obs.chi_s, obs.sdf_s, obs.udef_s, uvw, obs.com, x, y)
            uvw = pairwise_collision_update(
                colls, uvw, obs.mass, obs.inertia, obs.com, self._lengths)
            # prescribed-motion shapes are immovable: restore them
            for k in range(S):
                if not self.shapes[k].free:
                    uvw[k] = prescribed_uvw[k]

        # implicit penalization update, the winner shape per cell (the
        # first on a tie) (main.cpp:6944-6979)
        if S:
            win = torch.argmax(obs.chi_s, dim=0)
            us = torch.zeros_like(vel)
            for k in range(S):
                xr = x - obs.com[k, 0]
                yr = y - obs.com[k, 1]
                usk = torch.stack([
                    uvw[k, 0] - uvw[k, 2] * yr + obs.udef_s[k, 0],
                    uvw[k, 1] + uvw[k, 2] * xr + obs.udef_s[k, 1],
                ])
                us = torch.where(win == k, usk, us)
            alpha = torch.where(obs.chi > 0.5, 1.0 / (1.0 + cfg.lam * dt),
                                1.0)
            vel = alpha * vel + (1.0 - alpha) * us
            udef = self._combined_udef(obs)
        else:
            us = torch.zeros_like(vel)
            udef = torch.zeros_like(vel)

        vel, pres, res, div_linf = g.project(
            vel, state.pres, obs.chi, udef, dt, exact_poisson)

        new_state = state._replace(vel=vel, pres=pres, chi=obs.chi,
                                   us=us, udef=udef)
        return new_state, uvw, g.step_diag(vel, pres, res, div_linf,
                                           exact=exact_poisson)

    # ------------------------------------------------------------------
    # device: surface force diagnostics (main.cpp:7188-7284)
    # ------------------------------------------------------------------
    def _forces_impl(self, state: FlowState, obs: ObstacleFields, uvw):
        g = self.grid
        return [surface_forces(
            state.vel, state.pres, obs.chi, obs.sdf, obs.udef_s[k],
            obs.sdf_s[k], obs.com[k], uvw[k], self.cfg.nu, g.h)
            for k in range(len(self.shapes))]

    def _log_forces(self, obs, uvw):
        self._record_forces(self._forces_impl(self.state, obs, uvw))

    # ------------------------------------------------------------------
    # host driver
    # ------------------------------------------------------------------
    def _shape_inputs(self) -> list:
        """Per shape: the window origin (host ints, clipped into the grid)
        and the surface polygon, midline tables, width and CoM on the
        device; the arrays of every shape go over in one copy."""
        g = self.grid
        host, out = [], []
        for k, s in enumerate(self.shapes):
            wx, wy = self._wins[k]
            ox = int(np.clip(round(s.com[0] / g.h) - wx // 2, 0, g.nx - wx))
            oy = int(np.clip(round(s.com[1] / g.h) - wy // 2, 0, g.ny - wy))
            mid_r, mid_v, mid_nor, mid_vnor = s.midline_comp_frame()
            arrays = dict(zip(_INPUT_KEYS, (
                s.surface_polygon(), mid_r, mid_v, mid_nor, mid_vnor,
                s.width, s.com)))
            arrays = {k_: np.asarray(a, dtype=np.float64)
                      for k_, a in arrays.items()}
            host.append(arrays)
            out.append({"ox": ox, "oy": oy})
        if not host:
            return out
        buf = g.tensor(np.concatenate([a.ravel() for arrays in host
                                       for a in arrays.values()]))
        at = 0
        for arrays, inp in zip(host, out):
            for key, a in arrays.items():
                inp[key] = buf[at:at + a.size].view(a.shape)
                at += a.size
        return out

    def initialize(self):
        """Initial velocity := the chi-blended deformation velocity
        (main.cpp:6546-6575): u = u (1 - chi) + udef chi."""
        if not self.shapes:
            self._initialized = True
            return
        for s in self.shapes:
            s.advect(0.0, self.cfg.extents)
            s.midline(self.time)
        obs = self._rasterize_impl(self._shape_inputs())
        self._sync_shape_scalars(obs)
        udef = self._combined_udef(obs)
        vel = self.state.vel * (1.0 - obs.chi) + udef * obs.chi
        self.state = self.state._replace(vel=vel, chi=obs.chi)
        self._next_dt = None   # the blend rewrote vel; cached dt stale
        self._initialized = True

    @staticmethod
    def _combined_udef(obs: ObstacleFields) -> torch.Tensor:
        """The deformation velocity of the pressure RHS and the initial
        blend: the sum over shapes at cells where that shape's chi ties or
        wins the combined chi (main.cpp:6980-7006; ties sum)."""
        return torch.sum(
            torch.where((obs.chi_s >= obs.chi)[:, None], obs.udef_s, 0.0),
            dim=0)

    def step_once(self, dt: Optional[float] = None) -> dict:
        """One step: the reference's exact solves for the first 10 steps,
        the cached dt_next of the previous step (capped by the gait), and
        the diagnostics as host values (device values, the clock left
        alone, on the obstacle-free branch under ``async_diag``)."""
        g = self.grid
        cfg = self.cfg
        tm = self.timers or NULL_TIMERS
        if not self.shapes:
            # obstacle-free: the plain uniform step, no rasterization
            if dt is None:
                if self._next_dt is not None:
                    dt = self._next_dt
                else:
                    with tm.phase("dt"), tracing.label("sim.dt"):
                        dt = float(pull(g.compute_dt(self.state.vel))[0])
            exact = self.step_count < 10 or self._force_exact
            dt_dev = torch.as_tensor(dt, dtype=g.dtype, device=g.device)
            if self.async_diag:
                # no read: dt_next stays a device scalar fed to the next
                # dispatch, and the guard's verdict settles the clock; no
                # fence either (a fence waits for the device)
                with tracing.label("sim.flow_step_empty"):
                    self.state, diag = g.step(self.state, dt_dev,
                                              exact_poisson=exact,
                                              obstacle_terms=False)
                diag["dt"] = dt_dev
                self._next_dt = diag["dt_next"]
                self.step_count += 1
                return diag
            with tm.phase("flow"):
                with tracing.label("sim.flow_step_empty"):
                    self.state, diag = g.step(self.state, dt_dev,
                                              exact_poisson=exact,
                                              obstacle_terms=False)
                diag, _ = pull_diag(diag)
                diag["dt"] = float(dt)
                self._next_dt = float(diag["dt_next"])
                tm.fence("flow", self.state)
            self.time += dt
            self.step_count += 1
            return diag
        if not getattr(self, "_initialized", False):
            self.initialize()
        if dt is None:
            if self._next_dt is not None:
                dt = min(self._next_dt, self._kinematic_dt_cap())
            else:
                with tm.phase("dt"), tracing.label("sim.dt"):
                    dt = min(float(pull(g.compute_dt(self.state.vel))[0]),
                             self._kinematic_dt_cap())
        t0 = time.perf_counter()

        # ongrid host part (main.cpp:3992-4207)
        with tm.phase("kinematics"):
            for s in self.shapes:
                s.advect(dt, cfg.extents)
                s.midline(self.time)
        t1 = time.perf_counter()

        with tm.phase("rasterize"):
            with tracing.label("sim.rasterize"):
                obs = self._rasterize_impl(self._shape_inputs())
            self._sync_shape_scalars(obs)
            tm.fence("rasterize", obs)
        t2 = time.perf_counter()

        prescribed = g.tensor([[s.u, s.v, s.omega] for s in self.shapes])
        exact = self.step_count < 10 or self._force_exact
        with tm.phase("flow"):
            with tracing.label("sim.flow_step"):
                self.state, uvw, diag = self._flow_step_impl(
                    self.state, obs, prescribed,
                    torch.as_tensor(dt, dtype=g.dtype, device=g.device),
                    exact_poisson=exact)
            diag, (uvw_np,) = pull_diag(diag, uvw)
            diag["dt"] = float(dt)
            self._next_dt = float(diag["dt_next"])
            tm.fence("flow", self.state)
        for k, s in enumerate(self.shapes):
            if s.free:
                s.u, s.v, s.omega = (float(c) for c in uvw_np[k])
        t3 = time.perf_counter()

        if self.compute_forces_every and \
                self.step_count % self.compute_forces_every == 0:
            with tm.phase("forces"), tracing.label("sim.forces"):
                self._log_forces(obs, uvw)
        t4 = time.perf_counter()
        self.phase_seconds = {"kinematics": t1 - t0, "rasterize": t2 - t1,
                              "flow": t3 - t2, "forces": t4 - t3}

        self.time += dt
        self.step_count += 1
        return diag

    def run(self, tend: float, max_steps: int = 10**9) -> dict:
        diag = {}
        while self.time < tend and self.step_count < max_steps:
            diag = self.step_once()
        return diag
