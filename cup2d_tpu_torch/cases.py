"""The validation-case catalog: the counterpart of ``cup2d_tpu.cases``.

A case bundles a ``SimConfig``, a boundary table (``bc.py``) and its
initial state behind one name. The listing is the JAX package's:

``cavity``
    Lid-driven cavity: unit box, four no-slip walls, the y_hi lid moving
    at ``lid_u``, Re = lid_u / nu. Obstacle-free (``UniformSim``,
    ``ShardedUniformSim`` with ``mesh=``, or a ``fleet.FleetSim`` of
    ``members`` slots, every member on the one table). Validated against
    Ghia, Ghia & Shin (1982) at Re 100 (``ghia_errors``; ``python -m
    cup2d_tpu_torch.cases --ghia``).
``channel``, ``cylinder``
    Flow past a fixed disk between an inflow and an outflow face (Re 200,
    the impulsive start u = u_in), and the towed cylinder in the free-slip
    box: shaped cases, a ``sim.Simulation`` with one prescribed disk. Run
    ``sim.initialize()`` before stepping, or let the first ``step_once``
    run it.
``tgv_periodic``, ``shear_layer``, ``turb2d``
    Doubly-periodic obstacle-free cases on the unit box (``UniformSim``):
    the Taylor-Green vortex, whose kinetic energy decays as
    exp(-4 nu k^2 t), the double shear layer of Bell, Colella & Glaz
    (1989), and seeded decaying turbulence. They run under any solver,
    ``CUP2D_POIS=fftd`` included, solo or as a ``FleetSim`` of ``members``
    slots (turb2d's member m draws seed + m), and on a slab mesh (``mesh``:
    a ``ShardedUniformSim``, or a fleet placed on it).

The catalog's drivers run on ``cuda`` unless given ``device="cpu"``. Run
the Ghia comparison with

    python -m cup2d_tpu_torch.cases --ghia [--level 4] [--device cpu]

(Re 100 at 128^2 to t = 30, about 23,000 steps; both centreline errors
must be at most 0.02 of the lid speed).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from .bc import (FREE_SLIP, BCTable, convective_outflow, dirichlet_inflow,
                 free_slip, no_slip, periodic)
from .config import SimConfig
from .models import DiskShape
from .sim import Simulation

# Ghia, Ghia & Shin (1982), Re 100: u along the vertical centreline x = 0.5
# (Table I) and v along the horizontal centreline y = 0.5 (Table II), on
# their 129 x 129 grid, end points included.
GHIA_Y = np.array([
    0.0000, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
    0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766,
    1.0000])
GHIA_U = np.array([
    0.00000, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
    -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
    0.68717, 0.73722, 0.78871, 0.84123, 1.00000])
GHIA_X = np.array([
    0.0000, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266, 0.2344,
    0.5000, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531, 0.9609, 0.9688,
    1.0000])
GHIA_V = np.array([
    0.00000, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507,
    0.17527, 0.05454, -0.24533, -0.22445, -0.16914, -0.10313,
    -0.08864, -0.07391, -0.05906, 0.00000])
GHIA_BAR = 0.02        # of the lid speed, both centrelines


@dataclass(frozen=True)
class CaseSpec:
    """One catalog entry: ``build(**kw)`` returns a driver with ``case``
    set; ``default_level`` is the validation resolution; ``fleet_ok``
    marks the cases the JAX package's fleet pool serves."""

    name: str
    describe: str
    build: Callable
    default_level: int
    fleet_ok: bool = False


def cavity_table(lid_u: float = 1.0) -> BCTable:
    """Four no-slip walls, the y_hi lid moving at (+lid_u, 0)."""
    return BCTable(no_slip(), no_slip(), no_slip(), no_slip(lid_u, 0.0))


def channel_table(u_in: float, profile: str = "uniform") -> BCTable:
    """Dirichlet inflow at x_lo, convective outflow at x_hi, free-slip side
    walls."""
    return BCTable(dirichlet_inflow(u_in, profile=profile),
                   convective_outflow(), free_slip(), free_slip())


def periodic_table() -> BCTable:
    """Doubly-periodic box."""
    return BCTable(periodic(), periodic(), periodic(), periodic())


def periodic_channel_table() -> BCTable:
    """Periodic in x, no-slip walls in y."""
    return BCTable(periodic(), periodic(), no_slip(), no_slip())


def build_cavity(level: Optional[int] = None, re: float = 100.0,
                 lid_u: float = 1.0, dtype: str = "float32", mesh=None,
                 members: int = 0, cfl: float = 0.4, device=None):
    """Lid-driven cavity at Re = lid_u * L / nu on the unit box, from rest:
    a solo ``UniformSim``, a ``members``-slot ``fleet.FleetSim`` (every
    member on the one table), or a ``ShardedUniformSim`` over ``mesh`` (a
    ``parallel.mesh.SlabMesh``, whose first device is the sim's; ``device``
    is then left unset)."""
    lvl = 4 if level is None else level
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, dtype=dtype, nu=lid_u / re, cfl=cfl,
                    poisson_tol=1e-4, poisson_tol_rel=1e-3)
    bc = cavity_table(lid_u)
    _mesh_or_device(mesh, device, "build_cavity")
    if members > 0:
        from .fleet import FleetSim
        sim = FleetSim(cfg, level=lvl, members=members, bc=bc,
                       device=device, mesh=mesh)
    elif mesh is not None:
        from .parallel.mesh import ShardedUniformSim
        sim = ShardedUniformSim(cfg, mesh, level=lvl, bc=bc)
    else:
        from .uniform import UniformSim
        sim = UniformSim(cfg, level=lvl, device=device, bc=bc)
    sim.case = "cavity"
    return sim


def build_channel(level: Optional[int] = None, re: float = 200.0,
                  u_in: float = 0.2, diameter: float = 0.1,
                  dtype: str = "float32", profile: str = "uniform",
                  xpos: float = 1.0, device=None):
    """Channel past a fixed cylinder: the 4 x 1 domain, the impulsive start
    at the inflow velocity, Re = u_in * diameter / nu. Returns a
    ``sim.Simulation``."""
    lvl = 5 if level is None else level
    cfg = SimConfig(bpdx=4, bpdy=1, level_max=1, level_start=0,
                    extent=4.0, dtype=dtype, nu=u_in * diameter / re,
                    lam=1e6, cfl=0.5, max_poisson_iterations=200,
                    poisson_tol=1e-3, poisson_tol_rel=1e-2)
    sim = Simulation(
        cfg, shapes=[DiskShape(diameter / 2, xpos, 0.5,
                               prescribed=(0.0, 0.0))],
        level=lvl, bc=channel_table(u_in, profile), device=device)
    # impulsive start: the stream fills the domain at t = 0 (the standard
    # setup for the literature Strouhal band)
    vel = sim.state.vel.clone()
    vel[0] = u_in
    sim.state = sim.state._replace(vel=vel)
    sim.case = "channel"
    return sim


def build_cylinder(level: Optional[int] = None, D: float = 0.1,
                   U: float = 0.2, nu: float = 5e-4, xpos: float = 3.2,
                   bpdy: int = 1, dtype: str = "float32", device=None):
    """The towed cylinder: the free-slip box and a prescribed (-U, 0) disk
    towed through still fluid, the Galilean twin of ``channel`` in the
    closed box. Returns a ``sim.Simulation``."""
    lvl = 5 if level is None else level
    cfg = SimConfig(bpdx=4, bpdy=bpdy, level_max=1, level_start=0,
                    extent=4.0, dtype=dtype, nu=nu, lam=1e6, cfl=0.5,
                    max_poisson_iterations=200, poisson_tol=1e-3,
                    poisson_tol_rel=1e-2)
    sim = Simulation(
        cfg, shapes=[DiskShape(D / 2, xpos, 0.5 * bpdy,
                               prescribed=(-U, 0.0))],
        level=lvl, bc=FREE_SLIP, device=device)
    sim.case = "cylinder"
    return sim


def _mesh_or_device(mesh, device, who: str) -> None:
    if mesh is not None and device is not None:
        raise ValueError(f"{who}: pass a mesh or a device, not both (the "
                         "mesh's first device is the sim's)")


def _periodic_sim(cfg: SimConfig, lvl: int, mesh, members: int, device):
    """The obstacle-free periodic cases' driver on the doubly-periodic
    table, the JAX package's dispatch (fleet > split > solo): a
    ``members``-slot ``fleet.FleetSim`` (placed on ``mesh`` where given),
    a ``ShardedUniformSim`` over ``mesh``, or a solo ``UniformSim``."""
    _mesh_or_device(mesh, device, "periodic case")
    if members > 0:
        from .fleet import FleetSim
        return FleetSim(cfg, level=lvl, members=members, mesh=mesh,
                        bc=periodic_table(), device=device)
    if mesh is not None:
        from .parallel.mesh import ShardedUniformSim
        return ShardedUniformSim(cfg, mesh, level=lvl, bc=periodic_table())
    from .uniform import UniformSim
    return UniformSim(cfg, level=lvl, device=device, bc=periodic_table())


def _install_vel(sim, members: int, vel_fn):
    """Overwrite the zero state's velocity with ``vel_fn(m)`` [2, Ny, Nx]
    (numpy), stacked over a fleet's slots; a sim on a mesh takes it whole
    and places it (``set_state``)."""
    vel = (np.stack([vel_fn(m) for m in range(members)]) if members > 0
           else vel_fn(0))
    vel = sim.grid.tensor(vel)
    if getattr(sim, "mesh", None) is not None:
        from .io import whole
        sim.set_state(type(sim.state)(*(whole(f) for f in sim.state))
                      ._replace(vel=vel))
    else:
        sim.state = sim.state._replace(vel=vel)


def _periodic_cfg(nu: float, dtype: str, cfl: float) -> SimConfig:
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, dtype=dtype, nu=nu, cfl=cfl,
                     poisson_tol=1e-4, poisson_tol_rel=1e-3)


def build_tgv_periodic(level: Optional[int] = None, nu: float = 1e-3,
                       u0: float = 1.0, dtype: str = "float32", mesh=None,
                       members: int = 0, cfl: float = 0.4, device=None):
    """Doubly-periodic Taylor-Green vortex on the unit box:
    u = u0 sin(kx) cos(ky), v = -u0 cos(kx) sin(ky), k = 2 pi. Its
    nonlinear term is a pure gradient, so the flow decays self-similarly,
    KE(t) = KE(0) exp(-4 nu k^2 t), and the cell-centre samples are
    divergence-free under the central divergence."""
    lvl = 4 if level is None else level
    cfg = _periodic_cfg(nu, dtype, cfl)
    sim = _periodic_sim(cfg, lvl, mesh, members, device)
    x, y = sim.grid.cell_centers()
    k = 2.0 * np.pi / cfg.extent
    u = u0 * np.sin(k * x) * np.cos(k * y)
    v = -u0 * np.cos(k * x) * np.sin(k * y)
    _install_vel(sim, members, lambda m: np.stack([u, v]))
    sim.case = "tgv_periodic"
    return sim


def build_shear_layer(level: Optional[int] = None, nu: float = 2e-4,
                      rho: float = 30.0, delta: float = 0.05,
                      u0: float = 1.0, dtype: str = "float32", mesh=None,
                      members: int = 0, cfl: float = 0.4, device=None):
    """Doubly-periodic double shear layer (Bell, Colella & Glaz 1989): two
    tanh layers of width ~1/rho at y = 1/4 and 3/4, kicked by a
    delta sin(2 pi x) vertical velocity that rolls each up into a
    vortex."""
    lvl = 4 if level is None else level
    cfg = _periodic_cfg(nu, dtype, cfl)
    sim = _periodic_sim(cfg, lvl, mesh, members, device)
    x, y = sim.grid.cell_centers()
    L = cfg.extent
    u = u0 * np.where(y <= 0.5 * L, np.tanh(rho * (y / L - 0.25)),
                      np.tanh(rho * (0.75 - y / L)))
    v = delta * u0 * np.sin(2.0 * np.pi * x / L)
    _install_vel(sim, members, lambda m: np.stack([u, v]))
    sim.case = "shear_layer"
    return sim


def turb2d_velocity(ny: int, nx: int, h: float, seed: int, k0: float,
                    urms: float) -> np.ndarray:
    """The seeded turbulence's initial velocity [2, ny, nx] (host numpy,
    the JAX package's synthesis): a random-phase streamfunction with the
    energy spectrum E(k) ~ k / (1 + (k/k0)^4), differenced centrally on
    the wrap (u = D_y psi, v = -D_x psi, so the central divergence
    vanishes) and scaled to rms speed ``urms``."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(nx, d=1.0 / nx)
    ky = np.fft.fftfreq(ny, d=1.0 / ny)
    KX, KY = np.meshgrid(kx, ky, indexing="xy")
    kk = np.sqrt(KX ** 2 + KY ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        # psi-hat amplitude sqrt(E(k)/k)/k
        amp = np.where(kk > 0,
                       np.sqrt(kk / (1.0 + (kk / k0) ** 4)) / (kk ** 1.5),
                       0.0)
    phase = np.exp(2j * np.pi * rng.random((ny, nx)))
    psi = np.fft.ifft2(amp * phase).real
    u = (np.roll(psi, -1, axis=0) - np.roll(psi, 1, axis=0)) / (2.0 * h)
    v = -(np.roll(psi, -1, axis=1) - np.roll(psi, 1, axis=1)) / (2.0 * h)
    rms = np.sqrt(np.mean(u ** 2 + v ** 2))
    s = urms / rms if rms > 0 else 1.0
    return np.stack([u * s, v * s])


def build_turb2d(level: Optional[int] = None, nu: float = 1e-4,
                 seed: int = 0, k0: float = 6.0, urms: float = 1.0,
                 dtype: str = "float32", mesh=None, members: int = 0,
                 cfl: float = 0.4, device=None):
    """Seeded decaying 2D turbulence on the doubly-periodic unit box
    (``turb2d_velocity``, deterministic per seed; a fleet's member m draws
    seed + m, an ensemble)."""
    lvl = 4 if level is None else level
    cfg = _periodic_cfg(nu, dtype, cfl)
    sim = _periodic_sim(cfg, lvl, mesh, members, device)
    g = sim.grid
    _install_vel(sim, members, lambda m: turb2d_velocity(
        g.ny, g.nx, g.h, seed + m, k0, urms))
    sim.case = "turb2d"
    return sim

CASES: Tuple[CaseSpec, ...] = (
    CaseSpec("cavity",
             "lid-driven cavity (4x no-slip, moving lid), Re=100",
             build_cavity, default_level=4, fleet_ok=True),
    CaseSpec("channel",
             "channel past a fixed cylinder (inflow/outflow), Re=200",
             build_channel, default_level=5),
    CaseSpec("cylinder",
             "towed cylinder in the free-slip box (legacy validation)",
             build_cylinder, default_level=5),
    CaseSpec("tgv_periodic",
             "doubly-periodic Taylor-Green vortex (analytic KE decay)",
             build_tgv_periodic, default_level=4, fleet_ok=True),
    CaseSpec("shear_layer",
             "doubly-periodic double shear layer roll-up (BCG 1989)",
             build_shear_layer, default_level=4, fleet_ok=True),
    CaseSpec("turb2d",
             "seeded decaying 2D turbulence, doubly-periodic",
             build_turb2d, default_level=4, fleet_ok=True),
)

REGISTRY = {c.name: c for c in CASES}


def case_names() -> Tuple[str, ...]:
    return tuple(c.name for c in CASES)


def make_sim(name: str, **kw):
    """Build a named case's driver; an unknown name raises with the
    listing, an option that waits for an unported part names its ROADMAP
    item."""
    spec = REGISTRY.get(name)
    if spec is None:
        listing = ", ".join(f"{c.name} ({c.describe})" for c in CASES)
        raise ValueError(f"unknown case {name!r}; catalog: {listing}")
    return spec.build(**kw)


# ---------------------------------------------------------------------------
# Ghia et al. (1982) comparison
# ---------------------------------------------------------------------------

def centerline_profiles(sim):
    """(y, u(x=0.5)) and (x, v(y=0.5)) with the wall and lid values
    appended, from the cell-centred state: each centreline lies on cell
    faces, so each profile averages the two adjacent centre columns or
    rows."""
    grid = sim.grid
    vel = sim.state.vel.detach().cpu().double().numpy()
    ny, nx, h = grid.ny, grid.nx, grid.h
    yc = (np.arange(ny) + 0.5) * h
    xc = (np.arange(nx) + 0.5) * h
    u_mid = 0.5 * (vel[0][:, nx // 2 - 1] + vel[0][:, nx // 2])
    v_mid = 0.5 * (vel[1][ny // 2 - 1, :] + vel[1][ny // 2, :])
    lid_u = grid.bc.y_hi.u_wall[0]
    y = np.concatenate([[0.0], yc, [ny * h]])
    u = np.concatenate([[0.0], u_mid, [lid_u]])
    x = np.concatenate([[0.0], xc, [nx * h]])
    v = np.concatenate([[0.0], v_mid, [0.0]])
    return (y, u), (x, v)


def ghia_errors(sim) -> tuple[float, float]:
    """Max |u - Ghia| and |v - Ghia| along the two centrelines, in units of
    the lid speed (which is 1 in the catalog's cavity)."""
    (y, u), (x, v) = centerline_profiles(sim)
    return (float(np.max(np.abs(np.interp(GHIA_Y, y, u) - GHIA_U))),
            float(np.max(np.abs(np.interp(GHIA_X, x, v) - GHIA_V))))


def ghia_run(level: int = 4, re: float = 100.0, t_end: float = 30.0,
             dtype: str = "float32", device=None) -> dict:
    """The cavity at Re ``re`` from rest to ``t_end`` (``step_once``: the
    first 10 solves exact), then ``ghia_errors``. Returns the errors, the
    steps, the seconds of the stepping loop and whether both errors are
    within ``GHIA_BAR``."""
    sim = make_sim("cavity", level=level, re=re, dtype=dtype, device=device)
    dev = sim.grid.device
    t0 = time.perf_counter()
    while sim.time < t_end:
        sim.step_once()
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    err_u, err_v = ghia_errors(sim)
    return {"case": "cavity", "re": re, "n": sim.grid.nx, "dtype": dtype,
            "device": str(dev), "poisson_mode": sim.poisson_mode,
            "steps": sim.step_count, "t": sim.time, "seconds": secs,
            "err_u": err_u, "err_v": err_v,
            "ok": err_u <= GHIA_BAR and err_v <= GHIA_BAR}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The case catalog; --ghia runs the Re 100 cavity "
                    "against Ghia et al. (1982).")
    ap.add_argument("--ghia", action="store_true",
                    help="run the cavity to --t-end and compare with Ghia")
    ap.add_argument("--level", type=int, default=4,
                    help="grid level (4: 128^2)")
    ap.add_argument("--t-end", type=float, default=30.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.ghia:
        for c in CASES:
            print(f"{c.name}: {c.describe}")
        return 0
    out = ghia_run(level=args.level, t_end=args.t_end, dtype=args.dtype,
                   device=args.device)
    if out["device"].startswith("cuda"):
        import torch
        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
