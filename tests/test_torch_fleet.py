"""The port's fleet (``cup2d_tpu_torch.fleet.FleetSim``) and its member-axis
solvers against the JAX package's, f64 on the CPU at 32^2, B <= 3.

* ``bicgstab``/``mg_solve`` with ``member_axis=True`` on [3, 32, 32]
  right-hand sides: <= 1e-10 of JAX's, with equal per-member iterations,
  ``converged`` and ``stalled``; one member is the solo solve bit for bit;
  a member that converges early is frozen bit-exact while the loop runs on
  for the others (the JAX package's test of the same name).
* ``FleetSim`` at B = 1 is ``UniformSim`` bit for bit through the exact
  startup solves, clocks included, with no more device reads.
* B = 3 amplitude-laddered Taylor-Green members (10 exact startup steps and
  5 production steps, a production tolerance tight enough that the solves
  iterate) stay <= 1e-10 of JAX's ``FleetSim`` with equal iterations and dt
  rows, and <= 1e-12 of their solo port runs, under the default solver and
  fas.
* The catalog's cavity and ``tgv_periodic`` fleets (default, fas, fftd)
  against JAX's ``make_sim(..., members=2)``; a shaped fleet's members
  against the solo obstacle step.
* The fleet checkpoint carries the per-member clocks; a JAX fleet
  checkpoint loads into the port and steps on <= 1e-10 of JAX.
* ``mesh=`` places the fleet (tests/test_torch_fleet_mesh.py); without a
  mesh ``placement`` is ``"single"``, whatever is asked.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu import io as jio  # noqa: E402
from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.fleet import FleetSim as JFleet  # noqa: E402
from cup2d_tpu.fleet import taylor_green_fleet as jtg_fleet  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch import poisson as tp  # noqa: E402
from cup2d_tpu_torch import shapes_host  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.convert import copy_fleet_state  # noqa: E402
from cup2d_tpu_torch.fleet import FleetSim  # noqa: E402
from cup2d_tpu_torch.fleet import stack_states  # noqa: E402
from cup2d_tpu_torch.fleet import taylor_green_fleet  # noqa: E402
from cup2d_tpu_torch.uniform import UniformSim  # noqa: E402
from cup2d_tpu_torch.uniform import taylor_green_state  # noqa: E402

LVL = 2                   # 32 x 32
TRAJ_BAR = 1e-10          # port against JAX
SOLO_BAR = 1e-12          # a member against its solo run
STARTUP, PRODUCTION = 10, 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """The JAX package's fleet-test configuration, with a production
    tolerance under which the warm production solves still iterate."""
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                max_poisson_iterations=100, poisson_tol=1e-9,
                poisson_tol_rel=1e-7)
    base.update(kw)
    return SimConfig(**base)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


def _pois(mp, mode):
    if mode == "default":
        mp.delenv("CUP2D_POIS", raising=False)
    else:
        mp.setenv("CUP2D_POIS", mode)


# ---------------------------------------------------------------------------
# the member-axis solvers
# ---------------------------------------------------------------------------

def _rhs(ny, nx, members=3, seed=3):
    """Mean-free right-hand sides of three difficulties."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((members, ny, nx))
    b *= np.array([1e-3, 1.0, 0.1][:members])[:, None, None]
    return b - b.mean(axis=(1, 2), keepdims=True)


def _solvers(mode, monkeypatch):
    """The JAX and port grids of one solver mode."""
    from cup2d_tpu.uniform import UniformGrid as JGrid
    from cup2d_tpu_torch.uniform import UniformGrid as TGrid
    _pois(monkeypatch, "fas" if mode == "mg" else "default")
    cfg = _cfg()
    return JGrid(cfg, level=LVL), TGrid(_tcfg(cfg), level=LVL,
                                        device="cpu")


def _solve(pkg, g, b, mode, member_axis, **kw):
    kw = dict(tol=1e-7, tol_rel=1e-10, **kw)
    if mode == "mg":
        return pkg.mg_solve(g.laplacian, b, g.mg, max_cycles=50,
                            member_axis=member_axis, **kw)
    return pkg.bicgstab(g.laplacian, b, M=g.mg, max_iter=100,
                        sum_dtype=g.sum_dtype, member_axis=member_axis, **kw)


@pytest.mark.parametrize("mode", ["bicgstab", "mg"])
def test_member_solvers_match_jax(mode, monkeypatch):
    jg, tg = _solvers(mode, monkeypatch)
    b = _rhs(tg.ny, tg.nx)
    jr = jax.jit(lambda bb: _solve(jp, jg, bb, mode, True))(jnp.asarray(b))
    tr = _solve(tp, tg, torch.tensor(b), mode, True)
    scale = max(1.0, float(np.abs(np.asarray(jr.x)).max()))
    assert _err(tr.x, jr.x) <= TRAJ_BAR * scale
    for key in ("iters", "converged", "stalled"):
        assert np.array_equal(_np(getattr(tr, key)),
                              np.asarray(getattr(jr, key))), key
    assert np.allclose(_np(tr.residual), np.asarray(jr.residual),
                       rtol=1e-6, atol=1e-14)
    assert len(set(_np(tr.iters).tolist())) > 1    # the freeze had work


@pytest.mark.parametrize("mode", ["bicgstab", "mg"])
def test_member_form_of_one_member_is_the_solo_solve(mode, monkeypatch):
    """At B = 1 the member loop takes the solo loop's iterate bit for bit,
    in no more device reads."""
    _, tg = _solvers(mode, monkeypatch)
    b = torch.tensor(_rhs(tg.ny, tg.nx, members=1, seed=5))
    p0 = shapes_host.pulls
    solo = _solve(tp, tg, b[0], mode, False)
    p1 = shapes_host.pulls
    mem = _solve(tp, tg, b, mode, True)
    p2 = shapes_host.pulls
    assert torch.equal(mem.x[0], solo.x)
    assert int(mem.iters[0]) == solo.iters
    assert bool(mem.converged[0]) == solo.converged
    assert float(mem.residual[0]) == solo.residual
    assert p2 - p1 <= p1 - p0


def test_converged_member_frozen_under_extra_iterations():
    """A member whose solve converges early returns exactly the solution
    it returns when the loop stops with it: the sweeps run for its slower
    co-member are identity for it (the ``torch.where`` freeze). It also
    equals its solo solve."""
    fleet = FleetSim(_tcfg(_cfg()), level=LVL, members=2, device="cpu")
    g = fleet.grid
    rng = np.random.default_rng(7)
    # mean-free right-hand sides (the all-Neumann operator is singular):
    # a smooth small one that converges in a few iterations, a rough one
    # that takes many more, under one absolute tolerance
    x, y = g.cell_centers()
    easy = 1e-5 * np.cos(np.pi * x) * np.cos(np.pi * y)
    hard = rng.standard_normal((g.ny, g.nx))
    hard -= hard.mean()
    kw = dict(M=g.mg, tol=1e-8, tol_rel=0.0, max_iter=100,
              max_restarts=0, sum_dtype=g.sum_dtype)

    def solve(bb):
        return tp.bicgstab(g.laplacian, torch.tensor(np.stack(bb)),
                           member_axis=True, **kw)
    both = solve([easy, hard])
    iters = _np(both.iters)
    assert 0 < iters[0] < iters[1], iters
    short = solve([easy, easy])
    assert int(short.iters[0]) == int(iters[0])
    assert torch.equal(both.x[0], short.x[0])
    solo = tp.bicgstab(g.laplacian, torch.tensor(easy), **kw)
    assert int(iters[0]) == solo.iters
    assert bool(both.converged[0]) == solo.converged
    scale = max(1.0, float(solo.x.abs().max()))
    assert _err(both.x[0], solo.x) <= SOLO_BAR * scale
    assert bool(both.converged[1])


# ---------------------------------------------------------------------------
# FleetSim
# ---------------------------------------------------------------------------

def test_fleet_b1_bit_identical_to_uniformsim_equal_pulls():
    """Six steps through the exact startup solves: state, pressure and
    clock bit for bit, in no more device reads."""
    n = 6
    cfg = _tcfg(_cfg())

    def run(fleet):
        if fleet:
            sim = FleetSim(cfg, level=LVL, members=1, device="cpu")
            sim.state = stack_states([taylor_green_state(sim.grid)])
        else:
            sim = UniformSim(cfg, level=LVL, device="cpu")
            sim.state = taylor_green_state(sim.grid)
        p0 = shapes_host.pulls
        for _ in range(n):
            sim.step_once()
        vel, pres = sim.state.vel, sim.state.pres
        return ((vel[0], pres[0]) if fleet else (vel, pres)), sim.time, \
            shapes_host.pulls - p0

    (vu, pu), tu, gu = run(False)
    (vf, pf), tf, gf = run(True)
    assert torch.equal(vu, vf) and torch.equal(pu, pf)
    assert tu == tf
    assert gf <= gu


@pytest.fixture(scope="module")
def tg_runs():
    """Per solver mode: the JAX fleet and the port fleet (the port started
    from the JAX state by ``copy_fleet_state``) over 10 exact startup and 5
    production steps, with their per-step diagnostics and states, and the
    port fleet's state after startup."""
    out = {}
    for mode in ("default", "fas"):
        with pytest.MonkeyPatch.context() as mp:
            _pois(mp, mode)
            cfg = _cfg()
            js = JFleet(cfg, level=LVL, members=3)
            js.state = jtg_fleet(js.grid, 3)
            ts = FleetSim(_tcfg(cfg), level=LVL, members=3, device="cpu")
        copy_fleet_state(js, ts)
        steps = []
        mid = None
        for k in range(STARTUP + PRODUCTION):
            if k == STARTUP:
                mid = (ts.state, ts.times.copy(), ts._next_dt)
            jd = js.step_once()
            td = ts.step_once()
            steps.append((jd, td, np.asarray(js.state.vel),
                          np.asarray(js.state.pres), ts.state.vel,
                          ts.state.pres, js.times.copy(), ts.times.copy()))
        out[mode] = (steps, mid, ts, js)
    return out


@pytest.mark.parametrize("mode", ["default", "fas"])
def test_fleet_matches_jax(mode, tg_runs):
    steps, _, ts, _ = tg_runs[mode]
    assert ts.poisson_mode == ("fas" if mode == "fas" else "bicgstab+mg")
    for k, (jd, td, jv, jpres, tv, tpres, jt, tt) in enumerate(steps):
        assert _err(tv, jv) <= TRAJ_BAR, k
        assert _err(tpres, jpres) <= TRAJ_BAR, k
        assert np.array_equal(td["poisson_iters"],
                              np.asarray(jd["poisson_iters"])), k
        assert np.array_equal(td["poisson_converged"],
                              np.asarray(jd["poisson_converged"])), k
        # the dt rows agree to rounding (umax of states 1e-16 apart)
        assert np.allclose(td["dt"], np.asarray(jd["dt"]), rtol=TRAJ_BAR,
                           atol=0), k
        assert np.allclose(tt, jt, rtol=TRAJ_BAR, atol=0), k
    # the production solves iterate, and the members' clocks differ
    assert (steps[-1][1]["poisson_iters"] > 0).all()
    assert len({float(t) for t in steps[-1][7]}) == 3


@pytest.mark.parametrize("mode", ["default", "fas"])
def test_fleet_members_match_solo_runs(mode, tg_runs, monkeypatch):
    """Each member's production steps against a solo ``UniformSim`` from
    the same post-startup state: <= 1e-12, the same iterations and clock."""
    steps, (st, times, nd), _, _ = tg_runs[mode]
    _pois(monkeypatch, mode)
    for m in range(3):
        solo = UniformSim(_tcfg(_cfg()), level=LVL, device="cpu")
        solo.state = type(st)(*(a[m].clone() for a in st))
        solo.time, solo.step_count = float(times[m]), STARTUP
        solo._next_dt = float(nd[m])
        for k in range(PRODUCTION):
            d = solo.step_once()
            _, td, _, _, tv, tpres, _, tt = steps[STARTUP + k]
            assert d["poisson_iters"] == td["poisson_iters"][m], (m, k)
            assert _err(tv[m], solo.state.vel) <= SOLO_BAR, (m, k)
            assert _err(tpres[m], solo.state.pres) <= SOLO_BAR, (m, k)
            assert abs(tt[m] - solo.time) <= SOLO_BAR, (m, k)


# ---------------------------------------------------------------------------
# the catalog's fleets
# ---------------------------------------------------------------------------

CASE_FLEETS = [("cavity", "default"), ("tgv_periodic", "default"),
               ("tgv_periodic", "fas"), ("tgv_periodic", "fftd")]


@pytest.mark.parametrize("name,mode", CASE_FLEETS,
                         ids=[f"{n}-{m}" for n, m in CASE_FLEETS])
def test_case_fleets_match_jax(name, mode, monkeypatch):
    """``make_sim(name, members=2)`` of both packages, 2 steps from t = 0
    (exact startup solves): <= 1e-10 with equal iterations."""
    _pois(monkeypatch, mode)
    js = jcases.make_sim(name, level=LVL, dtype="float64", members=2)
    ts = tcases.make_sim(name, level=LVL, dtype="float64", members=2,
                         device="cpu")
    assert isinstance(ts, FleetSim) and ts.case == name
    assert (ts.members, ts.bc_table) == (2, js.bc_table)
    assert ts.poisson_mode == js.poisson_mode
    assert _err(ts.state.vel, js.state.vel) == 0.0
    for k in range(2):
        jd = js.step_once()
        td = ts.step_once()
        assert _err(ts.state.vel, js.state.vel) <= TRAJ_BAR, k
        assert _err(ts.state.pres, js.state.pres) <= TRAJ_BAR, k
        assert np.array_equal(td["poisson_iters"],
                              np.asarray(jd["poisson_iters"])), k
        assert np.allclose(ts.times, js.times, rtol=TRAJ_BAR, atol=0)


def test_turb2d_fleet_members_draw_seed_plus_slot():
    ts = tcases.make_sim("turb2d", level=LVL, dtype="float64", members=2,
                         seed=4, device="cpu")
    js = jcases.make_sim("turb2d", level=LVL, dtype="float64", members=2,
                         seed=4)
    assert _err(ts.state.vel, js.state.vel) == 0.0
    solo = tcases.make_sim("turb2d", level=LVL, dtype="float64", seed=5,
                           device="cpu")
    assert torch.equal(ts.state.vel[1], solo.state.vel)


def _shaped_state(grid, m):
    """Member m's shaped session (the JAX package's test state): the
    laddered Taylor-Green flow around a frozen disk moving at a nonzero
    solid velocity, with a small deformation field."""
    xs = (np.arange(grid.nx) + 0.5) * grid.h
    ys = (np.arange(grid.ny) + 0.5) * grid.h
    X, Y = np.meshgrid(xs, ys)
    chi = (((X - (0.35 + 0.1 * m)) ** 2 + (Y - 0.5) ** 2)
           < 0.15 ** 2).astype(np.float64)
    us = np.stack([0.2 * chi, 0.05 * chi])
    udef = 0.02 * np.stack([chi * np.sin(2 * np.pi * Y),
                            chi * np.cos(2 * np.pi * X)])
    base = taylor_green_state(grid)
    return base._replace(vel=base.vel * (0.8 ** m), chi=grid.tensor(chi),
                         us=grid.tensor(us), udef=grid.tensor(udef))


def test_shaped_fleet_members_match_solo_obstacle_step():
    """``FleetSim(shaped=True)``: penalization and the chi-weighted RHS on
    the member axis; each member follows ``UniformGrid.step(obstacle_terms=
    True)`` to <= 1e-12, its dt chain included."""
    B, n = 2, 3
    sim = FleetSim(_tcfg(_cfg(poisson_tol=1e-3, poisson_tol_rel=1e-2)),
                   level=LVL, members=B, shaped=True, device="cpu")
    sim.step_count = 20
    g = sim.grid
    sim.state = stack_states([_shaped_state(g, m) for m in range(B)])
    diag = None
    for _ in range(n):
        diag = sim.step_once()
    for m in range(B):
        st = _shaped_state(g, m)
        dt = float(g.compute_dt(st.vel))
        t = 0.0
        for _ in range(n):
            st, d = g.step(st, torch.tensor(dt, dtype=g.dtype),
                           exact_poisson=False, obstacle_terms=True)
            t += dt
            dt = float(d["dt_next"])
        assert _err(st.vel, sim.state.vel[m]) <= SOLO_BAR, m
        assert _err(st.pres, sim.state.pres[m]) <= SOLO_BAR, m
        assert abs(sim.times[m] - t) <= SOLO_BAR, m
        assert diag["umax"][m] > 0
    assert diag["poisson_iters"][0] >= 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_fleet_checkpoint_roundtrip_times(tmp_path):
    cfg = _tcfg(_cfg())
    sim = FleetSim(cfg, level=LVL, members=3, device="cpu")
    sim.state = taylor_green_fleet(sim.grid, 3)
    sim.step_count = 20
    for _ in range(2):
        sim.step_once()
    tio.save_checkpoint(str(tmp_path / "ck"), sim)
    other = FleetSim(cfg, level=LVL, members=3, device="cpu")
    tio.load_checkpoint(str(tmp_path / "ck"), other)
    assert np.array_equal(other.times, sim.times)
    assert other.time == sim.times.min() and other.step_count == 22
    assert torch.equal(other.state.vel, sim.state.vel)
    with pytest.raises(ValueError, match="fleet members"):
        tio.load_checkpoint(str(tmp_path / "ck"),
                            FleetSim(cfg, level=LVL, members=2, device="cpu"))
    # a checkpoint of one run: every member takes its clock
    solo = UniformSim(cfg, level=LVL, device="cpu")
    solo.state = taylor_green_state(solo.grid)
    solo.step_count = 20
    solo.step_once()
    tio.save_checkpoint(str(tmp_path / "solo"), solo)
    one = FleetSim(cfg, level=LVL, members=1, device="cpu")
    tio.load_checkpoint(str(tmp_path / "solo"), one)
    assert one.times.tolist() == [solo.time] and one.time == solo.time


def test_jax_fleet_checkpoint_steps_on_in_the_port(tmp_path, tg_runs):
    """The JAX fleet's checkpoint after its 15 steps (``tg_runs``) loads
    into a port ``FleetSim``, which then steps on <= 1e-10 of the JAX
    fleet."""
    js = tg_runs["default"][3]
    jio.save_checkpoint(str(tmp_path / "ck"), js)
    ts = FleetSim(_tcfg(js.cfg), level=LVL, members=3, device="cpu")
    tio.load_checkpoint(str(tmp_path / "ck"), ts)
    assert np.array_equal(ts.times, js.times)
    assert ts.step_count == STARTUP + PRODUCTION
    assert _err(ts.state.vel, js.state.vel) == 0.0
    jio.load_checkpoint(str(tmp_path / "ck"), js)    # both re-chain dt
    for _ in range(3):
        jd = js.step_once()
        td = ts.step_once()
        assert _err(ts.state.vel, js.state.vel) <= TRAJ_BAR
        assert np.array_equal(td["poisson_iters"],
                              np.asarray(jd["poisson_iters"]))
    assert np.allclose(ts.times, js.times, rtol=TRAJ_BAR, atol=0)


def test_fleet_refusals():
    cfg = _tcfg(_cfg())
    from cup2d_tpu_torch.parallel.mesh import make_mesh
    placed = FleetSim(cfg, level=LVL, members=2,
                      mesh=make_mesh(devices=["cpu"] * 2))
    assert placed.placement == "member"
    for kw in ({"placement": "member"}, {"member_cells_cap": 1 << 20}):
        sim = FleetSim(cfg, level=LVL, members=2, device="cpu", **kw)
        assert sim.placement == "single" and sim.mesh is None
    with pytest.raises(ValueError, match="members >= 1"):
        FleetSim(cfg, level=LVL, members=0, device="cpu")
    sim = FleetSim(cfg, level=LVL, members=2, device="cpu")
    with pytest.raises(ValueError, match="active mask shape"):
        sim.set_active([True])
    from cup2d_tpu_torch.profiling import PhaseTimers
    sim.timers = PhaseTimers()
    sim.step_once()
    assert set(sim.timers.report()) == {"step"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetSim(cfg, level=LVL, members=2)
