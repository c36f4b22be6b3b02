"""The obstacle terms on the x-split uniform step, f64 on CPU slab meshes
at 32^2: the Brinkman penalization slab by slab and the chi-weighted
divergence term of the split Poisson RHS (``UniformGrid.penalize``,
``shard_halo.divergence_bc_x(chi=, udef=)``), and shaped fleets on spatial
placement.

* ``UniformGrid.step(obstacle_terms=True)`` on D = 2 and 4 slabs, under
  the free-slip, cavity and doubly-periodic tables, default solver and
  fas, from the shaped state of tests/test_fleet_server.py: three
  production steps, <= 1e-10 of the JAX package's
  ``ShardedUniformSim._step(..., obstacle_terms=True)`` on as many devices
  with equal iterations (of its single-device step on the periodic table
  under fas, where its sharded solve is not an oracle), and <= 1e-12 of
  the port's solo step. The split RHS and penalization equal the
  whole-field ones bit for bit.
* ``FleetSim(shaped=True)`` on spatial placement, explicit and chosen by
  ``auto`` (a small ``member_cells_cap``), the state carried from the JAX
  package's spatial shaped fleet with ``convert.copy_fleet_state``: three
  steps, <= 1e-10 of it with equal per-member iterations and dt rows, and
  <= 1e-12 of the port's unplaced shaped fleet.
* A ``FleetServer`` on a shaped spatial pool (admissions, retirements
  with their session checkpoints, one eviction through
  ``FleetStepGuard``, whose retries replay the member's split obstacle
  step) against the unplaced shaped pool: the same events and counts,
  states, clocks and session checkpoints <= 1e-12.
* A spatial shaped fleet's checkpoint loads into an unplaced fleet and
  back, bit for bit."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.fleet import FleetSim as JFleet  # noqa: E402
from cup2d_tpu.fleet import stack_states as jstack  # noqa: E402
from cup2d_tpu.parallel.mesh import ShardedUniformSim as JSharded  # noqa
from cup2d_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from cup2d_tpu.parallel.mesh import shard_state as jshard  # noqa: E402
from cup2d_tpu.uniform import UniformGrid as JGrid  # noqa: E402
from cup2d_tpu.uniform import taylor_green_state as jtg  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch.convert import (bc_from_fields,  # noqa: E402
                                     config_from_dict, copy_fleet_state)
from cup2d_tpu_torch.faults import FaultPlan  # noqa: E402
from cup2d_tpu_torch.fleet import (FleetRequest, FleetServer,  # noqa: E402
                                   FleetSim, stack_states)
from cup2d_tpu_torch.io import whole  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                           shard_state, unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import Slabs  # noqa: E402
from cup2d_tpu_torch.resilience import EventLog  # noqa: E402
from cup2d_tpu_torch.resilience import FleetStepGuard  # noqa: E402
from cup2d_tpu_torch.uniform import UniformGrid  # noqa: E402
from cup2d_tpu_torch.uniform import taylor_green_state  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LVL = 2                   # 32 x 32
B = 3
JAX_BAR = 1e-10
SOLO_BAR = 1e-12
STEPS = 3
DT = 1e-3


def _cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                     max_poisson_iterations=100, poisson_tol=1e-9,
                     poisson_tol_rel=1e-7)


def _tcfg():
    return config_from_dict(dataclasses.asdict(_cfg()))


def _pois(mp, mode):
    if mode == "default":
        mp.delenv("CUP2D_POIS", raising=False)
    else:
        mp.setenv("CUP2D_POIS", mode)


def _shapes(grid, m):
    """Member m's obstacle (the recipe of tests/test_fleet_server.py): the
    laddered Taylor-Green amplitude, a frozen disk moving at a nonzero
    solid velocity, and a divergence-bearing deformation field inside
    it, as numpy arrays."""
    xs = (np.arange(grid.nx) + 0.5) * grid.h
    ys = (np.arange(grid.ny) + 0.5) * grid.h
    X, Y = np.meshgrid(xs, ys)
    chi = (((X - (0.35 + 0.1 * m)) ** 2 + (Y - 0.5) ** 2)
           < 0.15 ** 2).astype(np.float64)
    us = np.stack([0.2 * chi, 0.05 * chi])
    udef = 0.02 * np.stack([chi * np.sin(2 * np.pi * Y),
                            chi * np.cos(2 * np.pi * X)])
    return 0.8 ** m, chi, us, udef


def _shaped_state(grid, m):
    amp, chi, us, udef = _shapes(grid, m)
    base = taylor_green_state(grid)
    return base._replace(vel=base.vel * amp, chi=grid.tensor(chi),
                         us=grid.tensor(us), udef=grid.tensor(udef))


def _jshaped_state(grid, m):
    amp, chi, us, udef = _shapes(grid, m)
    base = jtg(grid)
    return base._replace(vel=base.vel * amp,
                         chi=jnp.asarray(chi, grid.dtype),
                         us=jnp.asarray(us, grid.dtype),
                         udef=jnp.asarray(udef, grid.dtype))


def _mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _max(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# the split uniform step with obstacle terms
# ---------------------------------------------------------------------------

TABLES = {"free_slip": None, "cavity": "cavity_table",
          "tgv_periodic": "periodic_table"}


def _table(pkg, name):
    fn = TABLES[name]
    return None if fn is None else getattr(pkg, fn)()


def _jax_oracle_is_solo(name, mode):
    """The JAX package's sharded fas solve on a periodic table is not an
    oracle: its split hierarchy drops the wrap, so even the obstacle-free
    ``tgv_periodic`` runs 32 cycles where its solo run takes 4 and drifts
    from it (ROADMAP queue 3). There the port's split step is held against
    the single-device JAX step, as tests/test_torch_mesh_periodic.py
    holds the obstacle-free one."""
    return name == "tgv_periodic" and mode == "fas"


@functools.lru_cache(maxsize=None)
def _jax_split_steps(name, mode, D):
    """Per step of the JAX package's sharded step with obstacle terms
    (its single-device step where ``_jax_oracle_is_solo``): (vel, pres,
    iterations)."""
    mp = pytest.MonkeyPatch()
    _pois(mp, mode)
    try:
        if _jax_oracle_is_solo(name, mode):
            g = JGrid(_cfg(), level=LVL, bc=_table(jcases, name))
            step = jax.jit(g.step, static_argnames=("exact_poisson",
                                                    "obstacle_terms"))
            st = _jshaped_state(g, 1)
        else:
            js = JSharded(_cfg(), jmake_mesh(D), level=LVL,
                          bc=_table(jcases, name))
            step = js._step
            st = jshard(_jshaped_state(js.grid, 1), js.mesh)
        out = []
        for _ in range(STEPS):
            st, d = step(st, jnp.asarray(DT), exact_poisson=False,
                         obstacle_terms=True)
            out.append((np.asarray(st.vel), np.asarray(st.pres),
                        int(d["poisson_iters"])))
        return out
    finally:
        mp.undo()


SPLIT = [(n, m, D) for n in TABLES for m in ("default", "fas")
         for D in (2, 4)]


@pytest.mark.parametrize("name,mode,D", SPLIT,
                         ids=[f"{n}-{m}-{D}" for n, m, D in SPLIT])
def test_split_obstacle_step_matches_jax_and_solo(monkeypatch, name, mode,
                                                  D):
    refs = _jax_split_steps(name, mode, D)
    _pois(monkeypatch, mode)
    jt = _table(jcases, name)
    bc = None if jt is None else bc_from_fields(jt)
    solo = UniformGrid(_tcfg(), level=LVL, device="cpu", bc=bc)
    split = UniformGrid(_tcfg(), level=LVL, device="cpu", bc=bc)
    split.attach_mesh(_mesh(D))
    st = _shaped_state(solo, 1)
    ss = shard_state(st, split.mesh)
    assert all(isinstance(f, Slabs) for f in ss)
    dt = torch.tensor(DT, dtype=torch.float64)
    for k, (jv, jp, jit) in enumerate(refs):
        st, d = solo.step(st, dt, obstacle_terms=True)
        ss, ds = split.step(ss, dt, obstacle_terms=True)
        w = unshard_state(ss)
        assert int(ds["poisson_iters"]) == int(d["poisson_iters"]) == jit, \
            (k, int(ds["poisson_iters"]), int(d["poisson_iters"]), jit)
        assert float((w.vel - st.vel).abs().max()) <= SOLO_BAR, k
        assert float((w.pres - st.pres).abs().max()) <= SOLO_BAR, k
        assert _max(w.vel.numpy(), jv) <= JAX_BAR, k
        assert _max(w.pres.numpy(), jp) <= JAX_BAR, k
        # the solid fields are frozen: the step hands them back as given
        for a in ("chi", "us", "udef"):
            assert torch.equal(whole(getattr(ss, a)), getattr(st, a)), a
    assert refs[0][2] > 0


def test_split_rhs_obstacle_term_equals_whole_field_bit_for_bit():
    """The split RHS with chi and udef is the whole-field RHS bit for bit,
    on every table, with the member axis and a dt per member too."""
    dt = torch.tensor([1e-3, 2e-3], dtype=torch.float64)[:, None, None]
    for name in TABLES:
        jt = _table(jcases, name)
        bc = None if jt is None else bc_from_fields(jt)
        g = UniformGrid(_tcfg(), level=LVL, device="cpu", bc=bc)
        gs = UniformGrid(_tcfg(), level=LVL, device="cpu", bc=bc)
        gs.attach_mesh(_mesh(4))
        st = stack_states([_shaped_state(g, m) for m in range(2)])
        want = g.poisson_rhs(st.vel, st.chi, st.udef, dt)
        sp = shard_state(st, gs.mesh)
        got = whole(gs.poisson_rhs(sp.vel, sp.chi, sp.udef, dt))
        assert torch.equal(got, want), name
        pen = whole(gs.penalize(sp.vel, sp.chi, sp.us, dt))
        assert torch.equal(pen, g.penalize(st.vel, st.chi, st.us, dt)), name
        assert not torch.equal(want, g.poisson_rhs(st.vel, None, None, dt))


# ---------------------------------------------------------------------------
# shaped fleets on spatial placement
# ---------------------------------------------------------------------------

def _jfleet(D, name):
    js = JFleet(_cfg(), level=LVL, members=B, shaped=True,
                mesh=None if D is None else jmake_mesh(D),
                placement="spatial", bc=_table(jcases, name))
    js.state = jstack([_jshaped_state(js.grid, m) for m in range(B)])
    js.step_count = 20
    return js


FLEETS = [("free_slip", m, D, pl) for m in ("default", "fas")
          for D, pl in ((2, "spatial"), (4, "auto"))] + [
    ("cavity", "fas", 4, "spatial")]


@pytest.mark.parametrize("name,mode,D,placement", FLEETS,
                         ids=[f"{n}-{m}-{D}-{p}" for n, m, D, p in FLEETS])
def test_shaped_spatial_fleet_matches_jax_and_unplaced(monkeypatch, name,
                                                       mode, D, placement):
    _pois(monkeypatch, mode)
    js = _jfleet(D, name)
    jt = _table(jcases, name)
    bc = None if jt is None else bc_from_fields(jt)
    sim = FleetSim(_tcfg(), level=LVL, members=B, shaped=True,
                   mesh=_mesh(D), placement=placement, member_cells_cap=0,
                   bc=bc)
    plain = FleetSim(_tcfg(), level=LVL, members=B, shaped=True,
                     device="cpu", bc=bc)
    assert sim.placement == "spatial"
    copy_fleet_state(js, sim)
    copy_fleet_state(js, plain)
    assert all(isinstance(f, Slabs) for f in sim.state)
    for k in range(STEPS):
        jd, d, pd = js.step_once(), sim.step_once(), plain.step_once()
        assert np.array_equal(d["poisson_iters"],
                              np.asarray(jd["poisson_iters"])), k
        assert np.array_equal(d["poisson_iters"], pd["poisson_iters"]), k
        assert np.allclose(d["dt"], np.asarray(jd["dt"]), rtol=JAX_BAR,
                           atol=0), k
        assert np.allclose(d["dt"], pd["dt"], rtol=SOLO_BAR, atol=0), k
        for a, j, p in zip(sim.state, js.state, plain.state):
            a = whole(a)
            assert _max(a.numpy(), j) <= JAX_BAR, k
            assert float((a - p).abs().max()) <= SOLO_BAR, k
        assert np.allclose(sim.times, js.times, rtol=JAX_BAR, atol=0), k
    assert (np.asarray(jd["poisson_iters"]) > 0).all()
    # the guard's solo replay of a shaped member runs the split obstacle
    # step on the member's slabs
    st0 = plain.member_state(1)
    sd = sim.member_step_once(1, dt=DT)
    pd = plain.member_step_once(1, dt=DT)
    assert int(sd["poisson_iters"]) == int(pd["poisson_iters"])
    for a, p, s in zip(sim.member_state(1), plain.member_state(1), st0):
        assert isinstance(a, Slabs)
        assert float((whole(a) - p).abs().max()) <= SOLO_BAR
    assert not torch.equal(plain.member_state(1).vel, st0.vel)


# ---------------------------------------------------------------------------
# the serving pool and checkpoints
# ---------------------------------------------------------------------------

def _serve(tmp_path, mesh, spec, tag):
    """Six shaped sessions through a three-slot pool (staggered horizons,
    so slots retire and refill), the guard's eviction rung armed by
    ``spec``."""
    sim = FleetSim(_tcfg(), level=LVL, members=B, shaped=True, mesh=mesh,
                   placement="spatial" if mesh else "auto",
                   device=None if mesh else "cpu")
    sim.step_count = 20
    log = EventLog(str(tmp_path / f"{tag}.jsonl"))
    guard = FleetStepGuard(sim, event_log=log,
                           faults=FaultPlan(spec) if spec else None)
    server = FleetServer(sim, guard=guard, event_log=log,
                         session_dir=str(tmp_path / f"sessions_{tag}"))
    dt0 = float(sim.grid.dt_from_umax(
        _shaped_state(sim.grid, 0).vel.abs().max()))
    for i in range(6):
        server.submit(FleetRequest(client_id=f"s{i}",
                                   state=_shaped_state(sim.grid, i % 3),
                                   t_end=(2.5 + i) * dt0))
    server.drain(max_steps=12)
    log.close()
    return sim, server


def _events(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items()
                 if k not in ("ts", "wall", "checkpoint")}
                for ln in f if ln.strip()]


def _close(a, b, bar):
    """Equal structure, floats within ``bar`` (event rows carry clocks;
    an aborted member's NaN rows match NaN)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], bar)
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y, bar)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= bar
    return a == b


@pytest.mark.parametrize("spec", [None, "nan_vel@22*3"])
def test_shaped_spatial_pool_equals_unplaced_pool(tmp_path, spec):
    sim_u, srv_u = _serve(tmp_path, None, spec, "u")
    sim_p, srv_p = _serve(tmp_path, _mesh(2), spec, "p")
    assert sim_p.placement == "spatial"
    for a, b in zip(sim_p.state, sim_u.state):
        assert float((whole(a) - b).abs().max()) <= SOLO_BAR
    assert np.allclose(sim_p.times, sim_u.times, rtol=SOLO_BAR, atol=0)
    assert (srv_p.admitted, srv_p.retired, srv_p.evicted) == (
        srv_u.admitted, srv_u.retired, srv_u.evicted)
    assert srv_u.retired >= 2 and srv_u.evicted == (1 if spec else 0)
    ev_u, ev_p = _events(tmp_path / "u.jsonl"), _events(tmp_path / "p.jsonl")
    assert _close(ev_p, ev_u, SOLO_BAR)
    if spec:
        assert [e.get("action") for e in ev_u
                if e["event"] in ("recovery", "member_aborted")] == [
            "retry", "escalate", "evict"]
    names = sorted(os.listdir(tmp_path / "sessions_u"))
    assert names == sorted(os.listdir(tmp_path / "sessions_p"))
    for cid in names:
        st_u, m_u = tio.load_member_checkpoint(
            str(tmp_path / "sessions_u" / cid), sim_u.grid)
        st_p, m_p = tio.load_member_checkpoint(
            str(tmp_path / "sessions_p" / cid), sim_p.grid)
        for a, b in zip(st_u, st_p):
            assert float((a - b).abs().max()) <= SOLO_BAR, cid
        assert torch.equal(st_u.chi, st_p.chi), cid
        assert abs(m_u["time"] - m_p["time"]) <= SOLO_BAR
        assert abs(m_u["next_dt"] - m_p["next_dt"]) <= SOLO_BAR


def test_shaped_spatial_checkpoint_loads_unplaced_and_back(tmp_path):
    placed = FleetSim(_tcfg(), level=LVL, members=B, shaped=True,
                      mesh=_mesh(2), placement="spatial")
    placed.set_state(stack_states([_shaped_state(placed.grid, m)
                                   for m in range(B)]))
    placed.step_count = 20
    for _ in range(2):
        placed.step_once()
    tio.save_checkpoint(str(tmp_path / "p"), placed)
    plain = FleetSim(_tcfg(), level=LVL, members=B, shaped=True,
                     device="cpu")
    tio.load_checkpoint(str(tmp_path / "p"), plain)
    for a, b in zip(placed.state, plain.state):
        assert torch.equal(whole(a), b)
    assert np.array_equal(plain.times, placed.times)
    assert plain.step_count == placed.step_count
    plain.step_once()
    tio.save_checkpoint(str(tmp_path / "u"), plain)
    back = FleetSim(_tcfg(), level=LVL, members=B, shaped=True,
                    mesh=_mesh(4), placement="spatial")
    tio.load_checkpoint(str(tmp_path / "u"), back)
    for a, b in zip(back.state, plain.state):
        assert isinstance(a, Slabs)
        assert torch.equal(whole(a), b)
    assert np.array_equal(back.times, plain.times)
    assert float(plain.state.chi.sum()) > 0


def test_no_obstacle_refusal_left_in_the_port():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cup2d_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert "obstacle terms of the split step are not" not in src
                assert "has no obstacle terms" not in src
