"""Fleets placed on a slab mesh (``FleetSim(mesh=, placement=,
member_cells_cap=)``), f64 on CPU meshes at 32^2, B = 4.

* Member placement (whole members along the mesh, B/D a device) and
  spatial placement (every member split along x, the member axis riding
  the halo kernels) on D = 2 and 4, of Taylor-Green, ``turb2d`` and
  cavity fleets under the default solver and fas: one exact startup step
  and two production steps, <= 1e-10 of the single-device JAX
  ``FleetSim`` with equal per-member iterations and dt rows, and of the
  unplaced port fleet bit for bit (member placement) or <= 1e-12 (spatial:
  the per-member reductions combine per-shard partials).
* ``auto`` placement and the reference's placement errors, message for
  message; a shaped fleet takes spatial placement.
* A placed fleet's checkpoint loads into an unplaced fleet and the other
  way round, bit for bit.
* On member placement a ``FleetStepGuard`` eviction drill and a
  ``FleetServer`` serving run (admissions, retirements with their session
  checkpoints, the eviction) equal the unplaced pool's bit for bit.
* The CLI: ``-case cavity -fleet 4 -mesh 2`` writes the unplaced CLI's
  dumps bit for bit, ``-serve`` serves through the placed pool, and
  ``-fleet`` with ``-mesh`` and no ``-case`` exits 2 with the reference's
  message."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.fleet import FleetSim as JFleet  # noqa: E402
from cup2d_tpu.fleet import taylor_green_fleet as jtg_fleet  # noqa: E402
from cup2d_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from cup2d_tpu_torch import __main__ as tmain  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.convert import copy_fleet_state  # noqa: E402
from cup2d_tpu_torch.faults import FaultPlan  # noqa: E402
from cup2d_tpu_torch.fleet import FleetRequest  # noqa: E402
from cup2d_tpu_torch.fleet import FleetServer  # noqa: E402
from cup2d_tpu_torch.fleet import FleetSim  # noqa: E402
from cup2d_tpu_torch.io import whole  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cup2d_tpu_torch.parallel.shard_halo import Blocks, Slabs  # noqa: E402
from cup2d_tpu_torch.resilience import EventLog  # noqa: E402
from cup2d_tpu_torch.resilience import FleetStepGuard  # noqa: E402
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
B = 4
JAX_BAR = 1e-10
SOLO_BAR = 1e-12
STEPS = 3                 # one exact startup step, two production steps


def _mesh(D):
    return make_mesh(devices=["cpu"] * D)


def _tg_cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                     max_poisson_iterations=100, poisson_tol=1e-9,
                     poisson_tol_rel=1e-7)


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _pois(mp, mode):
    if mode == "default":
        mp.delenv("CUP2D_POIS", raising=False)
    else:
        mp.setenv("CUP2D_POIS", mode)


def _fields(sim):
    return [whole(f) for f in sim.state]


def _build(case, pkg, mesh=None, placement="auto", cap=1 << 22):
    """A B-member fleet of ``case`` at t = 0, one step before the end of
    the exact startup solves."""
    if case == "tg":
        if pkg == "jax":
            sim = JFleet(_tg_cfg(), level=LVL, members=B)
            sim.state = jtg_fleet(sim.grid, B)
        else:
            sim = FleetSim(_tcfg(_tg_cfg()), level=LVL, members=B,
                           mesh=mesh, placement=placement,
                           member_cells_cap=cap,
                           device=None if mesh else "cpu")
            from cup2d_tpu_torch.fleet import taylor_green_fleet
            sim.set_state(taylor_green_fleet(sim.grid, B))
    elif pkg == "jax":
        sim = jcases.make_sim(case, level=LVL, dtype="float64", members=B)
    elif mesh is None:
        sim = tcases.make_sim(case, level=LVL, dtype="float64", members=B,
                              device="cpu")
    elif placement == "auto" and cap == 1 << 22:
        sim = tcases.make_sim(case, level=LVL, dtype="float64", members=B,
                              mesh=mesh)
    else:
        ref = tcases.make_sim(case, level=LVL, dtype="float64", members=B,
                              device="cpu")
        sim = FleetSim(ref.cfg, level=LVL, members=B, mesh=mesh,
                       placement=placement, member_cells_cap=cap,
                       bc=ref.grid.bc)
        sim.set_state(ref.state)
    sim.step_count = 9
    return sim


@functools.lru_cache(maxsize=None)
def _references(case, mode):
    """Per step: (JAX fields, unplaced port fields, JAX diag, port diag,
    JAX clocks, port clocks)."""
    mp = pytest.MonkeyPatch()
    _pois(mp, mode)
    try:
        js, ts = _build(case, "jax"), _build(case, "torch")
        out = []
        for _ in range(STEPS):
            jd, td = js.step_once(), ts.step_once()
            out.append(([np.asarray(f) for f in js.state], _fields(ts),
                        jd, td, js.times.copy(), ts.times.copy()))
        return out
    finally:
        mp.undo()


PLACED = [("tg", m, D, pl) for m in ("default", "fas") for D in (2, 4)
          for pl in ("member", "spatial")] + [
    ("turb2d", m, D, pl) for m in ("default", "fas")
    for D, pl in ((4, "member"), (2, "spatial"))] + [
    ("cavity", m, D, pl) for m in ("default", "fas")
    for D, pl in ((2, "auto"), (4, "spatial"))]


@pytest.mark.parametrize("case,mode,D,placement", PLACED,
                         ids=[f"{c}-{m}-{D}-{p}" for c, m, D, p in PLACED])
def test_placed_fleet_matches_jax_and_unplaced(monkeypatch, case, mode, D,
                                               placement):
    refs = _references(case, mode)
    _pois(monkeypatch, mode)
    sim = _build(case, "torch", _mesh(D), placement,
                 cap=0 if placement == "spatial" else 1 << 22)
    want = "member" if placement == "auto" else placement
    assert sim.placement == want
    kind = Blocks if want == "member" else Slabs
    assert all(isinstance(f, kind) for f in sim.state)
    for k, (jf, tf, jd, td, jt, tt) in enumerate(refs):
        d = sim.step_once()
        assert np.array_equal(d["poisson_iters"],
                              np.asarray(jd["poisson_iters"])), k
        assert np.array_equal(d["poisson_iters"], td["poisson_iters"]), k
        assert np.allclose(d["dt"], np.asarray(jd["dt"]), rtol=JAX_BAR,
                           atol=0), k
        for a, j, t in zip(_fields(sim), jf, tf):
            assert np.max(np.abs(a.numpy() - j)) <= JAX_BAR, k
            if want == "member":
                assert torch.equal(a, t), k
            else:
                assert float((a - t).abs().max()) <= SOLO_BAR, k
        assert np.allclose(sim.times, jt, rtol=JAX_BAR, atol=0), k
        if want == "member":
            assert np.array_equal(sim.times, tt), k
    assert (refs[-1][2]["poisson_iters"] > 0).all()


def test_placement_policy_and_errors():
    cfg, tcfg = _tg_cfg(), _tcfg(_tg_cfg())
    for members, D, cap, want in ((4, 2, 1 << 22, "member"),
                                  (4, 4, 1 << 22, "member"),
                                  (3, 2, 1 << 22, "spatial"),
                                  (4, 2, 0, "spatial")):
        sim = FleetSim(tcfg, level=LVL, members=members, mesh=_mesh(D),
                       member_cells_cap=cap)
        js = JFleet(cfg, level=LVL, members=members, mesh=jmake_mesh(D),
                    member_cells_cap=cap)
        assert sim.placement == js.placement == want
    assert FleetSim(tcfg, level=LVL, members=2,
                    device="cpu").placement == "single"
    for members, D, placement in ((3, 2, "member"), (4, 3, "spatial"),
                                  (4, 3, "auto")):
        with pytest.raises(ValueError) as te:
            FleetSim(tcfg, level=LVL, members=members, mesh=_mesh(D),
                     placement=placement)
        with pytest.raises(ValueError) as je:
            JFleet(cfg, level=LVL, members=members, mesh=jmake_mesh(D),
                   placement=placement)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="auto|member|spatial"):
        FleetSim(tcfg, level=LVL, members=4, mesh=_mesh(2),
                 placement="rows")
    with pytest.raises(ValueError, match="not both"):
        FleetSim(tcfg, level=LVL, members=4, mesh=_mesh(2), device="meta")
    shaped = FleetSim(tcfg, level=LVL, members=4, mesh=_mesh(2),
                      shaped=True, placement="spatial")
    assert shaped.placement == "spatial"
    assert all(isinstance(f, Slabs) for f in shaped.state)


@pytest.mark.parametrize("placement", ["member", "spatial"])
def test_placed_checkpoint_loads_unplaced_and_back(tmp_path, placement):
    tcfg = _tcfg(_tg_cfg())
    from cup2d_tpu_torch.fleet import taylor_green_fleet
    placed = FleetSim(tcfg, level=LVL, members=B, mesh=_mesh(2),
                      placement=placement)
    placed.set_state(taylor_green_fleet(placed.grid, B))
    placed.step_count = 20
    for _ in range(2):
        placed.step_once()
    tio.save_checkpoint(str(tmp_path / "p"), placed)
    plain = FleetSim(tcfg, level=LVL, members=B, device="cpu")
    tio.load_checkpoint(str(tmp_path / "p"), plain)
    for a, b in zip(_fields(placed), plain.state):
        assert torch.equal(a, b)
    assert np.array_equal(plain.times, placed.times)
    assert plain.step_count == placed.step_count
    plain.step_once()
    tio.save_checkpoint(str(tmp_path / "u"), plain)
    back = FleetSim(tcfg, level=LVL, members=B, mesh=_mesh(4),
                    placement=placement)
    tio.load_checkpoint(str(tmp_path / "u"), back)
    assert back.placement == placement
    for a, b in zip(_fields(back), plain.state):
        assert torch.equal(a, b)
    assert np.array_equal(back.times, plain.times)
    # the port's fleets of any placement carry each other
    other = FleetSim(tcfg, level=LVL, members=B, device="cpu")
    copy_fleet_state(back, other)
    for a, b in zip(_fields(back), other.state):
        assert torch.equal(a, b)


def _session_state(grid, m):
    st = taylor_green_state(grid)
    return st._replace(vel=st.vel * (0.8 ** m))


def _serve(tmp_path, mesh, spec, tag):
    """Six sessions through a four-slot pool (staggered horizons, so slots
    retire and refill), the guard's eviction rung armed by ``spec``."""
    sim = FleetSim(_tcfg(_tg_cfg()), level=LVL, members=B, mesh=mesh,
                   placement="member" if mesh else "auto",
                   device=None if mesh else "cpu")
    sim.step_count = 20
    log = EventLog(str(tmp_path / f"{tag}.jsonl"))
    guard = FleetStepGuard(sim, event_log=log,
                           faults=FaultPlan(spec) if spec else None)
    server = FleetServer(sim, guard=guard, event_log=log,
                         session_dir=str(tmp_path / f"sessions_{tag}"))
    dt0 = float(sim.grid.compute_dt(_session_state(sim.grid, 0).vel))
    for i in range(6):
        server.submit(FleetRequest(client_id=f"s{i}",
                                   state=_session_state(sim.grid, i % 3),
                                   t_end=(2.5 + i) * dt0))
    server.drain(max_steps=12)
    log.close()
    return sim, server


@pytest.mark.parametrize("spec", [None, "nan_vel@22*3"])
def test_member_placed_pool_equals_unplaced_pool(tmp_path, spec):
    sim_u, srv_u = _serve(tmp_path, None, spec, "u")
    sim_p, srv_p = _serve(tmp_path, _mesh(2), spec, "p")
    assert sim_p.placement == "member"
    for a, b in zip(_fields(sim_p), sim_u.state):
        assert torch.equal(a, b)
    assert np.array_equal(sim_p.times, sim_u.times)
    assert (srv_p.admitted, srv_p.retired, srv_p.evicted) == (
        srv_u.admitted, srv_u.retired, srv_u.evicted)
    assert srv_u.retired >= 2 and srv_u.evicted == (1 if spec else 0)

    def events(tag):
        with open(tmp_path / f"{tag}.jsonl") as f:
            return [{k: v for k, v in json.loads(ln).items()
                     if k not in ("ts", "wall", "checkpoint")}
                    for ln in f if ln.strip()]
    assert events("p") == events("u")
    for cid in sorted(os.listdir(tmp_path / "sessions_u")):
        st_u, m_u = tio.load_member_checkpoint(
            str(tmp_path / "sessions_u" / cid), sim_u.grid)
        st_p, m_p = tio.load_member_checkpoint(
            str(tmp_path / "sessions_p" / cid), sim_p.grid)
        assert all(torch.equal(a, b) for a, b in zip(st_u, st_p)), cid
        assert (m_u["time"], m_u["next_dt"]) == (m_p["time"],
                                                m_p["next_dt"])


def _cli(out, *flags):
    return tmain.main(["-case", "cavity", "-level", "2", "-device", "cpu",
                       "-dtype", "float64", "-maxSteps", "4", "-tdump",
                       "0.01", "-noMetrics", "-output", str(out), *flags])


def test_cli_case_fleet_on_a_mesh(tmp_path, capsys):
    assert _cli(tmp_path / "u", "-fleet", "4") == 0
    assert _cli(tmp_path / "p", "-fleet", "4", "-mesh", "2") == 0
    dumps = sorted(n for n in os.listdir(tmp_path / "u")
                   if n.startswith("vel."))
    assert len(dumps) >= 8
    assert dumps == sorted(n for n in os.listdir(tmp_path / "p")
                           if n.startswith("vel."))
    for n in dumps:
        a = open(tmp_path / "u" / n, "rb").read()
        assert a == open(tmp_path / "p" / n, "rb").read(), n
    assert _cli(tmp_path / "s", "-fleet", "2", "-mesh", "2", "-serve", "3",
                "-tend", "0.02", "-tdump", "0") == 0
    assert "served 3 session(s)" in capsys.readouterr().err
    assert len(os.listdir(tmp_path / "s" / "sessions")) == 3
    assert tmain.main(["-level", "2", "-device", "cpu", "-fleet", "4",
                       "-mesh", "2", "-output",
                       str(tmp_path / "r")]) == 2
    err = capsys.readouterr().err
    assert ("-fleet has its own placement policy (fleet.py) and does not "
            "combine with -mesh") in err
    assert "item 8" not in err
