"""Fleets across processes (``FleetSim`` on ``parallel.launch.world_mesh``),
gloo on the CPU: worlds of 2 ranks, 2 shards each (a 4-shard mesh),
spawned with ``subprocess`` on a free port; the worker is this file run as
a script (``python tests/test_torch_fleet_dist.py <scenario> <rank>
<world> <port> <dir>``), and every world has a hard timeout.

* Member and spatial placement, default and fas, of Taylor-Green and
  ``turb2d`` fleets, and spatial placement of a shaped Taylor-Green fleet
  (frozen disks, the obstacle terms on the split step) (B = 4, 32^2,
  f64) carried from the JAX package's
  state after its exact startup step (``convert.copy_fleet_state``): two
  production steps bit for bit the one-process 4-shard placed fleet and
  the same on both ranks, within 1e-10 of the single-device JAX
  ``FleetSim`` with equal per-member iterations.
* ``cases.make_sim(name, members=4, mesh=<world mesh>)`` for every
  fleet-capable case: two steps bit for bit the one-process mesh's.
* A ``FleetServer`` run (six sessions through the four slots, staggered
  horizons) whose session checkpoints rank 0 writes, one of them resumed
  into a fresh pool; and a ``FleetStepGuard`` drill under ``nan_vel@22``
  (a retry) and ``nan_vel@22*3`` (an eviction), the verdicts agreed on
  both ranks: fields, clocks, counts, events and session checkpoints
  equal the one-process pool's.
* The CLI ``-case cavity -fleet 4 -mesh 4`` over 2 ranks
  (``-coordinator -meshHosts 2 -processId r``): per-member dumps
  byte-equal to the one-process run's, events and metrics from rank 0."""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORLD_TIMEOUT = 240      # hard limit of one spawned world, seconds
LVL = 2                  # 32 x 32
B = 4
SHARDS = 4
JAX_BAR = 1e-10
PROD_STEPS = 2
RUNS = [(case, mode, pl) for case in ("tg", "turb2d")
        for mode in ("default", "fas") for pl in ("member", "spatial")] + [
    ("shaped", mode, "spatial") for mode in ("default", "fas")]
CASES = ("tg", "turb2d", "shaped")
FIELDS = ("vel", "pres")


def _tag(case, mode, pl):
    return f"{case}-{mode}-{pl}"


# ---------------------------------------------------------------------------
# the runs, shared by the workers (a world mesh) and the test process (the
# one-process 4-shard mesh)
# ---------------------------------------------------------------------------

def _tg_kw():
    return dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                max_poisson_iterations=100, poisson_tol=1e-9,
                poisson_tol_rel=1e-7)


def _pois(mode):
    if mode == "default":
        os.environ.pop("CUP2D_POIS", None)
    else:
        os.environ["CUP2D_POIS"] = mode


def _fleet(case, mesh, placement):
    """A B-member port fleet of ``case`` on ``mesh`` (None: unplaced on
    the CPU) at its t = 0 state."""
    from cup2d_tpu_torch import cases
    from cup2d_tpu_torch.config import SimConfig
    from cup2d_tpu_torch.fleet import FleetSim, taylor_green_fleet
    if case in ("tg", "shaped"):
        sim = FleetSim(SimConfig(**_tg_kw()), level=LVL, members=B,
                       shaped=case == "shaped", mesh=mesh,
                       placement=placement, device=None if mesh else "cpu")
        sim.set_state(taylor_green_fleet(sim.grid, B))
        return sim
    ref = cases.make_sim(case, level=LVL, dtype="float64", members=B,
                         device="cpu")
    if mesh is None:
        return ref
    sim = FleetSim(ref.cfg, level=LVL, members=B, mesh=mesh,
                   placement=placement, bc=ref.grid.bc)
    sim.set_state(ref.state)
    return sim


def carried_run(case, mode, placement, mesh, carry: dict) -> dict:
    """``PROD_STEPS`` production steps from the carried state: per step the
    whole fields, the iterations, the dt row and the clocks."""
    from cup2d_tpu_torch.convert import copy_fleet_state
    from cup2d_tpu_torch.io import whole
    from cup2d_tpu_torch.uniform import FlowState
    _pois(mode)
    try:
        sim = _fleet(case, mesh, placement)
        src = types.SimpleNamespace(
            members=B, state=FlowState(*(carry[k] for k in FlowState._fields)),
            times=carry["times"], time=float(carry["times"].min()),
            step_count=int(carry["step_count"]),
            _next_dt=carry["next_dt"])
        copy_fleet_state(src, sim)
        out = {"placement": np.asarray(sim.placement)}
        for k in range(PROD_STEPS):
            d = sim.step_once()
            for name, f in zip(FlowState._fields, sim.state):
                out[f"{k}/{name}"] = whole(f).numpy()
            out[f"{k}/iters"] = np.asarray(d["poisson_iters"])
            out[f"{k}/dt"] = np.asarray(d["dt"])
            out[f"{k}/times"] = sim.times.copy()
        return out
    finally:
        os.environ.pop("CUP2D_POIS", None)


def catalog_run(mesh) -> dict:
    """Every fleet-capable catalog case as a 4-member fleet on ``mesh``
    (``cases.make_sim(mesh=)``): its placement and the whole fields after
    two steps."""
    from cup2d_tpu_torch import cases
    from cup2d_tpu_torch.io import whole
    out = {}
    for name, spec in sorted(cases.REGISTRY.items()):
        if not spec.fleet_ok:
            continue
        sim = cases.make_sim(name, level=2, dtype="float64", members=B,
                             mesh=mesh)
        for _ in range(2):
            sim.step_once()
        out[f"{name}/placement"] = np.asarray(sim.placement)
        for k, f in zip(FIELDS, sim.state):
            out[f"{name}/{k}"] = whole(f).numpy()
    return out


def _session_state(grid, m):
    from cup2d_tpu_torch.uniform import taylor_green_state
    st = taylor_green_state(grid)
    return st._replace(vel=st.vel * (0.8 ** m))


def serve_run(mesh, outdir: str, spec) -> dict:
    """Six sessions through a four-slot member-placed pool (staggered
    horizons: slots retire and refill), the guard's ladder armed by
    ``spec``; then the first session resumed from its checkpoint into a
    fresh pool for two steps."""
    from cup2d_tpu_torch.config import SimConfig
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.fleet import FleetRequest, FleetServer, FleetSim
    from cup2d_tpu_torch.io import whole
    from cup2d_tpu_torch.resilience import EventLog, FleetStepGuard

    def pool():
        return FleetSim(SimConfig(**_tg_kw()), level=LVL, members=B,
                        mesh=mesh, placement="member" if mesh else "auto",
                        device=None if mesh else "cpu")
    sim = pool()
    sim.step_count = 20
    log = EventLog(os.path.join(outdir, "events.jsonl"))
    guard = FleetStepGuard(sim, event_log=log,
                           faults=FaultPlan(spec) if spec else None)
    server = FleetServer(sim, guard=guard, event_log=log,
                         session_dir=os.path.join(outdir, "sessions"))
    dt0 = float(sim.grid.compute_dt(_session_state(sim.grid, 0).vel))
    for i in range(6):
        server.submit(FleetRequest(client_id=f"s{i}",
                                   state=_session_state(sim.grid, i % 3),
                                   t_end=(2.5 + i) * dt0))
    server.drain(max_steps=12)
    log.close()
    out = {f"pool/{k}": whole(f).numpy()
           for k, f in zip(FIELDS, sim.state)}
    out["pool/times"] = sim.times.copy()
    out["pool/counts"] = np.asarray([server.admitted, server.retired,
                                     server.evicted])
    # the resumed session: a fresh pool admits s1 from its checkpoint
    sim2 = pool()
    sim2.step_count = 40
    srv2 = FleetServer(sim2)
    srv2.submit(FleetRequest(client_id="s1", checkpoint=os.path.join(
        outdir, "sessions", "s1")))
    for _ in range(2):
        srv2.step()
    out.update({f"resumed/{k}": whole(f).numpy()
                for k, f in zip(FIELDS, sim2.state)})
    out["resumed/times"] = sim2.times.copy()
    return out


def guard_run(mesh, outdir: str, spec: str) -> dict:
    """Four supervised steps of a member-placed Taylor-Green fleet from
    step 20 under ``spec``."""
    from cup2d_tpu_torch.config import SimConfig
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.fleet import FleetSim, taylor_green_fleet
    from cup2d_tpu_torch.io import whole
    from cup2d_tpu_torch.resilience import EventLog, FleetStepGuard
    sim = FleetSim(SimConfig(**_tg_kw()), level=LVL, members=B, mesh=mesh,
                   placement="member" if mesh else "auto",
                   device=None if mesh else "cpu")
    sim.set_state(taylor_green_fleet(sim.grid, B))
    sim.step_count = 20
    log = EventLog(os.path.join(outdir, "guard.jsonl"))
    guard = FleetStepGuard(sim, event_log=log, faults=FaultPlan(spec))
    for _ in range(4):
        guard.step()
    log.close()
    out = {f"guard/{k}": whole(f).numpy()
           for k, f in zip(FIELDS, sim.state)}
    out["guard/times"] = sim.times.copy()
    return out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _worker(scenario: str, rank: int, world: int, port: int,
            outdir: str) -> dict:
    torch.set_num_threads(1)
    from cup2d_tpu_torch.parallel.launch import (init_distributed,
                                                 shutdown_distributed,
                                                 world_mesh)
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            expected_processes=world, device="cpu",
                            timeout=120.0) == rank
    try:
        mesh = world_mesh(SHARDS, "cpu")
        res = {"local": list(mesh.local)}
        arrays = {}
        if scenario == "fleet":
            for case, mode, pl in RUNS:
                tag = _tag(case, mode, pl)
                with np.load(os.path.join(outdir, f"carry-{case}-{mode}"
                                                  ".npz")) as c:
                    carry = dict(c)
                arrays.update({f"{tag}/{k}": v for k, v in carried_run(
                    case, mode, pl, mesh, carry).items()})
            arrays.update({f"catalog/{k}": v
                           for k, v in catalog_run(mesh).items()})
        elif scenario == "serve":
            for spec in (None, "nan_vel@22*3"):
                d = os.path.join(outdir, spec or "plain")
                arrays.update({f"{spec}/{k}": v for k, v in
                               serve_run(mesh, d, spec).items()})
            d = os.path.join(outdir, "drill")
            os.makedirs(d, exist_ok=True)
            arrays.update(guard_run(mesh, d, "nan_vel@22"))
        np.savez(os.path.join(outdir, f"{scenario}.r{rank}.npz"), **arrays)
        from cup2d_tpu_torch.parallel.shard_halo import comm_stats
        res["comm"] = dict(comm_stats)
        return res
    finally:
        shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("CUP2D_POIS", "CUP2D_FAULTS", "CUP2D_SPANS"):
        env.pop(k, None)
    return env


def _run_world(cmds, timeout=WORLD_TIMEOUT):
    """Start every command, wait for all with a hard timeout, kill what is
    left; (rc, stdout, stderr) per process."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=REPO) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def spawn(scenario: str, outdir, world: int = 2) -> list:
    port = _free_port()
    outs = _run_world([[sys.executable, os.path.abspath(__file__), scenario,
                        str(r), str(world), str(port), str(outdir)]
                       for r in range(world)])
    res = []
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        res.append(json.loads(out.strip().splitlines()[-1]))
    return res


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu4():
    from cup2d_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=["cpu"] * SHARDS)


# ---------------------------------------------------------------------------
# fleets: the world against one process and the JAX package
# ---------------------------------------------------------------------------

def _shaped_fields(grid, m):
    """Member m's frozen obstacle (the recipe of tests/test_fleet_server.py
    ``_shaped_state``): chi, us, udef as numpy arrays."""
    xs = (np.arange(grid.nx) + 0.5) * grid.h
    ys = (np.arange(grid.ny) + 0.5) * grid.h
    X, Y = np.meshgrid(xs, ys)
    chi = (((X - (0.35 + 0.1 * m)) ** 2 + (Y - 0.5) ** 2)
           < 0.15 ** 2).astype(np.float64)
    udef = 0.02 * np.stack([chi * np.sin(2 * np.pi * Y),
                            chi * np.cos(2 * np.pi * X)])
    return chi, np.stack([0.2 * chi, 0.05 * chi]), udef


def _jax_carry_and_steps(case: str, mode: str) -> tuple:
    """The single-device JAX fleet's state after its exact startup step
    (from step 9) and its per-step fields, iterations and dt rows over the
    production steps that follow."""
    jax = pytest.importorskip("jax")
    del jax
    from cup2d_tpu import cases as jcases
    from cup2d_tpu.config import SimConfig as JConfig
    from cup2d_tpu.fleet import FleetSim as JFleet
    from cup2d_tpu.fleet import taylor_green_fleet as jtg_fleet
    _pois(mode)
    try:
        if case in ("tg", "shaped"):
            js = JFleet(JConfig(**_tg_kw()), level=LVL, members=B,
                        shaped=case == "shaped")
            js.state = jtg_fleet(js.grid, B)
            if case == "shaped":
                chi, us, udef = (np.stack(f) for f in zip(
                    *(_shaped_fields(js.grid, m) for m in range(B))))
                js.state = js.state._replace(chi=chi, us=us, udef=udef)
        else:
            js = jcases.make_sim(case, level=LVL, dtype="float64",
                                 members=B)
        js.step_count = 9
        js.step_once()
        carry = {k: np.asarray(v) for k, v in js.state._asdict().items()}
        carry.update(times=np.asarray(js.times, np.float64),
                     step_count=np.asarray(js.step_count),
                     next_dt=np.asarray(js._next_dt))
        steps = []
        for _ in range(PROD_STEPS):
            d = js.step_once()
            steps.append(([np.asarray(f) for f in js.state],
                          np.asarray(d["poisson_iters"]),
                          np.asarray(d["dt"])))
        return carry, steps
    finally:
        os.environ.pop("CUP2D_POIS", None)


@pytest.fixture(scope="module")
def fleet_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    jax_steps = {}
    for case in CASES:
        for mode in ("default", "fas"):
            carry, steps = _jax_carry_and_steps(case, mode)
            np.savez(d / f"carry-{case}-{mode}.npz", **carry)
            jax_steps[(case, mode)] = (carry, steps)
    res = spawn("fleet", d)
    ranks = [dict(np.load(d / f"fleet.r{r}.npz")) for r in range(2)]
    return res, ranks, jax_steps


def test_world_fleet_mesh_owns_two_shards_a_rank(fleet_world):
    res, _, _ = fleet_world
    assert [r["local"] for r in res] == [[0, 1], [2, 3]]
    # the member solvers' flag rows and the per-member reductions went
    # through all-gathers on both ranks alike
    for r in res:
        assert r["comm"]["allgathers.reductions"] > 0
    assert res[0]["comm"] == res[1]["comm"]


@pytest.mark.parametrize("case,mode,pl", RUNS,
                         ids=[_tag(*r) for r in RUNS])
def test_world_fleet_equals_one_process_and_jax(fleet_world, case, mode,
                                                pl):
    _, ranks, jax_steps = fleet_world
    tag = _tag(case, mode, pl)
    carry, jsteps = jax_steps[(case, mode)]
    solo = carried_run(case, mode, pl, _cpu4(), carry)
    assert str(solo["placement"]) == pl
    for r in ranks:
        assert str(r[f"{tag}/placement"]) == pl
        for k, v in solo.items():
            if k != "placement":
                assert np.array_equal(r[f"{tag}/{k}"], v), (tag, k)
    for k, (jf, jit, jdt) in enumerate(jsteps):
        w = ranks[0]
        assert np.array_equal(w[f"{tag}/{k}/iters"], jit), (tag, k)
        assert np.allclose(w[f"{tag}/{k}/dt"], jdt, rtol=JAX_BAR, atol=0)
        for name, j in zip(("vel", "pres"), jf[:2]):
            assert np.max(np.abs(w[f"{tag}/{k}/{name}"] - j)) <= JAX_BAR, \
                (tag, k, name)
    if case == "turb2d":
        assert (jsteps[-1][1] > 0).all()
    if case == "shaped":
        # the obstacle fields rode the split step untouched
        assert np.array_equal(ranks[0][f"{tag}/1/chi"], carry["chi"])
        assert carry["chi"].sum() > 0 and (jsteps[-1][1] > 0).all()


def test_world_catalog_fleets_equal_one_process(fleet_world):
    _, ranks, _ = fleet_world
    solo = catalog_run(_cpu4())
    assert len(solo) == 4 * 3
    for r in ranks:
        for k, v in solo.items():
            assert np.array_equal(r[f"catalog/{k}"], v), k
    assert str(solo["cavity/placement"]) == "member"


# ---------------------------------------------------------------------------
# serving, session checkpoints and the guard across the world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    spawn("serve", d)
    ranks = [dict(np.load(d / f"serve.r{r}.npz")) for r in range(2)]
    solo_dir = tmp_path_factory.mktemp("serve_solo")
    solo = {}
    for spec in (None, "nan_vel@22*3"):
        sd = os.path.join(solo_dir, spec or "plain")
        solo.update({f"{spec}/{k}": v for k, v in
                     serve_run(_cpu4(), sd, spec).items()})
    dd = os.path.join(solo_dir, "drill")
    os.makedirs(dd, exist_ok=True)
    solo.update(guard_run(_cpu4(), dd, "nan_vel@22"))
    return d, ranks, solo_dir, solo


def _events(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items()
                 if k not in ("ts", "wall", "checkpoint")}
                for ln in f if ln.strip()]


@pytest.mark.parametrize("spec", [None, "nan_vel@22*3"])
def test_world_pool_equals_one_process_pool(serve_world, spec):
    d, ranks, solo_dir, solo = serve_world
    for r in ranks:
        for k, v in solo.items():
            if k.startswith(f"{spec}/"):
                assert np.array_equal(r[k], v), k
    counts = solo[f"{spec}/pool/counts"]
    assert counts[1] >= 2 and counts[2] == (1 if spec else 0)
    sub = spec or "plain"
    # one writer: rank 0's events, the same as one process's
    assert _events(d / sub / "events.jsonl") == _events(
        os.path.join(solo_dir, sub, "events.jsonl"))
    if spec:
        kinds = [e.get("action") for e in _events(d / sub / "events.jsonl")
                 if e["event"] in ("recovery", "member_aborted")]
        assert kinds == ["retry", "escalate", "evict"]
    from cup2d_tpu_torch.io import load_member_checkpoint
    from cup2d_tpu_torch.uniform import UniformGrid
    from cup2d_tpu_torch.config import SimConfig
    grid = UniformGrid(SimConfig(**_tg_kw()), LVL, device="cpu")
    names = sorted(os.listdir(d / sub / "sessions"))
    assert names == sorted(os.listdir(os.path.join(solo_dir, sub,
                                                   "sessions")))
    assert len(names) >= 2
    for cid in names:
        st_w, m_w = load_member_checkpoint(str(d / sub / "sessions" / cid),
                                           grid)
        st_s, m_s = load_member_checkpoint(
            os.path.join(solo_dir, sub, "sessions", cid), grid)
        assert all(torch.equal(a, b) for a, b in zip(st_w, st_s)), cid
        assert (m_w["time"], m_w["next_dt"]) == (m_s["time"],
                                                m_s["next_dt"])


def test_world_guard_drill_agreed_on_both_ranks(serve_world):
    d, ranks, solo_dir, solo = serve_world
    for r in ranks:
        for k in ("guard/vel", "guard/pres", "guard/times"):
            assert np.array_equal(r[k], solo[k]), k
    ev = _events(d / "drill" / "guard.jsonl")
    assert ev == _events(os.path.join(solo_dir, "drill", "guard.jsonl"))
    assert [(e["action"], e["member"]) for e in ev] == [("retry", 0)]
    assert np.isfinite(solo["guard/vel"]).all()


# ---------------------------------------------------------------------------
# the CLI across two processes
# ---------------------------------------------------------------------------

CLI_FLEET = ["-case", "cavity", "-level", "2", "-device", "cpu", "-dtype",
             "float64", "-maxSteps", "4", "-tdump", "0.01", "-fleet", "4"]


def test_cli_fleet_across_two_processes_dumps_what_one_process_dumps(
        tmp_path):
    from cup2d_tpu_torch.__main__ import main
    solo, world = str(tmp_path / "solo"), str(tmp_path / "world")
    assert main(CLI_FLEET + ["-output", solo]) == 0
    port = _free_port()
    outs = _run_world([[sys.executable, "-m", "cup2d_tpu_torch"]
                       + CLI_FLEET + ["-mesh", "4", "-output", world,
                                      "-coordinator", f"127.0.0.1:{port}",
                                      "-meshHosts", "2", "-processId",
                                      str(r)] for r in range(2)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    dumps = sorted(n for n in os.listdir(solo) if n.startswith("vel."))
    assert len(dumps) >= 8 and any(".m3." in n for n in dumps)
    assert dumps == sorted(n for n in os.listdir(world)
                           if n.startswith("vel."))
    for n in dumps:
        assert open(os.path.join(solo, n), "rb").read() \
            == open(os.path.join(world, n), "rb").read(), n
    recs = [json.loads(x) for x in open(os.path.join(world,
                                                     "metrics.jsonl"))]
    assert [r["step"] for r in recs if r.get("event") == "metrics"] \
        == [1, 2, 3, 4]
    assert recs[-1]["event"] == "compile_ledger"
    assert all(r["fleet_members"] == 4 for r in recs
               if r.get("event") == "metrics")
    assert "done at" in outs[0][2] and "done at" not in outs[1][2]
    # every rank writes its own span file
    assert os.path.exists(os.path.join(world, "spans.jsonl"))
    assert os.path.exists(os.path.join(world, "spans.jsonl.p1"))


if __name__ == "__main__":
    scen, r, w, p, d = sys.argv[1:6]
    print(json.dumps(_worker(scen, int(r), int(w), int(p), d)), flush=True)
