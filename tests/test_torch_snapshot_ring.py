"""The device snapshot ring, snapshot-every-N replay and the lagged verdict
of the port (``cup2d_tpu_torch.resilience.StepGuard``,
``cup2d_tpu_torch.io.snapshot_state_device``), f64 on the CPU: the drills
of tests/test_snapshot_ring.py re-run on the port.

* The lagged guard engages on the obstacle-free drivers (``Simulation``
  without shapes, ``UniformSim``, ``AMRSim`` without shapes): bit for bit
  the unguarded run, zero state gathers and no more device reads; its
  final state within 1e-10 of the JAX package's run of the same steps.
* A snapshot and a restore read nothing from the device; a restored entry
  restores again (it is cloned, never handed to a step); a snapshot of an
  earlier topology restores through ``_install_state``.
* Restore and replay is bit for bit the uninterrupted run (uniform and
  forest); a fault mid-cadence recovers through restore + replay; a
  dispatch discarded under the lag refunds its fault count; these drills
  give the JAX guard's ``recovery`` events and end within 1e-10 of its
  final states.
* The ring's cadence and bytes; the CLI's ``-snapEvery`` drill: lagged,
  the JAX CLI's events and final checkpoint (<= 1e-10), a record for every
  step and a live ``snap_ring_bytes``; with ``-noLag``, the same events
  and the lagged run's final state bit for bit."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import faults as jfaults  # noqa: E402
from cup2d_tpu import resilience as jres  # noqa: E402
from cup2d_tpu.amr import AMRSim as JAMR  # noqa: E402
from cup2d_tpu.config import SimConfig as JConfig  # noqa: E402
from cup2d_tpu.models import DiskShape as JDisk  # noqa: E402
from cup2d_tpu.sim import Simulation as JSim  # noqa: E402
from cup2d_tpu.uniform import taylor_green_state as j_tg  # noqa: E402
from cup2d_tpu_torch import __main__ as tmain  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch import shapes_host  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim  # noqa: E402
from cup2d_tpu_torch.config import SimConfig  # noqa: E402
from cup2d_tpu_torch.faults import FaultPlan  # noqa: E402
from cup2d_tpu_torch.models import DiskShape  # noqa: E402
from cup2d_tpu_torch.profiling import (HostCounters,  # noqa: E402
                                       load_metrics, summarize_metrics)
from cup2d_tpu_torch.resilience import EventLog, StepGuard  # noqa: E402
from cup2d_tpu_torch.sim import Simulation  # noqa: E402
from cup2d_tpu_torch.uniform import UniformSim, taylor_green_state  # noqa

JAX_BAR = 1e-10
BASE = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
            nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
            max_poisson_iterations=100)
FOREST = dict(bpdx=1, bpdy=1, level_max=2, level_start=1, extent=1.0,
              dtype="float64", nu=1e-3, max_poisson_iterations=40)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform_sim(kind="simulation"):
    """The Taylor-Green vortex at level 3 in the production regime (step
    20: no exact startup solve)."""
    cfg = SimConfig(**BASE)
    if kind == "uniformsim":
        sim = UniformSim(cfg, level=3, device="cpu")
    else:
        sim = Simulation(cfg, shapes=[], level=3, device="cpu")
    sim.state = taylor_green_state(sim.grid)
    sim.step_count = 20
    return sim


def _forest_noise(shape):
    return 0.1 * np.random.default_rng(0).standard_normal(shape)


def _amr_free_sim():
    """The reference test's two-level obstacle-free forest with seeded
    noise on its velocity."""
    sim = AMRSim(SimConfig(**FOREST), shapes=[], device="cpu")
    f = sim.forest
    f.fields["vel"] = f.fields["vel"] + torch.as_tensor(
        _forest_noise(tuple(f.fields["vel"].shape)))
    return sim


def _jax_amr_free_sim():
    sim = JAMR(JConfig(**FOREST), shapes=[])
    f = sim.forest
    f.fields["vel"] = f.fields["vel"] + jnp.asarray(
        _forest_noise(f.fields["vel"].shape))
    return sim


def _jax_uniform_sim():
    sim = JSim(JConfig(**BASE), shapes=[], level=3)
    sim.state = j_tg(sim.grid)
    sim.step_count = 20
    return sim


def _vel(sim):
    if hasattr(sim, "forest"):
        v = sim._ordered_state()["vel"][:sim._n_real]
    else:
        v = sim.state.vel
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def _recoveries(path):
    with open(path) as f:
        return [e for e in map(json.loads, filter(str.strip, f))
                if e.get("event") == "recovery"]


def _key(evs):
    return [(e["step"], e["verdict"], e["action"], e.get("rung"),
             e.get("replayed")) for e in evs]


def _run(sim, n, guard=None):
    c = HostCounters().install()
    for _ in range(n):
        guard.step() if guard is not None else sim.step_once()
    if guard is not None:
        guard.drain()
    c.uninstall()
    return c.snapshot()


@pytest.fixture(scope="module")
def jax_tg6():
    """The JAX Taylor-Green run of 6 production steps."""
    sim = _jax_uniform_sim()
    for _ in range(6):
        sim.step_once()
    return _vel(sim), sim.time


# ---------------------------------------------------------------------------
# the lagged guard: zero gathers, no more reads, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["simulation", "uniformsim"])
def test_lagged_guard_zero_gathers_equal_pulls_bit_identical(kind, jax_tg6):
    n = 6
    a = _uniform_sim(kind)
    ca = _run(a, n)
    b = _uniform_sim(kind)
    guard = StepGuard(b)
    cb = _run(b, n, guard)
    assert b.async_diag and not a.async_diag      # the lag engaged
    assert torch.equal(a.state.vel, b.state.vel)
    assert torch.equal(a.state.pres, b.state.pres)
    assert a.time == b.time and a.step_count == b.step_count
    # the device ring adds nothing: no state gather, and the step's one
    # diagnostic read is only moved behind the next dispatch
    assert cb["state_gathers"] == 0
    assert cb["device_gets"] == ca["device_gets"]
    jv, jt = jax_tg6
    assert np.max(np.abs(_vel(b) - jv)) <= JAX_BAR
    assert abs(b.time - jt) <= 1e-14


def test_amr_lagged_guard_zero_gathers_bit_identical():
    n = 4
    a = _amr_free_sim()
    ca = _run(a, n)
    b = _amr_free_sim()
    cb = _run(b, n, StepGuard(b))
    assert b.async_diag
    assert np.array_equal(_vel(a), _vel(b))
    assert a.time == b.time
    assert cb["state_gathers"] == 0
    # the eager step reads its dt and its diagnostics; the lagged one only
    # the diagnostics, behind the next dispatch
    assert cb["device_gets"] == ca["device_gets"] - (n - 1)
    js = _jax_amr_free_sim()
    for _ in range(n):
        js.step_once()
    assert np.max(np.abs(_vel(b) - _vel(js))) <= JAX_BAR
    assert abs(b.time - js.time) <= 1e-14


# ---------------------------------------------------------------------------
# snapshots: no reads, restore twice, another topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mk", [_uniform_sim, _amr_free_sim],
                         ids=["uniform", "amr"])
def test_snapshot_restore_reads_nothing_restores_twice(mk):
    sim = mk()
    guard = StepGuard(sim)
    for _ in range(3):
        guard.step()
    guard.drain()
    ref, t_ref, s_ref = _vel(sim).copy(), sim.time, sim.step_count
    c = HostCounters().install()
    pulls = shapes_host.pulls
    snap = tio.snapshot_state_device(sim)
    assert shapes_host.pulls == pulls            # no host read
    # the snapshot holds clones: stepping on does not touch it
    assert all(v.data_ptr() != w.data_ptr()
               for v, w in zip(snap.payload.values(),
                               (sim._ordered_state() if hasattr(
                                   sim, "forest") else sim.state._asdict()
                                ).values()))
    for _ in range(2):
        guard.step()
    guard.drain()
    for _ in range(2):   # the same entry restores twice
        pulls = shapes_host.pulls
        tio.restore_snapshot_device(sim, snap)
        assert shapes_host.pulls == pulls
        assert np.array_equal(_vel(sim), ref)
        assert sim.time == t_ref and sim.step_count == s_ref
        sim.step_once()
    c.uninstall()
    assert c.snapshot()["state_gathers"] == 0
    assert tio.snapshot_nbytes(snap) == sum(
        v.numel() * v.element_size() for v in snap.payload.values())


def test_snapshot_of_another_topology_restores_through_install():
    sim = _amr_free_sim()
    for _ in range(2):
        sim.step_once()
    keys = sorted(sim.forest.blocks)
    ref = _vel(sim).copy()
    snap = tio.snapshot_state_device(sim)
    tols = sim.cfg.rtol, sim.cfg.ctol
    sim.cfg.rtol, sim.cfg.ctol = 1e9, 1e8     # coarsen everywhere
    assert sim.adapt() and sorted(sim.forest.blocks) != keys
    tio.restore_snapshot_device(sim, snap)
    assert sorted(sim.forest.blocks) == keys
    assert np.array_equal(_vel(sim), ref)
    assert sim.step_count == 2
    sim.cfg.rtol, sim.cfg.ctol = tols
    assert np.isfinite(sim.step_once()["umax"])


# ---------------------------------------------------------------------------
# replay: restore + replay == the uninterrupted run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mk", [_uniform_sim, _amr_free_sim],
                         ids=["uniform", "amr"])
def test_rewind_replay_bit_exact(mk):
    sim = mk()
    guard = StepGuard(sim, snap_every=4)
    for _ in range(6):
        guard.step()
    guard.drain()
    # anchor = the post-step-4 snapshot; steps 5 and 6 recorded
    assert len(guard._replay) == 2
    ref, t_ref, s_ref = _vel(sim).copy(), sim.time, sim.step_count
    c = HostCounters().install()
    n = guard._rewind_replay()
    c.uninstall()
    assert n == 2 and guard.replayed_steps == 2
    assert np.array_equal(_vel(sim), ref)
    assert sim.time == t_ref and sim.step_count == s_ref
    assert c.snapshot()["state_gathers"] == 0
    guard._rewind_replay()            # the entry survived its restore
    assert np.array_equal(_vel(sim), ref)
    guard.step()
    guard.drain()
    assert sim.step_count == s_ref + 1
    assert np.all(np.isfinite(_vel(sim)))


def test_mid_cadence_fault_restores_and_replays(tmp_path):
    """A NaN landing between snapshots (snapEvery 3) recovers through
    restore + a one-step replay + the dt/2 retry, within the bars of the
    rung-1 drill, with the JAX guard's events and final state."""
    tend = 0.25
    disk = (0.1, 0.4, 0.5)

    def drive_to(sim, stepper, cfl_dt):
        while sim.time < tend:
            if sim._next_dt is not None:
                dt = min(float(sim._next_dt), sim._kinematic_dt_cap())
            else:
                dt = min(cfl_dt(sim), sim._kinematic_dt_cap())
            stepper(min(dt, tend - sim.time + 1e-15))

    port_dt = lambda s: float(s.grid.compute_dt(s.state.vel))  # noqa
    ref = Simulation(SimConfig(**BASE), shapes=[DiskShape(
        *disk, prescribed=(0.2, 0.0))], level=3, device="cpu")
    drive_to(ref, lambda dt: ref.step_once(dt=dt), port_dt)
    runs = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            sim = Simulation(SimConfig(**BASE), shapes=[DiskShape(
                *disk, prescribed=(0.2, 0.0))], level=3, device="cpu")
            log = EventLog(str(tmp_path / "port.jsonl"))
            guard = StepGuard(sim, event_log=log, snap_every=3,
                              faults=FaultPlan("nan_vel@4"))
            cfl_dt = port_dt
        else:
            sim = JSim(JConfig(**BASE), shapes=[JDisk(
                *disk, prescribed=(0.2, 0.0))], level=3)
            log = jres.EventLog(str(tmp_path / "jax.jsonl"))
            guard = jres.StepGuard(sim, event_log=log, snap_every=3,
                                   faults=jfaults.FaultPlan("nan_vel@4"))
            cfl_dt = lambda s: float(s._dt(s.state.vel))  # noqa
        drive_to(sim, lambda dt: guard.step(dt=dt), cfl_dt)
        guard.drain()
        log.close()
        runs.append((sim, guard, _recoveries(tmp_path / f"{pkg}.jsonl")))
    (sim, guard, evs), (js, _, jevs) = runs
    # the anchor holds the state after 3 steps; the step from 3 replays,
    # the step from 4 is retried
    assert _key(evs) == _key(jevs) == [(4, "nonfinite", "retry", 0, 1)]
    assert guard.replayed_steps == 1
    vel, ref_v = sim.state.vel, ref.state.vel
    assert torch.isfinite(vel).all()
    assert abs(vel.abs().max() - ref_v.abs().max()) \
        <= 2e-3 * ref_v.abs().max()
    assert np.max(np.abs(_vel(sim) - _vel(js))) <= JAX_BAR
    assert abs(sim.time - js.time) <= 1e-14


def _pair_events(tmp_path, spec, port_sim, jax_sim, until, **kw):
    """The same lagged drill on both packages; their recovery events."""
    out = []
    for pkg, sim, mod, fmod in (("port", port_sim, None, None),
                                ("jax", jax_sim, jres, jfaults)):
        path = str(tmp_path / f"{pkg}.jsonl")
        if mod is None:
            log = EventLog(path)
            guard = StepGuard(sim, event_log=log, faults=FaultPlan(spec),
                              **kw)
        else:
            log = mod.EventLog(path)
            guard = mod.StepGuard(sim, event_log=log,
                                  faults=fmod.FaultPlan(spec), **kw)
        assert sim.async_diag               # the lagged device-diag path
        while sim.step_count < until:
            guard.step()
        guard.drain()
        log.close()
        out.append((sim, guard, _recoveries(path)))
    return out


def test_discarded_dispatch_refunds_fault_counts(tmp_path):
    """Under the lag step N+1 is dispatched before step N's bad verdict
    lands; that dispatch consumed N+1's fault and is thrown away. The
    refund makes faults at two consecutive steps both fire."""
    (sim, _, evs), (js, _, jevs) = _pair_events(
        tmp_path, "nan_vel@24,nan_vel@25", _uniform_sim(),
        _jax_uniform_sim(), 28)
    assert _key(evs) == _key(jevs) == [(24, "nonfinite", "retry", 0, 0),
                                       (25, "nonfinite", "retry", 0, 0)]
    assert np.all(np.isfinite(_vel(sim)))
    assert np.max(np.abs(_vel(sim) - _vel(js))) <= JAX_BAR


def test_amr_async_fault_mid_cadence_recovers(tmp_path):
    """The same on the lagged forest: detected one step late, the garbage
    dispatch discarded, the ring restored and replayed to step 4."""
    (sim, guard, evs), (js, _, jevs) = _pair_events(
        tmp_path, "nan_vel@4", _amr_free_sim(), _jax_amr_free_sim(), 6,
        snap_every=3)
    assert _key(evs) == _key(jevs) == [(4, "nonfinite", "retry", 0, 1)]
    assert sim.step_count == 6 and guard.replayed_steps == 1
    assert np.all(np.isfinite(_vel(sim))) and np.isfinite(sim.time)
    assert np.max(np.abs(_vel(sim) - _vel(js))) <= JAX_BAR
    assert abs(sim.time - js.time) <= 1e-14


# ---------------------------------------------------------------------------
# cadence and bytes
# ---------------------------------------------------------------------------

def test_snapshot_cadence_and_ring_bytes():
    sim = _uniform_sim()
    guard = StepGuard(sim, snap_every=4)
    per_snap = sum(v.numel() * v.element_size()
                   for v in sim.state._asdict().values())
    guard.step()                     # the seed anchor + 1 pending
    assert len(guard.ring) == 1
    assert guard.ring_nbytes() == per_snap
    for _ in range(3):
        guard.step()                 # dispatch 4 takes the cadence snap
    # the optimistic post-step snapshot waits in the pending slot: two
    # full snapshots coexist until the lagged verdict promotes it
    assert guard.ring_nbytes() == 2 * per_snap
    guard.step()
    guard.drain()
    assert len(guard._replay) == 1
    assert guard.ring_nbytes() == per_snap


# ---------------------------------------------------------------------------
# the CLI: -snapEvery, lagged and not, the final drain, telemetry
# ---------------------------------------------------------------------------

CLI = ["-bpdx", "1", "-bpdy", "1", "-levelMax", "1", "-levelStart", "0",
       "-Rtol", "2", "-Ctol", "1", "-extent", "1", "-CFL", "0.4",
       "-tend", "1", "-lambda", "1e6", "-nu", "0.001",
       "-poissonTol", "1e-3", "-poissonTolRel", "1e-2",
       "-maxPoissonRestarts", "0", "-maxPoissonIterations", "100",
       "-AdaptSteps", "20", "-tdump", "0", "-level", "3",
       "-dtype", "float64", "-device", "cpu",
       "-maxSteps", "10", "-snapEvery", "3", "-checkpointEvery", "10"]


def _cli_drill(out, monkeypatch, *extra) -> list:
    monkeypatch.setenv("CUP2D_FAULTS", "nan_vel@7")
    monkeypatch.delenv("CUP2D_TRACE", raising=False)
    assert tmain.main(CLI + list(extra) + ["-output", str(out)]) == 0
    return _recoveries(out / "events.jsonl")


def test_cli_snap_every_lagged_drill(tmp_path, monkeypatch):
    """The lagged ``-snapEvery 3`` drill of both CLIs: the same events,
    final checkpoints within 1e-10; the port's records cover every step,
    the drained last one included, with a live ring and no gather."""
    from cup2d_tpu import __main__ as jmain
    out = tmp_path / "run"
    evs = _cli_drill(out, monkeypatch)
    jout = tmp_path / "jax"
    cache = jmain.enable_compilation_cache
    jmain.enable_compilation_cache = lambda: None   # no persistent cache
    try:
        assert jmain.main([a for a in CLI if a not in ("-device", "cpu")]
                          + ["-output", str(jout), "-noSpans",
                             "-noMemLedger"]) == 0
    finally:
        jmain.enable_compilation_cache = cache
    assert _key(evs) == _key(_recoveries(jout / "events.jsonl")) == [
        (7, "nonfinite", "retry", 0, 1)]
    with np.load(out / "checkpoint" / "fields.npz") as a, \
            np.load(jout / "checkpoint" / "fields.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.max(np.abs(a[k] - b[k])) <= JAX_BAR, k
    recs = load_metrics(str(out / "metrics.jsonl"))
    ms = [r for r in recs if r.get("event") == "metrics"]
    # a record for every step, the drained final one included
    assert [r["step"] for r in ms] == list(range(1, 11))
    assert all(r["snap_ring_bytes"] > 0 for r in ms)
    assert all(r["state_gathers"] == 0 for r in ms)
    s = summarize_metrics(recs)
    assert s["replayed_steps_total"] == 1
    assert s["state_gathers_total"] == 0
    assert s["snap_ring_bytes"] > 0


def test_cli_snap_every_no_lag_matches_lagged(tmp_path, monkeypatch):
    """``-snapEvery 3 -noLag``: the eager verdict with the same cadence
    gives the same events and ends bit for bit where the lagged run
    ends."""
    evs = _cli_drill(tmp_path / "lag", monkeypatch)
    evs_eager = _cli_drill(tmp_path / "eager", monkeypatch, "-noLag")
    assert _key(evs_eager) == _key(evs) == [(7, "nonfinite", "retry", 0, 1)]
    fields = []
    for name in ("lag", "eager"):
        with np.load(tmp_path / name / "checkpoint" / "fields.npz") as d:
            fields.append({k: d[k].copy() for k in d.files})
        ms = [r for r in load_metrics(str(tmp_path / name / "metrics.jsonl"))
              if r.get("event") == "metrics"]
        assert [r["step"] for r in ms] == list(range(1, 11))
    assert fields[0].keys() == fields[1].keys()
    for k in fields[0]:
        assert np.array_equal(fields[0][k], fields[1][k]), k
    assert np.all(np.isfinite(fields[0]["vel"]))
