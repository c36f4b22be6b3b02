"""The run's observability (``tracing``, ``profiling.PhaseTimers``,
``cache``), held against ``cup2d_tpu.tracing`` and the JAX drivers.

* ``spans_to_perfetto`` of the same span rows (two processes, client
  sessions) gives the JAX package's dict; the span ring is bounded
  (``spans_dropped``), ``CUP2D_SPANS`` is read as the reference reads it,
  spans off (or no recorder) give the one shared ``nullcontext``;
  ``post --trace`` folds the per-process files into one ``trace.json``.
* The zero-overhead contract: a recorder-on run is bit-identical to a
  recorder-off run with equal ``device_gets`` and kernel builds, on a
  supervised ``UniformSim`` and under ``FleetServer`` churn; the build
  ledger carries the step entry points' labels and the solvers'
  components.
* Timers on and off are bit-identical, and ``report()`` has the JAX
  driver's phase names for the same run (``Simulation`` shaped,
  ``AMRSim`` with an adapt, ``FleetSim``); ``-profile`` prints the phases
  and the throughput.
* ``CUP2D_CACHE`` names the directory the kernel libraries build into
  (latched once; nothing is built on the CPU)."""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu import tracing as jtr  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu_torch import __main__ as tmain  # noqa: E402
from cup2d_tpu_torch import post as tpost  # noqa: E402
from cup2d_tpu_torch import profiling as tprof  # noqa: E402
from cup2d_tpu_torch import shapes_host  # noqa: E402
from cup2d_tpu_torch import tracing as ttr  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_recorder():
    """Every test starts and ends with no recorder installed."""
    yield
    r = ttr.recorder()
    if r is not None:
        r.uninstall()


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# the span ring and the Perfetto export
# ---------------------------------------------------------------------------

def _rows():
    rows = []
    for pid in (0, 1):
        for k, name in enumerate(("step", "dispatch", "verdict")):
            rows.append({"event": "span", "name": name,
                         "ts_us": 1000 * k + pid, "dur_us": 50 + k,
                         "depth": int(k > 0), "pid": pid, "step": k,
                         "wall": 1.0})
    for k, (name, cid) in enumerate((("admit", "s0"), ("admit", "s1"),
                                     ("retire", "s0"), ("evict", "s1"))):
        rows.append({"event": "span", "name": name, "ts_us": 5000 + 10 * k,
                     "dur_us": 7, "depth": 0, "pid": 0, "member": k % 2,
                     "client": cid})
    rows.append({"event": "metrics", "step": 1})
    return rows


def test_spans_to_perfetto_equals_the_reference():
    rows = _rows()
    assert ttr.spans_to_perfetto(rows) == jtr.spans_to_perfetto(rows)
    out = ttr.spans_to_perfetto(rows)
    names = {e["args"]["name"] for e in out["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"process 0", "process 1", "client s0", "client s1"}


def test_ring_is_bounded_and_spans_off_is_the_shared_nullcontext(
        monkeypatch):
    assert ttr.span("x") is ttr._NULL and ttr.label("x") is ttr._NULL
    r = ttr.FlightRecorder(max_spans=16).install()
    for k in range(40):
        with ttr.span("s", k=k):
            pass
    assert len(r._buf) == 16 and r.spans_dropped == 24
    assert r.span_count == 40
    assert [a["k"] for *_, a in r._buf] == list(range(24, 40))
    r.uninstall()
    for raw, on, cap in (("0", False, 65536), ("5", True, 16),
                         ("100", True, 100), ("", True, 65536),
                         ("x", True, 65536)):
        monkeypatch.setenv("CUP2D_SPANS", raw)
        t = ttr.FlightRecorder.from_env()
        j = jtr.FlightRecorder.from_env()
        assert (t.spans_on, t.max_spans) == (j.spans_on, j.max_spans) \
            == (on, cap), raw
    monkeypatch.setenv("CUP2D_SPANS", "0")
    off = ttr.FlightRecorder.from_env().install()
    assert ttr.span("x") is ttr._NULL
    # the ledger stays on with the spans off
    with ttr.label("uniform.step"):
        ttr.note_component("poisson.mg_solve")
    assert off.ledger["uniform.step"]["components"] == {"poisson.mg_solve"}
    assert off.span_count == 0


def test_nested_spans_depth_error_mark_and_flush():
    rows = []

    class Sink:
        def emit(self, **row):
            rows.append(row)
    r = ttr.FlightRecorder(sink=Sink()).install()
    with pytest.raises(ValueError):
        with ttr.span("step", step=3):
            with ttr.span("recover", member=1):
                raise ValueError("x")
    r.close()
    assert ttr.recorder() is None
    assert [(x["name"], x["depth"]) for x in rows] == [("recover", 1),
                                                       ("step", 0)]
    assert rows[0]["error"] == "ValueError" and rows[0]["member"] == 1
    assert rows[1]["step"] == 3 and all(x["pid"] == 0 for x in rows)
    assert all(x["dur_us"] >= 1 for x in rows)


def test_post_trace_writes_trace_json(tmp_path):
    base = tmp_path / "spans.jsonl"
    rows = _rows()
    with open(base, "w") as f:
        for r in rows:
            if r.get("pid", 0) == 0:
                f.write(json.dumps(r) + "\n")
    with open(str(base) + ".p1", "w") as f:
        for r in rows:
            if r.get("pid") == 1:
                f.write(json.dumps(r) + "\n")
    assert tpost.main(["--trace", str(base)]) == 0
    got = json.load(open(tmp_path / "trace.json"))
    order = [r for r in rows if r.get("pid", 0) == 0] + \
        [r for r in rows if r.get("pid") == 1]
    assert got == json.loads(json.dumps(jtr.spans_to_perfetto(order)))
    assert tpost.main(["--trace", str(base), str(tmp_path / "t2.json")]) \
        == 0
    assert json.load(open(tmp_path / "t2.json")) == got
    assert tpost.main(["--trace"]) == 2


# ---------------------------------------------------------------------------
# the zero-overhead contract
# ---------------------------------------------------------------------------

def _tg_cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, nu=1e-3, cfl=0.4, lam=1e6,
                     dtype="float64", max_poisson_iterations=100,
                     poisson_tol=1e-6, poisson_tol_rel=1e-4)


def _counts():
    return shapes_host.pulls, hk.build_events


def _uniform_guarded(recorded: bool):
    from cup2d_tpu_torch.resilience import StepGuard
    from cup2d_tpu_torch.uniform import UniformSim, taylor_green_state
    sim = UniformSim(_tcfg(_tg_cfg()), level=3, device="cpu")
    sim.state = taylor_green_state(sim.grid)
    rec = ttr.FlightRecorder().install() if recorded else None
    g0, b0 = _counts()
    guard = StepGuard(sim, ring=2, snap_every=2)
    for _ in range(12):
        guard.step()
    guard.drain()
    g1, b1 = _counts()
    if rec is not None:
        rec.uninstall()
    return sim, g1 - g0, b1 - b0, rec


def test_recorder_on_is_bit_identical_on_uniform_sim():
    off, gets_off, builds_off, _ = _uniform_guarded(False)
    on, gets_on, builds_on, rec = _uniform_guarded(True)
    for a, b in zip(off.state, on.state):
        assert torch.equal(a, b)
    assert (gets_on, builds_on) == (gets_off, builds_off) and gets_on > 0
    names = {name for name, *_ in rec._buf}
    assert {"step", "dispatch", "verdict", "snapshot",
            "uniform.step"} <= names
    depth = {name: d for name, _, _, d, _ in rec._buf}
    assert depth["step"] == 0 and depth["dispatch"] == 1
    rep = rec.ledger_report()
    rows = {r["label"]: r for r in rep["executables"]}
    assert rows["uniform.step"]["components"] == ["poisson.bicgstab"]
    # nothing is built on the CPU; no allocator peak there
    assert rep["compiles"] == 0 and rep["hbm_exec_bytes"] is None


def _serve(recorded: bool, tmp_path, tag):
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.fleet import FleetRequest, FleetServer, FleetSim
    from cup2d_tpu_torch.resilience import EventLog, FleetStepGuard
    from cup2d_tpu_torch.uniform import taylor_green_state
    sim = FleetSim(_tcfg(_tg_cfg()), level=2, members=3, device="cpu")
    sim.step_count = 20
    rows = []

    class Sink:
        def emit(self, **row):
            rows.append(row)
    rec = ttr.FlightRecorder(sink=Sink()).install() if recorded else None
    g0, b0 = _counts()
    log = EventLog(str(tmp_path / f"{tag}.jsonl"))
    guard = FleetStepGuard(sim, event_log=log,
                           faults=FaultPlan("nan_vel@22*3"))
    server = FleetServer(sim, guard=guard, event_log=log,
                         session_dir=str(tmp_path / f"sessions_{tag}"))
    base = taylor_green_state(sim.grid)
    dt0 = float(sim.grid.compute_dt(base.vel))
    for i in range(5):
        server.submit(FleetRequest(
            client_id=f"s{i}", state=base._replace(vel=base.vel * 0.8 ** i),
            t_end=(2.5 + i) * dt0))
    server.drain(max_steps=12)
    log.close()
    g1, b1 = _counts()
    if rec is not None:
        rec.close()
    return sim, server, g1 - g0, b1 - b0, rows


def test_recorder_on_is_bit_identical_under_fleet_server_churn(tmp_path):
    off, srv_off, gets_off, builds_off, _ = _serve(False, tmp_path, "off")
    on, srv_on, gets_on, builds_on, rows = _serve(True, tmp_path, "on")
    for a, b in zip(off.state, on.state):
        assert torch.equal(a, b)
    assert np.array_equal(off.times, on.times)
    assert (gets_on, builds_on) == (gets_off, builds_off)
    assert (srv_on.admitted, srv_on.retired, srv_on.evicted) == (
        srv_off.admitted, srv_off.retired, srv_off.evicted)
    assert srv_on.evicted == 1 and srv_on.retired >= 2
    names = [r["name"] for r in rows]
    for n in ("admit", "retire", "evict", "recover", "retry", "escalate",
              "fleet.step", "fleet.solo_ladder"):
        assert n in names, n
    trace = ttr.spans_to_perfetto(rows)
    clients = {e["args"]["name"] for e in trace["traceEvents"]
               if e["ph"] == "M" and e["pid"] >= 1 << 20}
    assert {"client s0", "client s1"} <= clients


# ---------------------------------------------------------------------------
# the phase timers against the JAX drivers
# ---------------------------------------------------------------------------

def _timed_pair(build_t, build_j, run):
    """The port's run with timers on and off (bit-identical, equal reads)
    and the JAX driver's run with timers on: the port's fields and the two
    report key sets."""
    from cup2d_tpu.profiling import PhaseTimers as JTimers
    from cup2d_tpu_torch.io import whole
    out = []
    for timed in (False, True):
        sim = build_t()
        if timed:
            sim.timers = tprof.PhaseTimers()
        g0 = shapes_host.pulls
        run(sim)
        out.append((sim, shapes_host.pulls - g0))
    (off, gets_off), (on, gets_on) = out
    assert gets_on == gets_off

    def fields(sim):
        if hasattr(sim, "forest"):
            return list(sim._ordered_state().values())
        return list(sim.state)
    for a, b in zip(fields(off), fields(on)):
        assert torch.equal(whole(a), whole(b))
    js = build_j()
    js.timers = JTimers()
    run(js)
    return set(on.timers.report()), set(js.timers.report())


def test_timers_simulation_phases_match_jax():
    from cup2d_tpu.models import DiskShape as JDisk
    from cup2d_tpu.sim import Simulation as JSimulation
    from cup2d_tpu_torch.models import DiskShape
    from cup2d_tpu_torch.sim import Simulation
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                    nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                    max_poisson_iterations=200)

    def run(sim):
        for _ in range(2):
            sim.step_once()
    t, j = _timed_pair(
        lambda: Simulation(_tcfg(cfg), shapes=[DiskShape(0.1, 0.5, 0.5)],
                           level=2, device="cpu"),
        lambda: JSimulation(cfg, shapes=[JDisk(0.1, 0.5, 0.5)], level=2),
        run)
    assert t == j == {"dt", "kinematics", "rasterize", "flow", "forces"}


def test_timers_amr_phases_match_jax():
    from cup2d_tpu.amr import AMRSim as JAMR
    from cup2d_tpu_torch.amr import AMRSim
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=3, level_start=1, extent=1.0,
                    nu=1e-4, cfl=0.4, dtype="float64",
                    max_poisson_iterations=100, poisson_tol=1e-4,
                    poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)

    def run(sim):
        sim.step_once()
        sim.adapt()
        sim.step_once()
    t, j = _timed_pair(lambda: AMRSim(_tcfg(cfg), shapes=[], device="cpu"),
                       lambda: JAMR(cfg, shapes=[]), run)
    assert t == j
    assert {"tables", "tables/build", "tables/put", "tables/corr", "dt",
            "flow", "adapt"} <= t


def test_timers_fleet_phase_matches_jax():
    from cup2d_tpu.fleet import FleetSim as JFleet
    from cup2d_tpu.fleet import taylor_green_fleet as jtg
    from cup2d_tpu_torch.fleet import FleetSim, taylor_green_fleet

    def build_t():
        sim = FleetSim(_tcfg(_tg_cfg()), level=2, members=2, device="cpu")
        sim.set_state(taylor_green_fleet(sim.grid, 2))
        return sim

    def build_j():
        sim = JFleet(_tg_cfg(), level=2, members=2)
        sim.state = jtg(sim.grid, 2)
        return sim

    def run(sim):
        sim.step_once()
        sim.step_once()
    t, j = _timed_pair(build_t, build_j, run)
    assert t == j == {"step"}


def test_fence_synchronizes_without_a_read(monkeypatch):
    from cup2d_tpu_torch.parallel.mesh import make_mesh
    from cup2d_tpu_torch.parallel.shard_halo import split_x
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d))
    tm = tprof.PhaseTimers()
    x = torch.zeros(2, 8)
    s = split_x(x, make_mesh(devices=["cpu"] * 2))
    g0 = shapes_host.pulls
    assert tm.fence("flow", x, {"a": s}, [x]) == (x, {"a": s}, [x])
    assert synced == [] and shapes_host.pulls == g0


def test_cli_profile_prints_phases_and_throughput(tmp_path, capsys):
    argv = ["-bpdx", "1", "-bpdy", "1", "-levelMax", "1", "-levelStart",
            "0", "-extent", "1", "-CFL", "0.4", "-tend", "1", "-nu", "1e-3",
            "-lambda", "1e6", "-poissonTol", "1e-6", "-poissonTolRel",
            "1e-4", "-maxPoissonRestarts", "0", "-maxPoissonIterations",
            "100", "-AdaptSteps", "20", "-Rtol", "2", "-Ctol", "1",
            "-dtype", "float64", "-tdump", "0", "-device", "cpu",
            "-case", "cavity", "-level", "2", "-fleet", "2", "-maxSteps",
            "3", "-profile", "-noMemLedger", "-spansLog",
            str(tmp_path / "sp.jsonl"), "-output", str(tmp_path / "o")]
    assert tmain.main(argv) == 0
    err = capsys.readouterr().err
    assert "cells_steps_per_sec" in err and "step:" in err
    recs = [r for r in tprof.load_metrics(str(tmp_path / "o" /
                                              "metrics.jsonl"))
            if r.get("event") == "metrics"]
    assert all("step" in r["phase_ms"] for r in recs)
    assert recs[-1]["span_count"] > 0
    assert tpost.main(["--trace", str(tmp_path / "sp.jsonl")]) == 0
    trace = json.load(open(tmp_path / "trace.json"))
    assert any(e["name"] == "fleet.step" for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# CUP2D_CACHE
# ---------------------------------------------------------------------------

def test_cup2d_cache_names_the_build_directory(tmp_path, monkeypatch):
    from cup2d_tpu_torch import cache, native
    monkeypatch.setattr(cache, "_LATCHED", [])
    monkeypatch.delenv("CUP2D_CACHE", raising=False)
    assert hk.build_dir() == hk.BUILD_DIR
    assert hk._lib_path("jacobi").parent == hk.BUILD_DIR
    assert cache._LATCHED == [None]
    monkeypatch.setattr(cache, "_LATCHED", [])
    monkeypatch.setenv("CUP2D_CACHE", str(tmp_path / "kc"))
    assert hk.build_dir() == tmp_path / "kc"
    # read once: a later change of the variable is not seen
    monkeypatch.setenv("CUP2D_CACHE", str(tmp_path / "other"))
    assert hk._lib_path("jacobi").parent == tmp_path / "kc"
    assert native._lib_path().parent == tmp_path / "kc"
    assert cache._LATCHED == [tmp_path / "kc"]
    # nothing builds on the CPU
    assert not (tmp_path / "kc").exists()
