"""The run driver (``python -m cup2d_tpu_torch``) against the JAX package's
CLI, f64 on the CPU, and its telemetry, signals and refusals.

* From one JAX checkpoint of ``entry()``'s two fish at 512 x 256 taken
  after the 10 exact startup steps (the startup solves part between the
  packages, ROADMAP queue 3): 4 production steps of the port's library
  match 4 of JAX's at <= 1e-10 with equal iterations; and both CLIs,
  restarted from it with ``-noSupervise -noLag``, agree: ``forces.csv``
  rows <= 1e-10 relative, equal ``poisson_iters`` per step in
  ``metrics.jsonl``, dumps' ``xyz`` byte-equal and ``attr`` within one
  f32 rounding.
* Metrics: schema 12, the key set of both packages' ``METRICS_KEYS``,
  steps 1, 2, 3, no kernel builds on the CPU; ``device_gets`` of a
  production step equals the reads the code makes (3 stacked reads of
  the shaped step, 2 + 2 a BiCGSTAB iteration of the solver); ``post
  --metrics`` gives the JAX ``post``'s summary keys.
* ``CUP2D_TRACE`` parses and wraps exactly its steps; SIGTERM at step 3
  writes the checkpoint and the ``sigterm_checkpoint`` event and exits 0,
  and ``-restart`` resumes it; a restart from a checkpoint with a NaN in
  ``vel`` ends with rc 1, a post-mortem checkpoint and an ``abort`` event.
* The supervised loop runs with rc 0 (``-guardRing``, ``-snapEvery``, a
  ``CUP2D_FAULTS`` NaN recovered by the retry rung), a live snapshot ring
  in every record. Every refused flag or variable exits 2 naming its
  ROADMAP item; without a card and without ``-device cpu`` the driver
  raises.
* ``health_verdict`` and ``PhysicsWatchdog`` classify as the JAX
  package's; the streams rotate and read back (torn lines counted)."""

import json
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu import io as jio  # noqa: E402
from cup2d_tpu import profiling as jprof  # noqa: E402
from cup2d_tpu.config import SimConfig as JConfig  # noqa: E402
from cup2d_tpu.sim import Simulation as JSim  # noqa: E402
from cup2d_tpu_torch import __main__ as tmain  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch import post as tpost  # noqa: E402
from cup2d_tpu_torch import profiling as tprof  # noqa: E402
from cup2d_tpu_torch import resilience as tres  # noqa: E402
from cup2d_tpu_torch.config import SimConfig  # noqa: E402
from cup2d_tpu_torch.sim import Simulation  # noqa: E402

TRAJ_BAR = 1e-10
LEVEL = 5                  # 512 x 256: each fish has several penalized cells
ENTRY_SHAPES = ("angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
                "angle=180 L=0.2 xpos=1.6 ypos=0.8")
# entry()'s configuration as reference flags, f64
ENTRY_FLAGS = ("-bpdx 2 -bpdy 1 -levelMax 1 -levelStart 0 -Rtol 2 -Ctol 1 "
               "-extent 4 -CFL 0.5 -tend 10 -lambda 1e7 -nu 0.00004 "
               "-poissonTol 1e-3 -poissonTolRel 0.01 -maxPoissonRestarts 0 "
               "-maxPoissonIterations 1000 -AdaptSteps 20 -tdump 0.002 "
               f"-dtype float64 -level {LEVEL}").split() + [
                   "-shapes", ENTRY_SHAPES]
CAVITY = ["-case", "cavity", "-level", "2", "-device", "cpu",
          "-noSupervise"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX Simulation's checkpoint after ``initialize()`` and its 10
    exact startup steps."""
    js = JSim(JConfig.from_argv(ENTRY_FLAGS), level=LEVEL)
    js.initialize()
    for _ in range(10):
        js.step_once()
    ck = str(tmp_path_factory.mktemp("jax") / "checkpoint")
    jio.save_checkpoint(ck, js)
    return ck


def _err(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.max(np.abs(a - b)))


def _records(path):
    return [r for r in tprof.load_metrics(path)
            if r.get("event") == "metrics"]


@pytest.fixture(scope="module")
def cli_runs(jax_ckpt, tmp_path_factory):
    """Both CLIs restarted from the JAX checkpoint for 4 steps, each
    checkpointing its last state."""
    from cup2d_tpu import __main__ as jmain
    root = tmp_path_factory.mktemp("cli")
    tail = ["-restart", jax_ckpt, "-noSupervise", "-noLag", "-maxSteps",
            "14", "-checkpointEvery", "14"]
    jdir, tdir = str(root / "jax"), str(root / "port")
    cache = jmain.enable_compilation_cache
    jmain.enable_compilation_cache = lambda: None   # no persistent cache
    try:
        assert jmain.main(ENTRY_FLAGS + tail + ["-output", jdir]) == 0
    finally:
        jmain.enable_compilation_cache = cache
    assert tmain.main(ENTRY_FLAGS + tail + ["-output", tdir, "-device",
                                            "cpu", "-noSpans",
                                            "-noMemLedger"]) == 0
    return jdir, tdir


def test_port_production_from_jax_checkpoint(cli_runs):
    """4 production steps of the port from the JAX checkpoint (the port
    CLI's run) against 4 of JAX's (the JAX CLI's): the f64 checkpoints
    both wrote at step 14 (the shapes through the port's unpickler)
    <= 1e-10, equal iterations at every step."""
    jdir, tdir = cli_runs
    jend, tend = (Simulation(SimConfig.from_argv(ENTRY_FLAGS), level=LEVEL,
                             device="cpu") for _ in range(2))
    tio.load_checkpoint(os.path.join(jdir, "checkpoint"), jend)
    tio.load_checkpoint(os.path.join(tdir, "checkpoint"), tend)
    assert jend.step_count == tend.step_count == 14
    assert abs(jend.time - tend.time) <= 1e-15
    iters = [[r["poisson_iters"] for r in _records(
        os.path.join(d, "metrics.jsonl"))] for d in (jdir, tdir)]
    assert iters[0] == iters[1] and len(iters[0]) == 4
    for k in ("vel", "us", "udef", "chi"):
        assert _err(getattr(jend.state, k), getattr(tend.state, k)) \
            <= TRAJ_BAR, k
    pres = [s.state.pres.detach().numpy() for s in (jend, tend)]
    assert _err(*(p - p.mean() for p in pres)) <= TRAJ_BAR
    for a, b in zip(jend.shapes, tend.shapes):
        for key in ("u", "v", "omega", "com", "center", "orientation"):
            assert _err(getattr(a, key), getattr(b, key)) <= TRAJ_BAR, key
        for key, v in a.forces.items():
            assert abs(b.forces[key] - v) <= TRAJ_BAR, key
        assert abs(b.omega) > 0               # the momentum solve ran


def test_cli_forces_and_iterations_match_jax(cli_runs):
    jdir, tdir = cli_runs
    jrows = open(os.path.join(jdir, "forces.csv")).read().splitlines()
    trows = open(os.path.join(tdir, "forces.csv")).read().splitlines()
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 1 + 4 * 2
    for jr, tr in zip(jrows[1:], trows[1:]):
        a = np.array(jr.split(","), float)
        b = np.array(tr.split(","), float)
        assert np.all(np.abs(a - b) <= TRAJ_BAR * np.maximum(
            np.abs(a), np.abs(b))), (jr, tr)
    jm = _records(os.path.join(jdir, "metrics.jsonl"))
    tm = _records(os.path.join(tdir, "metrics.jsonl"))
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == \
        [11, 12, 13, 14]
    assert [r["poisson_iters"] for r in tm] == \
        [r["poisson_iters"] for r in jm]
    assert all(r["poisson_iters"] > 0 for r in tm)


def test_cli_dumps_match_jax(cli_runs):
    jdir, tdir = cli_runs
    names = sorted(f[:-len(".xdmf2")] for f in os.listdir(tdir)
                   if f.endswith(".xdmf2"))
    assert names == sorted(f[:-len(".xdmf2")] for f in os.listdir(jdir)
                           if f.endswith(".xdmf2"))
    assert len(names) >= 2 and names[0] == "vel.00000010"
    for n in names:
        tj, xj, aj = tio.read_dump(os.path.join(jdir, n))
        tt, xt, at = tio.read_dump(os.path.join(tdir, n))
        assert abs(tj - tt) <= TRAJ_BAR
        assert open(os.path.join(jdir, n + ".xyz.raw"), "rb").read() == \
            open(os.path.join(tdir, n + ".xyz.raw"), "rb").read()
        # one f32 rounding of values that agree to 1e-10: within one
        # spacing of the larger
        gap = np.spacing(np.maximum(np.abs(aj), np.abs(at)))
        assert np.all(np.abs(aj - at) <= gap), n


def test_cli_metrics_stream(cli_runs):
    _, tdir = cli_runs
    recs = _records(os.path.join(tdir, "metrics.jsonl"))
    for r in recs:
        keys = set(r) - {"event", "wall"}
        assert keys == set(tprof.METRICS_KEYS) == set(jprof.METRICS_KEYS)
        assert r["schema"] == tprof.METRICS_SCHEMA_VERSION == \
            jprof.METRICS_SCHEMA_VERSION == 12
        assert r["jit_compiles"] == 0 and r["hbm_peak_bytes"] is None
        assert r["span_count"] is None and r["state_gathers"] == 0
    assert tprof.METRICS_KEYS == jprof.METRICS_KEYS
    # the reads of a production step with a cached dt: the (com, mass,
    # inertia), (diag, uvw) and forces reads, and BiCGSTAB's: the initial
    # test, two a iteration (the breakdown test, the flags), the final
    # one; plus the velocity's read when a dump preceded the step, and the
    # dt's after the restart (the uniform checkpoint caches none)
    for r in recs:
        dumped = os.path.exists(os.path.join(
            tdir, f"vel.{r['step'] - 1:08d}.xdmf2"))
        assert r["device_gets"] == 3 + 2 + 2 * r["poisson_iters"] \
            + dumped + (r["step"] == 11), r
    assert not os.path.exists(os.path.join(tdir, "spans.jsonl"))
    # post --metrics: the JAX post's summary keys
    from cup2d_tpu import post as jpost
    path = os.path.join(tdir, "metrics.jsonl")
    assert set(tpost.metrics_summary(path)) == \
        set(jpost.metrics_summary(path))
    assert tpost.main(["--metrics", path]) == 0


def test_cli_fresh_run_steps_and_counters(tmp_path):
    assert tmain.main(CAVITY + ["-maxSteps", "3", "-output",
                                str(tmp_path), "-tdump", "0"]) == 0
    recs = _records(str(tmp_path / "metrics.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert [r["jit_compiles"] for r in recs] == [0, 0, 0]
    assert all(r["case"] == "cavity" and r["kernel_tier"].startswith(
        "plain+bc(") for r in recs)
    assert not os.path.exists(tmp_path / "forces.csv")   # no shapes


def test_trace_window_parses_and_wraps_exact_steps(tmp_path, monkeypatch):
    monkeypatch.setenv("CUP2D_TRACE", "2:4")
    w = tprof.TraceWindow.from_env()
    assert (w.start, w.stop, w.logdir) == (2, 4, "trace")
    for bad in ("3", "a:b", "4:2"):
        monkeypatch.setenv("CUP2D_TRACE", bad)
        with pytest.raises(ValueError):
            tprof.TraceWindow.from_env()
    logdir = str(tmp_path / "tr")
    monkeypatch.setenv("CUP2D_TRACE", f"1:2:{logdir}")
    # a one-solve step keeps the trace small: fftd on the periodic box
    monkeypatch.setenv("CUP2D_POIS", "fftd")
    assert tmain.main(["-case", "tgv_periodic", "-level", "2", "-device",
                       "cpu", "-noSupervise", "-maxSteps", "3", "-output",
                       str(tmp_path)]) == 0
    ev = [json.loads(x) for x in open(tmp_path / "events.jsonl")]
    marks = [(e["event"], e["step"]) for e in ev
             if e["event"].startswith("trace")]
    assert marks == [("trace_start", 1), ("trace_stop", 2)]
    with open(os.path.join(logdir, "trace_1_2.json")) as f:
        assert json.load(f)["traceEvents"]


def test_sigterm_checkpoints_and_restart_resumes(tmp_path, monkeypatch):
    calls = []
    agree = tres.PreemptionGuard.agree

    def signalled(self):
        calls.append(1)
        if len(calls) == 4:      # the boundary before step 4
            os.kill(os.getpid(), signal.SIGTERM)
        return agree(self)
    monkeypatch.setattr(tres.PreemptionGuard, "agree", signalled)
    out = str(tmp_path / "run")
    assert tmain.main(CAVITY + ["-maxSteps", "10", "-output", out]) == 0
    ck = os.path.join(out, "checkpoint")
    assert json.load(open(os.path.join(ck, "meta.json")))["step_count"] == 3
    ev = [json.loads(x) for x in open(os.path.join(out, "events.jsonl"))]
    assert [(e["event"], e["step"], e["signum"]) for e in ev] == [
        ("sigterm_checkpoint", 3, int(signal.SIGTERM))]
    assert signal.getsignal(signal.SIGTERM) is not None
    monkeypatch.setattr(tres.PreemptionGuard, "agree", agree)
    assert tmain.main(CAVITY + ["-maxSteps", "5", "-output", out,
                                "-restart", ck]) == 0
    steps = [r["step"] for r in _records(os.path.join(out, "metrics.jsonl"))]
    assert steps == [1, 2, 3, 4, 5]


def test_nan_restart_aborts_with_postmortem(tmp_path):
    out = str(tmp_path / "run")
    assert tmain.main(CAVITY + ["-maxSteps", "2", "-output", out,
                                "-checkpointEvery", "2"]) == 0
    ck = os.path.join(out, "checkpoint")
    with np.load(os.path.join(ck, "fields.npz")) as d:
        fields = {k: d[k] for k in d.files}
    fields["vel"][0, 3, 3] = np.nan
    np.savez(os.path.join(ck, "fields.npz"), **fields)
    assert tmain.main(CAVITY + ["-maxSteps", "4", "-output", out,
                                "-restart", ck]) == 1
    pm = os.path.join(out, "postmortem")
    # the cavity's verdict lags a step (the CLI's default): step 3's bad
    # verdict lands after step 4 was dispatched, and the post-mortem holds
    # that state, as the JAX CLI's does
    assert json.load(open(os.path.join(pm, "meta.json")))["step_count"] == 4
    ev = [json.loads(x) for x in open(os.path.join(out, "events.jsonl"))]
    assert [(e["event"], e["action"], e["verdict"], e["step"])
            for e in ev] == [("recovery", "abort", "nonfinite", 2)]
    assert ev[0]["postmortem"] == pm


REFUSALS = [
    (["-serve", "6"], "-serve N needs -fleet B (the slot pool it serves "
                      "through)"),
    (["-mesh", "4", "-fleet", "2"], 8),
    (["-coordinator", "h:1"], 8),
    (["-meshHosts", "2"], 8), (["-processId", "0"], 8),
    (["-connectAttempts", "3"], 8), (["-connectBackoff", "1"], 8),
    (["-elastic"], 8), (["-elastic", "-mesh", "4"], 8),
    (["-simHosts", "2"], 8), (["-heartbeatMissK", "2"], 8),
    (["-heartbeatTimeout", "5"], 8), (["-mirror"], 8),
    (["-mirrorEvery", "2"], 8),
    (["-profile"], 9), (["-spansLog", "s.jsonl"], 9),
]


@pytest.mark.parametrize("flags,item", REFUSALS,
                         ids=[" ".join(f) for f, _ in REFUSALS])
def test_refused_flag_exits_2_naming_its_item(flags, item, tmp_path,
                                              capsys):
    """A flag the port cannot give names its ROADMAP item; a usage error of
    the JAX CLI gives its message."""
    assert tmain.main(CAVITY + flags + ["-output", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert (f"item {item}" if isinstance(item, int) else item) in err
    assert not os.listdir(tmp_path)                 # before any work


@pytest.mark.parametrize("env,item", [({"CUP2D_SPANS": "64"}, 9)])
def test_refused_supervision_and_env(env, item, tmp_path, monkeypatch,
                                     capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tmain.main(CAVITY + ["-output", str(tmp_path)]) == 2
    assert f"item {item}" in capsys.readouterr().err


SUPERVISED = [(["-guardRing", "2"], {}), (["-snapEvery", "3"], {}),
              ([], {"CUP2D_FAULTS": "nan_vel@2"}), ([], {})]


@pytest.mark.parametrize("flags,env", SUPERVISED,
                         ids=["-guardRing 2", "-snapEvery 3",
                              "CUP2D_FAULTS", "supervised"])
def test_supervised_runs(flags, env, tmp_path, monkeypatch):
    """The supervised loop (no ``-noSupervise``) with its ring and cadence
    flags and fault injection: rc 0, a live snapshot ring in every record,
    and the injected NaN recovered by the retry rung."""
    monkeypatch.delenv("CUP2D_FAULTS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = [a for a in CAVITY if a != "-noSupervise"]
    assert tmain.main(argv + flags + ["-maxSteps", "4", "-tdump", "0",
                                      "-output", str(tmp_path)]) == 0
    recs = _records(str(tmp_path / "metrics.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(r["snap_ring_bytes"] > 0 and r["state_gathers"] == 0
               for r in recs)
    ev = [json.loads(x) for x in open(tmp_path / "events.jsonl")]
    assert [(e["step"], e["action"]) for e in ev] == (
        [(2, "retry")] if env else [])
    assert sum(r["replayed_steps"] for r in recs) == 0


def test_usage_errors_and_accepted_switches(tmp_path, monkeypatch, capsys):
    assert tmain.main(["-case", "nope", "-noSupervise"]) == 2
    assert "catalog: cavity" in capsys.readouterr().err
    assert tpost.main(["--trace", "spans.jsonl"]) == 2
    assert "item 9" in capsys.readouterr().err
    monkeypatch.setenv("CUP2D_SPANS", "0")
    assert tmain.main(CAVITY + ["-maxSteps", "1", "-noLag", "-noSpans",
                                "-noMemLedger", "-noMirror", "-noMetrics",
                                "-noWatchdog", "-output",
                                str(tmp_path)]) == 0
    assert not os.path.exists(tmp_path / "metrics.jsonl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in CAVITY if a not in ("-device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(argv + ["-output", str(tmp_path / "card")])
    with pytest.raises(NotImplementedError, match="item 8"):
        tres.StepGuard(object(), mirror_hosts=2)


def test_verdict_and_watchdog_match_jax():
    """``health_verdict`` and ``PhysicsWatchdog`` classify as the JAX
    package's do, on host values and on tensors (one read)."""
    from cup2d_tpu import resilience as jres
    cases = [
        {"finite": True, "poisson_converged": True, "poisson_stalled": False,
         "poisson_residual": 1e-4},
        {"finite": False},
        {"finite": True, "poisson_residual": float("nan")},
        {"finite": True, "poisson_converged": False,
         "poisson_stalled": False, "poisson_residual": 0.5},
        {"finite": True, "poisson_converged": False,
         "poisson_stalled": True, "poisson_residual": 0.5},
        {"umax": float("inf")},
    ]
    for d in cases:
        for ok in (None, 1.0):
            assert tres.health_verdict(d, ok) == jres.health_verdict(d, ok)
    t = {"finite": torch.tensor(False), "umax": torch.tensor(1.0)}
    assert tres.health_verdict(t).reason == "nonfinite"
    tw, jw = tres.PhysicsWatchdog(), jres.PhysicsWatchdog()
    rng = np.random.default_rng(1)
    for _ in range(8):
        v = {"umax": 1 + 0.1 * rng.random(), "energy": 2 + 0.1 * rng.random(),
             "div_linf": 1e-6 * (1 + rng.random())}
        tw.observe(v)
        jw.observe(v)
    for bad in ({"umax": 9.0}, {"energy": 0.1}, {"div_linf": 1.0},
                {"umax": 1.05}):
        assert tw.check(bad) == jw.check(bad)
    assert tw.check({"energy": 0.1}) == "invariant_energy"
    assert vars(tres.PhysicsWatchdog.for_prec("bf16")).keys() == \
        vars(jres.PhysicsWatchdog.for_prec("bf16")).keys()


def test_streams_rotate_and_read_back(tmp_path):
    """``EventLog`` rotation, the readers over segments and a torn line,
    a record from a diag still holding tensors (one counted read), the
    timers and ``trace``."""
    from cup2d_tpu_torch import shapes_host
    path = str(tmp_path / "m.jsonl")
    log = tres.EventLog(path, rotate_mb=1e-4)       # ~105 bytes a segment
    counters = tprof.HostCounters().install()
    rec = tprof.MetricsRecorder(sink=log, counters=counters)
    before = shapes_host.pulls
    for k in range(3):
        rec.record_step(step=k + 1, t=0.1 * (k + 1), diag={
            "umax": torch.tensor(2.0), "poisson_iters": 3,
            "poisson_converged": torch.tensor(True)})
    log.close()
    assert shapes_host.pulls - before == 3
    with open(path, "a") as f:
        f.write('{"torn": ')
    recs, torn = tprof.load_metrics_report(path)
    assert torn == 1 and [r["step"] for r in recs] == [1, 2, 3]
    assert os.path.exists(path + ".1") and os.path.exists(path + ".3")
    assert recs[0]["umax"] == 2.0 and recs[0]["poisson_converged"] is True
    assert [r["device_gets"] for r in recs] == [1, 1, 1]
    summary = tprof.summarize_metrics(recs)
    assert summary["steps"] == 3 and summary["jit_compiles_total"] == 0
    counters.uninstall()
    timers = tprof.PhaseTimers()
    with timers.phase("step"):
        timers.fence("step", torch.zeros(2))
    assert timers.report()["step"]["count"] == 1
    sim = Simulation(SimConfig(bpdx=1, bpdy=1, extent=1.0, level_start=2,
                               dtype="float64"), device="cpu")
    assert tprof.throughput(sim)["cells"] == 32 * 32
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.path.exists(tmp_path / "tr" / "trace.json")


@pytest.mark.parametrize("kw,item", [("flight", 9)])
def test_recorder_slots_of_later_items_refuse(kw, item):
    """``MetricsRecorder``'s flight-recorder slot: a value raises, naming
    its ROADMAP item; without one the group is null."""
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tprof.MetricsRecorder(**{kw: object()})
    rec = tprof.MetricsRecorder().record_step(step=1, t=0.1, diag={})
    assert all(rec[k] is None for k in
               ("span_count", "compile_ms_total", "hbm_exec_bytes"))


def test_recorder_server_slot_takes_the_gauges():
    """``MetricsRecorder(server=...)``: the serving gauges of the server's
    ``telemetry_fields``; without a server, and on a solo record, the
    fleet and serving groups are null."""
    gauges = {"active_members": 2, "occupancy": 0.5, "admitted": 3,
              "evicted": 1, "queue_depth": 4}

    class Server:
        clients = None

        def telemetry_fields(self):
            return gauges
    rec = tprof.MetricsRecorder(server=Server()).record_step(
        step=1, t=0.1, diag={"umax": 1.0})
    assert {k: rec[k] for k in tprof._SERVE_KEYS} == gauges
    assert rec["fleet_members"] is None and rec["member_health"] is None
    rec = tprof.MetricsRecorder().record_step(step=1, t=0.1, diag={})
    assert all(rec[k] is None for k in
               tprof._SERVE_KEYS + ("fleet_members", "member_health"))


# the JAX package's fleet CLI drill at 32^2, f64
FLEET_FLAGS = ("-bpdx 1 -bpdy 1 -levelMax 1 -levelStart 0 -AdaptSteps 20 "
               "-Rtol 2 -Ctol 1 -extent 1 -CFL 0.4 -nu 0.001 -lambda 1e6 "
               "-poissonTol 1e-9 -poissonTolRel 1e-7 -maxPoissonRestarts 0 "
               "-maxPoissonIterations 100 -dtype float64 -level 2").split()


def _both_clis(flags, root):
    """Run the JAX CLI and the port's with ``flags`` into root/jax and
    root/port."""
    from cup2d_tpu import __main__ as jmain
    jdir, tdir = str(root / "jax"), str(root / "port")
    cache = jmain.enable_compilation_cache
    jmain.enable_compilation_cache = lambda: None   # no persistent cache
    try:
        assert jmain.main(flags + ["-output", jdir]) == 0
    finally:
        jmain.enable_compilation_cache = cache
    assert tmain.main(flags + ["-output", tdir, "-device", "cpu"]) == 0
    return jdir, tdir


def _metric_keys(path):
    return {frozenset(r) for r in tprof.load_metrics(path)
            if r.get("event") == "metrics"}


def test_cli_fleet_matches_jax(tmp_path):
    """``-fleet 4 -level 2``: 12 steps (the 10 exact startup solves among
    them) through both CLIs. Per-member dumps ``vel.NNNNNNNN.mK`` in the JAX
    layout (the same names and quads, attr within one f32 rounding), the
    last checkpoint's fields and per-member clocks <= 1e-10, equal
    iterations a step, the metrics records of the JAX key set."""
    flags = FLEET_FLAGS + ["-fleet", "4", "-tend", "10", "-tdump", "0.05",
                           "-maxSteps", "12", "-checkpointEvery", "12"]
    jdir, tdir = _both_clis(flags, tmp_path)
    dumps = sorted(f for f in os.listdir(jdir) if f.endswith(".xdmf2"))
    assert dumps and dumps == sorted(f for f in os.listdir(tdir)
                                     if f.endswith(".xdmf2"))
    assert {d.split(".")[2] for d in dumps} == {"m0", "m1", "m2", "m3"}
    for d in dumps:
        base = d[:-len(".xdmf2")]
        jt, jxyz, jattr = jio.read_dump(os.path.join(jdir, base))
        tt, txyz, tattr = tio.read_dump(os.path.join(tdir, base))
        assert abs(jt - tt) <= 1e-12 and np.array_equal(jxyz, txyz)
        assert np.allclose(jattr, tattr, rtol=2 ** -23, atol=1e-30), d
    jm = json.load(open(os.path.join(jdir, "checkpoint", "meta.json")))
    tm = json.load(open(os.path.join(tdir, "checkpoint", "meta.json")))
    assert jm["step_count"] == tm["step_count"] == 12
    assert tm["fleet"]["members"] == 4
    assert np.allclose(tm["fleet"]["times"], jm["fleet"]["times"],
                       rtol=1e-10, atol=0)
    with np.load(os.path.join(jdir, "checkpoint", "fields.npz")) as j, \
            np.load(os.path.join(tdir, "checkpoint", "fields.npz")) as t:
        assert j["vel"].shape == t["vel"].shape == (4, 2, 32, 32)
        assert _err(j["vel"], t["vel"]) <= TRAJ_BAR
        assert _err(j["pres"], t["pres"]) <= TRAJ_BAR
    jr, tr = (_records(os.path.join(d, "metrics.jsonl"))
              for d in (jdir, tdir))
    assert [r["member_health"]["poisson_iters"] for r in jr] == \
        [r["member_health"]["poisson_iters"] for r in tr]
    assert len(tr) == 12 and tr[-1]["fleet_members"] == 4
    assert _metric_keys(os.path.join(tdir, "metrics.jsonl")) == \
        _metric_keys(os.path.join(jdir, "metrics.jsonl"))


def test_cli_serve_matches_jax(tmp_path):
    """``-fleet 2 -serve 6``: the same admissions and retirements (slot,
    client, clock) as the JAX CLI, one client stream a session with the
    JAX stream's rows, session checkpoints, the ``serving_latency`` record
    and ``post``'s per-client summaries."""
    flags = FLEET_FLAGS + ["-fleet", "2", "-serve", "6", "-tend", "0.06",
                           "-tdump", "0"]
    jdir, tdir = _both_clis(flags, tmp_path)

    def lifecycle(d):
        return [(e["event"], e["member"], e["client"],
                 e.get("t0", e.get("t")))
                for e in map(json.loads, open(os.path.join(
                    d, "events.jsonl")))
                if e["event"] in ("member_admit", "member_retire")]
    jl, tl = lifecycle(jdir), lifecycle(tdir)
    assert [e[:3] for e in jl] == [e[:3] for e in tl]
    assert np.allclose([e[3] for e in jl], [e[3] for e in tl], rtol=1e-10,
                       atol=0)
    assert sum(e[0] == "member_retire" for e in tl) == 6
    names = sorted(os.listdir(os.path.join(jdir, "clients")))
    assert names == sorted(os.listdir(os.path.join(tdir, "clients")))
    assert len(names) == 6
    for n in names:
        jrows, trows = (tprof.load_metrics(os.path.join(d, "clients", n))
                        for d in (jdir, tdir))
        assert [r["step"] for r in jrows] == [r["step"] for r in trows]
        assert [r["poisson_iters"] for r in jrows] == \
            [r["poisson_iters"] for r in trows]
        assert np.allclose([r["umax"] for r in jrows],
                           [r["umax"] for r in trows], rtol=1e-10, atol=0)
        assert set(jrows[0]) == set(trows[0])
    assert sorted(os.listdir(os.path.join(tdir, "sessions"))) == \
        [n[:-len(".jsonl")] for n in names]
    lat = [r for r in tprof.load_metrics(os.path.join(tdir, "metrics.jsonl"))
           if r.get("event") == "serving_latency"]
    assert len(lat) == 1 and lat[0]["pool"]["step"]["count"] > 0
    assert _metric_keys(os.path.join(tdir, "metrics.jsonl")) == \
        _metric_keys(os.path.join(jdir, "metrics.jsonl"))
    summ = tpost.metrics_summary(os.path.join(tdir, "metrics.jsonl"))
    assert sorted(summ["clients"]) == [n[:-len(".jsonl")] for n in names]
    assert summ["admitted_total"] == 6 and summ["evicted_total"] == 0


# ---------------------------------------------------------------------------
# -mesh: the forest and the uniform path split over CPU shards
# ---------------------------------------------------------------------------

# one fish on a 2x1 root grid at level 3 with compression off, levelMax 5:
# more than 128 blocks, so a 2-shard mesh splits them (n_pad 256)
MESH_FOREST = ("-bpdx 2 -bpdy 1 -levelMax 5 -levelStart 3 -extent 2 "
               "-dtype float64 -CFL 0.4 -nu 0.0004 -lambda 1e6 -Rtol 2 "
               "-Ctol 0 -tdump 0.05 -tend 10 -AdaptSteps 5 "
               "-maxPoissonIterations 100 -maxPoissonRestarts 0 "
               "-poissonTol 1e-4 -poissonTolRel 1e-3 -device cpu").split() \
    + ["-shapes", "angle=0 L=0.4 xpos=1.0 ypos=0.5"]


@pytest.fixture(scope="module")
def mesh_cli(tmp_path_factory):
    """The forest CLI on ``-device cpu -mesh 2``, supervised: 6 steps with
    a checkpoint every 3, then 3 steps to a step-3 checkpoint and a
    ``-mesh 2`` restart from it to step 6."""
    root = tmp_path_factory.mktemp("mesh_cli")
    full, head, tail = (str(root / n) for n in ("full", "head", "tail"))
    ck = ["-checkpointEvery", "3"]
    rcs = (tmain.main(MESH_FOREST + ["-mesh", "2", "-maxSteps", "6",
                                     "-output", full] + ck),
           tmain.main(MESH_FOREST + ["-mesh", "2", "-maxSteps", "3",
                                     "-output", head] + ck),
           tmain.main(MESH_FOREST + ["-mesh", "2", "-maxSteps", "6",
                                     "-restart",
                                     os.path.join(head, "checkpoint"),
                                     "-output", tail] + ck))
    return rcs, full, head, tail


def test_cli_mesh_forest_reports_jax_halo_bytes(mesh_cli):
    """rc 0, the forest split over both shards, and every record's halo
    bytes non-null: the last equal to the JAX package's
    ``ShardedAMRSim._comm_stats`` on the same forest (the port's step-6
    checkpoint loaded into a JAX 2-device ``ShardedAMRSim``)."""
    from cup2d_tpu.parallel.forest_mesh import ShardedAMRSim as JShard
    from cup2d_tpu.parallel.mesh import make_mesh as jmake_mesh
    rcs, full, _, _ = mesh_cli
    assert rcs[0] == 0
    recs = _records(os.path.join(full, "metrics.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    assert all(r["halo_real_bytes"] is not None for r in recs)
    last = recs[-1]
    assert 0 < last["halo_real_bytes"] <= last["halo_padded_bytes"]
    argv = [a for a in MESH_FOREST if a not in ("-device", "cpu")]
    jsim = JShard(JConfig.from_argv(argv), jmake_mesh(2))
    jio.load_checkpoint(os.path.join(full, "checkpoint"), jsim)
    jsim._refresh()
    assert len(jsim.forest.blocks) == last["n_blocks"] > 128
    assert jsim._comm_stats == {
        "halo_real_bytes": last["halo_real_bytes"],
        "halo_padded_bytes": last["halo_padded_bytes"]}


def test_cli_mesh_forest_restart_bit_for_bit(mesh_cli):
    """The ``-mesh 2`` restart from its own step-3 checkpoint ends on the
    uninterrupted run bit for bit: the step-6 checkpoints' fields and
    meta, the common dumps' bytes, the forces rows of steps 4-6."""
    rcs, full, head, tail = mesh_cli
    assert rcs == (0, 0, 0)
    ca, cb = (os.path.join(d, "checkpoint") for d in (full, tail))
    with np.load(os.path.join(ca, "fields.npz")) as fa, \
            np.load(os.path.join(cb, "fields.npz")) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa.files)
    ma, mb = (json.load(open(os.path.join(c, "meta.json")))
              for c in (ca, cb))
    assert ma["step_count"] == 6 and ma == mb
    dumps = sorted({n for n in os.listdir(tail) if n.endswith(".attr.raw")}
                   & set(os.listdir(full)))
    assert dumps
    for n in dumps:
        with open(os.path.join(full, n), "rb") as fa, \
                open(os.path.join(tail, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    rows = open(os.path.join(full, "forces.csv")).read().splitlines()
    assert open(os.path.join(tail, "forces.csv")).read().splitlines() \
        == rows[:1] + rows[1 + 3:]


def test_cli_mesh_uniform_path_runs(tmp_path):
    """``-device cpu -mesh 2 -level 5`` runs the Taylor-Green-seeded
    ``ShardedUniformSim`` (256^2 on 2 shards), supervised, with rc 0; its
    checkpoint restarts on no mesh."""
    flags = FLEET_FLAGS[:-2] + ["-level", "5", "-tend", "1", "-tdump", "0",
                                "-device", "cpu"]
    out = str(tmp_path / "u")
    assert tmain.main(flags + ["-mesh", "2", "-maxSteps", "3",
                               "-checkpointEvery", "3", "-output", out]) == 0
    recs = _records(os.path.join(out, "metrics.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert recs[-1]["energy"] > 0 and recs[-1]["halo_real_bytes"] is None
    assert tmain.main(flags + ["-maxSteps", "4", "-restart",
                               os.path.join(out, "checkpoint"), "-output",
                               str(tmp_path / "solo")]) == 0


@pytest.mark.parametrize("flags,msg", [
    (["-mesh", "2", "-case", "turb2d"], "does not combine with -mesh"),
    (["-mesh", "all", "-device", "cpu"], "with -device, give the shard"),
])
def test_cli_mesh_usage_errors(flags, msg, tmp_path, capsys):
    """The JAX CLI's -mesh usage errors (a catalog case other than the
    cavity), and ``all`` beside ``-device``."""
    argv = FLEET_FLAGS[:-2] + ["-tend", "1", "-device", "cpu",
                               "-output", str(tmp_path)]
    assert tmain.main(argv + flags) == 2
    assert msg in capsys.readouterr().err
