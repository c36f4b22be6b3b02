"""The supervised loop of the port (``cup2d_tpu_torch.resilience.StepGuard``
and ``cup2d_tpu_torch.faults``) against the JAX package's, f64 on the CPU:
the drills of tests/test_resilience.py re-run on the port.

* ``FaultPlan``: every directive parses to the JAX plan's entries, and a
  typo or a missing step raises in both.
* The ladder, rung by rung, on the reference test's disk case (level 3):
  the same ``FaultPlan`` spec gives the same ``recovery`` events (step,
  verdict, action, rung, replayed) in both packages, and the final states
  agree to 1e-10 (the unfaulted runs of both agree to 4e-16 with equal
  iterations), besides the reference test's own bars against the port's
  unfaulted run: the NaN/Inf retry, the exact-Poisson escalation, the disk
  restore (bit for bit the unfaulted run), the abort with a loadable
  post-mortem, and the verdict-only abort.
* An unfaulted guarded run is bit for bit the unguarded one with the same
  device reads; a failed first step keeps the chi blend; the watchdog
  catches a finite x10 velocity.
* The crash window of ``save_checkpoint``: the load falls back to the
  parked ``.old`` bit for bit, loudly.
* The CLI, in process: a supervised NaN drill recovers with rc 0, the
  verdict-only one aborts with rc 1 and a post-mortem, ``sigterm@3``
  checkpoints step 3 and exits 0."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu import faults as jfaults  # noqa: E402
from cup2d_tpu import io as jio  # noqa: E402
from cup2d_tpu import resilience as jres  # noqa: E402
from cup2d_tpu.config import SimConfig as JConfig  # noqa: E402
from cup2d_tpu.models import DiskShape as JDisk  # noqa: E402
from cup2d_tpu.sim import Simulation as JSim  # noqa: E402
from cup2d_tpu_torch import __main__ as tmain  # noqa: E402
from cup2d_tpu_torch import faults as tfaults  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch import profiling as tprof  # noqa: E402
from cup2d_tpu_torch import resilience as tres  # noqa: E402
from cup2d_tpu_torch.config import SimConfig  # noqa: E402
from cup2d_tpu_torch.models import DiskShape, FishShape  # noqa: E402
from cup2d_tpu_torch.sim import Simulation  # noqa: E402
from cup2d_tpu_torch.uniform import taylor_green_state  # noqa: E402

JAX_BAR = 1e-10
BASE = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
            nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
            max_poisson_iterations=100)
DISK = (0.1, 0.4, 0.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim():
    return Simulation(SimConfig(**BASE),
                      shapes=[DiskShape(*DISK, prescribed=(0.2, 0.0))],
                      level=3, device="cpu")


@pytest.fixture(scope="module")
def jax_disk():
    """``fresh()``: the JAX package's disk case at t = 0, initialized. One
    instance, restored from its own device snapshot for each drill, so its
    jitted steps compile once for the module."""
    js = JSim(JConfig(**BASE), shapes=[JDisk(*DISK, prescribed=(0.2, 0.0))],
              level=3)
    js.initialize()
    snap = jio.snapshot_state_device(js)

    def fresh():
        jio.restore_snapshot_device(js, snap)
        js.force_log = None
        return js
    return fresh


def _events(path):
    with open(path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    return [e for e in evs if e.get("event") == "recovery"]


def _key(evs):
    return [(e["step"], e["verdict"], e["action"], e.get("rung"),
             e.get("replayed")) for e in evs]


def _err(a, b):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.max(np.abs(a - b)))


def _drive_to(sim, tend, stepper):
    """Advance to exactly ``tend`` (last dt clipped), so faulted and
    unfaulted runs compare at the same time."""
    while sim.time < tend:
        if sim._next_dt is not None:
            dt = min(float(sim._next_dt), sim._kinematic_dt_cap())
        else:
            dt = min(float(sim.grid.compute_dt(sim.state.vel)),
                     sim._kinematic_dt_cap())
        stepper(min(dt, tend - sim.time + 1e-15))


def _jax_drive_to(sim, tend, stepper):
    while sim.time < tend:
        if sim._next_dt is not None:
            dt = min(sim._next_dt, sim._kinematic_dt_cap())
        else:
            dt = min(float(sim._dt(sim.state.vel)),
                     sim._kinematic_dt_cap())
        stepper(min(dt, tend - sim.time + 1e-15))


def _pair(tmp_path, jax_disk, spec, drive, **kw):
    """The same drill on both packages: ``drive(sim, guard)`` on a fresh
    port disk sim and on the JAX one, each guarded with ``FaultPlan(spec)``
    and ``kw``. Returns (port sim, port events, JAX sim, JAX events)."""
    out = []
    for pkg, sim in (("port", _sim()), ("jax", jax_disk())):
        mod = tres if pkg == "port" else jres
        fmod = tfaults if pkg == "port" else jfaults
        path = str(tmp_path / f"{pkg}.jsonl")
        kw2 = {k: (v.replace("@PKG", pkg) if isinstance(v, str) else v)
               for k, v in kw.items()}
        guard = mod.StepGuard(sim, event_log=mod.EventLog(path),
                              faults=fmod.FaultPlan(spec), **kw2)
        raised = None
        try:
            drive(sim, guard)
        except (tres.ResilienceAbort, jres.ResilienceAbort) as e:
            raised = e
        guard.event_log.close()
        out += [sim, _events(path), raised]
    return out


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

PLAN_ATTRS = ("vel_poison", "vel_scale", "giveup", "sigterm_steps",
              "crash_points", "host_loss", "shard_loss", "mirror_corrupt")


@pytest.mark.parametrize("spec", [
    "nan_vel@3, poisson_giveup@5*2, sigterm@7,crash_in_save",
    "inf_vel@2*3,scale_vel@4",
    "host_exit@3,host_hang@3,shard_loss@3*2,mirror_corrupt@5",
    "crash_in_save*2, nan_vel@0*4",
    "",
])
def test_fault_plan_parses_as_jax(spec):
    t, j = tfaults.FaultPlan(spec), jfaults.FaultPlan(spec)
    for a in PLAN_ATTRS:
        tv, jv = getattr(t, a), getattr(j, a)
        if a == "vel_poison":
            tv = {k: [repr(v[0]), v[1]] for k, v in tv.items()}
            jv = {k: [repr(v[0]), v[1]] for k, v in jv.items()}
        assert tv == jv, a
    assert bool(t) == bool(j) == bool(spec)


@pytest.mark.parametrize("spec", ["tyop_fault@3", "nan_vel", "sigterm",
                                  "poisson_giveup", "scale_vel*2"])
def test_fault_plan_refuses_as_jax(spec):
    with pytest.raises(ValueError) as te:
        tfaults.FaultPlan(spec)
    with pytest.raises(ValueError) as je:
        jfaults.FaultPlan(spec)
    assert str(te.value) == str(je.value)


def test_fault_plan_consumes_and_suspends(monkeypatch):
    p = tfaults.FaultPlan("poisson_giveup@5*2,nan_vel@1,crash_in_save")
    with p.suspend():
        assert not p.poisson_giveup_at(5)
    assert p.poisson_giveup_at(5) and p.poisson_giveup_at(5)
    assert not p.poisson_giveup_at(5)      # count exhausted
    sim = _sim()
    sim.step_count = 1
    vel0 = sim.state.vel
    with p.suspend():
        assert p.apply_pre_step(sim) == []
    fired = p.apply_pre_step(sim)
    assert len(fired) == 1 and fired[0][1] == 0
    assert torch.isnan(sim.state.vel[0, 0, 0])
    assert torch.isfinite(vel0).all()      # a new tensor, never in place
    tfaults.install(p)
    try:
        with pytest.raises(tfaults.InjectedCrash):
            tfaults.crash_point("checkpoint_install")
        tfaults.crash_point("checkpoint_install")   # consumed
    finally:
        tfaults.install(None)
    assert tfaults.active() is None


# ---------------------------------------------------------------------------
# zero overhead: bit for bit, the same reads
# ---------------------------------------------------------------------------

def test_guard_unfaulted_bit_identical_uniform():
    def run(guarded):
        sim = _sim()
        guard = tres.StepGuard(sim) if guarded else None
        c = tprof.HostCounters().install()
        for _ in range(5):
            guard.step() if guarded else sim.step_once()
        if guarded:
            guard.drain()
        c.uninstall()
        return sim, c.snapshot()

    (a, ca), (b, cb) = run(False), run(True)
    assert torch.equal(a.state.vel, b.state.vel)
    assert torch.equal(a.state.pres, b.state.pres)
    assert a.time == b.time
    # the shaped step verdicts eagerly from its own read: no extra read,
    # no state gather
    assert cb == ca and cb["state_gathers"] == 0


# ---------------------------------------------------------------------------
# the ladder, rung by rung, against the JAX guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("directive", ["nan_vel@3", "inf_vel@3"])
def test_rung1_poison_recovers_via_rewind(tmp_path, jax_disk, directive):
    tend = 0.3
    ref = _sim()
    _drive_to(ref, tend, lambda dt: ref.step_once(dt=dt))
    sim, evs, _, js, jevs, _ = _pair(
        tmp_path, jax_disk, directive,
        lambda s, g: (_drive_to if isinstance(s, Simulation)
                      else _jax_drive_to)(s, tend,
                                          lambda dt: g.step(dt=dt)))
    assert _key(evs) == _key(jevs) == [(3, "nonfinite", "retry", 0, 0)]
    assert abs(sim.time - ref.time) < 1e-12
    vel, ref_v = sim.state.vel, ref.state.vel
    assert torch.isfinite(vel).all()
    # the reference test's bars against the unfaulted run
    assert abs(vel.abs().max() - ref_v.abs().max()) \
        <= 2e-3 * ref_v.abs().max()
    assert torch.linalg.norm(vel - ref_v) / torch.linalg.norm(ref_v) < 0.05
    assert _err(vel, js.state.vel) <= JAX_BAR
    assert abs(sim.time - js.time) <= 1e-14


def test_rung2_escalates_to_exact_poisson(tmp_path, jax_disk):
    def drive(s, g):
        for _ in range(5):
            g.step()
    sim, evs, _, js, jevs, _ = _pair(tmp_path, jax_disk,
                                     "poisson_giveup@2*2", drive)
    assert _key(evs) == _key(jevs) == [
        (2, "poisson_giveup(injected)", "retry", 0, 0),
        (2, "poisson_giveup(injected)", "escalate", 1, 0)]
    assert sim.step_count == 5 and not sim._force_exact
    assert _err(sim.state.vel, js.state.vel) <= JAX_BAR


def test_rung3_disk_restore_replays_bit_exactly(tmp_path, jax_disk):
    tend = 0.3
    ref = _sim()
    while ref.time < tend:
        ref.step_once()

    def drive(s, g):
        save = (tio.save_checkpoint if isinstance(s, Simulation)
                else jio.save_checkpoint)
        while s.time < tend:
            g.step()
            if s.step_count == 2:
                save(g.ckpt_dir, s)
    sim, evs, _, js, jevs, _ = _pair(
        tmp_path, jax_disk, "poisson_giveup@4*3", drive,
        ckpt_dir=str(tmp_path / "ck-@PKG"))
    assert _key(evs) == _key(jevs) == [
        (4, "poisson_giveup(injected)", "retry", 0, 0),
        (4, "poisson_giveup(injected)", "escalate", 1, 0),
        (4, "poisson_giveup(injected)", "disk_restore", 2, 0)]
    # after the restore the run makes steps 2..4 again on the normal path
    # (the give-up budget is spent): the unfaulted run, bit for bit
    assert torch.equal(sim.state.vel, ref.state.vel)
    assert sim.time == ref.time and sim.step_count == ref.step_count
    assert _err(sim.state.vel, js.state.vel) <= JAX_BAR


def test_rung4_abort_leaves_postmortem(tmp_path, jax_disk):
    def drive(s, g):
        g.step()
        g.step()
    sim, evs, err, js, jevs, jerr = _pair(
        tmp_path, jax_disk, "nan_vel@1*4", drive,
        postmortem_dir=str(tmp_path / "pm-@PKG"))
    assert isinstance(err, tres.ResilienceAbort)
    assert isinstance(jerr, jres.ResilienceAbort)
    assert _key(evs) == _key(jevs) == [
        (1, "nonfinite", "retry", 0, 0), (1, "nonfinite", "escalate", 1, 0),
        (1, "nonfinite", "abort", None, None)]
    pm = str(tmp_path / "pm-port")
    assert evs[-1]["postmortem"] == pm
    # the post-mortem loads, in both packages' loaders
    fresh = _sim()
    tio.load_checkpoint(pm, fresh)
    assert fresh.step_count == sim.step_count == js.step_count
    assert torch.isnan(fresh.state.vel).any()
    jio.load_checkpoint(pm, jax_disk())


def test_rung4_abort_closes_the_force_log(tmp_path):
    sim = _sim()
    sim.force_log = open(tmp_path / "forces.csv", "w")
    guard = tres.StepGuard(sim, faults=tfaults.FaultPlan("nan_vel@1*3"))
    guard.step()
    with pytest.raises(tres.ResilienceAbort, match="ladder exhausted"):
        guard.step()
    assert sim.force_log.closed and guard.recoveries == 2


def test_verdict_only_mode_aborts_first_failure(tmp_path, jax_disk):
    def drive(s, g):
        g.step()
        g.step()
    sim, evs, err, js, jevs, jerr = _pair(
        tmp_path, jax_disk, "nan_vel@1", drive, recover=False,
        postmortem_dir=str(tmp_path / "pm-@PKG"))
    assert err is not None and jerr is not None
    assert _key(evs) == _key(jevs) == [(1, "nonfinite", "abort", None, None)]
    assert os.path.exists(tmp_path / "pm-port" / "meta.json")


def test_first_step_failure_keeps_chi_blend(tmp_path):
    """The ring's seed is taken after the lazy chi blend: a rewind after a
    failed first step must not skip it."""
    def mk():
        cfg = SimConfig(**BASE)
        return Simulation(cfg, shapes=[FishShape(0.2, 0.5, 0.5, 0.0,
                                                 cfg.min_h)],
                          level=3, device="cpu")
    sim = mk()
    log = tres.EventLog(str(tmp_path / "ev.jsonl"))
    guard = tres.StepGuard(sim, event_log=log,
                           faults=tfaults.FaultPlan("poisson_giveup@0"))
    guard.step()
    log.close()
    evs = _events(tmp_path / "ev.jsonl")
    assert _key(evs) == [(0, "poisson_giveup(injected)", "retry", 0, 0)]
    # a fresh run stepped once at the same (halved) dt: bit for bit
    ref = mk()
    ref.step_once(dt=sim.time)
    assert torch.equal(sim.state.vel, ref.state.vel)


def test_watchdog_catches_finite_corruption(tmp_path):
    """``scale_vel``: every value stays finite, the isfinite verdict
    passes, and the physics watchdog's umax band walks the ladder."""
    sim = Simulation(SimConfig(**BASE), shapes=[], level=3, device="cpu")
    sim.state = taylor_green_state(sim.grid)
    sim.step_count = 20
    log = tres.EventLog(str(tmp_path / "ev.jsonl"))
    guard = tres.StepGuard(sim, event_log=log,
                           faults=tfaults.FaultPlan("scale_vel@30"),
                           watchdog=tres.PhysicsWatchdog())
    while sim.step_count < 32:
        guard.step()
    guard.drain()
    log.close()
    assert _key(_events(tmp_path / "ev.jsonl")) == [
        (30, "invariant_umax", "retry", 0, 0)]
    assert float(sim.state.vel.abs().max()) < 1.5


# ---------------------------------------------------------------------------
# the crash window of save_checkpoint
# ---------------------------------------------------------------------------

def test_crash_mid_save_restores_old_bitexact(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    sim = _sim()
    sim.step_once()
    sim.step_once()
    tio.save_checkpoint(ck, sim)                 # the survivor
    with np.load(os.path.join(ck, "fields.npz")) as d:
        v1 = {k: np.array(d[k]) for k in d.files}
    sim.step_once()
    tfaults.install(tfaults.FaultPlan("crash_in_save"))
    try:
        with pytest.raises(tfaults.InjectedCrash):
            tio.save_checkpoint(ck, sim)         # dies park -> install
    finally:
        tfaults.install(None)
    assert not os.path.exists(os.path.join(ck, "meta.json"))
    assert os.path.exists(os.path.join(ck + ".old", "meta.json"))
    log = tres.EventLog(str(tmp_path / "events.jsonl"))
    tres.set_event_log(log)
    try:
        fresh = _sim()
        tio.load_checkpoint(ck, fresh)
    finally:
        tres.set_event_log(None)
        log.close()
    assert "falling back" in capsys.readouterr().err
    with open(tmp_path / "events.jsonl") as f:
        assert any(json.loads(x).get("event") == "checkpoint_fallback_old"
                   for x in f)
    assert fresh.step_count == 2
    for k, v in v1.items():
        assert np.array_equal(getattr(fresh.state, k).numpy(), v), k


# ---------------------------------------------------------------------------
# the CLI, in process
# ---------------------------------------------------------------------------

CLI = ["-bpdx", "1", "-bpdy", "1", "-levelMax", "1", "-levelStart", "0",
       "-Rtol", "2", "-Ctol", "1", "-extent", "1", "-CFL", "0.4",
       "-tend", "1", "-lambda", "1e6", "-nu", "0.001",
       "-poissonTol", "1e-3", "-poissonTolRel", "1e-2",
       "-maxPoissonRestarts", "0", "-maxPoissonIterations", "100",
       "-AdaptSteps", "20", "-tdump", "0", "-level", "3",
       "-dtype", "float64", "-device", "cpu",
       "-shapes", "angle=0 L=0.25 xpos=0.5 ypos=0.5"]


def _cli(out, extra, monkeypatch, fault=None):
    monkeypatch.delenv("CUP2D_TRACE", raising=False)
    if fault:
        monkeypatch.setenv("CUP2D_FAULTS", fault)
    else:
        monkeypatch.delenv("CUP2D_FAULTS", raising=False)
    return tmain.main(CLI + ["-output", str(out)] + extra)


def test_cli_supervised_nan_drill_recovers(tmp_path, monkeypatch):
    out = tmp_path / "run"
    assert _cli(out, ["-maxSteps", "4"], monkeypatch, "nan_vel@2") == 0
    evs = _events(out / "events.jsonl")
    assert _key(evs) == [(2, "nonfinite", "retry", 0, 0)]
    recs = [r for r in tprof.load_metrics(str(out / "metrics.jsonl"))
            if r.get("event") == "metrics"]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(r["snap_ring_bytes"] > 0 and r["state_gathers"] == 0
               for r in recs)
    assert tfaults.active() is None      # the plan is the run's only


def test_cli_nan_abort_via_guard(tmp_path, monkeypatch):
    out = tmp_path / "run"
    assert _cli(out, ["-maxSteps", "6", "-noSupervise"], monkeypatch,
                "inf_vel@2") == 1
    assert os.path.exists(out / "postmortem" / "meta.json")
    aborts = [e for e in _events(out / "events.jsonl")
              if e["action"] == "abort"]
    assert len(aborts) == 1 and aborts[0]["verdict"] == "nonfinite"


def test_cli_sigterm_fault_checkpoints(tmp_path, monkeypatch):
    out = tmp_path / "run"
    assert _cli(out, ["-maxSteps", "8"], monkeypatch, "sigterm@3") == 0
    assert json.load(open(out / "checkpoint" / "meta.json"))[
        "step_count"] == 3
    sig = [json.loads(x) for x in open(out / "events.jsonl")]
    assert [(e["event"], e["step"]) for e in sig] == [
        ("sigterm_checkpoint", 3)]
