"""Per-member supervision and the serving pool of the port
(``resilience.FleetStepGuard``, ``fleet.FleetServer``), f64 on the CPU at
32^2, B = 3, after the JAX package's tests of the same names.

* ``nan_vel@24`` under a snapshot cadence rewinds only member 0 (restore
  its slice, replay solo, retry at dt/2): members 1 and 2 and their clocks
  stay bit-identical to an unfaulted run, and the recovery events equal
  the JAX guard's on the same run.
* ``nan_vel@24*3`` exhausts member 0's ladder in a serving pool: it is
  evicted (``retry``, ``escalate``, ``member_aborted``, ``member_evict``),
  its slot zeroed, and the healthy members and clocks stay bit-identical.
* A live member's trajectory is bit-identical under co-member churn; an
  all-True mask is the unmasked step bit for bit and a parked slot stays
  frozen; a session parked to its checkpoint and admitted again resumes
  bit-exact; churn adds no device read but the retiree's checkpoint and no
  kernel build (``HostCounters.jit_compiles``).
* The fleet's metrics record (schema v3 and v7 keys, the JAX package's
  aggregates), per-client streams and their ``post`` summaries.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.faults import FaultPlan as JFaultPlan  # noqa: E402
from cup2d_tpu.fleet import FleetSim as JFleet  # noqa: E402
from cup2d_tpu.fleet import taylor_green_fleet as jtg_fleet  # noqa: E402
from cup2d_tpu.resilience import EventLog as JEventLog  # noqa: E402
from cup2d_tpu.resilience import FleetStepGuard as JGuard  # noqa: E402
from cup2d_tpu_torch import post as tpost  # noqa: E402
from cup2d_tpu_torch import profiling as tprof  # noqa: E402
from cup2d_tpu_torch import shapes_host  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.convert import copy_fleet_state  # noqa: E402
from cup2d_tpu_torch.faults import FaultPlan  # noqa: E402
from cup2d_tpu_torch.fleet import FleetRequest  # noqa: E402
from cup2d_tpu_torch.fleet import FleetServer  # noqa: E402
from cup2d_tpu_torch.fleet import FleetSim  # noqa: E402
from cup2d_tpu_torch.fleet import taylor_green_fleet  # noqa: E402
from cup2d_tpu_torch.io import load_member_checkpoint  # noqa: E402
from cup2d_tpu_torch.resilience import EventLog  # noqa: E402
from cup2d_tpu_torch.resilience import FleetStepGuard  # noqa: E402
from cup2d_tpu_torch.resilience import PhysicsWatchdog  # noqa: E402
from cup2d_tpu_torch.tracing import ServingLatency  # noqa: E402
from cup2d_tpu_torch.uniform import taylor_green_state  # noqa: E402

LVL = 2                   # 32 x 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                     extent=1.0, nu=1e-3, cfl=0.4, lam=1e6,
                     dtype="float64", max_poisson_iterations=100)


def _pool(members=3):
    """A production-regime pool: the exact startup solves skipped, as in
    the JAX package's serving tests."""
    import dataclasses
    sim = FleetSim(config_from_dict(dataclasses.asdict(_jcfg())),
                   level=LVL, members=members, device="cpu")
    sim.step_count = 20
    return sim


def _session_state(grid, m):
    """Session m: the Taylor-Green vortex at amplitude 0.8**m (its own
    umax and dt)."""
    st = taylor_green_state(grid)
    return st._replace(vel=st.vel * (0.8 ** m))


def _dt0(sim, m):
    return float(sim.grid.compute_dt(_session_state(sim.grid, m).vel))


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _recoveries(path):
    return [(e["step"], e["member"], e["action"], e["verdict"], e["rung"],
             e["replayed"]) for e in _events(path)
            if e.get("event") == "recovery"]


# ---------------------------------------------------------------------------
# per-member supervision
# ---------------------------------------------------------------------------

def test_fleet_member_fault_rewinds_only_that_member(tmp_path):
    n = 6
    twin = _pool(3)
    twin.state = taylor_green_fleet(twin.grid, 3)
    for _ in range(n):
        twin.step_once()

    sim = _pool(3)
    sim.state = taylor_green_fleet(sim.grid, 3)
    guard = FleetStepGuard(sim, event_log=EventLog(str(tmp_path / "t.jsonl")),
                           snap_every=3, faults=FaultPlan("nan_vel@24"),
                           watchdog=PhysicsWatchdog())
    assert not guard.lag and not sim.async_diag
    recs = [guard.step() for _ in range(n)]
    guard.drain()

    js = JFleet(_jcfg(), level=LVL, members=3)
    js.state = jtg_fleet(js.grid, 3)
    js.step_count = 20
    jguard = JGuard(js, event_log=JEventLog(str(tmp_path / "j.jsonl")),
                    snap_every=3, faults=JFaultPlan("nan_vel@24"))
    for _ in range(n):
        jguard.step()
    jguard.drain()

    evs = _recoveries(tmp_path / "t.jsonl")
    assert evs == _recoveries(tmp_path / "j.jsonl")
    assert evs == [(24, 0, "retry", "nonfinite", 0, 1)]
    assert guard.replayed_steps == 1
    for m in (1, 2):                    # the healthy members never rewind
        assert torch.equal(twin.state.vel[m], sim.state.vel[m]), m
        assert torch.equal(twin.state.pres[m], sim.state.pres[m]), m
        assert twin.times[m] == sim.times[m]
    assert torch.isfinite(sim.state.vel[0]).all()
    assert sim.times[0] < twin.times[0]        # its retry ran at dt/2
    assert abs(sim.times[0] - js.times[0]) <= 1e-12
    assert sim.step_count == twin.step_count == 26
    # the record of the recovered step: per-member rows, the member's
    # retried dt in its slot
    assert recs[3]["step"] == 24 and len(recs[3]["dt"]) == 3
    assert recs[3]["dt"][0] < recs[3]["dt"][1]


def test_eviction_pins_healthy_members_bit_identical(tmp_path):
    n = 7

    def run(spec):
        sim = _pool(3)
        log = EventLog(str(tmp_path / f"ev_{bool(spec)}.jsonl"))
        guard = FleetStepGuard(sim, event_log=log,
                               faults=FaultPlan(spec) if spec else None)
        server = FleetServer(sim, guard=guard, event_log=log)
        for m in range(3):
            server.submit(FleetRequest(client_id=f"c{m}",
                                       state=_session_state(sim.grid, m)))
        for _ in range(n):
            assert server.step() is not None
        log.close()
        return sim, server

    sim_t, srv_t = run(None)
    sim_f, srv_f = run("nan_vel@24*3")
    assert srv_t.evicted == 0
    assert srv_f.evicted == 1 and srv_f.guard.evictions == 1
    assert not srv_f.active[0] and srv_f.client_of(0) is None
    assert srv_f.active[1] and srv_f.active[2]
    for m in (1, 2):
        assert torch.equal(sim_t.state.vel[m], sim_f.state.vel[m]), m
        assert sim_t.times[m] == sim_f.times[m], m
    assert (sim_f.member_state(0).vel == 0).all()
    assert sim_f.step_count == sim_t.step_count == 20 + n
    evs = _events(tmp_path / "ev_True.jsonl")
    kinds = [(e["event"], e.get("action")) for e in evs
             if e["event"] != "member_admit"]
    assert kinds == [("recovery", "retry"), ("recovery", "escalate"),
                     ("member_aborted", "evict"), ("member_evict", None)]
    assert evs[-1]["client"] == "c0" and evs[-1]["member"] == 0


# ---------------------------------------------------------------------------
# the serving pool
# ---------------------------------------------------------------------------

def test_member_trajectory_bit_identical_under_co_member_churn():
    n = 8

    def run(churn):
        sim = _pool(3)
        server = FleetServer(sim)
        dt1, dt2 = _dt0(sim, 1), _dt0(sim, 2)

        def req(cid, m, t_end=np.inf):
            return FleetRequest(client_id=cid,
                                state=_session_state(sim.grid, m),
                                t_end=float(t_end))
        server.submit(req("keep", 0))
        if churn:
            server.submit(req("s1", 1, 1.9 * dt1))
            server.submit(req("s2", 2, 2.9 * dt2))
        for k in range(n):
            if churn and k == 4:
                server.submit(req("s3", 1, 1.9 * dt1))
                server.submit(req("s4", 2, 2.9 * dt2))
            assert server.step() is not None
        st = sim.member_state(0)
        return st.vel, st.pres, float(sim.times[0]), server

    v_a, p_a, t_a, srv_a = run(False)
    v_b, p_b, t_b, srv_b = run(True)
    assert srv_a.retired == 0 and srv_a.admitted == 1
    assert srv_b.admitted == 5 and srv_b.retired >= 3
    assert srv_b.client_of(0) == "keep"
    assert torch.equal(v_a, v_b) and torch.equal(p_a, p_b)
    assert t_a == t_b


def test_all_true_mask_bit_identical_and_parked_slot_frozen():
    n = 3
    plain = _pool(3)
    plain.state = taylor_green_fleet(plain.grid, 3)
    masked = _pool(3)
    masked.state = taylor_green_fleet(masked.grid, 3)
    masked.set_active(np.ones(3, dtype=bool))
    dp = dm = None
    for _ in range(n):
        dp = plain.step_once()
        dm = masked.step_once()
    assert torch.equal(plain.state.vel, masked.state.vel)
    assert torch.equal(plain.state.pres, masked.state.pres)
    assert np.array_equal(plain.times, masked.times)
    assert np.array_equal(dp["poisson_iters"], dm["poisson_iters"])

    v2, p2 = masked.member_state(2).vel, masked.member_state(2).pres
    t2 = float(masked.times[2])
    v0 = masked.member_state(0).vel
    masked.set_active(np.array([True, True, False]))
    diag = None
    for _ in range(3):
        diag = masked.step_once()
    assert torch.equal(masked.member_state(2).vel, v2)
    assert torch.equal(masked.member_state(2).pres, p2)
    assert float(masked.times[2]) == t2
    assert not torch.equal(masked.member_state(0).vel, v0)
    assert diag["poisson_iters"][2] == 0 and diag["poisson_converged"][2]
    assert diag["dt"][2] == 0.0 and diag["div_linf"][2] == 0.0
    assert masked.time == min(masked.times[0], masked.times[1])


def test_admit_from_checkpoint_bit_exact_resume(tmp_path):
    probe = _pool(2)
    dt0 = _dt0(probe, 0)
    T = 4.6 * dt0        # about 5 steps
    t_mid = 2.6 * dt0    # parked after about 3

    def serve(sdir, horizons):
        sim = _pool(2)
        server = FleetServer(sim, session_dir=str(sdir))
        ckpt, times = None, []
        for t_end in horizons:
            server.submit(FleetRequest(
                client_id="X", checkpoint=ckpt,
                state=None if ckpt else _session_state(sim.grid, 0),
                t_end=t_end))
            assert server.drain() > 0
            ckpt = os.path.join(str(sdir), "X")
            times.append(load_member_checkpoint(ckpt, sim.grid)[1]["time"])
        return sim, ckpt, times

    sim_r, ck_r, _ = serve(tmp_path / "ref", [T])
    sim_s, ck_s, t_s = serve(tmp_path / "split", [t_mid, T])
    assert t_mid <= t_s[0] < T
    st_r, meta_r = load_member_checkpoint(ck_r, sim_r.grid)
    st_s, meta_s = load_member_checkpoint(ck_s, sim_s.grid)
    assert meta_r["time"] >= T
    for name, a, b in zip(st_r._fields, st_r, st_s):
        assert torch.equal(a, b), name
    assert meta_r["time"] == meta_s["time"]
    assert meta_r["next_dt"] == meta_s["next_dt"]
    with pytest.raises(ValueError, match="neither state nor checkpoint"):
        FleetServer(_pool(1)).step() or FleetServer(_pool(1))._admit(
            0, FleetRequest(client_id="none"))


def _step_reads(diag):
    """The reads of one fleet step: the solver's first flag read, one a
    solver iteration of the slowest member, and the stacked diagnostic
    read."""
    return 2 + int(np.max(diag["poisson_iters"]))


def test_churn_adds_no_device_reads(tmp_path):
    """Reads a serving cycle: the fixed-B fleet step's, plus one for each
    retiree's session checkpoint; the slot writes and the mask push read
    nothing."""
    n = 6
    fixed = _pool(3)
    fixed.state = taylor_green_fleet(fixed.grid, 3)
    fixed.set_active(np.ones(3, dtype=bool))
    for _ in range(n):
        p0 = shapes_host.pulls
        d = fixed.step_once()
        assert shapes_host.pulls - p0 == _step_reads(d)

    sim = _pool(3)
    server = FleetServer(sim, session_dir=str(tmp_path / "sessions"))
    dt = [_dt0(sim, m) for m in range(3)]
    for i in range(6):
        server.submit(FleetRequest(
            client_id=f"c{i}", state=_session_state(sim.grid, i % 3),
            t_end=(2 + i % 2 - 0.1) * dt[i % 3]))
    for k in range(n):
        r0 = server.retired
        p0 = shapes_host.pulls
        d = server.step()
        extra = server.retired - r0
        assert shapes_host.pulls - p0 == _step_reads(d) + extra, k
    assert server.retired >= 3 and server.admitted == 6


def test_zero_recompile_steady_state_churn(tmp_path):
    """After warm-up, admit, retire and a second eviction build no kernel
    (``jit_compiles`` counts kernel-library builds and loads: on the card
    the first step pays them, churn none; on the CPU none at all)."""
    sim = _pool(3)
    log = EventLog(str(tmp_path / "events.jsonl"))
    guard = FleetStepGuard(sim, event_log=log,
                           faults=FaultPlan("nan_vel@26*3,nan_vel@33*3"))
    server = FleetServer(sim, guard=guard, event_log=log)
    n_req = 0

    def submit(horizon_steps):
        nonlocal n_req
        st = _session_state(sim.grid, n_req % 3)
        dt0 = float(sim.grid.compute_dt(st.vel))
        server.submit(FleetRequest(client_id=f"c{n_req:03d}", state=st,
                                   t_end=(horizon_steps - 0.1) * dt0))
        n_req += 1

    for _ in range(3):
        submit(2)
    for _ in range(9):                     # steps 20..28, evict at 26
        submit(2)
        server.step()
    assert server.evicted == 1
    c = tprof.HostCounters().install()
    retired0, admitted0 = server.retired, server.admitted
    for _ in range(8):                     # steps 29..36, evict at 33
        submit(3)
        server.step()
    c.uninstall()
    assert server.evicted == 2 and guard.evictions == 2
    assert server.retired > retired0 and server.admitted > admitted0
    assert c.snapshot()["jit_compiles"] == 0
    log.close()


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_fleet_metrics_record_and_client_streams(tmp_path):
    """The schema-v3 fleet record (per-member rows, the JAX package's
    aggregates), the v7 serving gauges, one stream a client, the
    ``serving_latency`` report and ``post``'s per-client summaries."""
    sim = _pool(3)
    sim.state = taylor_green_fleet(sim.grid, 3)
    d = sim.step_once()
    rec = tprof.MetricsRecorder()
    rec.prime(sim)
    r = rec.record_step(step=sim.step_count, t=sim.time, dt=d["dt"],
                        diag=d, sim=sim, wall_ms=2.0)
    assert set(r) == set(tprof.METRICS_KEYS)
    assert r["fleet_members"] == 3
    assert r["member_steps_per_s"] == pytest.approx(3 / 2e-3, rel=1e-6)
    mh = r["member_health"]
    assert len(mh["umax"]) == 3 and mh["finite"] == [True] * 3
    assert r["umax"] == max(mh["umax"]) and r["dt_next"] == min(mh["dt_next"])
    assert r["energy"] == pytest.approx(sum(mh["energy"]))
    assert r["dt"] == min(mh["dt"])
    assert all(r[k] is None for k in tprof._SERVE_KEYS)

    sim = _pool(2)
    lat = ServingLatency()
    server = FleetServer(sim, guard=FleetStepGuard(sim),
                         clients_dir=str(tmp_path / "clients"), latency=lat)
    dt = _dt0(sim, 0)
    for i in range(3):
        server.submit(FleetRequest(client_id=f"s{i}",
                                   state=_session_state(sim.grid, 0),
                                   t_end=(2 - 0.1) * dt))
    sink = EventLog(str(tmp_path / "metrics.jsonl"))
    rec = tprof.MetricsRecorder(sink=sink, server=server)
    rec.prime(sim)
    while True:
        out = server.step()
        if out is None:
            break
        r = rec.record_step(step=out["step"], t=out["t"], dt=out["dt"],
                            diag=out, sim=sim, wall_ms=1.0)
        assert r["member_health"] is None and r["fleet_members"] == 2
        assert r["admitted"] >= 1 and 0 <= r["occupancy"] <= 1
    server.close()
    sink.emit(event="serving_latency", **lat.report())
    sink.close()
    assert server.retired == 3 and lat.pool["step"].n > 0
    assert sorted(os.listdir(tmp_path / "clients")) == [
        "s0.jsonl", "s1.jsonl", "s2.jsonl"]
    summ = tpost.metrics_summary(str(tmp_path / "metrics.jsonl"))
    assert sorted(summ["clients"]) == ["s0", "s1", "s2"]
    assert summ["clients"]["s2"]["steps"] == 2
    assert summ["clients"]["s0"]["finite_all"] is True
    assert summ["serving_latency"]["pool"]["step"]["count"] > 0
    from cup2d_tpu import profiling as jprof
    assert set(summ["clients"]["s0"]) == set(
        jprof.summarize_client([]))


def test_copy_fleet_state_carries_the_jax_fleet():
    js = JFleet(_jcfg(), level=LVL, members=3)
    js.state = jtg_fleet(js.grid, 3)
    js.step_count, js.times = 21, np.array([0.1, 0.2, 0.3])
    js.time = 0.1
    js._next_dt = js._dt(js.state.vel)
    ts = _pool(3)
    copy_fleet_state(js, ts)
    assert np.array_equal(ts.state.vel.numpy(), np.asarray(js.state.vel))
    assert np.array_equal(ts.times, js.times) and ts.step_count == 21
    assert ts.time == 0.1
    assert np.array_equal(ts._next_dt.numpy(), np.asarray(js._next_dt))
    assert torch.equal(ts._next_dt, ts._dt(ts.state.vel))
