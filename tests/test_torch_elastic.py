"""Elastic recovery, f64 on the CPU: ports of the JAX package's
``tests/test_elastic.py``, held against the port's own checkpoint path
(bit for bit where the JAX package holds 1e-12) and against single-device
JAX (1e-10, equal iterations; the JAX package's sharded tests fail under
jax 0.9.0, so the port is not held to them).

* The host-loss fault tokens; ``TopologyGuard``'s miss-count timeline,
  epoch and survivors; its host grouping; ``bounded_call``'s deadline;
  ``PreemptionGuard.agree`` without a world; the step boundary's one call.
* ``ShardedUniformSim.remesh`` raises ``ValueError`` where Nx does not
  divide by the new mesh's size.
* The simulated host-loss drill: 4 slabs in 2 hosts lose host 1 at step
  27, the guard re-meshes onto 2 slabs and resumes from the ring in place;
  the resumed state equals the step-26 checkpoint restarted on 2 slabs,
  and so does every step after; events and metrics record it; the resumed
  trajectory stays within 1e-10 of single-device JAX with equal
  iterations. The same drill on the forest resumes from the ring too.
* The CLI drill: ``-mesh 4 -elastic -simHosts 2`` with ``host_exit@6``.
* A forest ``DeviceSnapshot`` taken on 4 shards, restored onto 2
  (``io.restore_snapshot_resharded``), matches ``load_checkpoint`` of the
  same state within 1e-12 on both branches: a fresh sim on 2 shards (the
  topology reinstall), and the donor itself after ``remesh`` (the ordered
  state's fast path, re-placed on the new mesh). ``snapshot_covers``
  keeps the reference's owner rule.
* A forest and a uniform run re-meshed from 4 shards to 2 mid-run step bit
  for bit like a sim built on 2 shards from the same state; the uniform
  resharded restore installs the snapshot's state on the new mesh.
* A re-mesh onto the mesh of another world refuses until that world is
  re-formed (``reinit_distributed``)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from cup2d_tpu_torch import __main__ as tmain
from cup2d_tpu_torch.config import SimConfig
from cup2d_tpu_torch.convert import copy_amr_state
from cup2d_tpu_torch.faults import FaultPlan
from cup2d_tpu_torch.io import (load_checkpoint, restore_snapshot_resharded,
                                save_checkpoint, snapshot_covers,
                                snapshot_state_device)
from cup2d_tpu_torch.parallel import shard_halo as tsh
from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim, SlabMesh,
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.profiling import MetricsRecorder
from cup2d_tpu_torch.resilience import (EventLog, PreemptionGuard, StepGuard,
                                        TopologyGuard, bounded_call,
                                        dist_initialized)
from cup2d_tpu_torch.uniform import taylor_green_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(D):
    return make_mesh(devices=["cpu"] * D)


def _cfg(**kw):
    base = dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
                nu=1e-3, cfl=0.4, dtype="float64",
                max_poisson_iterations=200)
    base.update(kw)
    return SimConfig(**base)


def _sharded(mesh, level=2, **kw):
    sim = ShardedUniformSim(_cfg(**kw), mesh, level=level)
    sim.set_state(taylor_green_state(sim.grid))
    # production steps from the start: nothing here depends on the exact
    # startup solves
    sim.step_count = 20
    return sim


def test_remesh_rejects_indivisible():
    sim = _sharded(_cpu(4))                      # nx = 64
    with pytest.raises(ValueError):
        sim.remesh(_cpu(3))


def _world_mesh_of_others(D=2):
    """A mesh as ``SlabMesh.over_world`` builds it on rank 0 of a 2-rank
    world, without a process group: its second shard is another rank's."""
    m = SlabMesh.__new__(SlabMesh)
    m.devices = (torch.device("cpu"), None)[:D]
    m.owners = tuple(range(D))
    m.rank, m.world, m.distributed = 0, D, True
    m.local = (0,)
    return m


def test_remesh_onto_another_world_refuses():
    sim = _sharded(_cpu(4))
    with pytest.raises(NotImplementedError, match="reinit_distributed"):
        sim.remesh(_world_mesh_of_others())
    forest = ShardedAMRSim(_forest_cfg(), _cpu(4), shapes=[])
    with pytest.raises(NotImplementedError, match="reinit_distributed"):
        forest.remesh(_world_mesh_of_others())
    # a single-controller mesh takes any other one, a smaller one too
    sim.remesh(_cpu(2))
    assert sim.mesh.size == 2 and len(sim.state.vel.parts) == 2


def _forest_cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=2, level_start=1,
                     extent=1.0, dtype="float64", nu=1e-3,
                     max_poisson_iterations=40)


def test_forest_snapshot_reshard_matches_checkpoint(tmp_path):
    cfg = _forest_cfg()
    mesh2 = _cpu(2)
    rng = np.random.default_rng(0)
    sim = ShardedAMRSim(cfg, _cpu(4), shapes=[])
    f = sim.forest
    f.fields["vel"] = f.fields["vel"] + torch.tensor(
        0.1 * rng.standard_normal(tuple(f.fields["vel"].shape)))
    sim.time, sim.step_count = 0.125, 17

    snap = snapshot_state_device(sim)
    assert snapshot_covers(snap)      # single process: every shard local
    assert snapshot_covers(snap, lost_processes=(1,))
    assert not snapshot_covers(snap, lost_hosts=(1,), shards_destroyed=True)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, sim)

    # branch 1: a fresh sim on the smaller mesh (another forest version:
    # the topology reinstall)
    over = ShardedAMRSim(cfg, mesh2, shapes=[])
    restore_snapshot_resharded(over, snap)
    ref = ShardedAMRSim(cfg, mesh2, shapes=[])
    load_checkpoint(ck, ref)
    over.sync_fields()
    ref.sync_fields()
    assert over.time == ref.time and over.step_count == ref.step_count
    for k in f.fields:
        a = over.forest.fields[k].numpy()
        b = ref.forest.fields[k].numpy()
        assert np.max(np.abs(a - b)) <= 1e-12, k

    # branch 2: the donor re-meshed in place (the same forest version: the
    # ordered state's fast path), then the snapshot re-placed
    sim.remesh(mesh2)
    restore_snapshot_resharded(sim, snap)
    ordv = sim._ordered_state()["vel"]
    assert isinstance(ordv, tsh.Blocks) and ordv.mesh is mesh2
    assert len(ordv.parts) == 2
    sim.sync_fields()
    # compare in SFC order: slot numbers are an allocator detail
    oa = sim.forest.order()
    ob = ref.forest.order()
    for k in f.fields:
        a = sim.forest.fields[k].numpy()[oa]
        b = ref.forest.fields[k].numpy()[ob]
        assert np.max(np.abs(a - b)) <= 1e-12, k
    assert sim.mesh.size == 2 and sim._split


# the vortex forest of tests/test_torch_forest_mesh.py (n_pad 128)
VORTEX = dict(bpdx=2, bpdy=2, level_max=4, level_start=2, extent=1.0,
              nu=1e-4, cfl=0.4, dtype="float64", max_poisson_iterations=100,
              poisson_tol=1e-4, poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)


def _vortex(sim):
    bs = sim.cfg.bs
    vals = np.zeros((sim.forest.capacity, 2, bs, bs))
    for (l, i, j), s in sim.forest.blocks.items():
        h = sim.cfg.h_at(l)
        x = (i * bs + np.arange(bs) + 0.5) * h - 0.5
        y = (j * bs + np.arange(bs) + 0.5) * h - 0.5
        X, Y = np.meshgrid(x, y, indexing="xy")
        r2 = X ** 2 + Y ** 2
        ut = 0.5 / (2 * np.pi * np.sqrt(r2 + 1e-12)) \
            * (1 - np.exp(-r2 / (2 * 0.0064)))
        th = np.arctan2(Y, X)
        vals[s, 0] = -ut * np.sin(th)
        vals[s, 1] = ut * np.cos(th)
    sim.forest.fields["vel"] = torch.tensor(vals)


def _ordered(sim):
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    return f.fields["vel"].numpy()[o], f.fields["pres"].numpy()[o]


@pytest.mark.parametrize("pois", ["default", "fas"])
def test_forest_remesh_mid_run_steps_like_a_fresh_mesh(pois, monkeypatch):
    if pois == "fas":
        monkeypatch.setenv("CUP2D_POIS", "fas")
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    sim = ShardedAMRSim(SimConfig(**VORTEX), _cpu(4), shapes=[])
    _vortex(sim)
    sim.adapt()
    for _ in range(2):
        sim.step_once()
    fresh = ShardedAMRSim(SimConfig(**VORTEX), _cpu(2), shapes=[])
    copy_amr_state(sim, fresh)
    sim.remesh(_cpu(2))
    assert sim._split and len(sim._ordered_state()["vel"].parts) == 2
    for k in range(2):
        a, b = sim.step_once(), fresh.step_once()
        assert a["poisson_iters"] == b["poisson_iters"], k
        va, pa = _ordered(sim)
        vb, pb = _ordered(fresh)
        assert np.array_equal(va, vb) and np.array_equal(pa, pb), k


@pytest.mark.parametrize("pois", ["default", "fas"])
def test_uniform_remesh_mid_run_steps_like_a_fresh_mesh(pois, monkeypatch):
    if pois == "fas":
        monkeypatch.setenv("CUP2D_POIS", "fas")
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    sim = _sharded(_cpu(4))
    for _ in range(2):
        sim.step_once()
    fresh = _sharded(_cpu(2))
    fresh.set_state(unshard_state(sim.state))
    fresh.time, fresh.step_count = sim.time, sim.step_count
    fresh._next_dt = sim._next_dt
    snap = snapshot_state_device(sim)
    sim.remesh(_cpu(2))
    assert len(sim.state.vel.parts) == 2
    for k in range(2):
        a, b = sim.step_once(), fresh.step_once()
        assert a["poisson_iters"] == b["poisson_iters"], k
        for x, y in zip(unshard_state(sim.state), unshard_state(fresh.state)):
            assert torch.equal(x, y), k
    # the ring's entry of 4 shards, installed on the 2-shard mesh
    restore_snapshot_resharded(sim, snap)
    assert sim.state.vel.mesh is sim.mesh and len(sim.state.vel.parts) == 2
    for x, y in zip(unshard_state(sim.state), snap.payload.values()):
        assert torch.equal(x, tsh.gather_x(y))


# ---------------------------------------------------------------------------
# detection: the fault tokens, the guard's timeline, the bounded call
# ---------------------------------------------------------------------------

def _events(path, kind=None):
    with open(path) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    return [e for e in evs if kind is None or e.get("event") == kind]


def test_host_loss_fault_grammar():
    plan = FaultPlan("host_exit@5,host_hang@7,sigterm@3")
    assert plan
    assert plan.host_loss == {5: ["exit"], 7: ["hang"]}
    assert plan.host_loss_at(4) == []
    assert plan.host_loss_at(5) == ["exit"]
    assert plan.host_loss_at(5) == []
    with plan.suspend():
        assert plan.host_loss_at(7) == []
    assert plan.host_loss_at(7) == ["hang"]
    with pytest.raises(ValueError):
        FaultPlan("host_exit")
    with pytest.raises(ValueError):
        FaultPlan("host_vanish@3")


def test_topology_guard_detection_timeline(tmp_path):
    devs = [torch.device("cpu")] * 8
    log = EventLog(str(tmp_path / "events.jsonl"))
    plan = FaultPlan("host_exit@5")
    topo = TopologyGuard(devices=devs, sim_hosts=4, miss_k=2,
                         faults=plan, event_log=log)
    assert topo.n_hosts == 4 and topo.epoch == 0
    assert topo.poll(4) == ()
    # the fault marks host 3 dead; this beat is its first miss of 2
    assert topo.poll(5) == ()
    assert topo.epoch == 0 and all(topo.alive)
    assert topo.poll(6) == (3,)
    assert topo.epoch == 1 and topo.alive == [True, True, True, False]
    assert topo.survivor_devices() == devs[:6]
    assert topo.survivor_mesh().size == 6
    assert topo.lost_process_indices() == ()
    assert topo.lost_host_indices() == (3,)
    assert topo.poll(7) == () and topo.epoch == 1
    log.close()
    lost = _events(str(tmp_path / "events.jsonl"), "topology_lost")
    assert len(lost) == 1
    assert lost[0]["hosts"] == [3] and lost[0]["epoch"] == 1
    assert lost[0]["kinds"] == ["exit"] and lost[0]["miss_k"] == 2
    assert lost[0]["survivors"] == 6


def test_topology_guard_validates_host_grouping():
    devs = ["cpu"] * 8
    with pytest.raises(ValueError):
        TopologyGuard(devices=devs, sim_hosts=3)
    with pytest.raises(ValueError):
        TopologyGuard(devices=devs, sim_hosts=1)
    # a mesh names its slots
    assert TopologyGuard(_cpu(4), sim_hosts=2).n_hosts == 2


def test_bounded_call_hang_watchdog():
    done, r = bounded_call(lambda: 42, timeout=5.0)
    assert done and r == 42
    t0 = time.perf_counter()
    done, r = bounded_call(lambda: time.sleep(30), timeout=0.2)
    assert not done and r is None
    assert time.perf_counter() - t0 < 5.0

    def boom():
        raise RuntimeError("inside")

    with pytest.raises(RuntimeError, match="inside"):
        bounded_call(boom, timeout=5.0)


def test_preemption_agree_preinit_fast_path():
    assert dist_initialized() is False
    stop = PreemptionGuard()
    assert stop.agree() is False
    stop.triggered = True
    assert stop.agree() is True


def test_step_boundary_piggybacks_single_process():
    plan = FaultPlan("host_exit@3")
    topo = TopologyGuard(devices=["cpu"] * 4, sim_hosts=2, miss_k=1,
                         faults=plan)
    stop = PreemptionGuard()
    beat = topo.step_boundary(stop, 2)
    assert beat.stop is False and beat.lost == () and not beat.hung
    stop.triggered = True
    beat = topo.step_boundary(stop, 3)
    assert beat.stop is True
    assert beat.lost == (1,) and not beat.self_lost


# ---------------------------------------------------------------------------
# the simulated host-loss drill: ring resume, restart and JAX pins
# ---------------------------------------------------------------------------

def _drill(sim, tmp_path, spec, stop_at, ck_at, make_guard):
    """Drive ``sim`` on 4 shards in 2 simulated hosts to ``stop_at``: a
    checkpoint at ``ck_at``, the loss ``spec`` at the next boundary.
    Returns the guard, the events path, the metrics records, the
    checkpoint path, the recovered state and the guard's step records."""
    events_path = str(tmp_path / "events.jsonl")
    metrics_path = str(tmp_path / "metrics.jsonl")
    log = EventLog(events_path)
    metrics_log = EventLog(metrics_path)
    ck = str(tmp_path / "ck")
    plan = FaultPlan(spec)
    topo = TopologyGuard(sim.mesh, sim_hosts=2, miss_k=1, faults=plan,
                         event_log=log)
    guard = make_guard(sim, ck, log, plan)
    recorder = MetricsRecorder(sink=metrics_log, guard=guard)
    recorder.prime(sim)
    stop = PreemptionGuard()
    recs = []

    def record(rec):
        if rec is not None:
            recs.append(rec)
            recorder.record_step(step=rec["step"], t=rec["t"], dt=rec["dt"],
                                 diag=rec, sim=sim)

    recovered = None
    saved = False
    while sim.step_count < stop_at:
        if not saved and sim.step_count == ck_at:
            for rec in guard.drain():
                record(rec)
            save_checkpoint(ck, sim)
            saved = True
        beat = topo.step_boundary(stop, sim.step_count)
        assert not beat.hung and not beat.self_lost
        if beat.lost:
            guard.elastic_recover(topo)
            recovered = _state_of(sim)
            continue
        record(guard.step())
    for rec in guard.drain():
        record(rec)
    log.close()
    metrics_log.close()
    with open(metrics_path) as f:
        ms = [json.loads(ln) for ln in f if ln.strip()]
    return guard, events_path, ms, ck, recovered, recs


def _state_of(sim):
    if hasattr(sim, "forest"):
        sim.sync_fields()
        o = sim.forest.order()
        return [sim.forest.fields[k][o].clone()
                for k in sorted(sim.forest.fields)]
    return [t.clone() for t in unshard_state(sim.state)]


# tolerances that make the production solves iterate (tests/test_mesh.py)
ITERATE = dict(poisson_tol=1e-9, poisson_tol_rel=0.0)


def test_elastic_drill_simulated_host_loss(tmp_path):
    sim = _sharded(_cpu(4), **ITERATE)
    guard, events_path, ms, ck, recovered, recs = _drill(
        sim, tmp_path, "host_exit@27", 32, 26,
        lambda s, ck, log, plan: StepGuard(s, ckpt_dir=ck, event_log=log,
                                           faults=plan, snap_every=1))
    assert recovered is not None
    assert sim.mesh.size == 2 and len(sim.state.vel.parts) == 2
    assert sim.step_count == 32
    assert guard.topology_epoch == 1 and guard.remesh_count == 1
    assert guard.restore_source == "ring"
    lost = _events(events_path, "topology_lost")
    remesh = _events(events_path, "remesh")
    assert len(lost) == 1 and lost[0]["hosts"] == [1]
    assert len(remesh) == 1
    assert remesh[0]["source"] == "ring" and remesh[0]["epoch"] == 1
    assert remesh[0]["devices"] == 2 and remesh[0]["step"] == 26
    epochs = [m["topology_epoch"] for m in ms]
    assert epochs[0] == 0 and epochs[-1] == 1
    post = [m for m in ms if m["topology_epoch"] == 1]
    assert post[0]["remesh_count"] == 1
    assert post[0]["remesh_ms"] is not None and post[0]["remesh_ms"] > 0

    # the ring resume equals the checkpoint installed on 2 slabs, bit for
    # bit, and so does every step after
    ref = _sharded(_cpu(2), **ITERATE)
    load_checkpoint(ck, ref)
    for a, b in zip(recovered, _state_of(ref)):
        assert torch.equal(a, b)
    gref = StepGuard(ref, snap_every=1)
    while ref.step_count < 32:
        gref.step()
    gref.drain()
    assert ref.time == sim.time
    for a, b in zip(_state_of(sim), _state_of(ref)):
        assert torch.equal(a, b)

    # the resumed trajectory against single-device JAX from the same
    # checkpoint: within 1e-10, equal iterations every step
    pytest.importorskip("jax")
    from cup2d_tpu.config import SimConfig as JConfig
    from cup2d_tpu.io import load_checkpoint as jload
    from cup2d_tpu.uniform import UniformSim as JSim
    js = JSim(JConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                      extent=2.0, nu=1e-3, cfl=0.4, dtype="float64",
                      max_poisson_iterations=200, **ITERATE), level=2)
    jload(ck, js)
    resumed = [r for r in recs if r["step"] > 26]
    assert [r["step"] for r in resumed] == list(range(27, 33))
    for r in resumed:
        jd = js.step_once()
        assert int(jd["poisson_iters"]) == r["poisson_iters"] > 0, r["step"]
    assert abs(js.time - sim.time) <= 1e-10
    for a, b in ((js.state.vel, sim.state.vel), (js.state.pres,
                                                 sim.state.pres)):
        assert np.max(np.abs(np.asarray(a) - tsh.gather_x(b).numpy())) \
            <= 1e-10


def test_elastic_drill_forest_resumes_from_the_ring(tmp_path):
    """The forest on 4 shards in 2 simulated hosts: the mirror latches off
    for its payload, the loss resumes from the ring, and the resumed run
    equals the checkpoint restarted on 2 shards, bit for bit."""
    sim = ShardedAMRSim(SimConfig(**VORTEX), _cpu(4), shapes=[])
    _vortex(sim)
    sim.adapt()
    sim.step_count = 12
    guard, events_path, _, ck, _, _ = _drill(
        sim, tmp_path, "host_exit@14", 16, 13,
        lambda s, ck, log, plan: StepGuard(s, ckpt_dir=ck, event_log=log,
                                           faults=plan, snap_every=1,
                                           mirror_hosts=2))
    assert guard.mirror_hosts is None       # latched off at the first
    assert guard.restore_source == "ring"
    remesh = _events(events_path, "remesh")
    assert [(e["source"], e["step"], e["devices"]) for e in remesh] \
        == [("ring", 13, 2)]
    assert sim._split and len(sim._ordered_state()["vel"].parts) == 2
    ref = ShardedAMRSim(SimConfig(**VORTEX), _cpu(2), shapes=[])
    load_checkpoint(ck, ref)
    gref = StepGuard(ref, snap_every=1)
    while ref.step_count < 16:
        gref.step()
    gref.drain()
    assert ref.time == sim.time and sim.step_count == 16
    assert set(ref.forest.blocks) == set(sim.forest.blocks)
    for a, b in zip(_state_of(sim), _state_of(ref)):
        assert torch.equal(a, b)


CLI_DRILL = ["-bpdx", "2", "-bpdy", "1", "-levelMax", "1", "-levelStart",
             "0", "-level", "2", "-extent", "2", "-CFL", "0.4", "-tend",
             "10", "-lambda", "1e6", "-nu", "1e-3", "-poissonTol", "1e-3",
             "-poissonTolRel", "1e-2", "-maxPoissonRestarts", "0",
             "-maxPoissonIterations", "200", "-AdaptSteps", "20", "-Rtol",
             "2", "-Ctol", "1", "-tdump", "0", "-dtype", "float64",
             "-maxSteps", "12", "-device", "cpu", "-mesh", "4",
             "-elastic", "-simHosts", "2"]


@pytest.mark.parametrize("flags", [["-heartbeatMissK", "1"], []],
                         ids=["missK1", "missK3"])
def test_cli_elastic_simulated_drill(flags, tmp_path, monkeypatch, capsys):
    """``python -m cup2d_tpu_torch -mesh 4 -elastic -simHosts 2`` with
    ``host_exit@6``: rc 0 after 12 steps (the JAX CLI's stop, -maxSteps),
    the loss declared after ``-heartbeatMissK`` beats (3 by default) and
    resumed from the ring on 2 shards, the mirror on over the 2 hosts until
    the loss leaves one."""
    monkeypatch.setenv("CUP2D_FAULTS", "host_exit@6")
    out = str(tmp_path)
    assert tmain.main(CLI_DRILL + flags + ["-output", out]) == 0
    assert "after 12 steps" in capsys.readouterr().err
    k = 1 if flags else 3
    ev = _events(os.path.join(out, "events.jsonl"))
    assert [e["event"] for e in ev] == ["topology_lost", "remesh"]
    assert ev[0]["hosts"] == [1] and ev[0]["step"] == 6 + k - 1
    assert ev[0]["miss_k"] == k
    assert ev[1]["source"] == "ring" and ev[1]["devices"] == 2
    ms = _events(os.path.join(out, "metrics.jsonl"), "metrics")
    assert ms[-1]["step"] == 12
    assert ms[-1]["topology_epoch"] == 1 and ms[-1]["remesh_count"] == 1
    assert ms[-1]["restore_source"] == "ring"
    assert ms[0]["mirror_bytes"] > 0 and ms[-1]["mirror_bytes"] is None
