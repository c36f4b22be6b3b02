"""The host-redundant mirror tier, f64 on the CPU: ports of the JAX
package's ``tests/test_mirror.py``, held against the port's own
from-checkpoint restart bit for bit (the JAX package holds 1e-12).

* The ``shard_loss`` and ``mirror_corrupt`` tokens: grammar, consumption
  once, suspension in a replay.
* ``host_ring_shift`` is ``np.roll`` by Nx/H, on fresh tensors, and refuses
  H < 2 and an H that does not divide the mesh.
* ``_block_sums`` equals the JAX package's ``_block_sums`` on the same f32
  and f64 arrays, uint32 for uint32; the mirror's per-block checksums,
  ``verify_mirror``, ``corrupt_mirror``, mirror-aware ``snapshot_covers``
  and ``destroy_shards`` keep the JAX package's semantics, and never write
  into a snapshot's tensors.
* The destroyed-shard drill: 4 slabs in 2 simulated hosts lose host 1 and
  its bytes at step 27; the guard resumes from the neighbour's mirror, bit
  for bit the restart from the step-26 checkpoint on 2 slabs, and the
  metrics stream names the rung.
* A corrupt mirror is rejected once (``mirror_reject``) and the disk rung
  resumes.
* Mirror on against off: the same bits and the same device reads.
* Recovery events are fsynced at emit."""

import json

import numpy as np
import pytest
import torch

from cup2d_tpu_torch.config import SimConfig
from cup2d_tpu_torch.faults import FaultPlan
from cup2d_tpu_torch.io import (_block_sums, corrupt_mirror, destroy_shards,
                                load_checkpoint, mirror_nbytes,
                                mirror_snapshot, save_checkpoint,
                                snapshot_covers, snapshot_state_device,
                                verify_mirror)
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim, host_ring_shift,
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.parallel.shard_halo import gather_x, split_x
from cup2d_tpu_torch.profiling import (HostCounters, MetricsRecorder,
                                       summarize_metrics)
from cup2d_tpu_torch.resilience import (EventLog, PreemptionGuard, StepGuard,
                                        TopologyGuard)
from cup2d_tpu_torch.uniform import taylor_green_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(D):
    return make_mesh(devices=["cpu"] * D)


def _cfg():
    return SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
                     nu=1e-3, cfl=0.4, dtype="float64",
                     max_poisson_iterations=200)


def _sharded(mesh, level=2):
    sim = ShardedUniformSim(_cfg(), mesh, level=level)
    sim.set_state(taylor_green_state(sim.grid))
    sim.step_count = 20     # production solves from the start
    return sim


def _events(path, kind=None):
    with open(path) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    return [e for e in evs if kind is None or e.get("event") == kind]


def _whole(sim):
    return [t.clone() for t in unshard_state(sim.state)]


def _restart(ck, steps_to):
    """The reference leg: the checkpoint restarted on 2 slabs and stepped
    under a guard to ``steps_to``."""
    ref = _sharded(_cpu(2))
    load_checkpoint(ck, ref)
    g = StepGuard(ref, snap_every=1)
    while ref.step_count < steps_to:
        g.step()
    g.drain()
    return ref


# ---------------------------------------------------------------------------
# fault grammar
# ---------------------------------------------------------------------------

def test_mirror_fault_grammar():
    plan = FaultPlan("shard_loss@5,mirror_corrupt@7")
    assert plan
    assert plan.shard_loss == {5: 1}
    assert plan.mirror_corrupt == {7: 1}
    assert plan.shard_loss_at(4) is False
    assert plan.shard_loss_at(5) is True
    assert plan.shard_loss_at(5) is False
    with plan.suspend():
        assert plan.mirror_corrupt_at(7) is False
    assert plan.mirror_corrupt_at(7) is True
    assert plan.mirror_corrupt_at(7) is False
    with pytest.raises(ValueError):
        FaultPlan("shard_loss")
    with pytest.raises(ValueError):
        FaultPlan("mirror_corrupt")
    with pytest.raises(ValueError):
        FaultPlan("shard_lost@3")


# ---------------------------------------------------------------------------
# unit semantics
# ---------------------------------------------------------------------------

def test_host_ring_shift_is_roll():
    mesh = _cpu(4)
    x = torch.arange(4 * 16, dtype=torch.float64).reshape(4, 16)
    xs = split_x(x, mesh)
    y = host_ring_shift(xs, 2)
    assert np.array_equal(gather_x(y).numpy(), np.roll(x.numpy(), 8, -1))
    # fresh tensors: the source slabs are never shared
    assert not any(a.data_ptr() == b.data_ptr()
                   for a in y.parts for b in xs.parts)
    assert np.array_equal(gather_x(host_ring_shift(xs, 4)).numpy(),
                          np.roll(x.numpy(), 4, -1))
    with pytest.raises(ValueError):
        host_ring_shift(xs, 1)
    with pytest.raises(ValueError):
        host_ring_shift(xs, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_sums_match_jax(dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cup2d_tpu import io as jio
    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 16, 32)).astype(dtype) * 1e3
    a[0, 0, 0] = -0.0
    for h in (2, 4):
        got = _block_sums(torch.as_tensor(a), h).numpy()
        want = np.asarray(jio._block_sums(jnp.asarray(a), h))
        assert want.dtype == np.uint32 and got.shape == want.shape == (h,)
        assert np.array_equal(got.astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2 ** 32


def test_mirror_checksums_and_coverage():
    mesh = _cpu(4)
    sim = _sharded(mesh)
    snap = snapshot_state_device(sim)
    m = mirror_snapshot(snap, mesh, 2)
    assert m is not None and m.n_hosts == 2
    snap = snap._replace(mirror=m)
    assert mirror_nbytes(snap) > 0
    vel = gather_x(snap.payload["vel"]).numpy()
    assert np.array_equal(gather_x(m.payload["vel"]).numpy(),
                          np.roll(vel, vel.shape[-1] // 2, -1))
    # the stored sums are the whole mirror field's block sums
    assert np.array_equal(
        (m.sums["vel"].view(2, 2).sum(1) & 0xFFFFFFFF).numpy(),
        _block_sums(gather_x(m.payload["vel"]), 2).numpy())
    assert verify_mirror(snap, (0,)) == []
    assert verify_mirror(snap, (1,)) == []
    assert snapshot_covers(snap, lost_hosts=(1,), shards_destroyed=True)
    assert not snapshot_covers(snap, lost_hosts=(1,),
                               shards_destroyed=True, mirror=False)
    assert not snapshot_covers(snap, lost_hosts=(0, 1),
                               shards_destroyed=True)
    bare = snapshot_state_device(sim)
    assert not snapshot_covers(bare, lost_hosts=(1,),
                               shards_destroyed=True)

    before = [p.clone() for p in m.payload["vel"].parts]
    held = list(m.payload["vel"].parts)
    assert corrupt_mirror(snap) is True
    # new tensors: the slabs the snapshot held are untouched
    assert all(torch.equal(a, b) for a, b in zip(held, before))
    bad = verify_mirror(snap, (1,))
    assert bad and all(r["expected"] != r["actual"] for r in bad)
    assert {"vel", "pres"} <= {r["field"] for r in bad}
    assert corrupt_mirror(bare) is False

    snap2 = snapshot_state_device(sim)
    snap2 = snap2._replace(mirror=mirror_snapshot(snap2, mesh, 2))
    kept = [p.clone() for p in snap2.payload["vel"].parts]
    [wiped] = destroy_shards(sim, [snap2], (1,), 2)
    assert all(torch.equal(a, b)
               for a, b in zip(snap2.payload["vel"].parts, kept))
    nx = vel.shape[-1]
    lost = np.s_[..., nx // 2:]
    surv = np.s_[..., :nx // 2]
    assert np.all(gather_x(sim.state.vel).numpy()[lost] == 0)
    assert np.all(gather_x(wiped.payload["vel"]).numpy()[lost] == 0)
    assert np.any(gather_x(wiped.payload["vel"]).numpy()[surv] != 0)
    mv = gather_x(wiped.mirror.payload["vel"]).numpy()
    assert np.all(mv[lost] == 0) and np.any(mv[surv] != 0)
    assert verify_mirror(wiped, (1,)) == []
    # a forest payload is not mirrored (the tier latches off)
    assert mirror_snapshot(snap2._replace(meta={"kind": "forest"}),
                           mesh, 2) is None


# ---------------------------------------------------------------------------
# the destroyed-shard drill: the mirror rung
# ---------------------------------------------------------------------------

def _drill(tmp_path, spec, steps_to, metrics=True):
    events_path = str(tmp_path / "events.jsonl")
    metrics_path = str(tmp_path / "metrics.jsonl")
    log = EventLog(events_path)
    metrics_log = EventLog(metrics_path)
    ck = str(tmp_path / "ck")
    plan = FaultPlan(spec)
    devs = ["cpu"] * 4
    topo = TopologyGuard(devices=devs, sim_hosts=2, miss_k=1, faults=plan,
                         event_log=log)
    sim = _sharded(make_mesh(devices=devs))
    guard = StepGuard(sim, ckpt_dir=ck, event_log=log, faults=plan,
                      snap_every=1, mirror_hosts=2)
    recorder = MetricsRecorder(sink=metrics_log, guard=guard)
    recorder.prime(sim)
    stop = PreemptionGuard()

    def record(rec):
        if rec is not None:
            recorder.record_step(step=rec["step"], t=rec["t"], dt=rec["dt"],
                                 diag=rec, sim=sim)

    saved = False
    while sim.step_count < steps_to:
        if not saved and sim.step_count == 26:
            for rec in guard.drain():
                record(rec)
            save_checkpoint(ck, sim)
            saved = True
        beat = topo.step_boundary(stop, sim.step_count)
        assert not beat.hung and not beat.self_lost
        if beat.lost:
            guard.elastic_recover(topo)
            continue
        record(guard.step())
    for rec in guard.drain():
        record(rec)
    log.close()
    metrics_log.close()
    with open(metrics_path) as f:
        ms = [json.loads(ln) for ln in f if ln.strip()]
    return sim, guard, events_path, ms, ck


def test_elastic_drill_destroyed_shards_mirror_rung(tmp_path):
    sim, guard, events_path, ms, ck = _drill(
        tmp_path, "host_exit@27,shard_loss@27", 32)
    assert sim.mesh.size == 2 and sim.step_count == 32
    assert guard.restore_source == "mirror"
    assert guard.mirror_hosts is None     # one host left: no ring
    remesh = _events(events_path, "remesh")
    assert len(remesh) == 1 and remesh[0]["source"] == "mirror"
    assert remesh[0]["step"] == 26
    assert _events(events_path, "mirror_reject") == []
    pre = [m for m in ms if m["topology_epoch"] == 0]
    post = [m for m in ms if m["topology_epoch"] == 1]
    assert pre and post
    assert all(m["restore_source"] is None for m in pre)
    assert all(m["restore_source"] == "mirror" for m in post)
    assert any(m["mirror_bytes"] and m["mirror_bytes"] > 0 for m in pre)
    assert any(m["mirror_ms"] and m["mirror_ms"] > 0 for m in pre)
    summary = summarize_metrics(ms)
    assert summary["restore_source"] == "mirror"
    assert summary["mirror_bytes"] > 0
    # bit for bit the restart from the step-26 checkpoint on 2 slabs
    ref = _restart(ck, 32)
    assert ref.time == sim.time
    for a, b in zip(_whole(sim), _whole(ref)):
        assert torch.equal(a, b)


def test_corrupt_mirror_degrades_to_disk(tmp_path):
    sim, guard, events_path, _, ck = _drill(
        tmp_path, "mirror_corrupt@26,host_exit@27,shard_loss@27", 30)
    assert guard.restore_source == "disk"
    rejects = _events(events_path, "mirror_reject")
    assert len(rejects) == 1 and rejects[0]["n_rejects"] > 0
    assert rejects[0]["rejects"][0]["expected"] \
        != rejects[0]["rejects"][0]["actual"]
    remesh = _events(events_path, "remesh")
    assert len(remesh) == 1 and remesh[0]["source"] == "disk"
    assert sim.step_count == 30 and sim.mesh.size == 2
    ref = _restart(ck, 30)
    for a, b in zip(_whole(sim), _whole(ref)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# mirror on against off
# ---------------------------------------------------------------------------

def test_mirror_off_bit_identical_zero_extra_syncs():
    sim = ShardedUniformSim(_cfg(), _cpu(4), level=2)

    def run(mirror_hosts):
        sim.set_state(taylor_green_state(sim.grid))
        sim.step_count, sim.time = 20, 0.0
        sim._next_dt = None
        guard = StepGuard(sim, mirror_hosts=mirror_hosts, snap_every=1)
        counters = HostCounters().install()
        try:
            while sim.step_count < 26:
                guard.step()
            guard.drain()
        finally:
            counters.uninstall()
        if mirror_hosts:
            assert guard.mirror_nbytes() > 0
        else:
            assert guard.mirror_nbytes() == 0
        return _whole(sim), counters.snapshot()["device_gets"]

    state_off, gets_off = run(None)
    state_on, gets_on = run(2)
    for a, b in zip(state_off, state_on):
        assert torch.equal(a, b)
    assert gets_off == gets_on > 0


def test_durable_events_fsynced_at_emit(tmp_path):
    assert {"topology_lost", "remesh", "member_abort",
            "mirror_reject"} <= set(EventLog._DURABLE_EVENTS)
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path)
    log.emit(event="remesh", epoch=1, source="mirror")
    with open(path) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    assert len(evs) == 1 and evs[0]["event"] == "remesh"
    assert evs[0]["source"] == "mirror"
    log.close()
