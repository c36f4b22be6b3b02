"""Elastic recovery across real ranks, gloo on the CPU: worlds of 2 ranks
spawned with ``subprocess`` on a free port, the worker being this file run
as a script (``python tests/test_torch_dist_elastic.py <scenario> <rank>
<port> <port2> <dir>``); each test has its own hard timeout.

* ``exit``: Taylor-Green at f64 on a 4-shard world mesh (2 a rank) with
  the mirror on over the 2 ranks (its exchange crosses them). Rank 1 arms
  ``host_exit@24`` in its own ``CUP2D_FAULTS``, announces it in its beat
  and exits with code 17; rank 0 declares the loss in the same beat,
  re-forms a 1-rank world on a fresh port (``reinit_distributed``),
  re-meshes onto its own 2 shards and resumes from the step-23 checkpoint
  on disk (the lost rank's shards and the mirror they held are gone), bit
  for bit the same checkpoint restarted in one process on 2 slabs.
* ``hang``: rank 1 arms ``host_hang@2`` and blocks after that beat; rank
  0's next beat reports ``hung`` inside its 2 s deadline, and the test
  kills rank 1.
* ``dist_check --elastic --device cpu``: the four-card drills' script on
  gloo at 64^2 (4 ranks lose 2, the survivors re-init and resume bit for
  bit a fresh 2-rank restart; a hang seen within its deadline)."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EXIT_TIMEOUT = 120       # hard limit of the exit drill's world, seconds
HANG_TIMEOUT = 60        # and of the hang drill's
BEAT_TIMEOUT = 2.0       # the hang drill's heartbeat deadline
CK_AT, LOSS_AT, END = 23, 24, 28
KW = dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0, nu=1e-3,
          cfl=0.4, dtype="float64", max_poisson_iterations=200,
          poisson_tol=1e-9, poisson_tol_rel=0.0)


def _sim(mesh):
    from cup2d_tpu_torch.config import SimConfig
    from cup2d_tpu_torch.parallel.mesh import ShardedUniformSim
    from cup2d_tpu_torch.uniform import taylor_green_state
    sim = ShardedUniformSim(SimConfig(**KW), mesh, level=2)
    sim.set_state(taylor_green_state(sim.grid))
    sim.step_count = 20
    return sim


def _exit_drill(rank: int, port2: int, outdir: str) -> dict:
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.io import save_checkpoint
    from cup2d_tpu_torch.parallel.launch import (reinit_distributed,
                                                 world_mesh, world_size)
    from cup2d_tpu_torch.parallel.mesh import unshard_state
    from cup2d_tpu_torch.resilience import (EventLog, PreemptionGuard,
                                            StepGuard, TopologyGuard,
                                            set_event_log)
    log = EventLog(os.path.join(outdir, "events.jsonl"))
    set_event_log(log)
    plan = FaultPlan.from_env()          # host_exit on rank 1 only
    mesh = world_mesh(4, "cpu")
    sim = _sim(mesh)
    ck = os.path.join(outdir, "ck")
    guard = StepGuard(sim, ckpt_dir=ck, event_log=log, faults=plan,
                      snap_every=1, mirror_hosts=2)
    topo = TopologyGuard(mesh, timeout=30.0, faults=plan, event_log=log)
    stop = PreemptionGuard()
    reinit_s = None
    mirrored = 0
    while sim.step_count < END:
        if sim.step_count == CK_AT and reinit_s is None:
            guard.drain()
            save_checkpoint(ck, sim)
            mirrored = guard.mirror_nbytes()
        beat = topo.step_boundary(stop, sim.step_count)
        if beat.self_lost:
            os._exit(17)                 # the dying rank writes nothing
        if beat.hung or beat.lost:
            t0 = time.perf_counter()
            reinit_distributed(f"127.0.0.1:{port2}", num_processes=1,
                               process_id=0, device="cpu")
            reinit_s = time.perf_counter() - t0
            guard.elastic_recover(topo)
            continue
        guard.step()
    guard.drain()
    st = unshard_state(sim.state)
    np.savez(os.path.join(outdir, "resumed.npz"),
             **{k: v.numpy() for k, v in st._asdict().items()},
             time=np.asarray(sim.time))
    log.close()
    return {"world": world_size(), "shards": sim.mesh.size,
            "local": list(sim.mesh.local), "epoch": guard.topology_epoch,
            "source": guard.restore_source, "reinit_s": reinit_s,
            "lost": list(topo.lost_process_indices()),
            "mirror_bytes_before": mirrored, "step": sim.step_count}


def _hang_drill(rank: int) -> dict:
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.parallel.launch import world_mesh
    from cup2d_tpu_torch.resilience import PreemptionGuard, TopologyGuard
    plan = FaultPlan.from_env()          # host_hang on rank 1 only
    topo = TopologyGuard(world_mesh(2, "cpu"), timeout=BEAT_TIMEOUT,
                         faults=plan)
    stop = PreemptionGuard()
    for k in range(5):
        t0 = time.perf_counter()
        beat = topo.step_boundary(stop, k)
        if beat.hung:
            return {"hung_at": k, "seconds": time.perf_counter() - t0,
                    "flag": topo.hung}
    return {"hung_at": None}


def _worker(scenario: str, rank: int, port: int, port2: int,
            outdir: str) -> None:
    torch.set_num_threads(1)
    from cup2d_tpu_torch.parallel.launch import (init_distributed,
                                                 shutdown_distributed)
    assert init_distributed(f"127.0.0.1:{port}", 2, rank,
                            expected_processes=2, device="cpu",
                            timeout=60.0) == rank
    if scenario == "exit":
        res = _exit_drill(rank, port2, outdir)
        shutdown_distributed()
    else:
        res = _hang_drill(rank)
    print(json.dumps(res), flush=True)
    # the hung gather's thread is left to the killed peer
    os._exit(0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(scenario: str, outdir, faults: dict) -> list:
    port, port2 = _free_port(), _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ)
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.pop("CUP2D_POIS", None)
        env.pop("CUP2D_FAULTS", None)
        if r in faults:
            env["CUP2D_FAULTS"] = faults[r]
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(r),
             str(port), str(port2), str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
    return procs


def _finish(p, timeout):
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rank_exit_reinits_and_resumes_from_disk(tmp_path):
    procs = _spawn("exit", tmp_path, {1: f"host_exit@{LOSS_AT}"})
    try:
        rc0, out0, err0 = _finish(procs[0], EXIT_TIMEOUT)
        rc1, _, err1 = _finish(procs[1], 30)
    finally:
        _kill_all(procs)
    assert rc1 == 17, err1[-3000:]
    assert rc0 == 0, err0[-3000:]
    res = json.loads(out0.strip().splitlines()[-1])
    assert res["world"] == 1 and res["shards"] == 2
    assert res["local"] == [0, 1] and res["lost"] == [1]
    assert res["epoch"] == 1 and res["source"] == "disk"
    assert res["step"] == END and res["reinit_s"] < 30
    assert res["mirror_bytes_before"] > 0
    ev = [json.loads(x) for x in open(tmp_path / "events.jsonl")]
    kinds = [e["event"] for e in ev]
    assert kinds == ["topology_lost", "reinit_distributed", "remesh"], kinds
    assert ev[0]["hosts"] == [1] and ev[0]["step"] == LOSS_AT
    assert ev[2]["source"] == "disk" and ev[2]["devices"] == 2

    # the same checkpoint restarted in one process on 2 slabs
    from cup2d_tpu_torch.config import SimConfig
    from cup2d_tpu_torch.io import load_checkpoint
    from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim, make_mesh,
                                               unshard_state)
    from cup2d_tpu_torch.resilience import StepGuard
    ref = ShardedUniformSim(SimConfig(**KW), make_mesh(devices=["cpu"] * 2),
                            level=2)
    load_checkpoint(str(tmp_path / "ck"), ref)
    assert ref.step_count == CK_AT
    g = StepGuard(ref, snap_every=1)
    while ref.step_count < END:
        g.step()
    g.drain()
    got = np.load(tmp_path / "resumed.npz")
    assert float(got["time"]) == ref.time
    for k, v in unshard_state(ref.state)._asdict().items():
        assert np.array_equal(got[k], v.numpy()), k


def test_rank_hang_is_seen_inside_the_deadline(tmp_path):
    procs = _spawn("hang", tmp_path, {1: "host_hang@2"})
    try:
        rc0, out0, err0 = _finish(procs[0], HANG_TIMEOUT)
        hung_alive = procs[1].poll() is None
    finally:
        _kill_all(procs)          # the test kills the hung rank
    assert rc0 == 0, err0[-3000:]
    assert hung_alive
    res = json.loads(out0.strip().splitlines()[-1])
    assert res["hung_at"] == 3 and res["flag"] is True
    assert BEAT_TIMEOUT <= res["seconds"] < BEAT_TIMEOUT + 5


DIST_CHECK_TIMEOUT = 180


def test_dist_check_elastic_on_gloo(tmp_path):
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("CUP2D_FAULTS", None)
    r = subprocess.run(
        [sys.executable, "-m", "cup2d_tpu_torch.dist_check", "--elastic",
         "--device", "cpu", "--size", "64", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=DIST_CHECK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    rows = {row["run"]: row for row in map(json.loads,
                                          r.stdout.strip().splitlines())}
    ex, rs, hg = (rows[f"elastic {k}"] for k in ("exit", "restart", "hang"))
    assert ex["ok"] and ex["rcs"] == [0, 0, 17, 17] and ex["source"] == "disk"
    assert rs["bit_for_bit"] and rs["sha256"] == ex["sha256"]
    assert hg["ok"] and hg["hung_at"] == 3


if __name__ == "__main__":
    scen, r, p, p2, d = sys.argv[1:6]
    _worker(scen, int(r), int(p), int(p2), d)
