"""Multi-process runs on ``torch.distributed`` (``parallel.launch``), gloo
on the CPU: worlds of 2 ranks, 2 shards each, spawned with
``subprocess`` on a free port. The worker is this file run as a script
(``python tests/test_torch_dist.py <scenario> <rank> <world> <port>
<dir>``); every world has a hard timeout.

* ``ShardedUniformSim`` at f64 on a 4-shard world mesh, bit for bit the
  single-process 4-slab run and the same on both ranks: Taylor-Green
  under the default solver and fas, ``tgv_periodic`` (the x ring crosses
  the ranks twice) and the cavity table; each <= 1e-10 from single-device
  JAX with equal iterations. A small vortex forest under both surface
  exchange modes (``CUP2D_SHARD_EXCHANGE``), bit for bit the
  single-process run.
* The shaped f64 ``ShardedAMRSim`` of the JAX package's two-process
  worker (``tests/_multihost_worker.py``: a fish and a disk, levelMax 4,
  three regrid cycles, seeded vortices so that the pad bucket crosses):
  per cycle equal digests (topology, host tables, every field's bits) on
  both ranks and in the single-process 4-shard run; a collective dump and
  checkpoint whose bytes equal the single-process save's; a restore that
  continues identically; a skewed ``sigterm@3`` / ``sigterm@5`` that both
  ranks agree to stop on at step 5.
* The CLI across two processes (``-device cpu -mesh 4 -coordinator
  127.0.0.1:P -meshHosts 2 -processId r``): dumps and ``forces.csv``
  byte-equal to the single-process ``-mesh 4`` run's, one metrics record a
  step, and its two-process restart, whose checkpoint and dumps equal the
  uninterrupted single-process run's.
* A world re-meshed mid-run from 2 shards a rank to 1 (the forest and
  Taylor-Green): bit for bit the single-process run re-meshed from 4
  shards to 2; its forest step gathered group partials only, and no
  preconditioner operand.
* A fleet given the world flags without a coordinator, which fails to
  connect as every world run does, the elastic and mirror flags as the JAX
  CLI takes them, and a world whose peer never comes, which fails inside
  its timeout with the expected process count. Fleets across processes
  are tests/test_torch_fleet_dist.py.
  The elastic recovery across ranks is tests/test_torch_dist_elastic.py."""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORLD_TIMEOUT = 240      # hard limit of one spawned world, seconds
LEVEL = 3                # Taylor-Green at 128 x 64
STEPS = 3
JAX_BAR = 1e-10
UNIFORM_CASES = (("tg", ""), ("tg", "fas"), ("tgv_periodic", ""),
                 ("cavity", ""))


# ---------------------------------------------------------------------------
# the runs, shared by the workers (a world mesh) and the test process (the
# single-process 4-slab mesh)
# ---------------------------------------------------------------------------

# tolerances that make the production solves iterate (tests/test_mesh.py)
TG_KW = dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
             nu=1e-3, cfl=0.4, dtype="float64", poisson_tol=1e-9,
             poisson_tol_rel=0.0)


def _tg_cfg():
    from cup2d_tpu_torch.config import SimConfig
    return SimConfig(**TG_KW)


def uniform_run(case: str, pois: str, mesh) -> dict:
    """STEPS steps (the first an exact startup solve) of one uniform case
    on ``mesh``: per step the whole vel and pres and the iterations."""
    os.environ["CUP2D_POIS"] = pois
    from cup2d_tpu_torch import cases
    from cup2d_tpu_torch.parallel.mesh import ShardedUniformSim, unshard_state
    from cup2d_tpu_torch.uniform import taylor_green_state
    if case == "tg":
        sim = ShardedUniformSim(_tg_cfg(), mesh, level=LEVEL)
        sim.set_state(taylor_green_state(sim.grid))
    else:
        sim = cases.make_sim(case, level=2, dtype="float64", mesh=mesh)
    out = {}
    for k in range(STEPS):
        d = sim.advance(1, exact_first_steps=k == 0)
        st = unshard_state(sim.state)
        out[f"{k}/vel"] = st.vel.numpy()
        out[f"{k}/pres"] = st.pres.numpy()
        out[f"{k}/iters"] = np.asarray(d["poisson_iters"])
    del os.environ["CUP2D_POIS"]
    return out


def vortex_run(mesh, exchange: str) -> dict:
    """A small vortex forest (levels 3-5) on ``mesh`` under the
    ``exchange`` mode of the surface exchange, fas: an adapt and 2
    production steps; the whole ordered state and the iterations."""
    from cup2d_tpu_torch.amr import vortex_forest
    from cup2d_tpu_torch.convert import forest_from_numpy, forest_to_numpy
    from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
    f = vortex_forest(target=300, level_start=3, level_max=5, device="cpu",
                      dtype="float64")
    cfg, snap = f.cfg, forest_to_numpy(f)
    os.environ.update(CUP2D_SHARD_EXCHANGE=exchange, CUP2D_POIS="fas")
    try:
        sim = ShardedAMRSim(cfg, mesh, shapes=[])
    finally:
        del os.environ["CUP2D_SHARD_EXCHANGE"], os.environ["CUP2D_POIS"]
    forest_from_numpy(sim, *snap)
    sim.step_count = 10
    sim.adapt()
    out = {"iters": np.asarray([sim.step_once()["poisson_iters"]
                                for _ in range(2)])}
    for k, v in sim._ordered_state().items():
        out[k] = sim._gather(v)[:sim._n_real].numpy()
    return out


def remesh_run(mesh, smaller) -> dict:
    """A world re-meshed mid-run from 2 shards a rank to 1 (``smaller()``
    builds the new mesh): the vortex forest of ``vortex_run`` under the
    default solver (an adapt, a production step whose all-gathers are
    counted by kind, the re-mesh, 2 steps) and Taylor-Green (a step, the
    re-mesh, 2 steps); the whole states and iterations after each step."""
    from cup2d_tpu_torch.amr import vortex_forest
    from cup2d_tpu_torch.convert import forest_from_numpy, forest_to_numpy
    from cup2d_tpu_torch.parallel import shard_halo
    from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
    from cup2d_tpu_torch.parallel.mesh import ShardedUniformSim, unshard_state
    from cup2d_tpu_torch.uniform import taylor_green_state
    f = vortex_forest(target=300, level_start=3, level_max=5, device="cpu",
                      dtype="float64")
    cfg, snap = f.cfg, forest_to_numpy(f)
    sim = ShardedAMRSim(cfg, mesh, shapes=[])
    forest_from_numpy(sim, *snap)
    sim.step_count = 10
    sim.adapt()
    shard_halo.reset_comm_stats()
    its = [sim.step_once()["poisson_iters"]]
    out = {"forest/npad": np.asarray(sim._npad_hwm)}
    out.update({f"forest/comm/{k}": np.asarray(v) for k, v in
                shard_halo.comm_by_kind().items()})
    new = smaller()
    sim.remesh(new)
    its += [sim.step_once()["poisson_iters"] for _ in range(2)]
    out["forest/iters"] = np.asarray(its)
    out["forest/parts"] = np.asarray(len(sim._ordered_state()["vel"].parts))
    for k, v in sim._ordered_state().items():
        out[f"forest/{k}"] = sim._gather(v)[:sim._n_real].numpy()
    tg = ShardedUniformSim(_tg_cfg(), mesh, level=LEVEL)
    tg.set_state(taylor_green_state(tg.grid))
    tg.step_count = 10
    tg.step_once()
    tg.remesh(new)
    for k in range(2):
        tg.step_once()
        st = unshard_state(tg.state)
        out[f"tg/{k}/vel"] = st.vel.numpy()
        out[f"tg/{k}/pres"] = st.pres.numpy()
    return out


def _forest_cfg():
    from cup2d_tpu_torch.config import SimConfig
    return SimConfig(bpdx=2, bpdy=1, level_max=4, level_start=1, extent=1.0,
                     dtype="float64", nu=4e-5, lam=1e6, rtol=0.004,
                     ctol=0.0008)


def _digest(sim) -> str:
    """Topology, the host leaves of every table and every field's bits."""
    f = sim.forest
    h = hashlib.sha256()
    for key in sorted(f.blocks):
        h.update(repr((key, int(f.level[f.blocks[key]]))).encode())
    h.update(repr((sim._npad_hwm, sim._n_real)).encode())
    for name in sorted(sim._tables):
        t = sim._tables[name]
        for leaf in (t if isinstance(t, tuple) else ()):
            for a in (leaf if isinstance(leaf, tuple) else (leaf,)):
                if isinstance(a, np.ndarray):
                    h.update(a.tobytes())
                elif torch.is_tensor(a):
                    h.update(a.cpu().numpy().tobytes())
    sim.sync_fields()
    order = np.asarray(f.order())
    for k in sorted(f.fields):
        h.update(f.fields[k][torch.as_tensor(order)].numpy().tobytes())
    return h.hexdigest()


def _seed_vortices(sim) -> None:
    """The JAX worker's vortex sheet, written into the slot fields (whole
    on every rank: identical numpy everywhere)."""
    sim.sync_fields()
    f = sim.forest
    order = f.order()
    bs = sim.cfg.bs
    h = f.h_per_block(order)
    ar = np.arange(bs) + 0.5
    X = (f.bi[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, None, :] * h[:, None, None]
    Y = (f.bj[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, :, None] * h[:, None, None]
    vel = f.fields["vel"].clone()
    u = np.zeros((len(order), bs, bs))
    v = np.zeros((len(order), bs, bs))
    for k in range(6):
        cx, cy = 0.15 + 0.12 * k, 0.25 + 0.04 * (k % 3)
        dx, dy = X - cx, Y - cy
        r2 = dx * dx + dy * dy
        ut = 0.6 / (2 * np.pi * np.sqrt(r2 + 1e-8)) \
            * (1 - np.exp(-r2 / (2 * 0.02 ** 2)))
        th = np.arctan2(dy, dx)
        u += -ut * np.sin(th)
        v += ut * np.cos(th)
    idx = torch.as_tensor(np.asarray(order, np.int64))
    vel[idx, 0] = torch.as_tensor(u)
    vel[idx, 1] = torch.as_tensor(v)
    f.fields["vel"] = vel


def forest_run(mesh, outdir: str, rank: int = 0) -> dict:
    """The JAX worker's three regrid cycles, its collective I/O, the
    restore and (under a world) the skewed SIGTERM agreement."""
    from cup2d_tpu_torch.io import dump_forest, load_checkpoint, \
        save_checkpoint
    from cup2d_tpu_torch.models import DiskShape, FishShape
    from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
    cfg = _forest_cfg()
    sim = ShardedAMRSim(cfg, mesh, shapes=[
        FishShape(0.2, 0.62, 0.25, 0.0, cfg.min_h, period=1.0),
        DiskShape(0.05, 0.3, 0.3)])
    sim.compute_forces_every = 0
    sim.initialize()
    out = {"npad0": int(sim._npad_hwm), "digests": []}
    levels_mid = set()
    for cycle in range(3):
        if cycle == 2:
            levels_mid = {lv for (lv, _, _) in sim.forest.blocks}
            _seed_vortices(sim)
            sim.adapt()
            sim.adapt()
        sim.adapt()
        for _ in range(2):
            sim.step_once(dt=1e-3)
        out["digests"].append(_digest(sim))
    out["levels_mid"] = len(levels_mid)
    out["npad1"] = int(sim._npad_hwm)
    out["n_blocks"] = len(sim.forest.blocks)
    dump_forest(os.path.join(outdir, "vel.000"), sim.time, sim.forest,
                order=np.asarray(sim._order))
    ck = os.path.join(outdir, "ck")
    save_checkpoint(ck, sim)
    out["files"] = {
        name: hashlib.sha256(open(os.path.join(outdir, name), "rb")
                             .read()).hexdigest()
        for name in ("vel.000.xyz.raw", "vel.000.attr.raw",
                     "vel.000.xdmf2", "ck/meta.json", "ck/shapes.pkl")}
    with np.load(os.path.join(ck, "fields.npz")) as z:
        out["ck_fields"] = {k: hashlib.sha256(z[k].tobytes()).hexdigest()
                            for k in sorted(z.files)}
    sim.step_once(dt=1e-3)             # diverge, then restore
    load_checkpoint(ck, sim)
    for _ in range(2):
        sim.step_once(dt=1e-3)
    out["restored"] = _digest(sim)
    out["tmp_left"] = os.path.exists(ck + ".tmp")
    return out


def sigterm_drill(sim_mesh, rank: int) -> dict:
    """Process 0 latches SIGTERM after step 3, process 1 after step 5;
    ``agree`` stops both at the first boundary where both latched."""
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.parallel.mesh import ShardedUniformSim
    from cup2d_tpu_torch.resilience import PreemptionGuard
    from cup2d_tpu_torch.uniform import taylor_green_state
    sim = ShardedUniformSim(_tg_cfg(), sim_mesh, level=2)
    sim.set_state(taylor_green_state(sim.grid))
    plan = FaultPlan(f"sigterm@{3 if rank == 0 else 5}")
    stop = PreemptionGuard().install()
    agreed = local = None
    try:
        for k in range(1, 9):
            sim.step_once()
            plan.fire_post_step(k)
            if stop.triggered and local is None:
                local = k
            if stop.agree():
                agreed = k
                break
    finally:
        stop.uninstall()
    return {"agreed": agreed, "local": local}


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _worker(scenario: str, rank: int, world: int, port: int,
            outdir: str) -> dict:
    torch.set_num_threads(1)
    from cup2d_tpu_torch.parallel.launch import (init_distributed,
                                                 shutdown_distributed,
                                                 world_mesh)
    if scenario == "nopeer":
        init_distributed(f"127.0.0.1:{port}", world, rank,
                         expected_processes=world, device="cpu",
                         timeout=4.0, connect_attempts=2,
                         connect_backoff=0.1)
        return {"joined": True}
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            expected_processes=world, device="cpu",
                            timeout=120.0) == rank
    try:
        mesh = world_mesh(4, "cpu")
        res = {"local": list(mesh.local), "devices":
               [None if d is None else str(d) for d in mesh.devices]}
        if scenario == "uniform":
            arrays = {}
            for case, pois in UNIFORM_CASES:
                run = uniform_run(case, pois, mesh)
                arrays.update({f"{case}-{pois or 'default'}/{k}": v
                               for k, v in run.items()})
            for mode in ("allgather", "ppermute"):
                arrays.update({f"vortex-{mode}/{k}": v for k, v in
                               vortex_run(mesh, mode).items()})
            arrays.update({f"remesh/{k}": v for k, v in remesh_run(
                mesh, lambda: world_mesh(2, "cpu")).items()})
            np.savez(os.path.join(outdir, f"uniform.r{rank}.npz"), **arrays)
        elif scenario == "forest":
            res.update(forest_run(mesh, outdir, rank))
            res.update(sigterm_drill(mesh, rank))
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
    env.pop("CUP2D_POIS", None)
    return env


def _run_world(cmds, timeout=WORLD_TIMEOUT):
    """Start every command, wait for all with a hard timeout, kill what
    is left; (rc, stdout, stderr) per process."""
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


def spawn(scenario: str, outdir, world: int = 2, timeout=WORLD_TIMEOUT):
    port = _free_port()
    outs = _run_world([[sys.executable, os.path.abspath(__file__), scenario,
                        str(r), str(world), str(port), str(outdir)]
                       for r in range(world)], timeout)
    return outs


def _results(outs) -> list:
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
    return make_mesh(devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("uniform")
    res = _results(spawn("uniform", d))
    ranks = [dict(np.load(d / f"uniform.r{r}.npz")) for r in range(2)]
    return res, ranks


def test_world_mesh_owns_contiguous_shards(uniform_world):
    res, _ = uniform_world
    assert [r["local"] for r in res] == [[0, 1], [2, 3]]
    assert res[0]["devices"] == ["cpu", "cpu", None, None]
    assert res[1]["devices"] == [None, None, "cpu", "cpu"]


@pytest.mark.parametrize("case,pois", UNIFORM_CASES,
                         ids=[f"{c}-{p or 'default'}"
                              for c, p in UNIFORM_CASES])
def test_uniform_world_equals_single_process_bit_for_bit(uniform_world,
                                                         case, pois):
    _, ranks = uniform_world
    solo = uniform_run(case, pois, _cpu4())
    key = f"{case}-{pois or 'default'}"
    for k, v in solo.items():
        for r in ranks:
            np.testing.assert_array_equal(r[f"{key}/{k}"], v, err_msg=k)


@pytest.mark.parametrize("mode", ["allgather", "ppermute"])
def test_forest_surface_exchange_modes_across_ranks(uniform_world, mode):
    """The forest's surface exchange between ranks, by one all-gather of
    the packed sets or by point-to-point messages: bit for bit the
    single-process 4-shard run in the same mode."""
    _, ranks = uniform_world
    solo = vortex_run(_cpu4(), mode)
    for k, v in solo.items():
        for r in ranks:
            np.testing.assert_array_equal(r[f"vortex-{mode}/{k}"], v,
                                          err_msg=k)


def test_world_remesh_to_one_shard_a_rank(uniform_world):
    """A 2-rank world re-meshed from 2 shards a rank to 1 mid-run, the
    forest and Taylor-Green: bit for bit the single-process run re-meshed
    from 4 shards to 2, and the same on both ranks. The forest's
    production step before it gathered no preconditioner operand and, per
    reduction, at most one f64 partial per 16-block group."""
    from cup2d_tpu_torch.parallel.mesh import make_mesh
    _, ranks = uniform_world
    solo = remesh_run(_cpu4(), lambda: make_mesh(devices=["cpu"] * 2))
    for k, v in solo.items():
        if "/comm/" in k or k.endswith("/parts"):   # per process
            continue
        for r in ranks:
            np.testing.assert_array_equal(r[f"remesh/{k}"], v, err_msg=k)
    for r in ranks:
        assert int(r["remesh/forest/parts"]) == 1
        n, nbytes = r["remesh/forest/comm/preconditioner"]
        assert n == 0 and nbytes == 0
        n, nbytes = r["remesh/forest/comm/reductions"]
        assert n > 0 and nbytes <= n * int(r["remesh/forest/npad"]) // 16 * 8


def _jax_run(case: str, pois: str) -> dict:
    from cup2d_tpu import cases as jcases
    from cup2d_tpu.config import SimConfig as JCfg
    from cup2d_tpu.uniform import UniformSim as JSim
    from cup2d_tpu.uniform import taylor_green_state as jtg
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", pois)
    try:
        if case == "tg":
            js = JSim(JCfg(**TG_KW), level=LEVEL)
            js.state = jtg(js.grid)
        else:
            js = jcases.make_sim(case, level=2, dtype="float64")
        out = {}
        for k in range(STEPS):
            d = js.advance(1, exact_first_steps=k == 0)
            out[f"{k}/vel"] = np.asarray(js.state.vel)
            out[f"{k}/pres"] = np.asarray(js.state.pres)
            out[f"{k}/iters"] = int(d["poisson_iters"])
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("case,pois", UNIFORM_CASES,
                         ids=[f"{c}-{p or 'default'}"
                              for c, p in UNIFORM_CASES])
def test_uniform_world_matches_single_device_jax(uniform_world, case, pois):
    pytest.importorskip("jax")
    _, ranks = uniform_world
    ref = _jax_run(case, pois)
    key = f"{case}-{pois or 'default'}"
    w = ranks[0]
    assert ref["0/iters"] > 0
    for k in range(STEPS):
        assert int(w[f"{key}/{k}/iters"]) == ref[f"{k}/iters"], k
        for f in ("vel", "pres"):
            err = np.max(np.abs(w[f"{key}/{k}/{f}"] - ref[f"{k}/{f}"]))
            assert err <= JAX_BAR, (k, f, err)


@pytest.fixture(scope="module")
def forest_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("forest")
    solo_dir = tmp_path_factory.mktemp("forest_solo")
    res = _results(spawn("forest", d))
    solo = forest_run(_cpu4(), str(solo_dir))
    return res, solo


def test_forest_cycles_agree_across_ranks_and_with_one_process(forest_world):
    res, solo = forest_world
    assert res[0]["digests"] == res[1]["digests"] == solo["digests"]
    # the hard case occurred: mixed levels, and the pad bucket crossed
    assert solo["levels_mid"] >= 2
    assert solo["npad1"] > solo["npad0"]
    assert res[0]["npad1"] == solo["npad1"]


def test_worlds_crossed_ranks(uniform_world, forest_world):
    """Edge columns and surface blocks went point to point, reductions
    and whole operands through all-gathers."""
    for res, _ in (uniform_world, forest_world):
        for r in res:
            assert r["comm"]["p2p_messages"] > 0
            assert r["comm"]["allgathers"] > 0


def test_forest_collective_io_and_restore(forest_world):
    res, solo = forest_world
    assert res[0]["files"] == res[1]["files"] == solo["files"]
    assert res[0]["ck_fields"] == res[1]["ck_fields"] == solo["ck_fields"]
    assert res[0]["restored"] == res[1]["restored"] == solo["restored"]
    assert not res[0]["tmp_left"]


def test_sigterm_agreed_at_step_5(forest_world):
    res, _ = forest_world
    assert [r["local"] for r in res] == [3, 5]
    assert [r["agreed"] for r in res] == [5, 5]


# tests/test_torch_cli.py's forest CLI on a 2x1 root grid (one fish,
# more than 128 blocks, so n_pad 256 splits over 4 shards)
CLI_FOREST = ("-bpdx 2 -bpdy 1 -levelMax 5 -levelStart 3 -extent 2 "
              "-dtype float64 -CFL 0.4 -nu 0.0004 -lambda 1e6 -Rtol 2 "
              "-Ctol 0 -tdump 0.05 -tend 10 -AdaptSteps 5 "
              "-maxPoissonIterations 100 -maxPoissonRestarts 0 "
              "-poissonTol 1e-4 -poissonTolRel 1e-3 -device cpu "
              "-mesh 4 -checkpointEvery 3").split() \
    + ["-shapes", "angle=0 L=0.4 xpos=1.0 ypos=0.5"]


def _cli_world(flags, timeout=WORLD_TIMEOUT):
    port = _free_port()
    cmds = [[sys.executable, "-m", "cup2d_tpu_torch"] + flags
            + ["-coordinator", f"127.0.0.1:{port}", "-meshHosts", "2",
               "-processId", str(r)] for r in range(2)]
    outs = _run_world(cmds, timeout)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The single-process ``-mesh 4`` CLI to step 6; the two-process run to
    step 3 and its two-process restart to step 6."""
    from cup2d_tpu_torch.__main__ import main
    root = tmp_path_factory.mktemp("cli")
    solo, head, tail = (str(root / n) for n in ("solo", "head", "tail"))
    assert main(CLI_FOREST + ["-maxSteps", "6", "-output", solo]) == 0
    outs = _cli_world(CLI_FOREST + ["-maxSteps", "3", "-output", head])
    _cli_world(CLI_FOREST + ["-maxSteps", "6", "-output", tail, "-restart",
                             os.path.join(head, "checkpoint")])
    return solo, head, tail, outs


def _same_checkpoint(a: str, b: str) -> None:
    with np.load(os.path.join(a, "fields.npz")) as fa, \
            np.load(os.path.join(b, "fields.npz")) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert open(os.path.join(a, "meta.json")).read() \
        == open(os.path.join(b, "meta.json")).read()


def _same_dumps(a: str, b: str, common: bool = False) -> list:
    """The dump files ``a`` holds (``common``: those ``b`` holds too; a
    restart re-anchors the dump schedule), each byte-equal in ``b``."""
    names = sorted(n for n in os.listdir(a) if n.startswith("vel."))
    if common:
        names = [n for n in names if os.path.exists(os.path.join(b, n))]
    for n in names:
        assert open(os.path.join(a, n), "rb").read() \
            == open(os.path.join(b, n), "rb").read(), n
    return names


def test_cli_two_processes_dump_what_one_process_dumps(cli_runs):
    solo, head, _, outs = cli_runs
    assert len(_same_dumps(head, solo)) >= 6     # two dumps, a triplet each
    rows = open(os.path.join(solo, "forces.csv")).read().splitlines()
    assert open(os.path.join(head, "forces.csv")).read().splitlines() \
        == rows[:1 + 3]
    # one writer: three records, progress lines from rank 0 only
    recs = [json.loads(x) for x in open(os.path.join(head,
                                                     "metrics.jsonl"))]
    assert [r["step"] for r in recs if r["event"] == "metrics"] \
        == [1, 2, 3]
    assert recs[-1]["event"] == "compile_ledger"
    assert "done at" in outs[0][2] and "done at" not in outs[1][2]


def test_cli_two_process_restart_continues_bit_for_bit(cli_runs):
    solo, _, tail, _ = cli_runs
    _same_checkpoint(os.path.join(tail, "checkpoint"),
                     os.path.join(solo, "checkpoint"))
    assert _same_dumps(tail, solo, common=True)


def test_missing_peer_fails_inside_its_timeout(tmp_path):
    port = _free_port()
    (rc, out, err), = _run_world(
        [[sys.executable, os.path.abspath(__file__), "nopeer", "0", "2",
          str(port), str(tmp_path)]], timeout=60)
    assert rc != 0
    assert "expected 2 processes" in err, err[-2000:]
    assert "coordinator connect failed (attempt 1/2)" in err
    assert '"joined"' not in out


def test_refusals_that_stay(tmp_path, capsys):
    """A fleet with the world flags now brings up a world as the other
    world runs do (tests/test_torch_fleet_dist.py runs one), so
    ``-meshHosts 2`` without a coordinator fails to connect (rc 1) before
    any work; the elastic and mirror flags behave as in the JAX CLI
    (``cup2d_tpu/__main__.py:205-208``, :330-375): ``-elastic`` in one
    process without ``-simHosts`` is a usage error, and the other flags
    alone are accepted runs."""
    from cup2d_tpu_torch.__main__ import main
    base = ["-bpdx", "2", "-bpdy", "1", "-levelMax", "1", "-levelStart",
            "0", "-level", "2", "-extent", "2", "-CFL", "0.4", "-tend",
            "0.01", "-nu", "1e-3", "-poissonTol", "1e-3", "-poissonTolRel",
            "1e-2", "-maxPoissonRestarts", "0", "-maxPoissonIterations",
            "200", "-AdaptSteps", "20", "-Rtol", "2", "-Ctol", "1",
            "-lambda", "1e6", "-tdump", "0",
            "-dtype", "float64", "-maxSteps", "2", "-device", "cpu"]
    for k, (flags, rc, text) in enumerate((
            (["-mesh", "4", "-elastic"], 2,
             "-elastic on a single-process run needs -simHosts"),
            (["-mirror"], 0, "done at"),
            (["-mesh", "4", "-simHosts", "2"], 0, "done at"),
            (["-heartbeatMissK", "1"], 0, "done at"),
            (["-heartbeatTimeout", "3"], 0, "done at"),
            (["-case", "cavity", "-fleet", "2", "-mesh", "2",
              "-meshHosts", "2"], 1,
             "a world needs the coordinator address"))):
        out = str(tmp_path / str(k))
        assert main(base + flags + ["-output", out]) == rc, flags
        assert text in capsys.readouterr().err, flags


if __name__ == "__main__":
    scen, r, w, p, d = sys.argv[1:6]
    print(json.dumps(_worker(scen, int(r), int(w), int(p), d)), flush=True)
