"""The split paths across cards, in three layouts: ``solo`` (one card, no
mesh), ``mesh`` (one process over N cards, peer copies between them) and
``ranks`` (N processes of one card each, a ``torch.distributed`` NCCL
world brought up from torchrun's environment); N is every visible card:

    python -m cup2d_tpu_torch.dist_check --layout solo --out DIR
    python -m cup2d_tpu_torch.dist_check --layout mesh --out DIR
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m cup2d_tpu_torch.dist_check --layout ranks --out DIR
    python -m cup2d_tpu_torch.dist_check --compare DIR

Runs, f32 on the card: the x-split uniform step at ``--size``^2
(chip_smoke phase 7's: the benchmark velocity, production solves, dt =
h/2, one warm-up and ``--steps`` timed steps) under the default solver
and fas; the forest of ``amr.vortex_forest(target=--forest-target)``
(chip_smoke phase 5's at 10,000) split over the layout's shards, one
adapt, one warm-up and ``--steps`` timed production steps under each
solver; and the ``turb2d`` fleet (chip_smoke phase 18 (c)'s:
``--fleet-size``^2, ``--fleet-members`` members, from step 20) unplaced on
``solo`` and placed on the layout's mesh, member (B/N a card) and spatial
placement, under each solver: one warm-up and ``--steps`` timed steps.
``--runs`` picks among ``uniform``, ``forest`` and ``fleet`` (default
all). Each layout writes ``DIR/<layout>.json`` (rank 0 under a world):
per run ms a production step (host clock to a synchronize), iterations,
the sha256 of the final whole state, and under ``ranks`` the bytes rank 0
receives by all-gathers, in total and by kind (reductions, the
preconditioner, image transfers, regrid, surface exchange, levels,
state), and sends point to point a step (``shard_halo.comm_stats``).
``--compare`` prints one JSON line a run with the layouts side by side,
and, where ``DIR/cli_ranks`` and ``DIR/cli_mesh`` hold the dumps of two
CLI runs, whether every dump is byte-equal; it exits 1 when ``mesh`` and
``ranks`` differ anywhere. The ``solo`` layout is reported beside them:
the solo forest takes the split forest's reductions in its order
(``solo_eq_ranks``), the uniform step sums its slabs' partials instead.
Every number is the card's; the script refuses to run without one.

Elastic recovery across cards (``--elastic``, four or more cards): the
script builds the kernels, then starts its own processes, one a card,
each with its own environment:

    python -m cup2d_tpu_torch.dist_check --elastic --out DIR

(1) ``exit``: 4 NCCL ranks run the split uniform step at ``--size``^2
(the benchmark velocity, default solver, production solves from step
10, the mirror on over the 4 ranks); ranks 2 and 3 arm ``host_exit@12`` in
their own ``CUP2D_FAULTS``, announce it in the beat at step 12 and exit
with code 17. Ranks 0 and 1 see the loss in that beat, re-form a 2-rank
world on a fresh port (``reinit_distributed``), re-mesh from 4 shards to
2, one a rank, and resume from the step-11 checkpoint on disk to step 13.
(2) ``restart``: a fresh 2-rank world loads that checkpoint and steps to
13; its final state's sha256 and clock must equal (1)'s. (3) ``hang``: 2
ranks, rank 1 armed with ``host_hang@2``; rank 0's next beat must report
``hung`` inside its deadline, and the world is aborted (the script kills
rank 1). One JSON line each, the re-init seconds and re-mesh ms among
them, and the card's name and power limit; exit 1 when a check fails.
The checkpoint (``DIR/elastic_ck``) is removed at the end; the events
stay in ``DIR/elastic_events.jsonl``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import cases
from .amr import AMRSim, vortex_forest
from .config import SimConfig
from .convert import forest_from_numpy, forest_to_numpy
from .parallel import shard_halo
from .parallel.forest_mesh import ShardedAMRSim
from .parallel.launch import (init_distributed, rank, shutdown_distributed,
                              world_mesh, world_size)
from .parallel.mesh import ShardedUniformSim, make_mesh
from .parallel.shard_halo import gather_x
from .uniform import UniformSim, bench_state

LAYOUTS = ("solo", "mesh", "ranks")


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _latched:
    """CUP2D_POIS set while a sim is built."""

    def __init__(self, pois: str):
        self.pois = pois

    def __enter__(self):
        os.environ["CUP2D_POIS"] = self.pois

    def __exit__(self, *exc):
        os.environ.pop("CUP2D_POIS", None)


def _reset_comm() -> None:
    shard_halo.reset_comm_stats()


def uniform_runs(mesh, dev, size: int, steps: int) -> dict:
    """The split step (the solo step on ``mesh`` None) under both
    solvers."""
    level = (size // 8).bit_length() - 1
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                    nu=4e-5, cfl=0.5, dtype="float32")
    vel0 = None
    out = {}
    for pois in ("", "fas"):
        with _latched(pois):
            sim = (UniformSim(cfg, level=level, device=dev) if mesh is None
                   else ShardedUniformSim(cfg, mesh, level=level))
        if vel0 is None:
            vel0 = bench_state(sim.grid).vel.cpu()
        st = sim.grid.zero_state()._replace(vel=vel0.to(dev))
        if mesh is None:
            sim.state = st
        else:
            sim.set_state(st)
        del st
        sim.step_count = 10
        dt = 0.5 * sim.grid.h
        iters = [sim.step_once(dt)["poisson_iters"]]
        _sync()
        _reset_comm()
        t0 = time.perf_counter()
        for _ in range(steps):
            iters.append(sim.step_once(dt)["poisson_iters"])
        _sync()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        comm = {k: v / steps for k, v in shard_halo.comm_stats.items()}
        vel, pres = sim.state.vel, sim.state.pres
        if mesh is not None:
            vel, pres = gather_x(vel), gather_x(pres)
        out[f"uniform {size}^2 {pois or 'default'}"] = {
            "ms_per_step": ms, "iters": iters, "sha256": _sha(vel, pres),
            "comm_per_step": comm}
        del sim, vel, pres
        torch.cuda.empty_cache()
    return out


def forest_runs(mesh, dev, target: int, steps: int, levels=(6, 8)) -> dict:
    """phase 5's forest split over ``mesh`` (solo on None): an adapt, a
    warm-up and ``steps`` timed production steps under each solver.
    ``levels``: vortex_forest's (level_start, level_max)."""
    f = vortex_forest(target=target, device=dev, level_start=levels[0],
                      level_max=levels[1])
    cfg, snap = f.cfg, forest_to_numpy(f)
    del f
    out = {}
    for pois in ("structured", "fas"):
        with _latched(pois):
            sim = (AMRSim(cfg, shapes=[], device=dev) if mesh is None
                   else ShardedAMRSim(cfg, mesh, shapes=[]))
        forest_from_numpy(sim, *snap)
        sim.step_count = 10
        sim.adapt()
        iters = [sim.step_once()["poisson_iters"]]
        _sync()
        _reset_comm()
        t0 = time.perf_counter()
        for _ in range(steps):
            iters.append(sim.step_once()["poisson_iters"])
        _sync()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        comm = {k: v / steps for k, v in shard_halo.comm_stats.items()}
        state = sim._ordered_state()
        keys = sorted(sim.forest.blocks)
        out[f"forest {pois}"] = {
            "ms_per_step": ms, "iters": iters, "blocks": len(keys),
            "n_pad": int(sim._npad_hwm),
            "sha256": _sha(*(sim._gather(state[k]) for k in sorted(state)),
                           torch.as_tensor(np.asarray(keys, np.int64))),
            "comm_per_step": comm}
        del sim, state
        torch.cuda.empty_cache()
    return out


def fleet_runs(mesh, dev, size: int, members: int, steps: int) -> dict:
    """The ``turb2d`` fleet at size^2 with ``members`` members (f32, the
    catalog's seeded members), unplaced on ``mesh`` None, else placed on
    it, member and spatial, under each solver: a warm-up and ``steps``
    timed steps from step 20."""
    from .fleet import FleetSim
    from .io import whole
    level = (size // 8).bit_length() - 1
    start = cases.make_sim("turb2d", level=level, members=members,
                           device=dev).state
    start = type(start)(*(whole(f).cpu() for f in start))
    out = {}
    for pois in ("", "fas"):
        for pl in (("single",) if mesh is None else ("member", "spatial")):
            cfg = cases._periodic_cfg(1e-4, "float32", 0.4)
            with _latched(pois):
                if mesh is None:
                    sim = FleetSim(cfg, level=level, members=members,
                                   device=dev, bc=cases.periodic_table())
                else:
                    sim = FleetSim(cfg, level=level, members=members,
                                   mesh=mesh, placement=pl,
                                   bc=cases.periodic_table())
            sim.set_state(type(start)(*(f.to(sim.grid.device)
                                        for f in start)))
            sim.step_count = 20
            iters = [sim.step_once()["poisson_iters"].tolist()]
            _sync()
            _reset_comm()
            t0 = time.perf_counter()
            for _ in range(steps):
                iters.append(sim.step_once()["poisson_iters"].tolist())
            _sync()
            ms = 1e3 * (time.perf_counter() - t0) / steps
            comm = {k: v / steps for k, v in shard_halo.comm_stats.items()}
            vel, pres = whole(sim.state.vel), whole(sim.state.pres)
            name = f"fleet turb2d {size}^2 B={members} " + (
                "unplaced" if mesh is None else pl) + f" {pois or 'default'}"
            out[name] = {"ms_per_step": ms, "iters": iters,
                         "member_steps_per_s": 1e3 * members / ms,
                         "times": [float(t) for t in sim.times],
                         "sha256": _sha(vel, pres), "comm_per_step": comm}
            del sim, vel, pres
            torch.cuda.empty_cache()
    return out


def run_layout(layout: str, out_dir: str, size: int, target: int,
               steps: int, levels=(6, 8), runs=("uniform", "forest",
                                                  "fleet"),
               fleet=(1024, 8)) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dist_check: no CUDA device")
    dev = torch.device("cuda", 0)
    mesh = None
    if layout == "mesh":
        mesh = make_mesh()
    elif layout == "ranks":
        init_distributed()
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = world_mesh(world_size(), dev)
    me = rank()
    try:
        t0 = time.perf_counter()
        res = {"layout": layout, "card": torch.cuda.get_device_name(0),
               "shards": 1 if mesh is None else mesh.size,
               "torch": torch.__version__, "runs": {}}
        if "uniform" in runs:
            res["runs"].update(uniform_runs(mesh, dev, size, steps))
        if "forest" in runs:
            res["runs"].update(forest_runs(mesh, dev, target, steps,
                                           levels))
        if "fleet" in runs:
            res["runs"].update(fleet_runs(mesh, dev, fleet[0], fleet[1],
                                          steps))
        res["seconds"] = time.perf_counter() - t0
    finally:
        shutdown_distributed()
    if me == 0:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{layout}.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)


def _dumps_equal(a: str, b: str) -> dict:
    names = sorted(n for n in os.listdir(a) if n.startswith("vel."))
    other = sorted(n for n in os.listdir(b) if n.startswith("vel."))
    same = names == other and all(
        open(os.path.join(a, n), "rb").read()
        == open(os.path.join(b, n), "rb").read() for n in names)
    return {"dump_files": len(names), "byte_equal": same}


def compare(out_dir: str) -> int:
    got = {}
    for layout in LAYOUTS:
        p = os.path.join(out_dir, f"{layout}.json")
        if os.path.exists(p):
            with open(p) as f:
                got[layout] = json.load(f)
    rc = 0
    names = sorted({n for r in got.values() for n in r["runs"]})
    for name in names:
        row = {"run": name}
        for layout, r in got.items():
            run = r["runs"].get(name)
            if run is None:
                continue
            row[layout] = {k: run[k] for k in ("ms_per_step", "iters")}
            if "member_steps_per_s" in run:
                row[layout]["member_steps_per_s"] = run["member_steps_per_s"]
            if layout == "ranks":
                comm = run["comm_per_step"]
                row[layout]["comm_per_step"] = {
                    k: comm[k] for k in ("allgathers", "allgather_bytes",
                                         "p2p_messages", "p2p_bytes")}
                row[layout]["allgathered_mb_per_step_by_kind"] = {
                    k: [c, b / 1e6] for k, (c, b) in
                    shard_halo.comm_by_kind(comm).items() if c}
        runs = {k: r["runs"].get(name) for k, r in got.items()}
        if runs.get("mesh") and runs.get("ranks"):
            row["mesh_eq_ranks"] = (runs["mesh"]["sha256"]
                                    == runs["ranks"]["sha256"]
                                    and runs["mesh"]["iters"]
                                    == runs["ranks"]["iters"])
            rc |= not row["mesh_eq_ranks"]
        if runs.get("solo") and runs.get("ranks"):
            row["solo_eq_ranks"] = (runs["solo"]["sha256"]
                                    == runs["ranks"]["sha256"])
        print(json.dumps(row), flush=True)
    a, b = (os.path.join(out_dir, n) for n in ("cli_ranks", "cli_mesh"))
    if os.path.isdir(a) and os.path.isdir(b):
        cli = _dumps_equal(a, b)
        print(json.dumps({"run": "canonical cli -mesh all on ranks vs "
                          "-mesh 4 in one process", **cli}), flush=True)
        rc |= not cli["byte_equal"] or cli["dump_files"] == 0
    return int(rc)


# ---------------------------------------------------------------------------
# elastic recovery across cards
# ---------------------------------------------------------------------------

ELASTIC_START, ELASTIC_CK, ELASTIC_END = 10, 11, 13
HANG_AT, HANG_DEADLINE = 2, 5.0
ELASTIC_WORLD = 4
ELASTIC_LOST = (2, 3)
ELASTIC_TIMEOUT = 600      # seconds a spawned world may take


def _card_line() -> str:
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"


def _elastic_sim(mesh, size: int):
    level = (size // 8).bit_length() - 1
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                    nu=4e-5, cfl=0.5, dtype="float32")
    with _latched(""):
        sim = ShardedUniformSim(cfg, mesh, level=level)
    sim.set_state(sim.grid.zero_state()._replace(
        vel=bench_state(sim.grid).vel))
    sim.step_count = ELASTIC_START
    return sim


def _whole_sha(sim) -> str:
    return _sha(*(gather_x(v) for v in sim.state))


def _elastic_exit(rank_: int, port2: int, out_dir: str, size: int) -> dict:
    """(1) on one rank of the 4-rank world."""
    from .faults import FaultPlan
    from .io import save_checkpoint
    from .parallel.launch import reinit_distributed
    from .resilience import (EventLog, PreemptionGuard, StepGuard,
                             TopologyGuard, set_event_log)
    dev = _worker_device()
    log = EventLog(os.path.join(out_dir, "elastic_events.jsonl"))
    set_event_log(log)
    plan = FaultPlan.from_env()
    mesh = world_mesh(ELASTIC_WORLD, dev)
    sim = _elastic_sim(mesh, size)
    ck = os.path.join(out_dir, "elastic_ck")
    guard = StepGuard(sim, ckpt_dir=ck, event_log=log, faults=plan,
                      snap_every=1, mirror_hosts=ELASTIC_WORLD)
    topo = TopologyGuard(mesh, timeout=120.0, faults=plan, event_log=log)
    stop = PreemptionGuard()
    saved, reinit_s, mirror_bytes = False, None, 0
    iters = []
    while sim.step_count < ELASTIC_END:
        if not saved and sim.step_count == ELASTIC_CK:
            guard.drain()
            save_checkpoint(ck, sim)
            saved = True
            mirror_bytes = guard.mirror_nbytes()
        beat = topo.step_boundary(stop, sim.step_count)
        if beat.self_lost:
            os._exit(17)                 # the dying rank writes nothing
        if beat.hung:
            raise RuntimeError(f"rank {rank_}: heartbeat hung at step "
                               f"{sim.step_count}")
        if beat.lost:
            alive = [h for h in range(topo.n_hosts) if topo.alive[h]]
            t0 = time.perf_counter()
            reinit_distributed(f"127.0.0.1:{port2}", len(alive),
                               alive.index(rank_), device=dev)
            reinit_s = time.perf_counter() - t0
            guard.elastic_recover(topo)
            continue
        rec = guard.step()
        if rec is not None:
            iters.append(int(rec["poisson_iters"]))
    for rec in guard.drain():
        iters.append(int(rec["poisson_iters"]))
    _sync()
    sha = _whole_sha(sim)
    log.close()
    return {"world": world_size(), "shards": sim.mesh.size,
            "source": guard.restore_source, "epoch": guard.topology_epoch,
            "reinit_s": reinit_s, "remesh_ms": guard.remesh_ms_total,
            "lost": list(topo.lost_process_indices()),
            "mirror_bytes": mirror_bytes, "iters": iters,
            "step": sim.step_count, "time": sim.time, "sha256": sha}


def _elastic_restart(out_dir: str, size: int) -> dict:
    """(2) on one rank of the fresh 2-rank world."""
    from .io import load_checkpoint
    from .resilience import StepGuard
    dev = _worker_device()
    sim = _elastic_sim(world_mesh(world_size(), dev), size)
    load_checkpoint(os.path.join(out_dir, "elastic_ck"), sim)
    g = StepGuard(sim, snap_every=1)
    iters = []
    while sim.step_count < ELASTIC_END:
        rec = g.step()
        if rec is not None:
            iters.append(int(rec["poisson_iters"]))
    for rec in g.drain():
        iters.append(int(rec["poisson_iters"]))
    _sync()
    return {"world": world_size(), "iters": iters, "step": sim.step_count,
            "time": sim.time, "sha256": _whole_sha(sim)}


def _elastic_hang(rank_: int) -> dict:
    """(3) on one rank of the 2-rank world: beats alone, rank 1 hanging
    after its beat at ``HANG_AT``."""
    from .faults import FaultPlan
    from .parallel.launch import shutdown_distributed
    from .resilience import PreemptionGuard, TopologyGuard
    dev = _worker_device()
    topo = TopologyGuard(world_mesh(world_size(), dev),
                         timeout=HANG_DEADLINE, faults=FaultPlan.from_env())
    stop = PreemptionGuard()
    for k in range(HANG_AT + 3):
        t0 = time.perf_counter()
        beat = topo.step_boundary(stop, k)
        if beat.hung:
            seen = time.perf_counter() - t0
            t1 = time.perf_counter()
            shutdown_distributed(abort=True)
            return {"hung_at": k, "seconds": seen, "deadline":
                    HANG_DEADLINE,
                    "abort_s": time.perf_counter() - t1,
                    "world_after_abort": bool(
                        torch.distributed.is_initialized())}
    return {"hung_at": None}


# where the elastic workers run: the card (NCCL), or, to try the drills'
# plumbing without cards, the CPU (gloo; ``--device cpu``)
_WORKER_DEVICE = ["cuda"]


def _worker_device() -> torch.device:
    if _WORKER_DEVICE[0] == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def elastic_worker(kind: str, rank_: int, world: int, port: int,
                   port2: int, out_dir: str, size: int,
                   device: str = "cuda") -> None:
    _WORKER_DEVICE[0] = device
    init_distributed(f"127.0.0.1:{port}", world, rank_,
                     expected_processes=world, device=device, timeout=300.0)
    if kind == "exit":
        res = _elastic_exit(rank_, port2, out_dir, size)
    elif kind == "restart":
        res = _elastic_restart(out_dir, size)
    else:
        res = _elastic_hang(rank_)
    if rank() == 0 or kind == "hang":
        res["rank"] = rank_
        print(json.dumps(res), flush=True)
    if kind != "hang":
        shutdown_distributed()
    # a hung gather's thread is left to the abort
    os._exit(0)


def _spawn(kind: str, world: int, out_dir: str, size: int,
           faults: dict, device: str = "cuda") -> list:
    import socket
    import subprocess

    def port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    p1, p2 = port(), port()
    procs = []
    for r in range(world):
        env = dict(os.environ)
        env.pop("CUP2D_FAULTS", None)
        if r in faults:
            env["CUP2D_FAULTS"] = faults[r]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cup2d_tpu_torch.dist_check",
             "--elastic-worker", kind, "--rank", str(r), "--world",
             str(world), "--port", str(p1), "--port2", str(p2),
             "--out", out_dir, "--size", str(size), "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    return procs


def _collect(procs, timeout: float) -> list:
    import subprocess
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def _last_json(out: str):
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def elastic_check(out_dir: str, size: int, device: str = "cuda") -> int:
    """``--elastic``: drills (1)-(3) of the module docstring."""
    from .ops import hopper_kernels as hk
    os.makedirs(out_dir, exist_ok=True)
    if device == "cpu":
        card = "cpu (gloo), no card"
    else:
        if torch.cuda.device_count() < ELASTIC_WORLD:
            raise SystemExit(f"dist_check --elastic: needs "
                             f"{ELASTIC_WORLD} cards")
        hk.build()      # once here, so the ranks load the built kernels
        card = _card_line()
    rc = 0
    t0 = time.perf_counter()
    outs = _collect(_spawn("exit", ELASTIC_WORLD, out_dir, size,
                           {r: f"host_exit@{ELASTIC_CK + 1}"
                            for r in ELASTIC_LOST}, device),
                    ELASTIC_TIMEOUT)
    exit_s = time.perf_counter() - t0
    codes = [c for c, _, _ in outs]
    res = _last_json(outs[0][1])
    want = [0 if r not in ELASTIC_LOST else 17
            for r in range(ELASTIC_WORLD)]
    ok = (codes == want and res is not None and res["source"] == "disk"
          and res["world"] == 2 and res["shards"] == 2
          and res["lost"] == list(ELASTIC_LOST)
          and res["step"] == ELASTIC_END)
    print(json.dumps({"run": "elastic exit", "ok": ok, "rcs": codes,
                      "seconds": exit_s, "card": card, **(res or {})}),
          flush=True)
    if not ok:
        rc = 1
        for c, _, err in outs:
            print(f"rc {c}: {err[-3000:]}", file=sys.stderr)
    outs = _collect(_spawn("restart", 2, out_dir, size, {}, device),
                    ELASTIC_TIMEOUT)
    ref = _last_json(outs[0][1])
    same = (res is not None and ref is not None
            and ref["sha256"] == res["sha256"]
            and ref["time"] == res["time"]
            and ref["iters"] == res["iters"][-len(ref["iters"]):])
    print(json.dumps({"run": "elastic restart", "bit_for_bit": same,
                      "rcs": [c for c, _, _ in outs], "card": card,
                      **(ref or {})}), flush=True)
    if not same:
        rc = 1
        for c, _, err in outs:
            print(f"rc {c}: {err[-3000:]}", file=sys.stderr)
    procs = _spawn("hang", 2, out_dir, size, {1: f"host_hang@{HANG_AT}"},
                   device)
    try:
        outs = _collect(procs[:1], 180)
        hung_alive = procs[1].poll() is None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = _last_json(outs[0][1])
    ok = (outs[0][0] == 0 and hung_alive and res is not None
          and res["hung_at"] == HANG_AT + 1
          and res["seconds"] < HANG_DEADLINE + 5)
    print(json.dumps({"run": "elastic hang", "ok": ok,
                      "hung_rank_alive": hung_alive, "card": card,
                      **(res or {})}), flush=True)
    if not ok:
        rc = 1
        print(f"rc {outs[0][0]}: {outs[0][2][-3000:]}", file=sys.stderr)
    import shutil
    shutil.rmtree(os.path.join(out_dir, "elastic_ck"), ignore_errors=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", choices=LAYOUTS)
    ap.add_argument("--compare", metavar="DIR")
    ap.add_argument("--out", default="chiprun_out/dist")
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--forest-target", type=int, default=10000)
    ap.add_argument("--forest-levels", type=int, nargs=2, default=(6, 8),
                    metavar=("START", "MAX"),
                    help="vortex_forest's level_start and level_max")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--runs", nargs="+", default=("uniform", "forest",
                                                  "fleet"),
                    choices=("uniform", "forest", "fleet"))
    ap.add_argument("--fleet-size", type=int, default=1024)
    ap.add_argument("--fleet-members", type=int, default=8)
    ap.add_argument("--elastic", action="store_true",
                    help="the elastic recovery drills across 4 cards")
    ap.add_argument("--elastic-worker", choices=("exit", "restart", "hang"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port2", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="--elastic's ranks on cards (NCCL) or, to try "
                    "the drills without cards, on the CPU (gloo)")
    a = ap.parse_args(argv)
    if a.elastic_worker:
        elastic_worker(a.elastic_worker, a.rank, a.world, a.port, a.port2,
                       a.out, a.size, a.device)
        return 0
    if a.elastic:
        return elastic_check(a.out, a.size, a.device)
    if a.compare:
        return compare(a.compare)
    if not a.layout:
        ap.error("give --layout or --compare")
    run_layout(a.layout, a.out, a.size, a.forest_target, a.steps,
               tuple(a.forest_levels), tuple(a.runs),
               (a.fleet_size, a.fleet_members))
    return 0


if __name__ == "__main__":
    sys.exit(main())
