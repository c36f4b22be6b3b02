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
solver. Each layout writes ``DIR/<layout>.json`` (rank 0 under a world):
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


def run_layout(layout: str, out_dir: str, size: int, target: int,
               steps: int, levels=(6, 8)) -> None:
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
        res["runs"].update(uniform_runs(mesh, dev, size, steps))
        res["runs"].update(forest_runs(mesh, dev, target, steps, levels))
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
    a = ap.parse_args(argv)
    if a.compare:
        return compare(a.compare)
    if not a.layout:
        ap.error("give --layout or --compare")
    run_layout(a.layout, a.out, a.size, a.forest_target, a.steps,
               tuple(a.forest_levels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
