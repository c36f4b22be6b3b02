"""Where the time of the uniform or the forest step goes on the card.

Uniform (default): runs ``UniformGrid.step(obstacle_terms=False)`` on the
benchmark state (``bench_state``, dt = h/2, f32) under each solver, one
warm-up step and then ``--steps`` steps under ``torch.profiler``;
``--mesh D`` splits the grid along x into D slabs on the one card
(``UniformGrid.attach_mesh``, the step of ``ShardedUniformSim``).
Channel (``--channel``): the 8192 x 2048 parabolic channel table of
chip_smoke phases 8 and 10 (``cases.channel_table(0.2, "parabolic")``,
the JAX package's channel configuration without its disk) from the
impulsive start u = u_in, ``--mesh D`` slabs or solo, under
CUP2D_POIS=fas only (the default solver does not converge there at f32):
one warm-up production ``step_once`` at the CFL dt, then ``--steps``.
Forest (``--forest``): builds ``amr.vortex_forest`` (the ~1e4-block
synthetic-vortex forest of the canonical domain), runs its 10 startup
steps and one production step unprofiled, then ``--steps`` production
``AMRSim.step_once`` steps under the profiler; ``--twolevel`` (default
solver only) skips the startup steps and takes one production step from
the cold pressure instead, whose solve (> 15 iterations) engages the
two-level preconditioner for the profiled steps. Prints per solver: the
wall time per step, the device-busy share (sum of kernel times over the
wall time of the window), the device operations (kernels and copies)
launched per step, the Poisson iterations, and the kernels that take the
most device time. The Chrome trace of each window goes to
``--out`` (default ``build/profile/``, which git ignores).

    python -m cup2d_tpu_torch.profile_step --size 8192 --steps 3
    python -m cup2d_tpu_torch.profile_step --size 8192 --mesh 4
    python -m cup2d_tpu_torch.profile_step --forest --steps 3
    python -m cup2d_tpu_torch.profile_step --forest --twolevel --steps 5
    python -m cup2d_tpu_torch.profile_step --channel --mesh 4
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _summary(prof, steps, wall_ms, top):
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    rows = [{"kernel": e.key[:90], "calls": e.count,
             "ms_per_step": e.self_device_time_total / 1e3 / steps}
            for e in events[:top]]
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "launches_per_step": sum(e.count for e in events) / steps,
            "device_busy_share": device_ms / wall_ms, "top": rows}


def profile_forest(steps: int, pois: str, out_dir: str, top: int,
                   start=None, twolevel: bool = False) -> tuple[dict, tuple]:
    """Profile ``steps`` production steps of the forest under ``pois``
    (after the startup steps, or with ``twolevel`` after one cold
    production step). ``start`` = (cfg, blocks, fields) of a forest built
    earlier, or None to build ``vortex_forest``; returns the summary and
    the start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .amr import AMRSim, vortex_forest
    from .convert import forest_from_numpy, forest_to_numpy

    os.environ.pop("CUP2D_POIS", None)
    if pois:
        os.environ["CUP2D_POIS"] = pois
    try:
        if start is None:
            sim = vortex_forest()
            start = (sim.cfg,) + forest_to_numpy(sim)
        else:
            sim = AMRSim(start[0], shapes=[])
            forest_from_numpy(sim, start[1], start[2])
    finally:
        os.environ.pop("CUP2D_POIS", None)
    if twolevel:
        sim.step_count = 10
        sim.step_once()
    else:
        for _ in range(11):
            sim.step_once()
    torch.cuda.synchronize()
    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            iters.append(sim.step_once()["poisson_iters"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace_forest_{sim.poisson_mode}.json"))
    out = {"mode": sim.poisson_mode, "blocks": len(sim.forest.blocks),
           "n_pad": sim._npad_hwm, "steps": steps, "iters": iters}
    out.update(_summary(prof, steps, wall_ms, top))
    return out, start


CHANNEL_CFG = dict(bpdx=4, bpdy=1, level_max=1, level_start=0, extent=4.0,
                   nu=1e-4, cfl=0.5, max_poisson_iterations=200,
                   poisson_tol=1e-3, poisson_tol_rel=1e-2, dtype="float32")


def profile_channel(steps: int, out_dir: str, top: int,
                    mesh: int = 0) -> dict:
    """Profile ``steps`` production steps of the parabolic channel at
    level 8 (8192 x 2048) under fas, split into ``mesh`` slabs of the one
    card or solo."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .cases import channel_table
    from .config import SimConfig
    from .parallel.mesh import ShardedUniformSim, make_mesh
    from .uniform import UniformSim

    table = channel_table(0.2, profile="parabolic")
    os.environ["CUP2D_POIS"] = "fas"
    try:
        cfg = SimConfig(**CHANNEL_CFG)
        if mesh:
            sim = ShardedUniformSim(
                cfg, make_mesh(devices=[torch.device("cuda")] * mesh),
                level=8, bc=table)
        else:
            sim = UniformSim(cfg, level=8, bc=table)
    finally:
        os.environ.pop("CUP2D_POIS", None)
    st = sim.grid.zero_state()
    st.vel[0] = 0.2
    if mesh:
        sim.set_state(st)
    else:
        sim.state = st
    sim.step_count = 10          # production solves
    sim.step_once()
    torch.cuda.synchronize()
    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            iters.append(sim.step_once()["poisson_iters"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace_channel_fas_mesh{mesh}.json"))
    out = {"mode": sim.poisson_mode, "case": "channel", "mesh": mesh,
           "steps": steps, "iters": iters}
    out.update(_summary(prof, steps, wall_ms, top))
    return out


def profile_solver(size: int, steps: int, pois: str, out_dir: str,
                   top: int, mesh: int = 0) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import SimConfig
    from .parallel.mesh import make_mesh, shard_state
    from .uniform import UniformGrid, bench_state

    os.environ["CUP2D_POIS"] = pois
    try:
        grid = UniformGrid(
            SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                      extent=1.0, nu=4e-5, cfl=0.5, dtype="float32"),
            level=(size // 8).bit_length() - 1)
    finally:
        os.environ.pop("CUP2D_POIS", None)
    state = bench_state(grid)
    if mesh:
        grid.attach_mesh(make_mesh(devices=[grid.device] * mesh))
        state = shard_state(state, grid.mesh)
    dt = torch.tensor(0.5 * grid.h, device=grid.device)
    torch.cuda.reset_peak_memory_stats()
    state, _ = grid.step(state, dt, obstacle_terms=False)
    torch.cuda.synchronize()
    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, diag = grid.step(state, dt, obstacle_terms=False)
            iters.append(diag["poisson_iters"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_mesh{mesh}" if mesh else ""
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace_{grid.poisson_mode}_{size}{tag}.json"))
    out = {"mode": grid.poisson_mode, "size": size, "mesh": mesh,
           "steps": steps, "iters": iters,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    out.update(_summary(prof, steps, wall_ms, top))
    return out


def main(argv=None) -> int:
    import subprocess
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--forest", action="store_true",
                    help="profile the forest step instead")
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the uniform step into this many slabs on "
                         "the one card")
    ap.add_argument("--channel", action="store_true",
                    help="profile the parabolic channel under fas instead")
    ap.add_argument("--twolevel", action="store_true",
                    help="with --forest: the default solver's two-level "
                         "steps, after one cold production step")
    args = ap.parse_args(argv)
    if args.twolevel and not args.forest:
        ap.error("--twolevel profiles the forest: add --forest")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    start = None
    for pois in (("fas",) if args.channel else
                 ("",) if args.twolevel else ("", "fas")):
        if args.channel:
            res = profile_channel(args.steps, args.out, args.top, args.mesh)
        elif args.forest:
            res, start = profile_forest(args.steps, pois, args.out,
                                        args.top, start, args.twolevel)
        else:
            res = profile_solver(args.size, args.steps, pois, args.out,
                                 args.top, args.mesh)
        print(json.dumps({k: v for k, v in res.items() if k != "top"}))
        for row in res["top"]:
            print(f"  {row['ms_per_step']:9.3f} ms/step  "
                  f"{row['calls']:6d} calls  {row['kernel']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
