#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cup2d_tpu_torch``) on one
NVIDIA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one output line or more each; any failure exits non-zero before
the result lines:

1. build the eight Hopper kernels from ``cup2d_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card;
2. each kernel against its plain PyTorch twin on the card, f32, with the
   bounds stated below (the forest lab RHS per h class, at the path's nu
   and at a diffusion-dominated nu = 1), plus kernel and twin times
   (CUDA events) and, for the block-Jacobi update (at 1, 1000 and 16384
   blocks), the time of ``torch.addmm``; the sweep chain at every level of
   the 8192^2 V-cycle hierarchy with the chains a cycle launches there
   (graph replays: ms, bound and launches per level and per cycle); the
   four redesigned kernels' times beside their earlier designs', and the
   substage pairs' bounds at the face-sharing design's operation count
   on their own inputs beside the fixed per-cell count of the earlier
   design (both printed; the JSON line carries the first). The x-split
   step's halo kernels run at its main
   path's shapes (8192^2 on 4 slabs of one card), each shard against its
   twin, and the assembled slabs against the solo kernels (substage pair,
   single sweep) to at most 1 ulp (the same per-cell code and ghost
   values: bit for bit is expected); the single-op RHS, which lies on no
   path, runs on an 8192^2 normal lab (<= 2e-6 relative) and on the
   benchmark's padded lab (<= 2e-6 once scaled by 1/h^2, as a Heun stage
   adds it: its smooth differences cancel to ~1e-4 of an ulp's weight);
3. the uniform main path: ``UniformGrid.step(obstacle_terms=False)`` on
   the 8192^2 f32 benchmark state, under the default solver (BiCGSTAB +
   bf16 multigrid) and under CUP2D_POIS=fas, one warm-up and five timed
   steps each, with the uniform kernels' launch counts set to 0 before
   the phase and read after it;
4. five ``UniformSim.step_once`` steps at 256^2 f32 on the card and on
   the CPU (which runs the twins), velocity relative Linf <= 1e-4: the
   two devices sum in different orders;
5. the forest main path: ``amr.vortex_forest``, the synthetic-vortex
   forest of the canonical domain (bpdx 2, bpdy 1, extent 4, levelStart 6,
   levelMax 8, rtol 0.05, no compression, f32) adapted on the card past
   10,000 blocks, then under the default solver (BiCGSTAB + block-Jacobi,
   two-level on the iters>15 trigger) and under CUP2D_POIS=fas: 10
   startup steps (exact solves), 5 production steps and one ``adapt()``,
   each timed, with the forest kernels' launch counts set to 0 before
   each run and read after it (2 lab-RHS launches per step; one
   block-Jacobi launch per production FAS cycle, none under the default).
   The default run is made twice from the same state and must repeat
   itself bit for bit;
6. a multilevel forest (``amr.multilevel_forest``, levelMax 5) on the
   card and on the CPU, f32, 5 steps with an ``adapt()`` after the
   second: equal block key sets and velocity relative Linf <= 1e-4, once
   under CUP2D_POIS=fas at the production tolerances and once under the
   default BiCGSTAB at tolerances 1e-6/1e-5. (At the production 1e-3/1e-2
   a BiCGSTAB convergence test that lands on its edge takes one more
   iteration on one device than on the other, and the states then differ
   by the tolerance, not by rounding; 1000 times tighter, they agree
   whatever the iteration counts.)
7. the x-split main path: ``parallel.mesh.ShardedUniformSim`` on
   ``make_mesh(devices=["cuda:0"] * 4)`` at 8192^2 f32, ``bench_state``,
   fixed dt = h/2, production steps (step_count set past the exact
   startup), under the default solver and under CUP2D_POIS=fas: one
   warm-up and three timed steps, the launch counts set to 0 before the
   split run and read after it (2 halo-substage launches per shard and
   step; halo sweeps under fas only; no solo substage, correction or
   sweep-chain launch), then the solo ``UniformSim`` from the same state:
   equal iterations every step and velocity within 1e-5 relative (only
   the order of the reductions differs, and they accumulate in f64).

Then one JSON line of per-kernel numbers, the card's name and power limit
as nvidia-smi prints them, and the result line
``{"ok": true, "device": {...}}`` last. Needs no network; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np  # noqa: E402

from cup2d_tpu_torch import SimConfig, UniformGrid, UniformSim  # noqa: E402
from cup2d_tpu_torch.amr import (AMRSim, multilevel_forest,  # noqa: E402
                                 vortex_forest)
from cup2d_tpu_torch.convert import (forest_from_numpy,  # noqa: E402
                                     forest_to_numpy)
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.timing import (OPS_SWEEP_CELL, bound,  # noqa: E402
                                        cuda_ms, graph_ms, substage_ops,
                                        sweep_level_table, weno_faces)
from cup2d_tpu_torch.ops.stencil import pad_vector  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    Slabs, exchange_x, fused_advect_heun_sharded, gather_x,
    overlap_jacobi_sweeps, split_x)
from cup2d_tpu_torch.poisson import block_precond_matrix  # noqa: E402
from cup2d_tpu_torch.uniform import bench_state  # noqa: E402

# bounds (f32, kernel vs plain twin on the same inputs)
HEUN_ABS = 2e-6        # unit-scale operands at dt = h/2; FMA contraction
#                        in the kernel, amplified by ih2 = 1/h^2
CORRECTION_ABS = 5e-6  # unit-scale operands
JACOBI_REL = 2e-6      # relative to max |result|
LAB_RHS_REL = 2e-6     # relative to max |result| over the blocks of one
#                        h: the output scales with h and nu dt; FMA
#                        contraction in the kernel
BLOCK_JACOBI_REL = 2e-6  # relative to max |result|: summation order of
#                          the 64-term products differs from the GEMM's
TRAJ_REL = 1e-4        # card vs CPU after 5 steps: reduction order differs
RHS_REL = 2e-6         # single-op RHS relative to max |result| on a
#                        normal lab: FMA contraction in the kernel
SPLIT_ULPS = 1         # assembled halo-kernel slabs vs the solo kernel
SHARDED_REL = 1e-5     # split vs solo step on one card: the Krylov and
#                        FAS reductions sum in another order
FOREST_TARGET = 10000  # active blocks of the forest main path
MESH_D = 4             # slabs of the split main path, all on one card

# the previous designs of the four redesigned kernels, at the shapes of
# their JSON entries (n = 2 on 8192^2; [16384, 8, 8] in graph replay;
# both substages on [1, 2, 8192, 8192], and on 4 slabs of it):
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W before each redesign
# (PERF.md section 6); cup2d_tpu_torch.kernel_ab times each pair in one run
EARLIER_MS = {"fused_jacobi_sweeps": 0.681,
              "fused_block_jacobi_update": 0.0191,
              "fused_advect_heun": 3.973,
              "advect_substage_halo": 4.320}

# operations per cell, counting each add, multiply, compare, select, max,
# integer op and reciprocal as one: one WENO5 reconstruction is 83 (33
# smoothness, 30 weights, 15 candidate stencils, 5 blend), a derivative
# 177 (10 selects, 2 reconstructions, 1 difference); per component two
# derivatives, a 5-op Laplacian, a 6-op RHS and a 3-op update: 368 in
# the per-cell design, which reconstructs every face twice. The substage
# bound counts the face-sharing design's operations on its inputs
# instead (ops.timing.substage_ops); this count is printed beside it
OPS_SUBSTAGE_CELL = 2 * 368
OPS_CORRECTION_CELL = 15     # 3 pressure, 2 x 3 gradient, 2 x 3 update
# forest lab RHS: the substage cell less its 3-op update, per component
OPS_LAB_RHS_CELL = 2 * 365
BYTES_LAB_RHS_BLOCK = 4 * (2 * 14 * 14 + 2 * 8 * 8 + 1)
# block-Jacobi update: 64-term FMA chain (2 ops a term), subtract, add
OPS_BLOCK_JACOBI_ELEM = 2 * 64 + 2
BYTES_BLOCK_JACOBI_BLOCK = 4 * 4 * 64     # e, r, lap read; out written


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two f32 tensors in units of the last place
    (0 when they are equal bit for bit)."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bench_cfg(ny: int, nx: int):
    """The benchmark's configuration and the level that gives ny x nx."""
    level = (ny // 8).bit_length() - 1
    cfg = SimConfig(bpdx=nx // ny, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    return cfg, level


def bench_grid(ny: int, nx: int, device):
    """A UniformGrid of the benchmark's configuration at ny x nx."""
    cfg, level = bench_cfg(ny, nx)
    return UniformGrid(cfg, level=level, device=device)


def phase_kernels(dev):
    """Phase 2. Returns per-kernel dicts of the main-path-shape numbers."""
    res = {k: {"max_abs_err": 0.0} for k in hk.launches}

    def note(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    # K2 at the listed shapes and the main path's, on the benchmark's own
    # unit-scale velocity (per-member amplitudes and dt on batches)
    for shape in [(1, 2, 1024, 1024), (3, 2, 256, 512),
                  (1, 2, 8192, 8192)]:
        L, _, ny, nx = shape
        g = bench_grid(ny, nx, dev)
        amp = torch.tensor([1.0, 0.7, 0.4][:L], device=dev)
        v = (bench_state(g).vel[None] * amp[:, None, None, None]
             ).contiguous()
        dt = torch.tensor([0.5, 0.35, 0.27][:L], device=dev) * g.h
        got = hk.fused_advect_heun(v, g.h, 4e-5, dt)
        ref = hk.fused_advect_heun_plain(v, g.h, 4e-5, dt)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        del got, ref
        check(err <= HEUN_ABS, f"fused_advect_heun {shape}: {err} > "
              f"{HEUN_ABS}")
        note("fused_advect_heun", err)
        ms = cuda_ms(lambda: hk.fused_advect_heun(v, g.h, 4e-5, dt),
                     10)
        pms = cuda_ms(lambda: hk.fused_advect_heun_plain(
            v, g.h, 4e-5, dt), 2)
        print(f"phase 2 fused_advect_heun {list(shape)}: max_abs_err {err} "
              f"(rel {rel}) kernel_ms {ms} twin_ms {pms}", flush=True)
        if ny == 8192:
            cells = ny * nx
            facs = hk._substage_facs(dt, g.h, 4e-5, (L,), L, torch.float32,
                                     dev)
            v1 = hk.advect_substage(v, None, facs, 0.5, 1.0 / (g.h * g.h))
            faces = (weno_faces(v) + weno_faces(v1)) / (2 * L * cells)
            b = bound(40.0 * cells, substage_ops(v) + substage_ops(v1))
            b_old = bound(40.0 * cells, 2 * OPS_SUBSTAGE_CELL * cells)
            del v1
            res["fused_advect_heun"].update(ms=ms, plain_ms=pms,
                                            bound_ms=b[0], bound_by=b[1])
            print(f"phase 2 fused_advect_heun {list(shape)} both "
                  f"substages: kernel_ms {ms} (earlier design "
                  f"{EARLIER_MS['fused_advect_heun']}) bound_ms {b[0]} "
                  f"({b[1]}; {faces} reconstructions per cell and "
                  f"component) bound_ms at 368 operations a cell and "
                  f"component {b_old[0]} ({b_old[1]})", flush=True)
        del v
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    # K5 on unit-scale operands, pfac = -dt h / 2 at dt = h/2
    for ny in (1024, 8192):
        h = 1.0 / ny
        x, p, v = rn(1, ny, ny), rn(1, ny, ny), rn(1, 2, ny, ny)
        scal = torch.stack([x.mean(), p.mean(),
                            torch.tensor(-0.25 * h * h, device=dev)]
                           ).reshape(1, 3).contiguous()
        got = hk.fused_correction(x, p, v, scal, 1.0 / (h * h))
        ref = hk.fused_correction_plain(x, p, v, scal, 1.0 / (h * h))
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        del got, ref
        check(err <= CORRECTION_ABS,
              f"fused_correction {ny}^2: {err} > {CORRECTION_ABS}")
        note("fused_correction", err)
        ms = cuda_ms(lambda: hk.fused_correction(
            x, p, v, scal, 1.0 / (h * h)), 10)
        pms = cuda_ms(lambda: hk.fused_correction_plain(
            x, p, v, scal, 1.0 / (h * h)), 3)
        print(f"phase 2 fused_correction [1,{ny},{ny}]: max_abs_err {err} "
              f"kernel_ms {ms} twin_ms {pms}", flush=True)
        if ny == 8192:
            cells = ny * ny
            b = bound(28.0 * cells, OPS_CORRECTION_CELL * cells)
            res["fused_correction"].update(ms=ms, plain_ms=pms,
                                           bound_ms=b[0], bound_by=b[1])
        del x, p, v

    # K6: the chain lengths 1, 2, 3, 6 and the 24-sweep coarsest chain, at a
    # coarse, a mid and the finest level of the 8192^2 hierarchy
    for ny, ns in ((8, (24,)), (1024, (1, 2, 3, 6, 24)), (8192, (2, 24))):
        e, r = rn(ny, ny), rn(ny, ny)
        for n in ns:
            for fz in (False, True):
                got = hk.fused_jacobi_sweeps(e, r, 0.8, n, fz)
                ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, fz)
                err = float((got - ref).abs().max())
                rel = err / float(ref.abs().max())
                del got, ref
                check(rel <= JACOBI_REL, f"fused_jacobi_sweeps {ny}^2 n={n}"
                      f" from_zero={fz}: rel {rel} > {JACOBI_REL}")
                note("fused_jacobi_sweeps", err)
                reps = 10 if n <= 6 else 3
                ms = cuda_ms(lambda: hk.fused_jacobi_sweeps(
                    e, r, 0.8, n, fz), reps)
                pms = cuda_ms(lambda: hk.jacobi_sweeps_plain(
                    e, r, 0.8, n, fz), 2)
                print(f"phase 2 fused_jacobi_sweeps [{ny},{ny}] n={n} "
                      f"from_zero={fz}: max_abs_err {err} (rel {rel}) "
                      f"kernel_ms {ms} twin_ms {pms}", flush=True)
                if ny == 8192 and n == 2 and not fz:
                    cells = ny * ny
                    b = bound(12.0 * cells, OPS_SWEEP_CELL * n * cells)
                    res["fused_jacobi_sweeps"].update(
                        ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])
                    print(f"phase 2 fused_jacobi_sweeps [8192,8192] n=2: "
                          f"kernel_ms {ms} (earlier design "
                          f"{EARLIER_MS['fused_jacobi_sweeps']}) bound_ms "
                          f"{b[0]}", flush=True)
        del e, r
    torch.cuda.empty_cache()
    phase_sweep_levels(dev)

    # K4 on labs of unit-scale velocity with mixed per-block h: levels 6
    # and 7 of the canonical domain and the pad rows' h = 1, at dt = h7/2.
    # The output scales with the block (afac = -dt h, dfac = nu dt), so
    # each h class is held relative to its own max |ref|: at the path's
    # nu, where advection dominates and diffusion is 1-2% of a real row,
    # and at nu = 1, where diffusion dominates 250-500x; a wrong afac or
    # dfac fails both. Times (path's nu): per call in eager order (host
    # launch included), and device time from graph replays over 3
    # operand sets (77 MB at 16384 labs)
    h6 = 4.0 / 2 / 8 / 64
    dt = torch.tensor(0.25 * h6, device=dev)
    for n in (128, 16384):
        labs = [rn(n, 2, 14, 14) for _ in range(3)]
        lab = labs[0]
        cls = torch.arange(n, device=dev) % 3
        h = torch.tensor([h6, h6 / 2, 1.0], device=dev)[cls].reshape(
            n, 1, 1, 1)
        for nu in (4e-5, 1.0):
            got = hk.fused_lab_rhs(lab, h, nu, dt)
            ref = hk.fused_lab_rhs_plain(lab, h, nu, dt)
            diff = (got - ref).abs()
            err = float(diff.max())
            rel = max(float(diff[cls == c].max() / ref[cls == c].abs().max())
                      for c in range(3))
            check(rel <= LAB_RHS_REL, f"fused_lab_rhs [{n},2,14,14] nu={nu}"
                  f": rel {rel} > {LAB_RHS_REL}")
            note("fused_lab_rhs", err)
            print(f"phase 2 fused_lab_rhs [{n},2,14,14] nu={nu}: max_abs_err "
                  f"{err} (rel, worst h class, {rel})", flush=True)
        eager = cuda_ms(lambda: hk.fused_lab_rhs(lab, h, 4e-5, dt), 20)
        ms = graph_ms([lambda x=x: hk.fused_lab_rhs(x, h, 4e-5, dt)
                       for x in labs])
        pms = graph_ms([lambda x=x: hk.fused_lab_rhs_plain(x, h, 4e-5, dt)
                        for x in labs], reps=6)
        print(f"phase 2 fused_lab_rhs [{n},2,14,14]: kernel_ms {ms} (eager "
              f"per call {eager}) twin_ms {pms}", flush=True)
        b = bound(BYTES_LAB_RHS_BLOCK * n, OPS_LAB_RHS_CELL * 64 * n)
        res["fused_lab_rhs"].update(ms=ms, plain_ms=pms, bound_ms=b[0],
                                    bound_by=b[1], library_ms=None)
        del labs, lab, got, ref

    # K8 with the forest's own P_inv; library: one addmm, TF32 off.
    # Device times from graph replays over 6 operand sets (72 MB at 16384)
    # at 1 block, at a count that is no multiple of the kernel's 32-block
    # tile, and at the forest path's 16384
    torch.backends.cuda.matmul.allow_tf32 = False
    p_inv = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                         device=dev)
    for n in (1, 1000, 16384):
        sets = [(rn(n, 8, 8), rn(n, 8, 8), rn(n, 8, 8)) for _ in range(6)]
        e, r, lap = sets[0]
        got = hk.fused_block_jacobi_update(e, r, lap, p_inv)
        ref = hk.block_jacobi_plain(e, r, lap, p_inv)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= BLOCK_JACOBI_REL, f"fused_block_jacobi_update [{n},8,8]"
              f": rel {rel} > {BLOCK_JACOBI_REL}")
        note("fused_block_jacobi_update", err)
        eager = cuda_ms(lambda: hk.fused_block_jacobi_update(
            e, r, lap, p_inv), 50)
        ms = graph_ms([lambda o=o: hk.fused_block_jacobi_update(*o, p_inv)
                       for o in sets])
        pms = graph_ms([lambda o=o: hk.block_jacobi_plain(*o, p_inv)
                        for o in sets])
        pt = p_inv.T
        lms = graph_ms([lambda o=o: torch.addmm(
            o[0].reshape(n, 64), o[1].reshape(n, 64) - o[2].reshape(n, 64),
            pt) for o in sets])
        earlier = (f" (earlier design "
                   f"{EARLIER_MS['fused_block_jacobi_update']})"
                   if n == 16384 else "")
        print(f"phase 2 fused_block_jacobi_update [{n},8,8]: max_abs_err "
              f"{err} (rel {rel}) kernel_ms {ms}{earlier} (eager per call "
              f"{eager}) twin_ms {pms} addmm_ms {lms}", flush=True)
        b = bound(BYTES_BLOCK_JACOBI_BLOCK * n + 4 * 64 * 64,
                  OPS_BLOCK_JACOBI_ELEM * 64 * n)
        res["fused_block_jacobi_update"].update(
            ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
            library_ms=lms)
        del sets, e, r, lap, got, ref
    return res


def phase_sweep_levels(dev, size: int = 8192) -> list:
    """Phase 2, continued: the sweep chain at each level of the 8192^2
    V-cycle hierarchy with the chains one cycle launches there (n = 2 from
    zero and n = 2 from the corrected e down to 16^2, 24 from zero on
    8^2), device time from graph replays; per level its ms, bound and
    launches per cycle, then the sums over one cycle."""
    rows = sweep_level_table(hk.fused_jacobi_sweeps, dev, size=size)
    for row in rows:
        chains = ", ".join(
            f"n={c['n']}{' from zero' if c['from_zero'] else ''} "
            f"{c['ms']} ms" for c in row["chains"])
        print(f"phase 2 sweep level {row['level']}^2: kernel_ms {row['ms']} "
              f"bound_ms {row['bound_ms']} launches/cycle {row['launches']}"
              f" ({chains})", flush=True)
    print(f"phase 2 sweep levels per V-cycle: kernel_ms "
          f"{sum(r['ms'] for r in rows)} bound_ms "
          f"{sum(r['bound_ms'] for r in rows)} launches "
          f"{sum(r['launches'] for r in rows)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_halo_kernels(dev, res, size: int = 8192) -> None:
    """Phase 2, continued: the x-split step's halo kernels on the 8192^2
    benchmark velocity and on seeded normal fields split into MESH_D slabs
    of one card, and the single-op RHS on a normal lab and on the
    benchmark's padded lab. Fills ``res`` for the three kernels."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    walls = [(d == 0, d == MESH_D - 1) for d in range(MESH_D)]
    g = bench_grid(size, size, dev)
    cells = g.ny * g.nx
    v = bench_state(g).vel[None].contiguous()
    dt = torch.tensor([0.5], device=dev) * g.h
    ih2 = 1.0 / (g.h * g.h)

    # K3: assembled slabs vs the solo kernel, then shard by shard vs the
    # twin on the split step's own operands (both substages)
    s0 = split_x(v, mesh)
    solo = hk.fused_advect_heun(v, g.h, 4e-5, dt)
    split = gather_x(fused_advect_heun_sharded(s0, g.h, 4e-5, dt))
    u3 = ulps(split, solo)
    del split, solo
    print(f"phase 2 advect_substage_halo {size}^2 on {MESH_D} slabs vs "
          f"fused_advect_heun: max {u3} ulp", flush=True)
    check(u3 <= SPLIT_ULPS, f"advect_substage_halo: {u3} ulp from the solo "
          "kernel")
    facs = hk._substage_facs(dt, g.h, 4e-5, (1,), 1, torch.float32, dev)
    aux0 = exchange_x(s0, 3)
    s1 = Slabs([hk.advect_substage_halo(p, None, aux0[d], facs, 0.5, ih2,
                                        *walls[d])
                for d, p in enumerate(s0.parts)], mesh)
    aux1 = exchange_x(s1, 3)
    err = 0.0
    for d in range(MESH_D):
        for args in ((s0.parts[d], None, aux0[d], facs, 0.5),
                     (s1.parts[d], s0.parts[d], aux1[d], facs, 1.0)):
            k = hk.advect_substage_halo(*args, ih2, *walls[d])
            p = hk.advect_substage_halo_plain(*args, ih2, *walls[d])
            err = max(err, float((k - p).abs().max()))
            del k, p
    check(err <= HEUN_ABS, f"advect_substage_halo: {err} > {HEUN_ABS}")

    def k3(sub):
        for d in range(MESH_D):
            sub(s0.parts[d], None, aux0[d], facs, 0.5, ih2, *walls[d])
        for d in range(MESH_D):
            sub(s1.parts[d], s0.parts[d], aux1[d], facs, 1.0, ih2,
                *walls[d])

    ms = cuda_ms(lambda: k3(hk.advect_substage_halo), 10)
    pms = cuda_ms(lambda: k3(hk.advect_substage_halo_plain), 1)
    aux_bytes = 2 * sum(a.numel() for a in aux0) * 4
    ops = sum(substage_ops(p) for p in s0.parts + s1.parts)
    b = bound(40.0 * cells + aux_bytes, ops)
    b_old = bound(40.0 * cells + aux_bytes, 2 * OPS_SUBSTAGE_CELL * cells)
    res["advect_substage_halo"].update(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound_ms=b[0], bound_by=b[1],
                                       library_ms=None)
    print(f"phase 2 advect_substage_halo [1,2,{size},{size // MESH_D}] "
          f"x{MESH_D}, both "
          f"substages: max_abs_err {err} kernel_ms {ms} (earlier design "
          f"{EARLIER_MS['advect_substage_halo']}) twin_ms {pms} bound_ms "
          f"{b[0]} ({b[1]}) bound_ms at 368 operations a cell and "
          f"component {b_old[0]} ({b_old[1]})", flush=True)
    del s0, s1, aux0, aux1

    # K1 on a seeded normal lab (neighbours differ by O(1): the RHS has no
    # cancellation, and is held relative to its max) and on the
    # benchmark's padded lab. There the undivided WENO derivative of a
    # smooth field is a difference of two O(1) reconstructions ~1e-3
    # apart, so one ulp of a reconstruction is ~1e-4 of the RHS in either
    # implementation; it is held at the scale a Heun stage adds it to the
    # velocity (x ih2), the substage's own absolute bar
    before = hk.launches["advect_diffuse_rhs"]
    gen = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    for name, lab in (("normal", torch.randn(2, g.ny + 6, g.nx + 6,
                                             generator=gen, device=dev)),
                      ("benchmark", pad_vector(v, 3)[0].contiguous())):
        got = hk.advect_diffuse_rhs(lab, g.h, 4e-5, 0.5 * g.h)
        ref = hk.advect_diffuse_rhs_plain(lab, g.h, 4e-5, 0.5 * g.h)
        e = float((got - ref).abs().max())
        rel = e / float(ref.abs().max())
        del got, ref
        print(f"phase 2 advect_diffuse_rhs {name} lab {list(lab.shape)}: "
              f"max_abs_err {e} (rel {rel}; x ih2 {e * ih2})", flush=True)
        if name == "normal":
            check(rel <= RHS_REL, f"advect_diffuse_rhs {name}: rel {rel} "
                  f"> {RHS_REL}")
        else:
            check(e * ih2 <= HEUN_ABS, f"advect_diffuse_rhs {name}: "
                  f"{e} x ih2 > {HEUN_ABS}")
        err = max(err, e)
    del v
    ms = cuda_ms(lambda: hk.advect_diffuse_rhs(lab, g.h, 4e-5, 0.5 * g.h),
                 10)
    pms = cuda_ms(lambda: hk.advect_diffuse_rhs_plain(lab, g.h, 4e-5,
                                                      0.5 * g.h), 1)
    b = bound(4.0 * lab.numel() + 8.0 * cells, OPS_LAB_RHS_CELL * cells)
    res["advect_diffuse_rhs"].update(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        library_ms=None,
        launches=hk.launches["advect_diffuse_rhs"] - before)
    print(f"phase 2 advect_diffuse_rhs {list(lab.shape)}: kernel_ms {ms} "
          f"twin_ms {pms}", flush=True)
    del lab
    torch.cuda.empty_cache()

    # K7: the finest split level and two coarse ones (a split 64^2 level
    # of 16-wide slabs and a gathered 16^2 level on one shard)
    gen = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    for n, m in ((size, mesh), (64, mesh), (16, make_mesh(devices=[dev]))):
        e = torch.randn(n, n, generator=gen, device=dev)
        r = torch.randn(n, n, generator=gen, device=dev)
        es, rs = split_x(e, m), split_x(r, m)
        for fz in (False, True):
            split = gather_x(overlap_jacobi_sweeps(es, rs, 0.8, 1, fz))
            u7 = ulps(split, hk.fused_jacobi_sweeps(e, r, 0.8, 1, fz))
            check(u7 <= SPLIT_ULPS, f"jacobi_halo_sweep {n}^2 from_zero="
                  f"{fz}: {u7} ulp from the solo kernel")
            print(f"phase 2 jacobi_halo_sweep {n}^2 on {m.size} slabs "
                  f"from_zero={fz} vs fused_jacobi_sweeps(n=1): max {u7} "
                  "ulp", flush=True)
        aux = exchange_x(es, 1)
        mw = [(d == 0, d == m.size - 1) for d in range(m.size)]
        for d in range(m.size):
            k = hk.jacobi_halo_sweep(es.parts[d], rs.parts[d], aux[d], 0.8,
                                     *mw[d])
            p = hk.jacobi_halo_sweep_plain(es.parts[d], rs.parts[d],
                                           aux[d], 0.8, *mw[d])
            rel = float((k - p).abs().max() / p.abs().max())
            check(rel <= JACOBI_REL, f"jacobi_halo_sweep {n}^2 shard {d}: "
                  f"rel {rel} > {JACOBI_REL}")
            err = max(err, float((k - p).abs().max()))
        if n == size:
            def k7(sweep):
                for d in range(MESH_D):
                    sweep(es.parts[d], rs.parts[d], aux[d], 0.8, *mw[d])
            ms = cuda_ms(lambda: k7(hk.jacobi_halo_sweep), 20)
            pms = cuda_ms(lambda: k7(hk.jacobi_halo_sweep_plain), 2)
            b = bound(12.0 * n * n + 8.0 * 2 * n * MESH_D,
                      OPS_SWEEP_CELL * n * n)
            res["jacobi_halo_sweep"].update(ms=ms, plain_ms=pms,
                                            bound_ms=b[0], bound_by=b[1],
                                            library_ms=None)
            print(f"phase 2 jacobi_halo_sweep [{n},{n // MESH_D}] x{MESH_D}"
                  f", one sweep: kernel_ms {ms} twin_ms {pms}", flush=True)
        del e, r, es, rs, aux
    res["jacobi_halo_sweep"]["max_abs_err"] = err
    torch.cuda.empty_cache()


def run_sharded(dev, pois: str, steps: int = 3, size: int = 8192) -> dict:
    """Phase 7 under one solver: the split run (counts from 0), then the
    solo run from the same state, ``steps`` timed production steps after
    a warm-up. Checks the launches; returns both runs' numbers and their
    velocity difference."""
    cfg, level = bench_cfg(size, size)
    os.environ["CUP2D_POIS"] = pois
    try:
        sims = {"sharded": lambda: ShardedUniformSim(
                    cfg, make_mesh(devices=[dev] * MESH_D), level=level),
                "solo": lambda: UniformSim(cfg, level=level, device=dev)}
        out, vel = {}, {}
        for label, make in sims.items():
            sim = make()
            if label == "sharded":
                sim.set_state(bench_state(sim.grid))
            else:
                sim.state = bench_state(sim.grid)
            sim.step_count = 10          # production solves
            dt = 0.5 * sim.grid.h
            sync(dev)
            torch.cuda.reset_peak_memory_stats()
            hk.reset_launches()
            iters = [sim.step_once(dt)["poisson_iters"]]      # warm-up
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                d = sim.step_once(dt)
                iters.append(d["poisson_iters"])
            sync(dev)
            ms = (time.perf_counter() - t0) / steps * 1e3
            out[label] = {
                "mode": sim.poisson_mode, "ms_per_step": ms,
                "iters_per_step": sum(iters[1:]) / steps, "iters": iters,
                "umax": d["umax"], "finite": bool(d["finite"]),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launches": dict(hk.launches)}
            v = sim.state.vel
            vel[label] = gather_x(v) if label == "sharded" else v
            del sim, v
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("CUP2D_POIS", None)
    a, b = vel["sharded"], vel["solo"]
    rel = float((a - b).abs().max() / b.abs().max())
    out["vel_rel_linf"] = rel
    print(f"phase 7 sharded main path {size}^2 D={MESH_D} "
          f"{json.dumps(out)}", flush=True)
    sh, so = out["sharded"], out["solo"]
    nsteps = steps + 1
    check(sh["finite"] and so["finite"], f"{pois}: non-finite state")
    la = sh["launches"]
    check(la["advect_substage_halo"] == 2 * MESH_D * nsteps,
          f"sharded: halo substage launches {la} != 2 D per step")
    check((la["jacobi_halo_sweep"] > 0) == (pois == "fas"),
          f"sharded {pois or 'default'}: halo sweep launches {la}")
    for k in ("fused_advect_heun", "fused_correction",
              "fused_jacobi_sweeps"):
        check(la[k] == 0, f"sharded: a solo kernel launched ({k}: {la})")
    return out


def phase_sharded(dev, size: int = 8192) -> list:
    """Phase 7: the split main path against the solo step under both
    solvers: equal iterations every step and velocity within SHARDED_REL.
    Only the reductions' order differs; the means and the Krylov dots
    accumulate in f64, so their f32 values (and with them the two steps)
    agree unless a sum lands within its rounding error of an f32 rounding
    boundary."""
    runs = [run_sharded(dev, p, size=size) for p in ("", "fas")]
    for r, p in zip(runs, ("default", "fas")):
        check(r["sharded"]["iters"] == r["solo"]["iters"],
              f"sharded {p}: iterations {r['sharded']['iters']} != solo "
              f"{r['solo']['iters']}")
        check(r["vel_rel_linf"] <= SHARDED_REL, f"sharded {p}: vel rel "
              f"{r['vel_rel_linf']} > {SHARDED_REL} from the solo step")
    return runs


def run_main_path(dev, pois: str) -> dict:
    os.environ["CUP2D_POIS"] = pois
    try:
        g = bench_grid(8192, 8192, dev)
    finally:
        os.environ.pop("CUP2D_POIS", None)
    state = bench_state(g)
    dt = torch.tensor(0.5 * g.h, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(hk.launches)
    state, diag = g.step(state, dt, obstacle_terms=False)   # warm-up
    torch.cuda.synchronize()
    iters = []
    t0 = time.perf_counter()
    for _ in range(5):
        state, diag = g.step(state, dt, obstacle_terms=False)
        iters.append(diag["poisson_iters"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    delta = {k: hk.launches[k] - before[k] for k in hk.launches}
    finite = bool(torch.isfinite(state.vel).all()
                  and torch.isfinite(state.pres).all())
    out = {"mode": g.poisson_mode, "ms_per_step": ms,
           "iters_per_step": sum(iters) / len(iters), "iters": iters,
           "umax": float(diag["umax"]), "energy": float(diag["energy"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": delta}
    print(f"phase 3 main path 8192^2 {json.dumps(out)}", flush=True)
    check(finite, f"{g.poisson_mode}: non-finite state")
    steps = 6
    check(delta["fused_advect_heun"] == 2 * steps,
          f"{g.poisson_mode}: substage launches {delta} != 2/step")
    check(delta["fused_correction"] == steps,
          f"{g.poisson_mode}: correction launches {delta} != 1/step")
    if pois == "fas":
        check(delta["fused_jacobi_sweeps"] > 0,
              "fas: the smoother kernel never ran")
    else:
        check(delta["fused_jacobi_sweeps"] == 0,
              "bicgstab: the bf16 preconditioner must not launch the f32 "
              "smoother kernel")
    return out


def phase_trajectory(dev):
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    sims = {}
    for d in (dev, "cpu"):
        s = UniformSim(cfg, level=5, device=d)
        s.state = bench_state(s.grid)
        sims[str(d)] = (s, [s.step_once()["poisson_iters"]
                            for _ in range(5)])
    (sg, ig), (sc, ic) = sims[str(dev)], sims["cpu"]
    a = sg.state.vel.cpu()
    b = sc.state.vel
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"phase 4 trajectory 256^2 x5: card iters {ig} cpu iters {ic} "
          f"vel rel Linf {rel}", flush=True)
    check(bool(torch.isfinite(a).all()), "trajectory: non-finite state")
    check(rel <= TRAJ_REL, f"trajectory: card vs CPU {rel} > {TRAJ_REL}")


def run_forest(sim, label: str) -> dict:
    """10 startup steps, 5 production steps and one adapt() of one forest
    sim, each timed; the forest kernels' counts run from 0."""
    dev = sim.device
    cuda = dev.type == "cuda"
    n_blocks, n_pad = len(sim.forest.blocks), None
    if cuda:
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    times, iters, cycles = [], [], []
    for k in range(15):
        sync(dev)
        t0 = time.perf_counter()
        d = sim.step_once()
        sync(dev)
        times.append(time.perf_counter() - t0)
        iters.append(d["poisson_iters"])
        cycles.append(d["precond_cycles"])
        check(d["finite"], f"forest {label}: non-finite state at step {k}")
        n_pad = sim._npad_hwm
    t0 = time.perf_counter()
    changed = sim.adapt()
    sim._refresh()     # the table rebuild the next step would pay
    sync(dev)
    adapt_s = time.perf_counter() - t0
    launches = {k: hk.launches[k] for k in
                ("fused_lab_rhs", "fused_block_jacobi_update")}
    out = {"mode": sim.poisson_mode, "blocks": n_blocks, "n_pad": n_pad,
           "startup_ms_per_step": sum(times[:10]) / 10 * 1e3,
           "ms_per_step": sum(times[10:]) / 5 * 1e3,
           "startup_iters": iters[:10], "iters": iters[10:],
           "precond_cycles": cycles[10:],
           "adapt_s": adapt_s, "adapt_changed": changed,
           "blocks_after_adapt": len(sim.forest.blocks),
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if cuda else None),
           "launches": launches}
    print(f"phase 5 forest {label} {json.dumps(out)}", flush=True)
    check(launches["fused_lab_rhs"] == 2 * 15,
          f"forest {label}: lab-RHS launches {launches} != 2/step")
    fas_cycles = sum(iters[10:]) if label == "fas" else 0
    check(launches["fused_block_jacobi_update"] == fas_cycles,
          f"forest {label}: block-Jacobi launches {launches} != {fas_cycles}"
          " (one per production FAS cycle)")
    return out


def phase_forest(dev, target=FOREST_TARGET, **kw) -> tuple[list, dict]:
    """Phase 5: the forest main path under both solvers. Returns the runs
    and the forest kernels' launch counts summed over them."""
    os.environ.pop("CUP2D_POIS", None)
    t0 = time.perf_counter()
    sim = vortex_forest(target=target, device=dev, **kw)
    sync(dev)
    build_s = time.perf_counter() - t0
    n = len(sim.forest.blocks)
    levels = sorted({l for l, _, _ in sim.forest.blocks})
    print(f"phase 5 forest built: {n} blocks on levels {levels} in "
          f"{build_s} s", flush=True)
    check(n >= target, f"forest: {n} blocks < {target}")
    cfg, snap = sim.cfg, forest_to_numpy(sim)
    del sim

    def fresh(pois=None):
        if pois:
            os.environ["CUP2D_POIS"] = pois
        try:
            s = AMRSim(cfg, shapes=[], device=dev)
        finally:
            os.environ.pop("CUP2D_POIS", None)
        forest_from_numpy(s, *snap)
        return s

    # the default run twice from the same state: the card must repeat
    # itself bit for bit (iterations, adapted block set, velocity)
    sims = [fresh(), fresh()]
    runs = [run_forest(sims[0], "default")]
    again = run_forest(sims[1], "default (repeat)")
    (ka, va), (kb, vb) = (_ordered_vel(s) for s in sims)
    same = (again["startup_iters"] == runs[0]["startup_iters"]
            and again["iters"] == runs[0]["iters"] and ka == kb
            and bool(torch.equal(va, vb)))
    print(f"phase 5 forest default repeated bit for bit: {same}", flush=True)
    check(same, "forest: two runs of the same state differ on the card")
    del sims
    runs.append(run_forest(fresh("fas"), "fas"))
    total = {k: sum(r["launches"][k] for r in runs)
             for k in runs[0]["launches"]}
    return runs, total


def _ordered_vel(sim) -> tuple[list, np.ndarray]:
    fields = sim.fields()
    order = sim.forest.order()
    f = sim.forest
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in order]
    return keys, fields["vel"][torch.as_tensor(order, dtype=torch.long,
                                               device=sim.device)].cpu()


def phase_forest_cpu(dev, pois=None, **kw):
    """Phase 6: the same small multilevel forest on the card and on the
    CPU under one solver (None: the default), 5 steps with an adapt()
    after the second."""
    if pois:
        os.environ["CUP2D_POIS"] = pois
    try:
        cpu = multilevel_forest(dtype="float32", device="cpu", **kw)
        card = AMRSim(cpu.cfg, shapes=[], device=dev)
    finally:
        os.environ.pop("CUP2D_POIS", None)
    forest_from_numpy(card, *forest_to_numpy(cpu))
    card.step_count = cpu.step_count
    iters = {"card": [], "cpu": []}
    for k in range(5):
        if k == 2:
            a, b = card.adapt(), cpu.adapt()
            check(a == b, f"multilevel: adapt changed card {a} cpu {b}")
            check(set(card.forest.blocks) == set(cpu.forest.blocks),
                  "multilevel: the card and the CPU adapted to different "
                  "block sets (a tag within rounding of rtol)")
        iters["card"].append(card.step_once()["poisson_iters"])
        iters["cpu"].append(cpu.step_once()["poisson_iters"])
    (kc, a), (kp, b) = _ordered_vel(card), _ordered_vel(cpu)
    check(kc == kp, "multilevel: ordered block keys differ")
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"phase 6 multilevel forest {card.poisson_mode} tol "
          f"{card.cfg.poisson_tol}/{card.cfg.poisson_tol_rel} {len(kp)} "
          f"blocks x5 steps: card iters {iters['card']} cpu iters "
          f"{iters['cpu']} vel rel Linf {rel}", flush=True)
    check(bool(torch.isfinite(a).all()), "multilevel: non-finite state")
    check(rel <= TRAJ_REL, f"multilevel: card vs CPU {rel} > {TRAJ_REL}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    logs = hk.build()
    secs = time.perf_counter() - t_start
    card = card_line()
    print(f"phase 1 build {secs} s; card {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    for stem, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1 ptxas {stem}: {line.strip()}", flush=True)

    res = phase_kernels(dev)
    phase_halo_kernels(dev, res)

    uniform = ("fused_advect_heun", "fused_correction",
               "fused_jacobi_sweeps")
    hk.reset_launches()
    runs = [run_main_path(dev, p) for p in ("", "fas")]
    launches = {k: hk.launches[k] for k in uniform}
    for k, n in launches.items():
        check(n > 0, f"{k}: launched no time on the uniform main path")

    phase_trajectory(dev)

    forest_runs, forest_launches = phase_forest(dev)
    for k, n in forest_launches.items():
        check(n > 0, f"{k}: launched no time on the forest main path")
    launches.update(forest_launches)

    phase_forest_cpu(dev, "fas")
    phase_forest_cpu(dev, tol=1e-6, tol_rel=1e-5)

    sharded = phase_sharded(dev)
    for k in ("advect_substage_halo", "jacobi_halo_sweep"):
        launches[k] = sum(r["sharded"]["launches"][k] for r in sharded)
        check(launches[k] > 0, f"{k}: launched no time on the split path")
    # the single-op RHS lies on no path: its launches are phase 2's
    launches["advect_diffuse_rhs"] = res["advect_diffuse_rhs"]["launches"]
    check("jax" not in sys.modules, "the smoke imported jax")

    kernels = [dict(name=k, route="cuda", source=hk.SOURCES[k],
                    replaces=hk.REPLACES[k], launches=launches[k],
                    max_abs_err=res[k]["max_abs_err"], ms=res[k]["ms"],
                    plain_ms=res[k]["plain_ms"], bound_ms=res[k]["bound_ms"],
                    bound_by=res[k]["bound_by"],
                    library_ms=res[k].get("library_ms"),
                    on_main_path=k != "advect_diffuse_rhs")
               for k in hk.launches]
    print(f"main path summary: {json.dumps(runs)}")
    print(f"forest main path summary: {json.dumps(forest_runs)}")
    print(f"sharded main path summary: {json.dumps(sharded)}")
    print(f"total {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
