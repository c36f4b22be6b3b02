#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cup2d_tpu_torch``) on one
NVIDIA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one output line or more each; any failure exits non-zero before
the result lines:

1. build the eight Hopper kernels from ``cup2d_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card and every
   instance's registers and spills;
2. each kernel against its plain PyTorch twin on the card, f32, with the
   bounds stated below (the forest lab RHS per h class, at the path's nu
   and at a diffusion-dominated nu = 1; at 128, 10,529 (the forest main
   path's count) and 16,384 blocks, its bound at the face-sharing
   operation count of its inputs beside the per-cell count), plus kernel
   and twin times (CUDA events) and, for the block-Jacobi update (at 1,
   1000 and 16384 blocks), the time of ``torch.addmm``; the sweep chain at every level of
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
   adds it: its smooth differences cancel to ~1e-4 of an ulp's weight),
   each lab timed by graph replay, with its bound at the face-sharing
   count of its own winds beside the per-cell count.
   The boundary-table forms: the substage pair under the four tables of
   tests/test_megakernel.py (the cavity, the uniform and the parabolic
   channel, parabolic inflow through a y face with outflow opposite) on
   the 8192^2 benchmark velocity and on a ragged member stack, <= 2e-6
   relative to max |ref|, each table's kernel_ms printed beside the
   free-slip kernel's; the correction with the channel's pressure signs
   (<= 5e-6) and the sweep chain with signs (1, -1, 1, 1) at n = 1..3 on
   8192^2 (<= 2e-6 relative). The bf16 forms (``CUP2D_PREC=bf16``): the
   substage pair on the 8192^2 benchmark velocity, free-slip and under the
   cavity table, and on a ragged member stack (the first substage within
   one bf16 ulp of its twin and at least 99% of its values bit-equal, the
   second from the same bf16 inputs <= 2e-6 relative, the pair within the
   2e-2 bf16 band), the halo pair on 4 slabs (assembled, bit for bit the
   solo bf16 pair; per shard as the solo pair), the sweep chain at
   n = 1..3 (Neumann and signed) and every chain of one V-cycle (within
   n bf16 ulps), the bf16 V-cycle's levels timed, and the halo sweep (the
   assembled split sweep bit for bit the bf16 chain's, per shard within
   one bf16 ulp); each with kernel ms, twin ms and its bytes bound beside
   the f32 form's ms. The split step's boundary-table forms at its main
   path's shapes: the halo substage pair under the four tables on 4 slabs
   of the 8192^2 benchmark velocity and of a ragged member stack, f32 and
   bf16 (the assembled slabs bit for bit the solo BC pair, each shard
   against its twin as the solo forms are), and the signed halo sweep with
   the signs (1, 1, 1, 1) and (1, -1, 1, 1) on the finest split level and
   two coarse ones, f32 and bf16 (the assembled sweep bit for bit one
   signed sweep of the chain kernel, each shard against its twin); kernel
   ms, twin ms and bound beside the free-slip or Neumann form's ms. The
   halo sweep's slab list (one launch for every slab of the card) against
   its twin wherever a sweep is checked, and level by level over the
   4-slab split hierarchy of 8192^2 (slabs 2048 .. 8 wide, then the
   gathered 16^2 and 8^2 levels) in its four forms (Neumann and signed,
   f32 and bf16): one sweep as one slab-list launch, as the per-slab
   sequence it replaces (an exchange, then a launch per slab) and as one
   chain-kernel sweep of the whole field (``jacobi.cu``'s cp.async tiles),
   device ms from graph replays, the launches of each, the bytes bound,
   and the slab list bit for bit one sweep of the chain kernel;
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
   itself bit for bit; the lab RHS is timed on the fas run's own labs
   (its last call), with the reconstructions per cell and component the
   face sharing needs there;
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
   step; halo sweeps under fas only, one launch per sweep and level over
   all 4 slabs, with no edge-column exchange for a sweep; no solo
   substage, correction or sweep-chain launch), then the solo
   ``UniformSim`` from the same state:
   equal iterations every step and velocity within 1e-5 relative (only
   the order of the reductions differs, and they accumulate in f64).
8. the wall-bounded main path: the lid-driven cavity of the case catalog
   (``cases.make_sim("cavity")``, Re 100) at 8192^2 f32 (level 10) from
   the benchmark's velocity, and the obstacle-free channel table with a
   parabolic inflow (u_in 0.2) on 8192 x 2048 (bpdx 4, level 8, the JAX
   package's channel configuration without its disk) from the impulsive
   start u = u_in, each under the default solver and under CUP2D_POIS=fas:
   production ``step_once`` steps at the CFL dt, one warm-up and five
   timed, the launch counts set to 0 before each run and read after it
   (2 boundary-table substage launches and 1 signed correction a step,
   signed sweep chains under fas only: every ``+bc`` counter non-zero);
   then the cavity at 256^2 on the card and on the CPU, 5 ``step_once``
   steps from the same start (velocity relative Linf <= 1e-4), and the
   plug flow u = u_in through the uniform channel table on the card, 25
   steps (exact to 1e-6). The Ghia et al. (1982) Re 100 cavity (128^2 f32
   from rest to t = 30, ~23k steps, ~4 minutes on the H100) runs apart:
   ``python -m cup2d_tpu_torch.cases --ghia``.
9. the bf16 main path (``CUP2D_PREC=bf16``): phase 3's 8192^2 step under
   both solvers (every substage launch the bf16 form, and under fas
   every sweep-chain launch), phase 7's split step on 4 slabs of the card
   under both solvers (the bf16 halo forms; bit for bit the solo bf16
   step, equal iterations), the 8192^2 cavity under fas for two timed
   steps (the boundary-table bf16 forms), and 256^2 from the benchmark
   velocity for 5 steps under both solvers on the card against the CPU's
   twins (<= 2e-2 relative) and against the card's f32 run (in
   (0, 2e-2]); launch counts from 0 before each run, every ``+bf16``
   counter non-zero; and the cavity split into 4 slabs under fas for two
   timed steps (the split boundary-table bf16 forms), bit for bit the solo
   bf16 cavity with equal iterations.
10. the wall-bounded boxes on the x-split step: the 8192^2 cavity
   (``cases.make_sim("cavity", level=10, mesh=make_mesh(devices=["cuda:0"]
   * 4))``) from the benchmark velocity under the default solver and
   CUP2D_POIS=fas, and the 8192 x 2048 parabolic channel on 4 slabs under
   fas (the default solver does not converge there at f32): production
   ``step_once`` steps at the CFL dt, one warm-up and three timed, the
   launch counts from 0 (2 boundary-table halo substage launches per shard
   and step, signed halo sweeps under fas only, one launch per sweep and
   level with no exchange for it: every ``+bc`` halo counter non-zero; no
   solo substage, correction or sweep-chain launch), then the
   solo sim from the same state: equal iterations every step and velocity
   within 1e-5 relative.
11. the flagship step (``__graft_entry__.entry()``'s configuration: two
   fish, bpdx 2, bpdy 1, extent 4, nu 4e-5, lambda 1e7, f32) through the
   port's ``sim.Simulation`` at 1024 x 512 (level 6): ``initialize()``, the
   10 exact startup steps and 5 production ``step_once`` steps under the
   default solver and under CUP2D_POIS=fas, each step timed on the host
   clock (its phases' host ms, its iterations, the peak memory), the
   launch counts from 0 over each run (2 substage launches and 1
   correction a step, sweep chains under fas only, no other form); the
   three kernels against their twins on that run's own operands at
   1024 x 512 (<= 2e-6 relative; device ms by graph replay, bound at
   these shapes); ``entry()``'s own call, ``_flow_step_impl`` on the
   Taylor-Green state with the fishes' chi, prescribed zeros and
   dt = 2e-4, a warm-up and 5 calls ("flagship step ms"); the two fish at
   512 x 256 on the card and on the CPU from the card's state after its
   startup steps, 5 production steps each with equal iterations: under
   fas velocity and each fish's (u, v, omega) within 1e-4 relative, under
   the default solver within its 1e-2 relative tolerance (its bf16
   preconditioner cycle carries a one-ulp difference to ~1e-3 of a
   1-iteration solve); and the catalog's channel at 512 x 128 under fas
   for 3 steps (finite, every ``+bc`` counter of the three kernels moving).
12. the canonical shaped forest: run.sh's flags (validation/canonical.py,
   written out here: bpdx 2, bpdy 1, extent 4, levelStart 5, levelMax 8,
   CFL 0.5, lambda 1e7, nu 4e-5, Rtol 2, Ctol 1, AdaptSteps 20, tolerances
   1e-3/1e-2, f32, the two fish) through ``SimConfig.from_argv`` and the
   port's ``AMRSim`` under the default solver and CUP2D_POIS=fas, nothing
   cut: ``initialize()`` (host seconds, blocks, levels, pad bucket; every
   block with chi > 0.2 at level 7), then ``run()``'s schedule (an
   ``adapt()`` before each of steps 0-10) for 10 exact startup and 10
   production steps, each timed on the host clock to a synchronize with
   its phases' host ms (kinematics, megastep, forces) and each adapt's,
   the peak memory, the launch counts from 0 over each run (2 lab-RHS
   launches a step, block-Jacobi updates under fas only, one per
   production cycle; no launch of kernels 2, 3, 5, 6, 7); the two forest
   kernels on the fas run's last operands against their twins (phase 2's
   bars; device ms by graph replay, bounds at these N); the canonical
   case at levelMax 6 on the card and on the CPU from the card's state
   after its startup (``convert.copy_amr_state``), 5 production steps
   with an adapt after the second, equal keys and iterations, velocity
   and each fish's (u, v, omega) within 1e-4 relative, under fas and
   under the default solver at its production tolerances (printed beside
   it, not held: the default solver at 1e-6/1e-5, which does not converge
   on the shaped RHS); and the two-disk collision of
   validation/golden_collision.py at f32 (body 0's u flips from > 0.1 to
   < -0.01 across steps 0 -> 1; the largest difference from
   tests/golden_collision.json printed).

Then one JSON line of per-kernel numbers (with, per kernel, its launches
on the two flagship runs and the two canonical runs and, for the
flagship's and the canonical run's kernels, their numbers at those
shapes), the card's name and power limit
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

from cup2d_tpu_torch import (SimConfig, Simulation, UniformGrid,  # noqa
                             UniformSim)
from cup2d_tpu_torch import bc as tbc  # noqa: E402
from cup2d_tpu_torch import cases  # noqa: E402
from cup2d_tpu_torch import amr as tamr  # noqa: E402
from cup2d_tpu_torch.amr import (AMRSim, multilevel_forest,  # noqa: E402
                                 vortex_forest)
from cup2d_tpu_torch.convert import (copy_amr_state,  # noqa: E402
                                     copy_simulation_state,
                                     forest_from_numpy, forest_to_numpy)
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.timing import (OPS_SWEEP_CELL,  # noqa: E402
                                        advect_rhs_ops, bound,
                                        cuda_ms, graph_ms,
                                        halo_sweep_level_table,
                                        lab_weno_faces,
                                        substage_ops, substage_pair_bytes,
                                        sweep_bytes, sweep_level_table,
                                        vcycle_chains, weno_faces)
from cup2d_tpu_torch.ops.stencil import (inv_diag_bc,  # noqa: E402
                                         inv_diag_bc_slab, pad_vector)
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    Slabs, exchange_x, fused_advect_heun_sharded, gather_x,
    overlap_jacobi_sweeps, split_x, sweep_stats)
from cup2d_tpu_torch.poisson import block_precond_matrix  # noqa: E402
from cup2d_tpu_torch.uniform import (bench_state,  # noqa: E402
                                     taylor_green_state)

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
PLUG_ABS = 1e-6        # plug flow on the card: f32 rounding of an exact
#                        steady state (the JAX package pins 1e-10 at f64)
EDGE_SIGNS = (1.0, -1.0, 1.0, 1.0)   # the channel's pressure signs
# bf16 forms (the CUP2D_PREC=bf16 tier) against their twins: kernel and
# twin each round one f32 value to bf16, the two f32 values a few f32 ulp
# apart (FMA contraction), so a rounding across a bf16 midpoint moves one
# bf16 ulp and nothing moves more; a chain of n sweeps rounds n times
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative to max |ref|
BF16_EQUAL = 0.99      # share of bf16 outputs bit-equal to the twin's
F32_REL = 2e-6         # an f32 output (the second substage) from the same
#                        bf16 inputs, relative to max |ref|
BF16_BAND = 2e-2       # the bf16 pair against its twin, and the bf16 step
#                        against the f32 step: the JAX package's bf16 band
#                        (tests/test_megakernel.py)
BF16_KEYS = ("fused_advect_heun+bf16", "fused_advect_heun+bc+bf16",
             "advect_substage_halo+bf16", "fused_jacobi_sweeps+bf16",
             "fused_jacobi_sweeps+bc+bf16", "jacobi_halo_sweep+bf16",
             "advect_substage_halo+bc+bf16", "jacobi_halo_sweep+bc+bf16")

# the four tables of tests/test_megakernel.py
BC_TABLES = {
    "cavity": cases.cavity_table(1.0),
    "channel_uniform": cases.channel_table(1.0),
    "channel_parabolic": cases.channel_table(1.0, profile="parabolic"),
    "outflow_y": tbc.BCTable(tbc.no_slip(), tbc.no_slip(),
                             tbc.dirichlet_inflow(0.0, 1.0,
                                                  profile="parabolic"),
                             tbc.convective_outflow()),
}

# the previous designs of the redesigned kernels, at the shapes of their
# JSON entries (n = 2 on 8192^2; [16384, 8, 8] and [16384, 2, 14, 14] in
# graph replay; both substages on [1, 2, 8192, 8192], and on 4 slabs of
# it; one halo sweep on 4 slabs of 8192^2, a launch per slab, its four
# forms):
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W before each redesign
# (PERF.md section 6); cup2d_tpu_torch.kernel_ab times each pair in one run
EARLIER_MS = {"fused_jacobi_sweeps": 0.681,
              "fused_block_jacobi_update": 0.0191,
              "fused_advect_heun": 3.973,
              "advect_substage_halo": 4.320,
              "jacobi_halo_sweep": 0.403,
              "jacobi_halo_sweep+bf16": 0.359,
              "jacobi_halo_sweep+bc": 0.410,
              "jacobi_halo_sweep+bc+bf16": 0.366,
              "fused_lab_rhs": 0.0457,
              "advect_diffuse_rhs": 1.940}

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
# forest lab RHS and single-op RHS: the substage cell less its 3-op
# update, per component, in the per-cell design (the bounds count the
# face-sharing design's operations on their inputs instead,
# ops.timing.advect_rhs_ops; this count is printed beside them)
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


_BENCH_VEL: dict = {}


def bench_start(grid):
    """``bench_state(grid)``: its velocity is computed once per grid
    geometry (numpy takes seconds at 8192^2) and kept on the host, so the
    device's peak memory does not see it; each call copies it to the
    grid's device."""
    key = (grid.ny, grid.nx, tuple(grid.cfg.extents), grid.dtype)
    if key not in _BENCH_VEL:
        _BENCH_VEL[key] = bench_state(grid).vel.cpu()
    return grid.zero_state()._replace(
        vel=_BENCH_VEL[key].to(grid.device, copy=True))


class latched:
    """The solver and storage latches (CUP2D_POIS, CUP2D_PREC) set while
    the block builds grids and sims, unset after it."""

    def __init__(self, pois: str, prec: str = "f32"):
        self.env = {"CUP2D_POIS": pois, "CUP2D_PREC": prec}

    def __enter__(self):
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k in self.env:
            os.environ.pop(k, None)


def bf16_close(label: str, got, ref, ulps: int = 1) -> float:
    """Hold a bf16 output to its twin's: within ``ulps`` bf16 ulps of
    max |ref| and at least BF16_EQUAL of the values bit-equal. Returns the
    largest absolute difference."""
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    rel = err / float(ref.float().abs().max())
    share = float((got == ref).float().mean())
    print(f"phase 2 {label}: max_abs_err {err} (rel {rel}, bf16 ulps "
          f"{rel / BF16_ULP}; bit-equal {share})", flush=True)
    check(rel <= ulps * BF16_ULP and share >= BF16_EQUAL,
          f"{label}: rel {rel} > {ulps} bf16 ulp or bit-equal share {share}"
          f" < {BF16_EQUAL}")
    return err


def rel_close(label: str, got, ref, bar: float) -> float:
    """Hold an output to its twin's relative to max |ref|; returns the
    largest absolute difference."""
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"phase 2 {label}: max_abs_err {err} (rel {rel})", flush=True)
    check(rel <= bar, f"{label}: rel {rel} > {bar}")
    return err


def slab_list_close(key: str, es, rs, signs) -> float:
    """The slab-list halo sweep (one launch for every slab) against its
    twin, from e and from zero: f32 within JACOBI_REL of max |ref|, bf16
    within one bf16 ulp. Returns the largest absolute difference."""
    err = 0.0
    for fz in (False, True):
        got = torch.cat(hk.jacobi_halo_sweep_slabs(es.parts, rs.parts, 0.8,
                                                   fz, signs), dim=-1)
        ref = torch.cat(hk.jacobi_halo_sweep_slabs_plain(
            es.parts, rs.parts, 0.8, fz, signs), dim=-1)
        label = (f"{key} slab list {list(got.shape)} on {len(es.parts)} "
                 f"slabs from_zero={fz}")
        err = max(err, bf16_close(label, got, ref)
                  if got.dtype == torch.bfloat16
                  else rel_close(label, got, ref, JACOBI_REL))
    return err


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
        v = (bench_start(g).vel[None] * amp[:, None, None, None]
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
    res["fused_jacobi_sweeps"]["cycle_ms"] = sum(
        r["ms"] for r in phase_sweep_levels(dev))

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
    for n in (128, 10529, 16384):
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
        b = bound(BYTES_LAB_RHS_BLOCK * n, advect_rhs_ops(lab))
        b_old = bound(BYTES_LAB_RHS_BLOCK * n, OPS_LAB_RHS_CELL * 64 * n)
        earlier = (f" (earlier design {EARLIER_MS['fused_lab_rhs']})"
                   if n == 16384 else "")
        print(f"phase 2 fused_lab_rhs [{n},2,14,14]: kernel_ms {ms}{earlier} "
              f"(eager per call {eager}) twin_ms {pms} bound_ms {b[0]} "
              f"({b[1]}; face-sharing count) bound_ms at 365 operations a "
              f"cell and component {b_old[0]} ({b_old[1]})", flush=True)
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


def phase_bc_kernels(dev, res, size: int = 8192) -> None:
    """Phase 2, continued: the boundary-table forms of the substage pair,
    the correction and the sweep chain against their twins (the bounds of
    their free-slip forms), with kernel and twin times at 8192^2. Fills
    ``res`` for the three ``+bc`` entries."""
    g = bench_grid(size, size, dev)
    cells = g.ny * g.nx
    base = res["fused_advect_heun"]["ms"]
    v = bench_start(g).vel[None].contiguous()
    dt = torch.tensor([0.5], device=dev) * g.h
    err = 0.0
    for name, table in BC_TABLES.items():
        got = hk.fused_advect_heun(v, g.h, 4e-5, dt, bc=table)
        ref = hk.fused_advect_heun_plain(v, g.h, 4e-5, dt, bc=table)
        e = float((got - ref).abs().max())
        rel = e / float(ref.abs().max())
        del got, ref
        check(rel <= HEUN_ABS, f"fused_advect_heun+bc {name} {size}^2: rel "
              f"{rel} > {HEUN_ABS}")
        err = max(err, e)
        ms = cuda_ms(lambda: hk.fused_advect_heun(v, g.h, 4e-5, dt,
                                                  bc=table), 10)
        print(f"phase 2 fused_advect_heun+bc {name} [1,2,{size},{size}] both"
              f" substages: max_abs_err {e} (rel {rel}) kernel_ms {ms} "
              f"(free-slip kernel {base})", flush=True)
        if name == "cavity":
            pms = cuda_ms(lambda: hk.fused_advect_heun_plain(
                v, g.h, 4e-5, dt, bc=table), 2)
            facs = hk._substage_facs(dt, g.h, 4e-5, (1,), 1, torch.float32,
                                     dev, with_dt=True)
            v1 = hk.advect_substage(v, None, facs, 0.5, 1.0 / g.h ** 2,
                                    table, g.h)
            b = bound(40.0 * cells, substage_ops(v) + substage_ops(v1))
            del v1
            res["fused_advect_heun+bc"].update(
                ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                library_ms=None)
            print(f"phase 2 fused_advect_heun+bc cavity twin_ms {pms} "
                  f"bound_ms {b[0]} ({b[1]})", flush=True)
    del v
    torch.cuda.empty_cache()
    # a ragged member stack with per-member dt (4-byte rows, tiles across
    # both a y and an x wall)
    gen = torch.Generator(device=dev).manual_seed(3)
    vr = torch.randn(2, 2, 1000, 1501, generator=gen, device=dev)
    hr = 1.0 / 1501
    dtr = torch.tensor([0.5, 0.3], device=dev) * hr
    for name, table in BC_TABLES.items():
        got = hk.fused_advect_heun(vr, hr, 4e-5, dtr, bc=table)
        ref = hk.fused_advect_heun_plain(vr, hr, 4e-5, dtr, bc=table)
        e = float((got - ref).abs().max())
        rel = e / float(ref.abs().max())
        check(rel <= HEUN_ABS, f"fused_advect_heun+bc {name} "
              f"{list(vr.shape)}: rel {rel} > {HEUN_ABS}")
        err = max(err, e)
        print(f"phase 2 fused_advect_heun+bc {name} {list(vr.shape)}: "
              f"max_abs_err {e} (rel {rel})", flush=True)
    res["fused_advect_heun+bc"]["max_abs_err"] = err
    del vr, got, ref

    gen = torch.Generator(device=dev).manual_seed(4)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # K5 with the channel's signs; its means are 0 (an outflow table keeps
    # the pressure level)
    h = 1.0 / size
    x, p, v = rn(1, size, size), rn(1, size, size), rn(1, 2, size, size)
    scal = torch.tensor([[0.0, 0.0, -0.25 * h * h]], device=dev)
    got = hk.fused_correction(x, p, v, scal, 1.0 / (h * h),
                              grad_signs=EDGE_SIGNS)
    ref = hk.fused_correction_plain(x, p, v, scal, 1.0 / (h * h),
                                    grad_signs=EDGE_SIGNS)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    del got, ref
    check(err <= CORRECTION_ABS, f"fused_correction+bc: {err} > "
          f"{CORRECTION_ABS}")
    ms = cuda_ms(lambda: hk.fused_correction(
        x, p, v, scal, 1.0 / (h * h), grad_signs=EDGE_SIGNS), 10)
    pms = cuda_ms(lambda: hk.fused_correction_plain(
        x, p, v, scal, 1.0 / (h * h), grad_signs=EDGE_SIGNS), 3)
    b = bound(28.0 * cells, OPS_CORRECTION_CELL * cells)
    res["fused_correction+bc"].update(max_abs_err=err, ms=ms, plain_ms=pms,
                                      bound_ms=b[0], bound_by=b[1],
                                      library_ms=None)
    print(f"phase 2 fused_correction+bc {list(EDGE_SIGNS)} [1,{size},{size}]"
          f": max_abs_err {err} kernel_ms {ms} (free-slip kernel "
          f"{res['fused_correction']['ms']}) twin_ms {pms}", flush=True)
    del x, p, v

    # K6 with signs, n = 1..3 from e and from zero
    e, r = rn(size, size), rn(size, size)
    err = 0.0
    for n in (1, 2, 3):
        for fz in (False, True):
            got = hk.fused_jacobi_sweeps(e, r, 0.8, n, fz,
                                         edge_signs=EDGE_SIGNS)
            ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, fz,
                                         edge_signs=EDGE_SIGNS)
            d = float((got - ref).abs().max())
            rel = d / float(ref.abs().max())
            del got, ref
            check(rel <= JACOBI_REL, f"fused_jacobi_sweeps+bc n={n} "
                  f"from_zero={fz}: rel {rel} > {JACOBI_REL}")
            err = max(err, d)
            ms = cuda_ms(lambda: hk.fused_jacobi_sweeps(
                e, r, 0.8, n, fz, edge_signs=EDGE_SIGNS), 10)
            print(f"phase 2 fused_jacobi_sweeps+bc {list(EDGE_SIGNS)} "
                  f"[{size},{size}] n={n} from_zero={fz}: max_abs_err {d} "
                  f"(rel {rel}) kernel_ms {ms}", flush=True)
            if n == 2 and not fz:
                pms = cuda_ms(lambda: hk.jacobi_sweeps_plain(
                    e, r, 0.8, n, fz, edge_signs=EDGE_SIGNS), 2)
                b = bound(12.0 * cells, OPS_SWEEP_CELL * n * cells)
                res["fused_jacobi_sweeps+bc"].update(
                    ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                    library_ms=None)
                print(f"phase 2 fused_jacobi_sweeps+bc n=2: kernel_ms {ms} "
                      f"(free-slip kernel "
                      f"{res['fused_jacobi_sweeps']['ms']}) twin_ms {pms}",
                      flush=True)
    res["fused_jacobi_sweeps+bc"]["max_abs_err"] = err
    del e, r
    # the twin's memoized 8192^2 signed diagonal would count in phase 3's
    # peak memory
    inv_diag_bc.cache_clear()
    torch.cuda.empty_cache()


def phase_sweep_levels(dev, size: int = 8192,
                       dtype=torch.float32) -> list:
    """Phase 2, continued: the sweep chain at each level of the 8192^2
    V-cycle hierarchy with the chains one cycle launches there (n = 2 from
    zero and n = 2 from the corrected e down to 16^2, 24 from zero on
    8^2), on ``dtype`` legs, device time from graph replays; per level its
    ms, bound and launches per cycle, then the sums over one cycle."""
    rows = sweep_level_table(hk.fused_jacobi_sweeps, dev, size=size,
                             dtype=dtype)
    tag = "" if dtype == torch.float32 else " bf16"
    for row in rows:
        chains = ", ".join(
            f"n={c['n']}{' from zero' if c['from_zero'] else ''} "
            f"{c['ms']} ms" for c in row["chains"])
        print(f"phase 2 sweep level{tag} {row['level']}^2: kernel_ms "
              f"{row['ms']} bound_ms {row['bound_ms']} launches/cycle "
              f"{row['launches']} ({chains})", flush=True)
    print(f"phase 2 sweep levels{tag} per V-cycle: kernel_ms "
          f"{sum(r['ms'] for r in rows)} bound_ms "
          f"{sum(r['bound_ms'] for r in rows)} launches "
          f"{sum(r['launches'] for r in rows)}", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_bf16_kernels(dev, res, size: int = 8192) -> None:
    """Phase 2, continued: the four bf16 forms against their twins at the
    main paths' shapes, with kernel and twin ms and the bytes bound beside
    the f32 form's ms from this call. Fills ``res`` for BF16_KEYS.

    Substages: the first (bf16 in and out) to one bf16 ulp, the second
    from the same bf16 inputs (f32 out) to F32_REL, the whole pair (its f32
    state through the bf16 copy) to BF16_BAND; on the 8192^2 benchmark
    velocity (free-slip and the cavity table) and on a ragged member stack
    (2-byte loads). The kernel ms is the two launches on the bf16 copy; the
    pair's bound counts their bytes (24 a cell) against the face-sharing
    operation count. The halo pair on MESH_D slabs: the assembled split
    pair equal to the solo bf16 pair bit for bit, each shard's substages
    against their twins. Sweep chains: n = 1..3 (Neumann and the channel's
    signs) on 8192^2 and every chain of one V-cycle, within n bf16 ulps;
    the V-cycle's levels timed. The halo sweep: the assembled split sweep
    equal to the bf16 chain's, each shard within one bf16 ulp."""
    g = bench_grid(size, size, dev)
    cells = g.ny * g.nx
    ih2 = 1.0 / (g.h * g.h)
    v = bench_start(g).vel[None].contiguous()
    vb = v.to(torch.bfloat16)
    dt = torch.tensor([0.5], device=dev) * g.h
    bf = torch.bfloat16
    f32 = torch.float32

    # K2: free-slip and the cavity table
    for key, table in (("fused_advect_heun+bf16", None),
                       ("fused_advect_heun+bc+bf16", BC_TABLES["cavity"])):
        facs = hk._substage_facs(dt, g.h, 4e-5, (1,), 1, f32, dev,
                                 with_dt=table is not None)
        s1 = hk.advect_substage(vb, None, facs, 0.5, ih2, table, g.h)
        e1 = bf16_close(f"{key} substage 1 {list(v.shape)}", s1,
                        hk.advect_substage_plain(vb, None, facs, 0.5, ih2,
                                                 table, g.h))
        e2 = rel_close(f"{key} substage 2 {list(v.shape)}",
                       hk.advect_substage(s1, vb, facs, 1.0, ih2, table,
                                          g.h, f32),
                       hk.advect_substage_plain(s1, vb, facs, 1.0, ih2,
                                                table, g.h, f32), F32_REL)
        pair = hk.fused_advect_heun(v, g.h, 4e-5, dt, bc=table, bf16=True)
        rel_close(f"{key} pair vs twin", pair, hk.fused_advect_heun_plain(
            v, g.h, 4e-5, dt, bc=table, bf16=True), BF16_BAND)
        full = hk.fused_advect_heun(v, g.h, 4e-5, dt, bc=table)
        moved = float((pair - full).abs().max() / full.abs().max())
        del pair, full

        def launches2():
            hk.advect_substage(hk.advect_substage(vb, None, facs, 0.5, ih2,
                                                  table, g.h),
                               vb, facs, 1.0, ih2, table, g.h, f32)
        ms = cuda_ms(launches2, 10)
        whole = cuda_ms(lambda: hk.fused_advect_heun(
            v, g.h, 4e-5, dt, bc=table, bf16=True), 10)
        pms = cuda_ms(lambda: hk.fused_advect_heun_plain(
            v, g.h, 4e-5, dt, bc=table, bf16=True), 1)
        b = bound(substage_pair_bytes(cells, True),
                  substage_ops(vb.float()) + substage_ops(s1.float()))
        bb = bound(substage_pair_bytes(cells, True), 0.0)[0]
        del s1
        base = res["fused_advect_heun" if table is None
                   else "fused_advect_heun+bc"]["ms"]
        res[key].update(max_abs_err=max(e1, e2), ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], library_ms=None)
        print(f"phase 2 {key} [1,2,{size},{size}] both substages: kernel_ms "
              f"{ms} (with the f32->bf16 cast {whole}; f32 form {base}) "
              f"twin_ms {pms} bound_ms {b[0]} ({b[1]}; bytes alone {bb}); "
              f"the bf16 pair moves the state {moved} relative from the "
              "f32 pair", flush=True)
        torch.cuda.empty_cache()
    # a ragged member stack: 2-byte loads, tiles across both walls
    gen = torch.Generator(device=dev).manual_seed(5)
    vr = torch.randn(2, 2, 1000, 1501, generator=gen, device=dev)
    hr = 1.0 / 1501
    dtr = torch.tensor([0.5, 0.3], device=dev) * hr
    vrb = vr.to(bf)
    for key, table in (("fused_advect_heun+bf16", None),
                       ("fused_advect_heun+bc+bf16", BC_TABLES["cavity"])):
        facs = hk._substage_facs(dtr, hr, 4e-5, (2,), 2, f32, dev,
                                 with_dt=table is not None)
        s1 = hk.advect_substage(vrb, None, facs, 0.5, 1 / hr ** 2, table, hr)
        e1 = bf16_close(f"{key} substage 1 {list(vr.shape)}", s1,
                        hk.advect_substage_plain(vrb, None, facs, 0.5,
                                                 1 / hr ** 2, table, hr))
        e2 = rel_close(f"{key} substage 2 {list(vr.shape)}",
                       hk.advect_substage(s1, vrb, facs, 1.0, 1 / hr ** 2,
                                          table, hr, f32),
                       hk.advect_substage_plain(s1, vrb, facs, 1.0,
                                                1 / hr ** 2, table, hr, f32),
                       F32_REL)
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], e1, e2)
    del vr, vrb, s1

    # K3 on MESH_D slabs of the benchmark velocity
    key = "advect_substage_halo+bf16"
    mesh = make_mesh(devices=[dev] * MESH_D)
    walls = [(d == 0, d == MESH_D - 1) for d in range(MESH_D)]
    solo = hk.fused_advect_heun(v, g.h, 4e-5, dt, bf16=True)
    split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), g.h, 4e-5,
                                               dt, bf16=True))
    u3 = ulps(split, solo)
    del split, solo
    print(f"phase 2 {key} {size}^2 on {MESH_D} slabs vs the solo bf16 pair:"
          f" max {u3} ulp", flush=True)
    check(u3 == 0, f"{key}: the split bf16 pair is {u3} ulp from the solo")
    facs = hk._substage_facs(dt, g.h, 4e-5, (1,), 1, f32, dev)
    s0 = split_x(vb, mesh)
    aux0 = exchange_x(s0, 3)
    s1 = Slabs([hk.advect_substage_halo(p, None, aux0[d], facs, 0.5, ih2,
                                        *walls[d])
                for d, p in enumerate(s0.parts)], mesh)
    aux1 = exchange_x(s1, 3)
    err = 0.0
    for d in range(MESH_D):
        a1 = (s0.parts[d], None, aux0[d], facs, 0.5, ih2, *walls[d])
        a2 = (s1.parts[d], s0.parts[d], aux1[d], facs, 1.0, ih2, *walls[d],
              f32)
        err = max(err, bf16_close(
            f"{key} shard {d} substage 1", hk.advect_substage_halo(*a1),
            hk.advect_substage_halo_plain(*a1)))
        err = max(err, rel_close(
            f"{key} shard {d} substage 2", hk.advect_substage_halo(*a2),
            hk.advect_substage_halo_plain(*a2), F32_REL))

    def k3(sub):
        for d in range(MESH_D):
            sub(s0.parts[d], None, aux0[d], facs, 0.5, ih2, *walls[d])
        for d in range(MESH_D):
            sub(s1.parts[d], s0.parts[d], aux1[d], facs, 1.0, ih2, *walls[d],
                f32)

    ms = cuda_ms(lambda: k3(hk.advect_substage_halo), 10)
    pms = cuda_ms(lambda: k3(hk.advect_substage_halo_plain), 1)
    aux_bytes = 2 * sum(a.numel() for a in aux0) * 2
    b = bound(substage_pair_bytes(cells, True) + aux_bytes,
              sum(substage_ops(p.float()) for p in s0.parts + s1.parts))
    res[key].update(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                    bound_by=b[1], library_ms=None)
    print(f"phase 2 {key} [1,2,{size},{size // MESH_D}] x{MESH_D}, both "
          f"substages: kernel_ms {ms} (f32 form "
          f"{res['advect_substage_halo']['ms']}) twin_ms {pms} bound_ms "
          f"{b[0]} ({b[1]}; bytes alone "
          f"{bound(substage_pair_bytes(cells, True) + aux_bytes, 0)[0]})",
          flush=True)
    del v, vb, s0, s1, aux0, aux1
    torch.cuda.empty_cache()

    # K6: n = 1..3 on 8192^2, Neumann and signed, from e and from zero
    gen = torch.Generator(device=dev).manual_seed(6)
    e = torch.randn(size, size, generator=gen, device=dev).to(bf)
    r = torch.randn(size, size, generator=gen, device=dev).to(bf)
    for key, signs in (("fused_jacobi_sweeps+bf16", None),
                       ("fused_jacobi_sweeps+bc+bf16", EDGE_SIGNS)):
        err = 0.0
        for n in (1, 2, 3):
            for fz in (False, True):
                err = max(err, bf16_close(
                    f"{key} [{size},{size}] n={n} from_zero={fz}",
                    hk.fused_jacobi_sweeps(e, r, 0.8, n, fz, signs),
                    hk.jacobi_sweeps_bf16_plain(e, r, 0.8, n, fz, signs),
                    ulps=n))
        ms = cuda_ms(lambda: hk.fused_jacobi_sweeps(e, r, 0.8, 2, False,
                                                    signs), 10)
        pms = cuda_ms(lambda: hk.jacobi_sweeps_bf16_plain(e, r, 0.8, 2,
                                                          False, signs), 2)
        b = bound(sweep_bytes(cells, False, 2), OPS_SWEEP_CELL * 2 * cells)
        base = res["fused_jacobi_sweeps" if signs is None
                   else "fused_jacobi_sweeps+bc"]["ms"]
        res[key].update(max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], library_ms=None)
        print(f"phase 2 {key} [{size},{size}] n=2: kernel_ms {ms} (f32 form "
              f"{base}) twin_ms {pms} bound_ms {b[0]} ({b[1]})", flush=True)
    # every chain of one V-cycle (the 24-sweep coarsest one included)
    gen = torch.Generator(device=dev).manual_seed(7)
    for n_cells, chains in vcycle_chains(size):
        ev = torch.randn(n_cells, n_cells, generator=gen, device=dev).to(bf)
        rv = torch.randn(n_cells, n_cells, generator=gen, device=dev).to(bf)
        for n, fz in chains:
            got = hk.fused_jacobi_sweeps(ev, rv, 0.8, n, fz)
            ref = hk.jacobi_sweeps_bf16_plain(ev, rv, 0.8, n, fz)
            rel = float((got.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            check(rel <= n * BF16_ULP, f"fused_jacobi_sweeps+bf16 V-cycle "
                  f"level {n_cells}^2 n={n}: rel {rel}")
        del ev, rv, got, ref
    print("phase 2 fused_jacobi_sweeps+bf16: every chain of the 8192^2 "
          "V-cycle within n bf16 ulps of its twin", flush=True)
    bf_cycle = sum(row["ms"] for row in phase_sweep_levels(dev, size, bf))
    print(f"phase 2 sweep levels per V-cycle: bf16 legs {bf_cycle} ms, f32 "
          f"legs {res['fused_jacobi_sweeps']['cycle_ms']} ms", flush=True)

    # K7 on MESH_D slabs
    key = "jacobi_halo_sweep+bf16"
    es, rs = split_x(e, mesh), split_x(r, mesh)
    for fz in (False, True):
        split = gather_x(overlap_jacobi_sweeps(es, rs, 0.8, 1, fz))
        same = bool(torch.equal(split, hk.fused_jacobi_sweeps(e, r, 0.8, 1,
                                                              fz)))
        print(f"phase 2 {key} {size}^2 on {MESH_D} slabs from_zero={fz} vs "
              f"fused_jacobi_sweeps+bf16 (n=1): bit for bit {same}",
              flush=True)
        check(same, f"{key}: the split bf16 sweep differs from the chain's")
    aux = exchange_x(es, 1)
    err = 0.0
    for d in range(MESH_D):
        a = (es.parts[d], rs.parts[d], aux[d], 0.8, *walls[d])
        err = max(err, bf16_close(f"{key} shard {d}",
                                  hk.jacobi_halo_sweep(*a),
                                  hk.jacobi_halo_sweep_bf16_plain(*a)))

    err = max(err, slab_list_close(key, es, rs, None))
    res[key]["max_abs_err"] = err
    del e, r, es, rs, aux
    torch.cuda.empty_cache()


def phase_halo_kernels(dev, res, size: int = 8192) -> None:
    """Phase 2, continued: the x-split step's halo kernels on the 8192^2
    benchmark velocity and on seeded normal fields split into MESH_D slabs
    of one card, and the single-op RHS on a normal lab and on the
    benchmark's padded lab. Fills ``res`` for the three kernels."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    walls = [(d == 0, d == MESH_D - 1) for d in range(MESH_D)]
    g = bench_grid(size, size, dev)
    cells = g.ny * g.nx
    v = bench_start(g).vel[None].contiguous()
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
    # velocity (x ih2), the substage's own absolute bar. Device times from
    # graph replays of each lab, its bound at the face-sharing count of
    # its own winds beside the per-cell count
    before = hk.launches["advect_diffuse_rhs"]
    gen = torch.Generator(device=dev).manual_seed(2)
    labs = {"normal": torch.randn(2, g.ny + 6, g.nx + 6, generator=gen,
                                  device=dev),
            "benchmark": pad_vector(v, 3)[0].contiguous()}
    del v
    err = 0.0
    for name, lab in labs.items():
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
    launches = hk.launches["advect_diffuse_rhs"] - before
    nbytes = 4.0 * labs["benchmark"].numel() + 8.0 * cells
    b_old = bound(nbytes, OPS_LAB_RHS_CELL * cells)
    for name, lab in labs.items():
        ms = graph_ms([lambda: hk.advect_diffuse_rhs(lab, g.h, 4e-5,
                                                     0.5 * g.h)], reps=8)
        b = bound(nbytes, advect_rhs_ops(lab))
        faces = weno_faces(lab[:, 3:-3, 3:-3]) / cells
        print(f"phase 2 advect_diffuse_rhs {name} lab {list(lab.shape)}: "
              f"kernel_ms {ms} (earlier design, eager, benchmark lab "
              f"{EARLIER_MS['advect_diffuse_rhs']}) bound_ms {b[0]} ({b[1]}"
              f"; {faces} reconstructions per cell and component) bound_ms "
              f"at 365 operations a cell and component {b_old[0]} "
              f"({b_old[1]})", flush=True)
        if name == "benchmark":
            res["advect_diffuse_rhs"].update(ms=ms, bound_ms=b[0],
                                             bound_by=b[1])
    lab = labs["benchmark"]
    pms = cuda_ms(lambda: hk.advect_diffuse_rhs_plain(lab, g.h, 4e-5,
                                                      0.5 * g.h), 1)
    res["advect_diffuse_rhs"].update(max_abs_err=err, plain_ms=pms,
                                     library_ms=None, launches=launches)
    print(f"phase 2 advect_diffuse_rhs {list(lab.shape)}: twin_ms {pms}",
          flush=True)
    del labs, lab
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
        err = max(err, slab_list_close("jacobi_halo_sweep", es, rs, None))
        del e, r, es, rs, aux
    res["jacobi_halo_sweep"]["max_abs_err"] = err
    torch.cuda.empty_cache()


def phase_split_bc_kernels(dev, res, size: int = 8192) -> None:
    """Phase 2, continued: the boundary-table forms of the x-split step's
    halo kernels at its main path's shapes (8192^2 on MESH_D slabs of one
    card). The halo substage pair under the four tables on the benchmark
    velocity and on a ragged member stack (per-member dt, slabs of 375
    columns): the assembled slabs against the solo BC pair (<= 1 ulp, bit
    for bit expected), each shard against its twin (<= 2e-6 relative);
    the bf16 form likewise (assembled bit for bit the solo bf16 BC pair,
    per shard within one bf16 ulp). The signed halo sweep with the
    tables' two sign patterns, f32 and bf16, on the finest split level and
    two coarse ones: the assembled sweep against one signed sweep of the
    chain kernel (bit for bit), each shard against its twin. Kernel ms,
    twin ms and bound beside the free-slip or Neumann form's ms. Fills
    ``res`` for the four ``+bc`` halo entries."""
    f32, bf = torch.float32, torch.bfloat16
    mesh = make_mesh(devices=[dev] * MESH_D)
    walls = [(d == 0, d == MESH_D - 1) for d in range(MESH_D)]
    g = bench_grid(size, size, dev)
    cells = g.ny * g.nx
    v = bench_start(g).vel[None].contiguous()
    dt = torch.tensor([0.5], device=dev) * g.h
    ih2 = 1.0 / (g.h * g.h)

    def shard_args(vel, h, dts, table, storage, w):
        """Per shard, both substages' arguments on the split step's own
        operands (substage 1 run by the kernel)."""
        L = vel.shape[0]
        facs = hk._substage_facs(dts, h, 4e-5, (L,), L, f32, dev,
                                 with_dt=True)
        s0 = split_x(vel.to(storage), mesh)
        aux0 = exchange_x(s0, 3)
        kw = [dict(bc=table, h=h, col0=d * w, nx_tot=w * MESH_D)
              for d in range(MESH_D)]
        s1 = Slabs([hk.advect_substage_halo(p, None, aux0[d], facs, 0.5,
                                            1 / h ** 2, *walls[d], **kw[d])
                    for d, p in enumerate(s0.parts)], mesh)
        aux1 = exchange_x(s1, 3)
        out2 = None if storage == f32 else f32
        return [((s0.parts[d], None, aux0[d], facs, 0.5, 1 / h ** 2,
                  *walls[d]), kw[d],
                 (s1.parts[d], s0.parts[d], aux1[d], facs, 1.0, 1 / h ** 2,
                  *walls[d], out2), kw[d]) for d in range(MESH_D)], aux0

    for storage in (f32, bf):
        key = ("advect_substage_halo+bc" if storage == f32
               else "advect_substage_halo+bc+bf16")
        base = res["advect_substage_halo" if storage == f32
                   else "advect_substage_halo+bf16"]["ms"]
        bf16 = storage == bf
        err = 0.0
        for name, table in BC_TABLES.items():
            solo = hk.fused_advect_heun(v, g.h, 4e-5, dt, bc=table,
                                        bf16=bf16)
            split = gather_x(fused_advect_heun_sharded(
                split_x(v, mesh), g.h, 4e-5, dt, bc=table, bf16=bf16))
            u3 = ulps(split, solo)
            del split, solo
            check(u3 <= (0 if bf16 else SPLIT_ULPS), f"{key} {name}: the "
                  f"split pair is {u3} ulp from the solo BC pair")
            args, aux0 = shard_args(v, g.h, dt, table, storage,
                                    size // MESH_D)
            for d, (a1, k1, a2, k2) in enumerate(args):
                s1 = hk.advect_substage_halo(*a1, **k1)
                r1 = hk.advect_substage_halo_plain(*a1, **k1)
                if bf16:
                    e1 = bf16_close(f"{key} {name} shard {d} substage 1",
                                    s1, r1)
                else:
                    e1 = rel_close(f"{key} {name} shard {d} substage 1", s1,
                                   r1, HEUN_ABS)
                e2 = rel_close(f"{key} {name} shard {d} substage 2",
                               hk.advect_substage_halo(*a2, **k2),
                               hk.advect_substage_halo_plain(*a2, **k2),
                               F32_REL if bf16 else HEUN_ABS)
                err = max(err, e1, e2)
                del s1, r1

            def k3(sub):
                for a1, k1, _, _ in args:
                    sub(*a1, **k1)
                for _, _, a2, k2 in args:
                    sub(*a2, **k2)
            ms = cuda_ms(lambda: k3(hk.advect_substage_halo), 10)
            print(f"phase 2 {key} {name} [1,2,{size},{size // MESH_D}] "
                  f"x{MESH_D}, both substages: split vs solo BC pair {u3} "
                  f"ulp; kernel_ms {ms} (free-slip form {base})",
                  flush=True)
            if name == "cavity":
                pms = cuda_ms(lambda: k3(hk.advect_substage_halo_plain), 1)
                item = 2 if bf16 else 4
                aux_bytes = 2 * sum(a.numel() for a in aux0) * item
                b = bound(substage_pair_bytes(cells, bf16) + aux_bytes,
                          sum(substage_ops(a[0].float())
                              for a1, _, a2, _ in args for a in (a1, a2)))
                res[key].update(ms=ms, plain_ms=pms, bound_ms=b[0],
                                bound_by=b[1], library_ms=None)
                print(f"phase 2 {key} cavity twin_ms {pms} bound_ms {b[0]}"
                      f" ({b[1]})", flush=True)
            del args, aux0
            torch.cuda.empty_cache()
        # a ragged member stack: 4-byte (2-byte) copies, ragged tiles across
        # the y walls and every slab edge, per-member dt
        gen = torch.Generator(device=dev).manual_seed(9)
        vr = torch.randn(2, 2, 1000, 1500, generator=gen, device=dev)
        hr = 1.0 / 1500
        dtr = torch.tensor([0.5, 0.3], device=dev) * hr
        for name, table in BC_TABLES.items():
            u3 = ulps(gather_x(fused_advect_heun_sharded(
                split_x(vr, mesh), hr, 4e-5, dtr, bc=table, bf16=bf16)),
                hk.fused_advect_heun(vr, hr, 4e-5, dtr, bc=table,
                                     bf16=bf16))
            check(u3 <= (0 if bf16 else SPLIT_ULPS), f"{key} {name} "
                  f"{list(vr.shape)}: split {u3} ulp from the solo pair")
            args, _ = shard_args(vr, hr, dtr, table, storage, 1500 // MESH_D)
            for d, (a1, k1, a2, k2) in enumerate(args):
                r1 = hk.advect_substage_halo_plain(*a1, **k1)
                s1 = hk.advect_substage_halo(*a1, **k1)
                lab = f"{key} {name} {list(vr.shape)} shard {d}"
                e1 = (bf16_close(f"{lab} substage 1", s1, r1) if bf16 else
                      rel_close(f"{lab} substage 1", s1, r1, HEUN_ABS))
                e2 = rel_close(f"{lab} substage 2",
                               hk.advect_substage_halo(*a2, **k2),
                               hk.advect_substage_halo_plain(*a2, **k2),
                               F32_REL if bf16 else HEUN_ABS)
                err = max(err, e1, e2)
            print(f"phase 2 {key} {name} {list(vr.shape)} on {MESH_D} "
                  f"slabs: split vs solo BC pair {u3} ulp", flush=True)
            del args
        res[key]["max_abs_err"] = err
        del vr
    del v
    torch.cuda.empty_cache()

    # K7, signed: the finest split level and two coarse ones (a split 64^2
    # level of 16-wide slabs, a gathered 16^2 level on one shard), both
    # sign patterns of the tables (cavity: all Neumann, signed form all the
    # same; channel: (1, -1, 1, 1))
    gen = torch.Generator(device=dev).manual_seed(10)
    for storage in (f32, bf):
        bf16 = storage == bf
        key = ("jacobi_halo_sweep+bc" if not bf16
               else "jacobi_halo_sweep+bc+bf16")
        twin = (hk.jacobi_halo_sweep_bf16_plain if bf16
                else hk.jacobi_halo_sweep_plain)
        err = 0.0
        for n, m in ((size, mesh), (64, mesh),
                     (16, make_mesh(devices=[dev]))):
            e = torch.randn(n, n, generator=gen, device=dev).to(storage)
            r = torch.randn(n, n, generator=gen, device=dev).to(storage)
            es, rs = split_x(e, m), split_x(r, m)
            aux = exchange_x(es, 1)
            mw = [(d == 0, d == m.size - 1) for d in range(m.size)]
            for signs in ((1.0, 1.0, 1.0, 1.0), EDGE_SIGNS):
                for fz in (False, True):
                    split = gather_x(overlap_jacobi_sweeps(
                        es, rs, 0.8, 1, fz, edge_signs=signs))
                    u7 = ulps(split.float(), hk.fused_jacobi_sweeps(
                        e, r, 0.8, 1, fz, signs).float())
                    check(u7 == 0 if bf16 else u7 <= SPLIT_ULPS,
                          f"{key} {n}^2 {signs} from_zero={fz}: {u7} ulp "
                          "from the signed chain kernel")
                    print(f"phase 2 {key} {n}^2 on {m.size} slabs signs "
                          f"{list(signs)} from_zero={fz} vs "
                          f"fused_jacobi_sweeps (n=1): max {u7} ulp",
                          flush=True)
                for d in range(m.size):
                    a = (es.parts[d], rs.parts[d], aux[d], 0.8, *mw[d],
                         False, signs)
                    k, p = hk.jacobi_halo_sweep(*a), twin(*a)
                    lab = f"{key} {n}^2 {list(signs)} shard {d}"
                    err = max(err, bf16_close(lab, k, p) if bf16 else
                              rel_close(lab, k, p, JACOBI_REL))
            err = max(err, slab_list_close(key, es, rs, EDGE_SIGNS))
            del e, r, es, rs, aux
        res[key]["max_abs_err"] = err
    # the twins' memoized 8192^2 signed slab diagonals would count in the
    # later phases' peak memory
    inv_diag_bc_slab.cache_clear()
    torch.cuda.empty_cache()


def phase_halo_sweep_levels(dev, res, size: int = 8192) -> dict:
    """Phase 2, continued: the halo sweep at every level of the MESH_D-way
    split hierarchy of size^2 on one card (slabs 2048 .. 8 wide, then the
    gathered levels on one slab), in its four forms (Neumann and the
    channel's signs, f32 and bf16): one sweep as one slab-list launch and
    as the per-slab sequence it replaces (an edge-column exchange, then a
    launch per slab), device ms from graph replays, the launches of each,
    the bytes bound, and the slab list bit for bit one sweep of the chain
    kernel (from e and from zero). Fills ``res`` for the four halo sweep
    entries from the finest level (the twin: the slab list's, timed
    there), and returns the tables."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    forms = {"jacobi_halo_sweep": (torch.float32, None),
             "jacobi_halo_sweep+bf16": (torch.bfloat16, None),
             "jacobi_halo_sweep+bc": (torch.float32, EDGE_SIGNS),
             "jacobi_halo_sweep+bc+bf16": (torch.bfloat16, EDGE_SIGNS)}
    tables = {}
    for key, (dtype, signs) in forms.items():
        rows = halo_sweep_level_table(dev, size=size, slabs=MESH_D,
                                      dtype=dtype, edge_signs=signs)
        tables[key] = rows
        for row in rows:
            print(f"phase 2 halo sweep level {key} {row['level']}^2 on "
                  f"{row['slabs']} slabs of {row['width']}: kernel_ms "
                  f"{row['ms']} (1 launch) per-slab sequence ms "
                  f"{row['per_slab_ms']} ({row['per_slab_launches']} "
                  f"launches) chain-kernel sweep of the whole field ms "
                  f"{row['chain_ms']} bound_ms {row['bound_ms']} sweeps/cycle "
                  f"{row['sweeps_per_cycle']} bit for bit the chain kernel "
                  f"{row['bit_equal']}", flush=True)
            check(row["bit_equal"], f"{key} level {row['level']}^2: the "
                  "slab-list sweep differs from the chain kernel's")
        cyc = {k: sum(r[k] * r["sweeps_per_cycle"] for r in rows)
               for k in ("ms", "per_slab_ms", "launches",
                         "per_slab_launches", "bound_ms")}
        print(f"phase 2 halo sweep levels {key} per V-cycle: kernel_ms "
              f"{cyc['ms']} ({cyc['launches']} launches) per-slab sequence "
              f"ms {cyc['per_slab_ms']} ({cyc['per_slab_launches']} "
              f"launches) bound_ms {cyc['bound_ms']}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(12)
        e, r = (torch.randn(size, size, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        es, rs = split_x(e, mesh), split_x(r, mesh)
        pms = cuda_ms(lambda: hk.jacobi_halo_sweep_slabs_plain(
            es.parts, rs.parts, 0.8, False, signs), 2)
        top = rows[0]
        res[key].update(ms=top["ms"], plain_ms=pms, bound_ms=top["bound_ms"],
                        bound_by="bytes", library_ms=None,
                        per_slab_ms=top["per_slab_ms"],
                        cycle_ms=cyc["ms"])
        earlier = EARLIER_MS.get(key)
        print(f"phase 2 {key} [{size},{size // MESH_D}] x{MESH_D}, one "
              f"sweep: kernel_ms {top['ms']} (one launch; per-slab sequence "
              f"{top['per_slab_ms']}; chain-kernel sweep {top['chain_ms']}"
              + (f"; earlier design {earlier}" if earlier else "")
              + f") twin_ms {pms} bound_ms {top['bound_ms']}", flush=True)
        del e, r, es, rs
        torch.cuda.empty_cache()
    return tables


def run_sharded(dev, pois: str, steps: int = 3, size: int = 8192,
                prec: str = "f32") -> dict:
    """Phase 7 (phase 9 under ``prec`` bf16) under one solver: the split
    run (counts from 0), then the solo run from the same state, ``steps``
    timed production steps after a warm-up. Checks the launches; returns
    both runs' numbers and their velocity difference."""
    cfg, level = bench_cfg(size, size)
    with latched(pois, prec):
        sims = {"sharded": lambda: ShardedUniformSim(
                    cfg, make_mesh(devices=[dev] * MESH_D), level=level),
                "solo": lambda: UniformSim(cfg, level=level, device=dev)}
        out, vel = {}, {}
        for label, make in sims.items():
            sim = make()
            if label == "sharded":
                sim.set_state(bench_start(sim.grid))
            else:
                sim.state = bench_start(sim.grid)
            sim.step_count = 10          # production solves
            dt = 0.5 * sim.grid.h
            sync(dev)
            torch.cuda.reset_peak_memory_stats()
            hk.reset_launches()
            sweep_stats.update(sweeps=0, exchanges=0)
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
                "launches": dict(hk.launches),
                "halo_sweeps": dict(sweep_stats)}
            v = sim.state.vel
            vel[label] = gather_x(v) if label == "sharded" else v
            out[label]["tier"] = sim.kernel_tier
            del sim, v
            torch.cuda.empty_cache()
    a, b = vel["sharded"], vel["solo"]
    rel = float((a - b).abs().max() / b.abs().max())
    out["vel_rel_linf"] = rel
    out["bit_equal"] = bool(torch.equal(a, b))
    phase = "phase 7" if prec == "f32" else f"phase 9 {prec}"
    print(f"{phase} sharded main path {size}^2 D={MESH_D} "
          f"{json.dumps(out)}", flush=True)
    sh, so = out["sharded"], out["solo"]
    nsteps = steps + 1
    check(sh["finite"] and so["finite"], f"{pois}: non-finite state")
    la = sh["launches"]
    check(la["advect_substage_halo"] == 2 * MESH_D * nsteps,
          f"sharded: halo substage launches {la} != 2 D per step")
    check((la["jacobi_halo_sweep"] > 0) == (pois == "fas"),
          f"sharded {pois or 'default'}: halo sweep launches {la}")
    hs = sh["halo_sweeps"]
    check(la["jacobi_halo_sweep"] == hs["sweeps"] and hs["exchanges"] == 0,
          f"sharded {pois or 'default'}: {la['jacobi_halo_sweep']} halo "
          f"sweep launches for {hs['sweeps']} sweeps over the levels, "
          f"{hs['exchanges']} exchanges for them: expected one launch a "
          "sweep and level and no exchange on a one-card mesh")
    for k in ("fused_advect_heun", "fused_correction",
              "fused_jacobi_sweeps"):
        check(la[k] == 0, f"sharded: a solo kernel launched ({k}: {la})")
    bf16 = prec == "bf16"
    check(la["advect_substage_halo+bf16"]
          == (la["advect_substage_halo"] if bf16 else 0)
          and la["jacobi_halo_sweep+bf16"]
          == (la["jacobi_halo_sweep"] if bf16 else 0),
          f"sharded {prec}: bf16 form launches {la}")
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


def run_main_path(dev, pois: str, prec: str = "f32") -> dict:
    """Phase 3 (phase 9 under ``prec`` bf16) under one solver: a warm-up
    and five timed steps of the 8192^2 benchmark state, the launches
    counted over the six."""
    with latched(pois, prec):
        g = bench_grid(8192, 8192, dev)
    state = bench_start(g)
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
    out = {"mode": g.poisson_mode, "tier": g.kernel_tier,
           "prec": g.prec_mode, "smoother": g.smoother_tier,
           "ms_per_step": ms,
           "iters_per_step": sum(iters) / len(iters), "iters": iters,
           "umax": float(diag["umax"]), "energy": float(diag["energy"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": delta}
    phase = "phase 3" if prec == "f32" else f"phase 9 {prec}"
    print(f"{phase} main path 8192^2 {json.dumps(out)}", flush=True)
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
              "bicgstab: the bf16 preconditioner must not launch the "
              "smoother kernel")
    bf16 = prec == "bf16"
    check(delta["fused_advect_heun+bf16"]
          == (delta["fused_advect_heun"] if bf16 else 0)
          and delta["fused_jacobi_sweeps+bf16"]
          == (delta["fused_jacobi_sweeps"] if bf16 else 0),
          f"{g.poisson_mode} {prec}: bf16 form launches {delta}")
    return out


def phase_trajectory(dev):
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    sims = {}
    for d in (dev, "cpu"):
        s = UniformSim(cfg, level=5, device=d)
        s.state = bench_start(s.grid)
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
    # the fas run's lab RHS operands, kept to time the kernel on the
    # forest's own labs
    seen = {}
    lab_rhs = tamr.fused_lab_rhs

    def keep(lab, h, nu, dt):
        seen.update(lab=lab, h=h, nu=nu, dt=dt)
        return lab_rhs(lab, h, nu, dt)
    tamr.fused_lab_rhs = keep
    try:
        runs.append(run_forest(fresh("fas"), "fas"))
    finally:
        tamr.fused_lab_rhs = lab_rhs
    if torch.device(dev).type == "cuda":
        forest_labs_timing(**seen)
    total = {k: sum(r["launches"][k] for r in runs)
             for k in runs[0]["launches"]}
    return runs, total


def forest_labs_timing(lab, h, nu, dt) -> None:
    """The lab RHS on the forest main path's own labs (the last call of a
    run): device ms from graph replays, its bound, and the reconstructions
    per cell and component that the face sharing needs there."""
    n = lab.shape[0]
    h = torch.as_tensor(h, dtype=torch.float32, device=lab.device)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=lab.device)
    ms = graph_ms([lambda: hk.fused_lab_rhs(lab, h, nu, dt)])
    b = bound(BYTES_LAB_RHS_BLOCK * n, advect_rhs_ops(lab))
    faces = lab_weno_faces(lab) / (2 * 64 * n)
    print(f"phase 5 fused_lab_rhs on the forest's own labs {list(lab.shape)}"
          f": kernel_ms {ms} bound_ms {b[0]} ({b[1]}); {faces} "
          "reconstructions per cell and component (the per-cell design: "
          "4)", flush=True)


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


CHANNEL_CFG = dict(bpdx=4, bpdy=1, level_max=1, level_start=0, extent=4.0,
                   nu=1e-4, cfl=0.5, max_poisson_iterations=200,
                   poisson_tol=1e-3, poisson_tol_rel=1e-2, dtype="float32")


def walled_sim(kind: str, dev, level: int, mesh=None):
    """Phase 8's and phase 10's drivers: the catalog's cavity from the
    benchmark's velocity, or the parabolic channel table from u = u_in;
    solo, or split over ``mesh``."""
    if kind == "cavity":
        if mesh is None:
            sim = cases.make_sim("cavity", level=level, device=dev)
        else:
            sim = cases.make_sim("cavity", level=level, mesh=mesh)
        st = bench_start(sim.grid)
    else:
        table = cases.channel_table(0.2, profile="parabolic")
        cfg = SimConfig(**CHANNEL_CFG)
        sim = (UniformSim(cfg, level=level, device=dev, bc=table)
               if mesh is None else
               ShardedUniformSim(cfg, mesh, level=level, bc=table))
        st = sim.grid.zero_state()
        st.vel[0] = 0.2
    if mesh is None:
        sim.state = st
    else:
        sim.set_state(st)
    return sim


def run_walled(dev, kind: str, pois: str, level: int,
               steps: int = 5, prec: str = "f32") -> dict:
    """Phase 8 (phase 9 under ``prec`` bf16) under one solver: production
    steps at the CFL dt (a warm-up and ``steps`` timed), the launch counts
    from 0."""
    with latched(pois, prec):
        sim = walled_sim(kind, dev, level)
    sim.step_count = 10              # production solves
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    iters = [sim.step_once()["poisson_iters"]]               # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        d = sim.step_once()
        iters.append(d["poisson_iters"])
    sync(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    la = {k: n for k, n in hk.launches.items() if n}
    out = {"case": kind, "table": sim.bc_table, "tier": sim.kernel_tier,
           "shape": [sim.grid.ny, sim.grid.nx], "mode": sim.poisson_mode,
           "ms_per_step": ms, "iters_per_step": sum(iters[1:]) / steps,
           "iters": iters, "dt": d["dt"], "umax": d["umax"],
           "finite": bool(d["finite"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": la}
    phase = "phase 8" if prec == "f32" else f"phase 9 {prec}"
    print(f"{phase} {kind} {json.dumps(out)}", flush=True)
    n = steps + 1
    label = f"{kind} {pois or 'default'}"
    check(out["finite"], f"{label}: non-finite state")
    check(la.get("fused_advect_heun+bc", 0) == 2 * n
          and la.get("fused_advect_heun", 0) == 2 * n,
          f"{label}: substage launches {la} != 2 boundary-table ones a step")
    check(la.get("fused_correction+bc", 0) == n,
          f"{label}: correction launches {la} != 1 signed one a step")
    check((la.get("fused_jacobi_sweeps+bc", 0) > 0) == (pois == "fas")
          and la.get("fused_jacobi_sweeps", 0)
          == la.get("fused_jacobi_sweeps+bc", 0),
          f"{label}: sweep-chain launches {la}")
    bf16 = prec == "bf16"
    for k in ("fused_advect_heun+bc", "fused_jacobi_sweeps+bc"):
        check(la.get(k + "+bf16", 0) == (la.get(k, 0) if bf16 else 0),
              f"{label} {prec}: bf16 form launches {la}")
    del sim
    torch.cuda.empty_cache()
    return out


def phase_walled(dev) -> tuple[list, dict]:
    """Phase 8: the cavity (8192^2) and the parabolic channel (8192 x
    2048) under both solvers; the card against the CPU; the plug flow.
    Returns the runs and the +bc launch counts summed over the four
    main-path runs."""
    runs = [run_walled(dev, kind, pois, level)
            for kind, level in (("cavity", 10), ("channel", 8))
            for pois in ("", "fas")]
    total = {k: sum(r["launches"].get(k, 0) for r in runs)
             for k in ("fused_advect_heun+bc", "fused_correction+bc",
                       "fused_jacobi_sweeps+bc")}

    # card vs CPU: the cavity at 256^2 from the benchmark's velocity
    sims = [walled_sim("cavity", d, 5) for d in (dev, "cpu")]
    iters = [[s.step_once()["poisson_iters"] for _ in range(5)]
             for s in sims]
    a, b = sims[0].state.vel.cpu(), sims[1].state.vel
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"phase 8 cavity 256^2 x5 card vs CPU: card iters {iters[0]} cpu "
          f"iters {iters[1]} vel rel Linf {rel}", flush=True)
    check(bool(torch.isfinite(a).all()), "cavity 256^2: non-finite state")
    check(rel <= TRAJ_REL, f"cavity 256^2: card vs CPU {rel} > {TRAJ_REL}")
    del sims

    # the plug flow: an exact steady state through inflow and outflow
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                    extent=2.0, nu=1e-3, cfl=0.3, dtype="float32",
                    max_poisson_iterations=100)
    sim = UniformSim(cfg, level=5, device=dev, bc=cases.channel_table(0.2))
    st = sim.grid.zero_state()
    st.vel[0] = 0.2
    sim.state = st
    for _ in range(25):
        sim.step_once()
    vel = sim.state.vel
    du = float((vel[0] - 0.2).abs().max())
    dv = float(vel[1].abs().max())
    print(f"phase 8 plug flow {sim.grid.ny}x{sim.grid.nx} x25 on the card: "
          f"max |u - u_in| {du} max |v| {dv}", flush=True)
    check(du <= PLUG_ABS and dv <= PLUG_ABS,
          f"plug flow: {du}, {dv} > {PLUG_ABS}")
    del sim
    return runs, total


def run_split_walled(dev, kind: str, pois: str, level: int, steps: int = 3,
                     prec: str = "f32") -> dict:
    """Phase 10 (phase 9 under ``prec`` bf16) under one solver: a
    wall-bounded box split into MESH_D slabs of the card, then the solo
    sim from the same state, each a warm-up and ``steps`` timed production
    steps at the CFL dt, the launch counts from 0. Checks the split run's
    launches; returns both runs' numbers and their velocity
    difference."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    out, vel = {}, {}
    for label, m in (("sharded", mesh), ("solo", None)):
        with latched(pois, prec):
            sim = walled_sim(kind, dev, level, m)
        sim.step_count = 10          # production solves
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
        hk.reset_launches()
        sweep_stats.update(sweeps=0, exchanges=0)
        iters = [sim.step_once()["poisson_iters"]]           # warm-up
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            d = sim.step_once()
            iters.append(d["poisson_iters"])
        sync(dev)
        ms = (time.perf_counter() - t0) / steps * 1e3
        out[label] = {
            "case": kind, "table": sim.bc_table, "tier": sim.kernel_tier,
            "mode": sim.poisson_mode, "smoother": sim.smoother_tier,
            "shape": [sim.grid.ny, sim.grid.nx], "ms_per_step": ms,
            "iters_per_step": sum(iters[1:]) / steps, "iters": iters,
            "umax": d["umax"], "finite": bool(d["finite"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: n for k, n in hk.launches.items() if n},
            "halo_sweeps": dict(sweep_stats)}
        v = sim.state.vel
        vel[label] = gather_x(v) if m is not None else v
        del sim, v
        torch.cuda.empty_cache()
    a, b = vel["sharded"], vel["solo"]
    out["vel_rel_linf"] = float((a - b).abs().max() / b.abs().max())
    out["bit_equal"] = bool(torch.equal(a, b))
    del a, b, vel
    phase = "phase 10" if prec == "f32" else f"phase 9 {prec}"
    print(f"{phase} sharded {kind} D={MESH_D} {json.dumps(out)}", flush=True)
    sh, so = out["sharded"], out["solo"]
    label = f"sharded {kind} {pois or 'default'} {prec}"
    check(sh["finite"] and so["finite"], f"{label}: non-finite state")
    la = sh["launches"]
    n = steps + 1
    check(la.get("advect_substage_halo+bc", 0) == 2 * MESH_D * n
          and la.get("advect_substage_halo", 0) == 2 * MESH_D * n,
          f"{label}: halo substage launches {la} != 2 D boundary-table "
          "ones a step")
    check((la.get("jacobi_halo_sweep+bc", 0) > 0) == (pois == "fas")
          and la.get("jacobi_halo_sweep", 0)
          == la.get("jacobi_halo_sweep+bc", 0),
          f"{label}: halo sweep launches {la}")
    hs = sh["halo_sweeps"]
    check(la.get("jacobi_halo_sweep", 0) == hs["sweeps"]
          and hs["exchanges"] == 0,
          f"{label}: {la.get('jacobi_halo_sweep', 0)} halo sweep launches "
          f"for {hs['sweeps']} sweeps over the levels, {hs['exchanges']} "
          "exchanges for them: expected one launch a sweep and level and no"
          " exchange on a one-card mesh")
    for k in ("fused_advect_heun", "fused_correction",
              "fused_jacobi_sweeps"):
        check(la.get(k, 0) == 0, f"{label}: a solo kernel launched ({k}: "
              f"{la})")
    bf16 = prec == "bf16"
    for k in ("advect_substage_halo+bc", "jacobi_halo_sweep+bc"):
        check(la.get(k + "+bf16", 0) == (la.get(k, 0) if bf16 else 0),
              f"{label}: bf16 form launches {la}")
    check(sh["iters"] == so["iters"], f"{label}: iterations {sh['iters']} "
          f"!= solo {so['iters']}")
    check(out["vel_rel_linf"] <= SHARDED_REL, f"{label}: vel rel "
          f"{out['vel_rel_linf']} > {SHARDED_REL} from the solo step")
    return out


def phase_split_walled(dev) -> tuple[list, dict]:
    """Phase 10: the wall-bounded boxes on the x-split step, MESH_D slabs
    of the card: the 8192^2 cavity from the benchmark velocity under the
    default solver and fas, and the 8192 x 2048 parabolic channel under
    fas (the default solver does not converge there at f32, ROADMAP queue
    3), each against the solo run from the same state. Returns the runs
    and the ``+bc`` halo launches summed over them."""
    runs = [run_split_walled(dev, "cavity", p, 10) for p in ("", "fas")]
    runs.append(run_split_walled(dev, "channel", "fas", 8))
    total = {k: sum(r["sharded"]["launches"].get(k, 0) for r in runs)
             for k in ("advect_substage_halo+bc", "jacobi_halo_sweep+bc")}
    return runs, total


def phase_bf16_trajectory(dev, pois: str, steps: int = 5) -> None:
    """Phase 9, continued: 256^2 from the benchmark velocity under
    CUP2D_PREC=bf16 on the card and on the CPU (the twins), ``steps``
    ``step_once`` steps each, within BF16_BAND relative (a bf16 rounding
    on the other side of a midpoint on one device moves an ulp of bf16);
    and the card's bf16 run against its f32 run, in (0, BF16_BAND]."""
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    vel, iters = {}, {}
    for label, d, prec in (("card", dev, "bf16"), ("cpu", "cpu", "bf16"),
                           ("card f32", dev, "f32")):
        with latched(pois, prec):
            sim = UniformSim(cfg, level=5, device=d)
        sim.state = bench_start(sim.grid)
        iters[label] = [sim.step_once()["poisson_iters"]
                        for _ in range(steps)]
        vel[label] = sim.state.vel.cpu()
    a, b, c = vel["card"], vel["cpu"], vel["card f32"]
    rel = float((a - b).abs().max() / b.abs().max())
    moved = float((a - c).abs().max() / c.abs().max())
    print(f"phase 9 bf16 trajectory 256^2 x{steps} {pois or 'default'}: "
          f"card iters {iters['card']} cpu iters {iters['cpu']} card f32 "
          f"iters {iters['card f32']}; card vs CPU rel {rel}; card bf16 vs "
          f"card f32 rel {moved}", flush=True)
    check(bool(torch.isfinite(a).all()), "bf16 trajectory: non-finite")
    check(rel <= BF16_BAND, f"bf16 trajectory: card vs CPU {rel} > "
          f"{BF16_BAND}")
    check(0.0 < moved <= BF16_BAND, f"bf16 trajectory: bf16 vs f32 "
          f"{moved} not in (0, {BF16_BAND}]")


def phase_bf16(dev) -> tuple[dict, dict]:
    """Phase 9: the bf16 main path. The 8192^2 step under both solvers
    (phase 3's runs with CUP2D_PREC=bf16), the split step on MESH_D slabs
    of the card under both (bit for bit the solo bf16 step, equal
    iterations), the cavity under fas (the boundary-table bf16 forms),
    solo and split (bit for bit the solo bf16 cavity), and the 256^2 bf16
    step on the card against the CPU and against f32.
    Returns the runs and the bf16 forms' launches summed over the
    main-path runs."""
    runs = {"uniform": [run_main_path(dev, p, "bf16") for p in ("", "fas")]}
    runs["sharded"] = [run_sharded(dev, p, prec="bf16")
                       for p in ("", "fas")]
    for r, p in zip(runs["sharded"], ("default", "fas")):
        check(r["sharded"]["iters"] == r["solo"]["iters"] and r["bit_equal"],
              f"phase 9 sharded {p}: split iters {r['sharded']['iters']} vs "
              f"solo {r['solo']['iters']}, bit-equal {r['bit_equal']}")
    runs["walled"] = [run_walled(dev, "cavity", "fas", 10, steps=2,
                                 prec="bf16")]
    runs["split_walled"] = [run_split_walled(dev, "cavity", "fas", 10,
                                             steps=2, prec="bf16")]
    check(runs["split_walled"][0]["bit_equal"], "phase 9 sharded cavity: "
          "the split bf16 step differs from the solo bf16 step")
    for p in ("", "fas"):
        phase_bf16_trajectory(dev, p)
    total = {k: 0 for k in BF16_KEYS}
    for r in runs["uniform"]:
        for k in total:
            total[k] += r["launches"][k]
    for r in runs["sharded"]:
        for k in total:
            total[k] += r["sharded"]["launches"][k]
    for r in runs["walled"]:
        for k in total:
            total[k] += r["launches"].get(k, 0)
    for r in runs["split_walled"]:
        for k in total:
            total[k] += r["sharded"]["launches"].get(k, 0)
    return runs, total


# phase 11: the flagship step, __graft_entry__.entry()'s configuration
ENTRY_SHAPES = ("angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
                "angle=180 L=0.2 xpos=1.6 ypos=0.8")
ENTRY_LEVEL = 6        # 1024 x 512 cells
SHAPED_CPU_LEVEL = 5   # 512 x 256: each fish has several penalized cells
#                        (at level 4 one, a singular momentum system)
FLAGSHIP_REL = 2e-6    # the three kernels against their twins on the
#                        flagship's own operands, relative to max |ref|
SHAPED_KEYS = ("fused_advect_heun", "fused_correction", "fused_jacobi_sweeps")


def entry_cfg(**kw) -> SimConfig:
    """``entry()``'s configuration (f32, the two fish)."""
    base = dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=4.0,
                dtype="float32", nu=4e-5, lam=1e7, cfl=0.5,
                shapes=ENTRY_SHAPES)
    base.update(kw)
    return SimConfig(**base)


def run_flagship(dev, pois: str) -> tuple[dict, Simulation]:
    """Phase 11 under one solver: ``initialize()``, the 10 exact startup
    steps and 5 production ``step_once`` steps of the two fish at 1024 x
    512 f32, each step timed on the host clock to its end (a step ends in
    its own reads of the device, then a synchronize), the launches counted
    from 0 over the 15 steps."""
    with latched(pois):
        sim = Simulation(entry_cfg(), level=ENTRY_LEVEL, device=dev)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    t0 = time.perf_counter()
    sim.initialize()
    sync(dev)
    out = {"mode": sim.poisson_mode, "tier": sim.kernel_tier,
           "shape": [sim.grid.ny, sim.grid.nx],
           "initialize_ms": (time.perf_counter() - t0) * 1e3}
    finite = True
    for label, n in (("startup", 10), ("production", 5)):
        ms, iters, phase_ms = [], [], {}
        for _ in range(n):
            t0 = time.perf_counter()
            d = sim.step_once()
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(d["poisson_iters"])
            finite = finite and d["finite"]
            for k, v in sim.phase_seconds.items():
                phase_ms[k] = phase_ms.get(k, 0.0) + v * 1e3 / n
        out[label] = {"ms_per_step": sum(ms) / n, "ms": ms,
                      "iters_per_step": sum(iters) / n, "iters": iters,
                      "phase_ms_per_step": phase_ms}
    la = {k: n for k, n in hk.launches.items() if n}
    uvw = [[s.u, s.v, s.omega] for s in sim.shapes]
    out.update(umax=d["umax"], dt=d["dt"], uvw=uvw,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=la)
    print(f"phase 11 flagship {pois or 'default'} {json.dumps(out)}",
          flush=True)
    label = f"flagship {pois or 'default'}"
    steps = 15
    check(finite and np.isfinite(uvw).all(), f"{label}: non-finite state")
    check(la.get("fused_advect_heun", 0) == 2 * steps,
          f"{label}: substage launches {la} != 2 a step")
    check(la.get("fused_correction", 0) == steps,
          f"{label}: correction launches {la} != 1 a step")
    check((la.get("fused_jacobi_sweeps", 0) > 0) == (pois == "fas"),
          f"{label}: sweep-chain launches {la} (fas only)")
    check(not any("+bc" in k or "+bf16" in k or "halo" in k for k in la),
          f"{label}: launches of another form {la}")
    return out, sim


def flagship_kernels(sim) -> dict:
    """Phase 11, continued: the three kernels of the flagship step against
    their twins on its own operands at 1024 x 512 (the substage pair on
    the run's velocity at its dt, the correction on its pressure, the
    sweep chain n = 2 on the finest level), device ms by graph replay,
    and each bound at these shapes."""
    g = sim.grid
    dev = g.device
    v = sim.state.vel[None].contiguous()
    dt = torch.tensor([sim._next_dt], device=dev)
    cells = g.ny * g.nx
    out = {}
    got = hk.fused_advect_heun(v, g.h, g.cfg.nu, dt)
    ref = hk.fused_advect_heun_plain(v, g.h, g.cfg.nu, dt)
    facs = hk._substage_facs(dt, g.h, g.cfg.nu, (1,), 1, torch.float32, dev)
    v1 = hk.advect_substage(v, None, facs, 0.5, 1.0 / (g.h * g.h))
    b = bound(substage_pair_bytes(cells), substage_ops(v) + substage_ops(v1))
    out["fused_advect_heun"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        rel=float((got - ref).abs().max() / ref.abs().max()),
        ms=graph_ms([lambda: hk.fused_advect_heun(v, g.h, g.cfg.nu, dt)]),
        plain_ms=graph_ms([lambda: hk.fused_advect_heun_plain(
            v, g.h, g.cfg.nu, dt)], reps=6),
        bound_ms=b[0], bound_by=b[1])
    x = sim.state.pres[None].contiguous()
    p = torch.roll(x, 1, dims=-1).contiguous()
    scal = torch.stack([x.mean(), p.mean(),
                        -0.5 * dt[0] * g.h]).reshape(1, 3).contiguous()
    ih2 = 1.0 / (g.h * g.h)
    got = hk.fused_correction(x, p, v, scal, ih2)
    ref = hk.fused_correction_plain(x, p, v, scal, ih2)
    b = bound(28.0 * cells, OPS_CORRECTION_CELL * cells)
    out["fused_correction"] = dict(
        max_abs_err=max(float((a - c).abs().max()) for a, c in zip(got, ref)),
        rel=max(float((a - c).abs().max() / c.abs().max())
                for a, c in zip(got, ref)),
        ms=graph_ms([lambda: hk.fused_correction(x, p, v, scal, ih2)]),
        plain_ms=graph_ms([lambda: hk.fused_correction_plain(
            x, p, v, scal, ih2)], reps=6),
        bound_ms=b[0], bound_by=b[1])
    gen = torch.Generator(device=dev).manual_seed(11)
    e = torch.randn(g.ny, g.nx, generator=gen, device=dev)
    r = torch.randn(g.ny, g.nx, generator=gen, device=dev)
    got = hk.fused_jacobi_sweeps(e, r, 0.8, 2, False)
    ref = hk.jacobi_sweeps_plain(e, r, 0.8, 2, False)
    b = bound(sweep_bytes(cells, False), OPS_SWEEP_CELL * 2 * cells)
    out["fused_jacobi_sweeps"] = dict(
        max_abs_err=float((got - ref).abs().max()),
        rel=float((got - ref).abs().max() / ref.abs().max()),
        ms=graph_ms([lambda: hk.fused_jacobi_sweeps(e, r, 0.8, 2, False)]),
        plain_ms=graph_ms([lambda: hk.jacobi_sweeps_plain(
            e, r, 0.8, 2, False)], reps=6),
        bound_ms=b[0], bound_by=b[1])
    for k, o in out.items():
        o["shape"] = [g.ny, g.nx]
        print(f"phase 11 kernel {k} at {g.ny}x{g.nx}: {json.dumps(o)}",
              flush=True)
        check(o["rel"] <= FLAGSHIP_REL, f"{k} at the flagship's shapes: "
              f"rel {o['rel']} > {FLAGSHIP_REL}")
    return out


def phase_entry_call(dev) -> dict:
    """Phase 11, continued: ``entry()``'s own call on the port,
    ``_flow_step_impl(taylor_green_state(grid)._replace(chi=obs.chi),
    obs, zeros((2, 3)), 2e-4)`` after ``advect(0)``/``midline(0)``: a
    warm-up and 5 eager calls from the same arguments, host clock to a
    synchronize ("flagship step ms"), launches from 0 over the 5."""
    sim = Simulation(entry_cfg(), level=ENTRY_LEVEL, device=dev)
    for s in sim.shapes:
        s.advect(0.0, sim.cfg.extents)
        s.midline(0.0)
    obs = sim._rasterize_impl(sim._shape_inputs())
    state = taylor_green_state(sim.grid)._replace(chi=obs.chi)
    prescribed = torch.zeros((len(sim.shapes), 3), device=dev)
    dt = torch.tensor(2e-4, device=dev)
    sim._flow_step_impl(state, obs, prescribed, dt)        # warm-up
    sync(dev)
    hk.reset_launches()
    t0 = time.perf_counter()
    for _ in range(5):
        new, uvw, diag = sim._flow_step_impl(state, obs, prescribed, dt)
    sync(dev)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    la = {k: n for k, n in hk.launches.items() if n}
    out = {"flagship_step_ms": ms, "iters": diag["poisson_iters"],
           "uvw": uvw.cpu().tolist(), "umax": float(diag["umax"]),
           "launches": la}
    print(f"phase 11 entry() call {json.dumps(out)}", flush=True)
    check(bool(torch.isfinite(new.vel).all() and torch.isfinite(uvw).all())
          and tuple(uvw.shape) == (2, 3), "entry() call: bad outputs")
    check(la.get("fused_advect_heun", 0) == 10
          and la.get("fused_correction", 0) == 5,
          f"entry() call: launches {la}")
    return out


def phase_shaped_cpu(dev, pois: str) -> dict:
    """Phase 11, continued: the two fish at 512 x 256 f32 on the card and
    on the CPU from the same state (the card's after its 10 exact startup
    steps, carried over with ``convert.copy_simulation_state``), 5
    production
    ``step_once`` steps each, equal iterations; beside them the card from
    the same state one ulp away (how far rounding alone carries). Under
    fas: velocity within
    TRAJ_REL relative and each fish's (u, v, omega) within TRAJ_REL of its
    largest component. Under the default solver within the solver's
    relative tolerance (1e-2): its bf16 preconditioner cycle carries a
    one-ulp difference of its input to ~1e-3 of the 1-iteration production
    solve (ROADMAP queue 3), so the two devices agree to the tolerance,
    not to rounding."""
    with latched(pois):
        card = Simulation(entry_cfg(), level=SHAPED_CPU_LEVEL, device=dev)
        cpu = Simulation(entry_cfg(), level=SHAPED_CPU_LEVEL, device="cpu")
    card.initialize()
    for _ in range(10):
        card.step_once()
    copy_simulation_state(card, cpu)
    # the card again from the same state with its velocity one ulp away
    # in every cell: how far rounding alone carries in 5 steps
    with latched(pois):
        ulp = Simulation(entry_cfg(), level=SHAPED_CPU_LEVEL, device=dev)
    copy_simulation_state(card, ulp)
    sign = torch.where(torch.rand(card.state.vel.shape, device=dev,
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(5)) < 0.5, -1, 1)
    ulp.state = ulp.state._replace(vel=torch.nextafter(
        ulp.state.vel, ulp.state.vel + sign * torch.inf))
    iters = {"card": [], "cpu": [], "card_1ulp": []}
    for _ in range(5):
        for label, s in (("card", card), ("cpu", cpu), ("card_1ulp", ulp)):
            iters[label].append(s.step_once()["poisson_iters"])
    a, b = card.state.vel.cpu(), cpu.state.vel
    rel = float((a - b).abs().max() / b.abs().max())
    rel_ulp = float((ulp.state.vel.cpu() - a).abs().max() / a.abs().max())
    uvw_rel = []
    for p, q in zip(card.shapes, cpu.shapes):
        up, uq = np.array([p.u, p.v, p.omega]), np.array([q.u, q.v, q.omega])
        uvw_rel.append(float(np.abs(up - uq).max() / np.abs(uq).max()))
    bar = TRAJ_REL if pois == "fas" else cpu.cfg.poisson_tol_rel
    out = {"mode": cpu.poisson_mode, "shape": [card.grid.ny, card.grid.nx],
           "iters": iters, "vel_rel_linf": rel,
           "card_vs_card_1ulp_rel_linf": rel_ulp, "uvw_rel": uvw_rel,
           "bar": bar, "uvw_cpu": [[q.u, q.v, q.omega] for q in cpu.shapes]}
    print(f"phase 11 card vs CPU {json.dumps(out)}", flush=True)
    label = f"shaped card vs CPU {pois or 'default'}"
    check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
    check(iters["card"] == iters["cpu"], f"{label}: iterations {iters}")
    check(rel <= bar, f"{label}: vel {rel} > {bar}")
    check(max(uvw_rel) <= bar, f"{label}: uvw {uvw_rel} > {bar}")
    return out


def phase_shaped_channel(dev) -> dict:
    """Phase 11, continued: the catalog's channel (a fixed disk between an
    inflow and an outflow face) at 512 x 128 under fas for 3 steps on the
    card: finite, the boundary-table substage and the signed correction
    launched every step, signed sweep chains launched."""
    with latched("fas"):
        sim = cases.make_sim("channel", level=4, device=dev)
    hk.reset_launches()
    ds = [sim.step_once() for _ in range(3)]
    la = {k: n for k, n in hk.launches.items() if n}
    out = {"table": sim.bc_table, "shape": [sim.grid.ny, sim.grid.nx],
           "iters": [d["poisson_iters"] for d in ds],
           "umax": ds[-1]["umax"],
           "forcex": sim.shapes[0].forces["forcex"],
           "launches": la}
    print(f"phase 11 channel fas {json.dumps(out)}", flush=True)
    check(all(d["finite"] for d in ds), "shaped channel: non-finite")
    check(la.get("fused_advect_heun+bc", 0) == 6
          and la.get("fused_correction+bc", 0) == 3
          and la.get("fused_jacobi_sweeps+bc", 0) > 0,
          f"shaped channel: launches {la}")
    return out


def phase_shaped(dev) -> tuple[dict, dict]:
    """Phase 11: the flagship step. Returns the runs and the launches of
    the two flagship runs per kernel."""
    runs = {}
    flagship = []
    for p in ("", "fas"):
        out, sim = run_flagship(dev, p)
        flagship.append(out)
        if p == "fas":
            launches = {k: sum(r["launches"].get(k, 0) for r in flagship)
                        for k in SHAPED_KEYS}
            runs["kernels"] = flagship_kernels(sim)
        del sim
    runs["flagship"] = flagship
    runs["entry_call"] = phase_entry_call(dev)
    runs["card_vs_cpu"] = [phase_shaped_cpu(dev, p) for p in ("fas", "")]
    runs["channel"] = phase_shaped_channel(dev)
    return runs, launches


# phase 12: the canonical shaped forest, validation/canonical.py's run.sh
# flags (written out here: the smoke imports nothing of validation)
CANON_FLAGS = ("-AdaptSteps 20 -bpdx 2 -bpdy 1 -CFL 0.5 -Ctol 1 -extent 4 "
               "-lambda 1e7 -levelMax {lm} -levelStart {ls} "
               "-maxPoissonIterations 1000 -maxPoissonRestarts 0 "
               "-nu 0.00004 -poissonTol {tol} -poissonTolRel {rel} -Rtol 2 "
               "-tdump 0 -tend 10.0 -dtype float32")
CANON_LEVEL_MAX = 8
CANON_LEVEL_START = 5
CANON_CPU_LEVELS = (6, 3)    # levelMax, levelStart of the card-vs-CPU run
CANON_KEYS = ("fused_lab_rhs", "fused_block_jacobi_update")
# kernels 2, 3, 5, 6 and 7: no launch of any of their forms on the forest
NOT_FOREST = ("fused_advect_heun", "advect_substage_halo",
              "fused_correction", "fused_jacobi_sweeps", "jacobi_halo_sweep")


def canonical_cfg(level_max=CANON_LEVEL_MAX, level_start=CANON_LEVEL_START,
                  tol=1e-3, rel=1e-2) -> SimConfig:
    argv = CANON_FLAGS.format(lm=level_max, ls=level_start, tol=tol,
                              rel=rel).split()
    return SimConfig.from_argv(argv + ["-shapes", ENTRY_SHAPES])


def canonical_sim(dev, pois=None, **kw) -> AMRSim:
    """The canonical two-fish forest through the port's entry points;
    ``pois`` None runs the default solver (CUP2D_POIS unset)."""
    if pois:
        os.environ["CUP2D_POIS"] = pois
    try:
        return AMRSim(canonical_cfg(**kw), device=dev)
    finally:
        os.environ.pop("CUP2D_POIS", None)


def run_canonical(dev, pois=None, keep=None) -> dict:
    """Phase 12 under one solver: ``initialize()`` (host seconds), then
    ``run()``'s schedule (an ``adapt()`` before each of steps 0-10, then
    every 20) for 10 exact startup steps and 10 production steps, each
    step timed on the host clock to a synchronize, with its phases' host
    ms; launch counts from 0 over the 20 steps and their adapts."""
    label = f"canonical {pois or 'default'}"
    sim = canonical_sim(dev, pois)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.initialize()
    sync(dev)
    init_s = time.perf_counter() - t0
    f = sim.forest
    levels = sorted({k[0] for k in f.blocks})
    chi = sim.fields()["chi"]
    order = f.order()
    cmax = chi[torch.as_tensor(order, dtype=torch.long, device=dev)].amax(
        dim=(1, 2, 3)).cpu()
    lv = f.level[order]
    body = lv[cmax.numpy() > 0.2]
    out = {"mode": sim.poisson_mode, "initialize_s": init_s,
           "blocks": len(f.blocks), "levels": levels,
           "n_pad": sim._npad_hwm, "wcap": list(sim._wcap),
           "body_blocks": int(len(body)),
           "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"phase 12 {label} initialized {json.dumps(out)}", flush=True)
    check(len(body) > 0 and bool((body == sim.cfg.level_max - 1).all()),
          f"{label}: a block with chi > 0.2 is not at level "
          f"{sim.cfg.level_max - 1}: levels {sorted(set(body.tolist()))}")
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    seen = {}
    lab_rhs, block_upd = tamr.fused_lab_rhs, tamr.fused_block_jacobi_update

    def keep_lab(lab, h, nu, dt):
        seen["lab"] = (lab, h, nu, dt)
        return lab_rhs(lab, h, nu, dt)

    def keep_upd(e, r, lap, p_inv):
        seen["upd"] = (e, r, lap, p_inv)
        return block_upd(e, r, lap, p_inv)
    tamr.fused_lab_rhs, tamr.fused_block_jacobi_update = keep_lab, keep_upd
    rows = []
    try:
        for k in range(20):
            row = {"step": k}
            if sim.step_count <= 10 or \
                    sim.step_count % sim.cfg.adapt_steps == 0:
                sync(dev)
                t0 = time.perf_counter()
                row["adapt_changed"] = sim.adapt()
                sim._refresh()
                sync(dev)
                row["adapt_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            d = sim.step_once()
            sync(dev)
            row.update(ms=(time.perf_counter() - t0) * 1e3,
                       iters=d["poisson_iters"], blocks=len(f.blocks),
                       finite=d["finite"], dt=d["dt"],
                       **{f"{p}_ms": v * 1e3
                          for p, v in sim.phase_seconds.items()})
            rows.append(row)
    finally:
        tamr.fused_lab_rhs = lab_rhs
        tamr.fused_block_jacobi_update = block_upd
    la = {k: n for k, n in hk.launches.items() if n}
    for name, part in (("startup", rows[:10]), ("production", rows[10:])):
        n = len(part)
        out[name] = {
            "ms_per_step": sum(r["ms"] for r in part) / n,
            "iters": [r["iters"] for r in part],
            "blocks": [r["blocks"] for r in part],
            "phase_ms_per_step": {
                p: sum(r[f"{p}_ms"] for r in part) / n
                for p in ("kinematics", "megastep", "forces")},
            "adapt_ms": [round(r["adapt_ms"], 3) for r in part
                         if "adapt_ms" in r]}
    uvw = [[s.u, s.v, s.omega] for s in sim.shapes]
    out.update(uvw=uvw, umax=d["umax"], dt=d["dt"], time=sim.time,
               forcex=[s.forces["forcex"] for s in sim.shapes],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=la)
    print(f"phase 12 {label} {json.dumps(out)}", flush=True)
    check(all(r["finite"] for r in rows) and np.isfinite(uvw).all(),
          f"{label}: non-finite state")
    check(la.get("fused_lab_rhs", 0) == 2 * len(rows),
          f"{label}: lab-RHS launches {la} != 2 a step")
    fas_cycles = sum(r["iters"] for r in rows[10:]) if pois == "fas" else 0
    check(la.get("fused_block_jacobi_update", 0) == fas_cycles,
          f"{label}: block-Jacobi launches {la} != {fas_cycles} (one per "
          "production FAS cycle)")
    check(not any(hk.kernel_of(k) in NOT_FOREST for k in la),
          f"{label}: launches of a uniform or split kernel {la}")
    if keep is not None:
        keep.update(seen)
    return out


def canonical_kernels(seen: dict) -> dict:
    """Phase 12, continued: the two forest kernels on the canonical run's
    own last operands against their twins (phase 2's bars: the lab RHS per
    h class relative to its max |ref|, the block-Jacobi update relative to
    max |ref|), device ms by graph replay, bounds at these N."""
    out = {}
    lab, h, nu, dt = seen["lab"]
    n = lab.shape[0]
    got = hk.fused_lab_rhs(lab, h, nu, dt)
    ref = hk.fused_lab_rhs_plain(lab, h, nu, dt)
    diff = (got - ref).abs()
    hv = h.reshape(-1)
    rel = max(float(diff[hv == c].max()
                    / ref[hv == c].abs().max().clamp_min(1e-30))
              for c in torch.unique(hv))
    b = bound(BYTES_LAB_RHS_BLOCK * n, advect_rhs_ops(lab))
    out["fused_lab_rhs"] = dict(
        shape=list(lab.shape), max_abs_err=float(diff.max()), rel=rel,
        ms=graph_ms([lambda: hk.fused_lab_rhs(lab, h, nu, dt)]),
        plain_ms=graph_ms([lambda: hk.fused_lab_rhs_plain(lab, h, nu, dt)],
                          reps=6),
        bound_ms=b[0], bound_by=b[1])
    check(rel <= LAB_RHS_REL, f"fused_lab_rhs on the canonical labs: rel "
          f"{rel} > {LAB_RHS_REL}")
    if "upd" in seen:
        e, r, lap, p_inv = seen["upd"]
        n = e.shape[0]
        got = hk.fused_block_jacobi_update(e, r, lap, p_inv)
        ref = hk.block_jacobi_plain(e, r, lap, p_inv)
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        b = bound(BYTES_BLOCK_JACOBI_BLOCK * n + 4 * 64 * 64,
                  OPS_BLOCK_JACOBI_ELEM * 64 * n)
        pt = p_inv.T
        out["fused_block_jacobi_update"] = dict(
            shape=list(e.shape), max_abs_err=err, rel=rel,
            ms=graph_ms([lambda: hk.fused_block_jacobi_update(
                e, r, lap, p_inv)]),
            plain_ms=graph_ms([lambda: hk.block_jacobi_plain(
                e, r, lap, p_inv)]),
            library_ms=graph_ms([lambda: torch.addmm(
                e.reshape(n, 64), r.reshape(n, 64) - lap.reshape(n, 64),
                pt)]),
            bound_ms=b[0], bound_by=b[1])
        check(rel <= BLOCK_JACOBI_REL, f"fused_block_jacobi_update on the "
              f"canonical operands: rel {rel} > {BLOCK_JACOBI_REL}")
    for k, o in out.items():
        print(f"phase 12 kernel {k} on the canonical run's operands: "
              f"{json.dumps(o)}", flush=True)
    return out


def _ordered_fields(sim) -> tuple[list, dict]:
    fields = sim.fields()
    f = sim.forest
    order = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in order]
    idx = torch.as_tensor(order, dtype=torch.long, device=sim.device)
    return keys, {k: v[idx].cpu() for k, v in fields.items()}


def phase_canonical_cpu(dev, pois=None, tol=1e-3, rel=1e-2,
                        hold=True) -> dict:
    """Phase 12, continued: the canonical case at levelMax 6, levelStart 3,
    f32, on the card and on the CPU from the card's state after its
    ``initialize()`` and 10 startup steps (``convert.copy_amr_state``),
    5 production steps each with an ``adapt()`` after the second: equal
    block key sets and, with ``hold``, equal iterations, velocity within
    TRAJ_REL relative and each fish's (u, v, omega) within TRAJ_REL of
    its largest component. (At levelMax 5 no cell of either fish reaches
    chi 0.5 and uvw is 0 on both devices.) Without ``hold`` the numbers
    are printed and only finiteness is checked: under the default solver
    at tolerances 1e-6/1e-5 BiCGSTAB does not converge on the shaped RHS,
    which is not mean-free (121-321 iterations a step), and the devices
    part as the packages do (ROADMAP queue 3)."""
    lm, ls = CANON_CPU_LEVELS
    label = f"canonical card vs CPU {pois or 'default'} {tol}/{rel}"
    card = canonical_sim(dev, pois, level_max=lm, level_start=ls, tol=tol,
                         rel=rel)
    cpu = canonical_sim("cpu", pois, level_max=lm, level_start=ls, tol=tol,
                        rel=rel)
    card.initialize()
    for _ in range(10):
        if card.step_count <= 10:
            card.adapt()
        card.step_once()
    copy_amr_state(card, cpu)
    iters = {"card": [], "cpu": []}
    for k in range(5):
        if k == 2:
            a, b = card.adapt(), cpu.adapt()
            check(a == b, f"{label}: adapt changed card {a} cpu {b}")
            check(set(card.forest.blocks) == set(cpu.forest.blocks),
                  f"{label}: the card and the CPU adapted to different "
                  "block sets")
        iters["card"].append(card.step_once()["poisson_iters"])
        iters["cpu"].append(cpu.step_once()["poisson_iters"])
    (kc, fc), (kp, fp) = _ordered_fields(card), _ordered_fields(cpu)
    check(kc == kp, f"{label}: ordered block keys differ")
    a, b = fc["vel"], fp["vel"]
    vrel = float((a - b).abs().max() / b.abs().max())
    uvw_rel = []
    for p, q in zip(card.shapes, cpu.shapes):
        up, uq = np.array([p.u, p.v, p.omega]), np.array([q.u, q.v, q.omega])
        uvw_rel.append(float(np.abs(up - uq).max() / np.abs(uq).max()))
    out = {"mode": cpu.poisson_mode, "tol": [tol, rel], "blocks": len(kp),
           "iters": iters, "vel_rel_linf": vrel, "uvw_rel": uvw_rel,
           "bar": TRAJ_REL if hold else None}
    print(f"phase 12 {label} {json.dumps(out)}", flush=True)
    check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
    if hold:
        check(iters["card"] == iters["cpu"], f"{label}: iterations {iters}")
        check(vrel <= TRAJ_REL, f"{label}: vel {vrel} > {TRAJ_REL}")
        check(max(uvw_rel) <= TRAJ_REL,
              f"{label}: uvw {uvw_rel} > {TRAJ_REL}")
    return out


def phase_collision(dev, golden=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests",
        "golden_collision.json")) -> dict:
    """Phase 12, continued: the two-disk collision of
    validation/golden_collision.py's ``build_sim`` (copied here) at f32 on
    the card, 6 steps at dt 0.008: body 0's u must flip from > 0.1 to
    < -0.01 across steps 0 -> 1 (the e = 1 impulse); the largest
    difference from tests/golden_collision.json's com and (u, v, omega),
    f64 CPU numbers, is printed."""
    from cup2d_tpu_torch.models import DiskShape
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=3, level_start=2,
                    extent=1.0, dtype="float32", nu=2e-4, lam=1e6,
                    cfl=0.4, rtol=1e9, ctol=-1.0,
                    max_poisson_iterations=60, poisson_tol=1e-6,
                    poisson_tol_rel=1e-4)
    r = 0.06
    sim = AMRSim(cfg, shapes=[DiskShape(r, 0.42, 0.5),
                              DiskShape(r, 0.58, 0.5)], device=dev)
    sim.compute_forces_every = 0
    sim.initialize()
    f = sim.forest
    vel = sim.fields()["vel"].cpu().numpy().copy()
    order = f.order()
    bs = cfg.bs
    h = f.h_per_block(order)
    ar = np.arange(bs) + 0.5
    xc = (f.bi[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, None, :] * h[:, None, None]
    yc = (f.bj[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, :, None] * h[:, None, None]
    blob = np.zeros((len(order), bs, bs))
    for (cx, cy, uu) in ((0.42, 0.5, 0.6), (0.58, 0.5, -0.6)):
        blob += uu * np.exp(-((xc - cx) ** 2 + (yc - cy) ** 2)
                            / (2.0 * r ** 2))
    vel[order, 0] = blob
    vel[order, 1] = 0.0
    f.fields["vel"] = torch.tensor(vel, dtype=torch.float32, device=dev)
    with open(golden) as fh:
        want = json.load(fh)["steps"]
    steps, dcom, duvw = [], 0.0, 0.0
    for i in range(6):
        sim.step_once(dt=0.008)
        bodies = [[s.com[0], s.com[1], s.u, s.v, s.omega]
                  for s in sim.shapes]
        steps.append(bodies)
        for b, w in zip(bodies, want[i]["bodies"]):
            dcom = max(dcom, abs(b[0] - w["com"][0]), abs(b[1] - w["com"][1]))
            duvw = max(duvw, abs(b[2] - w["u"]), abs(b[3] - w["v"]),
                       abs(b[4] - w["omega"]))
    u0 = [s[0][2] for s in steps]
    out = {"body0_u": u0, "max_com_diff_from_golden": dcom,
           "max_uvw_diff_from_golden": duvw, "dtype": "float32"}
    print(f"phase 12 collision {json.dumps(out)}", flush=True)
    check(np.isfinite(steps).all(), "collision: non-finite")
    check(u0[0] > 0.1 and u0[1] < -0.01,
          f"collision: body 0 u {u0[:2]} did not flip (> 0.1 to < -0.01)")
    return out


def phase_canonical(dev) -> tuple[dict, dict]:
    """Phase 12: the canonical shaped forest. Returns the runs and the
    launches of the two canonical runs per forest kernel."""
    runs = {"canonical": []}
    seen = {}
    for p in (None, "fas"):
        runs["canonical"].append(run_canonical(
            dev, p, keep=seen if p == "fas" else None))
    launches = {k: sum(r["launches"].get(k, 0) for r in runs["canonical"])
                for k in CANON_KEYS}
    runs["kernels"] = canonical_kernels(seen)
    del seen
    runs["card_vs_cpu"] = [phase_canonical_cpu(dev, "fas"),
                           phase_canonical_cpu(dev, None),
                           phase_canonical_cpu(dev, None, 1e-6, 1e-5,
                                               hold=False)]
    runs["collision"] = phase_collision(dev)
    return runs, launches


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
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                print(f"phase 1 ptxas {stem} {fn}: {line.strip()}",
                      flush=True)
            elif line.startswith("nvcc "):
                print(f"phase 1 {stem}.cu: {line}", flush=True)

    res = phase_kernels(dev)
    phase_halo_kernels(dev, res)
    phase_bc_kernels(dev, res)
    t0 = time.perf_counter()
    phase_bf16_kernels(dev, res)
    print(f"phase 2 bf16 forms took {time.perf_counter() - t0} s",
          flush=True)
    t0 = time.perf_counter()
    phase_split_bc_kernels(dev, res)
    print(f"phase 2 split boundary-table forms took "
          f"{time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    phase_halo_sweep_levels(dev, res)
    print(f"phase 2 halo sweep levels took {time.perf_counter() - t0} s",
          flush=True)

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

    walled, walled_launches = phase_walled(dev)
    for k, n in walled_launches.items():
        check(n > 0, f"{k}: launched no time on the wall-bounded path")
    launches.update(walled_launches)

    t0 = time.perf_counter()
    bf16_runs, bf16_launches = phase_bf16(dev)
    print(f"phase 9 took {time.perf_counter() - t0} s", flush=True)
    for k, n in bf16_launches.items():
        check(n > 0, f"{k}: launched no time on the bf16 main path")
    launches.update(bf16_launches)

    t0 = time.perf_counter()
    split_walled, split_walled_launches = phase_split_walled(dev)
    print(f"phase 10 took {time.perf_counter() - t0} s", flush=True)
    for k, n in split_walled_launches.items():
        check(n > 0, f"{k}: launched no time on the split wall-bounded "
              "path")
    launches.update(split_walled_launches)

    t0 = time.perf_counter()
    shaped, shaped_launches = phase_shaped(dev)
    print(f"phase 11 took {time.perf_counter() - t0} s", flush=True)
    for k, n in shaped_launches.items():
        check(n > 0, f"{k}: launched no time on the flagship step")

    t0 = time.perf_counter()
    canon, canon_launches = phase_canonical(dev)
    print(f"phase 12 took {time.perf_counter() - t0} s", flush=True)
    for k, n in canon_launches.items():
        check(n > 0, f"{k}: launched no time on the canonical forest")
    check("jax" not in sys.modules, "the smoke imported jax")
    check("validation" not in sys.modules, "the smoke imported validation")

    kernels = [dict(name=k, route="cuda", source=hk.SOURCES[hk.kernel_of(k)],
                    replaces=hk.REPLACES[hk.kernel_of(k)],
                    launches=launches[k],
                    max_abs_err=res[k]["max_abs_err"], ms=res[k]["ms"],
                    plain_ms=res[k]["plain_ms"], bound_ms=res[k]["bound_ms"],
                    bound_by=res[k]["bound_by"],
                    library_ms=res[k].get("library_ms"),
                    on_main_path=k != "advect_diffuse_rhs",
                    flagship_launches=shaped_launches.get(k, 0),
                    flagship=shaped["kernels"].get(k),
                    canonical_launches=canon_launches.get(k, 0),
                    canonical=canon["kernels"].get(k))
               for k in hk.launches]
    print(f"main path summary: {json.dumps(runs)}")
    print(f"forest main path summary: {json.dumps(forest_runs)}")
    print(f"sharded main path summary: {json.dumps(sharded)}")
    print(f"wall-bounded main path summary: {json.dumps(walled)}")
    print(f"bf16 main path summary: {json.dumps(bf16_runs)}")
    print(f"split wall-bounded main path summary: "
          f"{json.dumps(split_walled)}")
    print(f"flagship step summary: {json.dumps(shaped)}")
    print(f"canonical shaped forest summary: {json.dumps(canon)}")
    print(f"total {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
