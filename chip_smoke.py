#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cup2d_tpu_torch``) on one
NVIDIA card. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one output line or more each; any failure exits non-zero before
the result lines:

1. build the ten Hopper kernel sources from ``cup2d_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, in parallel; ``tridiag.cu`` and
   ``group_sum.cu`` among them) and
   print the card and every instance's registers and spills;
2. each kernel against its plain PyTorch twin on the card, f32, with the
   bounds stated below (the forest lab RHS per h class, at the path's nu
   and at a diffusion-dominated nu = 1; at 128, 10,529 (the forest main
   path's count) and 16,384 blocks, its bound at the face-sharing
   operation count of its inputs beside the per-cell count), plus kernel
   and twin times (CUDA events) and, for the block-Jacobi update (at 1,
   1000 and 16384 blocks), the time of ``torch.addmm``; the sweep chain at every level of
   the 8192^2 V-cycle hierarchy with the chains a cycle launches there
   (graph replays: ms, bound and launches per level and per cycle);
   ``group_sum.cu`` bit for bit its twin at 1, 8, 256 and 1,024 groups
   (the forest's dot into f64 partials, an f32 and an f64 sum) and timed
   at the forest's [16384, 8, 8] beside ``torch.sum``, and kernel 8's
   preconditioner forms, P_inv r beside ``torch.mm`` and e + P_inv r
   beside ``torch.addmm``; the
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
   block-Jacobi launch per production FAS cycle and one per P_inv r,
   which both solvers apply through kernel 8; group partials launched).
   The default run is made twice from the same state and must repeat
   itself bit for bit; the lab RHS is timed on the fas run's own labs
   (its last call), with the reconstructions per cell and component the
   face sharing needs there. Then the default solver's two-level
   production: one production step from the cold pressure (its solve
   takes > 15 iterations and engages the trigger) and 5 timed steps,
   each application of the additive M one launch of kernel 8's E form
   (``+pinv+e`` launches = the steps' preconditioner cycles);
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
   timed (one under the default solver, whose channel solve never
   converges at f32: ~4.7 s a step), the launch counts set to 0 before
   each run and read after it
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
   velocity for 3 steps under both solvers on the card against the CPU's
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
   ``step_once`` steps at the CFL dt, one warm-up and two timed, the
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
   default solver and under CUP2D_POIS=fas (each run makes its own
   startup: the exact solves' preconditioner follows the latch, the bf16
   cycle under the default solver and the f32 cycle with the fused
   smoother under fas), each step timed on the host
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
   production steps (fas from a copy of the default run at step 10: the
   startup solves are the same exact Krylov solves under either latch;
   the card-vs-CPU runs below share one startup the same way), each
   timed on the host clock to a synchronize with
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
   it, not held: the default solver at 1e-6/1e-5, 1 production step,
   which does not converge on the shaped RHS); and the two-disk collision
   of
   validation/golden_collision.py at f32 (body 0's u flips from > 0.1 to
   < -0.01 across steps 0 -> 1; the largest difference from
   tests/golden_collision.json printed).
13. the periodic tables and the FFT direct solve: the wrap forms of
   kernels 2, 5 and 6 against their twins at 8192^2 on the doubly-periodic
   box and the periodic channel (pd,pd,ns,ns): the substage pair on the
   benchmark velocity <= 2e-6 relative, the correction <= 5e-6, the chain
   at n = 2 and the 24-sweep chain on an 8^2 level <= 2e-6 relative; the
   batched Thomas scans (``tridiag.cu``) at [1, 8192, 4097] on the
   channel's plan and its own cold right-hand side, <= 2e-6 relative (its
   ulps printed), beside the rfft + irfft pair around it; each with kernel
   and twin ms and its bound. Then the main path: ``cases.make_sim(
   "tgv_periodic")`` at level 10 (8192^2, f32) under the default solver,
   fas and fftd, 1 startup and 5 production steps each, and the periodic
   channel at 8192^2 from the benchmark velocity (dt = h/2, production)
   under fftd and fas, a warm-up and 3 timed steps: ms per step,
   iterations, launches per form from 0, every launch of kernels 2, 5 and
   6 a wrap form (``+pd``), the Thomas scans on the channel under fftd
   only, ``kernel_tier`` ``hopper+bc(pd,pd,pd,pd)``, and no plain twin
   called on the card's f32 operands; bench.py's fftd_periodic and
   fftd_channel arms (one cold mean-free RHS at 8192^2, converged at the
   production criterion, 1e-3 and 1e-2 relative) under fftd (one
   iteration) and the FAS V and F cycles, ms per solve and fftd's over
   the best FAS arm's; tgv_periodic at 128^2 on the
   card and on the CPU, 10 production steps under fftd and fas (equal
   iterations, velocity within 1e-4 relative); and its KE decay at 128^2
   f32 under fftd to t = 0.1, within 1% of exp(-4 nu k^2 t).
14. the run driver: ``cup2d_tpu_torch.__main__.main`` in process, on the
   card by default. The canonical run (phase 12's run.sh flags, f32,
   levelStart 5, levelMax 8, nothing cut, ``-noSupervise -maxSteps 22
   -checkpointEvery 10`` and a ``-tdump`` under every step's dt, so each
   step dumps the forest), then ``-restart`` from its step-10 checkpoint
   into a second directory: the two held equal bit for bit (every common
   dump's bytes, the ``forces.csv`` rows of steps 11-22 across the step-20
   adapt, each step's ``poisson_iters``, the step-20 checkpoints' fields
   and meta); then the flagship (``entry()``'s two fish at 1024 x 512,
   f32) through its library loop in the same phase (25 ``step_once``
   steps, each to a synchronize) and through the CLI restarted from the
   loop's step-10 checkpoint (steps 11-25, ``CUP2D_TRACE`` over three
   production steps; its startup steps are the loop's), and the catalog's ``-case tgv_periodic`` at 1024^2 for
   4 steps (the uniform driver and its dumps; every substage and
   correction launch a wrap form). Printed: production ms/step (the
   median of ``metrics.jsonl``'s ``wall_ms``, traced steps left out)
   beside phases 11 and 12's library-loop ms/step and the flagship's
   in-phase loop, each with the median host ms of the step's phases and
   the collector's ms a production step; the traced window's span, card
   busy time, idle share and host time blocked on the card a step; dump
   ms and bytes, checkpoint save and load seconds, ``jit_compiles`` after
   step 1 (must be 0), ``device_gets`` per production step,
   ``hbm_peak_bytes`` (the process's peak since the run began, as the
   records read it) beside the run's own peak over what was resident
   when it began, and the launches, from 0 over each CLI run, of kernels
   4 (canonical), 2 and 5 (flagship), each > 0. Its files live under
   build/phase14 and stay for phases 15 and 17; phase 17 removes them.
15. supervised runs: the canonical CLI of phase 14 without
   ``-noSupervise`` (the StepGuard ring, a device snapshot a step), bit
   for bit phase 14's run (every dump's bytes, the ``forces.csv`` rows,
   each step's iterations), its median production ``wall_ms`` beside
   phase 14's and its ``snap_ring_bytes``; ``CUP2D_FAULTS`` drills on it,
   each restarted from phase 14's step-10 checkpoint: ``nan_vel@12``
   (retry, rc 0), ``poisson_giveup@12*2`` (retry, escalate),
   ``nan_vel@12*3`` with a step-11 checkpoint of the run's own (retry,
   escalate, disk restore; then phase 14's last dump, forces rows and
   iterations bit for bit) and with the step-10 checkpoint as the run's
   own (the same events; whether it ends as phase 14's is printed, not
   held: the ladder retries right after the restore, as the reference's
   does, so the run skips the loop's step-10 adapt), ``nan_vel@12*4``
   without one (retry, escalate, abort, rc 1, a post-mortem that loads),
   and ``crash_in_save`` (the
   save dies between its renames; the load from ``.old`` is the step-10
   checkpoint bit for bit); then the lagged verdict where it engages:
   phase 5's forest (after one production step: its cold solve paid
   once) and the 8192^2 ``UniformSim`` (``bench_state``),
   under both solvers, 7 production steps eager and under
   ``StepGuard(snap_every=4)``, two runs in turns (eager, lagged): bit
   for bit (fields, clock, step count), the reads of each
   step (the lagged runs no more in all), host ms a step, ms a step over
   steps 3-6 between two synchronizes, the card's idle share over a
   ``torch.profiler`` window of the last step, the ring's bytes, then
   the first lagged run's anchor restored and 3 steps replayed, bit for
   bit again. The canonical CLI's production medians also come in turns
   (phase 14's, supervised, ``-noSupervise``, supervised; the last two
   restarted from phase 14's step-10 checkpoint). Launches of kernels 2, 4, 5,
   6 and 8 from 0 over the phase, each > 0; no twin called on the card's
   f32 operands. Files under build/phase15, removed at the end.
16. fleets and the serving pool (``fleet.FleetSim``, ``FleetServer``):
   bench.run_fleet's arm (the amplitude-laddered Taylor-Green fleet,
   production steps, 1 warm-up step, one synchronized window of 2, f32)
   at 256^2 with B = 1, 8, 64 and at 1024^2 with B = 1, 8, 32, under the
   default solver and fas: ms a step, member-steps/s and the idle share
   of one ``torch.profiler`` step at each B (no bar). The card bars: B = 1
   bit for bit ``UniformSim`` at 256^2 through 2 steps from step 9 (an
   exact startup solve and a production step), with no more reads; each member of a B = 8 fleet at 1024^2 (the benchmark
   velocity at amplitudes 0.8**m, 2 production steps) within 1e-5
   relative of its solo run with equal iterations, both solvers; a B = 4
   fleet at 64^2, 6 steps from step 6, card against CPU within 1e-4.
   Serving:
   ``main()`` in process, ``-fleet 8 -serve 24`` at 1024^2 (the README's
   fleet flags at ``-level 7``, ``-tend 0.006``: every session admitted
   and retired, three a slot; the pool starts at step ``SERVE_FIRST_STEP``
   = 10, past the exact startup solves), once unfaulted and once under
   ``CUP2D_FAULTS=nan_vel@15*3`` (one eviction): every healthy session's
   checkpoint bit for bit the unfaulted run's, no kernel build from the
   first retirement on, occupancy, admissions, retirements, evictions
   and the pool's ``serving_latency`` percentiles printed; a session
   parked at half its horizon and admitted again from its checkpoint
   bit for bit the straight run (1024^2). The unfaulted run goes twice:
   plain (``-noSpans -noMemLedger``) and observed (``-profile -spansLog
   PATH``: the phase timers, the span timeline and the allocator peaks),
   every session checkpoint and event bit-equal, equal device reads and
   kernel builds over each whole run (``shapes_host.pulls``,
   ``hopper_kernels.build_events``), the profile's throughput line
   printed, and ``post --trace PATH`` writing a ``trace.json`` with the
   admit and retire spans on one track a client. Launches of kernels 2,
   5 and 6 from 0 over the phase, each > 0; no twin called on the card's
   f32 operands. Files under build/phase16, removed at the end.
17. the forest on a mesh and the forest's left-overs, on ``MESH_D`` = 4
   shards of the card (four cards cut to one, as phase 7): (a) phase 5's
   10,529-block forest, after one production step (its cold solve paid
   once), as a ``ShardedAMRSim`` against the same forest
   solo, under the default solver and fas, one adapt and 6 production
   steps each: equal topologies and iterations, velocity and pressure
   within ``SHARDED_REL`` of max |solo|, the lab RHS launched 2 x 4 a
   step and the block-Jacobi update 4 a FAS cycle (from 0 each step),
   both held against their twins on one shard's last operands and timed
   there; ms a step split and solo, the idle share of a traced step, the
   halo bytes of one exchange; (b) ``main(["-device", "cuda:<i>",
   "-mesh", "4", <run.sh flags>])`` supervised, 12 steps with a dump each
   and a step-10 checkpoint: every dump within ``SHARDED_REL`` of phase
   14's unsharded run, the ``-mesh 4`` restart from step 10 bit for bit
   its own run, the restart without ``-mesh`` within ``SHARDED_REL``;
   (c) ``CUP2D_POIS=tables`` on phase 6's forest (card against CPU, ms a
   step against ``structured``), ``CUP2D_PREC=bf16`` with fas on phase
   5's forest (iterations and ms a step against f32 fas) and on phase
   6's (card against CPU within ``BF16_BAND``), ``adapt()`` at phase 5's
   blocks with the C regrid helper against ``_fix_states_py`` (equal
   topologies) and the uniform ``-mesh 4`` CLI path at 1024^2 (4
   production steps restarted from a Taylor-Green step-10 checkpoint).
   No twin called on the card's f32 operands in (a) and (b). Removes
   phase 14's files and its own (build/phase17).
18. periodic tables and fleets on the slab mesh, ``MESH_D`` = 4 slabs of
   the card (four cards cut to one): (a) the y-wrap forms of kernels 3
   and 7 on ``tgv_periodic``'s 8192^2 state and the periodic channel's
   8192 x 2048 (a wall-bounded shear): the split wrap pair over a ring
   exchange against kernel 2's solo wrap pair (<= 1 ulp), each shard's
   substages against their twin (<= 2e-6 relative); the halo sweep's
   y-wrap forms (per shard after a ring exchange, and the slab list with
   ring sources) and, on the channel, the signed forms on the ring,
   against their twins (<= 2e-6 relative) and the split sweep against
   one wrap sweep of the chain kernel (<= 1 ulp), on the finest level, a
   split 64^2 and a gathered 16^2 level (one slab, its own neighbour);
   kernel ms, twin ms and bounds beside the boundary-table forms'; (b)
   ``ShardedUniformSim`` of ``tgv_periodic`` at 8192^2 under the default
   solver and fas and of the periodic channel at 8192 x 2048 under fas,
   each against the solo sim from the same state (a first step, the
   exact startup solve on ``tgv_periodic``, and 3 timed production
   steps): equal iterations, velocity within ``SHARDED_REL``,
   ms a step split and solo, the wrap halo substage launched 2 x 4 a
   step, the y-wrap sweep one launch a sweep and level (fas, doubly
   periodic), no solo kernel; (c) a ``turb2d`` fleet at 1024^2, B = 8,
   unplaced, on member placement (2 a shard) and on spatial placement
   (``member_cells_cap=0``), default and fas: every member within
   ``SHARDED_REL`` of the unplaced fleet with equal per-member
   iterations, member-steps/s beside phase 16's, kernels 2 and 5 once a
   shard (member) or the wrap halo forms (spatial); then ``main(["-case",
   "cavity", "-level", "4", "-fleet", "4", "-mesh", "4", ...])`` against
   the unplaced CLI's dumps (within ``SHARDED_REL``); and a shaped fleet
   (frozen disks, the obstacle terms) of 4 members at 4096 x 2048,
   unplaced and placed by ``auto`` on 4 slabs (spatial: a member is above
   the 2048^2 cap), default and fas, a warm-up and 1 timed production
   step: every member within ``SHARDED_REL`` of the unplaced fleet with
   equal per-member iterations, member-steps/s of both layouts, the
   launches of kernels 3 (two a step and slab), 7 (fas, on the split
   levels and on those gathered onto one slab) and 6 (none: no level of
   the spatial hierarchy runs it) counted from 0 per run. No twin called
   on the card's f32 operands in (b) and (c). Files under build/phase18,
   removed at the end.
19. multi-process runs on ``torch.distributed`` (``parallel.launch``):
   a one-rank NCCL world in this process (NCCL takes no two ranks on one
   card) and its 4-shard world mesh on the card, whose reductions and
   gathers all go through NCCL all-gathers: (a) ``tgv_periodic`` at
   8192^2, default and fas, the exact startup step and 2 production
   steps, bit for bit (state and iterations) the same run on a
   single-controller 4-slab mesh (phase 18 (b)'s run); (b) phase 5's
   forest after its warm-up step (phase 15's start) on 4 shards, an
   adapt and 3 production steps under each solver, bit for bit
   (topology, state, iterations) the
   single-controller run (phase 17's), with the bytes its replicated
   whole work all-gathers a step; (c) a collective ``save_checkpoint`` /
   ``load_checkpoint`` round trip of (b)'s fas run, its arrays, meta and
   shapes bytes equal to the single-controller save and the restore bit
   for bit; (d) phase 18 (c)'s ``turb2d`` fleet (1024^2, B = 8) on the
   world mesh, member placement (2 a shard) and spatial, default and fas,
   a warm-up and 3 steps from the same start, bit for bit (the final
   state, kept on the card, and the per-member iterations) phase 18 (c)'s
   single-controller placed fleets, member-steps/s beside them and the
   bytes all-gathered a step. ms a step of each beside the
   single-controller run's; launches of kernels 3, 4, 7 and 8 from 0
   over (a)-(c) alone and of 2, 3, 5, 6 and 7 over (d)'s world fleets
   alone, each > 0; no twin called on the card's operands; the group
   torn down at the end (files under build/phase19, removed).
20. elastic recovery (``resilience.TopologyGuard``,
   ``StepGuard.elastic_recover``, the mirror tier): ``MESH_D`` = 4 shards
   of the card grouped into 2 simulated hosts, ``miss_k`` 1, from a
   checkpoint at step 10 with the loss at the next boundary, each drill
   bit for bit (state, clock) a fresh 2-shard run restarted from that
   checkpoint to step 12: (a) phase 7's uniform 8192^2 run under both
   solvers loses host 1 (``host_exit``) and resumes from the ring; (b)
   with the mirror on and the host's bytes destroyed (``shard_loss``),
   from the mirror; (c) with the mirrors corrupted first
   (``mirror_corrupt``), one ``mirror_reject`` and the disk rung; (d) 6
   steps with the mirror off, then on, bit-equal with equal device reads,
   the mirror's bytes, its capture's host ms and the step ms each way;
   (e) phase 5's forest after its warm-up (phase 15's start), default
   solver, from the ring, the mirror latched off for its payload. Each
   drill's re-mesh ms; launches of kernels 3, 7, 4, 8 (P_inv r) and
   ``group_sum.cu`` after the re-meshes, each > 0; counts from 0 over the
   phase; no twin called on the card's operands (files under
   build/phase20, removed).
21. lint (``cup2d_tpu_torch.analysis``, the port's graftlint): the
   package linted in process (``lint_package``) and by ``python -m
   cup2d_tpu_torch.analysis --json`` as a subprocess under this
   interpreter; fails on any finding or an rc other than 0; prints the
   files scanned, the findings, the suppressed count per rule and the
   seconds of each run. Launches no kernel.
22. f64 state on the card: (a) the f64 forms of kernels 2 (free-slip,
   the cavity table, the doubly periodic table), 5 and 6 (Neumann,
   signed, wrap) at 8192^2, 4 at [16384, 2, 14, 14] (per h class, nu
   4e-5 and 1) and 8 at [16384, 8, 8] (the update, P, E and tail forms)
   against their twins, <= 1e-12 relative to max |ref|, with kernel ms,
   twin ms, the bound at 8 bytes a value (the FP64 operation bound for 2
   and 4, ``timing.PEAK_F64``) and, for kernel 8, the f64 ``torch.addmm``
   / ``torch.mm``; (b) the 8192^2 benchmark step at f64 and at f32
   under both solvers (a warm-up and 3 timed steps each: ms a step, the
   f64/f32 ratio, iterations, the allocator's peak); (c) ``entry()``'s
   two fish at 1024 x 512 (initialize, 5 production steps a solver) and
   phase 5's forest (2 production steps a solver) at f64; the f64 forms'
   launches counted over (b) and (c), each > 0, and no twin called on an
   f64 card tensor there (the sweep chain's twin watched under fas: the
   default solver's preconditioner cycle is plain code by design); (d)
   the card's f64 runs against the port's CPU f64 runs from one carried
   state, production steps, <= 1e-10 relative with equal iterations:
   ``UniformSim`` at 128^2 (10 steps), the flagship at 512 x 256 (its
   startup on the card) under both solvers, phase 6's 355-block forest
   under both (an adapt after step 2) and the cavity at 128^2 under fas;
   (e) the split step, a spatially placed fleet and fftd at f64 on the
   card refuse, naming ROADMAP.md's note (c), and the bf16 tier with f64
   state refuses as in the JAX package; the CLI runs ``-dtype float64``
   on the forest (levelMax 6) and with ``-level 5``, 2 steps each (files
   under build/phase22, removed). ``--phases 22`` runs it alone (with
   phases 2 and 5, which it draws on).

Then one JSON line of per-kernel numbers (with, per kernel, its launches
on the two flagship runs, the two canonical runs, phase 13's runs,
phase 15's supervised runs, phase 16's fleet runs, phase 17's split
forest runs, phase 18's split periodic and placed fleet runs, phase
19's world runs and phase 20's elastic drills and, for the
flagship's and the canonical run's kernels, their
numbers at those shapes), the card's name and power limit
as nvidia-smi prints them, and the result line
``{"ok": true, "device": {...}}`` last. Needs no network; imports no JAX.

    python3 chip_smoke.py --phases 2,5,13

runs phase 1, the phases named (``a-b`` names a range) and the phases
they draw on (``PHASE_NEEDS``: phase 2's results for 13 and 18, phase
5's forest start for 15, 17, 19 and 20, phase 14's runs for 15); a
phase whose other inputs did not run reports without them. It prints
the per-kernel line if phase 2 ran (launches null for the paths that did
not run) and the result line with the phases it ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
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
from cup2d_tpu_torch import fleet as tfleet  # noqa: E402
from cup2d_tpu_torch.convert import (copy_amr_state,  # noqa: E402
                                     copy_simulation_state,
                                     forest_from_numpy, forest_to_numpy)
from cup2d_tpu_torch.io import whole  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.timing import (OPS_SWEEP_CELL,  # noqa: E402
                                        PEAK_F64, advect_rhs_ops, bound,
                                        cuda_ms, graph_ms,
                                        halo_sweep_level_table,
                                        lab_weno_faces,
                                        substage_ops, substage_pair_bytes,
                                        sweep_bytes, sweep_level_table,
                                        vcycle_chains, weno_faces)
from cup2d_tpu_torch.ops.stencil import (inv_diag_bc,  # noqa: E402
                                         inv_diag_bc_slab, pad_vector)
from cup2d_tpu_torch.parallel import shard_halo as tsh  # noqa: E402
from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh)
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    Slabs, exchange_x, fused_advect_heun_sharded, gather_x,
    overlap_jacobi_sweeps, split_x, sweep_stats)
from cup2d_tpu_torch import poisson as tpoisson  # noqa: E402
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
              "advect_diffuse_rhs": 1.940,
              # kernel 8 with zero e and lap (kernel_ab times it and the
              # separate add of the E form's composition in turns)
              "fused_block_jacobi_update+pinv": 0.00829,
              "tridiag_scan": 0.884}

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
    phase_precond_and_partials(dev, res, rn, p_inv)
    return res


def phase_precond_and_partials(dev, res, rn, p_inv, n: int = 16384) -> None:
    """Phase 2, the forest's reductions and preconditioner at the phase-5
    forest's 16384 blocks. Kernel 8's P form (P_inv r, ``hk.block_precond``)
    and E form (e + P_inv r, the additive two-level preconditioner)
    against their twins, timed (6 operand sets by graph replay); library:
    one mm and one addmm, TF32 off; bound: the operands read, the result
    written, and the 64 x 64 product's operations. ``group_sum.cu``: bit
    for bit its twin at 1, 8, 256 and 1,024 groups of 16 blocks (1,024
    values a group) of the dot (f32 products, f64 partials), the f32 sum
    and the f64 sum of the energy's [N, 2, 8, 8]; the dot timed at 1,024
    groups; library: ``torch.sum(a * c, dtype=torch.float64)``; bound:
    both operands read once, the partials written."""
    sets = [(rn(n, 8, 8), rn(n, 8, 8)) for _ in range(6)]
    pt = p_inv.T
    forms = (
        ("fused_block_jacobi_update+pinv", "P_inv r", 2,
         lambda e, r: hk.block_precond(r, p_inv),
         lambda e, r: hk.block_precond_form_plain(r, p_inv),
         lambda e, r: torch.mm(r.reshape(n, 64), pt), "mm"),
        ("fused_block_jacobi_update+pinv+e", "e + P_inv r", 3,
         lambda e, r: hk.block_precond(r, p_inv, e),
         lambda e, r: hk.block_precond_form_plain(r, p_inv, e),
         lambda e, r: torch.addmm(e.reshape(n, 64), r.reshape(n, 64), pt),
         "addmm"))
    for key, form, streams, kern, twin, lib, lib_name in forms:
        got, ref = kern(*sets[0]), twin(*sets[0])
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(rel <= BLOCK_JACOBI_REL, f"block_precond {form} [{n},8,8]: "
              f"rel {rel} > {BLOCK_JACOBI_REL}")
        ms = graph_ms([lambda o=o: kern(*o) for o in sets])
        pms = graph_ms([lambda o=o: twin(*o) for o in sets])
        lms = graph_ms([lambda o=o: lib(*o) for o in sets])
        b = bound(streams * 4 * 64 * n + 4 * 64 * 64,
                  (2 * 64 + streams - 2) * 64 * n)
        res[key].update(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
                        bound_by=b[1], library_ms=lms)
        earlier = (f" (earlier design {EARLIER_MS[key]})"
                   if key in EARLIER_MS else "")
        print(f"phase 2 block_precond {form} [{n},8,8] (kernel 8, "
              f"{streams} streams): max_abs_err {err} (rel {rel}) kernel_ms "
              f"{ms}{earlier} twin_ms {pms} {lib_name}_ms {lms} bound_ms "
              f"{b[0]} ({b[1]})", flush=True)
        del got, ref
    del sets

    a, c = rn(n, 8, 8), rn(n, 8, 8)
    e64 = rn(n, 2, 8, 8).double()
    gerr = 0.0
    for G in (1, 8, 256, 1024):
        x = a[:16 * G].reshape(G, 1024)
        y = c[:16 * G].reshape(G, 1024)
        z = e64[:16 * G].reshape(G, 2048)
        for form, args, acc in (("dot", (x, y), torch.float64),
                                ("f32 sum", (x, None), torch.float32),
                                ("f64 sum", (z, None), torch.float64)):
            got = hk.group_sum(*args, acc)
            ref = hk.group_sum_plain(*args, acc)
            same = bool(torch.equal(got, ref))
            gerr = max(gerr, float((got - ref).abs().max()))
            print(f"phase 2 group_sum {form} G={G}: bit for bit the twin "
                  f"{same}", flush=True)
            check(same, f"group_sum {form} at {G} groups differs from its "
                  "twin")
    x, y = a.reshape(1024, 1024), c.reshape(1024, 1024)
    got = hk.group_sum(x, y, torch.float64)
    lib = torch.sum(a * c, dtype=torch.float64)
    lib_err = float((torch.sum(got) - lib).abs())
    ops = [(u.reshape(1024, 1024), w.reshape(1024, 1024))
           for u, w in ((rn(n, 8, 8), rn(n, 8, 8)) for _ in range(4))]
    ms = graph_ms([lambda o=o: hk.group_sum(*o, torch.float64)
                   for o in ops])
    pms = graph_ms([lambda o=o: hk.group_sum_plain(*o, torch.float64)
                    for o in ops], reps=6)
    lms = graph_ms([lambda o=o: torch.sum(o[0] * o[1], dtype=torch.float64)
                    for o in ops])
    b = bound(2 * 4 * 64 * n + 8 * 1024, 2 * 64 * n)
    res["group_sum"].update(max_abs_err=gerr, ms=ms, plain_ms=pms,
                            bound_ms=b[0], bound_by=b[1], library_ms=lms)
    print(f"phase 2 group_sum dot [{n},8,8] f32 -> 1024 f64 partials: "
          f"max_abs_err against the twin {gerr}, |sum of partials - "
          f"torch.sum| {lib_err} kernel_ms {ms} twin_ms "
          f"{pms} library_ms {lms} bound_ms {b[0]} ({b[1]})", flush=True)
    del a, c, e64, ops, got


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


# the forest's kernels: the lab RHS, block-Jacobi (its preconditioner
# forms too) and the group partials; phase 5 also counts the E form, which
# its default runs' two-level steps launch
FOREST_KEYS = ("fused_lab_rhs", "fused_block_jacobi_update",
               "fused_block_jacobi_update+pinv", "group_sum")
PINV_E = "fused_block_jacobi_update+pinv+e"


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
    launches = {k: hk.launches[k] for k in FOREST_KEYS + (PINV_E,)}
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
    pinv = launches["fused_block_jacobi_update+pinv"]
    check(launches["fused_block_jacobi_update"] == fas_cycles + pinv
          and pinv > 0, f"forest {label}: block-Jacobi launches {launches}"
          f" != {fas_cycles} (one per production FAS cycle) + the P_inv r "
          "launches (> 0)")
    check(launches["group_sum"] > 0, f"forest {label}: no group_sum launch")
    return out


def run_forest_twolevel(sim, steps: int = 5) -> dict:
    """The default solver's two-level production steps: one production
    step from the cold pressure (its solve, > 15 iterations, engages the
    trigger), then ``steps`` timed ones, each applying the additive M,
    kernel 8's E form, once a preconditioner application; counts from 0."""
    dev = sim.device
    hk.reset_launches()
    sim.step_count = 10
    sync(dev)
    t0 = time.perf_counter()
    d = sim.step_once()
    sync(dev)
    cold = {"ms": (time.perf_counter() - t0) * 1e3,
            "iters": d["poisson_iters"], "mode_after": sim.poisson_mode}
    times, iters, cycles = [], [], []
    for k in range(steps):
        t0 = time.perf_counter()
        d = sim.step_once()
        sync(dev)
        times.append(time.perf_counter() - t0)
        iters.append(d["poisson_iters"])
        cycles.append(d["precond_cycles"])
        check(d["finite"], f"forest two-level: non-finite state at step {k}")
    launches = {k: hk.launches[k] for k in FOREST_KEYS + (PINV_E,)}
    out = {"mode": sim.poisson_mode, "blocks": len(sim.forest.blocks),
           "cold_step": cold, "ms_per_step": sum(times) / steps * 1e3,
           "iters": iters, "precond_cycles": cycles, "launches": launches}
    print(f"phase 5 forest default two-level {json.dumps(out)}", flush=True)
    check(sim.poisson_mode == "bicgstab+twolevel" and cold["iters"] > 15,
          f"forest two-level: the cold step took {cold['iters']} "
          f"iterations, mode {sim.poisson_mode}")
    check(launches[PINV_E] == sum(cycles) > 0
          and launches["fused_block_jacobi_update"]
          == launches["fused_block_jacobi_update+pinv"],
          f"forest two-level: kernel 8 launches {launches} against "
          f"{sum(cycles)} additive M applications (one E form each)")
    return out


def phase_forest(dev, target=FOREST_TARGET, **kw
                 ) -> tuple[list, dict, tuple]:
    """Phase 5: the forest main path under both solvers, and the default
    solver's two-level production steps. Returns the runs,
    the forest kernels' launch counts summed over them and the adapted
    forest's (config, (blocks, fields)) on the host, phase 15's start."""
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
    runs.append(run_forest_twolevel(fresh()))
    total = {k: sum(r["launches"][k] for r in runs)
             for k in runs[0]["launches"]}
    return runs, total, (cfg, snap)


def warm_forest(dev, forest_start: tuple) -> tuple:
    """Phase 5's forest after one production step of the default solver,
    its cold solve from zero pressure paid once: the start of the
    production runs of phases 15 and 17."""
    cfg, snap = forest_start
    sim = AMRSim(cfg, shapes=[], device=dev)
    forest_from_numpy(sim, *snap)
    sim.step_count = 10
    sim.step_once()
    return cfg, forest_to_numpy(sim)


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


def phase_forest_cpu(dev, pois=None, bar=TRAJ_REL, **kw):
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
    print(f"phase 6 multilevel forest {card.poisson_mode} "
          f"({card._pois_mode}, {card.smoother_tier}) tol "
          f"{card.cfg.poisson_tol}/{card.cfg.poisson_tol_rel} {len(kp)} "
          f"blocks x5 steps: card iters {iters['card']} cpu iters "
          f"{iters['cpu']} vel rel Linf {rel}", flush=True)
    check(bool(torch.isfinite(a).all()), "multilevel: non-finite state")
    check(rel <= bar, f"multilevel: card vs CPU {rel} > {bar}")


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
    # the default solver's steps are long (the channel's f32 solve never
    # converges: 121-200 iterations, ~4.7 s a step): a warm-up and 1 timed
    runs = [run_walled(dev, kind, pois, level, steps=5 if pois else 1)
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
    runs = [run_split_walled(dev, "cavity", p, 10, steps=2)
            for p in ("", "fas")]
    runs.append(run_split_walled(dev, "channel", "fas", 8, steps=2))
    total = {k: sum(r["sharded"]["launches"].get(k, 0) for r in runs)
             for k in ("advect_substage_halo+bc", "jacobi_halo_sweep+bc")}
    return runs, total


def phase_bf16_trajectory(dev, pois: str, steps: int = 3) -> None:
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
CANON_KEYS = FOREST_KEYS
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


def run_canonical(dev, pois=None, keep=None, start=None) -> tuple:
    """Phase 12 under one solver: ``initialize()`` (host seconds), then
    ``run()``'s schedule (an ``adapt()`` before each of steps 0-10, then
    every 20) for 10 exact startup steps and 10 production steps, each
    step timed on the host clock to a synchronize, with its phases' host
    ms; launch counts from 0 over the steps and their adapts. ``start``:
    a sim at step 10 (the startup solves are the same exact Krylov solves
    under every latch), whose state is taken instead
    (``convert.copy_amr_state``), so only the production steps run.
    Returns the figures and (without ``start``) a copy at step 10."""
    label = f"canonical {pois or 'default'}"
    sim = canonical_sim(dev, pois)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if start is None:
        sim.initialize()
    else:
        copy_amr_state(start, sim)
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
           "startup_shared": start is not None,
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
    at10 = None
    try:
        for k in range(20 if start is None else 10):
            row = {"step": sim.step_count}
            if sim.step_count == 10 and start is None:
                at10 = canonical_sim(dev, None)
                copy_amr_state(sim, at10)
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
    prod = [r for r in rows if r["step"] >= 10]
    for name, part in (("startup", rows[:-len(prod)]), ("production", prod)):
        n = len(part)
        if not n:
            continue
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
    fas_cycles = sum(r["iters"] for r in prod) if pois == "fas" else 0
    check(la.get("fused_block_jacobi_update", 0)
          == fas_cycles + la.get("fused_block_jacobi_update+pinv", 0),
          f"{label}: block-Jacobi launches {la} != {fas_cycles} (one per "
          "production FAS cycle) + the P_inv r launches")
    check(la.get("group_sum", 0) > 0, f"{label}: no group_sum launch")
    check(not any(hk.kernel_of(k) in NOT_FOREST for k in la),
          f"{label}: launches of a uniform or split kernel {la}")
    if keep is not None:
        keep.update(seen)
    return out, at10


def canonical_kernels(seen: dict, label: str = "phase 12") -> dict:
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
        print(f"{label} kernel {k} on the run's operands: "
              f"{json.dumps(o)}", flush=True)
    return out


def _ordered_fields(sim) -> tuple[list, dict]:
    fields = sim.fields()
    f = sim.forest
    order = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in order]
    idx = torch.as_tensor(order, dtype=torch.long, device=sim.device)
    return keys, {k: v[idx].cpu() for k, v in fields.items()}


def canonical_startup(dev, tol=1e-3, rel=1e-2) -> AMRSim:
    """Phase 12's card-vs-CPU start: the canonical case at
    ``CANON_CPU_LEVELS`` on the card after ``initialize()`` and its 10
    startup steps (exact solves, the same under every solver latch)."""
    lm, ls = CANON_CPU_LEVELS
    card = canonical_sim(dev, None, level_max=lm, level_start=ls, tol=tol,
                         rel=rel)
    card.initialize()
    for _ in range(10):
        if card.step_count <= 10:
            card.adapt()
        card.step_once()
    return card


def phase_canonical_cpu(dev, pois=None, tol=1e-3, rel=1e-2,
                        hold=True, start=None, steps=5) -> dict:
    """Phase 12, continued: the canonical case at levelMax 6, levelStart 3,
    f32, on the card and on the CPU from the card's state after its
    ``initialize()`` and 10 startup steps (``convert.copy_amr_state``),
    ``steps`` (5) production steps each with an ``adapt()`` after the
    second: equal
    block key sets and, with ``hold``, equal iterations, velocity within
    TRAJ_REL relative and each fish's (u, v, omega) within TRAJ_REL of
    its largest component. (At levelMax 5 no cell of either fish reaches
    chi 0.5 and uvw is 0 on both devices.) Without ``hold`` the numbers
    are printed and only finiteness is checked: under the default solver
    at tolerances 1e-6/1e-5 BiCGSTAB does not converge on the shaped RHS,
    which is not mean-free (121-321 iterations a step), and the devices
    part as the packages do (ROADMAP queue 3). ``start``: a
    ``canonical_startup`` sim at the same tolerances, shared by the
    solvers (its startup steps are theirs)."""
    lm, ls = CANON_CPU_LEVELS
    label = f"canonical card vs CPU {pois or 'default'} {tol}/{rel}"
    if start is None:
        start = canonical_startup(dev, tol, rel)
    card = canonical_sim(dev, pois, level_max=lm, level_start=ls, tol=tol,
                         rel=rel)
    cpu = canonical_sim("cpu", pois, level_max=lm, level_start=ls, tol=tol,
                        rel=rel)
    copy_amr_state(start, card)
    copy_amr_state(card, cpu)
    iters = {"card": [], "cpu": []}
    for k in range(steps):
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
    start = None
    for p in (None, "fas"):
        # fas starts from the default run's copy at step 10
        out, start = run_canonical(dev, p, keep=seen if p == "fas" else None,
                                   start=start)
        runs["canonical"].append(out)
    del start
    launches = {k: sum(r["launches"].get(k, 0) for r in runs["canonical"])
                for k in CANON_KEYS}
    runs["kernels"] = canonical_kernels(seen)
    del seen
    t0 = time.perf_counter()
    start = canonical_startup(dev)
    runs["card_vs_cpu"] = [phase_canonical_cpu(dev, "fas", start=start),
                           phase_canonical_cpu(dev, None, start=start),
                           phase_canonical_cpu(dev, None, 1e-6, 1e-5,
                                               hold=False, steps=1)]
    del start
    print(f"phase 12 card vs CPU took {time.perf_counter() - t0} s",
          flush=True)
    runs["collision"] = phase_collision(dev)
    return runs, launches


# phase 13: the periodic tables and the FFT direct solve
PERIODIC_TABLES = {"doubly": cases.periodic_table(),
                   "channel": cases.periodic_channel_table()}
PERIODIC_LEVEL = 10        # tgv_periodic at 8192^2
PERIODIC_CPU_LEVEL = 4     # 128^2: card against CPU, the KE decay
KE_BAR = 0.01              # the JAX package's tgv_periodic decay bar
TRIDIAG_REL = 2e-6         # the Thomas scans, relative to max |ref|
PERIODIC_KEYS = ("fused_advect_heun+pd", "fused_correction+pd",
                 "fused_jacobi_sweeps+pd", "tridiag_scan")
# the twins a periodic step on the card must not call on f32 or complex64
# operands (the default solver's bf16 preconditioner cycle runs
# jacobi_sweeps_plain on bf16 legs by design: that is plain code, not a
# twin standing in for a kernel)
TWINS = ("advect_substage_plain", "fused_correction_plain",
         "jacobi_sweeps_plain", "tridiag_scan_plain")


class twin_watch:
    """Count calls of the kernels' plain twins on CUDA operands of
    ``dtypes`` (f32 / complex64 by default) while the block runs (``hk``,
    ``poisson`` and ``shard_halo`` hold them)."""

    def __init__(self, names=TWINS,
                 dtypes=(torch.float32, torch.complex64)):
        self.names = names
        self.dtypes = dtypes
        self.calls = {k: 0 for k in names}

    def __enter__(self):
        import cup2d_tpu_torch.poisson as tpois
        self.saved = []
        for mod in (hk, tpois, tsh):
            for name in self.names:
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self.saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kw):
            t = next((a for a in args if torch.is_tensor(a)), None)
            if (t is not None and t.device.type == "cuda"
                    and t.dtype in self.dtypes):
                self.calls[name] += 1
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_periodic_kernels(dev, res, size: int = 8192) -> None:
    """Phase 13: the wrap forms of kernels 2, 5 and 6 and the Thomas scans
    against their twins at size^2 on the doubly-periodic box and the
    periodic channel (the substage pair on the benchmark velocity; the
    correction and the chains on unit-scale operands; the 24-sweep chain
    on the 8^2 level too), kernel and twin ms, bounds; ``res`` gets the
    four entries (the doubly-periodic box's numbers for the forms, the
    channel's plan for the scans)."""
    cells = size * size
    g = bench_grid(size, size, dev)
    h = g.h
    v = bench_start(g).vel[None].contiguous()
    dt = torch.tensor([0.5], device=dev) * h
    err = 0.0
    for name, table in PERIODIC_TABLES.items():
        got = hk.fused_advect_heun(v, h, 4e-5, dt, bc=table)
        ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt, bc=table)
        e = float((got - ref).abs().max())
        rel = e / float(ref.abs().max())
        del got, ref
        print(f"phase 13 fused_advect_heun+pd {name} [1,2,{size},{size}] "
              f"both substages: max_abs_err {e} (rel {rel})", flush=True)
        check(rel <= HEUN_ABS, f"fused_advect_heun+pd {name}: rel {rel} > "
              f"{HEUN_ABS}")
        err = max(err, e)
        ms = cuda_ms(lambda: hk.fused_advect_heun(v, h, 4e-5, dt,
                                                  bc=table), 10)
        pms = cuda_ms(lambda: hk.fused_advect_heun_plain(v, h, 4e-5, dt,
                                                         bc=table), 2)
        facs = hk._substage_facs(dt, h, 4e-5, (1,), 1, torch.float32, dev,
                                 with_dt=True)
        v1 = hk.advect_substage(v, None, facs, 0.5, 1.0 / h ** 2, table, h)
        b = bound(40.0 * cells, substage_ops(v) + substage_ops(v1))
        del v1
        print(f"phase 13 fused_advect_heun+pd {name}: kernel_ms {ms} "
              f"(free-slip {res['fused_advect_heun']['ms']}, BC form "
              f"{res['fused_advect_heun+bc']['ms']}) twin_ms {pms} bound_ms "
              f"{b[0]} ({b[1]})", flush=True)
        if name == "doubly":
            res["fused_advect_heun+pd"].update(
                ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                library_ms=None)
    res["fused_advect_heun+pd"]["max_abs_err"] = err
    del v
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(13)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x, p, vel = rn(1, size, size), rn(1, size, size), rn(1, 2, size, size)
    scal = torch.stack([x.mean(), p.mean(),
                        torch.tensor(-0.25 * h * h, device=dev)]
                       ).reshape(1, 3).contiguous()
    err = 0.0
    for name, table in PERIODIC_TABLES.items():
        sg, pa = tbc.pressure_signs(table), tbc.periodic_axes(table)
        got = hk.fused_correction(x, p, vel, scal, 1.0 / (h * h), sg)
        ref = hk.fused_correction_plain(x, p, vel, scal, 1.0 / (h * h), sg,
                                        pa)
        e = max(float((a - c).abs().max()) for a, c in zip(got, ref))
        del got, ref
        check(e <= CORRECTION_ABS, f"fused_correction+pd {name}: {e} > "
              f"{CORRECTION_ABS}")
        err = max(err, e)
        ms = cuda_ms(lambda: hk.fused_correction(
            x, p, vel, scal, 1.0 / (h * h), sg), 10)
        pms = cuda_ms(lambda: hk.fused_correction_plain(
            x, p, vel, scal, 1.0 / (h * h), sg, pa), 3)
        b = bound(28.0 * cells, OPS_CORRECTION_CELL * cells)
        print(f"phase 13 fused_correction+pd {name} [1,{size},{size}]: "
              f"max_abs_err {e} kernel_ms {ms} (Neumann "
              f"{res['fused_correction']['ms']}) twin_ms {pms} bound_ms "
              f"{b[0]} ({b[1]})", flush=True)
        if name == "doubly":
            res["fused_correction+pd"].update(
                ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                library_ms=None)
    res["fused_correction+pd"]["max_abs_err"] = err
    del x, p, vel

    err = 0.0
    for ny, n, reps in ((size, 2, 10), (8, 24, 10)):
        e, r = rn(ny, ny), rn(ny, ny)
        for name, table in PERIODIC_TABLES.items():
            sg, pa = tbc.pressure_signs(table), tbc.periodic_axes(table)
            for fz in (False, True):
                got = hk.fused_jacobi_sweeps(e, r, 0.8, n, fz, sg)
                ref = hk.jacobi_sweeps_plain(e, r, 0.8, n, fz, sg, pa)
                d = float((got - ref).abs().max())
                rel = d / float(ref.abs().max())
                del got, ref
                check(rel <= JACOBI_REL, f"fused_jacobi_sweeps+pd {name} "
                      f"{ny}^2 n={n} from_zero={fz}: rel {rel} > "
                      f"{JACOBI_REL}")
                err = max(err, d)
                ms = cuda_ms(lambda: hk.fused_jacobi_sweeps(
                    e, r, 0.8, n, fz, sg), reps)
                print(f"phase 13 fused_jacobi_sweeps+pd {name} [{ny},{ny}] "
                      f"n={n} from_zero={fz}: max_abs_err {d} (rel {rel}) "
                      f"kernel_ms {ms}", flush=True)
                if ny == size and not fz and name == "doubly":
                    pms = cuda_ms(lambda: hk.jacobi_sweeps_plain(
                        e, r, 0.8, n, fz, sg, pa), 2)
                    b = bound(12.0 * cells, OPS_SWEEP_CELL * n * cells)
                    res["fused_jacobi_sweeps+pd"].update(
                        ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                        library_ms=None)
                    print(f"phase 13 fused_jacobi_sweeps+pd n=2: kernel_ms "
                          f"{ms} (Neumann {res['fused_jacobi_sweeps']['ms']}"
                          f") twin_ms {pms} bound_ms {b[0]} ({b[1]})",
                          flush=True)
        del e, r
    res["fused_jacobi_sweeps+pd"]["max_abs_err"] = err
    inv_diag_bc.cache_clear()

    # the Thomas scans on the periodic channel's plan and its own rfft'd
    # cold right-hand side
    table = PERIODIC_TABLES["channel"]
    plan = tpoisson.FFTDiagPlan(size, size, torch.float32,
                                *tbc.periodic_axes(table),
                                tbc.pressure_signs(table), device=dev)
    gc = UniformGrid(bench_cfg(size, size)[0], level=g.level, device=dev,
                     bc=table)
    st = bench_start(gc)
    rhs = gc.poisson_rhs(st.vel, None, None, dt[0])
    rhs = rhs - rhs.mean()
    bh = torch.fft.rfft(rhs, dim=-1)[None].contiguous()
    del st, rhs
    got = hk.tridiag_scan(bh, plan.inv_denom, plan.cp)
    ref = hk.tridiag_scan_plain(bh, plan.inv_denom, plan.cp)
    gr, rr = torch.view_as_real(got), torch.view_as_real(ref)
    e = float((gr - rr).abs().max())
    rel = e / float(rr.abs().max())
    u = ulps(gr.contiguous(), rr.contiguous())
    del got, ref, gr, rr
    print(f"phase 13 tridiag_scan {list(bh.shape)}: max_abs_err {e} (rel "
          f"{rel}; {u} ulp)", flush=True)
    check(rel <= TRIDIAG_REL, f"tridiag_scan: rel {rel} > {TRIDIAG_REL}")
    ms = cuda_ms(lambda: hk.tridiag_scan(bh, plan.inv_denom, plan.cp), 10)
    pms = cuda_ms(lambda: hk.tridiag_scan_plain(bh, plan.inv_denom,
                                                plan.cp), 1)
    # the function's bytes: b read and x written (8 each per member, row
    # and mode), the two f32 coefficients read once; the Thomas design's
    # own adds dp's write and read-back (16 more per member, row and mode)
    L, n_s, nk = bh.shape
    b = bound(16.0 * L * n_s * nk + 8.0 * n_s * nk, 8.0 * L * n_s * nk)
    b_thomas = bound(32.0 * L * n_s * nk + 8.0 * n_s * nk,
                     8.0 * L * n_s * nk)
    xr = torch.randn(size, size, generator=gen, device=dev)
    fft_ms = cuda_ms(lambda: torch.fft.irfft(torch.fft.rfft(xr, dim=-1),
                                             n=size, dim=-1), 10)
    print(f"phase 13 tridiag_scan {list(bh.shape)}: kernel_ms {ms} "
          f"(earlier design {EARLIER_MS['tridiag_scan']}) twin_ms "
          f"{pms} bound_ms {b[0]} ({b[1]}; the Thomas design's own bytes, "
          f"dp written and read back: {b_thomas[0]}); library: none (no "
          f"PyTorch call "
          f"solves batched tridiagonal systems); the rfft + irfft pair "
          f"around it {fft_ms} ms", flush=True)
    res["tridiag_scan"].update(max_abs_err=e, ulps=u, ms=ms, plain_ms=pms,
                               bound_ms=b[0], bound_by=b[1],
                               library_ms=None, fft_ms=fft_ms)
    del bh, xr, plan, gc
    torch.cuda.empty_cache()


def run_periodic(dev, pois: str, level: int = PERIODIC_LEVEL) -> dict:
    """Phase 13's main path under one solver: ``cases.make_sim(
    "tgv_periodic")`` at level 10 (8192^2, f32), 1 startup step (an exact
    solve) and 5 production ones, each group timed; the launch counts
    from 0 and the twins watched over the 6 steps."""
    with latched(pois):
        sim = cases.make_sim("tgv_periodic", level=level, device=dev)
    check(sim.kernel_tier == "hopper+bc(pd,pd,pd,pd)",
          f"tgv_periodic: kernel_tier {sim.kernel_tier}")
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launches()
    out = {"case": "tgv_periodic", "mode": sim.poisson_mode,
           "tier": sim.kernel_tier, "shape": [sim.grid.ny, sim.grid.nx]}
    with twin_watch() as tw:
        for label, n in (("startup", 1), ("production", 5)):
            if label == "production":
                sim.step_count = 10
            iters = []
            t0 = time.perf_counter()
            for _ in range(n):
                d = sim.step_once()
                iters.append(d["poisson_iters"])
            sync(dev)
            out[f"{label}_ms_per_step"] = (time.perf_counter() - t0) / n * 1e3
            out[f"{label}_iters"] = iters
    la = {k: c for k, c in hk.launches.items() if c}
    out.update(umax=d["umax"], finite=bool(d["finite"]),
               converged=bool(d["poisson_converged"]),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=la, twin_calls=tw.calls)
    print(f"phase 13 tgv_periodic {json.dumps(out)}", flush=True)
    label = f"tgv_periodic {pois or 'default'}"
    check(out["finite"] and out["converged"], f"{label}: {out}")
    check(not any(tw.calls.values()), f"{label}: a twin ran on the card: "
          f"{tw.calls}")
    check(la.get("fused_advect_heun+pd", 0) == la.get("fused_advect_heun")
          == 12 and la.get("fused_correction+pd", 0)
          == la.get("fused_correction") == 6,
          f"{label}: substage / correction launches {la}")
    check(la.get("fused_jacobi_sweeps+pd", 0)
          == la.get("fused_jacobi_sweeps", 0)
          and (la.get("fused_jacobi_sweeps", 0) > 0) == (pois == "fas"),
          f"{label}: sweep-chain launches {la}")
    check("tridiag_scan" not in la, f"{label}: the doubly-periodic box "
          f"launched the Thomas scans: {la}")
    if pois == "fftd":
        check(out["production_iters"] == [1] * 5, f"{label}: {out}")
    del sim
    torch.cuda.empty_cache()
    return out


def run_periodic_channel(dev, pois: str, size: int = 8192,
                         steps: int = 3) -> dict:
    """Phase 13: the periodic channel (pd,pd,ns,ns) at size^2 from the
    benchmark velocity, production steps at dt = h/2 (a warm-up and
    ``steps`` timed), the launch counts from 0 and the twins watched."""
    cfg, level = bench_cfg(size, size)
    with latched(pois):
        sim = UniformSim(cfg, level=level, device=dev,
                         bc=PERIODIC_TABLES["channel"])
    sim.state = bench_start(sim.grid)
    sim.step_count = 10
    dt = 0.5 * sim.grid.h
    sync(dev)
    hk.reset_launches()
    with twin_watch() as tw:
        iters = [sim.step_once(dt)["poisson_iters"]]
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            d = sim.step_once(dt)
            iters.append(d["poisson_iters"])
        sync(dev)
    ms = (time.perf_counter() - t0) / steps * 1e3
    la = {k: c for k, c in hk.launches.items() if c}
    out = {"case": "periodic channel", "table": sim.bc_table,
           "mode": sim.poisson_mode, "tier": sim.kernel_tier,
           "ms_per_step": ms, "iters": iters, "finite": bool(d["finite"]),
           "converged": bool(d["poisson_converged"]), "launches": la,
           "twin_calls": tw.calls}
    print(f"phase 13 periodic channel {json.dumps(out)}", flush=True)
    label = f"periodic channel {pois}"
    n = steps + 1
    check(out["finite"] and out["converged"], f"{label}: {out}")
    check(not any(tw.calls.values()), f"{label}: a twin ran: {tw.calls}")
    check(la.get("fused_advect_heun+pd", 0) == 2 * n
          and la.get("fused_correction+pd", 0) == n
          and la.get("fused_jacobi_sweeps+pd", 0)
          == la.get("fused_jacobi_sweeps", 0)
          and (la.get("tridiag_scan", 0) == n) == (pois == "fftd"),
          f"{label}: launches {la}")
    del sim
    torch.cuda.empty_cache()
    return out


def periodic_solves(dev, size: int = 8192, reps: int = 3) -> dict:
    """Phase 13: bench.py's fftd_periodic and fftd_channel arms at size^2:
    one cold mean-free RHS of the benchmark velocity per table
    (``poisson_rhs`` at dt = h/2, its mean removed), solved at the
    production criterion (the configuration's tolerances, 1e-3 and 1e-2
    relative; bench.py's arms use 0 and 1e-3 relative at 1024^2, which an
    f32 direct solve at 8192^2 does not reach: its true residual floors at
    a few 1e-3 of the RHS) by fftd (one direct solve) and by the FAS
    cycles (V, and F-opened) on the periodic hierarchy; ms per solve
    (host clock to a synchronize, mean of ``reps``), iterations, relative
    residual."""
    out = {}
    cfg, level = bench_cfg(size, size)
    for name, table in PERIODIC_TABLES.items():
        with latched("fftd"):
            g = UniformGrid(cfg, level=level, device=dev, bc=table)
        st = bench_start(g)
        b = g.poisson_rhs(st.vel, None, None,
                          torch.tensor(0.5 * g.h, device=dev))
        b = b - b.mean()
        del st
        norm0 = float(b.abs().max())
        mg = tpoisson.MultigridPreconditioner(
            g.ny, g.nx, g.dtype, cycle_dtype=g.dtype, fused_smoother=True,
            edge_signs=g._psigns, periodic=g._paxes)
        tol = dict(tol=cfg.poisson_tol, tol_rel=cfg.poisson_tol_rel)
        arms = {
            "fftd": lambda: tpoisson.fft_diag_solve(
                g.laplacian, b, g._fft_plan, **tol),
            "fas_v": lambda: tpoisson.mg_solve(
                g.laplacian, b, mg, max_cycles=200, **tol),
            "fas_f": lambda: tpoisson.mg_solve(
                g.laplacian, b, mg, max_cycles=200, fmg=True, **tol)}
        rows = {}
        for arm, solve in arms.items():
            r = solve()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                r = solve()
            sync(dev)
            rows[arm] = {"ms_per_solve": (time.perf_counter() - t0) / reps
                         * 1e3, "iters": r.iters,
                         "residual_rel": r.residual / norm0,
                         "converged": r.converged}
            check(r.converged, f"{name} {arm}: not converged: {rows[arm]}")
        check(rows["fftd"]["iters"] == 1, f"{name} fftd: {rows['fftd']}")
        best = min(rows["fas_v"]["ms_per_solve"],
                   rows["fas_f"]["ms_per_solve"])
        out[name] = {"table": table.token, "mode": g.poisson_mode,
                     "arms": rows, "fftd_over_best_fas":
                     rows["fftd"]["ms_per_solve"] / best}
        print(f"phase 13 solve {name} {size}^2 {json.dumps(out[name])}",
              flush=True)
        del g, b, mg, arms
        torch.cuda.empty_cache()
    return out


def phase_periodic_cpu(dev, pois: str, steps: int = 10) -> dict:
    """Phase 13: tgv_periodic at 128^2 f32 on the card and on the CPU,
    ``steps`` production steps from the same start, equal iterations and
    velocity within 1e-4 relative."""
    sims = []
    for d in (dev, "cpu"):
        with latched(pois):
            s = cases.make_sim("tgv_periodic", level=PERIODIC_CPU_LEVEL,
                               device=d)
        s.step_count = 10
        sims.append(s)
    iters = [[s.step_once()["poisson_iters"] for _ in range(steps)]
             for s in sims]
    a, b = sims[0].state.vel.cpu(), sims[1].state.vel
    rel = float((a - b).abs().max() / b.abs().max())
    out = {"mode": sims[0].poisson_mode, "card_iters": iters[0],
           "cpu_iters": iters[1], "vel_rel": rel}
    print(f"phase 13 tgv_periodic 128^2 x{steps} card vs CPU "
          f"{json.dumps(out)}", flush=True)
    check(bool(torch.isfinite(a).all()), "tgv 128^2: non-finite state")
    check(iters[0] == iters[1], f"tgv 128^2 {pois}: iterations {iters}")
    check(rel <= TRAJ_REL, f"tgv 128^2 {pois}: card vs CPU {rel} > "
          f"{TRAJ_REL}")
    return out


def phase_ke_decay(dev, nu: float = 1e-3, t_end: float = 0.1) -> dict:
    """Phase 13: tgv_periodic at 128^2 f32 under fftd on the card to
    t = 0.1: KE within 1% of exp(-4 nu k^2 t), k = 2 pi."""
    with latched("fftd"):
        sim = cases.make_sim("tgv_periodic", level=PERIODIC_CPU_LEVEL,
                             nu=nu, device=dev)
    ke0 = float(torch.mean(sim.state.vel.double() ** 2))
    sim.advance(n_steps=10_000, tend=t_end)
    ke = float(torch.mean(sim.state.vel.double() ** 2))
    expected = float(np.exp(-4.0 * nu * (2.0 * np.pi) ** 2 * sim.time))
    err = abs(ke / ke0 - expected) / expected
    out = {"t": sim.time, "steps": sim.step_count, "ke_ratio": ke / ke0,
           "expected": expected, "rel_err": err}
    print(f"phase 13 KE decay 128^2 fftd f32 {json.dumps(out)}", flush=True)
    check(sim.time >= t_end and err < KE_BAR, f"KE decay: {out}")
    return out


def phase_periodic(dev, res) -> tuple[dict, dict]:
    """Phase 13: the wrap forms and the Thomas scans against their twins;
    tgv_periodic at 8192^2 under the three solvers and the periodic
    channel under fftd and fas (the main path: every launch a wrap form,
    no twin on the card); the solves of bench.py's fftd arms; card against
    CPU at 128^2; the KE decay. Returns the runs and the launches of the
    four new counters over the main-path runs."""
    t = [time.perf_counter()]
    phase_periodic_kernels(dev, res)
    t.append(time.perf_counter())
    runs = {"tgv_periodic": [run_periodic(dev, p)
                             for p in ("", "fas", "fftd")],
            "channel": [run_periodic_channel(dev, p)
                        for p in ("fftd", "fas")]}
    t.append(time.perf_counter())
    every = runs["tgv_periodic"] + runs["channel"]
    launches = {k: sum(r["launches"].get(k, 0) for r in every)
                for k in PERIODIC_KEYS}
    runs["solves"] = periodic_solves(dev)
    t.append(time.perf_counter())
    runs["card_vs_cpu"] = [phase_periodic_cpu(dev, p)
                           for p in ("fftd", "fas")]
    runs["ke_decay"] = phase_ke_decay(dev)
    t.append(time.perf_counter())
    print(f"phase 13 seconds: kernels {t[1] - t[0]}, runs {t[2] - t[1]}, "
          f"solves {t[3] - t[2]}, card vs CPU and KE {t[4] - t[3]}",
          flush=True)
    return runs, launches



# phase 14: the run driver on the card, python -m cup2d_tpu_torch in process
PHASE14_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase14")
CANON_TDUMP = 1e-4       # under every step's dt: each run dumps every step
CANON_CLI_STEPS = 22     # 10 startup, 12 production, the step-20 regrid
CANON_CKPT_EVERY = 10
FLAGSHIP_CLI_STEPS = 25  # 10 startup (the library loop's), 15 production
FLAGSHIP_TRACE = (16, 19)  # CUP2D_TRACE wraps the steps of records 17-19
FLAGSHIP_FLAGS = ("-bpdx 2 -bpdy 1 -levelMax 1 -levelStart 0 -Rtol 2 "
                  "-Ctol 1 -extent 4 -CFL 0.5 -tend 10 -lambda 1e7 "
                  "-nu 0.00004 -poissonTol 0.001 -poissonTolRel 0.01 "
                  "-maxPoissonRestarts 0 -maxPoissonIterations 1000 "
                  f"-AdaptSteps 20 -tdump 0.2 -dtype float32 "
                  f"-level {ENTRY_LEVEL}")


def canon_cli_argv(supervised: bool = False) -> list:
    """run.sh's flags as phase 12 writes them, f32, nothing cut, with
    ``-tdump`` at ``CANON_TDUMP``; the verdict-only loop unless
    ``supervised`` (the CLI's default loop)."""
    argv = CANON_FLAGS.format(lm=CANON_LEVEL_MAX, ls=CANON_LEVEL_START,
                              tol=1e-3, rel=1e-2).split()
    argv[argv.index("-tdump") + 1] = str(CANON_TDUMP)
    return argv + ["-shapes", ENTRY_SHAPES] + (
        [] if supervised else ["-noSupervise"])


class GcClock:
    """The collector's passes while entered: (wall start, seconds,
    generation) each, from ``gc.callbacks``."""

    def __init__(self):
        self.passes = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = (time.time(), time.perf_counter())
        elif self._t0 is not None:
            self.passes.append((self._t0[0],
                                time.perf_counter() - self._t0[1],
                                info["generation"]))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def between(self, a: float, b: float, n: int) -> dict:
        """The collector's ms a step and its full (generation 2) passes
        over ``n`` steps that ran between the wall times ``a`` and ``b``."""
        inside = [(s, g) for t, s, g in self.passes if a <= t <= b]
        return {"gc_ms_per_step": 1e3 * sum(s for s, _ in inside) / n,
                "gc_full_passes": sum(g == 2 for _, g in inside)}


def fresh_peak() -> int:
    """Collect, empty the allocator's cache, reset the peak: returns the
    bytes still allocated, which the next peak counts too."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return int(torch.cuda.memory_allocated())


def median_phases(phases: list) -> dict:
    """Each phase's median host ms over a list of ``phase_seconds``."""
    return {k: float(np.median([1e3 * p.get(k, 0.0) for p in phases]))
            for k in (phases[0] if phases else {})}


def cli_run(argv: list, out: str, keep: bool = False,
            trace: tuple | None = None) -> dict:
    """``cup2d_tpu_torch.__main__.main(argv)`` into ``out``, with the
    checkpoint saves and loads and the dumps it makes timed to a
    synchronize (the names ``__main__`` calls, wrapped for the run), each
    uniform ``Simulation.step_once`` timed with its phases' host seconds,
    and the collector's passes clocked; ``keep`` copies each checkpoint
    to ``checkpoint.<step>``; ``trace`` = (start, stop) sets
    ``CUP2D_TRACE=start:stop:<out>/trace`` for the run. Returns rc, wall
    seconds, the timings, the metrics records, the forces rows, the
    bytes allocated when the run began and the run's peak."""
    from cup2d_tpu_torch import __main__ as tmain
    from cup2d_tpu_torch.profiling import load_metrics
    calls = {"save": [], "load": [], "dump": []}
    names = {"save_checkpoint": "save", "load_checkpoint": "load",
             "dump_forest": "dump", "dump_uniform": "dump"}
    orig = {n: getattr(tmain, n) for n in names}

    def timed(name):
        fn = orig[name]

        def run(path, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(path, *a, **kw)
            torch.cuda.synchronize()
            calls[names[name]].append((time.perf_counter() - t0, path))
            if name == "save_checkpoint" and keep:
                with open(os.path.join(path, "meta.json")) as f:
                    step = json.load(f)["step_count"]
                shutil.copytree(path, f"{path}.{step}")
        return run
    for n in names:
        setattr(tmain, n, timed(n))
    steps = []
    step_once = Simulation.step_once

    def timed_step(sim, *a, **kw):
        t0 = time.perf_counter()
        d = step_once(sim, *a, **kw)
        steps.append((1e3 * (time.perf_counter() - t0),
                      dict(sim.phase_seconds)))
        return d
    Simulation.step_once = timed_step
    if trace is not None:
        os.environ["CUP2D_TRACE"] = (f"{trace[0]}:{trace[1]}:"
                                     f"{os.path.join(out, 'trace')}")
    # the records' hbm_peak_bytes is the process's peak since this reset,
    # which counts the base still allocated from earlier phases too
    base = fresh_peak()
    t0 = time.perf_counter()
    try:
        with GcClock() as gcc:
            rc = tmain.main(argv + ["-output", out])
    finally:
        for n, fn in orig.items():
            setattr(tmain, n, fn)
        Simulation.step_once = step_once
        os.environ.pop("CUP2D_TRACE", None)
    secs = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated())
    recs = [r for r in load_metrics(os.path.join(out, "metrics.jsonl"))
            if r.get("event") == "metrics"]
    fpath = os.path.join(out, "forces.csv")
    rows = open(fpath).read().splitlines() if os.path.exists(fpath) else []
    return {"rc": rc, "seconds": secs, "calls": calls, "records": recs,
            "forces": rows, "steps": steps, "gc": gcc, "hbm_base": base,
            "hbm_run_peak": peak - base, "trace": trace,
            "trace_dir": os.path.join(out, "trace")}


def trace_summary(path: str, steps: int) -> dict:
    """A ``torch.profiler`` Chrome trace of ``steps`` steps, per step: the
    span of its events, the card's busy time (the union of its kernel,
    copy and set intervals), the host's time blocked in synchronizing
    runtime calls, the host ops and the device activities; and the idle
    share, 1 - busy / span."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    cat = [str(e.get("cat", "")).lower() for e in ev]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e, c in zip(ev, cat)
                 if c in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(e["ts"] + e["dur"] for e in ev)
            - min(e["ts"] for e in ev))
    blocked = sum(e["dur"] for e, c in zip(ev, cat)
                  if c == "cuda_runtime" and ("Synchronize" in e["name"]
                                              or e["name"] == "cudaMemcpy"))
    return {"span_ms_per_step": span / 1e3 / steps,
            "busy_ms_per_step": busy / 1e3 / steps,
            "idle_share": 1.0 - busy / span,
            "blocked_ms_per_step": blocked / 1e3 / steps,
            "host_ops_per_step": sum(c == "cpu_op" for c in cat) / steps,
            "device_activities_per_step": len(dev) / steps}


def _dump_bytes(path: str) -> int:
    return sum(os.path.getsize(path + suf)
               for suf in (".xyz.raw", ".attr.raw", ".xdmf2"))


def cli_summary(label: str, run: dict, lib_ms: float) -> dict:
    """The numbers phase 14 prints of one CLI run, and its checks: rc 0,
    schema 12 with the JAX package's key set, no kernel build after step
    1, finite records."""
    from cup2d_tpu_torch.profiling import (METRICS_KEYS,
                                           METRICS_SCHEMA_VERSION)
    recs = run["records"]
    check(run["rc"] == 0, f"{label}: rc {run['rc']}")
    check(all(set(r) - {"event", "wall"} == set(METRICS_KEYS)
              and r["schema"] == METRICS_SCHEMA_VERSION == 12
              for r in recs), f"{label}: metrics records off the schema")
    tr = run["trace"]
    traced = set(range(tr[0] + 1, tr[1] + 1)) if tr else set()
    prod = [r for r in recs if r["step"] > 10]
    timed = [r for r in prod if r["step"] not in traced]
    dumps = run["calls"]["dump"]
    out = {
        "steps": [r["step"] for r in recs][-1],
        "seconds": run["seconds"],
        "production_ms_per_step": float(np.median(
            [r["wall_ms"] for r in timed])),
        "production_steps_timed": len(timed),
        "startup_ms_per_step": (float(np.median(
            [r["wall_ms"] for r in recs if r["step"] <= 10]))
            if recs[0]["step"] <= 10 else None),
        "library_loop_ms_per_step": lib_ms,
        "iters": [r["poisson_iters"] for r in recs],
        "dumps": len(dumps),
        "dump_ms": float(np.median([t for t, _ in dumps]) * 1e3)
        if dumps else None,
        "dump_bytes": _dump_bytes(dumps[-1][1]) if dumps else None,
        "checkpoint_save_s": [t for t, _ in run["calls"]["save"]],
        "checkpoint_load_s": [t for t, _ in run["calls"]["load"]],
        "jit_compiles_after_step_1": sum(r["jit_compiles"]
                                         for r in recs[1:]),
        "jit_compiles_step_1": recs[0]["jit_compiles"],
        "device_gets_per_production_step": [r["device_gets"]
                                            for r in prod],
        "hbm_peak_bytes": max(r["hbm_peak_bytes"] or 0 for r in recs),
        "hbm_base_bytes": run["hbm_base"],
        "hbm_run_peak_bytes": run["hbm_run_peak"],
        "blocks": [r["n_blocks"] for r in recs],
        "regrid_after_step_20": [(r["refines"], r["coarsens"])
                                 for r in recs if r["step"] == 21],
    }
    if prod:
        # the production steps after the first record's wall time
        first = recs.index(prod[0])
        a = recs[first - 1] if first else prod[0]
        out.update(run["gc"].between(a["wall"], recs[-1]["wall"],
                                     recs[-1]["step"] - a["step"]))
    if run["steps"]:
        # the step_once calls are the steps of the records, in order
        check(len(run["steps"]) == len(recs),
              f"{label}: {len(run['steps'])} step_once calls, "
              f"{len(recs)} records")
        st = [run["steps"][r["step"] - recs[0]["step"]] for r in timed]
        out["step_once_ms_per_step"] = float(np.median([m for m, _ in st]))
        out["phase_ms_per_step"] = median_phases([p for _, p in st])
        out["driver_ms_per_step"] = float(np.median(
            [r["wall_ms"] - m for r, (m, _) in zip(timed, st)]))
    if tr:
        path = os.path.join(run["trace_dir"],
                            f"trace_{tr[0]}_{tr[1]}.json")
        out["trace"] = trace_summary(path, tr[1] - tr[0])
        out["trace"]["wall_ms"] = [r["wall_ms"] for r in recs
                                   if r["step"] in traced]
    check(out["jit_compiles_after_step_1"] == 0,
          f"{label}: a kernel build after step 1")
    check(all(r["poisson_residual"] is not None
              and np.isfinite(r["umax"]) for r in recs),
          f"{label}: non-finite records")
    return out


def flagship_loop(dev, steps: int, ckpt: str) -> dict:
    """The flagship's library loop beside its CLI run: ``entry()``'s two
    fish at 1024 x 512 f32 under the default solver, ``initialize()`` and
    ``steps`` ``step_once`` steps, each timed on the host clock to a
    synchronize, as phase 11 does; the median production ms, its phases'
    host ms, and the collector's ms a production step. Its state after
    the 10 startup steps is saved to ``ckpt``, where the CLI run starts."""
    from cup2d_tpu_torch.io import save_checkpoint
    sim = Simulation(entry_cfg(), level=ENTRY_LEVEL, device=dev)
    sim.initialize()
    sync(dev)
    ms, phases = [], []
    with GcClock() as gcc:
        for i in range(steps):
            if i == 10:
                save_checkpoint(ckpt, sim)
                sync(dev)
                t_prod = time.time()
            t0 = time.perf_counter()
            sim.step_once()
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
            phases.append(dict(sim.phase_seconds))
        t_end = time.time()
    out = {"production_ms_per_step": float(np.median(ms[10:])),
           "production_ms": ms[10:],
           "phase_ms_per_step": median_phases(phases[10:]),
           **gcc.between(t_prod, t_end, steps - 10)}
    del sim
    return out


def phase_cli(dev, canon_lib_ms: float, flagship_lib_ms: float
              ) -> tuple[dict, dict]:
    """Phase 14: ``python -m cup2d_tpu_torch`` on the card, in process.
    The canonical run (run.sh's flags, f32, levelStart 5, levelMax 8,
    ``-noSupervise -maxSteps 22 -checkpointEvery 10``, a dump every step),
    its ``-restart`` from the step-10 checkpoint into a second directory,
    held to it bit for bit (every common dump, the forces rows of steps
    11-22, the iterations of every step, the step-20 checkpoints' fields
    and meta), and the flagship (``entry()``'s two fish at 1024 x 512,
    f32) through its library loop in this phase (25 steps) and through
    the CLI from the loop's step-10 checkpoint (three production steps
    traced). Launch counts from 0 over each CLI run. Returns the
    runs and the launches of kernels 4 (the canonical run), 2 and 5 (the
    flagship). The canonical run's directory stays for phases 15 and 17;
    phase 17 removes ``PHASE14_DIR``."""
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    dir_a = os.path.join(PHASE14_DIR, "canonical")
    dir_b = os.path.join(PHASE14_DIR, "restart")
    dir_c = os.path.join(PHASE14_DIR, "flagship")
    hk.reset_launches()
    a = cli_run(canon_cli_argv() + [
        "-maxSteps", str(CANON_CLI_STEPS), "-checkpointEvery",
        str(CANON_CKPT_EVERY)], dir_a, keep=True)
    la = {k: n for k, n in hk.launches.items() if n}
    runs = {"canonical": cli_summary("canonical cli", a, canon_lib_ms)}
    runs["canonical"]["launches"] = la
    print(f"phase 14 canonical cli {json.dumps(runs['canonical'])}",
          flush=True)
    step10 = os.path.join(dir_a, f"checkpoint.{CANON_CKPT_EVERY}")
    b = cli_run(canon_cli_argv() + [
        "-maxSteps", str(CANON_CLI_STEPS), "-checkpointEvery",
        str(CANON_CKPT_EVERY), "-restart", step10], dir_b)
    check(b["rc"] == 0, f"canonical restart: rc {b['rc']}")
    dumps_a = {os.path.basename(p) for _, p in a["calls"]["dump"]}
    dumps_b = {os.path.basename(p) for _, p in b["calls"]["dump"]}
    common = sorted(dumps_a & dumps_b)
    check(len(dumps_a) >= 2 and len(common) >= 2,
          f"canonical cli: dumps {sorted(dumps_a)}, common {common}")
    for n in common:
        for suf in (".xyz.raw", ".attr.raw"):
            with open(os.path.join(dir_a, n + suf), "rb") as fa, \
                    open(os.path.join(dir_b, n + suf), "rb") as fb:
                check(fa.read() == fb.read(),
                      f"canonical restart: {n}{suf} differs")
    rows = 2 * CANON_CKPT_EVERY      # two fish a step
    check(a["forces"][1 + rows:] == b["forces"][1:]
          and len(b["forces"]) == 1 + 2 * (CANON_CLI_STEPS
                                           - CANON_CKPT_EVERY),
          "canonical restart: forces rows of steps 11-22 differ")
    iters_a = [(r["step"], r["poisson_iters"]) for r in a["records"]
               if r["step"] > CANON_CKPT_EVERY]
    iters_b = [(r["step"], r["poisson_iters"]) for r in b["records"]]
    check(iters_a == iters_b,
          f"canonical restart: iterations {iters_a} != {iters_b}")
    ck_a, ck_b = (os.path.join(d, "checkpoint") for d in (dir_a, dir_b))
    with np.load(os.path.join(ck_a, "fields.npz")) as fa, \
            np.load(os.path.join(ck_b, "fields.npz")) as fb:
        check(sorted(fa.files) == sorted(fb.files)
              and all(np.array_equal(fa[k], fb[k]) for k in fa.files),
              "canonical restart: the step-20 checkpoints' fields differ")
    meta = [json.load(open(os.path.join(c, "meta.json")))
            for c in (ck_a, ck_b)]
    check(meta[0]["step_count"] == 20 and meta[0] == meta[1],
          "canonical restart: the step-20 checkpoints' meta differ")
    runs["restart"] = {
        "common_dumps": len(common), "seconds": b["seconds"],
        "checkpoint_load_s": [t for t, _ in b["calls"]["load"]],
        "production_ms_per_step": float(np.median(
            [r["wall_ms"] for r in b["records"]])),
        "forces_rows": len(b["forces"]) - 1, "bit_for_bit": True}
    print(f"phase 14 canonical restart {json.dumps(runs['restart'])}",
          flush=True)
    step10 = os.path.join(PHASE14_DIR, "flagship_step10")
    loop = flagship_loop(dev, FLAGSHIP_CLI_STEPS, step10)
    print(f"phase 14 flagship library loop {json.dumps(loop)}", flush=True)
    hk.reset_launches()
    c = cli_run(FLAGSHIP_FLAGS.split() + [
        "-shapes", ENTRY_SHAPES, "-noSupervise", "-maxSteps",
        str(FLAGSHIP_CLI_STEPS), "-restart", step10], dir_c,
        trace=FLAGSHIP_TRACE)
    lf = {k: n for k, n in hk.launches.items() if n}
    runs["flagship"] = cli_summary("flagship cli", c, flagship_lib_ms)
    runs["flagship"]["launches"] = lf
    runs["flagship"]["in_phase_library_loop"] = loop
    print(f"phase 14 flagship cli {json.dumps(runs['flagship'])}",
          flush=True)
    # a catalog case through -case: the uniform driver and dump on the card
    hk.reset_launches()
    e = cli_run(["-case", "tgv_periodic", "-level", "7", "-noSupervise",
                 "-maxSteps", "4", "-tdump", "1e-3"],
                os.path.join(PHASE14_DIR, "case"))
    lc = {k: n for k, n in hk.launches.items() if n}
    check(e["rc"] == 0 and [r["step"] for r in e["records"]] == [1, 2, 3, 4]
          and e["calls"]["dump"]
          and lc.get("fused_advect_heun+pd", 0) == 8
          and lc.get("fused_correction+pd", 0) == 4,
          f"-case tgv_periodic: rc {e['rc']}, launches {lc}")
    runs["case"] = {"seconds": e["seconds"], "dumps": len(e["calls"]["dump"]),
                    "ms_per_step": [r["wall_ms"] for r in e["records"]],
                    "iters": [r["poisson_iters"] for r in e["records"]],
                    "kernel_tier": e["records"][-1]["kernel_tier"],
                    "launches": lc}
    print(f"phase 14 case cli {json.dumps(runs['case'])}", flush=True)
    launches = {"fused_lab_rhs": la.get("fused_lab_rhs", 0),
                "fused_advect_heun": lf.get("fused_advect_heun", 0),
                "fused_correction": lf.get("fused_correction", 0)}
    for k, n in launches.items():
        check(n > 0, f"{k}: launched no time on the CLI runs")
    print(f"phase 14 launches {json.dumps(launches)}", flush=True)
    return runs, launches


# phase 15: supervised runs on the card
PHASE15_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase15")
DRILL_STEP = 12          # a production step after the step-10 adapt
DRILL_STEPS = 15
# (name, CUP2D_FAULTS, the step of the run's own checkpoint on disk or
# None, actions, rc). The ladder retries right after a disk restore, as
# the reference's does, so a run restored to step 10 makes step 11
# without the adapt the loop makes at step 10 (on the card it coarsens
# 3 blocks): "disk_restore" keeps a step-11 checkpoint and must end bit
# for bit the unfaulted run; "disk_restore_step10" restores the step-10
# one and reports whether it does.
DRILLS = (("retry", f"nan_vel@{DRILL_STEP}", None, ["retry"], 0),
          ("escalate", f"poisson_giveup@{DRILL_STEP}*2", None,
           ["retry", "escalate"], 0),
          ("disk_restore", f"nan_vel@{DRILL_STEP}*3", CANON_CKPT_EVERY + 1,
           ["retry", "escalate", "disk_restore"], 0),
          ("disk_restore_step10", f"nan_vel@{DRILL_STEP}*3",
           CANON_CKPT_EVERY, ["retry", "escalate", "disk_restore"], 0),
          ("abort", f"nan_vel@{DRILL_STEP}*4", None,
           ["retry", "escalate", "abort"], 1))
LAG_STEPS = 7            # with snap_every 4: the anchor after 4, 3 replayed
LAG_WARM = 2             # the first production steps: dt and trigger settle
LAG_TRACE = (6, 7)       # the torch.profiler window: the last step
# the runs in turns, lagged or not (eager, lagged, lagged, eager was cut
# to these two to make room for phase 20)
LAG_TURNS = (False, True)
SUPERVISED_KEYS = ("fused_advect_heun", "fused_lab_rhs", "fused_correction",
                   "fused_jacobi_sweeps", "fused_block_jacobi_update")
FOREST_TWINS = TWINS + ("fused_lab_rhs_plain", "block_jacobi_plain",
                        "block_precond_plain", "block_precond_form_plain",
                        "group_sum_plain")


def _events(out: str) -> list:
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(x) for x in f if x.strip()]


def _last_by_step(records: list) -> dict:
    """The newest record of each step (a rewind repeats steps)."""
    return {r["step"]: r for r in records}


def _canonical_loaded(dev, path: str) -> AMRSim:
    from cup2d_tpu_torch.io import load_checkpoint
    sim = AMRSim(canonical_cfg(), device=dev)
    load_checkpoint(path, sim)
    return sim


def supervised_canonical(dev, dir_a: str, eager_ms: float) -> dict:
    """The canonical CLI of phase 14 without ``-noSupervise``: the
    StepGuard ring, one snapshot a step, the eager verdict of the shaped
    forest; held bit for bit to phase 14's run (every dump's bytes, the
    forces rows, each step's iterations). Then a ``-noSupervise`` run and
    a supervised one more, each restarted from phase 14's step-10
    checkpoint (production steps only), so the production medians come
    in turns (phase 14's, supervised, verdict-only, supervised), each
    run's iterations phase 14's."""
    out = os.path.join(PHASE15_DIR, "canonical")
    run = cli_run(canon_cli_argv(supervised=True) + [
        "-maxSteps", str(CANON_CLI_STEPS), "-checkpointEvery",
        str(CANON_CKPT_EVERY)], out)
    check(run["rc"] == 0, f"supervised canonical: rc {run['rc']}")
    dumps_a = sorted(f[:-len(".xdmf2")] for f in os.listdir(dir_a)
                     if f.endswith(".xdmf2"))
    dumps_s = sorted(os.path.basename(p) for _, p in run["calls"]["dump"])
    check(dumps_a == dumps_s and len(dumps_s) >= 20,
          f"supervised canonical: dumps {dumps_s} != {dumps_a}")
    for n in dumps_s:
        for suf in (".xyz.raw", ".attr.raw"):
            with open(os.path.join(dir_a, n + suf), "rb") as fa, \
                    open(os.path.join(out, n + suf), "rb") as fb:
                check(fa.read() == fb.read(),
                      f"supervised canonical: {n}{suf} differs")
    rows_a = open(os.path.join(dir_a, "forces.csv")).read().splitlines()
    check(run["forces"] == rows_a,
          "supervised canonical: forces.csv differs from phase 14's")
    from cup2d_tpu_torch.profiling import load_metrics
    recs_a = [r for r in load_metrics(os.path.join(dir_a, "metrics.jsonl"))
              if r.get("event") == "metrics"]
    iters = [(r["step"], r["poisson_iters"]) for r in run["records"]]
    check(iters == [(r["step"], r["poisson_iters"]) for r in recs_a],
          f"supervised canonical: iterations {iters} differ")
    check(not [e for e in _events(out) if e.get("event") == "recovery"],
          "supervised canonical: a recovery in an unfaulted run")
    def median_prod(records):
        return float(np.median([r["wall_ms"] for r in records
                                if r["step"] > 10]))
    turns = {"noSupervise": [eager_ms], "supervised": [
        median_prod(run["records"])]}
    step10 = os.path.join(dir_a, f"checkpoint.{CANON_CKPT_EVERY}")
    for k, sup in enumerate((False, True)):
        out_k = os.path.join(PHASE15_DIR, f"canonical_turn{k}")
        r = cli_run(canon_cli_argv(supervised=sup) + [
            "-maxSteps", str(CANON_CLI_STEPS), "-checkpointEvery",
            str(CANON_CKPT_EVERY), "-restart", step10], out_k)
        check(r["rc"] == 0 and [(x["step"], x["poisson_iters"])
                                for x in r["records"]]
              == [x for x in iters if x[0] > CANON_CKPT_EVERY],
              f"canonical in turns ({'supervised' if sup else 'verdict'}"
              f"): rc {r['rc']}")
        turns["supervised" if sup else "noSupervise"].append(
            median_prod(r["records"]))
        shutil.rmtree(out_k)
    return {"production_ms_per_step": turns["supervised"][0],
            "eager_production_ms_per_step": eager_ms,
            "production_ms_in_turns": turns,
            "startup_ms_per_step": float(np.median(
                [r["wall_ms"] for r in run["records"] if r["step"] <= 10])),
            "snap_ring_bytes": max(r["snap_ring_bytes"]
                                   for r in run["records"]),
            "device_gets_per_production_step": [
                r["device_gets"] for r in run["records"] if r["step"] > 10],
            "state_gathers": sum(r["state_gathers"] for r in run["records"]),
            "dumps": len(dumps_s), "seconds": run["seconds"],
            "bit_for_bit": True}


def ladder_drill(dev, dir_a: str, name: str, spec: str, disk,
                 actions: list, rc: int) -> dict:
    """One ``CUP2D_FAULTS`` drill on the canonical CLI, restarted from
    phase 14's step-10 checkpoint. ``disk``: the step of the run's own
    checkpoint, the disk rung's restore point (10: that checkpoint copied
    in as the run's own; 11: saved by the run), or None."""
    out = os.path.join(PHASE15_DIR, name)
    os.makedirs(out)
    start = os.path.join(dir_a, f"checkpoint.{CANON_CKPT_EVERY}")
    ck = os.path.join(out, "checkpoint" if disk == CANON_CKPT_EVERY
                      else "start")
    shutil.copytree(start, ck)
    extra = (["-checkpointEvery", str(disk)]
             if disk and disk != CANON_CKPT_EVERY else [])
    os.environ["CUP2D_FAULTS"] = spec
    try:
        run = cli_run(canon_cli_argv(supervised=True) + [
            "-maxSteps", str(DRILL_STEPS), "-restart", ck] + extra, out)
    finally:
        os.environ.pop("CUP2D_FAULTS", None)
    evs = [e for e in _events(out) if e.get("event") == "recovery"]
    got = [e["action"] for e in evs]
    check(run["rc"] == rc and got == actions
          and all(e["step"] == DRILL_STEP for e in evs),
          f"drill {name} ({spec}): rc {run['rc']}, events "
          f"{[(e['step'], e['action'], e['verdict']) for e in evs]}")
    res = {"spec": spec, "rc": run["rc"], "actions": got,
           "verdicts": [e["verdict"] for e in evs],
           "replayed": [e.get("replayed") for e in evs],
           "seconds": run["seconds"]}
    last = _last_by_step(run["records"])
    if rc == 0:
        check(max(last) == DRILL_STEPS and all(
            np.isfinite(r["umax"]) for r in last.values()),
            f"drill {name}: records {sorted(last)}")
    if disk:
        # after the restore, is the run phase 14's again? Its last dump
        # (the clock rewound below the dump schedule, which resumes past
        # the failed step), the last step's forces rows and the
        # iterations since the restore, bit for bit
        n = os.path.basename(run["calls"]["dump"][-1][1])
        check(int(n.split(".")[1]) > DRILL_STEP,
              f"drill {name}: last dump {n}")
        same = {}
        for suf in (".xyz.raw", ".attr.raw"):
            with open(os.path.join(dir_a, n + suf), "rb") as fa, \
                    open(os.path.join(out, n + suf), "rb") as fb:
                same[n + suf] = fa.read() == fb.read()
        rows_a = open(os.path.join(dir_a, "forces.csv")).read().splitlines()
        same["forces"] = run["forces"][-2:] == rows_a[
            1 + 2 * (DRILL_STEPS - 1):1 + 2 * DRILL_STEPS]
        from cup2d_tpu_torch.profiling import load_metrics
        ref = _last_by_step(
            [r for r in load_metrics(os.path.join(dir_a, "metrics.jsonl"))
             if r.get("event") == "metrics"])
        steps = range(disk + 1, DRILL_STEPS + 1)
        same["iterations"] = ([last[s]["poisson_iters"] for s in steps]
                              == [ref[s]["poisson_iters"] for s in steps])
        res["compared_dump"] = n
        res["same_as_unfaulted"] = same
        res["bit_for_bit"] = all(same.values())
        if disk != CANON_CKPT_EVERY:
            check(res["bit_for_bit"],
                  f"drill {name}: differs from the unfaulted run {same}")
    if name == "abort":
        pm = _canonical_loaded(dev, os.path.join(out, "postmortem"))
        res["postmortem_step"] = pm.step_count
        check(pm.step_count > CANON_CKPT_EVERY,
              f"drill abort: post-mortem at step {pm.step_count}")
        del pm
    return res


def crash_drill(dev, dir_a: str) -> dict:
    """``crash_in_save``: a restart from phase 14's step-10 checkpoint
    (copied in as the run's own) dies in the step-11 save between the park
    and the install; the load falls back to the parked step-10 checkpoint,
    bit for bit."""
    from cup2d_tpu_torch.faults import InjectedCrash
    out = os.path.join(PHASE15_DIR, "crash")
    os.makedirs(out)
    start = os.path.join(dir_a, f"checkpoint.{CANON_CKPT_EVERY}")
    ck = os.path.join(out, "checkpoint")
    shutil.copytree(start, ck)
    os.environ["CUP2D_FAULTS"] = "crash_in_save"
    crashed = False
    try:
        cli_run(canon_cli_argv(supervised=True) + [
            "-maxSteps", str(CANON_CKPT_EVERY + 2), "-checkpointEvery",
            str(CANON_CKPT_EVERY + 1), "-restart", ck], out)
    except InjectedCrash:
        crashed = True
    finally:
        os.environ.pop("CUP2D_FAULTS", None)
    check(crashed and not os.path.exists(os.path.join(ck, "meta.json"))
          and os.path.exists(os.path.join(ck + ".old", "meta.json")),
          "crash_in_save: no crash between the park and the install")
    a = _canonical_loaded(dev, ck)          # falls back to .old
    b = _canonical_loaded(dev, start)
    ka, fa = _ordered_fields(a)
    kb, fb = _ordered_fields(b)
    same = (a.step_count == b.step_count == CANON_CKPT_EVERY
            and a.time == b.time and ka == kb
            and all(np.array_equal(fa[k], fb[k]) for k in fb))
    check(same, "crash_in_save: the .old load differs from the step-10 "
          "checkpoint")
    return {"crashed": crashed, "loaded_step": a.step_count,
            "bit_for_bit": same}


def _profiled(path: str):
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        on_trace_ready=lambda p: p.export_chrome_trace(path))


def _state_of(sim) -> dict:
    if hasattr(sim, "forest"):
        return {k: v.clone() for k, v in sim._ordered_state().items()}
    return {k: v.clone() for k, v in sim.state._asdict().items()}


def lag_run(sim, guarded: bool, trace: str) -> dict:
    """``LAG_STEPS`` production steps, eager or under
    ``StepGuard(snap_every=4)`` (the lagged verdict): each step's reads
    and host ms (no synchronize between steps, so the lag's overlap
    shows), the ms a step from a synchronize before step ``LAG_WARM`` to
    one after the step before ``LAG_TRACE``, the ring's bytes, and
    ``LAG_TRACE`` under ``torch.profiler``."""
    from cup2d_tpu_torch.profiling import HostCounters
    from cup2d_tpu_torch.resilience import StepGuard
    guard = StepGuard(sim, snap_every=4) if guarded else None
    c = HostCounters().install()
    gets, ms, ring = [], [], 0
    prof = None
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    last = 0
    for k in range(LAG_STEPS):
        if k == LAG_WARM:
            torch.cuda.synchronize()
            t_timed = time.perf_counter()
        if k == LAG_TRACE[0]:
            torch.cuda.synchronize()
            timed = time.perf_counter() - t_timed
            prof = _profiled(trace)
            prof.__enter__()
        guard.step() if guarded else sim.step_once()
        if k == LAG_TRACE[1] - 1:
            prof.__exit__(None, None, None)
        now = c.snapshot()["device_gets"]
        gets.append(now - last)
        last = now
        t = time.perf_counter()
        ms.append(1e3 * (t - t_prev))
        t_prev = t
        if guarded:
            ring = max(ring, guard.ring_nbytes())
    drain_gets = 0
    if guarded:
        guard.drain()
        drain_gets = c.snapshot()["device_gets"] - last
    torch.cuda.synchronize()
    c.uninstall()
    n_timed = LAG_TRACE[0] - LAG_WARM
    return {"device_gets": gets, "drain_gets": drain_gets, "ms": ms,
            "timed_ms_per_step": 1e3 * timed / n_timed,
            "timed_steps": n_timed,
            "state_gathers": c.snapshot()["state_gathers"],
            "ring_bytes_max": ring,
            "trace": trace_summary(trace, LAG_TRACE[1] - LAG_TRACE[0]),
            "guard": guard}


def lag_pair(dev, label: str, mk, card: str) -> dict:
    """Runs of one obstacle-free driver from the same state, in turns
    (``LAG_TURNS``: eager, lagged). Each bit for bit the first (the
    fields, the clock, the step count), the lagged ones with no more reads
    than the eager and no gather; then the first lagged run's anchor
    restored and its 3 steps replayed: bit for bit again."""
    base = os.path.join(PHASE15_DIR, label.replace(" ", "_"))
    runs, ref, first_lagged = [], None, None
    for k, guarded in enumerate(LAG_TURNS):
        sim = mk()
        r = lag_run(sim, guarded, f"{base}_{k}.json")
        guard = r.pop("guard")
        st = _state_of(sim)
        if ref is None:
            ref = (st, sim.time, sim.step_count)
        same = (sim.async_diag == guarded and sim.time == ref[1]
                and sim.step_count == ref[2]
                and all(torch.equal(ref[0][n], st[n]) for n in st))
        check(same, f"{label}: run {k} ({'lagged' if guarded else 'eager'}"
              ") differs from the first eager run")
        if guarded:
            check(r["state_gathers"] == 0
                  and sum(r["device_gets"]) + r["drain_gets"]
                  <= sum(runs[0]["device_gets"]),
                  f"{label}: lagged reads {r['device_gets']} + "
                  f"{r['drain_gets']} vs eager {runs[0]['device_gets']}, "
                  f"gathers {r['state_gathers']}")
        if guarded and first_lagged is None:
            n = guard._rewind_replay()
            torch.cuda.synchronize()
            sr = _state_of(sim)
            replay = (n == LAG_STEPS % 4 and sim.time == ref[1]
                      and all(torch.equal(ref[0][m], sr[m]) for m in sr))
            check(replay, f"{label}: restore + {n} replayed steps differ "
                  "from the uninterrupted run")
            first_lagged = {"replayed": n, "ring_bytes": guard.ring_nbytes(),
                            "mode": sim.poisson_mode}
            del sr
        runs.append(r)
        del sim, guard, st
        gc.collect()
        torch.cuda.empty_cache()
    out = {"eager": runs[0], "lagged": runs[1], "bit_for_bit": True,
           "replay_bit_for_bit": True, **first_lagged,
           "timed_ms_in_turns": {
               name: [r["timed_ms_per_step"] for r, g in
                      zip(runs, LAG_TURNS) if g == guarded]
               for name, guarded in (("eager", False), ("lagged", True))},
           "idle_in_turns": {
               name: [r["trace"]["idle_share"] for r, g in
                      zip(runs, LAG_TURNS) if g == guarded]
               for name, guarded in (("eager", False), ("lagged", True))},
           "card": card}
    del ref
    print(f"phase 15 lag {label} {json.dumps(out)}", flush=True)
    return out


def phase_supervised(dev, forest_start: tuple, canon_eager_ms: float,
                     card: str) -> tuple[dict, dict]:
    """Phase 15: supervision on the card. The canonical CLI without
    ``-noSupervise`` bit for bit phase 14's run; the ladder drills on it
    from phase 14's step-10 checkpoint (retry; retry, escalate; retry,
    escalate, disk restore to a step-11 checkpoint, then phase 14's run
    bit for bit, and to the step-10 one, reported; retry, escalate, abort
    with rc 1 and a post-mortem that loads) and the crash
    in a save (the ``.old`` load bit for bit); the lagged verdict on the
    obstacle-free drivers (phase 5's forest and the 8192^2
    ``UniformSim``, both solvers): bit for bit the eager run with no more
    reads, and restore + replay bit for bit. Launches of kernels 2, 4, 5,
    6 and 8 from 0 over the phase; no twin called on the card's f32
    operands. Removes its own files (phase 17 removes phase 14's)."""
    shutil.rmtree(PHASE15_DIR, ignore_errors=True)
    os.makedirs(PHASE15_DIR)
    dir_a = os.path.join(PHASE14_DIR, "canonical")
    hk.reset_launches()
    out = {}
    with twin_watch(FOREST_TWINS) as tw:
        t0 = time.perf_counter()
        out["canonical"] = supervised_canonical(dev, dir_a, canon_eager_ms)
        t1 = time.perf_counter()
        print(f"phase 15 supervised canonical cli "
              f"{json.dumps(out['canonical'])}", flush=True)
        out["drills"] = {}
        for name, spec, disk, actions, rc in DRILLS:
            out["drills"][name] = ladder_drill(dev, dir_a, name, spec,
                                               disk, actions, rc)
            print(f"phase 15 drill {name} "
                  f"{json.dumps(out['drills'][name])}", flush=True)
        out["drills"]["crash_in_save"] = crash_drill(dev, dir_a)
        print(f"phase 15 drill crash_in_save "
              f"{json.dumps(out['drills']['crash_in_save'])}", flush=True)
        cfg_f, snap = forest_start

        def forest(pois):
            def mk():
                if pois:
                    os.environ["CUP2D_POIS"] = pois
                try:
                    s = AMRSim(cfg_f, shapes=[], device=dev)
                finally:
                    os.environ.pop("CUP2D_POIS", None)
                forest_from_numpy(s, *snap)
                s.step_count = 10            # production steps
                return s
            return mk

        def uniform(pois):
            def mk():
                cfg, level = bench_cfg(8192, 8192)
                with latched(pois):
                    s = UniformSim(cfg, level=level, device=dev)
                s.state = bench_start(s.grid)
                s.step_count = 10
                return s
            return mk
        t2 = time.perf_counter()
        out["lag"] = {}
        for pois in ("", "fas"):
            name = pois or "default"
            out["lag"][f"forest {name}"] = lag_pair(
                dev, f"forest {name}", forest(pois), card)
            out["lag"][f"uniform 8192^2 {name}"] = lag_pair(
                dev, f"uniform 8192^2 {name}", uniform(pois), card)
    print(f"phase 15 seconds: canonical {t1 - t0}, drills {t2 - t1}, lag "
          f"{time.perf_counter() - t2}", flush=True)
    check(not any(tw.calls.values()),
          f"phase 15: twins called on the card's f32 operands {tw.calls}")
    launches = {k: hk.launches[k] for k in SUPERVISED_KEYS}
    for k, n in launches.items():
        check(n > 0, f"{k}: launched no time in the supervised runs")
    print(f"phase 15 launches {json.dumps(launches)}; card {card}",
          flush=True)
    shutil.rmtree(PHASE15_DIR)
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: fleets and the serving pool
# ---------------------------------------------------------------------------

PHASE16_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase16")
# bench.run_fleet's curve: the README's -level 5 fleet (256^2) and 1024^2,
# whose Taylor-Green mode needs no solve (its warm-started residual lies
# under the absolute tolerance: 0 iterations); then the turb2d ensemble
# at 1024^2 (-case turb2d -level 7, member m seeded m), whose solve
# iterates every step
FLEET_CURVES = (("tg", 256, (1, 8, 64)), ("tg", 1024, (1, 8, 32)),
                ("turb2d", 1024, (1, 8, 32)))
FLEET_WARM, FLEET_STEPS = 1, 2
FLEET_KEYS = ("fused_advect_heun", "fused_correction", "fused_jacobi_sweeps")
FLEET_SOLO_REL = 1e-5      # a member against its solo run (PERF.md §2)
FLEET_BAR_STEPS = 2        # the B = 8 bar's production steps
# the README's fleet flags at 1024^2 (-level 7), f32, 24 staggered
# sessions through 8 slots: horizons 0.003..0.006 at dt ~2.4e-4 (the
# diffusive limit), 13-25 steps a session, three sessions a slot
SERVE_FLAGS = ("-bpdx 1 -bpdy 1 -levelMax 1 -levelStart 0 -extent 1 "
               "-CFL 0.4 -tend 0.006 -lambda 1e6 -nu 0.001 -poissonTol 1e-3 "
               "-poissonTolRel 1e-2 -maxPoissonRestarts 0 "
               "-maxPoissonIterations 100 -AdaptSteps 20 -Rtol 2 -Ctol 1 "
               "-tdump 0 -dtype float32 -level 7 -fleet 8 -serve 24")
SERVE_FAULT = "nan_vel@15*3"   # member 0's ladder runs out: one eviction
# the serving runs' pool starts at this step, past the 10 exact startup
# solves (tol 0, ~20 s a run at 1024^2): its sessions are production
# traffic, and the exact solves are held by the curves and the card bars
SERVE_FIRST_STEP = 10


def fleet_sim(dev, size: int, members: int, pois: str = "", **kw):
    """A ``FleetSim`` of bench.run_fleet's configuration (f32, nu 4e-5,
    CFL 0.5) at size^2 with the amplitude-laddered Taylor-Green state."""
    from cup2d_tpu_torch.fleet import FleetSim, taylor_green_fleet
    base = dict(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                nu=4e-5, cfl=0.5, dtype="float32")
    base.update(kw)
    with latched(pois):
        sim = FleetSim(SimConfig(**base), level=(size // 8).bit_length() - 1,
                       members=members, device=dev)
    sim.state = taylor_green_fleet(sim.grid, members)
    return sim


def fleet_point(sim, tag: str) -> dict:
    """bench.run_fleet's arm at one B: production steps (step_count 20),
    ``FLEET_WARM`` warm-up steps, one synchronized window of
    ``FLEET_STEPS``, then one step under ``torch.profiler``."""
    b = sim.members
    sim.step_count = 20
    for _ in range(FLEET_WARM):
        sim.step_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 0
    for _ in range(FLEET_STEPS):
        d = sim.step_once()
        iters = max(iters, int(d["poisson_iters"].max()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace = os.path.join(PHASE16_DIR, f"trace_{tag}_{b}".replace(" ", "_"))
    with _profiled(trace):
        sim.step_once()
        torch.cuda.synchronize()
    tr = trace_summary(trace, 1)
    check(bool(torch.isfinite(sim.state.vel).all()),
          f"phase 16 fleet {tag} B={b}: nonfinite")
    return {"members": b, "step_ms": 1e3 * wall / FLEET_STEPS,
            "member_steps_per_s": b * FLEET_STEPS / wall,
            "idle_share": tr["idle_share"],
            "device_activities": tr["device_activities_per_step"],
            "busy_ms": tr["busy_ms_per_step"], "poisson_iters_max": iters}


def fleet_curves(dev, card: str) -> dict:
    out = {}
    for kind, size, bs in FLEET_CURVES:
        for pois in ("", "fas"):
            key = (f"{size}^2 {pois or 'default'}" if kind == "tg"
                   else f"{kind} {size}^2 {pois or 'default'}")
            pts = []
            for b in bs:
                if kind == "tg":
                    sim = fleet_sim(dev, size, b, pois)
                else:
                    with latched(pois):
                        sim = cases.make_sim(
                            kind, level=(size // 8).bit_length() - 1,
                            members=b, device=dev)
                pts.append(fleet_point(sim, key))
                del sim
            if kind == "turb2d":
                check(min(p["poisson_iters_max"] for p in pts) > 0,
                      f"phase 16 fleet {key}: the solve did not iterate")
            out[key] = {"points": pts, "speedup_vs_b1": (
                pts[-1]["member_steps_per_s"] / pts[0]["member_steps_per_s"])}
            print(f"phase 16 fleet curve {key} {json.dumps(out[key])}; "
                  f"card {card}", flush=True)
    return out


def fleet_card_bars(dev) -> dict:
    """B = 1 against ``UniformSim`` at 256^2 from step 9 (the last exact
    startup solve and a production step): bit for bit, clocks equal, no
    more reads; each
    member of a B = 8 fleet at 1024^2 (the benchmark velocity at
    amplitudes 0.8**m, ``FLEET_BAR_STEPS`` production steps) against its
    solo run:
    <= FLEET_SOLO_REL relative with equal iterations; a B = 4 fleet at
    64^2, 6 steps from step 6 (4 exact startup solves, 2 production
    steps), card against CPU <= TRAJ_REL."""
    from cup2d_tpu_torch import shapes_host
    from cup2d_tpu_torch.fleet import FleetSim, stack_states
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    out, secs = {}, {}
    for pois in ("", "fas"):
        name = pois or "default"
        t0 = time.perf_counter()
        with latched(pois):
            f = FleetSim(cfg, level=5, members=1, device=dev)
            u = UniformSim(cfg, level=5, device=dev)
        f.state = stack_states([taylor_green_state(f.grid)])
        u.state = taylor_green_state(u.grid)
        f.step_count = u.step_count = 9
        reads = [0, 0]
        for _ in range(2):
            p0 = shapes_host.pulls
            u.step_once()
            p1 = shapes_host.pulls
            f.step_once()
            reads[0] += p1 - p0
            reads[1] += shapes_host.pulls - p1
        same = (torch.equal(u.state.vel, f.state.vel[0])
                and torch.equal(u.state.pres, f.state.pres[0])
                and u.time == f.time)
        check(same, f"phase 16 B=1 {name}: not bit for bit UniformSim")
        check(reads[1] <= reads[0], f"phase 16 B=1 {name}: reads {reads}")
        out[f"b1 {name}"] = {"bit_for_bit": same, "reads_solo_fleet": reads}
        secs[f"b1 {name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        cfg8, level8 = bench_cfg(1024, 1024)
        with latched(pois):
            f = FleetSim(cfg8, level=level8, members=8, device=dev)
        base = bench_start(f.grid)
        f.state = stack_states([base._replace(vel=base.vel * 0.8 ** m)
                                for m in range(8)])
        f.step_count = 20
        solos = []
        for m in range(8):
            with latched(pois):
                s = UniformSim(cfg8, level=level8, device=dev)
            s.state = base._replace(vel=base.vel * 0.8 ** m)
            s.step_count = 20
            solos.append(s)
        worst, iters_equal, iters = 0.0, True, []
        for _ in range(FLEET_BAR_STEPS):
            d = f.step_once()
            ds = [s.step_once() for s in solos]
            iters.append(d["poisson_iters"].tolist())
            iters_equal &= d["poisson_iters"].tolist() == [
                x["poisson_iters"] for x in ds]
        for m, s in enumerate(solos):
            rel = float((f.state.vel[m] - s.state.vel).abs().max()
                        / s.state.vel.abs().max())
            worst = max(worst, rel)
            check(abs(f.times[m] - s.time) <= 1e-5 * s.time,
                  f"phase 16 B=8 {name} member {m}: clock")
        check(worst <= FLEET_SOLO_REL and iters_equal,
              f"phase 16 B=8 {name}: rel {worst}, iterations equal "
              f"{iters_equal}")
        out[f"b8 vs solo {name}"] = {"rel": worst, "iters": iters}
        secs[f"b8 {name}"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    card, cpu = (fleet_sim(d, 64, 4) for d in (dev, "cpu"))
    card.step_count = cpu.step_count = 6
    for _ in range(6):
        card.step_once()
        cpu.step_once()
    rel = float((card.state.vel.cpu() - cpu.state.vel).abs().max()
                / cpu.state.vel.abs().max())
    check(rel <= TRAJ_REL, f"phase 16 B=4 64^2 card vs CPU: rel {rel}")
    out["b4 64^2 card vs cpu"] = {"rel": rel,
                                  "times_rel": float(np.max(np.abs(
                                      card.times - cpu.times) / cpu.times))}
    secs["card vs cpu"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def serve_run(out: str, faults: str | None = None, extra=()) -> dict:
    """``main()`` in process with ``SERVE_FLAGS`` and ``extra`` into
    ``out`` (and ``CUP2D_FAULTS=faults``), its pool starting at
    ``SERVE_FIRST_STEP``: rc, seconds, metrics records, events, the
    ``serving_latency`` record, and the device reads and kernel builds
    over the whole run (``shapes_host.pulls``,
    ``hopper_kernels.build_events``)."""
    from cup2d_tpu_torch import __main__ as tmain
    from cup2d_tpu_torch import shapes_host
    from cup2d_tpu_torch.fleet import FleetSim
    from cup2d_tpu_torch.profiling import load_metrics
    if faults:
        os.environ["CUP2D_FAULTS"] = faults
    init = FleetSim.__init__

    def production_pool(sim, *a, **k):
        init(sim, *a, **k)
        sim.step_count = SERVE_FIRST_STEP

    FleetSim.__init__ = production_pool
    reads0, builds0 = shapes_host.pulls, hk.build_events
    t0 = time.perf_counter()
    try:
        rc = tmain.main(SERVE_FLAGS.split() + list(extra) + ["-output", out])
    finally:
        FleetSim.__init__ = init
        os.environ.pop("CUP2D_FAULTS", None)
    secs = time.perf_counter() - t0
    reads, builds = shapes_host.pulls - reads0, hk.build_events - builds0
    check(rc == 0, f"phase 16 serve {out}: rc {rc}")
    rows = load_metrics(os.path.join(out, "metrics.jsonl"))
    recs = [r for r in rows if r.get("event") == "metrics"]
    lat = [r for r in rows if r.get("event") == "serving_latency"]
    check(len(lat) == 1, "phase 16 serve: no serving_latency record")
    return {"seconds": secs, "records": recs, "events": _events(out),
            "latency": lat[0], "out": out, "reads": reads,
            "builds": builds,
            "ledger": [r for r in rows if r.get("event") == "compile_ledger"]}


# the plain serving run turns the flight recorder's spans and allocator
# peaks off; the observed one times the phases and writes the spans
SERVE_PLAIN = ("-noSpans", "-noMemLedger")
SERVE_OBSERVED = ("-profile", "-spansLog")


def serve_observed(card: str, plain: dict) -> dict:
    """The unfaulted serving run again with ``-profile -spansLog PATH``
    against ``plain`` (``SERVE_PLAIN``): every session checkpoint and
    event bit-equal, equal device reads and kernel builds over each whole
    run, the same device reads in every record; then ``post --trace`` on
    the span file. Returns the row printed."""
    from cup2d_tpu_torch import post as tpost
    d = os.path.join(PHASE16_DIR, "serve_obs")
    spans = os.path.join(PHASE16_DIR, "spans_obs.jsonl")
    obs = serve_run(d, extra=SERVE_OBSERVED + (spans,))
    # the plain run's sessions, kept for phase_fleet's faulted comparison
    sp, so = _sessions(plain["out"]), _sessions(d)
    plain["sessions"] = sp
    same = sorted(sp) == sorted(so) and all(
        all(np.array_equal(sp[c][0][k], so[c][0][k]) for k in sp[c][0])
        and sp[c][1]["time"] == so[c][1]["time"]
        and sp[c][1]["next_dt"] == so[c][1]["next_dt"] for c in sp)

    def evs(run):
        return [{k: v for k, v in e.items()
                 if k not in ("wall", "checkpoint")} for e in run["events"]]
    same &= evs(plain) == evs(obs)
    gets = ([r["device_gets"] for r in plain["records"]]
            == [r["device_gets"] for r in obs["records"]])
    check(tpost.main(["--trace", spans]) == 0, "phase 16: post --trace")
    with open(os.path.join(PHASE16_DIR, "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    names = {e["name"] for e in trace}
    clients = sum(e["ph"] == "M" and e["pid"] >= 1 << 20 for e in trace)
    phases = {k for r in obs["records"] for k in (r["phase_ms"] or {})}
    ledger = obs["ledger"][0] if obs["ledger"] else {}
    row = {"bit_for_bit": bool(same), "reads": [plain["reads"],
                                                obs["reads"]],
           "builds": [plain["builds"], obs["builds"]],
           "record_reads_equal": gets,
           "seconds": [plain["seconds"], obs["seconds"]],
           "median_wall_ms": [float(np.median([r["wall_ms"] for r in
                                               run["records"]]))
                              for run in (plain, obs)],
           "span_count": obs["records"][-1]["span_count"],
           "hbm_exec_bytes": ledger.get("hbm_exec_bytes"),
           "trace_events": len(trace), "client_tracks": clients,
           "phases": sorted(phases)}
    print(f"phase 16 observed serving {json.dumps(row)}; card {card}",
          flush=True)
    check(same and gets and plain["reads"] == obs["reads"]
          and plain["builds"] == obs["builds"] == 0,
          f"phase 16: the observed serving run differs from the plain "
          f"one {row}")
    flags = SERVE_FLAGS.split()
    n_serve = int(flags[flags.index("-serve") + 1])
    check({"admit", "retire", "fleet.step", "step"} <= names
          and clients == n_serve and phases == {"step"}
          and (ledger.get("hbm_exec_bytes") or 0) > 0,
          f"phase 16: the observed run's trace, phases or ledger {row}")
    return row


def serve_summary(run: dict) -> dict:
    recs, evs = run["records"], run["events"]
    members = recs[0]["fleet_members"]
    first = next(k for k, r in enumerate(recs)
                 if r["active_members"] < members or r["admitted"] > members)
    # the production steps (the first 10 run the exact solves)
    prod = [r for r in recs if r["step"] > 10]
    wall = [r["wall_ms"] for r in prod]
    pct = {kind: {q: run["latency"]["pool"][kind].get(q)
                  for q in ("count", "p50_ms", "p90_ms", "p99_ms")}
           for kind in ("queue_wait", "admit_to_first_step", "step")}
    return {"seconds": run["seconds"], "steps": len(recs),
            "admitted": recs[-1]["admitted"],
            "retired": sum(e["event"] == "member_retire" for e in evs),
            "evicted": recs[-1]["evicted"],
            "occupancy_mean": float(np.mean([r["occupancy"] for r in recs])),
            "startup_ms": float(sum(r["wall_ms"] for r in recs
                                    if r["step"] <= 10)),
            "production_median_wall_ms": float(np.median(wall)),
            "production_member_steps_per_s": float(
                sum(r["active_members"] for r in prod) / (1e-3 * sum(wall))),
            "jit_compiles_from_first_retirement": sum(
                r["jit_compiles"] for r in recs[first:]),
            "jit_compiles_total": sum(r["jit_compiles"] for r in recs),
            "latency": pct}


def _sessions(out: str) -> dict:
    root = os.path.join(out, "sessions")
    res = {}
    for cid in sorted(os.listdir(root)):
        with np.load(os.path.join(root, cid, "fields.npz")) as d:
            fields = {k: d[k] for k in d.files}
        with open(os.path.join(root, cid, "meta.json")) as f:
            res[cid] = (fields, json.load(f))
    return res


def serve_resume(dev) -> dict:
    """A session parked at about half its horizon and admitted again from
    its checkpoint against the one served straight through, at 1024^2:
    state, clock and chained dt bit for bit."""
    from cup2d_tpu_torch.fleet import FleetRequest, FleetServer
    from cup2d_tpu_torch.io import load_member_checkpoint

    def serve(sdir, horizons):
        sim = fleet_sim(dev, 1024, 2, nu=1e-3, cfl=0.4)
        sim.step_count = 20
        st0 = type(sim.state)(*(a[0].clone() for a in sim.state))
        server = FleetServer(sim, session_dir=sdir)
        ckpt = None
        for t_end in horizons:
            server.submit(FleetRequest(client_id="X", checkpoint=ckpt,
                                       state=None if ckpt else st0,
                                       t_end=t_end))
            check(server.drain() > 0, "phase 16 resume: no step")
            ckpt = os.path.join(sdir, "X")
        return load_member_checkpoint(ckpt, sim.grid)

    probe = fleet_sim(dev, 1024, 1, nu=1e-3, cfl=0.4)
    dt0 = float(probe.grid.compute_dt(probe.state.vel[0]))
    (st_r, m_r) = serve(os.path.join(PHASE16_DIR, "ref"), [8.6 * dt0])
    (st_s, m_s) = serve(os.path.join(PHASE16_DIR, "split"),
                        [4.6 * dt0, 8.6 * dt0])
    same = (all(torch.equal(a, b) for a, b in zip(st_r, st_s))
            and m_r["time"] == m_s["time"]
            and m_r["next_dt"] == m_s["next_dt"])
    check(same, "phase 16: a parked session did not resume bit for bit")
    return {"bit_for_bit": same, "t": m_r["time"]}


class solo_steps:
    """Counts ``FleetSim.member_step_once`` calls (the guard's solo
    replays and retries, L = 1 launches) while the block runs."""

    def __enter__(self):
        from cup2d_tpu_torch.fleet import FleetSim
        self.cls, self.orig, self.n = FleetSim, FleetSim.member_step_once, 0

        def counted(sim, *a, **kw):
            self.n += 1
            return self.orig(sim, *a, **kw)
        FleetSim.member_step_once = counted
        return self

    def __exit__(self, *exc):
        self.cls.member_step_once = self.orig


def phase_fleet(dev, card: str) -> tuple[dict, dict]:
    """Phase 16: fleets and the serving pool on the card. Launches of
    kernels 2, 5 and 6 from 0 over the fleet steps alone, each > 0 and
    each with L = B (no solo member step among them): the dispatch
    amortization curves, the unfaulted serving run and the parked-session
    resume. Outside that count: the card bars (solo runs beside the
    fleets) and the serving run with one eviction, whose launches include
    the ladder's solo member steps and are printed on their own line. No
    twin called on the card's f32 operands. Files under build/phase16,
    removed at the end."""
    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    os.makedirs(PHASE16_DIR)
    out = {}
    with twin_watch(TWINS) as tw:
        hk.reset_launches()
        with solo_steps() as solo:
            t0 = time.perf_counter()
            out["curves"] = fleet_curves(dev, card)
            t1 = time.perf_counter()
            runs = {"unfaulted": serve_run(os.path.join(PHASE16_DIR,
                                                        "serve"),
                                           extra=SERVE_PLAIN)}
            t2 = time.perf_counter()
            observed = serve_observed(card, runs["unfaulted"])
            out["resume"] = serve_resume(dev)
            print(f"phase 16 seconds: curves {t1 - t0}, serving {t2 - t1}, "
                  f"resume {time.perf_counter() - t2}", flush=True)
        launches = {k: hk.launches[k] for k in FLEET_KEYS}
        check(solo.n == 0, f"phase 16: {solo.n} solo member steps among "
              "the fleet steps' launches")
        t0 = time.perf_counter()
        out["bars"] = fleet_card_bars(dev)
        t1 = time.perf_counter()
        print(f"phase 16 card bars {json.dumps(out['bars'])}", flush=True)
        hk.reset_launches()
        with solo_steps() as solo:
            runs["faulted"] = serve_run(os.path.join(PHASE16_DIR, "serve_f"),
                                        SERVE_FAULT)
        print(f"phase 16 seconds: card bars {t1 - t0}, faulted serving "
              f"{time.perf_counter() - t1}", flush=True)
        faulted = {k: hk.launches[k] for k in FLEET_KEYS}
        faulted["solo_member_steps"] = solo.n
    check(not any(tw.calls.values()),
          f"phase 16: twins called on the card's f32 operands {tw.calls}")
    summ = {k: serve_summary(r) for k, r in runs.items()}
    u, f = summ["unfaulted"], summ["faulted"]
    flags = SERVE_FLAGS.split()
    n_serve = int(flags[flags.index("-serve") + 1])
    check(u["admitted"] == u["retired"] == n_serve and u["evicted"] == 0,
          f"phase 16 serve: {u['admitted']} admitted, {u['retired']} "
          f"retired, {u['evicted']} evicted")
    evicted = [e["client"] for e in runs["faulted"]["events"]
               if e["event"] == "member_evict"]
    check(len(evicted) == 1 and f["evicted"] == 1
          and f["retired"] == n_serve - 1,
          f"phase 16 faulted serve: evicted {evicted}, {f['retired']} "
          "retired")
    su = runs["unfaulted"].pop("sessions")
    sf = _sessions(runs["faulted"]["out"])
    check(sorted(sf) == sorted(c for c in su if c not in evicted),
          "phase 16: the faulted run's sessions")
    same = all(all(np.array_equal(su[c][0][k], sf[c][0][k])
                   for k in su[c][0])
               and su[c][1]["time"] == sf[c][1]["time"]
               and su[c][1]["next_dt"] == sf[c][1]["next_dt"] for c in sf)
    check(same, "phase 16: a healthy session differs under the eviction")
    for k, v in summ.items():
        check(v["jit_compiles_from_first_retirement"] == 0,
              f"phase 16 serve {k}: kernel builds after the first "
              "retirement")
    summ["healthy_sessions_bit_for_bit"] = same
    summ["evicted_client"] = evicted[0]
    out["serve"] = summ
    print(f"phase 16 serving {json.dumps(summ)}; card {card}", flush=True)
    print(f"phase 16 resume {json.dumps(out['resume'])}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k}: launched no time in the fleet runs")
    print(f"phase 16 launches, fleet steps only (L = B) "
          f"{json.dumps(launches)}; card {card}", flush=True)
    print(f"phase 16 launches, faulted serving run (with the ladder's "
          f"solo member steps, L = 1) {json.dumps(faulted)}; card {card}",
          flush=True)
    out["faulted_serve_launches"] = faulted
    out["observed_serve"] = observed
    shutil.rmtree(PHASE16_DIR)
    return out, launches


# ---------------------------------------------------------------------------
# phase 17: the forest on a mesh and the forest's left-overs
# ---------------------------------------------------------------------------

PHASE17_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase17")
MESH_STEPS = 6           # production steps after the adapt: 2 warm, 3
MESH_TIMED = (2, 5)      # timed to a synchronize, the last traced
MESH_CLI_STEPS = 12      # the canonical CLI on the mesh: 10 startup, 2
#                          production (phase 14 runs 22)
FOREST_MESH_KEYS = FOREST_KEYS
MESH_REMESH_D = 2        # (a)'s re-mesh: MESH_D shards of the card to 2


def _gathered(sim) -> dict:
    return {k: sim._gather(v) for k, v in sim._ordered_state().items()}


def mesh_forest_run(sim, label: str, seen: dict | None = None) -> dict:
    """One adapt, then ``MESH_STEPS`` production steps of ``sim``: each
    step's iterations and lab-RHS / block-Jacobi launches, ms a step over
    ``MESH_TIMED`` to a synchronize, and the last step traced
    (``torch.profiler``: idle share). ``seen`` collects the last per-shard
    operands of kernels 4 and 8."""
    dev = sim.device
    sync(dev)
    t0 = time.perf_counter()
    changed = sim.adapt()
    sim._refresh()
    sync(dev)
    adapt_s = time.perf_counter() - t0
    iters, launches = [], []
    trace = os.path.join(PHASE17_DIR, f"{label.replace(' ', '_')}.json")
    lab_rhs, upd = tamr.fused_lab_rhs, tsh.fused_block_jacobi_update
    if seen is not None:
        def keep_lab(lab, h, nu, dt):
            seen["lab"] = (lab, h, nu, dt)
            return lab_rhs(lab, h, nu, dt)

        def keep_upd(e, r, lap, p_inv):
            seen["upd"] = (e, r, lap, p_inv)
            return upd(e, r, lap, p_inv)
        tamr.fused_lab_rhs, tsh.fused_block_jacobi_update = keep_lab, keep_upd
    try:
        for k in range(MESH_STEPS):
            if k == MESH_TIMED[0]:
                sync(dev)
                tsh.reset_comm_stats()
                t_timed = time.perf_counter()
            if k == MESH_TIMED[1]:
                sync(dev)
                timed = time.perf_counter() - t_timed
                joins = tsh.comm_by_kind(local=True)
                prof = _profiled(trace)
                prof.__enter__()
            hk.reset_launches()
            d = sim.step_once()
            launches.append({k2: hk.launches[k2] for k2 in FOREST_MESH_KEYS})
            iters.append(d["poisson_iters"])
            check(d["finite"], f"{label}: non-finite state at step {k}")
        sync(dev)
        prof.__exit__(None, None, None)
    finally:
        tamr.fused_lab_rhs, tsh.fused_block_jacobi_update = lab_rhs, upd
    n = MESH_TIMED[1] - MESH_TIMED[0]
    return {"mode": sim.poisson_mode, "blocks": len(sim.forest.blocks),
            "n_pad": sim._npad_hwm, "adapt_changed": changed,
            "adapt_s": adapt_s, "iters": iters,
            "ms_per_step": 1e3 * timed / n, "launches": launches,
            "joined_per_step": {k: [c / n, b / n]
                                for k, (c, b) in joins.items() if c},
            "trace": trace_summary(trace, 1)}


def mesh_remesh(sim, cfg, dev, label: str) -> dict:
    """(a)'s re-mesh: ``sim`` (split over ``MESH_D`` shards of the card)
    re-meshed onto ``MESH_REMESH_D`` shards, then 2 production steps
    beside a sim built on those shards from the same state
    (``copy_amr_state``): equal iterations and topology, the state bit
    for bit."""
    mesh2 = make_mesh(devices=[dev] * MESH_REMESH_D)
    fresh = ShardedAMRSim(cfg, mesh2, shapes=[])
    copy_amr_state(sim, fresh)
    sync(dev)
    t0 = time.perf_counter()
    sim.remesh(mesh2)
    sync(dev)
    remesh_s = time.perf_counter() - t0
    iters = [(sim.step_once()["poisson_iters"],
              fresh.step_once()["poisson_iters"]) for _ in range(2)]
    a, b = _gathered(sim), _gathered(fresh)
    same = (set(sim.forest.blocks) == set(fresh.forest.blocks)
            and all(bool(torch.equal(a[k], b[k])) for k in a)
            and all(x == y for x, y in iters))
    row = {"shards": [MESH_D, MESH_REMESH_D], "remesh_s": remesh_s,
           "iters": iters, "bit_for_bit": same,
           "parts": len(sim._ordered_state()["vel"].parts)}
    print(f"phase 17 mesh forest {label} remesh {json.dumps(row)}",
          flush=True)
    check(same and row["parts"] == MESH_REMESH_D,
          f"mesh forest {label}: the re-meshed run differs from a run built "
          f"on {MESH_REMESH_D} shards")
    return row


def phase_mesh_forest(dev, forest_start: tuple, card: str
                      ) -> tuple[dict, dict]:
    """Phase 17 (a): phase 5's forest as a ``ShardedAMRSim`` on
    ``MESH_D`` shards of the card against the same forest solo, under the
    default solver and fas: one adapt and ``MESH_STEPS`` production steps
    each; equal iterations and topologies, velocity and pressure bit for
    bit; kernels 4, 8 (P_inv r, and the sweeps under fas) and
    ``group_sum.cu`` launched once per shard where solo launches once (lab
    RHS 2 x MESH_D a step); 4 and 8 held against their twins on the last
    shard operands and timed at those shapes (by the caller, outside its
    twin watch); halo bytes of one exchange; the bytes joined on the home
    a step by kind (the reductions' group partials only); after the
    default run, a re-mesh 4 -> 2 shards (``mesh_remesh``). Returns the
    runs, the split runs' launches and those operands."""
    cfg, snap = forest_start
    mesh = make_mesh(devices=[dev] * MESH_D)
    out, total, seen = {}, {k: 0 for k in FOREST_MESH_KEYS}, {}
    for pois in ("", "fas"):
        name = pois or "default"
        runs = {}
        for label in ("solo", "split"):
            with latched(pois or "structured"):
                sim = (ShardedAMRSim(cfg, mesh, shapes=[]) if label == "split"
                       else AMRSim(cfg, shapes=[], device=dev))
            forest_from_numpy(sim, *snap)
            sim.step_count = 10
            runs[label] = mesh_forest_run(
                sim, f"mesh forest {name} {label}",
                seen if label == "split" else None)
            runs[label]["keys"] = set(sim.forest.blocks)
            runs[label]["state"] = _gathered(sim)
            if label == "split":
                runs[label]["comm"] = dict(sim._comm_stats)
                if not pois:
                    remesh = mesh_remesh(sim, cfg, dev, name)
            del sim
        solo, split = runs["solo"], runs["split"]
        rel = max(float((split["state"][k] - solo["state"][k]).abs().max()
                        / solo["state"][k].abs().max().clamp_min(1e-30))
                  for k in ("vel", "pres"))
        row = {"mode": split["mode"], "blocks": split["blocks"],
               "n_pad": split["n_pad"], "shards": MESH_D,
               "iters": split["iters"], "solo_iters": solo["iters"],
               "rel": rel, "bit_for_bit": rel == 0.0,
               "split_ms_per_step": split["ms_per_step"],
               "solo_ms_per_step": solo["ms_per_step"],
               "split_adapt_s": split["adapt_s"],
               "solo_adapt_s": solo["adapt_s"],
               "split_idle_share": split["trace"]["idle_share"],
               "solo_idle_share": solo["trace"]["idle_share"],
               "split_trace": split["trace"], "comm": split["comm"],
               "joined_per_step": split["joined_per_step"],
               "launches_per_step": split["launches"][-1],
               "solo_launches_per_step": solo["launches"][-1]}
        if not pois:
            row["remesh"] = remesh
        print(f"phase 17 mesh forest {name} {json.dumps(row)}; card {card}",
              flush=True)
        check(split["keys"] == solo["keys"],
              f"mesh forest {name}: the split adapt's topology differs")
        check(split["iters"] == solo["iters"],
              f"mesh forest {name}: iterations {split['iters']} != solo "
              f"{solo['iters']}")
        check(rel == 0.0, f"mesh forest {name}: split vs solo {rel}, not "
              "bit for bit")
        joined = split["joined_per_step"]
        check("preconditioner" not in joined
              and joined["reductions"][1] <= joined["reductions"][0]
              * split["n_pad"] // 16 * 8,
              f"mesh forest {name}: a whole operand joined a step {joined}")
        for k, (ls, lo, it) in enumerate(zip(split["launches"],
                                             solo["launches"],
                                             split["iters"])):
            check(ls["fused_lab_rhs"] == MESH_D * lo["fused_lab_rhs"] == 2 *
                  MESH_D, f"mesh forest {name} step {k}: lab-RHS launches "
                  f"{ls} (solo {lo}) != 2 x {MESH_D}")
            for key in ("fused_block_jacobi_update",
                        "fused_block_jacobi_update+pinv", "group_sum"):
                want = MESH_D * lo[key]
                check(ls[key] == want and (want > 0) == (
                    it > 0 or key == "group_sum"),
                      f"mesh forest {name} step {k}: {key} launches {ls} "
                      f"(solo {lo})")
        for k in FOREST_MESH_KEYS:
            total[k] += sum(ls[k] for ls in split["launches"])
        out[name] = row
    check(split["comm"]["halo_real_bytes"] > 0,
          f"mesh forest: no halo bytes {split['comm']}")
    return out, total, seen


def _dump_attrs(d: str) -> dict:
    from cup2d_tpu_torch.io import read_dump
    names = sorted(n[:-len(".xdmf2")] for n in os.listdir(d)
                   if n.startswith("vel.") and n.endswith(".xdmf2"))
    return {n: read_dump(os.path.join(d, n)) for n in names}


def _dumps_close(label: str, a: dict, b: dict, bar: float,
                 phase: str = "phase 17") -> tuple:
    """Every common dump of two runs: the same time and geometry, the
    velocities within ``bar`` of max |a|. Prints each dump's figures."""
    common = sorted(set(a) & set(b))
    check(len(common) >= 2, f"{label}: common dumps {common}")
    rows = []
    for n in common:
        (ta, xa, va), (tb, xb, vb) = a[n], b[n]
        same = ta == tb and xa.shape == xb.shape and np.array_equal(xa, xb)
        rel = (float(np.abs(va - vb).max() / max(np.abs(va).max(), 1e-30))
               if va.shape == vb.shape else float("inf"))
        rows.append((n, ta, tb, same, rel))
    print(f"{phase} {label}: {json.dumps(rows)}", flush=True)
    for n, ta, tb, same, rel in rows:
        check(same, f"{label}: {n} time {ta} / {tb} or geometry differs")
    worst = max(r[4] for r in rows)
    check(worst <= bar, f"{label}: dumps {worst} > {bar}")
    return len(common), worst


def phase_mesh_cli(dev, card: str) -> dict:
    """Phase 17 (b): ``main(["-device", "cuda:<i>", "-mesh", "4", <run.sh
    flags>])``, supervised, ``MESH_CLI_STEPS`` steps with a dump each and
    a step-10 checkpoint: every dump within ``SHARDED_REL`` of phase 14's
    unsharded run; its ``-mesh 4`` restart from that checkpoint bit for
    bit its own run (dumps, iterations), and the restart without
    ``-mesh`` within ``SHARDED_REL``. Kernel 4 launched 2 x MESH_D a
    step."""
    dev_s = f"cuda:{torch.device(dev).index or torch.cuda.current_device()}"
    dir_a = os.path.join(PHASE14_DIR, "canonical")
    dir_m, dir_r, dir_s = (os.path.join(PHASE17_DIR, n)
                           for n in ("mesh", "restart", "solo"))
    argv = canon_cli_argv(supervised=True) + [
        "-device", dev_s, "-maxSteps", str(MESH_CLI_STEPS),
        "-checkpointEvery", str(CANON_CKPT_EVERY)]
    mesh = ["-mesh", str(MESH_D)]
    hk.reset_launches()
    m = cli_run(argv + mesh, dir_m, keep=True)
    lm = {k: n for k, n in hk.launches.items() if n}
    check(m["rc"] == 0, f"mesh canonical cli: rc {m['rc']}")
    check(lm.get("fused_lab_rhs", 0) == 2 * MESH_D * MESH_CLI_STEPS,
          f"mesh canonical cli: launches {lm}")
    dumps_m = _dumps_close("mesh canonical cli vs phase 14",
                           _dump_attrs(dir_m), _dump_attrs(dir_a),
                           SHARDED_REL)
    step10 = os.path.join(dir_m, f"checkpoint.{CANON_CKPT_EVERY}")
    r = cli_run(argv + mesh + ["-restart", step10], dir_r)
    s_ = cli_run(argv + ["-restart", step10], dir_s)
    check(r["rc"] == 0 and s_["rc"] == 0,
          f"mesh restarts: rc {r['rc']}, {s_['rc']}")
    am, ar = _dump_attrs(dir_m), _dump_attrs(dir_r)
    common = sorted(set(am) & set(ar))
    check(len(common) >= 2 and all(
        np.array_equal(am[n][2], ar[n][2]) for n in common),
        f"mesh restart: dumps {common} not bit for bit")
    it_m = [(x["step"], x["poisson_iters"]) for x in m["records"]
            if x["step"] > CANON_CKPT_EVERY]
    it_r = [(x["step"], x["poisson_iters"]) for x in r["records"]]
    check(it_m == it_r, f"mesh restart: iterations {it_m} != {it_r}")
    dumps_s = _dumps_close("restart without -mesh", am, _dump_attrs(dir_s),
                           SHARDED_REL)
    rec = m["records"][-1]
    out = {"seconds": m["seconds"], "steps": len(m["records"]),
           "production_ms_per_step": float(np.median(
               [x["wall_ms"] for x in m["records"]
                if x["step"] > CANON_CKPT_EVERY])),
           "startup_ms_per_step": float(np.median(
               [x["wall_ms"] for x in m["records"]
                if x["step"] <= CANON_CKPT_EVERY])),
           "dumps_vs_phase14": dumps_m, "restart_bit_for_bit": True,
           "restart_dumps": len(common), "solo_restart_vs_mesh": dumps_s,
           "halo_real_bytes": rec["halo_real_bytes"],
           "halo_padded_bytes": rec["halo_padded_bytes"],
           "n_blocks": rec["n_blocks"], "launches": lm,
           "restart_seconds": r["seconds"], "solo_seconds": s_["seconds"]}
    check(rec["halo_real_bytes"] is not None,
          "mesh canonical cli: no halo bytes in the metrics")
    print(f"phase 17 mesh canonical cli {json.dumps(out)}; card {card}",
          flush=True)
    return out


def forest_ms(sim, steps: int = 4) -> tuple[float, list]:
    """ms a production step of ``sim`` over ``steps`` steps after one warm
    step, to a synchronize, and the iterations."""
    dev = sim.device
    iters = [sim.step_once()["poisson_iters"]]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        iters.append(sim.step_once()["poisson_iters"])
    sync(dev)
    return 1e3 * (time.perf_counter() - t0) / steps, iters


def phase_leftovers(dev, forest_start: tuple, card: str) -> dict:
    """Phase 17 (c): ``CUP2D_POIS=tables`` on phase 6's 355-block forest
    (card against CPU at phase 6's default tolerances; ms a step against
    ``structured``); ``CUP2D_PREC=bf16`` with fas on phase 5's forest
    (iterations and ms a step against f32 fas) and on phase 6's forest
    card against CPU within ``BF16_BAND``; ``adapt()`` at phase 5's 10,529
    blocks with the C regrid helper against ``_fix_states_py`` (equal
    topologies); ``-mesh 4`` on the uniform CLI path, 4 production steps
    at 1024^2 from a Taylor-Green checkpoint at step 10."""
    out = {}
    phase_forest_cpu(dev, "tables", tol=1e-6, tol_rel=1e-5)
    for pois in ("structured", "tables"):
        with latched(pois):
            sim = multilevel_forest(dtype="float32", device=dev)
        ms, it = forest_ms(sim)
        out[f"multilevel {pois}"] = {
            "ms_per_step": ms, "iters": it, "blocks": len(sim.forest.blocks)}
    os.environ["CUP2D_PREC"] = "bf16"
    try:
        phase_forest_cpu(dev, "fas", bar=BF16_BAND)
    finally:
        os.environ.pop("CUP2D_PREC", None)
    cfg, snap = forest_start
    for prec in ("f32", "bf16"):
        with latched("fas", prec):
            sim = AMRSim(cfg, shapes=[], device=dev)
        forest_from_numpy(sim, *snap)
        sim.step_count = 10
        ms, it = forest_ms(sim)
        out[f"vortex fas {prec}"] = {"ms_per_step": ms, "iters": it,
                                     "smoother_tier": sim.smoother_tier}
    check(out["vortex fas bf16"]["smoother_tier"] == "strip+bf16",
          f"bf16 forest: tier {out['vortex fas bf16']['smoother_tier']}")
    # the regrid's 2:1 sweeps: the C helper against its Python twin
    adapted = {}
    for helper in ("native", "python"):
        sim = AMRSim(cfg, shapes=[], device=dev)
        forest_from_numpy(sim, *snap)
        sim._refresh()
        fix = sim._fix_states
        secs = []
        if helper == "python":
            def fix_py(lv, biv, bjv, st, sim=sim):
                state = {(int(lv[k]), int(biv[k]), int(bjv[k])): int(st[k])
                         for k in range(len(st))}
                sim._fix_states_py(state)
                for k in range(len(st)):
                    st[k] = state[(int(lv[k]), int(biv[k]), int(bjv[k]))]
            fix = fix_py

        def timed_fix(*a, fix=fix):
            t0 = time.perf_counter()
            fix(*a)
            secs.append(time.perf_counter() - t0)
        sim._fix_states = timed_fix
        sync(dev)
        t0 = time.perf_counter()
        changed = sim.adapt()
        sim._refresh()
        sync(dev)
        adapted[helper] = set(sim.forest.blocks)
        out[f"adapt {helper}"] = {"adapt_s": time.perf_counter() - t0,
                                  "fix_states_s": sum(secs),
                                  "changed": changed,
                                  "blocks": len(sim.forest.blocks)}
        del sim
    check(adapted["native"] == adapted["python"],
          "adapt: the C helper's topology differs from the Python sweep's")
    # the uniform path on -mesh 4: production steps 11-14, restarted from
    # a Taylor-Green checkpoint at step 10 (the split default solver's
    # exact startup solves take seconds a step)
    from cup2d_tpu_torch.io import save_checkpoint
    argv = ["-bpdx", "1", "-bpdy", "1", "-levelMax", "1", "-levelStart",
            "0", "-AdaptSteps", "20", "-Rtol", "2", "-Ctol", "1", "-extent",
            "1", "-CFL", "0.4", "-nu", "4e-5", "-lambda", "1e6",
            "-poissonTol", "1e-3", "-poissonTolRel", "1e-2",
            "-maxPoissonRestarts", "0", "-maxPoissonIterations", "100",
            "-tend", "1", "-tdump", "0", "-level", "7", "-dtype", "float32"]
    tg = UniformSim(SimConfig.from_argv(argv), level=7, device=dev)
    tg.state = taylor_green_state(tg.grid)
    tg.step_count = 10
    ck = os.path.join(PHASE17_DIR, "uniform_step10")
    save_checkpoint(ck, tg)
    del tg
    hk.reset_launches()
    u = cli_run(argv + ["-maxSteps", "14", "-restart", ck, "-device",
                        f"cuda:{torch.cuda.current_device()}", "-mesh",
                        str(MESH_D)], os.path.join(PHASE17_DIR, "uniform"))
    lu = {k: n for k, n in hk.launches.items() if n}
    check(u["rc"] == 0 and lu.get("advect_substage_halo", 0)
          == 2 * MESH_D * 4, f"uniform -mesh {MESH_D}: rc {u['rc']}, "
          f"launches {lu}")
    out["uniform mesh cli"] = {"seconds": u["seconds"], "launches": lu,
                               "ms_per_step": [x["wall_ms"]
                                               for x in u["records"]]}
    print(f"phase 17 left-overs {json.dumps(out)}; card {card}", flush=True)
    return out


def phase_mesh(dev, forest_start: tuple, forest_warm: tuple, card: str
               ) -> tuple[dict, dict]:
    """Phase 17: (a) the sharded forest (from ``forest_warm``), (b) the
    canonical CLI on a mesh, (c) the forest's left-overs (from
    ``forest_start``). Removes phase 14's and its own files."""
    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    os.makedirs(PHASE17_DIR)
    out = {}
    with twin_watch(FOREST_TWINS) as tw:
        t0 = time.perf_counter()
        out["forest"], launches, seen = phase_mesh_forest(dev, forest_warm,
                                                          card)
        out["forest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cli"] = phase_mesh_cli(dev, card)
        out["cli_s"] = time.perf_counter() - t0
    check(not any(tw.calls.values()),
          f"phase 17: twins called on the card's f32 operands {tw.calls}")
    out["forest"]["kernels"] = canonical_kernels(seen, "phase 17 per shard")
    del seen
    t0 = time.perf_counter()
    out["leftovers"] = phase_leftovers(dev, forest_start, card)
    out["leftovers_s"] = time.perf_counter() - t0
    print(f"phase 17 took (a) {out['forest_s']} s (b) {out['cli_s']} s "
          f"(c) {out['leftovers_s']} s", flush=True)
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    shutil.rmtree(PHASE17_DIR)
    return out, launches


# ---------------------------------------------------------------------------
# phase 18: periodic tables and fleets on the slab mesh
# ---------------------------------------------------------------------------

PHASE18_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase18")
SPLIT_PD_KEYS = ("advect_substage_halo+pd", "jacobi_halo_sweep+pd")
# the halo kernels' twins too: the split steps must run no twin of any
# kernel on the card's f32 operands
SPLIT_TWINS = TWINS + ("advect_substage_halo_plain",
                       "jacobi_halo_sweep_plain",
                       "jacobi_halo_sweep_slabs_plain")
PD_STEPS = 3              # timed production steps of (b), after a warm-up
FLEET18 = ("turb2d", 1024, 8)   # (c): the case, size, members
FLEET18_STEPS = 3         # timed fleet steps of (c), after a warm-up
CLI18_FLAGS = ["-case", "cavity", "-level", "4", "-fleet", "4",
               "-maxSteps", "2", "-tdump", "1e-6", "-noWatchdog"]
# (c)'s shaped fleet: 4096 x 2048 (8.39 M cells a member, above the
# 2048^2 member_cells_cap, so "auto" places it spatially), B members with
# frozen disks; a warm-up and SHAPED18_STEPS timed production steps
SHAPED18 = (2048, 4)      # ny (nx = 2 ny) and members
SHAPED18_STEPS = 1


def periodic_start(grid, kind: str):
    """A periodic grid's start, computed on its device in f64 and rounded:
    the catalog's ``tgv_periodic`` velocity (u0 sin(kx) cos(ky), k = 2 pi)
    or, on the channel, tests/test_torch_periodic.py's channel velocity
    (a wall-bounded shear with x modes; not solenoidal, so its production
    solves iterate)."""
    lx, ly = grid.cfg.extents
    x = ((torch.arange(grid.nx, device=grid.device, dtype=torch.float64)
          + 0.5) * grid.h)[None, :]
    y = ((torch.arange(grid.ny, device=grid.device, dtype=torch.float64)
          + 0.5) * grid.h)[:, None]
    if kind == "channel":
        px, py = 2 * np.pi * x / lx, np.pi * y / ly
        u = (torch.sin(py) * (1.0 + 0.3 * torch.cos(px))
             + 0.2 * torch.sin(2 * px) * torch.cos(3 * py))
        v = 0.25 * torch.sin(px) * torch.sin(py)
    else:
        k = 2.0 * np.pi / grid.cfg.extent
        u = torch.sin(k * x) * torch.cos(k * y)
        v = -(torch.cos(k * x) * torch.sin(k * y))
    vel = torch.stack([u, v]).to(grid.dtype)
    return grid.zero_state()._replace(vel=vel)


def periodic_cfg(kind: str, size: int = 8192):
    """(cfg, level, table): ``tgv_periodic``'s configuration at size^2 on
    the doubly-periodic table, or the benchmark's at size x size/4 on the
    periodic channel."""
    if kind == "tgv":
        return (cases._periodic_cfg(1e-3, "float32", 0.4),
                (size // 8).bit_length() - 1, PERIODIC_TABLES["doubly"])
    cfg, level = bench_cfg(size // 4, size)
    return cfg, level, PERIODIC_TABLES["channel"]


def periodic_grid(kind: str, dev, pois: str = "", mesh=None,
                  size: int = 8192):
    """(b)'s sims of ``periodic_cfg(kind, size)``, split over ``mesh``
    where given."""
    cfg, level, table = periodic_cfg(kind, size)
    with latched(pois):
        if mesh is None:
            return UniformSim(cfg, level=level, device=dev, bc=table)
        return ShardedUniformSim(cfg, mesh, level=level, bc=table)


def phase_split_periodic_kernels(dev, res, size: int = 8192) -> None:
    """Phase 18 (a): the y-wrap forms of kernels 3 and 7 at the split
    periodic step's shapes, MESH_D slabs of one card (4 cards cut to 1),
    on ``tgv_periodic``'s 8192^2 state and on the periodic channel's
    8192 x 2048 (``periodic_start``). Kernel 3's wrap form: the split
    pair (ring exchange) against kernel 2's solo wrap pair, <= 1 ulp;
    each shard's substages against their twin, <= 2e-6 relative. Kernel
    7's y-wrap forms (doubly periodic) and the ring of its signed forms
    (the channel): the split sweep against one wrap sweep of the chain
    kernel, <= 1 ulp; per shard (aux form) and as the slab list against
    the twins, <= 2e-6 relative; on the finest level, a split 64^2 level
    and a 16^2 level gathered onto one slab (its own neighbour). Kernel
    ms, twin ms, bound, beside the boundary-table forms' ms. Fills
    ``res`` for the two ``+pd`` halo entries."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    one = make_mesh(devices=[dev])
    nu = 4e-5
    err3 = 0.0
    for kind, name in (("tgv", "doubly"), ("channel", "channel")):
        cfg, level, table = periodic_cfg(kind, size)
        g = UniformGrid(cfg, level=level, device=dev, bc=table)
        h, ih2 = g.h, 1.0 / (g.h * g.h)
        cells = g.ny * g.nx
        v = periodic_start(g, kind).vel[None].contiguous()
        dt = torch.tensor([0.5], device=dev) * h
        solo = hk.fused_advect_heun(v, h, nu, dt, bc=table)
        split = gather_x(fused_advect_heun_sharded(split_x(v, mesh), h, nu,
                                                   dt, bc=table))
        u3 = ulps(split, solo)
        del split, solo
        check(u3 <= SPLIT_ULPS, f"advect_substage_halo+pd {name}: the split "
              f"pair is {u3} ulp from kernel 2's solo wrap pair")
        facs = hk._substage_facs(dt, h, nu, (1,), 1, torch.float32, dev,
                                 with_dt=True)
        w = g.nx // MESH_D
        s0 = split_x(v, mesh)
        aux0 = exchange_x(s0, 3, ring=True)
        kw = [dict(bc=table, h=h, col0=d * w, nx_tot=g.nx)
              for d in range(MESH_D)]
        s1 = Slabs([hk.advect_substage_halo(p, None, aux0[d], facs, 0.5, ih2,
                                            False, False, **kw[d])
                    for d, p in enumerate(s0.parts)], mesh)
        aux1 = exchange_x(s1, 3, ring=True)
        args = [((s0.parts[d], None, aux0[d], facs, 0.5, ih2, False, False),
                 (s1.parts[d], s0.parts[d], aux1[d], facs, 1.0, ih2, False,
                  False)) for d in range(MESH_D)]
        for d, (a1, a2) in enumerate(args):
            for k, a in ((1, a1), (2, a2)):
                err3 = max(err3, rel_close(
                    f"phase 18 advect_substage_halo+pd {name} shard {d} "
                    f"substage {k}", hk.advect_substage_halo(*a, **kw[d]),
                    hk.advect_substage_halo_plain(*a, **kw[d]), HEUN_ABS))

        def k3(sub):
            for d, (a1, _) in enumerate(args):
                sub(*a1, **kw[d])
            for d, (_, a2) in enumerate(args):
                sub(*a2, **kw[d])
        ms = cuda_ms(lambda: k3(hk.advect_substage_halo), 10)
        pms = cuda_ms(lambda: k3(hk.advect_substage_halo_plain), 1)
        aux_bytes = 2 * sum(a.numel() for a in aux0) * 4
        b = bound(substage_pair_bytes(cells, False) + aux_bytes,
                  sum(substage_ops(a[0]) for a1, a2 in args
                      for a in (a1, a2)))
        print(f"phase 18 advect_substage_halo+pd {name} [1,2,{g.ny},{w}] "
              f"x{MESH_D}, both substages: split vs solo wrap pair {u3} ulp;"
              f" kernel_ms {ms} (BC form "
              f"{res['advect_substage_halo+bc']['ms']}, free-slip "
              f"{res['advect_substage_halo']['ms']}) twin_ms {pms} bound_ms "
              f"{b[0]} ({b[1]})", flush=True)
        if name == "doubly":
            res["advect_substage_halo+pd"].update(
                ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                library_ms=None)
        del v, s0, s1, aux0, aux1, args, g
        torch.cuda.empty_cache()
    res["advect_substage_halo+pd"]["max_abs_err"] = err3

    gen = torch.Generator(device=dev).manual_seed(18)
    err7 = 0.0
    key = "jacobi_halo_sweep+pd"
    for name, table in PERIODIC_TABLES.items():
        sg, (px, _) = tbc.pressure_signs(table), tbc.periodic_axes(table)
        big = (size, size) if name == "doubly" else (size // 4, size)
        for (ny, nx), m in ((big, mesh), ((64, 64), mesh), ((16, 16), one)):
            e = torch.randn(ny, nx, generator=gen, device=dev)
            r = torch.randn(ny, nx, generator=gen, device=dev)
            es, rs = split_x(e, m), split_x(r, m)
            aux = exchange_x(es, 1, ring=px)
            for fz in (False, True):
                split = gather_x(overlap_jacobi_sweeps(es, rs, 0.8, 1, fz,
                                                       edge_signs=sg))
                u7 = ulps(split, hk.fused_jacobi_sweeps(e, r, 0.8, 1, fz,
                                                        sg))
                check(u7 <= SPLIT_ULPS, f"{key} {name} {ny}x{nx} "
                      f"from_zero={fz}: {u7} ulp from the chain kernel's "
                      "wrap sweep")
                print(f"phase 18 {key} {name} {ny}x{nx} on {m.size} slabs "
                      f"from_zero={fz} vs fused_jacobi_sweeps+pd (n=1): "
                      f"{u7} ulp", flush=True)
            for d in range(m.size):
                a = (es.parts[d], rs.parts[d], aux[d], 0.8, False, False,
                     False, sg)
                err7 = max(err7, rel_close(
                    f"phase 18 {key} {name} {ny}x{nx} shard {d}",
                    hk.jacobi_halo_sweep(*a), hk.jacobi_halo_sweep_plain(*a),
                    JACOBI_REL))
            err7 = max(err7, slab_list_close(f"phase 18 {key} {name}", es,
                                             rs, sg))
            if nx == size:
                cells = ny * nx
                ms = cuda_ms(lambda: overlap_jacobi_sweeps(
                    es, rs, 0.8, 1, edge_signs=sg), 10)
                aux_ms = cuda_ms(lambda: [hk.jacobi_halo_sweep(
                    es.parts[d], rs.parts[d], aux[d], 0.8, False, False,
                    False, sg) for d in range(m.size)], 10)
                pms = cuda_ms(lambda: hk.jacobi_halo_sweep_slabs_plain(
                    es.parts, rs.parts, 0.8, False, sg), 2)
                b = bound(12.0 * cells, OPS_SWEEP_CELL * cells)
                print(f"phase 18 {key} {name} {ny}x{nx} on {m.size} slabs: "
                      f"slab list kernel_ms {ms}, per-shard aux form "
                      f"{aux_ms} (signed form "
                      f"{res['jacobi_halo_sweep+bc']['ms']}, Neumann "
                      f"{res['jacobi_halo_sweep']['ms']}) twin_ms {pms} "
                      f"bound_ms {b[0]} ({b[1]})", flush=True)
                if name == "doubly":
                    res[key].update(ms=ms, aux_ms=aux_ms, plain_ms=pms,
                                    bound_ms=b[0], bound_by=b[1],
                                    library_ms=None)
            del e, r, es, rs, aux
    res[key]["max_abs_err"] = err7
    inv_diag_bc_slab.cache_clear()
    inv_diag_bc.cache_clear()
    torch.cuda.empty_cache()


def run_split_periodic(dev, kind: str, pois: str, size: int = 8192
                       ) -> dict:
    """Phase 18 (b) under one solver: the periodic box split into MESH_D
    slabs of the card, then the solo sim from the same state, a first
    step and ``PD_STEPS`` timed production steps at the CFL dt each, the
    launch counts from 0 and the twins watched. ``tgv``'s first step is
    its exact startup solve (from the Taylor-Green state the production
    solves meet their tolerance at iteration 0), the channel's a
    production warm-up."""
    mesh = make_mesh(devices=[dev] * MESH_D)
    out, vel = {}, {}
    for label, m in (("sharded", mesh), ("solo", None)):
        sim = periodic_grid(kind, dev, pois, m, size)
        st = periodic_start(sim.grid, kind)
        if m is None:
            sim.state = st
        else:
            sim.set_state(st)
        del st
        sim.step_count = 9 if kind == "tgv" else 10
        sync(dev)
        hk.reset_launches()
        sweep_stats.update(sweeps=0, exchanges=0)
        with twin_watch(SPLIT_TWINS) as tw:
            iters = [sim.step_once()["poisson_iters"]]
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(PD_STEPS):
                d = sim.step_once()
                iters.append(d["poisson_iters"])
            sync(dev)
        ms = (time.perf_counter() - t0) / PD_STEPS * 1e3
        out[label] = {
            "case": kind, "table": sim.bc_table, "tier": sim.kernel_tier,
            "mode": sim.poisson_mode, "shape": [sim.grid.ny, sim.grid.nx],
            "ms_per_step": ms, "iters": iters, "finite": bool(d["finite"]),
            "converged": bool(d["poisson_converged"]),
            "launches": {k: n for k, n in hk.launches.items() if n},
            "halo_sweeps": dict(sweep_stats), "twin_calls": tw.calls}
        v = sim.state.vel
        vel[label] = gather_x(v) if m is not None else v
        del sim, v
        torch.cuda.empty_cache()
    a, b = vel["sharded"], vel["solo"]
    out["vel_rel_linf"] = float((a - b).abs().max() / b.abs().max())
    out["bit_equal"] = bool(torch.equal(a, b))
    del a, b, vel
    print(f"phase 18 split periodic {kind} D={MESH_D} {json.dumps(out)}",
          flush=True)
    sh, so = out["sharded"], out["solo"]
    label = f"split periodic {kind} {pois or 'default'}"
    check(sh["finite"] and so["finite"] and sh["converged"],
          f"{label}: {out}")
    check(not any(sh["twin_calls"].values())
          and not any(so["twin_calls"].values()),
          f"{label}: a twin ran on the card")
    la = sh["launches"]
    n = PD_STEPS + 1
    check(la.get("advect_substage_halo+pd", 0) == 2 * MESH_D * n
          == la.get("advect_substage_halo", 0),
          f"{label}: halo substage launches {la} != 2 D wrap ones a step")
    sweeps = la.get("jacobi_halo_sweep", 0)
    wrapped = la.get("jacobi_halo_sweep+pd", 0)
    check((sweeps > 0) == (pois == "fas")
          and wrapped == (sweeps if kind == "tgv" else 0)
          and la.get("jacobi_halo_sweep+bc", 0) == sweeps,
          f"{label}: halo sweep launches {la}")
    hs = sh["halo_sweeps"]
    check(sweeps == hs["sweeps"] and hs["exchanges"] == 0,
          f"{label}: {sweeps} halo sweep launches for {hs}")
    for k in ("fused_advect_heun", "fused_correction",
              "fused_jacobi_sweeps"):
        check(la.get(k, 0) == 0, f"{label}: a solo kernel launched ({k}: "
              f"{la})")
    check(sh["iters"] == so["iters"], f"{label}: iterations {sh['iters']} "
          f"!= solo {so['iters']}")
    check(out["vel_rel_linf"] <= SHARDED_REL, f"{label}: vel rel "
          f"{out['vel_rel_linf']} > {SHARDED_REL} from the solo step")
    return out


def fleet18(dev, pois: str, state, mesh=None, cap: int = 1 << 22):
    """(c)'s fleet: ``FLEET18``'s catalog case, unplaced or placed on
    ``mesh`` (``member_cells_cap`` 0: spatial), from ``state``."""
    from cup2d_tpu_torch.fleet import FleetSim
    case, size, b = FLEET18
    level = (size // 8).bit_length() - 1
    with latched(pois):
        if mesh is None:
            sim = FleetSim(cases._periodic_cfg(1e-4, "float32", 0.4),
                           level=level, members=b, device=dev,
                           bc=cases.periodic_table())
        else:
            sim = FleetSim(cases._periodic_cfg(1e-4, "float32", 0.4),
                           level=level, members=b, mesh=mesh,
                           member_cells_cap=cap, bc=cases.periodic_table())
    sim.set_state(state)
    sim.step_count = 20
    return sim


def shaped18_start(grid, members: int):
    """The shaped fleet's start on ``grid``'s device: per member m the
    recipe of tests/test_fleet_server.py's ``_shaped_state`` with its disk
    scaled to the box (centre (0.35 + 0.1 m) lx, ly / 2, radius 0.15 ly),
    the Taylor-Green flow at amplitude 0.8**m, the solid translating at
    (0.2, 0.05) and a deformation field 0.02 (sin 2 pi y/ly, cos 2 pi
    x/lx) inside it."""
    from cup2d_tpu_torch.fleet import stack_states
    lx, ly = grid.cfg.extents
    kw = dict(dtype=torch.float64, device=grid.device)
    xs = (torch.arange(grid.nx, **kw) + 0.5) * grid.h
    ys = (torch.arange(grid.ny, **kw) + 0.5) * grid.h
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    base = taylor_green_state(grid)
    out = []
    for m in range(members):
        chi = (((X - (0.35 + 0.1 * m) * lx) ** 2 + (Y - 0.5 * ly) ** 2)
               < (0.15 * ly) ** 2).to(torch.float64)
        us = torch.stack([0.2 * chi, 0.05 * chi])
        udef = 0.02 * torch.stack([chi * torch.sin(2 * np.pi * Y / ly),
                                   chi * torch.cos(2 * np.pi * X / lx)])
        out.append(base._replace(vel=base.vel * (0.8 ** m),
                                 **{k: v.to(grid.dtype) for k, v in
                                    (("chi", chi), ("us", us),
                                     ("udef", udef))}))
    return stack_states(out)


def placed_shaped_fleet(dev, card: str, mesh) -> tuple[dict, dict]:
    """(c)'s shaped fleet: ``SHAPED18`` members at 4096 x 2048, f32,
    unplaced and placed by ``auto`` on ``mesh`` (spatial: a member is
    above the cap), default and fas, a warm-up and ``SHAPED18_STEPS``
    timed production steps each from the same start: every member within
    ``SHARDED_REL`` of the unplaced fleet with equal per-member
    iterations; member-steps/s of both layouts; the launches from 0 per
    run (unplaced: kernels 2 and 5, fas 6; spatial: 3 two a step and
    slab, fas 7, also on the levels gathered onto one slab, and no 6);
    no twin on the card.
    Returns the rows and the spatial runs' launches."""
    from cup2d_tpu_torch.fleet import FleetSim
    ny, b = SHAPED18
    level = (ny // 8).bit_length() - 1
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=1e-3, cfl=0.4, lam=1e6, dtype="float32")
    out, launches, start = {}, {}, None
    n = SHAPED18_STEPS + 1
    for pois in ("", "fas"):
        name = pois or "default"
        rows, states = {}, {}
        for label, m in (("unplaced", None), ("auto", mesh)):
            with latched(pois):
                sim = FleetSim(cfg, level=level, members=b, shaped=True,
                               device=None if m else dev, mesh=m)
            if start is None:
                start = shaped18_start(sim.grid, b)
            sim.set_state(type(start)(*(f.clone() for f in start)))
            sim.step_count = 20
            hk.reset_launches()
            with twin_watch(SPLIT_TWINS) as tw:
                iters = [sim.step_once()["poisson_iters"].tolist()]
                sync(dev)
                t0 = time.perf_counter()
                for _ in range(SHAPED18_STEPS):
                    d = sim.step_once()
                    iters.append(d["poisson_iters"].tolist())
                sync(dev)
            wall = time.perf_counter() - t0
            la = {k: c for k, c in hk.launches.items() if c}
            rows[label] = {"placement": sim.placement,
                           "step_ms": 1e3 * wall / SHAPED18_STEPS,
                           "member_steps_per_s": b * SHAPED18_STEPS / wall,
                           "iters": iters, "finite": bool(d["finite"].all()),
                           "launches": la, "twin_calls": tw.calls}
            check(rows[label]["finite"] and not any(tw.calls.values())
                  and sim.placement == ("single" if m is None
                                        else "spatial"),
                  f"phase 18 shaped fleet {label} {name}: {rows[label]}")
            if m is None:
                check(la.get("fused_advect_heun", 0) == 2 * n
                      and la.get("fused_correction", 0) == n
                      and (la.get("fused_jacobi_sweeps", 0) > 0)
                      == (pois == "fas"),
                      f"phase 18 shaped fleet unplaced {name}: launches {la}")
            else:
                check(la.get("advect_substage_halo", 0) == 2 * MESH_D * n
                      and (la.get("jacobi_halo_sweep", 0) > 0)
                      == (pois == "fas")
                      and "fused_jacobi_sweeps" not in la
                      and "fused_advect_heun" not in la
                      and "fused_correction" not in la,
                      f"phase 18 shaped fleet auto {name}: launches {la}")
                for k, c in la.items():
                    launches[k] = launches.get(k, 0) + c
            states[label] = [whole(f) for f in (sim.state.vel,
                                                sim.state.pres)]
            del sim
        rel = [max(float((a[k] - u[k]).abs().max() / u[k].abs().max())
                   for a, u in zip(states["auto"], states["unplaced"]))
               for k in range(b)]
        rows["auto"]["rel_to_unplaced"] = rel
        check(max(rel) <= SHARDED_REL
              and rows["auto"]["iters"] == rows["unplaced"]["iters"],
              f"phase 18 shaped fleet {name}: rel {rel}, iterations "
              f"{rows['auto']['iters']} vs {rows['unplaced']['iters']}")
        out[name] = rows
        print(f"phase 18 shaped fleet {2 * ny}x{ny} B={b} {name} "
              f"{json.dumps(rows)}; card {card}", flush=True)
        del states
        torch.cuda.empty_cache()
    del start
    torch.cuda.empty_cache()
    return out, launches


def phase_placed_fleets(dev, card: str, fleet16: dict) -> tuple[dict, dict]:
    """Phase 18 (c): ``FLEET18`` (turb2d 1024^2, B = 8) unplaced and on
    MESH_D shards of one card, member placement (2 a shard) and spatial
    (``member_cells_cap=0``), under the default solver and fas: a warm-up
    and ``FLEET18_STEPS`` timed production steps each from the same
    state, every member within ``SHARDED_REL`` of the unplaced fleet with
    equal per-member iterations; member-steps/s beside phase 16's; the
    launches from 0 per run (member: kernels 2 and 5 once a shard, fas 6;
    spatial: the wrap forms of 3 and, fas, 7); no twin on the card. Then
    the ``-case cavity -fleet 4 -mesh 4`` CLI against the unplaced CLI's
    dumps (within ``SHARDED_REL``). Last, the shaped fleet placed by
    ``auto`` (``placed_shaped_fleet``)."""
    case, size, b = FLEET18
    start = cases.make_sim(case, level=(size // 8).bit_length() - 1,
                           members=b, device=dev).state
    mesh = make_mesh(devices=[dev] * MESH_D)
    out, launches, digests = {}, {}, {}
    for pois in ("", "fas"):
        rows, states = {}, {}
        for label, kw in (("unplaced", {}),
                          ("member", {"mesh": mesh}),
                          ("spatial", {"mesh": mesh, "cap": 0})):
            sim = fleet18(dev, pois, start, **kw)
            hk.reset_launches()
            with twin_watch(SPLIT_TWINS) as tw:
                iters = [sim.step_once()["poisson_iters"].tolist()]
                sync(dev)
                t0 = time.perf_counter()
                for _ in range(FLEET18_STEPS):
                    d = sim.step_once()
                    iters.append(d["poisson_iters"].tolist())
                sync(dev)
            wall = time.perf_counter() - t0
            la = {k: n for k, n in hk.launches.items() if n}
            rows[label] = {"placement": sim.placement,
                           "step_ms": 1e3 * wall / FLEET18_STEPS,
                           "member_steps_per_s": b * FLEET18_STEPS / wall,
                           "iters": iters, "finite": bool(d["finite"].all()),
                           "launches": la, "twin_calls": tw.calls}
            check(rows[label]["finite"] and not any(tw.calls.values()),
                  f"phase 18 fleet {label} {pois}: {rows[label]}")
            n = FLEET18_STEPS + 1
            if label == "member":
                check(la.get("fused_advect_heun", 0) == 2 * MESH_D * n
                      and la.get("fused_correction", 0) == MESH_D * n
                      and (la.get("fused_jacobi_sweeps", 0) > 0)
                      == (pois == "fas")
                      and "advect_substage_halo" not in la,
                      f"phase 18 member fleet {pois}: launches {la}")
            if label == "spatial":
                check(la.get("advect_substage_halo+pd", 0) == 2 * MESH_D * n
                      and (la.get("jacobi_halo_sweep+pd", 0) > 0)
                      == (pois == "fas")
                      and "fused_advect_heun" not in la
                      and "fused_correction" not in la,
                      f"phase 18 spatial fleet {pois}: launches {la}")
            if label != "unplaced":
                for k, c in la.items():
                    launches[k] = launches.get(k, 0) + c
            states[label] = [whole(f) for f in (sim.state.vel,
                                                sim.state.pres)]
            if label != "unplaced":
                # phase 19 (d) holds the world fleets to these (kept on
                # the card: 96 MB a run)
                digests[(pois, label)] = (states[label], iters,
                                          rows[label]["step_ms"])
            del sim
        for label in ("member", "spatial"):
            rel = max(float((a - u).abs().max() / u.abs().max())
                      for a, u in zip(states[label], states["unplaced"]))
            rows[label]["rel_to_unplaced"] = rel
            check(rel <= SHARDED_REL
                  and rows[label]["iters"] == rows["unplaced"]["iters"],
                  f"phase 18 {label} fleet {pois or 'default'}: rel {rel}, "
                  f"iterations {rows[label]['iters']} vs "
                  f"{rows['unplaced']['iters']}")
        ref = fleet16.get(f"{case} {size}^2 {pois or 'default'}")
        p16 = None if ref is None else next(
            (p["member_steps_per_s"] for p in ref["points"]
             if p["members"] == b), None)
        out[pois or "default"] = {"runs": rows, "phase16_member_steps_per_s":
                                  p16}
        print(f"phase 18 placed fleets {case} {size}^2 B={b} on {MESH_D} "
              f"shards {pois or 'default'} {json.dumps(out[pois or 'default'])}"
              f"; card {card}", flush=True)
        del states
        torch.cuda.empty_cache()
    del start

    # the CLI: -case cavity -fleet 4 -mesh 4 against the unplaced CLI
    dev_s = (str(dev) if torch.device(dev).type == "cpu" else
             f"cuda:{torch.device(dev).index or torch.cuda.current_device()}")
    argv = CLI18_FLAGS + ["-device", dev_s]
    shutil.rmtree(PHASE18_DIR, ignore_errors=True)
    os.makedirs(PHASE18_DIR)
    runs = {}
    for label, extra in (("unplaced", []), ("mesh", ["-mesh",
                                                      str(MESH_D)])):
        runs[label] = cli_run(argv + extra, os.path.join(PHASE18_DIR, label))
        check(runs[label]["rc"] == 0, f"phase 18 cli {label}: rc "
              f"{runs[label]['rc']}")
    dumps = _dumps_close("cli -case cavity -fleet 4 -mesh 4 vs unplaced",
                         _dump_attrs(os.path.join(PHASE18_DIR, "mesh")),
                         _dump_attrs(os.path.join(PHASE18_DIR, "unplaced")),
                         SHARDED_REL, "phase 18")
    out["cli"] = {"dumps": dumps, "seconds": {k: r["seconds"]
                                              for k, r in runs.items()}}
    print(f"phase 18 cli {json.dumps(out['cli'])}", flush=True)
    shutil.rmtree(PHASE18_DIR)
    t0 = time.perf_counter()
    out["shaped"], sl = placed_shaped_fleet(dev, card, mesh)
    print(f"phase 18 shaped fleet seconds {time.perf_counter() - t0}",
          flush=True)
    for k, c in sl.items():
        launches[k] = launches.get(k, 0) + c
    out["digests"] = digests
    return out, launches


def phase_periodic_mesh(dev, res, card: str, fleet16: dict
                        ) -> tuple[dict, dict]:
    """Phase 18: (a) the y-wrap halo forms against their twins and the
    solo wrap forms, (b) the split periodic step against solo, (c) placed
    fleets against the unplaced fleet and the placed CLI. Returns the
    runs and the launches of every kernel over (b)'s split runs and (c)'s
    placed fleet runs."""
    t = [time.perf_counter()]
    phase_split_periodic_kernels(dev, res)
    t.append(time.perf_counter())
    runs = {"split": [run_split_periodic(dev, "tgv", p) for p in ("", "fas")]
            + [run_split_periodic(dev, "channel", "fas")]}
    t.append(time.perf_counter())
    launches = {}
    for r in runs["split"]:
        for k, n in r["sharded"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    runs["fleets"], fl = phase_placed_fleets(dev, card, fleet16)
    for k, n in fl.items():
        launches[k] = launches.get(k, 0) + n
    t.append(time.perf_counter())
    print(f"phase 18 seconds: (a) {t[1] - t[0]} (b) {t[2] - t[1]} (c) "
          f"{t[3] - t[2]}; card {card}", flush=True)
    return runs, launches


# ---------------------------------------------------------------------------
# phase 19: multi-process runs on torch.distributed, through a one-rank
# NCCL world on the card
# ---------------------------------------------------------------------------

PHASE19_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase19")
DIST_STEPS = 2            # (a): production steps after the startup step
DIST_FOREST_STEPS = 3     # (b): production steps after the adapt
DIST_KEYS = ("advect_substage_halo", "jacobi_halo_sweep", "fused_lab_rhs",
             "fused_block_jacobi_update", "fused_block_jacobi_update+pinv",
             "group_sum")
# (d): the kernels of the world fleets (member: 2, 5, fas 6; spatial: the
# wrap forms of 3 and, fas, 7), counted over (d) alone
DIST_FLEET_KEYS = ("fused_advect_heun", "fused_correction",
                   "fused_jacobi_sweeps", "advect_substage_halo",
                   "jacobi_halo_sweep")
# the split uniform step's twins and the forest's, each once
DIST_TWINS = tuple(dict.fromkeys(SPLIT_TWINS + FOREST_TWINS))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_tgv(dev, pois: str, mesh, size: int = 8192) -> tuple:
    """(a) on ``mesh``: ``tgv_periodic`` at size^2 on 4 slabs of the card,
    its exact startup step and ``DIST_STEPS`` timed production steps.
    Returns the sim and its row (the whole vel and pres on the card)."""
    sim = periodic_grid("tgv", dev, pois, mesh, size)
    sim.set_state(periodic_start(sim.grid, "tgv"))
    sim.step_count = 9
    iters = [sim.step_once()["poisson_iters"]]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        d = sim.step_once()
        iters.append(d["poisson_iters"])
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / DIST_STEPS
    check(bool(d["finite"]), f"phase 19 tgv {pois or 'default'}: nonfinite")
    return sim, {"iters": iters, "ms_per_step": ms,
                 "vel": gather_x(sim.state.vel),
                 "pres": gather_x(sim.state.pres)}


def dist_forest(dev, forest_start: tuple, pois: str, mesh) -> tuple:
    """(b) on ``mesh``: phase 5's forest as a 4-shard ``ShardedAMRSim``,
    one adapt and ``DIST_FOREST_STEPS`` production steps (the first
    untimed). Returns the sim and its row."""
    cfg, snap = forest_start
    with latched(pois or "structured"):
        sim = ShardedAMRSim(cfg, mesh, shapes=[])
    forest_from_numpy(sim, *snap)
    sim.step_count = 10
    sim.adapt()
    iters = [sim.step_once()["poisson_iters"]]
    sync(dev)
    tsh.reset_comm_stats()
    t0 = time.perf_counter()
    for _ in range(DIST_FOREST_STEPS - 1):
        d = sim.step_once()
        iters.append(d["poisson_iters"])
    sync(dev)
    n = DIST_FOREST_STEPS - 1
    comm = {k: v / n for k, v in tsh.comm_stats.items()}
    check(bool(d["finite"]), f"phase 19 forest {pois or 'default'}: "
          "nonfinite")
    return sim, {"iters": iters, "blocks": len(sim.forest.blocks),
                  "keys": set(sim.forest.blocks),
                  "ms_per_step": 1e3 * (time.perf_counter() - t0) / n,
                  "comm_per_step": comm, "state": _gathered(sim)}


def _same(a: dict, b: dict, keys) -> bool:
    return all(torch.equal(a[k], b[k]) for k in keys)


def _checkpoint_bytes(d: str) -> dict:
    """Every array's bytes, meta.json and shapes.pkl of a checkpoint (the
    zip members' timestamps aside)."""
    out = {}
    with np.load(os.path.join(d, "fields.npz")) as z:
        for k in z.files:
            out[k] = z[k].tobytes()
    for n in ("meta.json", "shapes.pkl"):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


def dist_checkpoint(sim, solo_sim, before: dict) -> dict:
    """(c): the world sim's collective save beside the single-controller
    sim's, then a restore into the world sim (its fields zeroed first)
    against the state it saved."""
    from cup2d_tpu_torch.io import load_checkpoint, save_checkpoint
    t0 = time.perf_counter()
    wd, sd = (os.path.join(PHASE19_DIR, n) for n in ("world", "solo"))
    save_checkpoint(wd, sim)
    save_checkpoint(sd, solo_sim)
    wb, sb = _checkpoint_bytes(wd), _checkpoint_bytes(sd)
    sim._set_ordered(**{k: v * 0.0 for k, v in
                        sim._ordered_state().items()})
    load_checkpoint(wd, sim)
    after = _gathered(sim)
    # the real blocks (a restore pads with zeros, a solve leaves its own
    # values in the pad rows)
    n = sim._n_real
    row = {"bytes_equal": wb == sb,
           "restore_bit_for_bit": all(torch.equal(after[k][:n],
                                                  before[k][:n])
                                      for k in before),
           "bytes": sum(len(v) for v in wb.values()),
           "seconds": time.perf_counter() - t0}
    print(f"phase 19 (c) {json.dumps(row)}", flush=True)
    check(row["bytes_equal"] and row["restore_bit_for_bit"],
          "phase 19 (c): the collective checkpoint differs")
    return row


def dist_fleets(dev, wmesh, digests: dict, card: str) -> tuple:
    """(d): phase 18 (c)'s ``turb2d`` fleet on the world mesh, member and
    spatial, default and fas, the same warm-up and ``FLEET18_STEPS``
    steps from the same start: the final state bit for bit and the
    per-member iterations equal phase 18 (c)'s single-controller runs
    (``digests``: their final vel and pres, kept on the card, their
    iterations and ms a step). Returns (rows, launches from 0 over these
    runs)."""
    case, size, b = FLEET18
    start = cases.make_sim(case, level=(size // 8).bit_length() - 1,
                           members=b, device=dev).state
    rows, launches = {}, {k: 0 for k in DIST_FLEET_KEYS}
    for pois in ("", "fas"):
        for label, cap in (("member", 1 << 22), ("spatial", 0)):
            sim = fleet18(dev, pois, start, mesh=wmesh, cap=cap)
            check(sim.placement == label and sim.mesh.distributed,
                  f"phase 19 (d) {label}: placement {sim.placement}")
            hk.reset_launches()
            tsh.reset_comm_stats()
            iters = [sim.step_once()["poisson_iters"].tolist()]
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(FLEET18_STEPS):
                d = sim.step_once()
                iters.append(d["poisson_iters"].tolist())
            sync(dev)
            wall = time.perf_counter() - t0
            for k in DIST_FLEET_KEYS:
                launches[k] += hk.launches[k]
            n = FLEET18_STEPS + 1
            comm = {k: tsh.comm_stats[k] / n for k in (
                "allgathers", "allgather_bytes")}
            ref_state, ref_iters, ref_ms = digests.pop((pois, label))
            same = all(torch.equal(whole(a), b) for a, b in zip(
                (sim.state.vel, sim.state.pres), ref_state))
            del ref_state
            name = f"{label} {pois or 'default'}"
            rows[name] = {
                "bit_for_bit": same, "iters": iters,
                "iters_equal": iters == ref_iters,
                "step_ms": 1e3 * wall / FLEET18_STEPS,
                "single_controller_step_ms": ref_ms,
                "member_steps_per_s": b * FLEET18_STEPS / wall,
                "finite": bool(d["finite"].all()),
                "allgathers_per_step": comm["allgathers"],
                "allgather_kb_per_step": comm["allgather_bytes"] / 1e3}
            print(f"phase 19 (d) world fleet {case} {size}^2 B={b} {name} "
                  f"{json.dumps(rows[name])}; card {card}", flush=True)
            check(rows[name]["bit_for_bit"] and rows[name]["iters_equal"]
                  and rows[name]["finite"],
                  f"phase 19 (d) {name}: the world fleet differs from the "
                  "single-controller placed fleet")
            del sim
    del start
    torch.cuda.empty_cache()
    return rows, launches


def phase_dist(dev, forest_start: tuple, card: str, size: int = 8192,
               fleet_digests: dict | None = None) -> tuple[dict, dict]:
    """Phase 19: the multi-process code paths through a one-rank NCCL
    world in this process (``parallel.launch.init_distributed``; NCCL
    takes no two ranks on one card), whose 4-shard world mesh sends every
    reduction and gather through NCCL collectives. (a) ``tgv_periodic`` at
    8192^2 on 4 slabs, default and fas: the startup step and
    ``DIST_STEPS`` production steps bit for bit the same run on a
    single-controller mesh (phase 18 (b)'s run); (b) phase 5's forest
    after its warm-up step (``forest_start``: phase 15's start) on 4
    shards, an adapt and ``DIST_FOREST_STEPS`` production steps under each
    solver bit for bit the single-controller run (phase 17's), with the
    bytes it all-gathers a step by kind (the reductions' group partials
    only, no preconditioner operand; the transfers whole); (c) a collective
    ``save_checkpoint`` / ``load_checkpoint`` round trip of (b)'s fas run
    whose arrays, meta and shapes bytes equal the no-world save; (d)
    ``dist_fleets`` against phase 18 (c)'s digests (``fleet_digests``).
    Launches of kernels 3, 4, 7, 8 and ``group_sum.cu`` from 0 over
    (a)-(c) alone, and of 2, 3, 5, 6 and 7 over (d) alone (returned under
    their names; 3 and 7 sum both); no twin on the card's operands. The
    group is torn down before the smoke goes on."""
    from cup2d_tpu_torch.parallel.launch import (init_distributed,
                                                 shutdown_distributed,
                                                 world_mesh)
    shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    os.makedirs(PHASE19_DIR)
    t0 = time.perf_counter()
    check(init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                           expected_processes=1, device=dev,
                           timeout=120.0) == 0, "phase 19: rank")
    try:
        check(torch.distributed.get_backend() == "nccl",
              "phase 19: the world's backend is not NCCL")
        wmesh = world_mesh(MESH_D, dev)
        smesh = make_mesh(devices=[dev] * MESH_D)
        check(wmesh.distributed and not smesh.distributed,
              "phase 19: mesh kinds")
        out, launches = {"uniform": {}, "forest": {}}, {k: 0 for k in
                                                        DIST_KEYS}
        t_up = time.perf_counter() - t0
        with twin_watch(DIST_TWINS) as tw:
            t1 = time.perf_counter()
            for pois in ("", "fas"):
                name = pois or "default"
                solo_sim, solo = dist_tgv(dev, pois, smesh, size)
                hk.reset_launches()
                tsh.reset_comm_stats()
                sim, row = dist_tgv(dev, pois, wmesh, size)
                for k in DIST_KEYS:
                    launches[k] += hk.launches[k]
                gathers = tsh.comm_stats["allgathers"]
                same = _same(row, solo, ("vel", "pres"))
                out["uniform"][name] = {
                    "iters": row["iters"], "solo_iters": solo["iters"],
                    "bit_for_bit": same, "ms_per_step": row["ms_per_step"],
                    "solo_ms_per_step": solo["ms_per_step"],
                    "allgathers": gathers}
                print(f"phase 19 (a) tgv {size}^2 {name} "
                      f"{json.dumps(out['uniform'][name])}; card {card}",
                      flush=True)
                check(same and row["iters"] == solo["iters"],
                      f"phase 19 (a) {name}: the world run differs from "
                      "the single-controller run")
                check(gathers > 0, f"phase 19 (a) {name}: no collective")
                del row, solo, sim, solo_sim
                torch.cuda.empty_cache()
            t3 = time.perf_counter()
            for pois in ("", "fas"):
                name = pois or "default"
                solo_sim, solo = dist_forest(dev, forest_start, pois, smesh)
                hk.reset_launches()
                sim, row = dist_forest(dev, forest_start, pois, wmesh)
                for k in DIST_KEYS:
                    launches[k] += hk.launches[k]
                same = (row["keys"] == solo["keys"]
                        and _same(row["state"], solo["state"],
                                  row["state"].keys()))
                by_kind = tsh.comm_by_kind(row["comm_per_step"])
                out["forest"][name] = {
                    "blocks": row["blocks"], "iters": row["iters"],
                    "solo_iters": solo["iters"], "bit_for_bit": same,
                    "ms_per_step": row["ms_per_step"],
                    "solo_ms_per_step": solo["ms_per_step"],
                    "comm_per_step": {k: row["comm_per_step"][k] for k in (
                        "allgathers", "allgather_bytes", "p2p_messages",
                        "p2p_bytes")},
                    "allgathered_mb_per_step_by_kind": {
                        k: [c, b / 1e6] for k, (c, b) in by_kind.items()}}
                print(f"phase 19 (b) forest {name} "
                      f"{json.dumps(out['forest'][name])}; card {card}",
                      flush=True)
                check(same and row["iters"] == solo["iters"],
                      f"phase 19 (b) {name}: the world run differs from "
                      "the single-controller run")
                red_n, red_b = by_kind["reductions"]
                check(by_kind["preconditioner"] == (0, 0) and red_n > 0
                      and red_b <= red_n * sim._npad_hwm // 16 * 8,
                      f"phase 19 (b) {name}: a whole operand all-gathered "
                      f"{by_kind}")
                if pois == "fas":
                    out["checkpoint"] = dist_checkpoint(sim, solo_sim,
                                                        row["state"])
                del row, solo, sim, solo_sim
            t4 = time.perf_counter()
            fleet_launches = None
            if fleet_digests is not None:
                out["fleets"], fleet_launches = dist_fleets(
                    dev, wmesh, fleet_digests, card)
            t5 = time.perf_counter()
        check(not any(tw.calls.values()),
              f"phase 19: twins called on the card's operands {tw.calls}")
    finally:
        shutdown_distributed()
        shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    check(not torch.distributed.is_initialized(), "phase 19: the world "
          "outlived the phase")
    for k in DIST_KEYS:
        check(launches[k] > 0, f"{k}: launched no time on the world runs")
    if fleet_launches is not None:
        for k, n in fleet_launches.items():
            check(n > 0, f"{k}: launched no time on the world fleets")
            launches[k] = launches.get(k, 0) + n
        out["fleet_launches"] = fleet_launches
    out["seconds"] = {"bring_up": t_up, "uniform": t3 - t1,
                      "forest": t4 - t3, "fleets": t5 - t4}
    print(f"phase 19 seconds {json.dumps(out['seconds'])}; launches "
          f"{json.dumps(launches)}; card {card}", flush=True)
    return out, launches


# ---------------------------------------------------------------------------
# phase 20: elastic recovery (resilience.TopologyGuard, StepGuard.
# elastic_recover, the mirror tier)
# ---------------------------------------------------------------------------

PHASE20_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase20")
# from step 10 (production solves): the checkpoint of the start (the
# benchmark state, the same for both solvers, so written once), the loss
# at the next boundary (the step in flight on the lost topology is
# dropped, so the ring's anchor, the guard's seed, and the checkpoint hold
# the same step), 2 steps on the survivors
ELASTIC_START = ELASTIC_CK = 10
ELASTIC_END = 12
ELASTIC_SPEC = f"host_exit@{ELASTIC_CK + 1}"
ELASTIC_ONOFF_STEPS = 6    # (d): steps with the mirror off, then on
# the kernels a resumed run launches: the split uniform step's (7 under
# fas only) and the split forest's under the default solver
ELASTIC_UNIFORM_KEYS = ("advect_substage_halo", "jacobi_halo_sweep")
ELASTIC_FOREST_KEYS = ("fused_lab_rhs", "fused_block_jacobi_update+pinv",
                       "group_sum")


def elastic_events(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def elastic_drill(dev, sim, spec: str, ck: str, save, mirror: bool,
                  label: str) -> dict:
    """Drive ``sim`` (split over ``MESH_D`` shards of the card, grouped
    into 2 simulated hosts) under a ``StepGuard`` from ``ELASTIC_START``
    to ``ELASTIC_END``: the checkpoint ``ck`` at ``ELASTIC_CK`` (written
    by ``save(ck)`` where given), the faults ``spec`` at the boundaries,
    the loss recovered in place. Returns the rung, the events, the re-mesh
    ms, the launches made after the re-mesh and the final whole state."""
    from cup2d_tpu_torch.faults import FaultPlan
    from cup2d_tpu_torch.resilience import (EventLog, PreemptionGuard,
                                            StepGuard, TopologyGuard)
    log_path = os.path.join(PHASE20_DIR, f"{label}.events.jsonl")
    log = EventLog(log_path)
    plan = FaultPlan(spec)
    topo = TopologyGuard(sim.mesh, sim_hosts=2, miss_k=1, faults=plan,
                         event_log=log)
    guard = StepGuard(sim, ckpt_dir=ck, event_log=log, faults=plan,
                      snap_every=1, mirror_hosts=2 if mirror else None)
    stop = PreemptionGuard()
    saved, before, remesh_s = False, None, None
    mirror_bytes = 0
    while sim.step_count < ELASTIC_END:
        if not saved and sim.step_count == ELASTIC_CK:
            guard.drain()
            if save is not None:
                save(ck)
            saved = True
        beat = topo.step_boundary(stop, sim.step_count)
        check(not beat.hung and not beat.self_lost,
              f"phase 20 {label}: beat {beat}")
        if beat.lost:
            # the anchor's and the step in flight's mirrors
            mirror_bytes = guard.mirror_nbytes()
            sync(dev)
            t0 = time.perf_counter()
            guard.elastic_recover(topo)
            sync(dev)
            remesh_s = time.perf_counter() - t0
            before = dict(hk.launches)
            continue
        guard.step()
    guard.drain()
    sync(dev)
    log.close()
    check(before is not None, f"phase 20 {label}: no loss was declared")
    ev = elastic_events(log_path)
    remesh = [e for e in ev if e["event"] == "remesh"]
    return {"source": guard.restore_source,
            "remesh_ms": guard.remesh_ms_total, "remesh_s": remesh_s,
            "mirror_rejects": sum(e["event"] == "mirror_reject" for e in ev),
            "remesh_event": {k: remesh[0][k] for k in
                             ("source", "step", "devices", "epoch")}
            if len(remesh) == 1 else remesh,
            "mirror_bytes": mirror_bytes,
            "mirror_latched_off": guard.mirror_hosts is None,
            "shards_after": sim.mesh.size,
            "launches_after_remesh": {k: hk.launches[k] - before[k]
                                      for k in hk.launches
                                      if hk.launches[k] > before[k]},
            "state": _elastic_state(sim), "time": sim.time,
            "step": sim.step_count}


def _elastic_state(sim) -> dict:
    if hasattr(sim, "forest"):
        st = _gathered(sim)
        return {k: v[:sim._n_real] for k, v in st.items()} | {
            "__keys": torch.as_tensor(
                np.asarray(sorted(sim.forest.blocks), np.int64))}
    return {k: gather_x(v) for k, v in sim.state._asdict().items()}


def elastic_restart(sim, ck: str) -> dict:
    """The fresh run on 2 shards from the checkpoint: ``sim`` built there,
    the checkpoint loaded and stepped under a guard to ``ELASTIC_END``."""
    from cup2d_tpu_torch.io import load_checkpoint
    from cup2d_tpu_torch.resilience import StepGuard
    load_checkpoint(ck, sim)
    check(sim.step_count == ELASTIC_CK, "phase 20: checkpoint step")
    g = StepGuard(sim, snap_every=1)
    while sim.step_count < ELASTIC_END:
        g.step()
    g.drain()
    return {"state": _elastic_state(sim), "time": sim.time}


def elastic_same(label: str, row: dict, ref: dict) -> bool:
    same = (row["time"] == ref["time"]
            and row["state"].keys() == ref["state"].keys()
            and all(torch.equal(row["state"][k], ref["state"][k])
                    for k in ref["state"]))
    row["bit_for_bit"] = same
    check(same, f"phase 20 {label}: the resumed run differs from the "
          "restart from the checkpoint on 2 shards")
    return same


def elastic_start(sim, mesh) -> None:
    """Put a split uniform sim back at the drills' start: on ``mesh`` (a
    re-mesh from the survivors' 2 shards), the benchmark state at step
    ``ELASTIC_START``, no cached dt."""
    if sim.mesh is not mesh:
        sim.remesh(mesh)
    sim.set_state(bench_start(sim.grid))
    sim.step_count, sim.time, sim._next_dt = ELASTIC_START, 0.0, None


def elastic_onoff(dev, sim, mesh) -> dict:
    """(d): ``ELASTIC_ONOFF_STEPS`` guarded steps of the split default
    run with the mirror off, then on, from the same state on one sim: the
    states bit-equal and the device reads equal; the mirror's bytes, its
    capture's host ms a step and the step ms each way."""
    from cup2d_tpu_torch.profiling import HostCounters
    from cup2d_tpu_torch.resilience import StepGuard
    out, states = {}, {}
    for on in (False, True):
        elastic_start(sim, mesh)
        guard = StepGuard(sim, snap_every=1, mirror_hosts=2 if on else None)
        counters = HostCounters().install()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(ELASTIC_ONOFF_STEPS):
            guard.step()
        guard.drain()
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0) / ELASTIC_ONOFF_STEPS
        counters.uninstall()
        name = "on" if on else "off"
        out[name] = {"ms_per_step": ms,
                     "device_gets": counters.snapshot()["device_gets"],
                     "mirror_bytes": guard.mirror_nbytes(),
                     "capture_host_ms_per_step":
                         guard.mirror_ms_total / ELASTIC_ONOFF_STEPS}
        states[name] = _elastic_state(sim)
        del guard
    out["bit_equal"] = all(torch.equal(states["on"][k], states["off"][k])
                           for k in states["off"])
    check(out["bit_equal"] and out["on"]["device_gets"]
          == out["off"]["device_gets"] and out["on"]["mirror_bytes"] > 0
          and out["off"]["mirror_bytes"] == 0,
          f"phase 20 (d): mirror on against off {out}")
    return out


def phase_elastic(dev, forest_warm: tuple, card: str, size: int = 8192
                  ) -> tuple[dict, dict]:
    """Phase 20: elastic recovery on the card, 4 shards of one card in 2
    simulated hosts (``TopologyGuard(sim_hosts=2)``, ``miss_k`` 1), each
    drill bit for bit a fresh 2-shard run restarted from the step-10
    checkpoint: (a) the uniform 8192^2 run (phase 7's) under both solvers
    loses host 1 (``host_exit``) and resumes from the ring; (b) with the
    mirror on and ``shard_loss``, from the mirror; (c) with the mirror
    corrupted first, one ``mirror_reject`` and the disk rung; (d) mirror on
    against off; (e) phase 5's forest after its warm-up, from the ring
    (the mirror latches off for it). One split sim a solver serves every
    uniform drill, put back on 4 shards between them (``remesh``), and one
    2-shard sim a solver the restart. Launches of kernels 3, 7, 4, 8 and
    ``group_sum.cu`` after each re-mesh; the counts over the phase."""
    from cup2d_tpu_torch.io import save_checkpoint
    shutil.rmtree(PHASE20_DIR, ignore_errors=True)
    os.makedirs(PHASE20_DIR)
    cfg, level = bench_cfg(size, size)
    mesh4 = make_mesh(devices=[dev] * MESH_D)
    out = {"uniform": {}}
    secs = {"build": 0.0, "save": 0.0, "restart": 0.0}
    launches_after = {}
    t0 = time.perf_counter()

    def build(pois, shards, make=None):
        tb = time.perf_counter()
        mesh = mesh4 if shards == MESH_D else make_mesh(devices=[dev] * 2)
        with latched(pois):
            sim = (make(mesh) if make is not None else
                   ShardedUniformSim(cfg, mesh, level=level))
        secs["build"] += time.perf_counter() - tb
        return sim

    def note(label, row):
        for k, n in row.pop("launches_after_remesh").items():
            launches_after[k] = launches_after.get(k, 0) + n
        row.pop("state")
        print(f"phase 20 {label} {json.dumps(row)}; card {card}",
              flush=True)

    def saved(ck):
        # the checkpoint is written inside the drill: time it here
        tb = time.perf_counter()
        save_checkpoint(ck, sim)
        secs["save"] += time.perf_counter() - tb

    def restart(ref_sim, ck):
        tb = time.perf_counter()
        r = elastic_restart(ref_sim, ck)
        secs["restart"] += time.perf_counter() - tb
        return r

    with twin_watch(DIST_TWINS) as tw:
        for pois in ("", "fas"):
            name = pois or "default"
            # the default drill writes the start's checkpoint; the fas
            # drills start from the same state and step
            ck = os.path.join(PHASE20_DIR, "ck_uniform")
            sim = build(pois, MESH_D)
            elastic_start(sim, mesh4)
            row = elastic_drill(dev, sim, ELASTIC_SPEC, ck,
                                None if pois else saved, False,
                                f"a_{name}")
            ref = restart(build(pois, 2), ck)
            elastic_same(f"(a) {name}", row, ref)
            check(row["source"] == "ring" and row["shards_after"] == 2,
                  f"phase 20 (a) {name}: rung {row['source']}")
            rows = {"a": row}
            if not pois:
                elastic_start(sim, mesh4)
                row = elastic_drill(
                    dev, sim, f"{ELASTIC_SPEC},shard_loss@{ELASTIC_CK + 1}",
                    ck, None, True, "b")
                elastic_same("(b)", row, ref)
                check(row["source"] == "mirror" and row["mirror_rejects"]
                      == 0 and row["mirror_bytes"] > 0,
                      f"phase 20 (b): rung {row['source']}")
                rows["b"] = row
                elastic_start(sim, mesh4)
                row = elastic_drill(
                    dev, sim, f"mirror_corrupt@{ELASTIC_CK},{ELASTIC_SPEC},"
                    f"shard_loss@{ELASTIC_CK + 1}", ck, None, True, "c")
                elastic_same("(c)", row, ref)
                check(row["source"] == "disk"
                      and row["mirror_rejects"] == 1,
                      f"phase 20 (c): rung {row['source']}, "
                      f"{row['mirror_rejects']} rejects")
                rows["c"] = row
                t1 = time.perf_counter()
                out["onoff"] = elastic_onoff(dev, sim, mesh4)
                t_onoff = time.perf_counter() - t1
                print(f"phase 20 (d) mirror on/off "
                      f"{json.dumps(out['onoff'])}; card {card}", flush=True)
            for k, r in rows.items():
                note(f"({k}) uniform {size}^2 {name}", r)
            out["uniform"][name] = rows
            del ref, rows, row, sim
            torch.cuda.empty_cache()
        t2 = time.perf_counter()
        fcfg, fsnap = forest_warm

        def forest(shards):
            fsim = build("structured", shards,
                         lambda mesh: ShardedAMRSim(fcfg, mesh, shapes=[]))
            forest_from_numpy(fsim, *fsnap)
            fsim.step_count = ELASTIC_START
            return fsim

        sim = forest(MESH_D)
        ck = os.path.join(PHASE20_DIR, "ck_forest")
        row = elastic_drill(dev, sim, ELASTIC_SPEC, ck, saved, True, "e")
        del sim
        ref = restart(forest(2), ck)
        elastic_same("(e) forest", row, ref)
        check(row["source"] == "ring" and row["mirror_latched_off"],
              f"phase 20 (e): rung {row['source']}")
        note("(e) forest default", row)
        out["forest"] = row
        del ref
        t3 = time.perf_counter()
    check(not any(tw.calls.values()),
          f"phase 20: twins called on the card's operands {tw.calls}")
    shutil.rmtree(PHASE20_DIR, ignore_errors=True)
    for k in ELASTIC_UNIFORM_KEYS + ELASTIC_FOREST_KEYS:
        check(launches_after.get(k, 0) > 0, f"{k}: launched no time after "
              "a re-mesh")
    out["launches_after_remesh"] = launches_after
    out["seconds"] = {"uniform": t2 - t0 - t_onoff, "onoff": t_onoff,
                      "forest": t3 - t2, **{f"of which {k}": v
                                            for k, v in secs.items()}}
    print(f"phase 20 seconds {json.dumps(out['seconds'])}; launches after "
          f"the re-meshes {json.dumps(launches_after)}; card {card}",
          flush=True)
    return out, dict(hk.launches)


def phase_lint(card: str) -> dict:
    """The port's lint over its own package, in process and as the CLI's
    ``--json`` subprocess: both must be clean, the subprocess rc 0, and
    both must scan every ``.py`` of the package."""
    from cup2d_tpu_torch.analysis import lint_package
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    report = lint_package()
    secs_in = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cup2d_tpu_torch.analysis", "--json"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": root})
    secs_cli = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    cli = json.loads(lines[-1]) if lines else {}
    n_py = sum(fn.endswith(".py") for d, _, fns in os.walk(
        os.path.join(root, "cup2d_tpu_torch")) if "__pycache__" not in d
        for fn in fns)
    out = {"files": report.files_scanned, "py_files": n_py,
           "findings": len(report.findings),
           "suppressed": dict(report.suppressed),
           "cli_rc": proc.returncode, "cli_files": cli.get("files_scanned"),
           "cli_findings": len(cli.get("findings", [])) if cli else None,
           "seconds": {"in_process": secs_in, "cli": secs_cli}}
    print(f"phase 21 lint {json.dumps(out)}; card {card}", flush=True)
    for f in report.findings:
        print(f"phase 21 finding {f}", flush=True)
    check(report.clean, f"lint: {len(report.findings)} findings in process")
    check(proc.returncode == 0 and cli.get("clean") is True,
          f"lint CLI: rc {proc.returncode}: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    check(report.files_scanned == cli.get("files_scanned") == n_py,
          f"lint scanned {report.files_scanned} / {cli.get('files_scanned')}"
          f" files of {n_py}")
    return out


# ---------------------------------------------------------------------------
# Phase 22: f64 state on the card
# ---------------------------------------------------------------------------

PHASE22_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase22")
F64_REL = 1e-12        # an f64 form against its twin, relative to max |ref|
F64_TRAJ_REL = 1e-10   # the card's f64 run against the port's CPU f64 run
F64_KEYS = ("fused_advect_heun+f64", "fused_correction+f64",
            "fused_jacobi_sweeps+f64", "fused_lab_rhs+f64",
            "fused_block_jacobi_update+f64")
# the twins an f64 step on the card must not call on f64 operands; the
# sweep chain's twin is watched under fas only: the default solver's
# preconditioner cycle runs it as plain code by design (the JAX package's
# XLA cycle, which the f32 step runs on bf16 legs)
F64_TWINS = ("advect_substage_plain", "fused_correction_plain",
             "fused_lab_rhs_plain", "block_jacobi_plain",
             "block_precond_plain", "block_precond_form_plain",
             "group_sum_plain", "advect_substage_halo_plain",
             "jacobi_halo_sweep_plain", "tridiag_scan_plain")
F64_UNIFORM_STEPS = 3
F64_FLAGSHIP_STEPS = 5
F64_FOREST_STEPS = 2
F64_CLI_STEPS = 2


def cfg64(cfg) -> SimConfig:
    """``cfg`` with f64 state."""
    return dataclasses.replace(cfg, dtype="float64")


def f64_close(label: str, got, ref, bar: float = F64_REL) -> float:
    """Hold an f64 output to its twin's, relative to max |ref|; returns the
    largest absolute difference."""
    check(got.dtype == torch.float64, f"{label}: {got.dtype} out")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"phase 22 {label}: max_abs_err {err} (rel {rel})", flush=True)
    check(rel <= bar, f"{label}: rel {rel} > {bar}")
    return err


def phase_f64_kernels(dev, res) -> None:
    """Phase 22 (a): each f64 form against its twin on the card at the f32
    phases' shapes (8192^2 for 2, 5 and 6, in every form; [16384, 2, 14,
    14] and [16384, 8, 8] for 4 and 8), <= 1e-12 relative; card ms, the
    bound at 8 bytes a value (and the FP64 operations for 2 and 4), the
    twin's ms and, for kernel 8, the f64 library call's."""
    gen = torch.Generator(device=dev).manual_seed(22)

    def rn(*s):
        return torch.randn(*s, generator=gen, device=dev,
                           dtype=torch.float64)

    def note(key, err, **kw):
        r = res.setdefault(key, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        r.update(kw)

    n8 = 8192
    cells = n8 * n8
    # K2: the benchmark's 8192^2 velocity widened to f64, dt = h/2
    g32 = bench_grid(n8, n8, dev)
    h = g32.h
    v = bench_start(g32).vel[None].double()
    dt = torch.tensor([0.5 * h], dtype=torch.float64, device=dev)
    ih2 = 1.0 / (h * h)
    for name, table in (("free-slip", None), ("cavity", BC_TABLES["cavity"]),
                        ("doubly periodic", cases.periodic_table())):
        got = hk.fused_advect_heun(v, h, 4e-5, dt, bc=table)
        ref = hk.fused_advect_heun_plain(v, h, 4e-5, dt, bc=table)
        err = f64_close(f"fused_advect_heun f64 {name} [1,2,8192,8192]",
                        got, ref)
        del got, ref
        ms = cuda_ms(lambda: hk.fused_advect_heun(v, h, 4e-5, dt, bc=table),
                     5)
        if table is not None:
            print(f"phase 22 fused_advect_heun f64 {name}: kernel_ms {ms}",
                  flush=True)
            note("fused_advect_heun+f64", err)
            continue
        pms = cuda_ms(lambda: hk.fused_advect_heun_plain(v, h, 4e-5, dt),
                      1)
        facs = hk._substage_facs(dt, h, 4e-5, (1,), 1, torch.float64, dev)
        v1 = hk.advect_substage(v, None, facs, 0.5, ih2)
        b = bound(80.0 * cells, substage_ops(v) + substage_ops(v1),
                  PEAK_F64)
        del v1
        print(f"phase 22 fused_advect_heun f64 [1,2,8192,8192] both "
              f"substages: kernel_ms {ms} twin_ms {pms} bound_ms {b[0]} "
              f"({b[1]}, FP64)", flush=True)
        note("fused_advect_heun+f64", err, ms=ms, plain_ms=pms,
             bound_ms=b[0], bound_by=b[1], library_ms=None)
    del v
    torch.cuda.empty_cache()
    # K5: unit-scale operands, pfac = -dt h / 2 at dt = h/2
    x, p, vel = rn(1, n8, n8), rn(1, n8, n8), rn(1, 2, n8, n8)
    scal = torch.stack([x.mean(), p.mean(), torch.tensor(
        -0.25 * h * h, dtype=torch.float64, device=dev)]).reshape(1, 3)
    for name, signs in (("Neumann", None), ("signed", EDGE_SIGNS),
                        ("wrap", (0.0, 0.0, 0.0, 0.0))):
        periodic = (signs is not None and signs[0] == 0.0,) * 2
        got = hk.fused_correction(x, p, vel, scal, ih2, signs)
        ref = hk.fused_correction_plain(x, p, vel, scal, ih2, signs,
                                        periodic)
        err = max(f64_close(f"fused_correction f64 {name} {k} "
                            "[1,8192,8192]", a, c)
                  for k, a, c in zip(("pres", "vel"), got, ref))
        del got, ref
        ms = cuda_ms(lambda: hk.fused_correction(x, p, vel, scal, ih2,
                                                 signs), 10)
        if signs is not None:
            print(f"phase 22 fused_correction f64 {name}: kernel_ms {ms}",
                  flush=True)
            note("fused_correction+f64", err)
            continue
        pms = cuda_ms(lambda: hk.fused_correction_plain(
            x, p, vel, scal, ih2), 3)
        b = bound(56.0 * cells, OPS_CORRECTION_CELL * cells, PEAK_F64)
        print(f"phase 22 fused_correction f64 [1,8192,8192]: kernel_ms {ms}"
              f" twin_ms {pms} bound_ms {b[0]} ({b[1]})", flush=True)
        note("fused_correction+f64", err, ms=ms, plain_ms=pms,
             bound_ms=b[0], bound_by=b[1], library_ms=None)
    del x, p, vel
    # K6: two sweeps (the fas legs' n) from e and from zero
    e, r = rn(n8, n8), rn(n8, n8)
    for name, signs in (("Neumann", None), ("signed", EDGE_SIGNS),
                        ("wrap", (0.0, 0.0, 0.0, 0.0))):
        periodic = (signs is not None and signs[0] == 0.0,) * 2
        for fz in (False, True):
            got = hk.fused_jacobi_sweeps(e, r, 0.8, 2, fz, signs)
            ref = hk.jacobi_sweeps_plain(e, r, 0.8, 2, fz, signs, periodic)
            err = f64_close(f"fused_jacobi_sweeps f64 {name} n=2 from_zero="
                            f"{fz} [8192,8192]", got, ref)
            del got, ref
            note("fused_jacobi_sweeps+f64", err)
        ms = cuda_ms(lambda: hk.fused_jacobi_sweeps(e, r, 0.8, 2,
                                                    edge_signs=signs), 10)
        if signs is not None:
            print(f"phase 22 fused_jacobi_sweeps f64 {name} n=2: kernel_ms "
                  f"{ms}", flush=True)
            continue
        pms = cuda_ms(lambda: hk.jacobi_sweeps_plain(e, r, 0.8, 2), 3)
        b = bound(24.0 * cells, OPS_SWEEP_CELL * 2 * cells, PEAK_F64)
        print(f"phase 22 fused_jacobi_sweeps f64 [8192,8192] n=2: kernel_ms"
              f" {ms} twin_ms {pms} bound_ms {b[0]} ({b[1]})", flush=True)
        note("fused_jacobi_sweeps+f64", 0.0, ms=ms, plain_ms=pms,
             bound_ms=b[0], bound_by=b[1], library_ms=None)
    del e, r
    torch.cuda.empty_cache()
    # K4: labs of unit-scale velocity with phase 2's three h classes, held
    # per class at the path's nu and at nu = 1
    n = 16384
    h6 = 4.0 / 2 / 8 / 64
    dtl = torch.tensor(0.25 * h6, dtype=torch.float64, device=dev)
    labs = [rn(n, 2, 14, 14) for _ in range(3)]
    lab = labs[0]
    cls = torch.arange(n, device=dev) % 3
    hl = torch.tensor([h6, h6 / 2, 1.0], dtype=torch.float64,
                      device=dev)[cls].reshape(n, 1, 1, 1)
    err = 0.0
    for nu in (4e-5, 1.0):
        got = hk.fused_lab_rhs(lab, hl, nu, dtl)
        ref = hk.fused_lab_rhs_plain(lab, hl, nu, dtl)
        for c in range(3):
            err = max(err, f64_close(
                f"fused_lab_rhs f64 [{n},2,14,14] nu={nu} h class {c}",
                got[cls == c], ref[cls == c]))
    ms = graph_ms([lambda x=x: hk.fused_lab_rhs(x, hl, 4e-5, dtl)
                   for x in labs])
    pms = graph_ms([lambda x=x: hk.fused_lab_rhs_plain(x, hl, 4e-5, dtl)
                    for x in labs], reps=6)
    b = bound(2 * BYTES_LAB_RHS_BLOCK * n, advect_rhs_ops(lab), PEAK_F64)
    print(f"phase 22 fused_lab_rhs f64 [{n},2,14,14]: kernel_ms {ms} twin_ms"
          f" {pms} bound_ms {b[0]} ({b[1]}, FP64)", flush=True)
    note("fused_lab_rhs+f64", err, ms=ms, plain_ms=pms, bound_ms=b[0],
         bound_by=b[1], library_ms=None)
    del labs, lab, got, ref
    # K8: every form with the forest's P_inv at f64; the library's f64
    # addmm / mm beside each
    p_inv = torch.tensor(block_precond_matrix(8), dtype=torch.float64,
                         device=dev)
    pt = p_inv.T
    sets = [(rn(n, 8, 8), rn(n, 8, 8), rn(n, 8, 8)) for _ in range(6)]
    e, r, lap = sets[0]
    err = f64_close(f"fused_block_jacobi_update f64 [{n},8,8]",
                    hk.fused_block_jacobi_update(e, r, lap, p_inv),
                    hk.block_jacobi_plain(e, r, lap, p_inv))
    for name, args in (("P_inv r", ()), ("e + P_inv r", (e,)),
                       ("e + P_inv (r - lap)", (e, lap))):
        err = max(err, f64_close(
            f"block_precond f64 {name} [{n},8,8]",
            hk.block_precond(r, p_inv, *args),
            hk.block_precond_form_plain(r, p_inv, *args)))
    ms = graph_ms([lambda o=o: hk.fused_block_jacobi_update(*o, p_inv)
                   for o in sets])
    pms = graph_ms([lambda o=o: hk.block_jacobi_plain(*o, p_inv)
                    for o in sets])
    lms = graph_ms([lambda o=o: torch.addmm(
        o[0].reshape(n, 64), o[1].reshape(n, 64) - o[2].reshape(n, 64), pt)
        for o in sets])
    p_ms = graph_ms([lambda o=o: hk.block_precond(o[1], p_inv)
                     for o in sets])
    p_lms = graph_ms([lambda o=o: torch.mm(o[1].reshape(n, 64), pt)
                      for o in sets])
    e_ms = graph_ms([lambda o=o: hk.block_precond(o[1], p_inv, o[0])
                     for o in sets])
    e_lms = graph_ms([lambda o=o: torch.addmm(o[0].reshape(n, 64),
                                              o[1].reshape(n, 64), pt)
                      for o in sets])
    b = bound(8.0 * (4 * 64 * n + 64 * 64), OPS_BLOCK_JACOBI_ELEM * 64 * n,
              PEAK_F64)
    bp = bound(8.0 * (2 * 64 * n + 64 * 64), 2 * 64 * 64 * n, PEAK_F64)
    be = bound(8.0 * (3 * 64 * n + 64 * 64), (2 * 64 + 1) * 64 * n,
               PEAK_F64)
    print(f"phase 22 fused_block_jacobi_update f64 [{n},8,8]: update "
          f"kernel_ms {ms} twin_ms {pms} addmm_ms {lms} bound_ms {b[0]} "
          f"({b[1]}); P kernel_ms {p_ms} mm_ms {p_lms} bound_ms {bp[0]} "
          f"({bp[1]}); E kernel_ms {e_ms} addmm_ms {e_lms} bound_ms "
          f"{be[0]} ({be[1]})", flush=True)
    note("fused_block_jacobi_update+f64", err, ms=ms, plain_ms=pms,
         bound_ms=b[0], bound_by=b[1], library_ms=lms, p_ms=p_ms,
         p_library_ms=p_lms, e_ms=e_ms, e_library_ms=e_lms)
    del sets, e, r, lap
    torch.cuda.empty_cache()


def f64_uniform(dev, pois: str, dtype: str,
                steps: int = F64_UNIFORM_STEPS) -> dict:
    """Phase 22 (b): the 8192^2 benchmark step in ``dtype`` under one
    solver, a warm-up and ``steps`` timed steps; the launches counted over
    them."""
    cfg, level = bench_cfg(8192, 8192)
    with latched(pois):
        g = UniformGrid(dataclasses.replace(cfg, dtype=dtype), level=level,
                        device=dev)
    state = g.zero_state()._replace(
        vel=bench_start(bench_grid(8192, 8192, dev)).vel.to(g.dtype))
    dt = torch.tensor(0.5 * g.h, dtype=g.dtype, device=dev)
    fresh_peak()
    before = dict(hk.launches)
    state, diag = g.step(state, dt, obstacle_terms=False)
    torch.cuda.synchronize()
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, diag = g.step(state, dt, obstacle_terms=False)
        iters.append(diag["poisson_iters"])
    torch.cuda.synchronize()
    out = {"dtype": dtype, "mode": g.poisson_mode,
           "smoother": g.smoother_tier,
           "ms_per_step": (time.perf_counter() - t0) / steps * 1e3,
           "iters": iters, "umax": float(diag["umax"]),
           "finite": bool(torch.isfinite(state.vel).all()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": {k: hk.launches[k] - before[k] for k in hk.launches
                        if hk.launches[k] != before[k]}}
    del state, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def f64_flagship(dev, pois: str) -> dict:
    """Phase 22 (c): ``entry()``'s two fish at 1024 x 512 in f64 under one
    solver: ``initialize()``, then ``F64_FLAGSHIP_STEPS`` production steps
    (the exact startup solves skipped), each timed to its end."""
    with latched(pois):
        sim = Simulation(entry_cfg(dtype="float64"), level=ENTRY_LEVEL,
                         device=dev)
    sim.initialize()
    sim.step_count = 10
    ms, iters, finite = [], [], True
    for _ in range(F64_FLAGSHIP_STEPS):
        t0 = time.perf_counter()
        d = sim.step_once()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(d["poisson_iters"])
        finite = finite and d["finite"]
    uvw = [[s.u, s.v, s.omega] for s in sim.shapes]
    out = {"mode": sim.poisson_mode, "shape": [sim.grid.ny, sim.grid.nx],
           "ms_per_step": sum(ms) / len(ms), "iters": iters, "uvw": uvw,
           "finite": bool(finite and np.isfinite(uvw).all())}
    check(out["finite"], f"flagship f64 {pois or 'default'}: non-finite")
    return out


def f64_forest(dev, forest_start: tuple, pois) -> dict:
    """Phase 22 (c): phase 5's forest in f64 under one solver, from its
    start state, ``F64_FOREST_STEPS`` production steps timed to their
    end."""
    cfg, snap = forest_start
    if pois:
        os.environ["CUP2D_POIS"] = pois
    try:
        sim = AMRSim(cfg64(cfg), shapes=[], device=dev)
    finally:
        os.environ.pop("CUP2D_POIS", None)
    forest_from_numpy(sim, *snap)
    sim.step_count = 10
    ms, iters = [], []
    for k in range(F64_FOREST_STEPS):
        t0 = time.perf_counter()
        d = sim.step_once()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(d["poisson_iters"])
        check(d["finite"], f"forest f64 {pois or 'default'}: non-finite at "
              f"step {k}")
    return {"mode": sim.poisson_mode, "blocks": len(sim.forest.blocks),
            "ms": ms, "iters": iters}


def f64_pair(label: str, card, cpu, steps: int, adapt_at=None) -> dict:
    """Phase 22 (d): ``steps`` steps of a card sim and a CPU sim from one
    state (an adapt before step ``adapt_at``); equal iterations and the
    card's state within F64_TRAJ_REL of the CPU's."""
    iters = {"card": [], "cpu": []}
    for k in range(steps):
        if k == adapt_at:
            a, b = card.adapt(), cpu.adapt()
            check(a == b and set(card.forest.blocks) == set(
                cpu.forest.blocks), f"{label}: the adapts differ")
        iters["card"].append(card.step_once()["poisson_iters"])
        iters["cpu"].append(cpu.step_once()["poisson_iters"])
    if isinstance(card, AMRSim):
        (kc, a), (kp, b) = _ordered_vel(card), _ordered_vel(cpu)
        check(kc == kp, f"{label}: ordered block keys differ")
    else:
        a, b = card.state.vel.cpu(), cpu.state.vel
    rel = float((a - b).abs().max() / b.abs().max())
    out = {"iters": iters, "vel_rel_linf": rel}
    if hasattr(card, "shapes") and card.shapes:
        out["uvw_rel"] = max(
            float(np.abs(np.subtract([p.u, p.v, p.omega],
                                     [q.u, q.v, q.omega])).max()
                  / np.abs([q.u, q.v, q.omega]).max())
            for p, q in zip(card.shapes, cpu.shapes))
    print(f"phase 22 card vs CPU f64 {label} {json.dumps(out)}", flush=True)
    check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
    check(iters["card"] == iters["cpu"], f"{label}: iterations {iters}")
    check(rel <= F64_TRAJ_REL and out.get("uvw_rel", 0.0) <= F64_TRAJ_REL,
          f"{label}: card vs CPU {out} > {F64_TRAJ_REL}")
    return out


def carry_uniform(cpu, card) -> None:
    """One CPU production step of ``cpu`` (the solve from zero pressure),
    then its state, clocks and cached dt given to ``card``."""
    cpu.step_count = 10
    cpu.step_once()
    card.state = type(cpu.state)(*(t.to(card.grid.device)
                                   for t in cpu.state))
    card.time, card.step_count = cpu.time, cpu.step_count
    card._next_dt = cpu._next_dt


def phase_f64_cpu(dev) -> dict:
    """Phase 22 (d): the card's f64 runs against the port's CPU f64 runs
    from one carried state, production steps only: the exact startup
    solves stall at the floor, and the first production solve from zero
    pressure takes 34-92 iterations, which carry a one-ulp difference of
    the input to 1e-9..1e-6 (on the CPU alone), where after it a one-ulp
    difference stays below 1e-13. So the CPU makes that step and the card
    takes its state (``carry_uniform``, ``copy_amr_state``); the flagship
    makes its startup on the card and the CPU takes it. One start serves
    both solvers' pairs. The runs: ``UniformSim`` at 128^2 for 10 steps,
    the flagship at 512 x 256 under both solvers, phase 6's 355-block
    forest under both with an adapt, and the cavity at 128^2 under fas."""
    out, secs = {}, {}
    t0 = time.perf_counter()
    cfg, level = bench_cfg(128, 128)
    card, cpu = (UniformSim(cfg64(cfg), level=level, device=d)
                 for d in (dev, "cpu"))
    cpu.state = bench_state(cpu.grid)
    carry_uniform(cpu, card)
    out["uniform 128^2"] = f64_pair("uniform 128^2", card, cpu, 10)
    secs["uniform"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with latched(""):
        start = Simulation(entry_cfg(dtype="float64"),
                           level=SHAPED_CPU_LEVEL, device=dev)
    start.initialize()
    for _ in range(10):
        start.step_once()
    for pois in ("", "fas"):
        with latched(pois):
            card, cpu = (Simulation(entry_cfg(dtype="float64"),
                                    level=SHAPED_CPU_LEVEL, device=d)
                         for d in (dev, "cpu"))
        copy_simulation_state(start, card)
        copy_simulation_state(start, cpu)
        out[f"flagship 512x256 {pois or 'default'}"] = f64_pair(
            f"flagship 512x256 {pois or 'default'}", card, cpu, 5)
    secs["flagship"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = multilevel_forest(dtype="float64", device="cpu", tol=1e-6,
                             tol_rel=1e-5)
    warm.step_once()
    for pois in (None, "fas"):
        if pois:
            os.environ["CUP2D_POIS"] = pois
        try:
            card, cpu = (AMRSim(warm.cfg, shapes=[], device=d)
                         for d in (dev, "cpu"))
        finally:
            os.environ.pop("CUP2D_POIS", None)
        copy_amr_state(warm, card)
        copy_amr_state(warm, cpu)
        out[f"forest {len(cpu.forest.blocks)} blocks {pois or 'default'}"] \
            = f64_pair(f"forest {pois or 'default'}", card, cpu, 5,
                       adapt_at=2)
    secs["forest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with latched("fas"):
        card, cpu = (cases.make_sim("cavity", level=4, dtype="float64",
                                    device=d) for d in (dev, "cpu"))
    cpu.state = cpu.grid.zero_state()._replace(
        vel=bench_state(cpu.grid).vel)
    carry_uniform(cpu, card)
    out["cavity 128^2 fas"] = f64_pair("cavity 128^2 fas", card, cpu, 5)
    secs["cavity"] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"phase 22 card vs CPU f64 runs took {json.dumps(secs)} s",
          flush=True)
    return out


def phase_f64_refusals(dev) -> dict:
    """Phase 22 (e): what still refuses f64 on the card raises at
    construction, naming the ROADMAP entry (the bf16 tier with f64 state
    as the JAX package words it); the CLI runs ``-dtype float64`` on the
    forest default and with ``-level N`` for a few steps."""
    from cup2d_tpu_torch import __main__ as tmain
    cfg, level = bench_cfg(128, 128)
    c64 = cfg64(cfg)
    mesh = make_mesh(devices=[dev] * 2)
    tries = {
        "split step": lambda: ShardedUniformSim(c64, mesh, level=level),
        "spatial fleet": lambda: tfleet.FleetSim(
            c64, level=level, members=2, mesh=mesh, placement="spatial"),
        "fftd": lambda: UniformGrid(c64, level=level, device=dev,
                                    bc=cases.periodic_table()),
        "bf16": lambda: UniformGrid(c64, level=level, device=dev)}
    env = {"fftd": ("fftd", "f32"), "bf16": ("", "bf16")}
    out = {}
    for name, build in tries.items():
        msg = None
        with latched(*env.get(name, ("", "f32"))):
            try:
                build()
            except ValueError as e:
                msg = str(e)
        out[name] = msg
        print(f"phase 22 refusal {name}: {msg}", flush=True)
        check(msg is not None, f"{name} at f64 on the card did not refuse")
        check(("note (c)" in msg) != (name == "bf16"),
              f"{name}: the refusal names no ROADMAP entry: {msg}")
    shutil.rmtree(PHASE22_DIR, ignore_errors=True)
    canon = CANON_FLAGS.format(lm=CANON_CPU_LEVELS[0],
                               ls=CANON_CPU_LEVELS[1], tol=1e-3,
                               rel=1e-2).split()
    uni = FLAGSHIP_FLAGS.split()
    for argv in (canon, uni):
        argv[argv.index("-dtype") + 1] = "float64"
    uni[uni.index("-level") + 1] = str(SHAPED_CPU_LEVEL)
    for name, argv in (("forest", canon), ("uniform", uni)):
        d = os.path.join(PHASE22_DIR, name)
        t0 = time.perf_counter()
        rc = tmain.main(argv + ["-shapes", ENTRY_SHAPES, "-maxSteps",
                                str(F64_CLI_STEPS), "-output", d])
        secs = time.perf_counter() - t0
        from cup2d_tpu_torch.profiling import load_metrics
        recs = [r for r in load_metrics(os.path.join(d, "metrics.jsonl"))
                if r.get("event") == "metrics"]
        out[f"cli {name}"] = {"rc": rc, "seconds": secs, "steps": len(recs)}
        print(f"phase 22 CLI -dtype float64 ({name}): rc {rc}, {len(recs)} "
              f"steps in {secs} s", flush=True)
        check(rc == 0 and len(recs) == F64_CLI_STEPS,
              f"CLI -dtype float64 ({name}): rc {rc}, {len(recs)} records")
    shutil.rmtree(PHASE22_DIR, ignore_errors=True)
    return out


def phase_f64(dev, res, forest_start: tuple, card: str
              ) -> tuple[dict, dict]:
    """Phase 22: f64 state on the card. (a) the f64 forms against their
    twins; (b) the 8192^2 step at f64 beside f32 under both solvers; (c)
    the flagship step and phase 5's forest at f64; (d) the card's f64 runs
    against the port's CPU f64 runs; (e) the refusals that remain and the
    CLI. The f64 forms' launches are counted over (b) and (c), where no
    twin may run on an f64 card tensor. Returns the summary and those
    launch counts."""
    t0 = time.perf_counter()
    phase_f64_kernels(dev, res)
    secs = {"a": time.perf_counter() - t0}
    hk.reset_launches()
    uniform, flagship, forest = {}, {}, {}
    t0 = time.perf_counter()
    for pois in ("", "fas"):
        names = F64_TWINS + (("jacobi_sweeps_plain",) if pois else ())
        with twin_watch(names, (torch.float64,)) as tw:
            f64 = f64_uniform(dev, pois, "float64")
        f32 = f64_uniform(dev, pois, "float32")
        uniform[pois or "default"] = {"f64": f64, "f32": f32,
                                      "ratio": f64["ms_per_step"]
                                      / f32["ms_per_step"],
                                      "twin_calls": tw.calls}
        print(f"phase 22 uniform 8192^2 {pois or 'default'} "
              f"{json.dumps(uniform[pois or 'default'])}; card {card}",
              flush=True)
        check(f64["finite"], f"uniform f64 {pois}: non-finite")
        check(not any(tw.calls.values()),
              f"uniform f64 {pois}: twins on the card {tw.calls}")
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pois in ("", "fas"):
        names = F64_TWINS + (("jacobi_sweeps_plain",) if pois else ())
        with twin_watch(names, (torch.float64,)) as tw:
            flagship[pois or "default"] = f64_flagship(dev, pois)
            forest[pois or "default"] = f64_forest(dev, forest_start,
                                                   pois or None)
        check(not any(tw.calls.values()),
              f"flagship / forest f64 {pois}: twins on the card {tw.calls}")
    launches = {k: hk.launches[k] for k in F64_KEYS}
    print(f"phase 22 flagship f64 {json.dumps(flagship)}", flush=True)
    print(f"phase 22 forest f64 {json.dumps(forest)}", flush=True)
    print(f"phase 22 f64 launches over (b) and (c) {json.dumps(launches)}",
          flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k}: launched no time on the f64 paths")
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    versus = phase_f64_cpu(dev)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refusals = phase_f64_refusals(dev)
    secs["e"] = time.perf_counter() - t0
    print(f"phase 22 sections took {json.dumps(secs)} s", flush=True)
    return ({"uniform": uniform, "flagship": flagship, "forest": forest,
             "card_vs_cpu": versus, "refusals": refusals, "seconds": secs},
            launches)


# phase -> the phases whose results it cannot run without
PHASE_NEEDS = {13: (2,), 15: (5, 14), 17: (5,), 18: (2,), 19: (5,),
               20: (5,), 22: (2, 5)}
PHASES = range(2, 23)


def phases_of(argv: list) -> set:
    """The phases to run: all (no arguments), or ``--phases`` a,b-c with
    what they need (``PHASE_NEEDS``, transitively)."""
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases or ranges (2,5,13-15); "
                    "default: every phase")
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    want = set()
    for part in args.phases.split(","):
        a, _, b = part.partition("-")
        want.update(range(int(a), int(b or a) + 1))
    if not want <= set(PHASES) | {1}:
        ap.error(f"--phases: {sorted(want - set(PHASES) - {1})} are not "
                 f"phases 1-{PHASES[-1]}")
    todo = sorted(want)
    while todo:
        for k in PHASE_NEEDS.get(todo.pop(), ()):
            if k not in want:
                want.add(k)
                todo.append(k)
    return want - {1}


def main(argv=None) -> int:
    run = phases_of(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    logs = hk.build()
    secs = time.perf_counter() - t_start
    card = card_line()
    print(f"phase 1 build {secs} s; card {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; phases {sorted(run)}", flush=True)
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

    launches = {}
    res = None
    if 2 in run:
        t2 = time.perf_counter()
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
        print(f"phase 2 took {time.perf_counter() - t2} s", flush=True)
        # the single-op RHS lies on no path: its launches are phase 2's
        launches["advect_diffuse_rhs"] = res["advect_diffuse_rhs"][
            "launches"]
    t0 = time.perf_counter()

    runs = None
    if 3 in run:
        uniform = ("fused_advect_heun", "fused_correction",
                   "fused_jacobi_sweeps")
        hk.reset_launches()
        runs = [run_main_path(dev, p) for p in ("", "fas")]
        launches.update({k: hk.launches[k] for k in uniform})
        for k in uniform:
            check(launches[k] > 0,
                  f"{k}: launched no time on the uniform main path")
    if 4 in run:
        phase_trajectory(dev)
    if run & {3, 4}:
        print(f"phases 3-4 took {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()

    forest_runs = forest_start = forest_warm = None
    if 5 in run:
        forest_runs, forest_launches, forest_start = phase_forest(dev)
        for k, n in forest_launches.items():
            check(n > 0, f"{k}: launched no time on the forest main path")
        launches.update(forest_launches)
    if 6 in run:
        phase_forest_cpu(dev, "fas")
        phase_forest_cpu(dev, tol=1e-6, tol_rel=1e-5)
    if run & {5, 6}:
        print(f"phases 5-6 took {time.perf_counter() - t0} s", flush=True)

    sharded = None
    if 7 in run:
        t0 = time.perf_counter()
        sharded = phase_sharded(dev)
        for k in ("advect_substage_halo", "jacobi_halo_sweep"):
            launches[k] = sum(r["sharded"]["launches"][k] for r in sharded)
            check(launches[k] > 0, f"{k}: launched no time on the split "
                  "path")
        print(f"phase 7 took {time.perf_counter() - t0} s", flush=True)

    side = {}
    for k_phase, label, fn in (
            (8, "the wall-bounded path", phase_walled),
            (9, "the bf16 main path", phase_bf16),
            (10, "the split wall-bounded path", phase_split_walled)):
        if k_phase not in run:
            continue
        t0 = time.perf_counter()
        out, got = fn(dev)
        print(f"phase {k_phase} took {time.perf_counter() - t0} s",
              flush=True)
        for k, n in got.items():
            check(n > 0, f"{k}: launched no time on {label}")
        launches.update(got)
        side[k_phase] = out
    walled, bf16_runs, split_walled = (side.get(k) for k in (8, 9, 10))

    shaped, shaped_launches = {"kernels": {}}, {}
    if 11 in run:
        t0 = time.perf_counter()
        shaped, shaped_launches = phase_shaped(dev)
        print(f"phase 11 took {time.perf_counter() - t0} s", flush=True)
        for k, n in shaped_launches.items():
            check(n > 0, f"{k}: launched no time on the flagship step")

    canon, canon_launches = {"kernels": {}}, {}
    if 12 in run:
        t0 = time.perf_counter()
        canon, canon_launches = phase_canonical(dev)
        print(f"phase 12 took {time.perf_counter() - t0} s", flush=True)
        for k, n in canon_launches.items():
            check(n > 0, f"{k}: launched no time on the canonical forest")

    periodic, periodic_launches = None, {}
    if 13 in run:
        t0 = time.perf_counter()
        periodic, periodic_launches = phase_periodic(dev, res)
        print(f"phase 13 took {time.perf_counter() - t0} s", flush=True)
        for k, n in periodic_launches.items():
            check(n > 0, f"{k}: launched no time on the periodic main path")
        launches.update(periodic_launches)

    cli = None
    if 14 in run:
        t0 = time.perf_counter()
        cli, _ = phase_cli(
            dev, canon["canonical"][0]["production"]["ms_per_step"]
            if 12 in run else None,
            shaped["flagship"][0]["production"]["ms_per_step"]
            if 11 in run else None)
        print(f"phase 14 took {time.perf_counter() - t0} s", flush=True)

    if run & {15, 17, 19, 20}:
        forest_warm = warm_forest(dev, forest_start)
    supervised, sup_launches = None, {}
    if 15 in run:
        t0 = time.perf_counter()
        supervised, sup_launches = phase_supervised(
            dev, forest_warm, cli["canonical"]["production_ms_per_step"],
            card)
        print(f"phase 15 took {time.perf_counter() - t0} s", flush=True)

    fleet, fleet_launches = {"curves": {}}, {}
    if 16 in run:
        t0 = time.perf_counter()
        fleet, fleet_launches = phase_fleet(dev, card)
        print(f"phase 16 took {time.perf_counter() - t0} s", flush=True)

    mesh_runs, mesh_launches = {"forest": {"kernels": {}}}, {}
    if 17 in run:
        t0 = time.perf_counter()
        mesh_runs, mesh_launches = phase_mesh(dev, forest_start,
                                              forest_warm, card)
        print(f"phase 17 took {time.perf_counter() - t0} s", flush=True)
        for k in FOREST_MESH_KEYS:
            check(mesh_launches[k] > 0, f"{k}: launched no time on the "
                  "forest mesh path")

    pd_mesh, pd_launches = None, {}
    if 18 in run:
        t0 = time.perf_counter()
        pd_mesh, pd_launches = phase_periodic_mesh(dev, res, card,
                                                   fleet["curves"])
        print(f"phase 18 took {time.perf_counter() - t0} s", flush=True)
        for k in SPLIT_PD_KEYS:
            check(pd_launches.get(k, 0) > 0, f"{k}: launched no time on "
                  "the split periodic path")
        launches.update({k: pd_launches[k] for k in SPLIT_PD_KEYS})

    dist_runs, dist_launches = None, {}
    if 19 in run:
        t0 = time.perf_counter()
        dist_runs, dist_launches = phase_dist(
            dev, forest_warm, card, fleet_digests=(
                pd_mesh["fleets"].pop("digests") if 18 in run else None))
        print(f"phase 19 took {time.perf_counter() - t0} s", flush=True)
    if pd_mesh is not None:
        # phase 18's fleet digests (tensors on the card) serve phase 19 only
        pd_mesh["fleets"].pop("digests", None)

    elastic_runs, elastic_launches = None, {}
    if 20 in run:
        t0 = time.perf_counter()
        hk.reset_launches()
        elastic_runs, elastic_launches = phase_elastic(dev, forest_warm,
                                                       card)
        print(f"phase 20 took {time.perf_counter() - t0} s", flush=True)
        for k in ELASTIC_UNIFORM_KEYS + ELASTIC_FOREST_KEYS:
            check(elastic_launches[k] > 0, f"{k}: launched no time on the "
                  "elastic drills")
    lint = None
    if 21 in run:
        t0 = time.perf_counter()
        lint = phase_lint(card)
        print(f"phase 21 took {time.perf_counter() - t0} s", flush=True)
    f64_runs = None
    if 22 in run:
        t0 = time.perf_counter()
        f64_runs, f64_launches = phase_f64(dev, res, forest_start, card)
        launches.update(f64_launches)
        print(f"phase 22 took {time.perf_counter() - t0} s", flush=True)
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    check("jax" not in sys.modules, "the smoke imported jax")
    check("validation" not in sys.modules, "the smoke imported validation")

    for label, summary in (
            ("main path", runs), ("forest main path", forest_runs),
            ("sharded main path", sharded),
            ("wall-bounded main path", walled),
            ("bf16 main path", bf16_runs),
            ("split wall-bounded main path", split_walled),
            ("flagship step", shaped if 11 in run else None),
            ("canonical shaped forest", canon if 12 in run else None),
            ("periodic main path", periodic), ("run driver", cli),
            ("supervised runs", supervised),
            ("fleet", fleet if 16 in run else None),
            ("forest mesh", mesh_runs if 17 in run else None),
            ("periodic mesh and placed fleets", pd_mesh),
            ("multi-process", dist_runs),
            ("elastic recovery", elastic_runs), ("lint", lint),
            ("f64 on the card", f64_runs)):
        if summary is not None:
            print(f"{label} summary: {json.dumps(summary)}")
    print(f"total {time.perf_counter() - t_start} s")
    if res is not None:
        kernels = [dict(
            name=k, route="cuda", source=hk.source_of(k),
            replaces=hk.REPLACES[hk.kernel_of(k)],
            launches=launches.get(k),
            **{k2: res.get(k, {}).get(k2) for k2 in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            on_main_path=k != "advect_diffuse_rhs",
            flagship_launches=shaped_launches.get(k, 0),
            flagship=shaped["kernels"].get(k),
            canonical_launches=canon_launches.get(k, 0),
            canonical=canon["kernels"].get(k),
            periodic_launches=periodic_launches.get(k, 0),
            supervised_launches=sup_launches.get(k, 0),
            fleet_launches=fleet_launches.get(k, 0),
            forest_mesh_launches=mesh_launches.get(k, 0),
            forest_mesh=mesh_runs["forest"]["kernels"].get(k),
            periodic_mesh_launches=pd_launches.get(k, 0),
            dist_launches=dist_launches.get(k, 0),
            elastic_launches=elastic_launches.get(k, 0),
            **({k2: res[k][k2] for k2 in ("ulps", "fft_ms", "aux_ms",
                                          "p_ms", "p_library_ms", "e_ms",
                                          "e_library_ms")
                if k2 in res.get(k, {})}))
            for k in hk.launches]
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()},
        **({} if run == set(PHASES) else {"phases": sorted(run)})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
