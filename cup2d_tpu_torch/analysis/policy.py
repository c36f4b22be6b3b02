"""graftlint policy for the port — the sanctioned-site tables, as DATA.

Every table row is a deliberate, reasoned exception to a rule (or, for
the alias and leading-dim tables, the contract's reach); adding a row is
a review-visible act (this file is the single source of truth — the
tests are thin wrappers over it). Rows that stop matching reality are
themselves findings (`stale policy row`, emitted by each rule's finalize
pass), so the tables cannot rot silently.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# env-latch — CUP2D_* env gates are read ONCE at a sanctioned
# construction/enable point and stored, never consulted mid-run: a read
# in a per-step or per-refresh helper means a mid-run env mutation
# silently flips a solver, storage precision or exchange form at the
# next step or regrid.
# ---------------------------------------------------------------------------

# files where ANY CUP2D_* read is a sanctioned latch: none — the port's
# config.py reads no env var (SimConfig is built from flags alone)
ENV_LATCH_FILES = frozenset()

# (file, enclosing scope) -> allowed vars. Each is a construct-once /
# enable-once latch, or a measurement entry point's write around one:
ENV_LATCH_SITES = {
    # the forest's solver and storage gates, latched per sim in the
    # constructor: CUP2D_POIS (structured|tables|fft|fas|fas-f; fftd
    # refuses by name), CUP2D_TWOLEVEL (the two-level preconditioner),
    # CUP2D_PREC (the bf16-leg FAS tier). The step reads the stored
    # self._pois_mode / self._twolevel_form / self._fas_leg_dtype, never
    # the env
    ("amr.py", "AMRSim.__init__"): {"CUP2D_POIS", "CUP2D_TWOLEVEL",
                                    "CUP2D_PREC"},
    # the uniform family's ONE latch: the storage precision (stored as
    # self.bf16, the grid's kernel tier) and the solver (solver_mode /
    # fas_fmg; fftd is a VALUE of CUP2D_POIS, not a read site of its
    # own). UniformSim, Simulation, FleetSim and the split sims read the
    # grid's stored latch
    ("uniform.py", "UniformGrid.__init__"): {"CUP2D_PREC", "CUP2D_POIS"},
    # the fault-injection latch: every injector parses from the ONE plan
    # FaultPlan.from_env constructs; StepGuard, TopologyGuard and io's
    # crash window read the plan object, never the env
    ("faults.py", "FaultPlan.from_env"): {"CUP2D_FAULTS"},
    # read once from ShardedAMRSim.__init__, stored as self._exchange
    ("parallel/forest_mesh.py", "_exchange_mode"):
        {"CUP2D_SHARD_EXCHANGE"},
    # windowed device tracing: latched once by the CLI before the run
    # loop (a mid-run mutation must not re-arm a finished window)
    ("profiling.py", "TraceWindow.from_env"): {"CUP2D_TRACE"},
    # flight-recorder span ring: read once at construction; the
    # installed recorder stores spans_on/max_spans
    ("tracing.py", "FlightRecorder.from_env"): {"CUP2D_SPANS"},
    # the kernel build directory: latched at the first call into the
    # module-level _LATCHED list (a path, not a numerics gate)
    ("cache.py", "build_dir"): {"CUP2D_CACHE"},
    # the regrid helper's build directory, as the JAX package reads it:
    # latched at the first build into the module-level _CACHE list (a
    # path, not a numerics gate; unset, cache.build_dir's)
    ("native/__init__.py", "_lib_path"): {"CUP2D_NATIVE_CACHE"},
    # measurement entry points, not the library: dist_check's _latched
    # sets CUP2D_POIS around the construction of the sims it compares
    # and pops it after, so the latch above reads the solver the run
    # names
    ("dist_check.py", "_latched.__enter__"): {"CUP2D_POIS"},  # sets it
    ("dist_check.py", "_latched.__exit__"): {"CUP2D_POIS"},   # pops it
    # profile_step writes CUP2D_POIS before it builds the sim it traces
    # and pops it in a finally after the run (the forest, the split
    # channel under fas, the uniform solver)
    ("profile_step.py", "profile_forest"): {"CUP2D_POIS"},   # --forest
    ("profile_step.py", "profile_channel"): {"CUP2D_POIS"},  # --channel
    ("profile_step.py", "profile_solver"): {"CUP2D_POIS"},   # --size
}


# ---------------------------------------------------------------------------
# host-sync — the port's step reads the card through ``shapes_host.pull``
# (one stacked copy, counted in ``pulls``, which profiling.HostCounters
# reports as device_gets); every other read or card-wide wait stalls
# the launch queue with no counter to see it. The rows below are the
# sanctioned read sites, each with the count that pins it where one
# does; a row whose read no runtime count pins says so, and stands in
# ROADMAP's held speed notes.
# ---------------------------------------------------------------------------

# measurement modules, sanctioned whole: they time kernels and steps
# with CUDA events and synchronize around the timed region by design,
# and no library path imports them
HOST_SYNC_FILES = frozenset({
    "kernel_ab.py",      # kernel A/B timing (ulp distances read back)
    "profile_step.py",   # torch.profiler traces of steps
    "dist_check.py",     # multi-process runs compared by digest
    "ops/timing.py",     # cuda_ms / graph_ms and the sweep tables
})

HOST_SYNC_SITES = {
    # the counting reader itself (its .cpu() is THE copy every counted
    # read makes), the diag form over it, and the shaped drivers' two
    # batched reads: the S x 19 shape scalars after rasterization and
    # the force rows, each one pull for every shape
    "shapes_host.py": {"pull", "pull_diag",
                       "ShapeHostMixin._sync_shape_scalars",
                       "ShapeHostMixin._record_forces"},
    # each driver's step: the one pull_diag of the step's diagnostics
    # (dt_next folded in), plus the cold-start dt read when no cached
    # dt exists (the first step, the first after a restart); pinned by
    # the device_gets counts of tests/test_torch_cli.py and
    # tests/test_torch_snapshot_ring.py. advance is the library loop's
    # explicit CFL read, one per step by its contract
    "uniform.py": {"UniformSim.step_once", "UniformSim.advance"},
    # the shaped uniform step: the same two reads, plus its diag pull
    # after the obstacle pass carries the shapes' uvw rows along
    "sim.py": {"Simulation.step_once"},
    # the forest: step_once's diag pull and dt read; _step_shaped is the
    # shaped step's (the force pass's one read and the post-regrid dt);
    # compute_dt is the explicit CFL read; initialize's one stacked
    # any-nonzero read (once per run) and _adapt_impl's tag-vector read
    # (once per regrid, the host decides the new forest) are cold
    "amr.py": {"AMRSim.step_once", "AMRSim._step_shaped",
               "AMRSim.compute_dt", "AMRSim.initialize",
               "AMRSim._adapt_impl"},
    # fleets: FleetSim.step_once's one [B]-row diag pull goes through
    # _host_diag; member_step_once is the guard's solo replay/retry
    # (recovery, a cold path) with its own dt read
    "fleet.py": {"_host_diag", "FleetSim.member_step_once"},
    # the batched scalar read of the supervision layer (one pull for
    # every tensor the verdict needs); _gather_ints is the world's
    # heartbeat all-gather, read once per step boundary on a
    # multi-process run only — NOT counted in device_gets (ROADMAP,
    # held speed notes); step_boundary's synchronize drains the exiting
    # rank's queue once, at its own exit (elastic drill, cold)
    "resilience.py": {"_host_scalars", "_gather_ints",
                      "TopologyGuard.step_boundary"},
    # the solvers' convergence flags, read per iteration (bicgstab: the
    # start test, the restart/breakdown tests and the stacked
    # convergence flags; the final norms once) or per cycle (mg_solve:
    # the start test, the stacked converged/stalled flags, the final
    # norm), the members' flag rows (_member_flags) and fftd's one
    # residual read; each is a pull, counted in device_gets (a shaped
    # uniform production step reads 3 + 2 + 2 x its BiCGSTAB iterations,
    # pinned by tests/test_torch_cli.py; the iteration counts by the
    # solver parity tests) — the input of the future change that moves
    # the convergence tests onto the card (ROADMAP, held speed notes)
    "poisson.py": {"_member_flags", "bicgstab", "mg_solve",
                   "fft_diag_solve"},
    # io's cold gathers: dumps, checkpoint and member-checkpoint state
    # gathers (HostCounters.state_gathers meters them), the snapshot
    # restore's dt-cache entries, the mirror tier's checksum read
    # (elastic recovery only)
    "io.py": {"_dump_uniform", "_dump_forest", "_gather_state",
              "save_member_checkpoint", "restore_snapshot_device",
              "verify_mirror"},
    # the conversions to and from the JAX package's numpy layout: whole-
    # state copies made once by a caller that wants host arrays (tests,
    # a restart from the other package), never per step
    "convert.py": {"state_to_numpy", "forest_to_numpy",
                   "obstacle_to_numpy", "copy_simulation_state", "_host"},
    # the world handshake: one all-gather of the rank ids, read once
    # when the world forms (not per step)
    "parallel/launch.py": {"_handshake"},
    # PhaseTimers.fence: the opt-in phase timers synchronize each card
    # once per fenced phase, by their contract (off unless -profile);
    # record_step is the metrics recorder's library-path fallback (one
    # pull of the tensors a caller left in diag; the drivers hand it
    # host values)
    "profiling.py": {"PhaseTimers.fence", "MetricsRecorder.record_step"},
    # the Ghia drill (python -m cup2d_tpu_torch.cases --ghia): the
    # centreline read and the synchronize that closes the timed loop,
    # once per run
    "cases.py": {"centerline_profiles", "ghia_run"},
}


# ---------------------------------------------------------------------------
# alias-safety — torch has no buffer donation; the hazard donation
# guarded is aliasing now: the step writes into the tensors it was given
# (in-place updates, ``.copy_`` in ops/obstacle.py), so a state installed
# from a tensor that shares memory with a numpy buffer (a checkpoint's
# npz, the caller's array) or with a snapshot-ring entry corrupts that
# buffer or the snapshot a later restore needs.
# ---------------------------------------------------------------------------

# attributes that hold snapshot-ring entries: DeviceSnapshot.payload
# (io.py) — a restore installs fresh clones of them, never the entry
ALIAS_SNAPSHOT_ATTRS = frozenset({"payload"})

# (defining file, defining scope, kind) of each state sink: "call" —
# a call of that def installs its arguments; "attr" — a store to
# ``<obj>.<attr>`` installs the value; "item" — a store to
# ``<obj>.<attr>[k]`` does
ALIAS_SINKS = (
    # the uniform family's state tuple: every driver's state is one
    ("uniform.py", "FlowState", "call"),
    # the fleet's install: an unplaced fleet keeps the state it is given
    # as is (a placed one, like ShardedUniformSim.set_state, copies it
    # onto its slabs or blocks — the row matches every set_state call)
    ("fleet.py", "FleetSim.set_state", "call"),
    # the drivers' state attribute, stepped in place
    ("uniform.py", "UniformSim.state", "attr"),
    ("sim.py", "Simulation.state", "attr"),     # the shaped uniform step
    # the forest's slot fields (Forest.fields[name] = tensor)
    ("forest.py", "Forest.fields", "item"),
)


# ---------------------------------------------------------------------------
# leading-dim — field operators address the trailing [-2]=y / [-1]=x axes
# via ``...`` slicing and negative axis numbers ONLY, so one kernel and
# one plain twin serve uniform [ny,nx], member-batched [B,ny,nx] and
# forest-lab [N,2,H,W] operands. file -> checked scopes ("*" = whole
# file). Scopes NOT listed (the DCT base solves, the forest FAS window
# images, the C entries' fixed layouts) are 2-D or flat by design.
# ---------------------------------------------------------------------------

LEADING_DIM_SCOPES = {
    # the stencil library is the contract's origin: every op serves the
    # uniform grid, the fleet's member batch and the split slabs
    "ops/stencil.py": ("*",),
    # the MG cycle runs member-batched (one V-cycle over [B, ny, nx]);
    # mg_solve / _mg_solve_members are the cycle loop, bicgstab /
    # _bicgstab_members carry the member axis through the Krylov state;
    # project_correct is the shared epilogue over any leading shape;
    # fft_diag_solve / FFTDiagPlan batch B systems through one
    # transform (trailing-axes rffts, the Thomas scans broadcast over
    # any lead)
    "poisson.py": ("MultigridPreconditioner", "bicgstab",
                   "_bicgstab_members", "mg_solve", "_mg_solve_members",
                   "project_correct", "fft_diag_solve", "FFTDiagPlan"),
    # the wrappers of the hand-written kernels that take any leading
    # shape and flatten it to the kernel's [L, ...] layout, and their
    # plain twins, which must compute the same function on the same
    # operands (the flattening itself must not assume a rank; the C
    # entries below them see fixed layouts)
    "ops/hopper_kernels.py": (
        "fused_advect_heun", "fused_advect_heun_plain",
        "fused_correction", "fused_correction_plain",
        "fused_jacobi_sweeps", "jacobi_sweeps_plain",
        "fused_lab_rhs", "fused_lab_rhs_plain",
        "fused_block_jacobi_update", "block_jacobi_plain",
        "block_precond", "block_precond_plain",
        "advect_diffuse_rhs", "advect_diffuse_rhs_plain",
        "advect_substage_halo", "advect_substage_halo_plain",
        "jacobi_halo_sweep", "jacobi_halo_sweep_plain"),
    # the split step's substage pair (flattens any leading shape before
    # the slab loop, so fleet spatial pools and the solo split sim share
    # it), the halo smoother behind overlap_jacobi_sweeps, and the split
    # Poisson RHS with its obstacle term (a solo [2, ny, w] slab and a
    # spatial fleet's [B, 2, ny, w] one, dt a scalar or [B, 1, 1])
    "parallel/shard_halo.py": ("fused_advect_heun_sharded",
                               "overlap_jacobi_sweeps", "sweep_slabs",
                               "sweep_exchanged", "divergence_bc_x",
                               "_divergence_x"),
    # the obstacle terms' two entry points: one penalization and one RHS
    # for the solo step, every fleet layout and the split step's slabs
    "uniform.py": ("UniformGrid.penalize", "UniformGrid.poisson_rhs"),
}
