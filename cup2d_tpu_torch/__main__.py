"""Run driver: ``python -m cup2d_tpu_torch <reference flags>``, the
counterpart of ``python -m cup2d_tpu``.

Runs the case the reference's ``main()`` runs, with its flag names
(run.sh:1-22), e.g. the canonical two-fish adaptive run:

    python -m cup2d_tpu_torch -bpdx 2 -bpdy 1 -levelMax 8 -levelStart 5 \
        -Rtol 2 -Ctol 1 -extent 4 -CFL 0.5 -tend 10 -lambda 1e7 \
        -nu 0.00004 -poissonTol 1e-3 -poissonTolRel 0.01 \
        -maxPoissonRestarts 0 -maxPoissonIterations 1000 -AdaptSteps 20 \
        -tdump 0.5 -noSupervise -shapes 'angle=0 L=0.2 xpos=1.8 ypos=0.8
                                         angle=180 L=0.2 xpos=1.6 ypos=0.8'

The adaptive forest by default (``amr.AMRSim``); ``-level N`` a uniform
run at level N (``sim.Simulation``); ``-case NAME`` a catalog case
(``cases.REGISTRY``; ``-level`` overrides its resolution, ``-tend`` and
``-tdump`` its schedule); ``-fleet B`` B obstacle-free uniform members in
one batched step (``fleet.FleetSim``: a dt and a clock each, the
amplitude-laddered Taylor-Green ensemble at t = 0, or a fleet-capable
catalog case with ``-case``; per-member supervision by
``resilience.FleetStepGuard``; per-member dumps ``vel.NNNNNNNN.mK`` at
each member's own clock; ``-shapes`` refuses). ``-serve N`` with ``-fleet
B`` serves N Taylor-Green sessions with horizons staggered over [tend/2,
tend] through the B-slot pool (``fleet.FleetServer``): each admitted into
a free slot, retired at its horizon with a session checkpoint under
``<output>/sessions/<client>``, evicted if its recovery ladder runs out;
per-client streams under ``<output>/clients/``, a ``serving_latency``
record at exit unless ``-noMetrics``; SIGTERM parks every live session and
exits 0. Extra flags as in the JAX package: ``-dtype``,
``-output DIR``, ``-checkpointEvery N``, ``-restart DIR`` (a checkpoint of
either package), ``-maxSteps N``, ``-metricsLog PATH``, ``-noMetrics``,
``-eventLog PATH``, ``-logRotateMB N``, ``-noWatchdog``; and one of the
port's own, ``-device cpu|cuda[:i]`` (default ``cuda``: without a card
and without ``-device cpu`` the run raises).

The loop is the JAX package's supervised loop: every step goes through
``resilience.StepGuard`` with its device snapshot ring (``-guardRing N``
anchors, one snapshot every ``-snapEvery N`` good steps) and its recovery
ladder (retry at dt/2, the exact solve, the checkpoint on disk, abort
with a post-mortem checkpoint and rc 1); ``-noSupervise`` keeps only the
verdict (the first bad step aborts). The verdict lags one step on the
obstacle-free drivers unless ``-noLag`` (the shaped ones verdict
eagerly): the loop drains it before each dump, adapt, checkpoint and
SIGTERM save and at its end, and re-checks the dump schedule after a
drain, whose disk restore may rewind the clock. ``CUP2D_FAULTS`` (latched
once, ``faults.FaultPlan``) arms fault injection. Also: dumps on the
catch-up ``-tdump`` schedule; the adapt schedule (steps <= 10, then
every ``AdaptSteps``); ``forces.csv`` (appended on a restart); one
``metrics.jsonl`` record a step (schema 12, flight-recorder fields null,
no ``spans.jsonl``); SIGTERM writes ``<output>/checkpoint`` and exits 0.
``CUP2D_TRACE=start:stop[:logdir]`` wraps steps [start, stop) in
``torch.profiler``.

``-mesh N|all`` splits the run over a device mesh (the JAX CLI's
branches, ``cup2d_tpu/__main__.py:182-289``): the forest path builds
``parallel.forest_mesh.ShardedAMRSim`` (the canonical run, shapes and
all), the uniform path a Taylor-Green-seeded
``parallel.mesh.ShardedUniformSim`` (obstacle-free only), ``-case
cavity`` its split form, and ``-case cavity -fleet B [-serve S]`` a fleet
placed on the mesh by the fleet's own policy (``FleetSim(mesh=,
placement="auto")``: whole members along the mesh where B divides by it,
else split along x); dumps and checkpoints keep the global layout, so a
checkpoint restarts on any mesh or on none. ``all`` takes every visible
card, ``N`` the first N cards; with ``-device`` naming one device, ``-mesh
N`` puts N shards on it (four shards on one card, or on the CPU).
``-fleet`` with ``-mesh`` and no ``-case``, and ``-case X -mesh N`` for
any X but cavity, exit 2 with the JAX CLI's messages.

Several processes run one simulation (``parallel.launch``, the JAX
CLI's ``cup2d_tpu/__main__.py:186-204``): with ``-mesh``, ``-coordinator
HOST:PORT -meshHosts N -processId R`` (or torchrun's environment, e.g.
``python -m torch.distributed.run --standalone --nproc_per_node 4 -m
cup2d_tpu_torch ... -mesh all``) brings up a ``torch.distributed`` world
(NCCL on cards, gloo with ``-device cpu``; ``-connectAttempts`` and
``-connectBackoff`` bound the connect) before any sim is built. ``-mesh
all`` is then one shard per rank (``global_mesh``), ``-mesh N`` N shards
over the ranks (N divisible by the world size), each rank's on its device:
``-device cpu``'s CPU, or its card (``cuda:LOCAL_RANK``, else
``processId`` modulo the card count). The progress lines, the metrics,
the event log, ``forces.csv``, the dumps and the checkpoints come from
rank 0; every rank takes the same steps and regrids, and a SIGTERM stops
every rank at the same step once every rank has it. A world that does
not form fails the run (rc 1), never a silent single-process run.

Elastic recovery, as the JAX CLI (``cup2d_tpu/__main__.py:330-375``,
:527-570): ``-elastic`` on a ``-mesh`` of 2 or more shards arms
``resilience.TopologyGuard``, whose heartbeat rides the step boundary's
SIGTERM all-gather (``-heartbeatTimeout S`` its deadline, default 10; a
host is lost after ``-heartbeatMissK K`` missed beats, default 3).
``-simHosts H`` groups one process's shards into H simulated hosts, whose
losses ``CUP2D_FAULTS`` injects (``host_exit@N``, ``host_hang@N``,
``shard_loss@N``, ``mirror_corrupt@N``): a declared loss re-meshes the
survivors and resumes in place (``StepGuard.elastic_recover``: ring,
mirror, disk, abort), with ``topology_lost`` and ``remesh`` events and the
metrics' elastic fields. Over 2 or more hosts the mirror tier is on
(``-noMirror`` turns it off, ``-mirror`` asks for it, ``-mirrorEvery N``
mirrors every Nth snapshot). Under a world (no ``-simHosts``) a rank armed
with ``host_exit`` announces it and exits with code 17, and a survivor that
sees a loss or a missed deadline aborts the world and exits 1 (in-place
resume across ranks is the library's ``parallel.launch.reinit_distributed``
with ``elastic_recover``). ``-elastic`` without a mesh of 2 or more, or in
one process without ``-simHosts``, exits 2 with the JAX CLI's messages.

What the port cannot do yet is refused with rc 2 before any work, naming
its ROADMAP queue 1 item: a fleet across processes (item 8);
``-profile``, ``-spansLog`` and span ring capacities in ``CUP2D_SPANS``
(item 9). The JAX CLI's usage errors exit 2 with its messages.
Flags that only turn off what the port lacks (``-noSpans``,
``-noMemLedger``) are accepted.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .config import CommandlineParser, SimConfig
from .io import dump_forest, dump_uniform, load_checkpoint, save_checkpoint

_PREFIX = "cup2d_tpu_torch"

# flag -> (ROADMAP queue 1 item, what it asks for)
_REFUSED = {
    "profile": (9, "per-phase timers"),
    "spansLog": (9, "the flight recorder's span timeline"),
}


# the flags of a multi-process world
_WORLD_FLAGS = ("coordinator", "meshHosts", "processId", "connectAttempts",
                "connectBackoff")


def _not_ported(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP queue 1 item {item})"


_FLEET_ACROSS = "-fleet across processes: " + _not_ported(
    "a fleet whose mesh spans processes", 8)


_ELASTIC_NEEDS_MESH = ("-elastic needs -mesh with at least 2 devices "
                       "(nothing to re-mesh onto otherwise)")


def _refusal(p) -> str | None:
    """The usage error of this command line, or None. The reference's own
    usage errors first (naming the item where their flag waits for one),
    then every flag and variable whose effect the port cannot give."""
    if p.has("serve") and not p.has("fleet"):
        return "-serve N needs -fleet B (the slot pool it serves through)"
    if p.has("serve") and p.has("restart"):
        return ("-serve resumes per-session (admit from "
                "<output>/sessions/<client>), not from a whole-fleet "
                "-restart")
    if p.has("elastic") and not p.has("mesh"):
        return _ELASTIC_NEEDS_MESH
    if p.has("fleet") and p.has("mesh") and not p.has("case"):
        return ("-fleet has its own placement policy (fleet.py) and does "
                "not combine with -mesh")
    if p.has("fleet") and any(p.has(f) for f in _WORLD_FLAGS):
        return _FLEET_ACROSS
    if not p.has("mesh") and any(p.has(f) for f in _WORLD_FLAGS):
        return ("-coordinator/-meshHosts/-processId/-connectAttempts/"
                "-connectBackoff bring up a world for -mesh; give -mesh "
                "N|all")
    if p.has("mesh") and p.has("device") \
            and p("mesh").asString() == "all":
        return ("-mesh all takes every visible card; with -device, give "
                "the shard count (-mesh N puts N shards on that device)")
    for flag, (item, what) in _REFUSED.items():
        if p.has(flag):
            return f"-{flag}: " + _not_ported(what, item)
    if os.environ.get("CUP2D_SPANS", "0") != "0":
        return "CUP2D_SPANS: " + _not_ported("the span ring", 9)
    return None


def _abort_world() -> None:
    """Abort a world with a lost or hung member (a destroy could wait on
    it); no-op without one."""
    from .parallel.launch import shutdown_distributed
    shutdown_distributed(abort=True)


def _say(msg: str) -> None:
    """A progress line on stderr, from rank 0 under a world."""
    from .resilience import is_writer
    if is_writer():
        print(f"{_PREFIX}: {msg}", file=sys.stderr)


def main(argv=None) -> int:
    """Run the command line; a world this run brought up is torn down at
    its end."""
    from .resilience import dist_initialized
    had_world = dist_initialized()
    try:
        return _main(argv)
    finally:
        if not had_world and dist_initialized():
            from .parallel.launch import shutdown_distributed
            shutdown_distributed()


def _main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = CommandlineParser(argv)
    msg = _refusal(p)
    if msg is not None:
        print(f"{_PREFIX}: {msg}", file=sys.stderr)
        return 2
    case_name = p("case").asString() if p.has("case") else None
    if case_name is not None:
        from .cases import REGISTRY
        if case_name not in REGISTRY:
            names = ", ".join(c for c in REGISTRY)
            print(f"{_PREFIX}: unknown -case {case_name!r} "
                  f"(catalog: {names})", file=sys.stderr)
            return 2
    # a -case run takes its SimConfig from the catalog
    cfg = None if case_name is not None else SimConfig.from_argv(argv)
    fleet_n = p("fleet").asInt() if p.has("fleet") else 0
    serve_n = p("serve").asInt() if p.has("serve") else 0
    uniform = (fleet_n > 0 or p.has("level") or case_name is not None
               or cfg.level_max <= 1)
    outdir = p("output").asString() if p.has("output") else "."
    ckpt_every = p("checkpointEvery").asInt() if p.has("checkpointEvery") \
        else 0
    max_steps = p("maxSteps").asInt() if p.has("maxSteps") else 10**9
    rotate_mb = p("logRotateMB").asInt() if p.has("logRotateMB") else None

    from .uniform import resolve_device
    device = resolve_device(p("device").asString() if p.has("device")
                            else None)
    # -mesh: every visible card (all), the first N cards, or N shards on
    # the one device -device names; under a world (-coordinator ... or
    # torchrun's environment) one shard a rank (all) or N over the ranks
    mesh = None
    if p.has("mesh"):
        from .parallel.launch import (global_mesh, init_distributed,
                                      world_mesh)
        from .parallel.mesh import make_mesh
        try:
            init_distributed(
                coordinator_address=(p("coordinator").asString()
                                     if p.has("coordinator") else None),
                num_processes=(p("meshHosts").asInt()
                               if p.has("meshHosts") else None),
                process_id=(p("processId").asInt()
                            if p.has("processId") else None),
                expected_processes=(p("meshHosts").asInt()
                                    if p.has("meshHosts") else None),
                connect_attempts=(p("connectAttempts").asInt()
                                  if p.has("connectAttempts") else 5),
                connect_backoff=(p("connectBackoff").asDouble()
                                 if p.has("connectBackoff") else 1.0),
                device=device)
        except (RuntimeError, ValueError) as e:
            print(f"{_PREFIX}: {e}", file=sys.stderr)
            return 1
        from .resilience import dist_initialized
        spec = p("mesh").asString()
        if dist_initialized():
            if fleet_n:      # a torchrun world
                print(f"{_PREFIX}: {_FLEET_ACROSS}", file=sys.stderr)
                return 2
            if device.type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = (global_mesh(device) if spec == "all"
                    else world_mesh(int(spec), device))
        elif p.has("device"):
            mesh = make_mesh(devices=[device] * int(spec))
        else:
            mesh = make_mesh(None if spec == "all" else int(spec))
    if p.has("elastic"):
        from .resilience import dist_initialized
        if mesh is None or mesh.size < 2:
            print(f"{_PREFIX}: {_ELASTIC_NEEDS_MESH}", file=sys.stderr)
            return 2
        if not p.has("simHosts") and not dist_initialized():
            # one process without a simulated topology: its heartbeat
            # would watch a one-host world whose only loss is itself
            print(f"{_PREFIX}: -elastic on a single-process run needs "
                  "-simHosts H (H >= 2) to stand up a simulated "
                  "topology; real heartbeats need a multi-process "
                  "bring-up (-coordinator/-meshHosts)", file=sys.stderr)
            return 2
    from .resilience import is_writer
    os.makedirs(outdir, exist_ok=True)

    from . import faults
    from .profiling import HostCounters, MetricsRecorder, TraceWindow
    from .resilience import (EventLog, FleetStepGuard, PhysicsWatchdog,
                             PreemptionGuard, ResilienceAbort, StepGuard,
                             set_event_log)

    plan = faults.FaultPlan.from_env()   # CUP2D_FAULTS, latched once
    events_path = p("eventLog").asString() if p.has("eventLog") \
        else os.path.join(outdir, "events.jsonl")
    log = EventLog(events_path)
    set_event_log(log)                   # io's fallback event
    tracer = TraceWindow.from_env()      # CUP2D_TRACE, latched once

    if case_name is not None:
        from .cases import REGISTRY, make_sim
        kw = {"device": device}
        if p.has("level"):
            kw["level"] = p("level").asInt()
        if fleet_n:
            if not REGISTRY[case_name].fleet_ok:
                print(f"{_PREFIX}: -case {case_name} does not ride the "
                      "fleet slot pool (obstacle cases are solo-driver "
                      "only)", file=sys.stderr)
                return 2
            kw["members"] = fleet_n
        if mesh is not None:
            if case_name != "cavity":
                print(f"{_PREFIX}: -case {case_name} does not combine with "
                      "-mesh (the sharded path is obstacle-free only)",
                      file=sys.stderr)
                return 2
            del kw["device"]
            kw["mesh"] = mesh
        sim = make_sim(case_name, **kw)
        cfg = sim.cfg
        # -tend/-tdump override the case's schedule (the grid and
        # operators are built already)
        if p.has("tend"):
            cfg.end_time = p("tend").asDouble()
        if p.has("tdump"):
            cfg.dump_time = p("tdump").asDouble()
    elif fleet_n:
        if cfg.shapes:
            print(f"{_PREFIX}: -fleet supports obstacle-free uniform runs "
                  "only (shapes given)", file=sys.stderr)
            return 2
        from .fleet import FleetSim
        level = p("level").asInt() if p.has("level") else cfg.level_start
        sim = FleetSim(cfg, level=level, members=fleet_n, device=device)
        if not p.has("restart") and not serve_n:
            # a zero state would be a trivial run: the amplitude-laddered
            # Taylor-Green ensemble (a serving pool starts empty; its
            # sessions arrive through the queue)
            sim.seed_taylor_green()
    elif uniform:
        level = p("level").asInt() if p.has("level") else cfg.level_start
        if mesh is not None:
            if cfg.shapes:
                print(f"{_PREFIX}: -mesh on the uniform path is "
                      "obstacle-free only (ShardedUniformSim)",
                      file=sys.stderr)
                return 2
            from .parallel.mesh import ShardedUniformSim
            from .uniform import taylor_green_state
            sim = ShardedUniformSim(cfg, mesh, level=level)
            if not p.has("restart"):
                # an obstacle-free zero state would be a trivial run
                sim.set_state(taylor_green_state(sim.grid))
        else:
            from .sim import Simulation
            sim = Simulation(cfg, level=level, device=device)
    elif mesh is not None:
        from .parallel.forest_mesh import ShardedAMRSim
        sim = ShardedAMRSim(cfg, mesh)
    else:
        from .amr import AMRSim
        sim = AMRSim(cfg, device=device)
    if p.has("restart"):
        load_checkpoint(p("restart").asString(), sim)

    if not fleet_n and hasattr(type(sim), "force_log_header") \
            and is_writer():
        force_path = os.path.join(outdir, "forces.csv")
        resuming = p.has("restart") and os.path.exists(force_path)
        sim.force_log = open(force_path, "a" if resuming else "w")
        if not resuming:
            sim.force_log.write(type(sim).force_log_header() + "\n")

    if sim.shapes and not p.has("restart"):
        # t = 0 only: the chi blend would discard the rigid-motion part of
        # a restored body-interior velocity (load_checkpoint marks the sim
        # initialized)
        sim.initialize()   # so the t = 0 dump sees the blended velocity

    def dump(path):
        if fleet_n:
            # one triplet a member, at the member's own clock (sim.time is
            # the fleet's min)
            for m in range(sim.members):
                dump_uniform(f"{path}.m{m}", float(sim.times[m]),
                             sim.member_state(m).vel, sim.grid.h)
        elif uniform:
            dump_uniform(path, sim.time, sim.state.vel, sim.grid.h)
        else:
            sim.sync_fields()
            dump_forest(path, sim.time, sim.forest)

    ckpt_path = os.path.join(outdir, "checkpoint")
    topo = None
    if p.has("elastic"):
        from .resilience import TopologyGuard
        topo = TopologyGuard(
            mesh,
            sim_hosts=(p("simHosts").asInt()
                       if p.has("simHosts") else None),
            miss_k=(p("heartbeatMissK").asInt()
                    if p.has("heartbeatMissK") else 3),
            timeout=(p("heartbeatTimeout").asDouble()
                     if p.has("heartbeatTimeout") else 10.0),
            faults=plan, event_log=log)
    # the mirror tier: on where the elastic guard watches 2 or more hosts
    # (-mirror asks for it, still with a topology; -noMirror turns it off)
    mirror_hosts = None
    if topo is not None and not p.has("noMirror"):
        if topo.n_hosts >= 2 and (p.has("mirror") or p.has("elastic")):
            mirror_hosts = topo.n_hosts
    guard_cls = FleetStepGuard if fleet_n else StepGuard
    guard = guard_cls(
        sim,
        ring=p("guardRing").asInt() if p.has("guardRing") else 1,
        ckpt_dir=ckpt_path,
        postmortem_dir=os.path.join(outdir, "postmortem"),
        event_log=log,
        faults=plan,
        recover=not p.has("noSupervise"),
        watchdog=None if p.has("noWatchdog") else PhysicsWatchdog(),
        snap_every=p("snapEvery").asInt() if p.has("snapEvery") else 1,
        lag=not p.has("noLag"),
        mirror_hosts=mirror_hosts,
        mirror_every=(p("mirrorEvery").asInt()
                      if p.has("mirrorEvery") else 1))

    # -serve N: N staggered-horizon sessions through the B-slot pool (the
    # server wires the guard's eviction rung)
    server = None
    if serve_n:
        from .fleet import (FleetRequest, FleetServer, FlowState,
                            taylor_green_fleet)
        serving_lat = None
        if not p.has("noMetrics"):
            from .tracing import ServingLatency
            serving_lat = ServingLatency()
        server = FleetServer(
            sim, guard=guard,
            session_dir=os.path.join(outdir, "sessions"),
            event_log=log,
            clients_dir=os.path.join(outdir, "clients"),
            clients_rotate_mb=rotate_mb, latency=serving_lat)
        # the session ladder: Taylor-Green at decaying amplitudes, the
        # horizons staggered over [tend/2, tend] so that retirements
        # interleave with admissions
        ens = taylor_green_fleet(sim.grid, serve_n)
        for i in range(serve_n):
            t_end = cfg.end_time * (0.5 + 0.5 * (i + 1) / serve_n)
            server.submit(FleetRequest(
                client_id=f"s{i:04d}",
                state=FlowState(*(a[i] for a in ens)), t_end=t_end))

    metrics_log = None
    recorder = None
    counters = None
    if not p.has("noMetrics"):
        metrics_path = p("metricsLog").asString() if p.has("metricsLog") \
            else os.path.join(outdir, "metrics.jsonl")
        metrics_log = EventLog(metrics_path, rotate_mb=rotate_mb)
        counters = HostCounters().install()
        recorder = MetricsRecorder(sink=metrics_log, counters=counters,
                                   timers=sim.timers, guard=guard,
                                   server=server)
        recorder.prime(sim)

    def record(rec, wall_ms=None):
        if rec is not None and recorder is not None:
            recorder.record_step(step=rec["step"], t=rec["t"],
                                 dt=rec["dt"], diag=rec, sim=sim,
                                 wall_ms=wall_ms)

    def drain():
        # settle every verdict in flight before anything reads the state
        # or the clock (a checkpoint of an unverdicted step could persist
        # a bad state); a recovery may rewind the clock, so callers
        # re-check their condition after it
        for rec in guard.drain():
            record(rec)

    # SIGTERM = preemption notice: finish the step in flight, write the
    # restart point, exit 0. Installed around the loop only.
    stop = PreemptionGuard().install()
    faults.install(plan)   # io's crash window consults it, for the loop

    rc = 0
    try:
        if server is not None:
            # the serving loop: refill, step, retire a cycle. No dump
            # schedule: a session's artifacts are its checkpoint and its
            # client stream. The fleet guard's verdict is eager, so
            # admissions and retirements see settled state.
            while ((server.queue or server.active.any())
                   and sim.step_count < max_steps):
                if stop.agree():
                    n_parked = server.park_all()
                    log.emit(event="sigterm_park", step=sim.step_count,
                             parked=n_parked, queued=len(server.queue),
                             signum=stop.signum)
                    _say(f"SIGTERM at step {sim.step_count} — "
                         f"{n_parked} live session(s) parked under "
                         f"{os.path.join(outdir, 'sessions')}, "
                         f"{len(server.queue)} still queued, exiting "
                         "cleanly")
                    return 0
                if sim.step_count % 5 == 0:
                    _say(f"{sim.step_count:08d} serving "
                         f"{int(server.active.sum())}/{sim.members} "
                         f"slots, queue={len(server.queue)}, "
                         f"retired={server.retired}, "
                         f"evicted={server.evicted}")
                t_step = time.perf_counter()
                rec = server.step()
                if rec is None:
                    break
                record(rec, wall_ms=1e3 * (time.perf_counter() - t_step))
            _say(f"served {server.admitted} session(s): "
                 f"{server.retired} retired, {server.evicted} evicted, "
                 f"{len(server.queue)} unserved")
        next_dump = sim.time if cfg.dump_time > 0 else float("inf")
        while server is None:
            if not (sim.time < cfg.end_time
                    and sim.step_count < max_steps):
                # the end, or a lagged clock: settle the verdicts in
                # flight (a recovery may rewind), then look again. The
                # condition reads the settled clock, one step stale on the
                # lagged paths, so such a run may take one step more than
                # a -noLag run before it stops; each step's state is the
                # same.
                if guard.pending:
                    drain()
                    continue
                break
            # under -elastic the heartbeat rides the same step-boundary
            # all-gather as the SIGTERM agreement (one collective)
            if topo is not None:
                beat = topo.step_boundary(stop, sim.step_count)
                if beat.self_lost:
                    # a real host_exit: die as a lost host would, at once,
                    # writing nothing
                    os._exit(17)
                if beat.hung:
                    # every surviving rank says so: rank 0 may be the one
                    # that hangs
                    print(f"{_PREFIX}: heartbeat collective missed its "
                          f"{topo.timeout:.1f}s deadline at step "
                          f"{sim.step_count} — a peer died mid-step. The "
                          "old world's collectives are unusable; in-place "
                          "resume needs a runtime re-init "
                          "(parallel.launch.reinit_distributed, "
                          "orchestrator-driven). Aborting with the last "
                          "checkpoint intact.", file=sys.stderr)
                    _abort_world()
                    return 1
                if beat.lost:
                    if topo.sim_hosts is None:
                        print(f"{_PREFIX}: hosts {list(beat.lost)} left the "
                              "program — aborting (in-place resume across "
                              "ranks is the library's reinit_distributed "
                              "path)", file=sys.stderr)
                        _abort_world()
                        return 1
                    # a simulated topology: re-mesh the survivors and
                    # resume in place
                    guard.elastic_recover(topo)
                    continue
                stop_now = beat.stop
            else:
                stop_now = stop.agree()
            if stop_now:
                drain()
                save_checkpoint(ckpt_path, sim)
                log.emit(event="sigterm_checkpoint", step=sim.step_count,
                         sim_time=sim.time, path=ckpt_path,
                         signum=stop.signum)
                _say(f"SIGTERM at step {sim.step_count} — "
                     f"checkpoint written to {ckpt_path}, exiting "
                     "cleanly")
                return 0
            if sim.step_count % 5 == 0:
                _say(f"{sim.step_count:08d} t={sim.time:.6f}")
            if cfg.dump_time > 0 and sim.time >= next_dump:
                # catch the schedule up even when dt > tdump (the
                # reference falls permanently behind there,
                # main.cpp:6597-6602); the dump sees a verdicted state,
                # and a disk restore in the drain may make it not due
                drain()
                if sim.time >= next_dump:
                    while next_dump <= sim.time:
                        next_dump += cfg.dump_time
                    dump(os.path.join(outdir,
                                      f"vel.{sim.step_count:08d}"))
            if not uniform and (sim.step_count <= 10
                                or sim.step_count % cfg.adapt_steps == 0):
                drain()   # never regrid an unverdicted state
                sim.adapt()
            if tracer is not None:
                tracer.maybe_start(sim.step_count)
            t_step = time.perf_counter()
            rec = guard.step()
            if tracer is not None:
                tracer.maybe_stop(sim.step_count)
            record(rec, wall_ms=1e3 * (time.perf_counter() - t_step))
            if ckpt_every and sim.step_count % ckpt_every == 0:
                drain()
                save_checkpoint(ckpt_path, sim)
    except ResilienceAbort as e:
        # the guard wrote the post-mortem checkpoint, emitted the abort
        # event and closed the force log
        _say(f"unrecoverable step failure — {e}")
        rc = 1
    finally:
        stop.uninstall()
        faults.install(None)
        if server is not None:
            server.close()   # the per-client streams
        if tracer is not None:
            tracer.close()   # a window past tend must not leak a trace
        if sim.force_log is not None and not sim.force_log.closed:
            sim.force_log.close()
        if counters is not None:
            counters.uninstall()
        if metrics_log is not None:
            if server is not None and server.latency is not None:
                # the serving latency distributions, for post --metrics
                metrics_log.emit(event="serving_latency",
                                 **server.latency.report())
            metrics_log.close()
        set_event_log(None)
        log.close()
    if rc:
        return rc

    if not uniform:
        sim.sync_fields()   # leave the slot fields current
    _say(f"done at t={sim.time:.6f} "
         f"after {sim.step_count} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
