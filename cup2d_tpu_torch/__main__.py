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
``parallel.mesh.ShardedUniformSim`` (obstacle-free only), and ``-case
cavity`` its split form; dumps and checkpoints keep the global layout, so
a checkpoint restarts on any mesh or on none. ``all`` takes every visible
card, ``N`` the first N cards; with ``-device`` naming one device, ``-mesh
N`` puts N shards on it (four shards on one card, or on the CPU).

What the port cannot do yet is refused with rc 2 before any work, naming
its ROADMAP queue 1 item: ``-fleet`` with ``-mesh`` (the fleet's placement
on a mesh) and the multi-process, elastic and mirror flags (item 8);
``-profile``, ``-spansLog`` and span ring capacities in ``CUP2D_SPANS``
(item 9). The JAX CLI's usage errors exit 2 with its messages.
Flags that only turn off what the port lacks (``-noSpans``,
``-noMemLedger``, ``-noMirror``) are accepted.
"""

from __future__ import annotations

import os
import sys
import time

from .config import CommandlineParser, SimConfig
from .io import dump_forest, dump_uniform, load_checkpoint, save_checkpoint

_PREFIX = "cup2d_tpu_torch"

# flag -> (ROADMAP queue 1 item, what it asks for)
_REFUSED = {
    "coordinator": (8, "multi-process bring-up"),
    "meshHosts": (8, "multi-process bring-up"),
    "processId": (8, "multi-process bring-up"),
    "connectAttempts": (8, "multi-process bring-up"),
    "connectBackoff": (8, "multi-process bring-up"),
    "elastic": (8, "the elastic topology guard"),
    "simHosts": (8, "the elastic topology guard"),
    "heartbeatMissK": (8, "the elastic topology guard"),
    "heartbeatTimeout": (8, "the elastic topology guard"),
    "mirror": (8, "the host-redundant mirror tier"),
    "mirrorEvery": (8, "the host-redundant mirror tier"),
    "profile": (9, "per-phase timers"),
    "spansLog": (9, "the flight recorder's span timeline"),
}


def _not_ported(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP queue 1 item {item})"


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
        return ("-elastic needs -mesh with at least 2 devices; "
                + _not_ported("the elastic topology guard", 8))
    if p.has("fleet") and p.has("mesh"):
        return ("-fleet has its own placement policy (fleet.py) and does "
                "not combine with -mesh; "
                + _not_ported("the fleet's placement on a mesh", 8))
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


def main(argv=None) -> int:
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
    # the one device -device names
    mesh = None
    if p.has("mesh"):
        from .parallel.mesh import make_mesh
        spec = p("mesh").asString()
        if p.has("device"):
            mesh = make_mesh(devices=[device] * int(spec))
        else:
            mesh = make_mesh(None if spec == "all" else int(spec))
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

    if not fleet_n and hasattr(type(sim), "force_log_header"):
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
                             sim.state.vel[m], sim.grid.h)
        elif uniform:
            dump_uniform(path, sim.time, sim.state.vel, sim.grid.h)
        else:
            sim.sync_fields()
            dump_forest(path, sim.time, sim.forest)

    ckpt_path = os.path.join(outdir, "checkpoint")
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
        lag=not p.has("noLag"))

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
                    print(f"{_PREFIX}: SIGTERM at step {sim.step_count} — "
                          f"{n_parked} live session(s) parked under "
                          f"{os.path.join(outdir, 'sessions')}, "
                          f"{len(server.queue)} still queued, exiting "
                          "cleanly", file=sys.stderr)
                    return 0
                if sim.step_count % 5 == 0:
                    print(f"{_PREFIX}: {sim.step_count:08d} serving "
                          f"{int(server.active.sum())}/{sim.members} "
                          f"slots, queue={len(server.queue)}, "
                          f"retired={server.retired}, "
                          f"evicted={server.evicted}", file=sys.stderr)
                t_step = time.perf_counter()
                rec = server.step()
                if rec is None:
                    break
                record(rec, wall_ms=1e3 * (time.perf_counter() - t_step))
            print(f"{_PREFIX}: served {server.admitted} session(s): "
                  f"{server.retired} retired, {server.evicted} evicted, "
                  f"{len(server.queue)} unserved", file=sys.stderr)
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
            if stop.agree():
                drain()
                save_checkpoint(ckpt_path, sim)
                log.emit(event="sigterm_checkpoint", step=sim.step_count,
                         sim_time=sim.time, path=ckpt_path,
                         signum=stop.signum)
                print(f"{_PREFIX}: SIGTERM at step {sim.step_count} — "
                      f"checkpoint written to {ckpt_path}, exiting "
                      "cleanly", file=sys.stderr)
                return 0
            if sim.step_count % 5 == 0:
                print(f"{_PREFIX}: {sim.step_count:08d} t={sim.time:.6f}",
                      file=sys.stderr)
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
        print(f"{_PREFIX}: unrecoverable step failure — {e}",
              file=sys.stderr)
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
    print(f"{_PREFIX}: done at t={sim.time:.6f} "
          f"after {sim.step_count} steps", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
