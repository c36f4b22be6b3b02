"""Multi-process launch on ``torch.distributed``: the counterpart of
``cup2d_tpu.parallel.launch`` (the reference's ``MPI_Init``,
main.cpp:6307, and its srun recipes).

One process per card (or several on the CPU) runs the same program; each
calls ``init_distributed`` and then builds its mesh with ``world_mesh``
(n shards over the ranks, n / world_size on each rank's device) or
``global_mesh`` (one shard per rank). The backend is NCCL where the
shards live on cards and gloo where they live on the CPU. The
coordinator, the world size and the rank come from the arguments (the
CLI's ``-coordinator HOST:PORT -meshHosts N -processId R``) or from
torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), which takes the place of the JAX package's pod
autodetection (``_in_tpu_pod``), e.g. on one host with four cards:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m cup2d_tpu_torch <flags> -mesh all

Every rank makes the same host decisions (``parallel.shard_halo``: the
reductions are all-gathered and combined in shard order, the regrid tags
are one all-gathered vector), so the ranks enter every collective in the
same order. A world that does not form fails the run with a message: the
connect is bounded (``timeout``) and retried a bounded number of times,
and a run never falls back to a single process.

After a host loss (``resilience.TopologyGuard``) the old world's
collectives are dead: ``reinit_distributed`` aborts it and forms the
survivors' world on a fresh port, with its own connect budget; a mesh
built over it (``world_mesh``) is one ``remesh`` accepts, and
``resilience.StepGuard.elastic_recover`` resumes on it.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..resilience import dist_initialized, record_event
from .shard_halo import SlabMesh

__all__ = ["global_mesh", "init_distributed", "rank", "reinit_distributed",
           "shutdown_distributed", "world_mesh", "world_size"]


def rank() -> int:
    return dist.get_rank() if dist_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist_initialized() else 1


def _torchrun_env() -> Optional[dict]:
    """torchrun's (or any launcher's) ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK``, or None where the
    process was not started by one."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    return {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"]),
            "address": (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                        f"{env.get('MASTER_PORT', '29500')}"),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}


def _connect_with_retry(connect: Callable[[], None], attempts: int = 5,
                        backoff: float = 1.0) -> None:
    """Bounded exponential-backoff retry around the connect: a coordinator
    that comes up seconds after its workers is a transient. Each failed
    attempt is logged to stderr and as a ``coordinator_retry`` event; the
    last failure propagates."""
    attempts = max(1, int(attempts))
    for attempt in range(1, attempts + 1):
        try:
            return connect()
        except Exception as e:   # the backends raise several types
            if attempt >= attempts:
                raise
            delay = backoff * (2.0 ** (attempt - 1))
            print(f"cup2d_tpu_torch: coordinator connect failed (attempt "
                  f"{attempt}/{attempts}): {e}; retrying in {delay:.1f}s",
                  file=sys.stderr)
            record_event(event="coordinator_retry", attempt=attempt,
                         max_attempts=attempts, delay_s=delay,
                         error=str(e))
            time.sleep(delay)


def _handshake(device: torch.device) -> None:
    """One all-gather of every rank's id on ``device``: proves the world
    formed (and brings NCCL's communicator up on the card)."""
    me = torch.tensor([dist.get_rank()], dtype=torch.int64, device=device)
    got = [torch.empty_like(me) for _ in range(dist.get_world_size())]
    dist.all_gather(got, me)
    ids = [int(g.item()) for g in got]
    if ids != list(range(dist.get_world_size())):
        raise RuntimeError(f"distributed handshake gathered ranks {ids}")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     expected_processes: Optional[int] = None,
                     connect_attempts: int = 5,
                     connect_backoff: float = 1.0,
                     device=None, timeout: float = 300.0) -> int:
    """Join (or form) the world of this run and return this process's
    rank. ``coordinator_address`` is rank 0's ``host:port``; with neither
    it nor ``num_processes`` given, torchrun's environment is read, and
    with no environment either there is nothing to join: rank 0 of no
    world, unless ``expected_processes`` > 1 says a world was meant
    (refused, never a silent single-process run).

    ``device`` names where this rank's shards live: a card (NCCL; a bare
    ``cuda`` takes ``LOCAL_RANK``, else the rank modulo the card count, and
    ``torch.cuda.set_device`` is called before NCCL comes up) or the CPU
    (gloo). Default: a card where one is visible. ``timeout`` (seconds)
    bounds the rendezvous and every collective after it; the connect is
    tried ``connect_attempts`` times, ``connect_backoff`` x 2^k seconds
    apart. A world of another size than ``expected_processes``, or one
    that does not form in time, raises with the expected count."""
    if dist_initialized():
        got = dist.get_world_size()
        if expected_processes and got != expected_processes:
            raise RuntimeError(
                f"distributed runtime has {got} processes, expected "
                f"{expected_processes} — partial bring-up")
        return dist.get_rank()
    env = _torchrun_env()
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and env is None:
        if expected_processes and expected_processes > 1:
            raise RuntimeError(
                f"expected {expected_processes} processes but no launcher "
                "environment was detected and no coordinator was given — "
                "refusing to run single-process silently")
        return 0
    env = env or {}
    address = coordinator_address or env.get("address")
    world = num_processes if num_processes is not None else env.get("world")
    me = process_id if process_id is not None else env.get("rank")
    if address is None or world is None or me is None:
        raise ValueError(
            "init_distributed: a world needs the coordinator address, the "
            "number of processes and this process's id (-coordinator, "
            "-meshHosts, -processId, or torchrun's environment)")
    _form_world(address, int(world), int(me), device,
                env.get("local_rank", me), timeout, connect_attempts,
                connect_backoff, expected_processes)
    return dist.get_rank()


def _form_world(address: str, world: int, me: int, device, local: int,
                timeout: float, connect_attempts: int,
                connect_backoff: float, expected_processes) -> None:
    """Form the world of ``world`` processes at ``address`` as rank ``me``
    on ``device`` (a card: NCCL, a bare ``cuda`` taking card ``local``
    modulo the card count; else gloo), with a bounded, retried connect and
    the handshake."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    wait = datetime.timedelta(seconds=timeout)

    def connect():
        try:
            dist.init_process_group(backend, init_method=f"tcp://{address}",
                                    world_size=int(world), rank=int(me),
                                    timeout=wait)
        except Exception as e:   # the store's timeout types vary by version
            raise RuntimeError(
                f"the world of {world} processes did not form at {address} "
                f"within {timeout:g} s ({type(e).__name__}: {e}); expected "
                f"{expected_processes or world} processes — partial "
                "bring-up, refusing to run single-process") from e

    _connect_with_retry(connect, attempts=connect_attempts,
                        backoff=connect_backoff)
    _handshake(device)
    got = dist.get_world_size()
    if expected_processes and got != expected_processes:
        raise RuntimeError(
            f"distributed runtime has {got} processes, expected "
            f"{expected_processes} — partial bring-up")


def shutdown_distributed(abort: bool = False) -> None:
    """Tear the world down (a no-op without one). ``abort``: a member is
    gone or a collective hangs, so the world is aborted
    (``ncclCommAbort`` under NCCL, which also ends a kernel that waits on
    the dead peer) instead of destroyed, which could wait on it."""
    if not dist_initialized():
        return
    if abort:
        from torch.distributed import distributed_c10d as c10d
        abort_fn = getattr(c10d, "_abort_process_group", None)
        if abort_fn is not None:
            abort_fn()
            if not dist_initialized():
                return
    dist.destroy_process_group()


def reinit_distributed(coordinator_address: str, num_processes: int,
                       process_id: int, connect_attempts: int = 10,
                       connect_backoff: float = 0.5, device=None,
                       timeout: float = 300.0) -> int:
    """Form the survivors' world after a topology loss
    (``cup2d_tpu/parallel/launch.py:173-218``): once a peer is gone every
    collective of the old world hangs, so the old world is aborted
    (``shutdown_distributed(abort=True)``; a failure there is logged and
    the new world's connect is the judge) and a new one of
    ``num_processes`` forms at ``coordinator_address``. The survivors
    renumber in old-rank order, so the new rank 0, the coordinator, is the
    lowest surviving rank; the address names it, on a fresh port (the old
    coordinator may be gone, or its port still in TIME_WAIT). The connect
    budget is this function's own (more attempts at a shorter backoff than
    ``init_distributed``'s: a re-init races only survivors already up).
    ``device`` defaults to this rank's current card, else the CPU, so the
    backend stays the old world's. Meshes built afterwards
    (``world_mesh``) are over the new world (``shard_halo.world_epoch``).
    Records a ``reinit_distributed`` event; returns the new rank."""
    from . import shard_halo
    if device is None:
        device = _rank_device(None)
    t0 = time.perf_counter()
    try:
        shutdown_distributed(abort=True)
    except Exception as e:
        print(f"cup2d_tpu_torch: distributed shutdown during re-init "
              f"failed: {e}", file=sys.stderr)
        record_event(event="reinit_shutdown_failed", error=str(e))
        if dist_initialized():
            dist.destroy_process_group()
    _form_world(coordinator_address, int(num_processes), int(process_id),
                device, int(process_id), timeout, connect_attempts,
                connect_backoff, int(num_processes))
    shard_halo.world_epoch += 1
    record_event(event="reinit_distributed", num_processes=num_processes,
                 process_id=process_id,
                 seconds=time.perf_counter() - t0)
    return dist.get_rank()


def _rank_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def world_mesh(n_shards: int, device=None) -> SlabMesh:
    """The mesh of ``n_shards`` shards over the world's ranks, n_shards /
    world_size on each rank's ``device`` (default its current card, else
    the CPU)."""
    if not dist_initialized():
        raise RuntimeError("world_mesh needs init_distributed first")
    return SlabMesh.over_world(n_shards, _rank_device(device))


def global_mesh(device=None) -> SlabMesh:
    """Under a world, one shard per rank on its device, in rank order
    (contiguous x or SFC ranges per process, as the JAX package's mesh over
    every chip of every host); without one, every visible card of this
    process (``make_mesh()``)."""
    if dist_initialized():
        return world_mesh(world_size(), device)
    from .mesh import make_mesh
    return make_mesh()
