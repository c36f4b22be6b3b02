"""The flight recorder and the serving pool's latency instruments, the
counterpart of ``cup2d_tpu.tracing``.

Four instruments, one rule: no new device read on the hot path. A run
with the recorder on is bit-identical to one with it off, with equal
``profiling.HostCounters.device_gets`` and equal kernel builds
(``jit_compiles``); tests/test_torch_tracing.py holds both on
``UniformSim`` and under ``FleetServer`` churn.

1. **Span timeline**: hierarchical wall-clock spans (``step`` nesting
   ``dispatch``/``verdict``/``snapshot``/``mirror``/``recover``/the ladder
   rungs, ``remesh``, ``admit``/``retire``/``evict``, ``regrid``) kept per
   process in a bounded ring, flushed through an ``EventLog``-like sink at
   shutdown or when the ring is full, exported to a Chrome/Perfetto
   ``trace.json`` by ``python -m cup2d_tpu_torch.post --trace``. A span is
   a host-clock interval between points the run passes through anyway:
   where a phase reads the device (the verdict's stacked read, a snapshot
   restore) it covers the device work; a ``dispatch`` span times the
   enqueue only.

2. **Build attribution**: the port has no jit, so the JAX package's
   ``named_jit`` has no counterpart. Its labels are spans around the
   drivers' step entry points instead (``label``: ``uniform.step``,
   ``sim.flow_step``, ``amr.step``, ``fleet.step``, ...; the reference's
   strings where it has the entry point), pushed on a stack for the call.
   Every ``nvcc`` build and library load of ``ops.hopper_kernels.build``
   fired inside such a call lands on the innermost open label
   (``note_build``); the ledger row carries count, ms, the trigger step
   (``note_step``), the latch token (``note_token``) and the Poisson
   components the call ran (``note_component``), as ``ledger_entry`` does
   in the reference. A build outside every label is ``<unattributed>``.

3. **Memory ledger**: on a card, a label's first call, and every call
   that fired a build, reads ``torch.cuda.max_memory_allocated`` at its
   exit (the allocator's counters on the host: no synchronization, no
   read of the device) and keeps the largest value per label
   (``peak_allocated_bytes``), as the reference captures an executable's
   memory when it compiles; later calls read nothing. ``capture_memory=
   False`` (``-noMemLedger``) turns it off; on the CPU it is absent
   (None).

4. **Serving latency histograms**: ``ServingLatency`` keeps per-request
   queue-wait, admit-to-first-step and per-step latency in fixed-bucket
   log2 ``LatencyHistogram``\\ s, per client and pool-wide, on host clocks
   at ``fleet.FleetServer``'s submit, admit and step boundaries.

Under a ``torch.distributed`` world the recorder's ``pid`` is the rank and
each rank writes its own span file (the CLI's ``spans.jsonl`` on rank 0,
``spans.jsonl.p<rank>`` past it), as the reference's per-process sinks do;
``spans_to_perfetto`` gives each its own track.

This module imports nothing of the package at module level (resilience,
fleet and profiling import it).
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional

# ---------------------------------------------------------------------------
# module state: the active recorder and the label stack
# ---------------------------------------------------------------------------

_RECORDER: Optional["FlightRecorder"] = None
_LABEL_STACK: list = []     # the innermost open build label last
_NULL = nullcontext()       # shared and reentrant: the recorder-off span


def recorder() -> Optional["FlightRecorder"]:
    """The installed flight recorder, or None (the library default)."""
    return _RECORDER


def span(name: str, **attrs):
    """A timeline span context: the shared ``nullcontext`` while no
    recorder with spans on is installed, else one ring entry at exit
    (host clocks only)."""
    r = _RECORDER
    if r is None or not r.spans_on:
        return _NULL
    return _SpanCtx(r, name, attrs)


def label(name: str):
    """A driver entry point's build label (the counterpart of a
    ``named_jit`` call): pushed for the call so that a kernel build fired
    inside it is charged to ``name``, recorded as a span of that name, and
    on a card the allocator's peak is read at exit. The shared
    ``nullcontext`` while no recorder is installed."""
    r = _RECORDER
    if r is None:
        return _NULL
    return _LabelCtx(r, name)


def note_step(n) -> None:
    """The current driver step, stamped onto builds as the trigger step
    (the guard's dispatch sets it)."""
    r = _RECORDER
    if r is not None:
        r._step = int(n)


def note_token(token) -> None:
    """The current latch token (the dispatch-time poisson-mode/kernel-tier
    label), stamped onto a label's row that has none."""
    r = _RECORDER
    if r is not None:
        r._token = token


def note_component(name: str) -> None:
    """Record a component (``poisson.bicgstab``, ...) on the innermost
    open label's row. The JAX package records it while tracing; the port
    has no trace, so every call records it (a set insert)."""
    r = _RECORDER
    if r is None or not r.compile_attr or not _LABEL_STACK:
        return
    ent = r.ledger.get(_LABEL_STACK[-1])
    if ent is not None:
        ent["components"].add(name)


def note_build(duration_s: float) -> None:
    """One kernel-library build (an ``nvcc`` run) or load (a C entry
    resolved) of ``ops.hopper_kernels.build``, charged to the innermost
    open label (``<unattributed>`` outside every label)."""
    r = _RECORDER
    if r is not None and r.compile_attr:
        r._on_build_event(_LABEL_STACK[-1] if _LABEL_STACK else None,
                          duration_s)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _SpanCtx:
    """One open span. Entry and exit are a few host clock reads and list
    operations; the record lands in the ring at exit (spans close in
    nesting order, as ``with`` scoping makes them)."""

    __slots__ = ("_r", "name", "attrs", "_wall", "_t0")

    def __init__(self, r: "FlightRecorder", name: str, attrs: dict):
        self._r = r
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._r._stack.append(self)
        self._wall = time.time()          # aligns the processes' tracks
        self._t0 = time.perf_counter()    # the duration
        return self

    def __exit__(self, etype, _exc, _tb):
        dur = time.perf_counter() - self._t0
        r = self._r
        r._stack.pop()
        attrs = self.attrs
        if etype is not None:
            # an aborting rung propagates through its spans: keep the
            # interval and mark it, so the timeline shows where it died
            attrs = {**attrs, "error": etype.__name__}
        r._record(self.name, self._wall, dur, len(r._stack), attrs)
        return False


class _LabelCtx:
    """An open build label: the label pushed on the stack for the call,
    its ledger row made, a span of its name when spans are on, and on a
    card the allocator's peak kept at the exit of the label's first call
    and of a call that fired a build."""

    __slots__ = ("_r", "name", "_span", "_ent", "_n0")

    def __init__(self, r: "FlightRecorder", name: str):
        self._r = r
        self.name = name
        self._span = _SpanCtx(r, name, {}) if r.spans_on else None
        self._ent = None

    def __enter__(self):
        r = self._r
        if r.compile_attr:
            self._ent = r._ledger_entry(self.name, None)
            self._n0 = self._ent["count"]
        _LABEL_STACK.append(self.name)
        if self._span is not None:
            self._span.__enter__()
        return self

    def __exit__(self, etype, exc, tb):
        if self._span is not None:
            self._span.__exit__(etype, exc, tb)
        _LABEL_STACK.pop()
        ent = self._ent
        if ent is not None and self._r.capture_memory \
                and (ent["mem"] is None or ent["count"] > self._n0):
            peak = _allocator_peak()
            if peak is not None:
                mem = ent["mem"] or {"peak_allocated_bytes": 0}
                mem["peak_allocated_bytes"] = max(
                    mem["peak_allocated_bytes"], peak)
                ent["mem"] = mem
        return False


def _allocator_peak() -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of the current card where this
    process has brought one up, else None (the CPU)."""
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return int(torch.cuda.max_memory_allocated())


def _mem_total(mem: Optional[dict]) -> int:
    if not mem:
        return 0
    return int(mem.get("peak_allocated_bytes", 0))


# ---------------------------------------------------------------------------
# serving latency histograms
# ---------------------------------------------------------------------------

class LatencyHistogram:
    """Fixed-bucket log2 histogram of durations. Bucket ``i`` counts
    samples in ``[2^i, 2^(i+1))`` microseconds (bucket 0 takes those under
    2 us); 40 buckets reach ~18 minutes. O(1) memory and update.
    Percentiles report the upper edge of the bucket holding the rank,
    clamped to the observed max: never under the true value, within one
    bucket (2x)."""

    NBUCKETS = 40

    __slots__ = ("counts", "n", "sum_us", "max_us")

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.n = 0
        self.sum_us = 0.0
        self.max_us = 0.0

    def add(self, seconds: float) -> None:
        us = max(seconds * 1e6, 0.0)
        i = min(max(int(us), 1).bit_length() - 1, self.NBUCKETS - 1)
        self.counts[i] += 1
        self.n += 1
        self.sum_us += us
        self.max_us = max(self.max_us, us)

    def percentile(self, q: float) -> Optional[float]:
        """The q-quantile in milliseconds, or None when empty."""
        if self.n == 0:
            return None
        target = max(int(math.ceil(q * self.n)), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                if i == self.NBUCKETS - 1:
                    # the overflow bucket has no upper edge: the max is
                    # the only honest bound
                    return round(self.max_us / 1e3, 3)
                return round(min(float(1 << (i + 1)), self.max_us) / 1e3, 3)
        return round(self.max_us / 1e3, 3)

    def report(self) -> dict:
        if self.n == 0:
            return {"count": 0}
        return {"count": self.n,
                "mean_ms": round(self.sum_us / self.n / 1e3, 3),
                "p50_ms": self.percentile(0.50),
                "p90_ms": self.percentile(0.90),
                "p99_ms": self.percentile(0.99),
                "max_ms": round(self.max_us / 1e3, 3)}


class ServingLatency:
    """Per-request latency of a ``FleetServer``, on host clocks at its
    submit, admit and step boundaries (no device work):

    - ``queue_wait``: submit to the admit that seats the request;
    - ``admit_to_first_step``: admit to the end of the first fused step
      that carried the client;
    - ``step``: the wall time of each fused step, charged to every client
      it carried.

    Per-client tracking stops at ``MAX_CLIENTS`` ids (the pool-wide
    histograms go on; the rest count as ``untracked_clients``)."""

    KINDS = ("queue_wait", "admit_to_first_step", "step")
    MAX_CLIENTS = 512

    def __init__(self):
        self.pool = {k: LatencyHistogram() for k in self.KINDS}
        self.clients: dict = {}
        self._submitted: dict = {}
        self._admitted: dict = {}
        self._dropped: set = set()

    def _client(self, cid) -> Optional[dict]:
        h = self.clients.get(cid)
        if h is None:
            if len(self.clients) >= self.MAX_CLIENTS:
                self._dropped.add(cid)
                return None
            h = {k: LatencyHistogram() for k in self.KINDS}
            self.clients[cid] = h
        return h

    def _observe(self, kind: str, cid, seconds: float) -> None:
        self.pool[kind].add(seconds)
        h = self._client(cid)
        if h is not None:
            h[kind].add(seconds)

    def on_submit(self, cid) -> None:
        self._submitted[cid] = time.perf_counter()

    def on_admit(self, cid) -> None:
        now = time.perf_counter()
        t0 = self._submitted.pop(cid, None)
        if t0 is not None:
            self._observe("queue_wait", cid, now - t0)
        self._admitted[cid] = now

    def on_step(self, cids, seconds: float) -> None:
        """One fused step of ``seconds`` carried ``cids`` (None: a free
        slot)."""
        now = time.perf_counter()
        for cid in cids:
            if cid is None:
                continue
            self._observe("step", cid, seconds)
            t0 = self._admitted.pop(cid, None)
            if t0 is not None:
                self._observe("admit_to_first_step", cid, now - t0)

    def report(self) -> dict:
        out = {"pool": {k: self.pool[k].report() for k in self.KINDS}}
        if self.clients:
            out["clients"] = {
                str(cid): {k: h[k].report() for k in self.KINDS}
                for cid, h in self.clients.items()}
        if self._dropped:
            out["untracked_clients"] = len(self._dropped)
        return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Per-process flight recorder: the span ring and the build and memory
    ledger. Install one (``install`` registers it module-wide); ``close``
    flushes and deregisters it. Its state is plain host data: it never
    reads the device."""

    def __init__(self, *, spans: bool = True, compile_attr: bool = True,
                 capture_memory: bool = True, max_spans: int = 65536,
                 sink=None):
        self.spans_on = bool(spans)
        self.compile_attr = bool(compile_attr)
        self.capture_memory = bool(capture_memory)
        self.max_spans = int(max_spans)
        self.sink = sink                  # EventLog-like (.emit(**row))
        self.pid = 0
        self._buf: deque = deque()
        self._stack: list = []
        self.span_count = 0               # cumulative, kept over flushes
        self.spans_dropped = 0
        self.ledger: dict = {}            # label -> row dict
        self.compile_ms_total = 0.0
        self._step = None                 # note_step
        self._token = None                # note_token

    @classmethod
    def from_env(cls, **kw) -> "FlightRecorder":
        """The one read of ``CUP2D_SPANS``, at construction: ``"0"`` turns
        the span ring off (the ledger stays on), an integer sets the
        ring's capacity (at least 16), unset or empty keeps the caller's
        settings."""
        raw = os.environ.get("CUP2D_SPANS", "").strip()
        on = kw.pop("spans", True)
        if raw == "0":
            on = False
        elif raw:
            try:
                kw["max_spans"] = max(int(raw), 16)
            except ValueError:
                pass
        return cls(spans=on, **kw)

    # -- lifecycle -----------------------------------------------------
    def install(self) -> "FlightRecorder":
        global _RECORDER
        _RECORDER = self
        from .resilience import dist_initialized
        if dist_initialized():
            import torch.distributed as dist
            self.pid = dist.get_rank()
        else:
            self.pid = 0
        return self

    def uninstall(self) -> None:
        global _RECORDER
        if _RECORDER is self:
            _RECORDER = None

    def close(self) -> None:
        self.flush()
        self.uninstall()

    # -- span ring -----------------------------------------------------
    def _record(self, name, wall, dur, depth, attrs) -> None:
        self.span_count += 1
        buf = self._buf
        if len(buf) >= self.max_spans:
            if self.sink is not None:
                self.flush()       # the cold path: a ring-full write
            else:
                buf.popleft()
                self.spans_dropped += 1
        buf.append((name, wall, dur, depth, attrs))

    def flush(self) -> None:
        """Drain the span ring into the sink, one JSONL row a span (the
        cold path: shutdown or a full ring)."""
        sink = self.sink
        if sink is None:
            return
        buf = self._buf
        while buf:
            name, wall, dur, depth, attrs = buf.popleft()
            row = {"event": "span", "name": name,
                   "ts_us": int(wall * 1e6),
                   "dur_us": max(int(dur * 1e6), 1),
                   "depth": depth, "pid": self.pid}
            for k, v in attrs.items():
                if k not in row:
                    row[k] = v
            sink.emit(**row)

    # -- build / memory ledger -----------------------------------------
    def _ledger_entry(self, name: str, token=None) -> dict:
        ent = self.ledger.get(name)
        if ent is None:
            ent = {"label": name, "count": 0, "ms": 0.0,
                   "first_step": None, "last_step": None,
                   "token": token, "components": set(), "mem": None}
            self.ledger[name] = ent
        elif token is not None and ent["token"] is None:
            ent["token"] = token
        return ent

    def _on_build_event(self, name: Optional[str],
                        duration_s: float) -> None:
        ent = self._ledger_entry(name or "<unattributed>")
        ent["count"] += 1
        ent["ms"] += duration_s * 1e3
        if ent["first_step"] is None:
            ent["first_step"] = self._step
        ent["last_step"] = self._step
        if ent["token"] is None:
            ent["token"] = self._token
        self.compile_ms_total += duration_s * 1e3

    def hbm_exec_bytes(self) -> int:
        """The largest allocator peak read at any label's exit (0 where
        none was read: the CPU, or ``capture_memory`` off)."""
        return max((_mem_total(e["mem"]) for e in self.ledger.values()),
                   default=0)

    def ledger_report(self) -> dict:
        """The build blame report: one row a label."""
        rows = []
        for name in sorted(self.ledger):
            e = self.ledger[name]
            rows.append({
                "label": name,
                "compiles": e["count"],
                "ms": round(e["ms"], 3),
                "first_step": e["first_step"],
                "last_step": e["last_step"],
                "token": e["token"],
                "components": sorted(e["components"]) or None,
                "memory": e["mem"],
            })
        return {
            "compiles": sum(r["compiles"] for r in rows),
            "compile_ms_total": round(self.compile_ms_total, 3),
            "hbm_exec_bytes": self.hbm_exec_bytes() or None,
            "executables": rows,
        }


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------

_CLIENT_PID_BASE = 1 << 20    # client tracks live above any process id


def spans_to_perfetto(rows) -> dict:
    """Chrome/Perfetto trace-event JSON of flushed span rows: one track a
    process (pid = the rank) and one a client session (spans with a
    ``client`` attribute, admit/retire/evict, are mirrored onto the
    client's track under a ``session`` envelope from its first to its
    last appearance). Load it at https://ui.perfetto.dev or
    chrome://tracing."""
    events = []
    pids = set()
    clients: dict = {}
    for r in rows:
        if r.get("event") != "span":
            continue
        pid = int(r.get("pid", 0))
        pids.add(pid)
        args = {k: v for k, v in r.items()
                if k not in ("event", "name", "ts_us", "dur_us",
                             "depth", "pid", "wall")}
        ev = {"name": str(r["name"]), "ph": "X", "ts": int(r["ts_us"]),
              "dur": int(r["dur_us"]), "pid": pid, "tid": 0,
              "args": args}
        events.append(ev)
        cid = r.get("client")
        if cid is not None:
            info = clients.setdefault(
                str(cid), {"first": ev["ts"], "last": ev["ts"],
                           "spans": []})
            info["first"] = min(info["first"], ev["ts"])
            info["last"] = max(info["last"], ev["ts"] + ev["dur"])
            info["spans"].append(ev)
    meta = []
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": f"process {pid}"}})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "guard"}})
    for i, cid in enumerate(sorted(clients,
                                   key=lambda c: clients[c]["first"])):
        cpid = _CLIENT_PID_BASE + i
        info = clients[cid]
        meta.append({"name": "process_name", "ph": "M", "pid": cpid,
                     "tid": 0, "args": {"name": f"client {cid}"}})
        events.append({"name": "session", "ph": "X",
                       "ts": info["first"],
                       "dur": max(info["last"] - info["first"], 1),
                       "pid": cpid, "tid": 0, "args": {"client": cid}})
        for ev in info["spans"]:
            events.append({**ev, "pid": cpid})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
