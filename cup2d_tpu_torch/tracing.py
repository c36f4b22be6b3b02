"""The serving pool's latency instruments, the counterpart of part of
``cup2d_tpu.tracing``.

- ``span``: the timeline span context the fleet server opens around its
  admit, retire and evict calls. With no flight recorder installed it
  returns one shared ``nullcontext``, which is all the port has.
- ``LatencyHistogram``: a fixed-bucket log2 histogram of durations.
- ``ServingLatency``: per-request queue-wait, admit-to-first-step and
  per-step latency, pool-wide and per client, on host clocks at
  ``fleet.FleetServer``'s submit, admit and step boundaries.

Not ported (ROADMAP queue 1 item 9): the flight recorder with its span
ring, ``spans.jsonl`` and ``spans_to_perfetto``, ``named_jit`` and the
compile and memory ledgers; so ``-spansLog`` and ``CUP2D_SPANS`` stay
refused.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from typing import Optional

_NULL = nullcontext()       # shared and reentrant: the recorder-off span


def span(name: str, **attrs):
    """A timeline span: free while no recorder is installed, which in the
    port is always (the recorder is item 9)."""
    return _NULL


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
