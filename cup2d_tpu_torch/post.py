"""Offline tools, the counterpart of ``cup2d_tpu.post``: render a dump to
PNG, or summarize a run's metrics stream.

``render`` draws each cell's quad colored by |attr|^2 (the reference's
``post.py`` contract) through matplotlib, imported only when called; the
card's machine has no matplotlib, so nothing there calls it.
``--metrics`` prints one JSON line per stream, ``profiling``'s summary
plus the torn-line count and the source path, the keys of the JAX
package's summary; a serving run's per-client streams (``clients/`` beside
the metrics file) are summarized per client under ``clients``.
``--trace`` exports a flight recorder's span stream (``spans.jsonl``, with
the per-process siblings ``spans.jsonl.p<rank>`` and rotated segments
folded in) to a Chrome/Perfetto ``trace.json`` beside it, or to the
``.json`` path given after it (``tracing.spans_to_perfetto``).

Usage:  python -m cup2d_tpu_torch.post out/vel.00000012.xdmf2 [...]
        python -m cup2d_tpu_torch.post --metrics out/metrics.jsonl [...]
        python -m cup2d_tpu_torch.post --trace out/spans.jsonl [trace.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .io import read_dump


def render(path: str, png_path: str | None = None,
           cmap: str = "viridis", dpi: int = 400) -> str:
    """Render one dump (any of the .xdmf2/.xyz.raw/.attr.raw paths or the
    bare prefix) to PNG; returns the written path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection

    for suf in (".xdmf2", ".attr.raw", ".xyz.raw"):
        if path.endswith(suf):
            path = path[: -len(suf)]
    time, xyz, attr = read_dump(path)
    val = np.sum(attr.astype(np.float64) ** 2, axis=1)
    fig, ax = plt.subplots()
    pc = PolyCollection(xyz, array=val, cmap=cmap, edgecolors="none")
    ax.add_collection(pc)
    ax.set_xlim(float(xyz[..., 0].min()), float(xyz[..., 0].max()))
    ax.set_ylim(float(xyz[..., 1].min()), float(xyz[..., 1].max()))
    ax.set_aspect("equal")
    ax.set_title(f"t = {time:g}")
    fig.colorbar(pc, ax=ax, shrink=0.7)
    out = png_path or (path + ".png")
    fig.savefig(out, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return out


def metrics_summary(path: str) -> dict:
    """Aggregate one metrics.jsonl stream (``summarize_metrics`` + the
    torn-line count + the source path); a serving run's ``clients/``
    directory next to it (``profiling.ClientStreams``, one
    ``<client>.jsonl`` each) is summarized per client under
    ``clients``."""
    import os

    from .profiling import (load_metrics, load_metrics_report,
                            summarize_client, summarize_metrics)

    records, torn = load_metrics_report(path)
    out = summarize_metrics(records)
    out["truncated_records"] = torn
    out["source"] = path
    cdir = os.path.join(os.path.dirname(os.path.abspath(path)), "clients")
    if os.path.isdir(cdir):
        out["clients"] = {
            fn[:-len(".jsonl")]: summarize_client(
                load_metrics(os.path.join(cdir, fn)))
            for fn in sorted(os.listdir(cdir))
            if fn.endswith(".jsonl")}
    return out


def trace_export(path: str, out_path: str | None = None) -> str:
    """Export a span stream to Perfetto trace JSON
    (``cup2d_tpu/post.py:98-126``): ``path`` is rank 0's ``spans.jsonl``;
    the other ranks' ``<path>.p<r>`` and the rotated segments of each are
    folded in. Returns the written path (default ``trace.json`` beside
    ``path``)."""
    import glob
    import os
    import re

    from .profiling import load_metrics
    from .tracing import spans_to_perfetto

    # the live per-process siblings only: load_metrics folds in each
    # one's rotated segments (.pN.M, or .M on the base path)
    sibs = [q for q in sorted(glob.glob(path + ".p[0-9]*"))
            if re.fullmatch(r"\.p\d+", q[len(path):])]
    rows = []
    for q in [path] + sibs:
        try:
            rows.extend(load_metrics(q))
        except FileNotFoundError:
            continue
    trace = spans_to_perfetto(rows)
    out = out_path or os.path.join(
        os.path.dirname(os.path.abspath(path)) or ".", "trace.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m cup2d_tpu_torch.post <dump>[.xdmf2] ... | "
              "--metrics <metrics.jsonl> ... | "
              "--trace <spans.jsonl> ... [out.json]", file=sys.stderr)
        return 2
    if args[0] == "--metrics":
        if not args[1:]:
            print("usage: python -m cup2d_tpu_torch.post --metrics "
                  "<metrics.jsonl> ...", file=sys.stderr)
            return 2
        for a in args[1:]:
            print(json.dumps(metrics_summary(a)))
        return 0
    if args[0] == "--trace":
        ins = args[1:]
        out = None
        if len(ins) == 2 and ins[1].endswith(".json"):
            ins, out = ins[:1], ins[1]
        if not ins:
            print("usage: python -m cup2d_tpu_torch.post --trace "
                  "<spans.jsonl> ... [out.json]", file=sys.stderr)
            return 2
        for a in ins:
            print(trace_export(a, out))
        return 0
    for a in args:
        print(render(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
