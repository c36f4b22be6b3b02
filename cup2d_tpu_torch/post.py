"""Offline tools, the counterpart of ``cup2d_tpu.post``: render a dump to
PNG, or summarize a run's metrics stream.

``render`` draws each cell's quad colored by |attr|^2 (the reference's
``post.py`` contract) through matplotlib, imported only when called; the
card's machine has no matplotlib, so nothing there calls it.
``--metrics`` prints one JSON line per stream, ``profiling``'s summary
plus the torn-line count and the source path, the keys of the JAX
package's summary; a serving run's per-client streams (``clients/`` beside
the metrics file) are summarized per client under ``clients``.
``--trace`` (the span timeline's Perfetto export) waits for the flight
recorder (ROADMAP queue 1 item 9) and exits 2.

Usage:  python -m cup2d_tpu_torch.post out/vel.00000012.xdmf2 [...]
        python -m cup2d_tpu_torch.post --metrics out/metrics.jsonl [...]
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


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: python -m cup2d_tpu_torch.post <dump>[.xdmf2] ... | "
              "--metrics <metrics.jsonl> ...", file=sys.stderr)
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
        print("cup2d_tpu_torch.post: --trace exports the flight recorder's "
              "span timeline, which is not ported yet (ROADMAP queue 1 "
              "item 9); the port writes no spans.jsonl", file=sys.stderr)
        return 2
    for a in args:
        print(render(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
