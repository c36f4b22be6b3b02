"""The sweep chain and the block-Jacobi update against an earlier design
of the same two kernels, on the card: bit for bit, and in time.

    python -m cup2d_tpu_torch.kernel_ab --other DIR [--out FILE]

``DIR`` is a ``csrc`` directory of an earlier tree that holds
``jacobi.cu`` and ``block_jacobi.cu`` with the one-launch C interfaces
that took no launch plan: ``cup2d_jacobi_sweeps(e, r, out, L, ny, nx,
nsw, omega, from_zero, stream)`` and ``cup2d_block_jacobi(p_inv, e, r,
lap, out, n, stream)`` (for instance the ``cup2d_tpu_torch/ops/csrc`` of
``git archive <commit>`` unpacked under ``build/``). Both builds run on
the same operands:

1. bit for bit: every chain of the 8192^2 V-cycle hierarchy, the test
   shapes (ragged tiles, member stacks, rows that are not whole 16-byte
   words) and the block-Jacobi update at 1, 33 and 16384 blocks; the
   largest distance in ulp must be 0;
2. time, in turns (earlier, this, this, earlier) within the one process:
   device time from graph replays of each V-cycle chain per level and of
   the block-Jacobi update at 16384 blocks over 6 operand sets.

Prints one JSON line per comparison and a summary line last; exits 1 if
any output differs. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from .ops import hopper_kernels as hk
from .ops.timing import graph_ms, sweep_level_table, vcycle_chains
from .poisson import block_precond_matrix

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_OTHER = {"jacobi": ("cup2d_jacobi_sweeps",
                     [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
          "block_jacobi": ("cup2d_block_jacobi",
                           [_P, _P, _P, _P, _P, _I, _P])}


def build_other(csrc: Path) -> dict:
    """Compile the earlier sources (one nvcc each, together) and return
    their loaded C entry points."""
    hk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in _OTHER:
        src = csrc / f"{stem}.cu"
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = hk.BUILD_DIR / f"other-{stem}-{tag}.so"
        cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for stem, (p, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {stem}.cu:\n"
                               f"{out}")
        name, argtypes = _OTHER[stem]
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[stem] = fn
    return fns


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def other_sweeps(fns):
    """The earlier design behind ``fused_jacobi_sweeps``' interface, with
    the same chain splitting."""
    def sweeps(e, r, omega, n, from_zero=False):
        ny, nx = r.shape[-2:]
        L = r.numel() // (ny * nx)
        cur = None if from_zero else e
        for k in hk.sweep_chain(n):
            out = torch.empty_like(r)
            rc = fns["jacobi"](None if cur is None else cur.data_ptr(),
                               r.data_ptr(), out.data_ptr(), L, ny, nx, k,
                               float(omega), int(cur is None), _stream())
            if rc:
                raise RuntimeError(f"earlier jacobi launch failed: {rc}")
            cur = out
        return cur
    return sweeps


def other_block_jacobi(fns):
    def update(e, r, lap, p_inv):
        out = torch.empty_like(e)
        rc = fns["block_jacobi"](p_inv.data_ptr(), e.data_ptr(),
                                 r.data_ptr(), lap.data_ptr(),
                                 out.data_ptr(), e.shape[0], _stream())
        if rc:
            raise RuntimeError(f"earlier block_jacobi launch failed: {rc}")
        return out
    return update


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def bit_checks(sweeps_o, bj_o, dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    shapes = [((1, s, s), n, fz) for s, chains in vcycle_chains(8192)
              for n, fz in chains]
    shapes += [((1, 72, 136), n, fz) for n in range(1, 7)
               for fz in (False, True)]
    shapes += [((3, 16, 16), 2, False), ((1, 37, 150), 2, False),
               ((2, 33, 70), 6, True), ((1, 1000, 1501), 5, False)]
    for shape, n, fz in shapes:
        e = torch.randn(shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev)
        u = ulps(hk.fused_jacobi_sweeps(e, r, 0.8, n, fz),
                 sweeps_o(e, r, 0.8, n, fz))
        rows.append({"kernel": "fused_jacobi_sweeps", "shape": list(shape),
                     "n": n, "from_zero": fz, "ulps": u})
        del e, r
    p = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                     device=dev)
    for nb in (1, 33, 16384):
        e, r, lap = (torch.randn(nb, 8, 8, generator=gen, device=dev)
                     for _ in range(3))
        u = ulps(hk.fused_block_jacobi_update(e, r, lap, p),
                 bj_o(e, r, lap, p))
        rows.append({"kernel": "fused_block_jacobi_update", "blocks": nb,
                     "ulps": u})
    return rows


def block_jacobi_times(bj_o, dev, n: int = 16384) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4)
    p = torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                     device=dev)
    sets = [tuple(torch.randn(n, 8, 8, generator=gen, device=dev)
                  for _ in range(3)) for _ in range(6)]
    out = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        fn = bj_o if who == "earlier" else hk.fused_block_jacobi_update
        out[who].append(graph_ms([lambda o=o: fn(*o, p) for o in sets]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the earlier design")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    hk.build()
    fns = build_other(args.other)
    sweeps_o, bj_o = other_sweeps(fns), other_block_jacobi(fns)
    lines = []

    def emit(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)

    bits = bit_checks(sweeps_o, bj_o, dev)
    for row in bits:
        emit({"bits": row})
    worst = max(row["ulps"] for row in bits)
    tables = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        fn = sweeps_o if who == "earlier" else hk.fused_jacobi_sweeps
        tables[who].append(sweep_level_table(fn, dev))
    for k, (size, _) in enumerate(vcycle_chains(8192)):
        emit({"level": size,
              "earlier_ms": [t[k]["ms"] for t in tables["earlier"]],
              "this_ms": [t[k]["ms"] for t in tables["this"]],
              "bound_ms": tables["this"][0][k]["bound_ms"],
              "launches": tables["this"][0][k]["launches"],
              "chains": {who: [[c["ms"] for c in t[k]["chains"]]
                               for t in tables[who]] for who in tables}})
    bj = block_jacobi_times(bj_o, dev)
    emit({"block_jacobi_16384_ms": bj})
    emit({"summary": {
        "card": torch.cuda.get_device_name(0), "worst_ulps": worst,
        "cycle_ms": {who: [sum(r["ms"] for r in t) for t in tables[who]]
                     for who in tables},
        "cycle_bound_ms": sum(r["bound_ms"] for r in tables["this"][0])}})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
