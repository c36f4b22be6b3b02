"""The redesigned kernels against an earlier design of the same kernels,
on the card: bit for bit, and in time.

    python -m cup2d_tpu_torch.kernel_ab --other DIR [--out FILE]

``DIR`` is a ``csrc`` directory of an earlier tree (for instance the
``cup2d_tpu_torch/ops/csrc`` of ``git archive <commit>`` unpacked under
``build/``) that holds ``jacobi.cu``, ``block_jacobi.cu``,
``advect_heun.cu``, ``advect_heun_halo.cu``, ``lab_rhs.cu`` and
``advect_rhs.cu`` with their headers. Each earlier C entry point takes
today's arguments (it then runs behind today's wrapper) or, for the two
substage kernels, those of their per-cell design, without a launch plan
(``_LEGACY``): ``cup2d_advect_substage(v, vold, out, facs, L, ny, nx,
cfac, ih2, stream)`` and ``cup2d_advect_substage_halo(v, vold, aux, out,
facs, L, ny, nxl, cfac, ih2, is_lo, is_hi, stream)``. Both builds run on
the same operands:

1. bit for bit: every chain of the 8192^2 V-cycle hierarchy, the test
   shapes (ragged tiles, member stacks, rows that are not whole 16-byte
   words) and the block-Jacobi update at 1, 33 and 16384 blocks; both
   substages (vold absent and given) of the solo kernel on the 8192^2
   benchmark state, a member stack, ragged shapes and adversarial winds
   (``wind_field``), and of the halo kernel under the four wall
   combinations; the forest lab RHS and the single-op RHS on normal labs.
   The largest distance in ulp must be 0;
2. time, in turns (earlier, this, this, earlier) within the one process:
   device time from graph replays of each V-cycle chain per level, of the
   block-Jacobi update at 16384 blocks over 6 operand sets, and of each
   substage at the main paths' shapes (8192^2 solo, and 4 slabs of
   8192 x 2048 for the halo kernel).

Prints one JSON line per comparison and a summary line last; exits 1 if
any output differs. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .config import SimConfig
from .ops import hopper_kernels as hk
from .ops.timing import graph_ms, sweep_level_table, vcycle_chains
from .poisson import block_precond_matrix
from .uniform import UniformGrid, bench_state

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interfaces of the per-cell substage kernels, without launch
# plans; an earlier source with today's interface runs behind today's
# wrapper
_LEGACY = {"advect_heun": ("cup2d_advect_substage",
                           [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P]),
           "advect_heun_halo": ("cup2d_advect_substage_halo",
                                [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                 _I, _I, _P])}
_STEMS = ("jacobi", "block_jacobi", "advect_heun", "advect_heun_halo",
          "lab_rhs", "advect_rhs")

WIND_PATTERNS = ("normal", "random_sign", "zeros", "positive", "negative",
                 "checker")


def wind_field(shape, pattern: str, seed: int, device) -> torch.Tensor:
    """A seeded f32 velocity [..., 2, ny, nx] whose winds stress the face
    sharing: standard normal, |normal| with a random sign per cell, normal
    with 30% of the cells exactly 0, all positive, all negative, or a
    checkerboard of signs (every neighbour differs)."""
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal(shape))
    if pattern == "normal":
        a = rng.standard_normal(shape)
    elif pattern == "random_sign":
        a = mag * rng.choice([-1.0, 1.0], shape)
    elif pattern == "zeros":
        a = rng.standard_normal(shape) * (rng.random(shape) > 0.3)
    elif pattern == "positive":
        a = mag
    elif pattern == "negative":
        a = -mag
    elif pattern == "checker":
        j, i = np.indices(shape[-2:])
        a = mag * np.where((i + j) % 2, -1.0, 1.0)
    else:
        raise ValueError(f"wind_field: unknown pattern {pattern!r}")
    return torch.tensor(a, dtype=torch.float32, device=device)


def _arity(src: str, name: str) -> int:
    """The number of parameters of the C entry point ``name`` in a
    source."""
    decl = src[src.index(f"{name}(", src.index('extern "C"')):]
    return decl[:decl.index(")")].count(",") + 1


def build_other(csrc: Path) -> tuple[dict, set]:
    """Compile the earlier sources (one nvcc each, together) and return
    their loaded C entry points and the stems whose entry point takes
    today's arguments (the others take ``_LEGACY``'s)."""
    hk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in _STEMS:
        src = csrc / f"{stem}.cu"
        tag = hashlib.sha256(src.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
        ).hexdigest()[:16]
        so = hk.BUILD_DIR / f"other-{stem}-{tag}.so"
        cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), so)
    fns, current = {}, set()
    for stem, (p, so) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {stem}.cu:\n"
                               f"{out}")
        src = (csrc / f"{stem}.cu").read_text()
        name, argtypes = hk._ENTRIES[stem]
        if _arity(src, name) == len(argtypes):
            current.add(stem)
        elif stem in _LEGACY and _arity(src, name) == len(_LEGACY[stem][1]):
            name, argtypes = _LEGACY[stem]
        else:
            raise RuntimeError(f"the earlier {stem}.cu: {name} takes "
                               f"{_arity(src, name)} arguments, neither "
                               "today's nor the planless interface")
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[stem] = fn
    return fns, current


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def earlier(fns, current, stem, wrapper, legacy=None):
    """The earlier build of ``stem`` behind ``wrapper``'s interface: the
    wrapper itself routed to it where its C interface is today's, else
    ``legacy(fns)``, a wrapper of the ``_LEGACY`` interface."""
    if stem not in current:
        return legacy(fns)

    def call(*args, **kw):
        with earlier_entries(fns, (stem,)):
            return wrapper(*args, **kw)
    return call


def other_substage(fns):
    """The earlier solo substage behind ``advect_substage``'s interface."""
    def substage(v, vold, facs, cfac, ih2):
        L, _, ny, nx = v.shape
        out = torch.empty_like(v)
        rc = fns["advect_heun"](v.data_ptr(),
                                None if vold is None else vold.data_ptr(),
                                out.data_ptr(), facs.data_ptr(), L, ny, nx,
                                float(cfac), float(ih2), _stream())
        if rc:
            raise RuntimeError(f"earlier advect_heun launch failed: {rc}")
        return out
    return substage


def other_substage_halo(fns):
    """The earlier halo substage behind ``advect_substage_halo``'s
    interface."""
    def substage(v, vold, aux, facs, cfac, ih2, is_lo, is_hi):
        L, _, ny, nxl = v.shape
        out = torch.empty_like(v)
        rc = fns["advect_heun_halo"](
            v.data_ptr(), None if vold is None else vold.data_ptr(),
            aux.data_ptr(), out.data_ptr(), facs.data_ptr(), L, ny, nxl,
            float(cfac), float(ih2), int(bool(is_lo)), int(bool(is_hi)),
            _stream())
        if rc:
            raise RuntimeError(f"earlier advect_heun_halo launch failed: "
                               f"{rc}")
        return out
    return substage


@contextlib.contextmanager
def earlier_entries(fns, stems):
    """Route the wrappers of ``stems`` (unchanged C interfaces) to the
    earlier builds for the duration."""
    hk.build()
    saved = {s: hk._fns[s] for s in stems}
    hk._fns.update({s: fns[s] for s in stems})
    try:
        yield
    finally:
        hk._fns.update(saved)


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


def _facs(L, h, dev):
    dt = torch.tensor([0.5, 0.35, 0.27][:L], device=dev) * h
    return hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, dev)


def _bench_velocity(size: int, dev) -> tuple[torch.Tensor, float]:
    """The benchmark's f32 velocity [1, 2, size, size] and its h."""
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0,
                    extent=1.0, nu=4e-5, cfl=0.5, dtype="float32")
    g = UniformGrid(cfg, level=(size // 8).bit_length() - 1, device=dev)
    return bench_state(g).vel[None].contiguous(), g.h


def substage_bit_checks(sub_o, halo_o, dev, size: int = 8192) -> list[dict]:
    """Both substages of the solo kernel (vold absent, then given; the
    benchmark state at size^2) and of the halo kernel (under the four wall
    combinations) against the earlier builds; one row per operand set with
    the worst ulp."""
    rows = []

    def solo(v, label):
        L, _, ny, nx = v.shape
        h = 1.0 / nx
        facs = _facs(L, h, dev)
        vold = wind_field(v.shape, "normal", 99, dev)
        u = 0
        for vo, cfac in ((None, 0.5), (vold, 1.0)):
            u = max(u, ulps(hk.advect_substage(v, vo, facs, cfac, 1 / h**2),
                            sub_o(v, vo, facs, cfac, 1 / h**2)))
        rows.append({"kernel": "fused_advect_heun", "shape": list(v.shape),
                     "operands": label, "ulps": u})

    v, h = _bench_velocity(size, dev)
    facs = _facs(1, h, dev)
    ih2 = 1.0 / (h * h)
    v1 = hk.advect_substage(v, None, facs, 0.5, ih2)
    u = max(ulps(v1, sub_o(v, None, facs, 0.5, ih2)),
            ulps(hk.advect_substage(v1, v, facs, 1.0, ih2),
                 sub_o(v1, v, facs, 1.0, ih2)))
    rows.append({"kernel": "fused_advect_heun", "shape": list(v.shape),
                 "operands": "bench_state, both substages", "ulps": u})
    del v, v1
    torch.cuda.empty_cache()
    solo(wind_field((3, 2, 256, 512), "normal", 1, dev), "member stack")
    for k, shape in enumerate([(1, 2, 37, 150), (2, 2, 33, 70),
                               (1, 2, 1000, 1501), (1, 2, 130, 260)]):
        solo(wind_field(shape, "normal", 10 + k, dev), "ragged")
    for k, pat in enumerate(WIND_PATTERNS):
        solo(wind_field((2, 2, 130, 260), pat, 20 + k, dev), pat)
    for k, pat in enumerate(("normal", "random_sign", "checker")):
        v = wind_field((2, 2, 70, 264), pat, 30 + k, dev)
        aux = wind_field((2, 2, 70, 6), pat, 40 + k, dev)
        vold = wind_field(v.shape, "normal", 50 + k, dev)
        facs, h = _facs(2, 1 / 264, dev), 1 / 264
        for lo in (False, True):
            for hi in (False, True):
                u = 0
                for vo, cfac in ((None, 0.5), (vold, 1.0)):
                    args = (v, vo, aux, facs, cfac, 1 / h**2, lo, hi)
                    u = max(u, ulps(hk.advect_substage_halo(*args),
                                    halo_o(*args)))
                rows.append({"kernel": "advect_substage_halo",
                             "shape": list(v.shape), "operands": pat,
                             "is_lo": lo, "is_hi": hi, "ulps": u})
    return rows


def rhs_bit_checks(fns, dev) -> list[dict]:
    """The forest lab RHS and the single-op RHS, which share weno.cuh,
    against their earlier builds."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 16384
    lab = torch.randn(n, 2, 14, 14, generator=gen, device=dev)
    h = torch.tensor([1 / 64, 1 / 128, 1.0], device=dev)[
        torch.arange(n, device=dev) % 3]
    dt = torch.tensor(0.5 / 128, device=dev)
    vlab = torch.randn(2, 518, 1030, generator=gen, device=dev)
    this = (hk.fused_lab_rhs(lab, h, 4e-5, dt),
            hk.advect_diffuse_rhs(vlab, 1 / 1024, 4e-5, 0.5 / 1024))
    with earlier_entries(fns, ("lab_rhs", "advect_rhs")):
        then = (hk.fused_lab_rhs(lab, h, 4e-5, dt),
                hk.advect_diffuse_rhs(vlab, 1 / 1024, 4e-5, 0.5 / 1024))
    return [{"kernel": "fused_lab_rhs", "shape": list(lab.shape),
             "ulps": ulps(this[0], then[0])},
            {"kernel": "advect_diffuse_rhs", "shape": list(vlab.shape),
             "ulps": ulps(this[1], then[1])}]


def substage_times(sub_o, halo_o, dev, size: int = 8192,
                   slabs: int = 4) -> dict:
    """Device ms of each substage at the main paths' shapes, in turns
    (earlier, this, this, earlier): the solo kernel on [1, 2, size, size],
    the halo kernel on ``slabs`` slabs of it (one call = every slab)."""
    v, h = _bench_velocity(size, dev)
    facs = _facs(1, h, dev)
    ih2 = 1.0 / (h * h)
    v1 = hk.advect_substage(v, None, facs, 0.5, ih2)
    w = size // slabs
    zeros = v.new_zeros((1, 2, size, 3))

    def slabs_of(f):
        """Per slab: its columns and its aux (zeros on a walled side)."""
        return [(f[..., d * w:(d + 1) * w].contiguous(), torch.cat(
            [f[..., d * w - 3:d * w] if d > 0 else zeros,
             f[..., (d + 1) * w:(d + 1) * w + 3] if d < slabs - 1
             else zeros], -1).contiguous()) for d in range(slabs)]
    s0, s1 = slabs_of(v), slabs_of(v1)
    walls = [(d == 0, d == slabs - 1) for d in range(slabs)]

    def halo(fn, second):
        for d in range(slabs):
            if second:
                fn(s1[d][0], s0[d][0], s1[d][1], facs, 1.0, ih2, *walls[d])
            else:
                fn(s0[d][0], None, s0[d][1], facs, 0.5, ih2, *walls[d])

    calls = {
        "solo_first": lambda fn, _: fn(v, None, facs, 0.5, ih2),
        "solo_second": lambda fn, _: fn(v1, v, facs, 1.0, ih2),
        "halo_first": lambda _, fn: halo(fn, False),
        "halo_second": lambda _, fn: halo(fn, True)}
    out = {k: {"earlier": [], "this": []} for k in calls}
    for who in ("earlier", "this", "this", "earlier"):
        fns = ((sub_o, halo_o) if who == "earlier"
               else (hk.advect_substage, hk.advect_substage_halo))
        for k, call in calls.items():
            out[k][who].append(graph_ms([lambda c=call: c(*fns)], reps=4))
    return out


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
    fns, current = build_other(args.other)
    sweeps_o = earlier(fns, current, "jacobi", hk.fused_jacobi_sweeps)
    bj_o = earlier(fns, current, "block_jacobi",
                   hk.fused_block_jacobi_update)
    sub_o = earlier(fns, current, "advect_heun", hk.advect_substage,
                    other_substage)
    halo_o = earlier(fns, current, "advect_heun_halo",
                     hk.advect_substage_halo, other_substage_halo)
    lines = []

    def emit(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)

    bits = (substage_bit_checks(sub_o, halo_o, dev) + rhs_bit_checks(fns, dev)
            + bit_checks(sweeps_o, bj_o, dev))
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
    sub = substage_times(sub_o, halo_o, dev)
    for k, row in sub.items():
        emit({"substage": k, **row})
    emit({"summary": {
        "card": torch.cuda.get_device_name(0), "worst_ulps": worst,
        "substage_pair_ms": {
            mode: {who: [a + b for a, b in zip(
                sub[f"{mode}_first"][who], sub[f"{mode}_second"][who])]
                for who in ("earlier", "this")} for mode in ("solo", "halo")},
        "cycle_ms": {who: [sum(r["ms"] for r in t) for t in tables[who]]
                     for who in tables},
        "cycle_bound_ms": sum(r["bound_ms"] for r in tables["this"][0])}})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
