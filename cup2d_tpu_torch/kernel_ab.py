"""The redesigned kernels against an earlier design of the same kernels,
on the card: bit for bit, and in time.

    python -m cup2d_tpu_torch.kernel_ab --other DIR [--out FILE]
        [--only precond,tridiag,...]

``DIR`` is a ``csrc`` directory of an earlier tree (for instance the
``cup2d_tpu_torch/ops/csrc`` of ``git archive <commit>`` unpacked under
``build/``) that holds ``jacobi.cu``, ``block_jacobi.cu``,
``advect_heun.cu``, ``advect_heun_halo.cu``, ``lab_rhs.cu``,
``advect_rhs.cu``, ``correction.cu``, ``jacobi_halo.cu`` and
``tridiag.cu`` with their headers (``--only`` runs the comparisons it
names, ``SECTIONS``, and builds only their sources). Each earlier C entry
point takes
today's arguments (it then runs behind today's wrapper; kernel 8 on the
earlier launch plan, ``other_block_jacobi``) or, for the two
substage kernels and the single-op RHS, those of their per-cell design,
without a launch plan (``_LEGACY``): ``cup2d_advect_substage(v, vold,
out, facs, L, ny, nx, cfac, ih2, stream)``,
``cup2d_advect_substage_halo(v, vold, aux, out, facs, L, ny, nxl, cfac,
ih2, is_lo, is_hi, stream)`` and ``cup2d_advect_rhs(lab, out, facs, L,
ny, nx, stream)``. Both builds run on the same operands:

1. bit for bit: every chain of the 8192^2 V-cycle hierarchy, the test
   shapes (ragged tiles, member stacks, rows that are not whole 16-byte
   words); the block-Jacobi update at 1, 33 and 16384 blocks, and this
   tree's preconditioner forms of kernel 8 (P_inv r, e + P_inv r and
   e + P_inv (r - lap)) against the compositions they replace, built
   from the earlier kernel 8 with zero operands and torch sums, on
   normal operands and on a set whose products round to -0; the Thomas
   scans (``tridiag.cu``) on the card tests' ragged shapes and the
   periodic channel's [1, 8192, 4097]; both
   substages (vold absent and given) of the solo kernel on the 8192^2
   benchmark state, a member stack, ragged shapes and adversarial winds
   (``wind_field``), and of the halo kernel under the four wall
   combinations; the forest lab RHS at 1, 33, 10,529 and 16,384 blocks on
   normal labs and on every adversarial wind pattern; the single-op RHS
   on the 8192^2 benchmark lab, a normal lab, every wind pattern at an
   even and an odd pitch (8- and 4-byte copies), a member stack, ragged
   shapes at odd and even pitches and a lab off the 8-byte grid;
   the projection correction on 8192^2, a member stack and ragged shapes;
   the boundary-table and bf16 forms the earlier sources define, behind
   today's wrappers: the solo BC pair under four tables and the solo bf16
   pair (free-slip and cavity) on the 8192^2 benchmark state, a member
   stack and ragged shapes, the bf16 halo pair under the four wall
   combinations, the halo sweep (f32 and bf16) and the signed chain (f32
   and bf16); and this tree's slab-list halo sweep (one launch for every
   slab of the card) against the earlier per-slab sweep over an
   edge-column exchange, in its four forms (Neumann and signed, f32 and
   bf16), at every level of the 4-slab split hierarchy of 8192^2 and on
   ragged slabs, from e and from zero. The largest distance in ulp must
   be 0;
2. time, in turns (earlier, this, this, earlier) within the one process:
   device time from graph replays of each V-cycle chain per level, of
   kernel 8 at 16384 blocks over 6 operand sets (the update form and the
   three preconditioner forms against the compositions they replace,
   with one ``torch.mm``/``addmm`` of the same function as a yardstick,
   and each form of this tree against its persistent grid, 1 to 6 CTAs
   per SM), of the Thomas scans at [1, 8192, 4097], and of each
   substage at the main paths' shapes (8192^2 solo, and 4 slabs of
   8192 x 2048 for the halo kernel), of the correction on 8192^2, of the
   solo BC pair (cavity) and bf16 pair on 8192^2, of one halo sweep on
   4 slabs of 8192^2 (f32 and bf16, a launch per slab), of one halo sweep
   at every level of the split hierarchy in its four forms (the earlier
   per-slab sequence against the slab list), of the lab RHS at 10,529
   and 16,384 blocks, and of the single-op RHS on the 8192^2 benchmark
   lab (also one float off the 8-byte grid: 4-byte copies) and on a
   normal lab of its shape;
3. this tree's boundary-table forms beside its free-slip forms, in turns
   (free-slip, table, table, free-slip), at 8192^2: the substage pair
   under the cavity and the parabolic channel tables, the correction and
   the n = 2 sweep chain with the channel's signs (1, -1, 1, 1); and on
   4 slabs of one card the halo pair under the same tables and one halo
   sweep with the channel's signs; and the periodic tables' halo forms
   (no earlier design: their twins hold them in ``chip_smoke.py``), the
   wrap pair on the doubly-periodic box and the periodic channel over a
   ring exchange and the y-wrap sweep, beside the free-slip and Neumann
   forms.

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
from .ops.stencil import pad_vector
from .ops.timing import graph_ms, sweep_level_table, vcycle_chains
from .parallel.mesh import make_mesh
from .parallel.shard_halo import (fused_advect_heun_sharded, gather_x,
                                  level_meshes, overlap_jacobi_sweeps,
                                  split_x, sweep_exchanged, sweep_slabs)
from .poisson import block_precond_matrix
from .uniform import UniformGrid, bench_state

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interfaces of the per-cell substage and single-op RHS kernels,
# without launch plans; an earlier source with today's interface runs
# behind today's wrapper
_LEGACY = {"advect_heun": ("cup2d_advect_substage",
                           [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P]),
           "advect_heun_halo": ("cup2d_advect_substage_halo",
                                [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                 _I, _I, _P]),
           "advect_rhs": ("cup2d_advect_rhs", [_P, _P, _P, _I, _I, _I, _P])}
_STEMS = ("jacobi", "block_jacobi", "advect_heun", "advect_heun_halo",
          "lab_rhs", "advect_rhs", "correction", "jacobi_halo", "tridiag")
# the comparisons ``--only`` selects, and the earlier sources each builds
SECTIONS = {"substage": ("advect_heun", "advect_heun_halo"),
            "rhs": ("lab_rhs", "advect_rhs"),
            "sweeps": ("jacobi",),
            "correction": ("correction",),
            "forms": ("advect_heun", "advect_heun_halo", "jacobi",
                      "jacobi_halo", "correction"),
            "halo": ("jacobi_halo",),
            "precond": ("block_jacobi",),
            "tridiag": ("tridiag",)}

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


def build_other(csrc: Path, stems=_STEMS) -> tuple[dict, set]:
    """Compile the earlier sources of ``stems`` (one nvcc each, together)
    and return their loaded C entry points (and those of the
    boundary-table and bf16 forms they define, under their
    ``hopper_kernels._FORM_ENTRIES`` keys) and the stems whose entry point
    takes today's arguments (the others take ``_LEGACY``'s)."""
    hk.build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems:
        src = csrc / f"{stem}.cu"
        tag = hashlib.sha256(src.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
        ).hexdigest()[:16]
        so = hk.build_dir() / f"other-{stem}-{tag}.so"
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
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[stem] = fn
        if stem not in current:
            continue
        for key, (fstem, fname, fargs) in hk._FORM_ENTRIES.items():
            if fstem == stem and f"{fname}(" in src:
                f = getattr(lib, fname)
                f.argtypes, f.restype = fargs, ctypes.c_int
                fns[key] = f
    return fns, current


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def earlier(fns, current, stem, wrapper, legacy=None):
    """The earlier build of ``stem`` behind ``wrapper``'s interface: the
    wrapper itself routed to it where its C interface is today's, else
    ``legacy(fns)``, a wrapper of the ``_LEGACY`` interface; None where
    the earlier source was not built."""
    if stem not in fns:
        return None
    if stem not in current:
        return legacy(fns)

    def call(*args, **kw):
        with earlier_entries(fns, (stem,)):
            return wrapper(*args, **kw)
    return call


def routed(fns, current, wrapper):
    """``wrapper`` with every C entry of the earlier builds that takes
    today's arguments (its kernel's forms included) in place of this
    tree's, for the duration of each call."""
    keys = [k for k in fns
            if hk._FORM_ENTRIES.get(k, (k,))[0] in current]

    def call(*args, **kw):
        with earlier_entries(fns, keys):
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


# the launch plan of the earlier (CTA-tile) block-Jacobi design: two
# persistent CTAs per SM over 32-block tiles (it runs with its own plan,
# as its wrapper launched it)
EARLIER_BLOCK_JACOBI_CTAS_PER_SM = 2


def other_block_jacobi(fns):
    """The earlier kernel 8 (update form) behind
    ``fused_block_jacobi_update``'s interface, on its own launch plan."""
    def update(e, r, lap, p_inv):
        n = e.shape[0]
        out = torch.empty_like(e)
        sms = torch.cuda.get_device_properties(e.device).multi_processor_count
        grid = min(-(-n // 32), EARLIER_BLOCK_JACOBI_CTAS_PER_SM * sms)
        rc = fns["block_jacobi"](p_inv.data_ptr(), e.data_ptr(), r.data_ptr(),
                                 lap.data_ptr(), out.data_ptr(), n, grid,
                                 _stream())
        if rc:
            raise RuntimeError(f"earlier block_jacobi launch failed: {rc}")
        return out
    return update


def other_advect_rhs(fns):
    """The earlier single-op RHS behind ``advect_diffuse_rhs``'s
    interface."""
    def rhs(vlab, h, nu, dt):
        ny, nx = vlab.shape[-2] - 6, vlab.shape[-1] - 6
        out = vlab.new_empty(vlab.shape[:-2] + (ny, nx))
        facs = hk._rhs_facs(vlab.device, float(-dt * h), float(nu * dt))
        rc = fns["advect_rhs"](vlab.data_ptr(), out.data_ptr(),
                               facs.data_ptr(), vlab[..., 0, 0, 0].numel(),
                               ny, nx, _stream())
        if rc:
            raise RuntimeError(f"earlier advect_rhs launch failed: {rc}")
        return out
    return rhs


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


def bit_checks(sweeps_o, dev) -> list[dict]:
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
    return rows


def _pinv(dev) -> torch.Tensor:
    return torch.tensor(block_precond_matrix(8), dtype=torch.float32,
                        device=dev)


def signed_zero_blocks(n: int, p: torch.Tensor) -> tuple:
    """(e, r, lap) at n blocks whose P_inv r product is -0 in row b % 64
    of block b: r_k = -sign(P_ik) times the least subnormal where that
    product underflows (|P_ik| < 0.5), else -0 times sign(P_ik), so every
    term of the chain rounds to -0; e = -0 and lap = 0. Where a form adds
    the product to e without adding it to 0 first, -0 + -0 stays -0."""
    tiny = torch.tensor(1.4e-45, device=p.device)
    rows = p[torch.arange(n, device=p.device) % 64]          # [n, 64]
    r = torch.where(rows.abs() < 0.5, -torch.sign(rows) * tiny,
                    -torch.copysign(torch.zeros_like(rows), rows))
    return (torch.full((n, 8, 8), -0.0, device=p.device),
            r.reshape(n, 8, 8).contiguous(),
            torch.zeros(n, 8, 8, device=p.device))


def precond_bit_checks(bj_o, dev) -> list[dict]:
    """Kernel 8 at 1, 33 and 16384 blocks, on standard normal operands and
    on ``signed_zero_blocks``: the update form against its earlier build,
    and this tree's three preconditioner forms (``block_precond``) against
    the compositions they replace, built from the earlier build: kernel 8
    with e = lap = 0 on r (or on r - lap), then e + z in torch."""
    gen = torch.Generator(device=dev).manual_seed(3)
    p = _pinv(dev)

    def composed(r, e=None, lap=None):
        d = r if lap is None else r - lap
        zero = torch.zeros_like(d)
        z = bj_o(zero, d, zero, p)
        return z if e is None else e + z

    rows = []
    for nb in (1, 33, 16384):
        sets = {"normal": tuple(torch.randn(nb, 8, 8, generator=gen,
                                            device=dev) for _ in range(3)),
                "signed_zero": signed_zero_blocks(nb, p)}
        for kind, (e, r, lap) in sets.items():
            u = ulps(hk.fused_block_jacobi_update(e, r, lap, p),
                     bj_o(e, r, lap, p))
            rows.append({"kernel": "fused_block_jacobi_update",
                         "blocks": nb, "operands": kind, "ulps": u})
            for form, args in (("P_inv r", ()), ("e + P_inv r", (e,)),
                               ("e + P_inv (r - lap)", (e, lap))):
                u = ulps(hk.block_precond(r, p, *args), composed(r, *args))
                rows.append({"kernel": "block_precond", "form": form,
                             "blocks": nb, "operands": kind, "ulps": u})
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


def form_bit_checks(fns, current, dev, size: int = 8192) -> list[dict]:
    """The boundary-table and bf16 forms of the substage kernels and the
    halo sweep against the earlier builds (each kernel's earlier forms
    behind today's wrappers): the solo BC pair under the four tables of
    tests/test_torch_cavity.py on the 8192^2 benchmark velocity, a member
    stack and ragged shapes; the solo bf16 pair (free-slip and cavity) and
    the bf16 halo pair under the four wall combinations; the halo sweep,
    Neumann in f32 and bf16, under the four wall combinations (and on a
    slab of the 8192^2 split); the signed chain in f32 and bf16. One row
    per operand set with the worst ulp (of the f32 values: 0 where
    equal)."""
    from .cases import (cavity_table, channel_table,
                        periodic_channel_table, periodic_table)
    from .bc import BCTable, convective_outflow, dirichlet_inflow, no_slip
    tables = {"cavity": cavity_table(1.0),
              "channel_uniform": channel_table(1.0),
              "channel_parabolic": channel_table(1.0, "parabolic"),
              "outflow_y": BCTable(no_slip(), no_slip(),
                                   dirichlet_inflow(0.0, 1.0, "parabolic"),
                                   convective_outflow())}
    bf = torch.bfloat16
    sub_o = routed(fns, current, hk.advect_substage)
    halo_o = routed(fns, current, hk.advect_substage_halo)
    sweep_o = routed(fns, current, hk.jacobi_halo_sweep)
    chain_o = routed(fns, current, hk.fused_jacobi_sweeps)
    rows = []

    def fulps(a, b):
        return ulps(a.float(), b.float())

    def pair(v, table, storage, label):
        L, _, ny, nx = v.shape
        h = 1.0 / nx
        dt = torch.tensor([0.5, 0.35, 0.27][:L], device=dev) * h
        facs = hk._substage_facs(dt, h, 4e-5, (L,), L, torch.float32, dev,
                                 with_dt=table is not None)
        vs = v.to(storage)
        out2 = None if storage == torch.float32 else torch.float32
        v1 = hk.advect_substage(vs, None, facs, 0.5, 1 / h ** 2, table, h)
        u = max(fulps(v1, sub_o(vs, None, facs, 0.5, 1 / h ** 2, table, h)),
                fulps(hk.advect_substage(v1, vs, facs, 1.0, 1 / h ** 2,
                                         table, h, out2),
                      sub_o(v1, vs, facs, 1.0, 1 / h ** 2, table, h, out2)))
        rows.append({"kernel": "fused_advect_heun", "form": (
            ("" if table is None else "+bc")
            + ("+bf16" if storage == bf else "")), "table": (
            None if table is None else table.token), "shape": list(v.shape),
            "operands": label, "ulps": u})

    v, _ = _bench_velocity(size, dev)
    for name, table in tables.items():
        pair(v, table, torch.float32, "bench_state")
    for table in (None, tables["cavity"]):
        pair(v, table, bf, "bench_state")
    del v
    torch.cuda.empty_cache()
    for k, shape in enumerate([(3, 2, 256, 512), (1, 2, 37, 150),
                               (2, 2, 33, 70), (1, 2, 1000, 1501)]):
        v = wind_field(shape, "normal", 70 + k, dev)
        for name, table in tables.items():
            pair(v, table, torch.float32, "member stack" if k == 0
                 else "ragged")
        for table in (None, tables["cavity"]):
            pair(v, table, bf, "member stack" if k == 0 else "ragged")
    for k, pat in enumerate(("normal", "random_sign", "checker")):
        v = wind_field((2, 2, 70, 264), pat, 80 + k, dev).to(bf)
        aux = wind_field((2, 2, 70, 6), pat, 90 + k, dev).to(bf)
        facs, h = _facs(2, 1 / 264, dev), 1 / 264
        for lo in (False, True):
            for hi in (False, True):
                a1 = (v, None, aux, facs, 0.5, 1 / h ** 2, lo, hi)
                v1 = hk.advect_substage_halo(*a1)
                a2 = (v1, v, aux, facs, 1.0, 1 / h ** 2, lo, hi,
                      torch.float32)
                u = max(fulps(v1, halo_o(*a1)),
                        fulps(hk.advect_substage_halo(*a2), halo_o(*a2)))
                rows.append({"kernel": "advect_substage_halo",
                             "form": "+bf16", "shape": list(v.shape),
                             "operands": pat, "is_lo": lo, "is_hi": hi,
                             "ulps": u})
    gen = torch.Generator(device=dev).manual_seed(11)
    for storage in (torch.float32, bf):
        for shape in ((72, 136), (3, 40, 75), (size, size // 4)):
            e, r = (torch.randn(shape, generator=gen, device=dev).to(storage)
                    for _ in range(2))
            aux = torch.randn(shape[:-1] + (2,), generator=gen,
                              device=dev).to(storage)
            u = 0
            for lo in (False, True):
                for hi in (False, True):
                    for fz in (False, True):
                        a = (e, r, aux, 0.8, lo, hi, fz)
                        u = max(u, fulps(hk.jacobi_halo_sweep(*a),
                                         sweep_o(*a)))
            rows.append({"kernel": "jacobi_halo_sweep", "form": (
                "+bf16" if storage == bf else ""), "shape": list(shape),
                "ulps": u})
            del e, r, aux
        signs = (1.0, -1.0, 1.0, 1.0)
        for shape, n in (((1, 72, 136), 2), ((2, 33, 70), 6),
                         ((1, size, size), 2)):
            e, r = (torch.randn(shape, generator=gen, device=dev).to(storage)
                    for _ in range(2))
            u = max(fulps(hk.fused_jacobi_sweeps(e, r, 0.8, n, fz, signs),
                          chain_o(e, r, 0.8, n, fz, signs))
                    for fz in (False, True))
            rows.append({"kernel": "fused_jacobi_sweeps", "form": (
                "+bc+bf16" if storage == bf else "+bc"), "shape": list(shape),
                "n": n, "ulps": u})
            del e, r
    torch.cuda.empty_cache()
    return rows


def form_times(fns, current, dev, size: int = 8192,
               slabs: int = 4) -> dict:
    """Device ms, in turns (earlier, this, this, earlier), of the forms
    this tree's header changes run under: the solo BC pair (cavity) and
    the solo bf16 pair on [1, 2, size, size], and one halo sweep on
    ``slabs`` slabs of size^2 (one call = every slab), f32 and bf16."""
    from .cases import cavity_table
    v, h = _bench_velocity(size, dev)
    dt = torch.tensor([0.5], device=dev) * h
    gen = torch.Generator(device=dev).manual_seed(12)
    w = size // slabs
    fields = {}
    for storage in (torch.float32, torch.bfloat16):
        e, r = (torch.randn(size, w, generator=gen, device=dev).to(storage)
                for _ in range(2))
        aux = torch.zeros(size, 2, device=dev).to(storage)
        fields[storage] = (e, r, aux)
    walls = [(d == 0, d == slabs - 1) for d in range(slabs)]
    table = cavity_table()

    def arms(heun, sweep):
        def sweeps(storage):
            e, r, aux = fields[storage]
            for lo, hi in walls:
                sweep(e, r, aux, 0.8, lo, hi)
        return {
            "solo_bc_pair_cavity": lambda: heun(v, h, 4e-5, dt, bc=table),
            "solo_bf16_pair": lambda: heun(v, h, 4e-5, dt, bf16=True),
            "halo_sweep": lambda: sweeps(torch.float32),
            "halo_sweep_bf16": lambda: sweeps(torch.bfloat16)}
    this = arms(hk.fused_advect_heun, hk.jacobi_halo_sweep)
    then = arms(routed(fns, current, hk.fused_advect_heun),
                routed(fns, current, hk.jacobi_halo_sweep))
    out = {k: {"earlier": [], "this": []} for k in this}
    for who in ("earlier", "this", "this", "earlier"):
        for k in out:
            fn = then[k] if who == "earlier" else this[k]
            out[k][who].append(graph_ms([fn], reps=4))
    return out


LAB_BLOCKS = (1, 33, 10529, 16384)


def _lab_operands(n, pattern, seed, dev):
    """Labs [n, 2, 14, 14] of a wind pattern (``wind_field``), the forest's
    mixed per-block h (levels 6 and 7 of the canonical domain and the pad
    rows' 1) and dt."""
    lab = wind_field((n, 2, 14, 14), pattern, seed, dev)
    h = torch.tensor([1 / 64, 1 / 128, 1.0], device=dev)[
        torch.arange(n, device=dev) % 3]
    return lab, h, torch.tensor(0.5 / 128, device=dev)


def _bench_lab(dev, size: int = 8192) -> torch.Tensor:
    """The benchmark velocity's free-slip lab [2, size + 6, size + 6]."""
    return pad_vector(_bench_velocity(size, dev)[0], 3)[0].contiguous()


def rhs_bit_checks(fns, rhs_o, dev) -> list[dict]:
    """The forest lab RHS at 1, 33, 10,529 and 16,384 blocks on normal
    labs and on every adversarial wind pattern, and the single-op RHS
    (``rhs_o``: its earlier build behind today's interface) on the 8192^2
    benchmark lab, a normal lab, every wind pattern at an even pitch
    (8-byte copies) and an odd one (4-byte), a member stack, ragged
    shapes at odd and even pitches and a lab off the 8-byte grid, against
    their earlier builds."""
    rows = []
    for k, n in enumerate(LAB_BLOCKS):
        for j, pattern in enumerate(WIND_PATTERNS):
            lab, h, dt = _lab_operands(n, pattern, 100 + 10 * k + j, dev)
            this = hk.fused_lab_rhs(lab, h, 4e-5, dt)
            with earlier_entries(fns, ("lab_rhs",)):
                then = hk.fused_lab_rhs(lab, h, 4e-5, dt)
            rows.append({"kernel": "fused_lab_rhs", "shape": list(lab.shape),
                         "operands": pattern, "ulps": ulps(this, then)})

    def single(vlab, label):
        ny, nx = vlab.shape[-2] - 6, vlab.shape[-1] - 6
        h = 1.0 / nx
        vec = hk.advect_rhs_plan(vlab[..., 0, 0, 0].numel(), ny, nx, 1,
                                 vlab.data_ptr() % 8 == 0)[0]
        u = ulps(hk.advect_diffuse_rhs(vlab, h, 4e-5, 0.5 * h),
                 rhs_o(vlab, h, 4e-5, 0.5 * h))
        rows.append({"kernel": "advect_diffuse_rhs", "shape": list(
            vlab.shape), "operands": label, "copy_bytes": 4 * vec,
            "ulps": u})

    single(_bench_lab(dev), "bench_state lab")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(5)
    single(torch.randn(2, 518, 1030, generator=gen, device=dev), "normal")
    for k, pat in enumerate(WIND_PATTERNS):
        for shape in ((2, 2, 76, 270), (1, 2, 76, 271)):
            single(wind_field(shape, pat, 110 + k, dev), pat)
    single(wind_field((3, 2, 262, 518), "normal", 120, dev), "member stack")
    for k, shape in enumerate([(1, 2, 43, 157), (2, 2, 39, 77),
                               (1, 2, 1006, 1507), (1, 2, 43, 156),
                               (2, 2, 39, 76), (1, 2, 136, 266)]):
        single(wind_field(shape, "normal", 130 + k, dev), "ragged")
    buf = wind_field((2 * 43 * 156 + 1,), "normal", 140, dev)
    single(buf[1:].view(1, 2, 43, 156), "off the 8-byte grid")
    return rows


def advect_rhs_times(rhs_o, dev, size: int = 8192) -> dict:
    """Device ms of the single-op RHS on the benchmark's [2, size + 6,
    size + 6] lab (smooth winds: 0.4% of the faces' cells differ in sign),
    on the same lab one float off the 8-byte grid (this tree copies it 4
    bytes at a time) and on a normal lab of its shape (about half the
    faces' cells differ), in turns (earlier, this, this, earlier), graph
    replays."""
    gen = torch.Generator(device=dev).manual_seed(15)
    bench = _bench_lab(dev, size)
    off = torch.empty(bench.numel() + 1, device=dev)[1:].view(bench.shape)
    off.copy_(bench)
    labs = {"bench_state": bench, "bench_state, 4-byte copies": off,
            "normal": torch.randn(2, size + 6, size + 6, generator=gen,
                                  device=dev)}
    h = 1.0 / size
    out = {}
    for name, lab in labs.items():
        row = {"earlier": [], "this": []}
        for who in ("earlier", "this", "this", "earlier"):
            fn = rhs_o if who == "earlier" else hk.advect_diffuse_rhs
            row[who].append(graph_ms([lambda: fn(lab, h, 4e-5, 0.5 * h)],
                                     reps=8))
        out[name] = row
    del labs, bench, off
    torch.cuda.empty_cache()
    return out


def lab_rhs_times(fns, dev) -> dict:
    """Device ms of the lab RHS at the forest's 10,529 blocks and at
    16,384, in turns (earlier, this, this, earlier), graph replays over
    3 operand sets: normal labs (half the interior faces' two cells differ
    in wind sign) and all-positive ones (none do), keyed "<n> <pattern>"."""
    out = {}
    for n in LAB_BLOCKS[2:]:
        for pattern in ("normal", "positive"):
            sets = [_lab_operands(n, pattern, 200 + k, dev)
                    for k in range(3)]
            row = {"earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                ctx = (earlier_entries(fns, ("lab_rhs",))
                       if who == "earlier" else contextlib.nullcontext())
                with ctx:
                    row[who].append(graph_ms([
                        lambda o=o: hk.fused_lab_rhs(o[0], o[1], 4e-5,
                                                     o[2]) for o in sets]))
            out[f"{n} {pattern}"] = row
    return out


HALO_FORMS = {"": (torch.float32, None), "+bf16": (torch.bfloat16, None),
              "+bc": (torch.float32, (1.0, -1.0, 1.0, 1.0)),
              "+bc+bf16": (torch.bfloat16, (1.0, -1.0, 1.0, 1.0))}


def _halo_levels(dev, size: int, slabs: int):
    """(level size, mesh) of every level of the ``slabs``-way split V-cycle
    hierarchy of size^2 on one card (``shard_halo.level_meshes``)."""
    levels = [n for n, _ in vcycle_chains(size)]
    return list(zip(levels, level_meshes(
        [(n, n) for n in levels], make_mesh(devices=[dev] * slabs))))


def halo_slab_checks(fns, current, dev, size: int = 8192,
                     slabs: int = 4) -> list[dict]:
    """The slab-list halo sweep (one launch for every slab) against the
    earlier build's per-slab sweep over an edge-column exchange, in its
    four forms, at every level of the ``slabs``-way split hierarchy of
    size^2 and on ragged slabs (34 columns: no whole 16-byte rows; two
    members), from e and from zero; one row per form and operand set."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(n, (n, n), m) for n, m in _halo_levels(dev, size, slabs)]
    cases.append((136, (2, 40, 136), make_mesh(devices=[dev] * slabs)))
    for form, (dtype, signs) in HALO_FORMS.items():
        per_slab = routed(fns, current, sweep_exchanged)
        for n, shape, mesh in cases:
            e, r = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            es, rs = split_x(e, mesh), split_x(r, mesh)
            u = max(ulps(gather_x(sweep_slabs(es, rs, 0.8, fz,
                                              signs)).float(),
                         gather_x(per_slab(es, rs, 0.8, fz,
                                           signs)).float())
                    for fz in (False, True))
            rows.append({"kernel": "jacobi_halo_sweep", "form": form,
                         "slab_list": True, "shape": list(shape),
                         "slabs": mesh.size, "ulps": u})
            del e, r, es, rs
    torch.cuda.empty_cache()
    return rows


def halo_slab_times(fns, current, dev, size: int = 8192,
                    slabs: int = 4) -> list[dict]:
    """Device ms of one halo sweep at every level of the split hierarchy,
    in its four forms, in turns: the earlier build's per-slab sequence
    (an exchange, then a launch per slab) and this tree's slab list (one
    launch): earlier, this, this, earlier."""
    per_slab = routed(fns, current, sweep_exchanged)
    gen = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for form, (dtype, signs) in HALO_FORMS.items():
        for n, mesh in _halo_levels(dev, size, slabs):
            es, rs = (split_x(torch.randn(n, n, generator=gen,
                                          device=dev).to(dtype), mesh)
                      for _ in range(2))
            row = {"halo_sweep": form or "neumann", "level": n,
                   "slabs": mesh.size, "earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                fn = per_slab if who == "earlier" else sweep_slabs
                row[who].append(graph_ms([lambda: fn(es, rs, 0.8, False,
                                                     signs)], reps=8))
            rows.append(row)
            del es, rs
    torch.cuda.empty_cache()
    return rows


def correction_bit_checks(corr_o, dev) -> list[dict]:
    """The correction against its earlier build: 8192^2, a member stack
    and ragged shapes, means and pfac per member."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for shape in [(1, 8192, 8192), (3, 256, 512), (1, 37, 150),
                  (2, 33, 70)]:
        L = shape[0]
        x = torch.randn(shape, generator=gen, device=dev)
        p = torch.randn(shape, generator=gen, device=dev)
        v = torch.randn((L, 2) + shape[1:], generator=gen, device=dev)
        scal = torch.stack([x.mean((1, 2)), p.mean((1, 2)),
                            -0.25 * torch.rand(L, generator=gen,
                                               device=dev) / shape[-1] ** 2],
                           -1).contiguous()
        ih2 = float(shape[-1]) ** 2
        this = hk.fused_correction(x, p, v, scal, ih2)
        then = corr_o(x, p, v, scal, ih2)
        rows.append({"kernel": "fused_correction", "shape": list(shape),
                     "ulps": max(ulps(a, b) for a, b in zip(this, then))})
        del x, p, v, this, then
    torch.cuda.empty_cache()
    return rows


def correction_times(corr_o, dev, size: int = 8192) -> dict:
    """Device ms of the correction on [1, size, size], in turns."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, p = (torch.randn(1, size, size, generator=gen, device=dev)
            for _ in range(2))
    v = torch.randn(1, 2, size, size, generator=gen, device=dev)
    scal = torch.tensor([[0.01, -0.02, -0.25 / size ** 2]], device=dev)
    out = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        fn = corr_o if who == "earlier" else hk.fused_correction
        out[who].append(graph_ms([lambda: fn(x, p, v, scal,
                                             float(size) ** 2)], reps=4))
    return out


def bc_form_times(dev, size: int = 8192, slabs: int = 4) -> dict:
    """This tree's boundary-table forms beside its free-slip forms, device
    ms in turns (free-slip, table, table, free-slip) at size^2: the
    substage pair (cavity and parabolic channel tables), the correction
    and the n = 2 sweep chain (the channel's signs); and the x-split
    step's on ``slabs`` slabs of one card (one call = every slab and its
    exchange): the halo pair (the same tables, and the periodic box and
    channel: the wrap form over a ring exchange) and one halo sweep (the
    channel's signs, and the doubly-periodic ones: the y-wrap form)."""
    from .cases import (cavity_table, channel_table,
                        periodic_channel_table, periodic_table)
    signs = (1.0, -1.0, 1.0, 1.0)
    v, h = _bench_velocity(size, dev)
    dt = torch.tensor([0.5], device=dev) * h
    gen = torch.Generator(device=dev).manual_seed(8)
    x, p = (torch.randn(1, size, size, generator=gen, device=dev)
            for _ in range(2))
    scal = torch.tensor([[0.0, 0.0, -0.25 / size ** 2]], device=dev)
    e, r = x[0], p[0]
    ih2 = float(size) ** 2
    mesh = make_mesh(devices=[dev] * slabs)
    vs, es, rs = split_x(v, mesh), split_x(e, mesh), split_x(r, mesh)

    def halo_pair(bc):
        fused_advect_heun_sharded(vs, h, 4e-5, dt, bc=bc)

    def halo_sweeps(signs):
        overlap_jacobi_sweeps(es, rs, 0.8, 1, edge_signs=signs)

    arms = {
        "substage_pair_cavity": (
            lambda: hk.fused_advect_heun(v, h, 4e-5, dt),
            lambda: hk.fused_advect_heun(v, h, 4e-5, dt, bc=cavity_table())),
        "substage_pair_channel_parabolic": (
            lambda: hk.fused_advect_heun(v, h, 4e-5, dt),
            lambda: hk.fused_advect_heun(
                v, h, 4e-5, dt, bc=channel_table(1.0, "parabolic"))),
        "correction": (
            lambda: hk.fused_correction(x, p, v, scal, ih2),
            lambda: hk.fused_correction(x, p, v, scal, ih2,
                                        grad_signs=signs)),
        "sweep_chain_n2": (
            lambda: hk.fused_jacobi_sweeps(e, r, 0.8, 2),
            lambda: hk.fused_jacobi_sweeps(e, r, 0.8, 2, edge_signs=signs)),
        "halo_pair_cavity": (
            lambda: halo_pair(None), lambda: halo_pair(cavity_table())),
        "halo_pair_channel_parabolic": (
            lambda: halo_pair(None),
            lambda: halo_pair(channel_table(1.0, "parabolic"))),
        "halo_sweep": (lambda: halo_sweeps(None),
                       lambda: halo_sweeps(signs)),
        # the periodic tables' halo forms: the wrap pair over a ring
        # exchange, the sweep's y-wrap form (doubly periodic signs)
        "halo_pair_periodic": (
            lambda: halo_pair(None), lambda: halo_pair(periodic_table())),
        "halo_pair_periodic_channel": (
            lambda: halo_pair(None),
            lambda: halo_pair(periodic_channel_table())),
        "halo_sweep_periodic": (lambda: halo_sweeps(None),
                                lambda: halo_sweeps((0.0, 0.0, 0.0, 0.0))),
    }
    out = {k: {"free_slip": [], "table": []} for k in arms}
    for who in ("free_slip", "table", "table", "free_slip"):
        for k, (fs, tb) in arms.items():
            out[k][who].append(graph_ms([fs if who == "free_slip" else tb],
                                        reps=4))
    return out


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
    """Device ms of kernel 8 at n blocks over 6 operand sets (graph
    replays), in turns (earlier, this, library, library, this, earlier):
    the update form against its earlier build, and each preconditioner
    form of ``block_precond`` against the composition it replaces
    (earlier kernel 8 with zero operands; for e + P_inv r a torch add
    after it; for the tail a torch difference before and an add after);
    the library: one ``torch.mm``/``torch.addmm`` of the same function
    (TF32 off), timed beside them and used nowhere in the port."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4)
    p = _pinv(dev)
    pt = p.T
    sets = [tuple(torch.randn(n, 8, 8, generator=gen, device=dev)
                  for _ in range(3)) for _ in range(6)]
    zero = torch.zeros(n, 8, 8, device=dev)

    def flat(t):
        return t.reshape(n, 64)

    arms = {
        "update": (lambda e, r, lap: bj_o(e, r, lap, p),
                   lambda e, r, lap: hk.fused_block_jacobi_update(
                       e, r, lap, p),
                   lambda e, r, lap: torch.addmm(flat(e), flat(r)
                                                 - flat(lap), pt)),
        "P_inv r": (lambda e, r, lap: bj_o(zero, r, zero, p),
                    lambda e, r, lap: hk.block_precond(r, p),
                    lambda e, r, lap: torch.mm(flat(r), pt)),
        "e + P_inv r": (lambda e, r, lap: e + bj_o(zero, r, zero, p),
                        lambda e, r, lap: hk.block_precond(r, p, e),
                        lambda e, r, lap: torch.addmm(flat(e), flat(r),
                                                      pt)),
        "e + P_inv (r - lap)": (
            lambda e, r, lap: e + bj_o(zero, r - lap, zero, p),
            lambda e, r, lap: hk.block_precond(r, p, e, lap),
            lambda e, r, lap: torch.addmm(flat(e), flat(r) - flat(lap),
                                          pt))}
    out = {k: {"earlier": [], "this": [], "library": []} for k in arms}
    for who in ("earlier", "this", "library", "library", "this", "earlier"):
        k_who = ("earlier", "this", "library").index(who)
        for k, fns in arms.items():
            fn = fns[k_who]
            out[k][who].append(graph_ms([lambda o=o: fn(*o) for o in sets]))
    return out


def block_jacobi_grid_times(dev, n: int = 16384) -> list[dict]:
    """Device ms of each kernel-8 form of this tree at n blocks against
    the grid, 1 to 6 CTAs per SM (one CTA per ``BLOCK_JACOBI_TILE``
    blocks at most): the evidence for
    ``hopper_kernels.BLOCK_JACOBI_CTAS_PER_SM``."""
    gen = torch.Generator(device=dev).manual_seed(6)
    p = _pinv(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sets = [tuple(torch.randn(n, 8, 8, generator=gen, device=dev)
                  for _ in range(3)) for _ in range(6)]
    out = torch.empty(n, 8, 8, device=dev)
    hk.build()
    rows = []
    for operands, form in ((1, "P_inv r"), (2, "e + P_inv r"),
                           (3, "update")):
        for c in range(1, 7):
            grid = min(-(-n // hk.BLOCK_JACOBI_TILE), c * sms)

            def call(e, r, lap, grid=grid, operands=operands):
                key = "block_jacobi" if operands == 3 else "block_jacobi+pinv"
                hk._launch(key, dev, p.data_ptr(),
                           e.data_ptr() if operands > 1 else None,
                           r.data_ptr(),
                           lap.data_ptr() if operands > 2 else None,
                           out.data_ptr(), n, grid)
            rows.append({"block_jacobi_grid": form, "ctas_per_sm": c,
                         "grid": grid,
                         "plan": grid == hk.block_jacobi_grid(n, sms),
                         "ms": graph_ms([lambda o=o: call(*o)
                                         for o in sets])})
    return rows


def tridiag_operands(L: int, n_s: int, nk: int, seed: int, dev) -> tuple:
    """b [L, n_s, nk] complex64 standard normal and the coefficients of a
    diagonally dominant system (|cp| < 1), as tests/test_torch_cuda.py
    builds them."""
    rng = np.random.default_rng(seed)
    b = torch.tensor(rng.standard_normal((L, n_s, nk))
                     + 1j * rng.standard_normal((L, n_s, nk)),
                     dtype=torch.complex64, device=dev)
    d = -2.0 - 2.0 * rng.random((n_s, nk))
    cp, idn = np.empty((n_s, nk)), np.empty((n_s, nk))
    idn[0], cp[0] = 1.0 / d[0], 1.0 / d[0]
    for j in range(1, n_s):
        idn[j] = 1.0 / (d[j] - cp[j - 1])
        cp[j] = idn[j]
    cp[-1] = 0.0
    return (b, torch.tensor(idn, dtype=torch.float32, device=dev),
            torch.tensor(cp, dtype=torch.float32, device=dev))


# the card tests' shapes (ragged mode groups and row tiles) and the
# periodic channel's plan at 8192^2
TRIDIAG_SHAPES = ((1, 64, 33), (3, 37, 20), (2, 9, 1), (1, 1024, 513),
                  (1, 70, 33), (2, 129, 65), (1, 8192, 4097))


def tridiag_bit_checks(tri_o, dev) -> list[dict]:
    """``tridiag.cu`` against its earlier build on ``TRIDIAG_SHAPES``."""
    rows = []
    for k, shape in enumerate(TRIDIAG_SHAPES):
        b, idn, cp = tridiag_operands(*shape, 60 + k, dev)
        u = ulps(torch.view_as_real(hk.tridiag_scan(b, idn, cp)),
                 torch.view_as_real(tri_o(b, idn, cp)))
        rows.append({"kernel": "tridiag_scan", "shape": list(shape),
                     "ulps": u})
    return rows


def tridiag_times(tri_o, dev, shape=(1, 8192, 4097)) -> dict:
    """Device ms of one scan at the periodic channel's [1, 8192, 4097] in
    turns (earlier, this, this, earlier), graph replays over 2 operand
    sets (each 268 MB of b, beyond the L2)."""
    ops = [tridiag_operands(*shape, 70 + k, dev) for k in range(2)]
    out = {"earlier": [], "this": []}
    for who in ("earlier", "this", "this", "earlier"):
        fn = tri_o if who == "earlier" else hk.tridiag_scan
        out[who].append(graph_ms([lambda o=o: fn(*o) for o in ops],
                                 reps=4))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the earlier design")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated comparisons to run (default: "
                    "all): " + ", ".join(SECTIONS))
    args = ap.parse_args(argv)
    want = args.only.split(",")
    unknown = sorted(set(want) - set(SECTIONS))
    if unknown:
        ap.error(f"--only: unknown {unknown}; choose from {list(SECTIONS)}")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    hk.build()
    stems = [t for t in _STEMS if any(t in SECTIONS[w] for w in want)]
    fns, current = build_other(args.other, stems)
    sweeps_o = earlier(fns, current, "jacobi", hk.fused_jacobi_sweeps)
    bj_o = other_block_jacobi(fns) if "block_jacobi" in fns else None
    sub_o = earlier(fns, current, "advect_heun", hk.advect_substage,
                    other_substage)
    halo_o = earlier(fns, current, "advect_heun_halo",
                     hk.advect_substage_halo, other_substage_halo)
    corr_o = earlier(fns, current, "correction", hk.fused_correction)
    rhs_o = earlier(fns, current, "advect_rhs", hk.advect_diffuse_rhs,
                    other_advect_rhs)
    tri_o = earlier(fns, current, "tridiag", hk.tridiag_scan)
    lines = []

    def emit(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)

    checks = {"substage": lambda: substage_bit_checks(sub_o, halo_o, dev),
              "rhs": lambda: rhs_bit_checks(fns, rhs_o, dev),
              "sweeps": lambda: bit_checks(sweeps_o, dev),
              "precond": lambda: precond_bit_checks(bj_o, dev),
              "correction": lambda: correction_bit_checks(corr_o, dev),
              "forms": lambda: form_bit_checks(fns, current, dev),
              "halo": lambda: halo_slab_checks(fns, current, dev),
              "tridiag": lambda: tridiag_bit_checks(tri_o, dev)}
    bits = [row for k, run in checks.items() if k in want for row in run()]
    for row in bits:
        emit({"bits": row})
    worst = max(row["ulps"] for row in bits)
    summary = {"card": torch.cuda.get_device_name(0), "worst_ulps": worst,
               "operand_sets": len(bits)}
    if "sweeps" in want:
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
                                   for t in tables[who]]
                             for who in tables}})
        summary["cycle_ms"] = {who: [sum(r["ms"] for r in t)
                                     for t in tables[who]]
                               for who in tables}
        summary["cycle_bound_ms"] = sum(r["bound_ms"]
                                        for r in tables["this"][0])
    if "precond" in want:
        bj = block_jacobi_times(bj_o, dev)
        for form, row in bj.items():
            emit({"block_jacobi_16384_ms": form, **row})
        for row in block_jacobi_grid_times(dev):
            emit(row)
        summary["block_jacobi_16384_ms"] = bj
    if "substage" in want:
        sub = substage_times(sub_o, halo_o, dev)
        for k, row in sub.items():
            emit({"substage": k, **row})
        summary["substage_pair_ms"] = {
            mode: {who: [a + b for a, b in zip(
                sub[f"{mode}_first"][who], sub[f"{mode}_second"][who])]
                for who in ("earlier", "this")} for mode in ("solo", "halo")}
    if "correction" in want:
        corr = correction_times(corr_o, dev)
        emit({"correction_8192_ms": corr})
        summary["correction_ms"] = corr
    if "forms" in want:
        forms = bc_form_times(dev)
        for k, row in forms.items():
            emit({"bc_form": k, **row})
        earlier_forms = form_times(fns, current, dev)
        for k, row in earlier_forms.items():
            emit({"form": k, **row})
        summary.update(bc_form_ms=forms, form_ms=earlier_forms)
    if "halo" in want:
        halo = halo_slab_times(fns, current, dev)
        for row in halo:
            emit(row)
        summary["halo_sweep_finest_ms"] = {
            row["halo_sweep"]: {who: row[who] for who in ("earlier", "this")}
            for row in halo if row["level"] == 8192}
    if "rhs" in want:
        lab = lab_rhs_times(fns, dev)
        for n, row in lab.items():
            emit({"lab_rhs_blocks": n, **row})
        rhs = advect_rhs_times(rhs_o, dev)
        for k, row in rhs.items():
            emit({"advect_rhs_lab": k, **row})
        summary.update(lab_rhs_ms=lab, advect_rhs_ms=rhs)
    if "tridiag" in want:
        tri = tridiag_times(tri_o, dev)
        emit({"tridiag_8192_ms": tri})
        summary["tridiag_ms"] = tri
    emit({"summary": summary})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
