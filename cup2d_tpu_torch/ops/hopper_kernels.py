"""Hand-written Hopper kernels of the uniform and forest steps, their
plain PyTorch twins and their launch counters.

Eight CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a``) replace the
eight Pallas kernels of ``cup2d_tpu/ops/pallas_kernels.py``: the
obstacle-free uniform step runs the first three, the obstacle-free forest
step the next two, the x-split sharded uniform step
(``parallel.shard_halo``) the two halo kernels, and the single-op RHS
lies on no step (the JAX package keeps it as a parity and history
baseline):

=============================  ===============================  ===================
wrapper                        replaces                         source
=============================  ===============================  ===================
``fused_advect_heun``          ``_substage_kernel`` (both Heun  ``advect_heun.cu``
                               substages, free-slip, f32)
``fused_correction``           ``_correct_kernel`` (Neumann,    ``correction.cu``
                               f32)
``fused_jacobi_sweeps``        ``_jacobi_strips_kernel``        ``jacobi.cu``
                               (Neumann, f32)
``fused_lab_rhs``              ``_lab_kernel`` (forest labs,    ``lab_rhs.cu``
                               f32)
``fused_block_jacobi_update``  ``_block_jacobi_kernel`` (f32)   ``block_jacobi.cu``
``advect_substage_halo``       ``_sharded_substage_kernel``     ``advect_heun_halo.cu``
                               (one substage on an x slab,
                               free-slip, f32)
``jacobi_halo_sweep``          ``_jacobi_halo_kernel`` (one     ``jacobi_halo.cu``
                               sweep on an x slab, f32)
``advect_diffuse_rhs``         ``_adv_kernel`` (RHS over a      ``advect_rhs.cu``
                               pre-padded lab, f32)
=============================  ===============================  ===================

The four WENO kernels share their per-cell arithmetic through
``csrc/weno.cuh``; the two substage kernels share their tiles, loader and
face-sharing core through ``csrc/substage.cuh``.

Dispatch is by the device of the tensors alone: CPU tensors run the plain
twin (the same op sequence as the JAX package's XLA chain, which the CPU
tests hold against JAX); CUDA tensors launch the kernel or raise. There is
no fallback from one to the other.

The kernels are built at first use with ``nvcc`` into shared libraries with
a plain C interface (one ``nvcc`` per source, run in parallel) under
``build/torch_ext/`` at the repository root, and loaded with ``ctypes``.
Nothing here imports or builds anything CUDA at import time. ``nvcc`` runs
without ``--use_fast_math``: IEEE divides and denormals are kept, which
the WENO ``den > 1e-35`` guard relies on.

``launches`` counts kernel launches per wrapper (one per substage for the
advection kernels, one per chain of at most six sweeps for the smoother,
one per sweep and slab for the halo smoother, one per call for the
others); twin calls do not count. A launch runs on the current stream of
its tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import stencil
from .stencil import (_edge_ones, _zshift, advect_diffuse_core,
                      heun_substage, inv_diag_neumann, inv_diag_slab,
                      laplacian5_neumann, laplacian5_neumann_slab,
                      pad_vector, pad_vector_slab)

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source stem -> (C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    "advect_heun": ("cup2d_advect_substage",
                    [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P]),
    "correction": ("cup2d_fused_correction",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "jacobi": ("cup2d_jacobi_sweeps",
               [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "lab_rhs": ("cup2d_lab_rhs", [_P, _P, _P, _F, _P, _I, _P]),
    "block_jacobi": ("cup2d_block_jacobi",
                     [_P, _P, _P, _P, _P, _I, _I, _P]),
    "advect_heun_halo": ("cup2d_advect_substage_halo",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I,
                          _I, _I, _P]),
    "jacobi_halo": ("cup2d_jacobi_halo_sweep",
                    [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P]),
    "advect_rhs": ("cup2d_advect_rhs", [_P, _P, _P, _I, _I, _I, _P]),
}

launches = {"fused_advect_heun": 0, "fused_correction": 0,
            "fused_jacobi_sweeps": 0, "fused_lab_rhs": 0,
            "fused_block_jacobi_update": 0, "advect_substage_halo": 0,
            "jacobi_halo_sweep": 0, "advect_diffuse_rhs": 0}

# the TPU kernel each wrapper replaces, for reports
REPLACES = {
    "fused_advect_heun": "cup2d_tpu/ops/pallas_kernels.py:329",
    "fused_correction": "cup2d_tpu/ops/pallas_kernels.py:804",
    "fused_jacobi_sweeps": "cup2d_tpu/ops/pallas_kernels.py:979",
    "fused_lab_rhs": "cup2d_tpu/ops/pallas_kernels.py:756",
    "fused_block_jacobi_update": "cup2d_tpu/ops/pallas_kernels.py:1345",
    "advect_substage_halo": "cup2d_tpu/ops/pallas_kernels.py:576",
    "jacobi_halo_sweep": "cup2d_tpu/ops/pallas_kernels.py:1202",
    "advect_diffuse_rhs": "cup2d_tpu/ops/pallas_kernels.py:130",
}
SOURCES = {
    "fused_advect_heun": "cup2d_tpu_torch/ops/csrc/advect_heun.cu",
    "fused_correction": "cup2d_tpu_torch/ops/csrc/correction.cu",
    "fused_jacobi_sweeps": "cup2d_tpu_torch/ops/csrc/jacobi.cu",
    "fused_lab_rhs": "cup2d_tpu_torch/ops/csrc/lab_rhs.cu",
    "fused_block_jacobi_update": "cup2d_tpu_torch/ops/csrc/block_jacobi.cu",
    "advect_substage_halo": "cup2d_tpu_torch/ops/csrc/advect_heun_halo.cu",
    "jacobi_halo_sweep": "cup2d_tpu_torch/ops/csrc/jacobi_halo.cu",
    "advect_diffuse_rhs": "cup2d_tpu_torch/ops/csrc/advect_rhs.cu",
}

JACOBI_MAX_SWEEPS = 6
# jacobi.cu's two tiles, (rows out, shared columns), and the CTAs of each
# that fit on an SM (shared memory for the big one, registers for the
# small one)
JACOBI_TILES = {True: (64, 128), False: (16, 32)}
JACOBI_CTAS_PER_SM = {True: 1, False: 4}
JACOBI_BIG_ROUNDS = 4
# block_jacobi.cu's blocks per tile (fixed in the kernel) and CTAs per SM
BLOCK_JACOBI_TILE = 32
BLOCK_JACOBI_CTAS_PER_SM = 2
# the substage kernels' tile (rows, columns out; csrc/substage.cuh) and
# CTAs per SM (96 KB of shared memory and 128 registers a thread each)
SUBSTAGE_TILE = (32, 128)
SUBSTAGE_CTAS_PER_SM = 2

_fns: dict = {}          # source stem -> loaded C entry point


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME unset and nvcc not on "
                       "PATH): the Hopper kernels cannot be built")


def _lib_path(stem: str) -> Path:
    # every header counts: a .cu that includes one must rebuild with it
    src = (_CSRC / f"{stem}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{tag[:16]}.so"


def build() -> dict:
    """Compile every kernel source not yet built (one ``nvcc`` each, all
    started together), load them, and return ``{stem: log}`` with the
    compiler's resource report for the sources built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in _ENTRIES:
        if stem in _fns:
            continue
        so = _lib_path(stem)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    logs = {}
    failed = []
    for stem, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        logs[stem] = out
        if p.returncode != 0:
            failed.append(f"{stem}.cu (rc {p.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for stem, (name, argtypes) in _ENTRIES.items():
        if stem not in _fns:
            fn = getattr(ctypes.CDLL(str(_lib_path(stem))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[stem] = fn
    return logs


def _launch(stem: str, device: torch.device, *args) -> None:
    """Launch on ``device`` (made current for the call) and its current
    stream."""
    if stem not in _fns:
        build()
    with torch.cuda.device(device):
        rc = _fns[stem](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {stem} failed: error {rc}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned16(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts if t is not None)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _on_cuda(*ts) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (mixed
    devices, another device type) raises."""
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on devices {sorted(devs)}: expected all on "
                     "cpu (plain twin) or all on cuda (kernel)")


def _check_f32(name: str, **ts) -> None:
    for k, t in ts.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32 on the card, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


# ---------------------------------------------------------------------------
# K2: one Heun substage of WENO5 advection + diffusion (free-slip box)
# ---------------------------------------------------------------------------

def advect_substage_plain(v, vold, facs, cfac, ih2):
    """Plain twin of one substage: v, vold [L, 2, Ny, Nx] (vold None on
    the first substage, where it is v); facs [L, 2] per-member
    (afac, dfac). The JAX package's pad -> advect_diffuse_core ->
    heun_substage chain."""
    afac = facs[:, 0].reshape(-1, 1, 1, 1)
    dfac = facs[:, 1].reshape(-1, 1, 1, 1)
    rhs = advect_diffuse_core(pad_vector(v, 3), 3, afac, dfac)
    return heun_substage(v if vold is None else vold, cfac, rhs, ih2)


@functools.lru_cache(maxsize=4096)
def substage_plan(L: int, ny: int, nx: int, sms: int,
                  aligned: bool) -> tuple[int, int]:
    """Launch plan of the substage kernels (``advect_heun.cu``,
    ``advect_heun_halo.cu``) for L members of ny x nx (a slab's width for
    the halo kernel) on a card of ``sms`` SMs: (vec, grid). 16-byte copies
    where rows are whole 16-byte words and v is ``aligned``, else 4-byte
    ones; persistent CTAs, as many as the tiles up to the SMs' room."""
    ty, tx = SUBSTAGE_TILE
    tiles = L * _cdiv(ny, ty) * _cdiv(nx, tx)
    vec = 4 if nx % 4 == 0 and aligned else 1
    return vec, min(tiles, sms * SUBSTAGE_CTAS_PER_SM)


def advect_substage(v, vold, facs, cfac, ih2):
    """One substage: the kernel for CUDA tensors, the twin for CPU ones."""
    if not _on_cuda(v, vold, facs):
        return advect_substage_plain(v, vold, facs, cfac, ih2)
    L, two, ny, nx = v.shape
    if two != 2 or facs.shape != (L, 2):
        raise ValueError(f"advect_substage: v {tuple(v.shape)} / facs "
                         f"{tuple(facs.shape)}: expected [L,2,Ny,Nx]/[L,2]")
    if vold is not None and vold.shape != v.shape:
        raise ValueError("advect_substage: vold shape differs from v")
    _check_f32("advect_substage", v=v, vold=vold, facs=facs)
    out = torch.empty_like(v)
    vec, grid = substage_plan(L, ny, nx, _sm_count(v.device),
                              _aligned16(v))
    _launch("advect_heun", v.device, v.data_ptr(),
            None if vold is None else vold.data_ptr(), out.data_ptr(),
            facs.data_ptr(), L, ny, nx, float(cfac), float(ih2), vec, grid)
    launches["fused_advect_heun"] += 1
    return out


def _substage_facs(dt, h, nu, lead, L, dtype, device):
    dtv = torch.as_tensor(dt, dtype=dtype, device=device)
    dtv = dtv.broadcast_to(lead).reshape(L)
    return torch.stack([-dtv * h, nu * dtv], dim=-1)


def _advect_heun(vel, h, nu, dt, substage):
    lead = vel.shape[:-3]
    L = math.prod(lead)
    v = vel.reshape((L,) + vel.shape[-3:])
    facs = _substage_facs(dt, float(h), nu, lead, L, vel.dtype, vel.device)
    ih2 = 1.0 / (float(h) * float(h))
    v1 = substage(v, None, facs, 0.5, ih2)
    v2 = substage(v1, v, facs, 1.0, ih2)
    return v2.reshape(vel.shape)


def fused_advect_heun(vel, h, nu, dt):
    """Both Heun substages (main.cpp:6607-6642). vel [..., 2, Ny, Nx]; dt a
    scalar or shaped like the leading dims (per-member dt)."""
    return _advect_heun(vel, h, nu, dt, advect_substage)


def fused_advect_heun_plain(vel, h, nu, dt):
    """Plain twin of ``fused_advect_heun`` on any device."""
    return _advect_heun(vel, h, nu, dt, advect_substage_plain)


# ---------------------------------------------------------------------------
# K5: projection correction epilogue (Neumann box)
# ---------------------------------------------------------------------------

def fused_correction_plain(x, pres_old, vel, scal, ih2):
    """Plain twin: x, pres_old [L, Ny, Nx]; vel [L, 2, Ny, Nx]; scal
    [L, 3] = (mean x, mean pres_old, pfac). Returns (pres, vel)."""
    ny, nx = x.shape[-2:]
    s = scal.reshape(-1, 3, 1, 1)
    pres = ((x - s[:, 0]) + pres_old) - s[:, 1]
    gx = _edge_ones(nx, x.dtype, x.device, lo=-1.0, hi=1.0)
    gy = _edge_ones(ny, x.dtype, x.device, lo=-1.0, hi=1.0)
    dpx = (_zshift(pres, 0, 1) - _zshift(pres, 0, -1)) + pres * gx[None, :]
    dpy = (_zshift(pres, 1, 0) - _zshift(pres, -1, 0)) + pres * gy[:, None]
    dv = s[:, 2:3] * torch.stack([dpx, dpy], dim=-3)
    return pres, vel + dv * ih2


def fused_correction(x, pres_old, vel, scal, ih2):
    """Correction epilogue: the kernel for CUDA tensors, the twin for CPU
    ones. Same arguments and result as ``fused_correction_plain``."""
    if not _on_cuda(x, pres_old, vel, scal):
        return fused_correction_plain(x, pres_old, vel, scal, ih2)
    L, ny, nx = x.shape
    if (pres_old.shape != x.shape or vel.shape != (L, 2, ny, nx)
            or scal.shape != (L, 3)):
        raise ValueError(
            f"fused_correction: x {tuple(x.shape)}, pres_old "
            f"{tuple(pres_old.shape)}, vel {tuple(vel.shape)}, scal "
            f"{tuple(scal.shape)}: expected [L,Ny,Nx] x2, [L,2,Ny,Nx], [L,3]")
    _check_f32("fused_correction", x=x, pres_old=pres_old, vel=vel,
               scal=scal)
    pres = torch.empty_like(x)
    vout = torch.empty_like(vel)
    _launch("correction", x.device, x.data_ptr(), pres_old.data_ptr(),
            vel.data_ptr(), scal.data_ptr(), pres.data_ptr(),
            vout.data_ptr(), L, ny, nx, float(ih2))
    launches["fused_correction"] += 1
    return pres, vout


# ---------------------------------------------------------------------------
# K6: chains of damped-Jacobi sweeps (Neumann walls)
# ---------------------------------------------------------------------------

def jacobi_sweeps_plain(e, r, omega, n, from_zero=False):
    """Plain twin: n sweeps e + omega*(r - lap(e))*inv_d of the zero-ghost
    Neumann Laplacian on [..., Ny, Nx]; ``from_zero`` makes the first
    sweep omega*r*inv_d and ignores ``e``."""
    ny, nx = r.shape[-2:]
    inv_d = inv_diag_neumann(ny, nx, r.dtype, r.device)
    if from_zero and n > 0:
        e = omega * r * inv_d
        n -= 1
    for _ in range(n):
        e = e + omega * (r - laplacian5_neumann(e)) * inv_d
    return e


def sweep_chain(n: int) -> list[int]:
    """The sweeps of each launch of an n-sweep chain: launches of
    ``JACOBI_MAX_SWEEPS`` and one of the rest, in that order."""
    full, rest = divmod(int(n), JACOBI_MAX_SWEEPS)
    return [JACOBI_MAX_SWEEPS] * full + ([rest] if rest else [])


@functools.lru_cache(maxsize=4096)
def jacobi_plan(L: int, ny: int, nx: int, n: int, sms: int,
                aligned: bool) -> tuple[bool, int, int]:
    """Launch plan of ``jacobi.cu`` for an n-sweep launch on L members of
    ny x nx on a card of ``sms`` SMs: (big, vec, grid). The 128-column
    tile where the level has at least ``JACOBI_BIG_ROUNDS`` per SM (fewer
    leave the last round's SMs idle for a whole tile), else the 32-column
    one (each puts out its width less twice the x halo, n rounded up to 4);
    16-byte copies where rows are whole 16-byte words and the pointers
    ``aligned``, else 4-byte ones; persistent CTAs, as many as the tiles
    up to the SMs' room."""
    hx = 4 * _cdiv(n, 4)

    def tiles(big):
        ty, w = JACOBI_TILES[big]
        return L * _cdiv(ny, ty) * _cdiv(nx, w - 2 * hx)
    big = tiles(True) >= JACOBI_BIG_ROUNDS * sms
    vec = 4 if nx % 4 == 0 and aligned else 1
    return big, vec, min(tiles(big), sms * JACOBI_CTAS_PER_SM[big])


def block_jacobi_grid(n: int, sms: int) -> int:
    """Persistent CTAs of ``block_jacobi.cu`` for n blocks: two per SM, or
    one per tile of ``BLOCK_JACOBI_TILE`` blocks where there are fewer."""
    return min(_cdiv(n, BLOCK_JACOBI_TILE), BLOCK_JACOBI_CTAS_PER_SM * sms)


def fused_jacobi_sweeps(e, r, omega, n, from_zero=False):
    """n sweeps: on CUDA tensors as launches of at most six sweeps each
    (``sweep_chain``; the first carries ``from_zero``), on CPU tensors the
    twin."""
    if not _on_cuda(None if from_zero else e, r):
        return jacobi_sweeps_plain(e, r, omega, n, from_zero)
    ny, nx = r.shape[-2:]
    L = math.prod(r.shape[:-2])
    if not from_zero and e.shape != r.shape:
        raise ValueError(f"fused_jacobi_sweeps: e {tuple(e.shape)} vs r "
                         f"{tuple(r.shape)}")
    _check_f32("fused_jacobi_sweeps", r=r, e=None if from_zero else e)
    cur = None if from_zero else e
    sms = _sm_count(r.device)
    for k in sweep_chain(n):
        out = torch.empty_like(r)
        big, vec, grid = jacobi_plan(L, ny, nx, k, sms, _aligned16(cur, r))
        _launch("jacobi", r.device,
                None if cur is None else cur.data_ptr(), r.data_ptr(),
                out.data_ptr(), L, ny, nx, k, float(omega), int(cur is None),
                int(big), vec, grid)
        launches["fused_jacobi_sweeps"] += 1
        cur = out
    return cur


# ---------------------------------------------------------------------------
# K4: WENO5 advection + diffusion RHS over forest labs
# ---------------------------------------------------------------------------

def fused_lab_rhs_plain(lab, h, nu, dt):
    """Plain twin: ``advect_diffuse_rhs(lab, 3, h, nu, dt)`` on labs
    [N, 2, 14, 14] with ``h`` shaped [N, 1, 1, 1] (or a scalar)."""
    return stencil.advect_diffuse_rhs(lab, 3, h, nu, dt)


def fused_lab_rhs(lab, h, nu, dt):
    """WENO5 advect-diffuse RHS over pre-assembled forest labs
    [N, 2, BS+6, BS+6] -> [N, 2, BS, BS] with per-block h ([N, 1, 1, 1]
    or [N]) and a scalar dt: the kernel for CUDA tensors, the twin for
    CPU ones. The kernel forms afac = -dt h and dfac = nu dt itself, from
    device operands, so a call is one launch."""
    if not _on_cuda(lab):
        return fused_lab_rhs_plain(lab, h, nu, dt)
    n, two, hp, wp = lab.shape
    if two != 2 or hp != 14 or wp != 14:
        raise ValueError(f"fused_lab_rhs: lab {tuple(lab.shape)}: expected "
                         "[N, 2, 14, 14] (BS 8, 3 ghost cells)")
    if not torch.is_tensor(h):
        h = torch.full((n,), float(h), device=lab.device)
    if not torch.is_tensor(dt):
        dt = torch.tensor(float(dt), device=lab.device)
    h = h.reshape(-1)
    if h.shape != (n,) or dt.numel() != 1:
        raise ValueError(f"fused_lab_rhs: h {tuple(h.shape)} / dt "
                         f"{tuple(dt.shape)}: expected one h per block and "
                         "a scalar dt")
    _check_f32("fused_lab_rhs", lab=lab, h=h, dt=dt)
    out = lab.new_empty((n, 2, 8, 8))
    _launch("lab_rhs", lab.device, lab.data_ptr(), h.data_ptr(),
            dt.data_ptr(), float(nu), out.data_ptr(), n)
    launches["fused_lab_rhs"] += 1
    return out


# ---------------------------------------------------------------------------
# K8: one forest block-Jacobi update e + P_inv (r - lap)
# ---------------------------------------------------------------------------

def block_jacobi_plain(e, r, lap, p_inv):
    """Plain twin: ``e + apply_block_precond_blocks(r - lap, p_inv)`` on
    [N, BS, BS] block stacks (the JAX package's XLA composition)."""
    n, bs, _ = r.shape
    d = r - lap
    return e + (d.reshape(n, bs * bs) @ p_inv.T).reshape(n, bs, bs)


def fused_block_jacobi_update(e, r, lap, p_inv):
    """e + P_inv (r - lap) over [N, 8, 8] f32 stacks, P_inv [64, 64]: the
    kernel for CUDA tensors (an f32 FMA chain, no TF32; every operand
    16-byte aligned), the twin for CPU ones."""
    if not _on_cuda(e, r, lap, p_inv):
        return block_jacobi_plain(e, r, lap, p_inv)
    n = e.shape[0]
    if (e.shape != (n, 8, 8) or r.shape != e.shape or lap.shape != e.shape
            or p_inv.shape != (64, 64)):
        raise ValueError(
            f"fused_block_jacobi_update: e {tuple(e.shape)}, r "
            f"{tuple(r.shape)}, lap {tuple(lap.shape)}, p_inv "
            f"{tuple(p_inv.shape)}: expected [N, 8, 8] x3 and [64, 64]")
    _check_f32("fused_block_jacobi_update", e=e, r=r, lap=lap, p_inv=p_inv)
    if not _aligned16(e, r, lap, p_inv):
        raise ValueError("fused_block_jacobi_update: operands must start on "
                         "16-byte boundaries (the kernel copies 16 bytes at "
                         "a time)")
    out = torch.empty_like(e)
    if n == 0:
        return out
    _launch("block_jacobi", e.device, p_inv.data_ptr(), e.data_ptr(),
            r.data_ptr(), lap.data_ptr(), out.data_ptr(), n,
            block_jacobi_grid(n, _sm_count(e.device)))
    launches["fused_block_jacobi_update"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: one Heun substage on an x slab of a split field (free-slip box)
# ---------------------------------------------------------------------------

def advect_substage_halo_plain(v, vold, aux, facs, cfac, ih2, is_lo, is_hi):
    """Plain twin of one substage on an x slab: v, vold [L, 2, Ny, w]
    (vold None on the first substage); aux [L, 2, Ny, 6] the three columns
    either side of the slab (the neighbours' edge columns; ignored on a
    side whose wall the slab owns, ``is_lo``/``is_hi``); facs [L, 2]
    per-member (afac, dfac). The slabs of a split field give
    ``advect_substage_plain`` of the whole field bit for bit."""
    afac = facs[:, 0].reshape(-1, 1, 1, 1)
    dfac = facs[:, 1].reshape(-1, 1, 1, 1)
    lab = pad_vector_slab(v, aux, 3, is_lo, is_hi)
    rhs = advect_diffuse_core(lab, 3, afac, dfac)
    return heun_substage(v if vold is None else vold, cfac, rhs, ih2)


def advect_substage_halo(v, vold, aux, facs, cfac, ih2, is_lo, is_hi):
    """One substage on an x slab: the kernel for CUDA tensors, the twin
    for CPU ones. Same arguments and result as the twin."""
    if not _on_cuda(v, vold, aux, facs):
        return advect_substage_halo_plain(v, vold, aux, facs, cfac, ih2,
                                          is_lo, is_hi)
    L, two, ny, nxl = v.shape
    if (two != 2 or facs.shape != (L, 2)
            or aux.shape != (L, 2, ny, 6)):
        raise ValueError(
            f"advect_substage_halo: v {tuple(v.shape)}, aux "
            f"{tuple(aux.shape)}, facs {tuple(facs.shape)}: expected "
            "[L,2,Ny,w], [L,2,Ny,6], [L,2]")
    if vold is not None and vold.shape != v.shape:
        raise ValueError("advect_substage_halo: vold shape differs from v")
    _check_f32("advect_substage_halo", v=v, vold=vold, aux=aux, facs=facs)
    out = torch.empty_like(v)
    vec, grid = substage_plan(L, ny, nxl, _sm_count(v.device),
                              _aligned16(v))
    _launch("advect_heun_halo", v.device, v.data_ptr(),
            None if vold is None else vold.data_ptr(), aux.data_ptr(),
            out.data_ptr(), facs.data_ptr(), L, ny, nxl, float(cfac),
            float(ih2), int(bool(is_lo)), int(bool(is_hi)), vec, grid)
    launches["advect_substage_halo"] += 1
    return out


# ---------------------------------------------------------------------------
# K7: one damped-Jacobi sweep on an x slab of a split field
# ---------------------------------------------------------------------------

def jacobi_halo_sweep_plain(e, r, aux, omega, is_lo, is_hi,
                            from_zero=False):
    """Plain twin of one sweep e + omega*(r - lap(e))*inv_d on an x slab
    [..., Ny, w]: aux [..., Ny, 2] the neighbours' edge columns (zeros at
    a wall); the x-wall diagonal only on the sides the slab owns.
    ``from_zero`` gives omega*r*inv_d and reads neither e nor aux. The
    slabs of a split field give one sweep of ``jacobi_sweeps_plain`` bit
    for bit, in any dtype."""
    ny, w = r.shape[-2:]
    inv_d = inv_diag_slab(ny, w, r.dtype, r.device, bool(is_lo),
                          bool(is_hi))
    if from_zero:
        return omega * r * inv_d
    return e + omega * (r - laplacian5_neumann_slab(e, aux, is_lo, is_hi)
                        ) * inv_d


def jacobi_halo_sweep(e, r, aux, omega, is_lo, is_hi, from_zero=False):
    """One sweep on an x slab: the kernel for CUDA tensors (one launch),
    the twin for CPU ones. Same arguments and result as the twin."""
    if from_zero:
        e = aux = None
    if not _on_cuda(e, r, aux):
        return jacobi_halo_sweep_plain(e, r, aux, omega, is_lo, is_hi,
                                       from_zero)
    ny, nxl = r.shape[-2:]
    L = math.prod(r.shape[:-2])
    if e is not None and (e.shape != r.shape
                          or aux.shape != r.shape[:-1] + (2,)):
        raise ValueError(
            f"jacobi_halo_sweep: e {tuple(e.shape)}, r {tuple(r.shape)}, "
            f"aux {tuple(aux.shape)}: expected [...,Ny,w] x2, [...,Ny,2]")
    _check_f32("jacobi_halo_sweep", e=e, r=r, aux=aux)
    out = torch.empty_like(r)
    _launch("jacobi_halo", r.device, None if e is None else e.data_ptr(),
            r.data_ptr(), None if aux is None else aux.data_ptr(),
            out.data_ptr(), L, ny, nxl, float(omega), int(bool(is_lo)),
            int(bool(is_hi)), int(e is None))
    launches["jacobi_halo_sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# K1: WENO5 advect-diffuse RHS over a pre-padded lab (single op)
# ---------------------------------------------------------------------------

def advect_diffuse_rhs_plain(vlab, h, nu, dt):
    """Plain twin: ``stencil.advect_diffuse_rhs(vlab, 3, h, nu, dt)`` on a
    lab [..., 2, Ny+6, Nx+6] -> [..., 2, Ny, Nx]."""
    return stencil.advect_diffuse_rhs(vlab, 3, h, nu, dt)


def advect_diffuse_rhs(vlab, h, nu, dt):
    """WENO5 advect-diffuse RHS over a ghost-padded lab (ghosts read, not
    painted), afac = -dt h, dfac = nu dt with numbers h, nu and dt: the
    kernel for CUDA tensors, the twin for CPU ones."""
    if not _on_cuda(vlab):
        return advect_diffuse_rhs_plain(vlab, h, nu, dt)
    if vlab.dim() < 3 or vlab.shape[-3] != 2:
        raise ValueError(f"advect_diffuse_rhs: lab {tuple(vlab.shape)}: "
                         "expected [..., 2, Ny+6, Nx+6]")
    ny, nx = vlab.shape[-2] - 6, vlab.shape[-1] - 6
    L = math.prod(vlab.shape[:-3])
    facs = torch.tensor([-dt * h, nu * dt], dtype=torch.float32,
                        device=vlab.device)
    _check_f32("advect_diffuse_rhs", vlab=vlab)
    out = vlab.new_empty(vlab.shape[:-2] + (ny, nx))
    _launch("advect_rhs", vlab.device, vlab.data_ptr(), out.data_ptr(),
            facs.data_ptr(), L, ny, nx)
    launches["advect_diffuse_rhs"] += 1
    return out
