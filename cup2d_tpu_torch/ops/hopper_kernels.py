"""Hand-written Hopper kernels of the uniform and forest steps, their
plain PyTorch twins and their launch counters.

Five CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a``) replace the
Pallas kernels of ``cup2d_tpu/ops/pallas_kernels.py`` that the
obstacle-free uniform step (the first three) and the obstacle-free forest
step (the last two) run:

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
=============================  ===============================  ===================

The two WENO kernels share their per-cell arithmetic through
``csrc/weno.cuh``.

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
advection kernel, one per chain of at most six sweeps for the smoother,
one per call for the forest kernels); twin calls do not count.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .stencil import (_edge_ones, _zshift, advect_diffuse_core,
                      advect_diffuse_rhs, heun_substage, inv_diag_neumann,
                      laplacian5_neumann, pad_vector)

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source stem -> (C entry point, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    "advect_heun": ("cup2d_advect_substage",
                    [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P]),
    "correction": ("cup2d_fused_correction",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "jacobi": ("cup2d_jacobi_sweeps",
               [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    "lab_rhs": ("cup2d_lab_rhs", [_P, _P, _P, _F, _P, _I, _P]),
    "block_jacobi": ("cup2d_block_jacobi", [_P, _P, _P, _P, _P, _I, _P]),
}

launches = {"fused_advect_heun": 0, "fused_correction": 0,
            "fused_jacobi_sweeps": 0, "fused_lab_rhs": 0,
            "fused_block_jacobi_update": 0}

# the TPU kernel each wrapper replaces, for reports
REPLACES = {
    "fused_advect_heun": "cup2d_tpu/ops/pallas_kernels.py:329",
    "fused_correction": "cup2d_tpu/ops/pallas_kernels.py:804",
    "fused_jacobi_sweeps": "cup2d_tpu/ops/pallas_kernels.py:979",
    "fused_lab_rhs": "cup2d_tpu/ops/pallas_kernels.py:756",
    "fused_block_jacobi_update": "cup2d_tpu/ops/pallas_kernels.py:1345",
}
SOURCES = {
    "fused_advect_heun": "cup2d_tpu_torch/ops/csrc/advect_heun.cu",
    "fused_correction": "cup2d_tpu_torch/ops/csrc/correction.cu",
    "fused_jacobi_sweeps": "cup2d_tpu_torch/ops/csrc/jacobi.cu",
    "fused_lab_rhs": "cup2d_tpu_torch/ops/csrc/lab_rhs.cu",
    "fused_block_jacobi_update": "cup2d_tpu_torch/ops/csrc/block_jacobi.cu",
}

JACOBI_MAX_SWEEPS = 6

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


def _launch(stem: str, *args) -> None:
    if stem not in _fns:
        build()
    rc = _fns[stem](*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {stem} failed: error {rc}")


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
    _launch("advect_heun", v.data_ptr(),
            None if vold is None else vold.data_ptr(), out.data_ptr(),
            facs.data_ptr(), L, ny, nx, float(cfac), float(ih2))
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
    _launch("correction", x.data_ptr(), pres_old.data_ptr(), vel.data_ptr(),
            scal.data_ptr(), pres.data_ptr(), vout.data_ptr(), L, ny, nx,
            float(ih2))
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


def fused_jacobi_sweeps(e, r, omega, n, from_zero=False):
    """n sweeps: on CUDA tensors as launches of at most six sweeps each
    (the first carries ``from_zero``), on CPU tensors the twin."""
    if not _on_cuda(None if from_zero else e, r):
        return jacobi_sweeps_plain(e, r, omega, n, from_zero)
    ny, nx = r.shape[-2:]
    L = math.prod(r.shape[:-2])
    if not from_zero and e.shape != r.shape:
        raise ValueError(f"fused_jacobi_sweeps: e {tuple(e.shape)} vs r "
                         f"{tuple(r.shape)}")
    _check_f32("fused_jacobi_sweeps", r=r, e=None if from_zero else e)
    cur = None if from_zero else e
    left = int(n)
    while left > 0:
        k = min(left, JACOBI_MAX_SWEEPS)
        out = torch.empty_like(r)
        _launch("jacobi", None if cur is None else cur.data_ptr(),
                r.data_ptr(), out.data_ptr(), L, ny, nx, k, float(omega),
                int(cur is None))
        launches["fused_jacobi_sweeps"] += 1
        cur = out
        left -= k
    return cur


# ---------------------------------------------------------------------------
# K4: WENO5 advection + diffusion RHS over forest labs
# ---------------------------------------------------------------------------

def fused_lab_rhs_plain(lab, h, nu, dt):
    """Plain twin: ``advect_diffuse_rhs(lab, 3, h, nu, dt)`` on labs
    [N, 2, 14, 14] with ``h`` shaped [N, 1, 1, 1] (or a scalar)."""
    return advect_diffuse_rhs(lab, 3, h, nu, dt)


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
    _launch("lab_rhs", lab.data_ptr(), h.data_ptr(), dt.data_ptr(),
            float(nu), out.data_ptr(), n)
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
    kernel for CUDA tensors (an f32 FMA chain, no TF32), the twin for CPU
    ones."""
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
    out = torch.empty_like(e)
    _launch("block_jacobi", p_inv.data_ptr(), e.data_ptr(), r.data_ptr(),
            lap.data_ptr(), out.data_ptr(), n)
    launches["fused_block_jacobi_update"] += 1
    return out
