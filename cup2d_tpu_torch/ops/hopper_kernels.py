"""Hand-written Hopper kernels of the uniform and forest steps, their
plain PyTorch twins and their launch counters.

Eight CUDA C++ kernels (``csrc/*.cu``, built for ``sm_90a``) replace the
eight Pallas kernels of ``cup2d_tpu/ops/pallas_kernels.py``: the
obstacle-free uniform step (free-slip or walled by a boundary table) runs
the first three, the obstacle-free forest step the next two, the x-split
sharded uniform step (``parallel.shard_halo``) the two halo kernels, and
the single-op RHS lies on no step (the JAX package keeps it as a parity
and history baseline):

=============================  ===============================  ===================
wrapper                        replaces                         source
=============================  ===============================  ===================
``fused_advect_heun``          ``_substage_kernel`` (both Heun  ``advect_heun.cu``
                               substages, free-slip or a
                               table's ghosts, f32 or bf16)
``fused_correction``           ``_correct_kernel`` (Neumann or  ``correction.cu``
                               a table's signs, f32)
``fused_jacobi_sweeps``        ``_jacobi_strips_kernel``        ``jacobi.cu``
                               (Neumann or a table's edge
                               signs, f32 or bf16)
``fused_lab_rhs``              ``_lab_kernel`` (forest labs,    ``lab_rhs.cu``
                               f32)
``fused_block_jacobi_update``  ``_block_jacobi_kernel`` (f32;   ``block_jacobi.cu``
``block_precond``              the update, P_inv r and
                               e + P_inv r forms)
``advect_substage_halo``       ``_sharded_substage_kernel``     ``advect_heun_halo.cu``
                               (one substage on an x slab,
                               free-slip, a table's ghosts or a
                               periodic table's wrap, f32 or
                               bf16)
``jacobi_halo_sweep``          ``_jacobi_halo_kernel`` (one     ``jacobi_halo.cu``
``jacobi_halo_sweep_slabs``    sweep on an x slab, or on every
                               slab of a device in one launch,
                               Neumann or a table's edge
                               signs, a periodic y wrapped,
                               f32 or bf16)
``advect_diffuse_rhs``         ``_adv_kernel`` (RHS over a      ``advect_rhs.cu``
                               pre-padded lab, f32)
``tridiag_scan``               no Pallas kernel: the fftd       ``tridiag.cu``
                               solve's two ``lax.scan``s
                               (batched Thomas, complex64)
``group_sum``                  no Pallas kernel: the forest's   ``group_sum.cu``
                               full reductions, XLA's in the
                               JAX package (per 16-block
                               group, one fixed tree; f32 or
                               f64)
=============================  ===============================  ===================

The four WENO kernels share their arithmetic through ``csrc/weno.cuh``;
the two substage kernels and the single-op RHS share their tiles, cp.async
ring and face-sharing walk through ``csrc/substage.cuh`` (the RHS in its
own form: a lab loader that paints nothing, and rhs as the result).

Five kernels also have a boundary-table form for the wall-bounded boxes
of ``bc.py`` (a second C entry in the same source, a template instance of
its own): ``fused_advect_heun(bc=...)`` paints the table's ghosts in the
kernel (``_substage_kernel``'s BC branch), ``advect_substage_halo(bc=...)``
paints them on an x slab (``_sharded_substage_kernel``'s BC branch: the
profile at the slab's global columns, the x faces on the walls it owns),
``fused_correction(grad_signs=...)``, ``fused_jacobi_sweeps(edge_signs=
...)`` and ``jacobi_halo_sweep(edge_signs=...)`` take the table's pressure
signs. The reference's halo sweep is Neumann only: its signed split
hierarchies sweep with the signed strip kernel on GSPMD-partitioned
fields, which the port's split levels sweep slab by slab instead, so the
signed halo sweep equals one signed sweep of ``fused_jacobi_sweeps`` bit
for bit.

Three kernels also have a wrap form for the periodic tables (f32, a C
entry and template instance of its own; the JAX package runs these tables
on its XLA chains only, whose function the forms compute):
``fused_advect_heun(bc=<periodic table>)`` copies the halo along a
periodic axis from the wrapped rows and columns and paints the other
axis's faces; ``fused_correction`` reads the gradient's neighbours at the
wrapped index; ``fused_jacobi_sweeps`` sweeps the wrapped halo with the
interior diagonal along a periodic axis. A periodic axis's pressure signs
are 0 (``bc.pressure_signs``), both of them (a lone 0 refuses), and the
two wrappers read the periodic axes from those pairs (``_wrap_axes``).
The two halo kernels of the x-split step have wrap forms too (f32): on a
periodic table ``advect_substage_halo`` runs the substage's wrap form on
an x slab (the rows wrapped inside the slab along a periodic y; along a
periodic x the halo columns come from a ring exchange and no slab owns a
wall), and ``jacobi_halo_sweep`` / ``jacobi_halo_sweep_slabs`` their
y-wrap forms where the signs make y periodic (a periodic x needs no form:
the slab list's edge-column sources close into a ring). The FFT direct
solve's batched Thomas scans
(``tridiag_scan``, ``tridiag.cu``) replace no TPU kernel: the JAX package
runs them as ``lax.scan`` (``FFTDiagPlan.solve``), which PyTorch lacks.
The forest's group partials (``group_sum``, ``group_sum.cu``) replace no
TPU kernel either: every full reduction of the forest over its ordered
blocks sums fixed groups of 16 blocks by one tree
(``parallel.shard_halo.block_sum``), so that a shard's partials are the
solo run's bit for bit, which PyTorch's reductions, choosing their order
from the size of the call, do not promise.

Four kernels also have a bf16 storage form, the ``CUP2D_PREC=bf16`` tier
(bf16 operands, f32 arithmetic; a C entry of its own in the same source):
``fused_advect_heun(bf16=True)`` (substage 1 reads a bf16 copy of the
state and writes bf16, substage 2 reads that and the copy as vold and
writes the f32 state; free-slip or a table), ``advect_substage_halo`` on
bf16 slabs (aux in bf16; free-slip or a table), and ``fused_jacobi_sweeps`` and
``jacobi_halo_sweep`` on bf16 fields (every sweep rounded to bf16 once).
The dtype of the operands selects the form. Their twins widen to f32, run
the f32 twin and round where the kernel rounds.

Five kernels also have an f64 form, for f64 state on the card (a C entry
of its own, in the same source but for the sweep chain's,
``jacobi_f64.cu``; the arithmetic type a template parameter of the
kernel, in the f32 form's order of operations): the free-slip,
boundary-table and wrap forms of ``fused_advect_heun``, ``fused_correction``
and ``fused_jacobi_sweeps``, and ``fused_lab_rhs``,
``fused_block_jacobi_update`` and ``block_precond`` (every form). The JAX
package runs f64 state on its XLA chains (its Pallas gates take f32
only), whose function these forms compute; their twins are the f32 forms'
twins, which run at the operands' dtype. The halo kernels (3, 7) and
``tridiag.cu`` take no f64: the split steps and fftd refuse f64 state on
the card before they allocate (``uniform.check_card_f64``).

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
advection kernels, one per chain of at most six sweeps for the smoother
(in bf16: of 6, 2 or 1, ``BF16_CHAIN``), one per sweep for the halo
smoother, over every slab of a device (``jacobi_halo_sweep_slabs``) or of
one slab (``jacobi_halo_sweep``), one per call for the others); a launch
counts under its kernel's name and again under the name with the suffix
of each form it is: ``+bc`` (a boundary table), ``+bf16`` (bf16
storage), ``+bc+bf16`` (both), ``+pd`` (the wrap form of a periodic
table, which counts under ``+bc`` too) and ``+pinv`` (kernel 8 as the
forest's block-Jacobi preconditioner, ``block_precond``: its P form
P_inv r, its E form e + P_inv r, which counts under ``+pinv+e`` too, and
its update form inside a preconditioner) and ``+f64`` (an f64 form). Twin
calls do not count. A launch runs on the current stream of its tensors'
device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import stencil
from ..bc import pad_vector_bc, pad_vector_bc_slab, periodic_axes
from .stencil import (NEUMANN_SIGNS, _edge_ones, _shift_bc, _zshift,
                      advect_diffuse_core, heun_substage, inv_diag_bc,
                      inv_diag_bc_slab, inv_diag_neumann, laplacian5_bc,
                      laplacian5_bc_slab, laplacian5_neumann, pad_vector,
                      pad_vector_slab)

_CSRC = Path(__file__).resolve().parent / "csrc"
# the default build directory; ``CUP2D_CACHE`` takes its place
# (``cache.build_dir``, read once at the first build)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source stem -> (C entry point, ctypes argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _D = ctypes.c_float, ctypes.c_double
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
    "advect_rhs": ("cup2d_advect_rhs", [_P, _P, _P, _I, _I, _I, _I, _I,
                                        _P]),
    "tridiag": ("cup2d_tridiag_scan", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "group_sum": ("cup2d_group_sum", [_P, _P, _P, _I, _I, _I, _I, _P]),
    # the f64 forms of the sweep chain (jacobi.cuh's kernel), a source of
    # their own so that they compile beside jacobi.cu's instances
    "jacobi_f64": ("cup2d_jacobi_sweeps_f64",
                   [_P, _P, _P, _I, _I, _I, _I, _D, _I, _I, _I, _I, _P]),
}


class _Face(ctypes.Structure):
    """``substage::Face`` (csrc/substage.cuh)."""
    _fields_ = [("kind", ctypes.c_int), ("parabolic", ctypes.c_int),
                ("u", ctypes.c_float), ("v", ctypes.c_float)]


class _Faces(ctypes.Structure):
    """``substage::Faces``: x_lo, x_hi, y_lo, y_hi, passed by value."""
    _fields_ = [(name, _Face) for name in ("x_lo", "x_hi", "y_lo", "y_hi")]


class _Face64(ctypes.Structure):
    """``substage::FaceT<double>``: the f64 forms' face, its wall velocity
    in f64."""
    _fields_ = [("kind", ctypes.c_int), ("parabolic", ctypes.c_int),
                ("u", ctypes.c_double), ("v", ctypes.c_double)]


class _Faces64(ctypes.Structure):
    """``substage::Faces64``: the f64 forms' face table, by value."""
    _fields_ = [(name, _Face64)
                for name in ("x_lo", "x_hi", "y_lo", "y_hi")]


_FACE_KINDS = {"free_slip": 0, "no_slip": 1, "inflow": 2, "outflow": 3,
               "periodic": 4}


class _Slab(ctypes.Structure):
    """``halo::Slab`` (csrc/jacobi_halo.cu): one slab of a slab list."""
    _fields_ = [("e", ctypes.c_void_p), ("r", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("left", ctypes.c_void_p),
                ("right", ctypes.c_void_p), ("nxl", ctypes.c_int),
                ("lstride", ctypes.c_int), ("rstride", ctypes.c_int),
                ("is_lo", ctypes.c_int), ("is_hi", ctypes.c_int)]


# the most slabs one slab-list launch takes (jacobi_halo.cu's MAX_SLABS)
HALO_MAX_SLABS = 16

# the boundary-table and bf16 forms: key -> (source stem, C entry point,
# argtypes)
_FORM_ENTRIES = {
    "advect_heun+bc": ("advect_heun", "cup2d_advect_substage_bc",
                       [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _Faces, _I,
                        _I, _P]),
    "correction+bc": ("correction", "cup2d_fused_correction_signed",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                       _F, _P]),
    "jacobi+bc": ("jacobi", "cup2d_jacobi_sweeps_signed",
                  [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F, _F,
                   _F, _F, _P]),
    "advect_heun+bf16": ("advect_heun", "cup2d_advect_substage_bf16",
                         [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I,
                          _P]),
    "advect_heun+bc+bf16": ("advect_heun", "cup2d_advect_substage_bc_bf16",
                            [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _Faces,
                             _I, _I, _I, _P]),
    "advect_heun_halo+bf16": ("advect_heun_halo",
                              "cup2d_advect_substage_halo_bf16",
                              [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                               _I, _I, _I, _I, _P]),
    "jacobi+bf16": ("jacobi", "cup2d_jacobi_sweeps_bf16",
                    [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
    "jacobi+bc+bf16": ("jacobi", "cup2d_jacobi_sweeps_signed_bf16",
                       [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F,
                        _F, _F, _F, _P]),
    "jacobi_halo+bf16": ("jacobi_halo", "cup2d_jacobi_halo_sweep_bf16",
                         [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P]),
    "advect_heun_halo+bc": ("advect_heun_halo",
                            "cup2d_advect_substage_halo_bc",
                            [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                             _Faces, _I, _I, _I, _I, _I, _I, _P]),
    "advect_heun_halo+bc+bf16": ("advect_heun_halo",
                                 "cup2d_advect_substage_halo_bc_bf16",
                                 [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                  _F, _Faces, _I, _I, _I, _I, _I, _I, _I,
                                  _P]),
    "jacobi_halo+bc": ("jacobi_halo", "cup2d_jacobi_halo_sweep_signed",
                       [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _F, _F,
                        _F, _F, _P]),
    "jacobi_halo+bc+bf16": ("jacobi_halo",
                            "cup2d_jacobi_halo_sweep_signed_bf16",
                            [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _F,
                             _F, _F, _F, _P]),
    "jacobi_halo+slabs": ("jacobi_halo", "cup2d_jacobi_halo_sweep_slabs",
                          [_P, _I, _I, _I, _F, _I, _P]),
    "jacobi_halo+slabs+bf16": ("jacobi_halo",
                               "cup2d_jacobi_halo_sweep_slabs_bf16",
                               [_P, _I, _I, _I, _F, _I, _P]),
    "jacobi_halo+slabs+bc": ("jacobi_halo",
                             "cup2d_jacobi_halo_sweep_slabs_signed",
                             [_P, _I, _I, _I, _F, _I, _F, _F, _F, _F, _P]),
    "jacobi_halo+slabs+bc+bf16": ("jacobi_halo",
                                  "cup2d_jacobi_halo_sweep_slabs_signed_bf16",
                                  [_P, _I, _I, _I, _F, _I, _F, _F, _F, _F,
                                   _P]),
    "advect_heun+wrap": ("advect_heun", "cup2d_advect_substage_wrap",
                         [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _Faces,
                          _I, _I, _P]),
    "correction+wrap": ("correction", "cup2d_fused_correction_wrap",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                         _F, _P]),
    "jacobi+wrap": ("jacobi", "cup2d_jacobi_sweeps_wrap",
                    [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F, _F,
                     _F, _F, _P]),
    "advect_heun_halo+wrap": ("advect_heun_halo",
                              "cup2d_advect_substage_halo_wrap",
                              [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                               _Faces, _I, _I, _I, _I, _I, _I, _P]),
    "jacobi_halo+wrap": ("jacobi_halo", "cup2d_jacobi_halo_sweep_wrap",
                         [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _F, _F,
                          _F, _F, _P]),
    "jacobi_halo+slabs+wrap": ("jacobi_halo",
                               "cup2d_jacobi_halo_sweep_slabs_wrap",
                               [_P, _I, _I, _I, _F, _I, _F, _F, _F, _F, _P]),
    "block_jacobi+pinv": ("block_jacobi", "cup2d_block_precond",
                          [_P, _P, _P, _P, _P, _I, _I, _P]),
    # the f64 forms (f64 operands and scalars; the signs stay f32)
    "advect_heun+f64": ("advect_heun", "cup2d_advect_substage_f64",
                        [_P, _P, _P, _P, _I, _I, _I, _D, _D, _I, _I, _P]),
    "advect_heun+bc+f64": ("advect_heun", "cup2d_advect_substage_bc_f64",
                           [_P, _P, _P, _P, _I, _I, _I, _D, _D, _D,
                            _Faces64, _I, _I, _P]),
    "advect_heun+wrap+f64": ("advect_heun", "cup2d_advect_substage_wrap_f64",
                             [_P, _P, _P, _P, _I, _I, _I, _D, _D, _D,
                              _Faces64, _I, _I, _P]),
    "correction+f64": ("correction", "cup2d_fused_correction_f64",
                       [_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _P]),
    "correction+bc+f64": ("correction", "cup2d_fused_correction_signed_f64",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _F, _F,
                           _F, _F, _P]),
    "correction+wrap+f64": ("correction", "cup2d_fused_correction_wrap_f64",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _F, _F,
                             _F, _F, _P]),
    "jacobi+f64": ("jacobi_f64", "cup2d_jacobi_sweeps_f64",
                   [_P, _P, _P, _I, _I, _I, _I, _D, _I, _I, _I, _I, _P]),
    "jacobi+bc+f64": ("jacobi_f64", "cup2d_jacobi_sweeps_signed_f64",
                      [_P, _P, _P, _I, _I, _I, _I, _D, _I, _I, _I, _I, _F,
                       _F, _F, _F, _P]),
    "jacobi+wrap+f64": ("jacobi_f64", "cup2d_jacobi_sweeps_wrap_f64",
                        [_P, _P, _P, _I, _I, _I, _I, _D, _I, _I, _I, _I, _F,
                         _F, _F, _F, _P]),
    "lab_rhs+f64": ("lab_rhs", "cup2d_lab_rhs_f64",
                    [_P, _P, _P, _D, _P, _I, _P]),
    "block_jacobi+f64": ("block_jacobi", "cup2d_block_jacobi_f64",
                         [_P, _P, _P, _P, _P, _I, _I, _P]),
    "block_jacobi+pinv+f64": ("block_jacobi", "cup2d_block_precond_f64",
                              [_P, _P, _P, _P, _P, _I, _I, _P]),
}

launches = {"fused_advect_heun": 0, "fused_correction": 0,
            "fused_jacobi_sweeps": 0, "fused_lab_rhs": 0,
            "fused_block_jacobi_update": 0, "advect_substage_halo": 0,
            "jacobi_halo_sweep": 0, "advect_diffuse_rhs": 0,
            "fused_advect_heun+bc": 0, "fused_correction+bc": 0,
            "fused_jacobi_sweeps+bc": 0, "fused_advect_heun+bf16": 0,
            "fused_advect_heun+bc+bf16": 0, "advect_substage_halo+bf16": 0,
            "fused_jacobi_sweeps+bf16": 0, "fused_jacobi_sweeps+bc+bf16": 0,
            "jacobi_halo_sweep+bf16": 0, "advect_substage_halo+bc": 0,
            "advect_substage_halo+bc+bf16": 0, "jacobi_halo_sweep+bc": 0,
            "jacobi_halo_sweep+bc+bf16": 0, "fused_advect_heun+pd": 0,
            "fused_correction+pd": 0, "fused_jacobi_sweeps+pd": 0,
            "advect_substage_halo+pd": 0, "jacobi_halo_sweep+pd": 0,
            "tridiag_scan": 0, "group_sum": 0,
            "fused_block_jacobi_update+pinv": 0,
            "fused_block_jacobi_update+pinv+e": 0,
            "fused_advect_heun+f64": 0, "fused_correction+f64": 0,
            "fused_jacobi_sweeps+f64": 0, "fused_lab_rhs+f64": 0,
            "fused_block_jacobi_update+f64": 0}

# the TPU kernel each wrapper replaces, for reports (a boundary-table or
# bf16 form is a form of its kernel: ``kernel_of``)
REPLACES = {
    "fused_advect_heun": "cup2d_tpu/ops/pallas_kernels.py:329",
    "fused_correction": "cup2d_tpu/ops/pallas_kernels.py:804",
    "fused_jacobi_sweeps": "cup2d_tpu/ops/pallas_kernels.py:979",
    "fused_lab_rhs": "cup2d_tpu/ops/pallas_kernels.py:756",
    "fused_block_jacobi_update": "cup2d_tpu/ops/pallas_kernels.py:1345",
    "advect_substage_halo": "cup2d_tpu/ops/pallas_kernels.py:576",
    "jacobi_halo_sweep": "cup2d_tpu/ops/pallas_kernels.py:1202",
    "advect_diffuse_rhs": "cup2d_tpu/ops/pallas_kernels.py:130",
    # no Pallas kernel: the two lax.scan's of FFTDiagPlan.solve
    "tridiag_scan": "cup2d_tpu/poisson.py:1028",
    # no Pallas kernel: XLA's jnp.sum of the forest's dots, means and
    # integrals
    "group_sum": "cup2d_tpu/poisson.py:519",
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
    "tridiag_scan": "cup2d_tpu_torch/ops/csrc/tridiag.cu",
    "group_sum": "cup2d_tpu_torch/ops/csrc/group_sum.cu",
    # a form built from a source of its own
    "fused_jacobi_sweeps+f64": "cup2d_tpu_torch/ops/csrc/jacobi_f64.cu",
}

JACOBI_MAX_SWEEPS = 6
# the sweeps a bf16, wrap or f64 chain launch may take (jacobi.cu builds
# those alone for these forms)
BF16_CHAIN = (6, 2, 1)
# jacobi.cu's two tiles, (rows out, shared columns), and the CTAs of each
# that fit on an SM (shared memory for the big one, registers for the
# small one); the f64 forms' big tile has half the rows
JACOBI_TILES = {True: (64, 128), False: (16, 32)}
JACOBI_TILES_F64 = {True: (32, 128), False: (16, 32)}
JACOBI_CTAS_PER_SM = {True: 1, False: 4}
JACOBI_BIG_ROUNDS = 4
# block_jacobi.cu's blocks per CTA round (a chunk of 8 for each of its 4
# warps, fixed in the kernel) and CTAs per SM, every form (kernel_ab's
# grid sweep)
BLOCK_JACOBI_TILE = 32
BLOCK_JACOBI_CTAS_PER_SM = 4
# the f64 forms' CTAs per SM, by the operands a form streams (P 1, E 2,
# update 3): as many as their shared memory lets an SM hold (P_inv and the
# rings in f64 take 68, 102 and 137 KB a CTA), so that no CTA waits for a
# second wave
BLOCK_JACOBI_CTAS_PER_SM_F64 = {1: 3, 2: 2, 3: 1}
# the substage kernels' tile (rows, columns out; csrc/substage.cuh) and
# CTAs per SM (96 KB of shared memory and 128 registers a thread each; the
# f64 form's 187 KB, one)
SUBSTAGE_TILE = (32, 128)
SUBSTAGE_CTAS_PER_SM = 2
SUBSTAGE_CTAS_PER_SM_F64 = 1

_fns: dict = {}          # source stem (or _FORM_ENTRIES key) -> C entry
# kernel-library builds and loads since import: one per nvcc run and one
# per C entry resolved (profiling.HostCounters' jit_compiles); a steady
# state makes none, and the CPU never any
build_events = 0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def kernel_of(name: str) -> str:
    """The kernel a launch counter belongs to (``fused_correction+bc``,
    ``fused_advect_heun+bc+bf16`` -> ``fused_correction``,
    ``fused_advect_heun``), the key of ``REPLACES`` and ``SOURCES``."""
    return name.split("+")[0]


def source_of(name: str) -> str:
    """The source a launch counter's form builds from: its own
    ``SOURCES`` row where it has one, else its kernel's."""
    return SOURCES.get(name, SOURCES[kernel_of(name)])


def _count(name: str, bc: bool = False, bf16: bool = False,
           pd: bool = False, f64: bool = False) -> None:
    launches[name] += 1
    if f64:
        launches[name + "+f64"] += 1
    if pd:
        launches[name + "+pd"] += 1
    if bc:
        launches[name + "+bc"] += 1
    if bf16:
        launches[name + "+bf16"] += 1
    if bc and bf16:
        launches[name + "+bc+bf16"] += 1


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
    return build_dir() / f"lib{stem}-{tag[:16]}.so"


def build_dir() -> Path:
    """Where the kernel libraries build and load: ``CUP2D_CACHE`` where
    set (read once, at the first build), else ``BUILD_DIR``."""
    from ..cache import build_dir as _cache_dir
    return _cache_dir(BUILD_DIR)


def build() -> dict:
    """Compile every kernel source not yet built (one ``nvcc`` each, all
    started together), load them, and return ``{stem: log}`` with the
    compiler's resource report for the sources built now and, last, the
    seconds its ``nvcc`` ran (``nvcc ... s``). Each build and each load
    is one ``build_events`` and one row of the flight recorder's build
    ledger (``tracing.note_build``, on the innermost open label)."""
    global build_events
    from .. import tracing
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
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
        build_events += 1
    # the compiler's output, drained while it runs, and its wall time
    outs = {stem: [] for stem in procs}
    readers = [threading.Thread(target=lambda p=p, o=outs[stem]:
                                o.append(p.stdout.read()))
               for stem, (p, _, _) in procs.items()]
    for t in readers:
        t.start()
    secs = {}
    while len(secs) < len(procs):
        for stem, (p, _, _) in procs.items():
            if stem not in secs and p.poll() is not None:
                secs[stem] = time.perf_counter() - t0
        time.sleep(0.05)
    for t in readers:
        t.join()
    logs = {}
    failed = []
    for stem, (p, tmp, so) in procs.items():
        out = "".join(outs[stem])
        logs[stem] = out + f"\nnvcc {secs[stem]:.1f} s\n"
        if p.returncode != 0:
            failed.append(f"{stem}.cu (rc {p.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
        tracing.note_build(secs[stem])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    entries = {k: (k, *v) for k, v in _ENTRIES.items()}
    entries.update(_FORM_ENTRIES)
    for key, (stem, name, argtypes) in entries.items():
        if key not in _fns:
            t_load = time.perf_counter()
            fn = getattr(ctypes.CDLL(str(_lib_path(stem))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[key] = fn
            build_events += 1
            tracing.note_build(time.perf_counter() - t_load)
    return logs


def _launch(stem: str, device: torch.device, *args) -> None:
    """Launch the C entry ``stem`` (a source stem or a ``_FORM_ENTRIES``
    key) on ``device`` (made current for the call) and its current
    stream."""
    if stem not in _fns:
        build()
    with torch.cuda.device(device):
        rc = _fns[stem](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {stem} failed: error {rc}")


def _signs(signs) -> tuple:
    """A table's four pressure signs (x_lo, x_hi, y_lo, y_hi) as floats:
    +1 (Neumann) or -1 (Dirichlet) on a wall face, 0 on both faces of a
    periodic axis (a lone 0 refuses: tables pair periodic faces)."""
    signs = tuple(float(x) for x in signs)
    pairs = (signs[:2], signs[2:])
    if len(signs) != 4 or any(
            p != (0.0, 0.0) and any(x not in (1.0, -1.0) for x in p)
            for p in pairs):
        raise ValueError(f"signs {signs}: expected +1 (Neumann) or -1 "
                         "(Dirichlet) on a wall face, 0 on both faces of a "
                         "periodic axis")
    return signs


def _wrap_axes(signs) -> tuple:
    """(px, py): the periodic axes of ``_signs``' checked signs, those
    whose pair is (0, 0)."""
    return tuple(signs[k:k + 2] == (0.0, 0.0) for k in (0, 2))


def _faces(bc, f64: bool = False):
    """The kernel's by-value face table of a ``BCTable`` (a periodic face
    is kind 4: the wrap form); ``f64``: the f64 forms' table."""
    faces, face = (_Faces64(), _Face64) if f64 else (_Faces(), _Face)
    for name, f in zip(("x_lo", "x_hi", "y_lo", "y_hi"), bc):
        if f.kind not in _FACE_KINDS:
            raise ValueError(f"boundary table {bc.token}: face {name} of kind "
                             f"{f.kind!r} has no kernel form")
        setattr(faces, name, face(_FACE_KINDS[f.kind],
                                  int(f.kind == "inflow"
                                      and f.profile == "parabolic"),
                                  float(f.u_wall[0]), float(f.u_wall[1])))
    return faces


def _split_signs(signs) -> tuple:
    """``_signs`` of a split field's halo sweep and its y-wrap flag: a
    periodic y (the pair (0, 0)) takes the y-wrap form; a periodic x needs
    no form of its own (its slabs close into a ring, none a wall slab, so
    the x signs are never read)."""
    signs = _signs(signs)
    return signs, _wrap_axes(signs)[1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned_copies(*ts) -> bool:
    """True where the operands start on the boundary of the kernels' wide
    copies: 16 bytes for f32 (four values) and f64 (two), 8 for bf16 (four
    values)."""
    return all(t.data_ptr() % min(4 * t.element_size(), 16) == 0
               for t in ts if t is not None)


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


_F32 = (torch.float32,)
_STORAGE = (torch.float32, torch.bfloat16)
# the five kernels with an f64 form (2, 5, 6, 4, 8)
_WIDE = (torch.float32, torch.float64)
_STORAGE_WIDE = (torch.float32, torch.bfloat16, torch.float64)


def _check(name: str, allowed=_F32, **ts) -> None:
    """Each operand of a launch is of a dtype in ``allowed``, the same one
    for all (the kernel's storage type), and contiguous."""
    names = " or ".join(str(d).split(".")[-1] for d in allowed)
    seen = {t.dtype for t in ts.values() if t is not None}
    for k, t in ts.items():
        if t is None:
            continue
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {k} must be {names} on the card, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    if len(seen) > 1:
        raise TypeError(f"{name}: operands of dtypes {sorted(map(str, seen))}"
                        ": expected one storage dtype")


def _out_dtype(name: str, v, out_dtype):
    """A substage's output dtype: v's by default; a bf16 substage may
    write f32 (the second Heun substage), an f32 one only f32."""
    out_dtype = v.dtype if out_dtype is None else out_dtype
    if out_dtype != v.dtype and not (v.dtype == torch.bfloat16
                                     and out_dtype == torch.float32):
        raise TypeError(f"{name}: {v.dtype} operands write {v.dtype} (or, "
                        f"from bfloat16, float32), not {out_dtype}")
    return out_dtype


def _widen(*ts):
    """bf16 operands as f32 (others as they are; None stays None)."""
    return tuple(t.float() if t is not None and t.dtype == torch.bfloat16
                 else t for t in ts)


# ---------------------------------------------------------------------------
# K2: one Heun substage of WENO5 advection + diffusion (free-slip box, and
# the boundary-table form)
# ---------------------------------------------------------------------------

def advect_substage_plain(v, vold, facs, cfac, ih2, bc=None, h=None,
                          out_dtype=None):
    """Plain twin of one substage: v, vold [L, 2, Ny, Nx] (vold None on
    the first substage, where it is v); facs [L, 2] per-member
    (afac, dfac), or with a boundary table ``bc`` (not free-slip) [L, 3]
    with the raw dt, which feeds the outflow speed with the grid spacing
    ``h``. The JAX package's pad (``pad_vector`` or ``bc.pad_vector_bc``,
    whose wrap serves a periodic table's axes) -> advect_diffuse_core ->
    heun_substage chain. bf16 v and vold (the
    bf16 form) are widened to f32 first and the result rounded once to
    ``out_dtype`` (default v's dtype)."""
    out_dtype = _out_dtype("advect_substage", v, out_dtype)
    v, vold = _widen(v, vold)
    afac = facs[:, 0].reshape(-1, 1, 1, 1)
    dfac = facs[:, 1].reshape(-1, 1, 1, 1)
    if bc is None:
        lab = pad_vector(v, 3)
    else:
        lab = pad_vector_bc(v, 3, bc, h, facs[:, 2].reshape(-1, 1, 1, 1))
    rhs = advect_diffuse_core(lab, 3, afac, dfac)
    return heun_substage(v if vold is None else vold, cfac, rhs,
                         ih2).to(out_dtype)


@functools.lru_cache(maxsize=4096)
def substage_plan(L: int, ny: int, nx: int, sms: int, aligned: bool,
                  f64: bool = False) -> tuple[int, int]:
    """Launch plan of the substage kernels (``advect_heun.cu``,
    ``advect_heun_halo.cu``) for L members of ny x nx (a slab's width for
    the halo kernel) on a card of ``sms`` SMs: (vec, grid). Copies of four
    values (16 bytes in f32, 8 in bf16) where rows are whole such words
    and v is ``aligned`` to them, else of one; persistent CTAs, as many as
    the tiles up to the SMs' room. ``f64``: copies of two values (16
    bytes) where nx is even and v ``aligned``, else of one, and one CTA an
    SM."""
    ty, tx = SUBSTAGE_TILE
    tiles = L * _cdiv(ny, ty) * _cdiv(nx, tx)
    if f64:
        vec = 2 if nx % 2 == 0 and aligned else 1
        return vec, min(tiles, sms * SUBSTAGE_CTAS_PER_SM_F64)
    vec = 4 if nx % 4 == 0 and aligned else 1
    return vec, min(tiles, sms * SUBSTAGE_CTAS_PER_SM)


def advect_substage(v, vold, facs, cfac, ih2, bc=None, h=None,
                    out_dtype=None):
    """One substage: the kernel for CUDA tensors (its boundary-table form
    where ``bc`` is given, its wrap form where the table has a periodic
    axis, its bf16 form for bf16 v and vold, its f64 form for f64 v, vold
    and facs), the twin for CPU ones. Same arguments and result as the
    twin; a periodic table has no bf16 form."""
    if not _on_cuda(v, vold, facs):
        return advect_substage_plain(v, vold, facs, cfac, ih2, bc, h,
                                     out_dtype)
    L, two, ny, nx = v.shape
    cols = 2 if bc is None else 3
    if (two != 2 or facs.shape != (L, cols)
            or (bc is not None and min(ny, nx) < 2)):
        raise ValueError(f"advect_substage: v {tuple(v.shape)} / facs "
                         f"{tuple(facs.shape)}: expected [L,2,Ny,Nx]/"
                         f"[L,{cols}] (a table's ghosts need Ny, Nx >= 2)")
    if vold is not None and vold.shape != v.shape:
        raise ValueError("advect_substage: vold shape differs from v")
    _check("advect_substage", _STORAGE_WIDE, v=v, vold=vold)
    f64 = v.dtype == torch.float64
    _check("advect_substage", (torch.float64,) if f64 else _F32, facs=facs)
    out_dtype = _out_dtype("advect_substage", v, out_dtype)
    bf16 = v.dtype == torch.bfloat16
    wrap = bc is not None and any(periodic_axes(bc))
    if wrap and bf16:
        raise ValueError(f"advect_substage: boundary table {bc.token}: a "
                         "periodic table has no bf16 form")
    faces = None if bc is None else _faces(bc, f64)
    out = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    vec, grid = substage_plan(L, ny, nx, _sm_count(v.device),
                              _aligned_copies(v), f64)
    args = (v.data_ptr(), None if vold is None else vold.data_ptr(),
            out.data_ptr(), facs.data_ptr(), L, ny, nx, float(cfac),
            float(ih2))
    form = (int(out_dtype == torch.bfloat16),) if bf16 else ()
    key = ("advect_heun" + ("" if bc is None else "+wrap" if wrap else "+bc")
           + ("+bf16" if bf16 else "") + ("+f64" if f64 else ""))
    if bc is None:
        _launch(key, v.device, *args, *form, vec, grid)
    else:
        _launch(key, v.device, *args, float(h), faces, *form, vec, grid)
    _count("fused_advect_heun", bc is not None, bf16, wrap, f64)
    return out


def _substage_facs(dt, h, nu, lead, L, dtype, device, with_dt=False):
    """Per-member [L, 2] (afac, dfac), or [L, 3] with the raw dt."""
    dtv = torch.as_tensor(dt, dtype=dtype, device=device)
    dtv = dtv.broadcast_to(lead).reshape(L)
    cols = [-dtv * h, nu * dtv] + ([dtv] if with_dt else [])
    return torch.stack(cols, dim=-1)


def _advect_heun(vel, h, nu, dt, substage, bc, bf16=False):
    if bc is not None and bc.is_free_slip:
        bc = None
    if bf16 and vel.dtype != torch.float32:
        raise ValueError(f"fused_advect_heun(bf16=True): {vel.dtype} state;"
                         " the bf16 tier needs f32 state")
    lead = vel.shape[:-3]
    L = math.prod(lead)
    v = vel.reshape((L,) + vel.shape[-3:])
    h = float(h)
    facs = _substage_facs(dt, h, nu, lead, L, vel.dtype, vel.device,
                          with_dt=bc is not None)
    ih2 = 1.0 / (h * h)
    if bf16:
        vb = v.to(torch.bfloat16)
        v1 = substage(vb, None, facs, 0.5, ih2, bc, h)
        v2 = substage(v1, vb, facs, 1.0, ih2, bc, h, torch.float32)
    else:
        v1 = substage(v, None, facs, 0.5, ih2, bc, h)
        v2 = substage(v1, v, facs, 1.0, ih2, bc, h)
    return v2.reshape(vel.shape)


def fused_advect_heun(vel, h, nu, dt, bc=None, bf16=False):
    """Both Heun substages (main.cpp:6607-6642). vel [..., 2, Ny, Nx]; dt a
    scalar or shaped like the leading dims (per-member dt); ``bc`` a
    ``BCTable`` (None or free-slip: the free-slip kernel; a periodic table:
    the wrap form, f32 or f64). f64 state runs the f64 forms.
    ``bf16`` (f32 state only): substage 1 reads a bf16 copy vb of the
    state and writes bf16, substage 2 reads that and vb (as vold) and
    writes the f32 state; facs stay f32."""
    return _advect_heun(vel, h, nu, dt, advect_substage, bc, bf16)


def fused_advect_heun_plain(vel, h, nu, dt, bc=None, bf16=False):
    """Plain twin of ``fused_advect_heun`` on any device."""
    return _advect_heun(vel, h, nu, dt, advect_substage_plain, bc, bf16)


# ---------------------------------------------------------------------------
# K5: projection correction epilogue (Neumann box, and a table's signs)
# ---------------------------------------------------------------------------

def fused_correction_plain(x, pres_old, vel, scal, ih2, grad_signs=None,
                           periodic=(False, False)):
    """Plain twin: x, pres_old [L, Ny, Nx]; vel [L, 2, Ny, Nx]; scal
    [L, 3] = (mean x, mean pres_old, pfac); ``grad_signs`` the table's
    (sx_lo, sx_hi, sy_lo, sy_hi) pressure signs (None: all Neumann), the
    wall terms -s_lo and +s_hi; ``periodic`` the table's (px, py): the
    gradient's shifts wrap there (``stencil._shift_bc``, as the JAX
    package's ``pressure_gradient_update_bc``), where the signs are 0.
    Returns (pres, vel)."""
    ny, nx = x.shape[-2:]
    px, py = periodic
    sx_lo, sx_hi, sy_lo, sy_hi = grad_signs or (1.0, 1.0, 1.0, 1.0)
    s = scal.reshape(-1, 3, 1, 1)
    # lint: allow[leading-dim] -- s is scal flattened to [L, 3, 1, 1] above: axis 1 is the coefficient axis whatever the lead
    pres = ((x - s[:, 0]) + pres_old) - s[:, 1]
    gx = _edge_ones(nx, x.dtype, x.device, lo=-sx_lo, hi=sx_hi)
    gy = _edge_ones(ny, x.dtype, x.device, lo=-sy_lo, hi=sy_hi)

    def zs(dy, dx):
        return _shift_bc(pres, dy, dx, px, py)
    dpx = (zs(0, 1) - zs(0, -1)) + pres * gx[None, :]
    dpy = (zs(1, 0) - zs(-1, 0)) + pres * gy[:, None]
    # lint: allow[leading-dim] -- s is scal flattened to [L, 3, 1, 1]: axis 1 is the coefficient axis whatever the lead
    dv = s[:, 2:3] * torch.stack([dpx, dpy], dim=-3)
    return pres, vel + dv * ih2


def fused_correction(x, pres_old, vel, scal, ih2, grad_signs=None):
    """Correction epilogue: the kernel for CUDA tensors (its signed form
    where ``grad_signs`` is given, its wrap form where they have a periodic
    axis's (0, 0) pair; f32 or f64 operands, one dtype), the twin for CPU
    ones (with those axes). Same arguments and result as
    ``fused_correction_plain``."""
    signs = None if grad_signs is None else _signs(grad_signs)
    px, py = (False, False) if signs is None else _wrap_axes(signs)
    if not _on_cuda(x, pres_old, vel, scal):
        return fused_correction_plain(x, pres_old, vel, scal, ih2, signs,
                                      (px, py))
    L, ny, nx = x.shape
    if (pres_old.shape != x.shape or vel.shape != (L, 2, ny, nx)
            or scal.shape != (L, 3)):
        raise ValueError(
            f"fused_correction: x {tuple(x.shape)}, pres_old "
            f"{tuple(pres_old.shape)}, vel {tuple(vel.shape)}, scal "
            f"{tuple(scal.shape)}: expected [L,Ny,Nx] x2, [L,2,Ny,Nx], [L,3]")
    _check("fused_correction", _WIDE, x=x, pres_old=pres_old, vel=vel,
           scal=scal)
    f64 = x.dtype == torch.float64
    tag = "+f64" if f64 else ""
    pres = torch.empty_like(x)
    vout = torch.empty_like(vel)
    args = (x.data_ptr(), pres_old.data_ptr(), vel.data_ptr(),
            scal.data_ptr(), pres.data_ptr(), vout.data_ptr(), L, ny, nx,
            float(ih2))
    if signs is None:
        _launch("correction" + tag, x.device, *args)
        _count("fused_correction", f64=f64)
        return pres, vout
    _launch(("correction+wrap" if px or py else "correction+bc") + tag,
            x.device, *args, *signs)
    _count("fused_correction", True, pd=px or py, f64=f64)
    return pres, vout


# ---------------------------------------------------------------------------
# K6: chains of damped-Jacobi sweeps (Neumann walls, and a table's signs)
# ---------------------------------------------------------------------------

def jacobi_sweeps_plain(e, r, omega, n, from_zero=False, edge_signs=None,
                        periodic=(False, False)):
    """Plain twin: n sweeps e + omega*(r - lap(e))*inv_d of the zero-ghost
    Neumann Laplacian on [..., Ny, Nx] (``edge_signs``: a table's signed
    ``laplacian5_bc`` and its diagonal; ``periodic`` its (px, py), whose
    shifts wrap, the signs 0 there, as the JAX package's periodic
    ``MultigridPreconditioner._smooth``); ``from_zero`` makes the first
    sweep omega*r*inv_d and ignores ``e``."""
    ny, nx = r.shape[-2:]
    if edge_signs is None:
        inv_d = inv_diag_neumann(ny, nx, r.dtype, r.device)
        lap = laplacian5_neumann
    else:
        signs = tuple(float(x) for x in edge_signs)
        inv_d = inv_diag_bc(ny, nx, r.dtype, r.device, signs)
        px, py = periodic

        def lap(p):
            return laplacian5_bc(p, *signs, px, py)
    if from_zero and n > 0:
        e = omega * r * inv_d
        n -= 1
    for _ in range(n):
        e = e + omega * (r - lap(e)) * inv_d
    return e


def jacobi_sweeps_bf16_plain(e, r, omega, n, from_zero=False,
                             edge_signs=None, periodic=(False, False)):
    """Plain twin of the bf16 form of the sweep chain: e, r bf16; each
    sweep is ``jacobi_sweeps_plain``'s in f32 on the widened operands,
    rounded to bf16 once, as the kernel stores it. (``jacobi_sweeps_plain``
    on bf16 tensors is another function: bf16 arithmetic, every operation
    rounded, the default solver's bf16 preconditioner cycle.)"""
    (rf,) = _widen(r)
    cur = None if from_zero else _widen(e)[0]
    for k in range(int(n)):
        cur = jacobi_sweeps_plain(cur, rf, omega, 1, from_zero and k == 0,
                                  edge_signs, periodic
                                  ).to(torch.bfloat16).float()
    return e if cur is None else cur.to(torch.bfloat16)


def sweep_chain(n: int, bf16: bool = False, wrap: bool = False,
                f64: bool = False) -> list[int]:
    """The sweeps of each launch of an n-sweep chain: launches of
    ``JACOBI_MAX_SWEEPS`` and one of the rest, in that order; in bf16 of
    the sizes ``BF16_CHAIN``, largest first (a bf16 chain rounds every
    sweep wherever it keeps it, so the cut does not change its result),
    and so in the wrap and f64 forms (an f32 or f64 sweep keeps in shared
    memory what it would store in device memory: the same holds)."""
    n = int(n)
    if bf16 or wrap or f64:
        out = []
        for k in BF16_CHAIN:
            out += [k] * (n // k)
            n %= k
        return out
    full, rest = divmod(n, JACOBI_MAX_SWEEPS)
    return [JACOBI_MAX_SWEEPS] * full + ([rest] if rest else [])


@functools.lru_cache(maxsize=4096)
def jacobi_plan(L: int, ny: int, nx: int, n: int, sms: int, aligned: bool,
                f64: bool = False) -> tuple[bool, int, int]:
    """Launch plan of ``jacobi.cu`` for an n-sweep launch on L members of
    ny x nx on a card of ``sms`` SMs: (big, vec, grid). The 128-column
    tile where the level has at least ``JACOBI_BIG_ROUNDS`` per SM (fewer
    leave the last round's SMs idle for a whole tile), else the 32-column
    one (each puts out its width less twice the x halo, n rounded up to 4);
    copies of four values (16 bytes in f32, 8 in bf16) where rows are whole
    such words and the pointers ``aligned`` to them, else of one;
    persistent CTAs, as many as the tiles up to the SMs' room. ``f64``:
    the f64 tiles (``JACOBI_TILES_F64``) and copies of two values (16
    bytes) where nx is even and the pointers ``aligned``."""
    hx = 4 * _cdiv(n, 4)
    shapes = JACOBI_TILES_F64 if f64 else JACOBI_TILES

    def tiles(big):
        ty, w = shapes[big]
        return L * _cdiv(ny, ty) * _cdiv(nx, w - 2 * hx)
    big = tiles(True) >= JACOBI_BIG_ROUNDS * sms
    if f64:
        vec = 2 if nx % 2 == 0 and aligned else 1
    else:
        vec = 4 if nx % 4 == 0 and aligned else 1
    return big, vec, min(tiles(big), sms * JACOBI_CTAS_PER_SM[big])


def block_jacobi_grid(n: int, sms: int,
                      ctas: int = BLOCK_JACOBI_CTAS_PER_SM) -> int:
    """CTAs of ``block_jacobi.cu`` for n blocks: ``ctas`` per SM (every
    f32 form ``BLOCK_JACOBI_CTAS_PER_SM``, an f64 form its
    ``BLOCK_JACOBI_CTAS_PER_SM_F64``), or one per round of
    ``BLOCK_JACOBI_TILE`` blocks where there are fewer."""
    return min(_cdiv(n, BLOCK_JACOBI_TILE), ctas * sms)


def fused_jacobi_sweeps(e, r, omega, n, from_zero=False, edge_signs=None):
    """n sweeps: on CUDA tensors as launches of at most six sweeps each
    (``sweep_chain``; the first carries ``from_zero``; the signed form where
    ``edge_signs`` is given; the wrap form, f32 or f64, where they have a
    periodic axis's (0, 0) pair; the bf16 form for bf16 e and r, the f64
    form for f64 ones), on CPU tensors the twin
    (``jacobi_sweeps_bf16_plain`` for bf16) with those axes."""
    bf16 = r.dtype == torch.bfloat16
    signs = () if edge_signs is None else _signs(edge_signs)
    px, py = _wrap_axes(signs) if signs else (False, False)
    wrap = px or py
    if not _on_cuda(None if from_zero else e, r):
        twin = jacobi_sweeps_bf16_plain if bf16 else jacobi_sweeps_plain
        return twin(e, r, omega, n, from_zero, signs or None, (px, py))
    ny, nx = r.shape[-2:]
    L = math.prod(r.shape[:-2])
    if not from_zero and e.shape != r.shape:
        raise ValueError(f"fused_jacobi_sweeps: e {tuple(e.shape)} vs r "
                         f"{tuple(r.shape)}")
    _check("fused_jacobi_sweeps", _STORAGE_WIDE, r=r,
           e=None if from_zero else e)
    if wrap and bf16:
        raise ValueError("fused_jacobi_sweeps: the wrap form is f32 or f64 "
                         "only")
    f64 = r.dtype == torch.float64
    key = (("jacobi+wrap" if wrap else "jacobi+bc") if signs else "jacobi"
           ) + ("+bf16" if bf16 else "") + ("+f64" if f64 else "")
    cur = None if from_zero else e
    sms = _sm_count(r.device)
    for k in sweep_chain(n, bf16, wrap, f64):
        out = torch.empty_like(r)
        big, vec, grid = jacobi_plan(L, ny, nx, k, sms,
                                     _aligned_copies(cur, r), f64)
        _launch(key, r.device, None if cur is None else cur.data_ptr(),
                r.data_ptr(), out.data_ptr(), L, ny, nx, k, float(omega),
                int(cur is None), int(big), vec, grid, *signs)
        _count("fused_jacobi_sweeps", bool(signs), bf16, wrap, f64)
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
    or [N]) and a scalar dt: the kernel for CUDA tensors (f32, or its f64
    form for f64 labs; h and dt of the labs' dtype), the twin for CPU ones.
    The kernel forms afac = -dt h and dfac = nu dt itself, from device
    operands, so a call is one launch."""
    if not _on_cuda(lab):
        return fused_lab_rhs_plain(lab, h, nu, dt)
    n, two, hp, wp = lab.shape
    if two != 2 or hp != 14 or wp != 14:
        raise ValueError(f"fused_lab_rhs: lab {tuple(lab.shape)}: expected "
                         "[N, 2, 14, 14] (BS 8, 3 ghost cells)")
    if not torch.is_tensor(h):
        h = torch.full((n,), float(h), dtype=lab.dtype, device=lab.device)
    if not torch.is_tensor(dt):
        dt = torch.tensor(float(dt), dtype=lab.dtype, device=lab.device)
    h = h.reshape(-1)
    if h.shape != (n,) or dt.numel() != 1:
        raise ValueError(f"fused_lab_rhs: h {tuple(h.shape)} / dt "
                         f"{tuple(dt.shape)}: expected one h per block and "
                         "a scalar dt")
    _check("fused_lab_rhs", _WIDE, lab=lab, h=h, dt=dt)
    f64 = lab.dtype == torch.float64
    out = lab.new_empty((n, 2, 8, 8))
    _launch("lab_rhs+f64" if f64 else "lab_rhs", lab.device, lab.data_ptr(),
            h.data_ptr(), dt.data_ptr(), float(nu), out.data_ptr(), n)
    _count("fused_lab_rhs", f64=f64)
    return out


# ---------------------------------------------------------------------------
# K8: the forest's block-Jacobi update e + P_inv (r - lap) and its
# preconditioner forms P_inv r and e + P_inv r
# ---------------------------------------------------------------------------

# blocks of one fixed-shape product in the twin (the forest's reduction
# group, parallel.shard_halo.GROUP_BLOCKS)
PRECOND_ROWS = 16


def block_precond_plain(d, p_inv):
    """P_inv d on an [N, BS, BS] block stack (``apply_block_precond_blocks``)
    as products of one fixed shape: each whole group of ``PRECOND_ROWS``
    blocks is one [16, BS^2] x [BS^2, BS^2] product of a batched product,
    the blocks past the last whole group one more product. A block's
    product then has the same operands and shape whatever N, so a shard's
    blocks give the solo forest's bits (a product over all N rows lets the
    library pick its blocking, and so its order, from N)."""
    n, bs, _ = d.shape
    k = bs * bs
    g = n // PRECOND_ROWS
    flat = d.reshape(n, k)
    head = flat[:g * PRECOND_ROWS].reshape(g, PRECOND_ROWS, k)
    out = torch.bmm(head, p_inv.T.expand(g, k, k)).reshape(-1, k)
    if g * PRECOND_ROWS < n:
        out = torch.cat([out, flat[g * PRECOND_ROWS:] @ p_inv.T])
    return out.reshape(n, bs, bs)


def block_jacobi_plain(e, r, lap, p_inv):
    """Plain twin: ``e + P_inv (r - lap)`` on [N, BS, BS] block stacks (the
    JAX package's XLA composition), the product as
    ``block_precond_plain``'s fixed-shape products."""
    return e + block_precond_plain(r - lap, p_inv)


def block_precond_form_plain(r, p_inv, e=None, lap=None):
    """Plain twin of ``block_precond``: ``0 + P_inv r`` (e None),
    ``e + (0 + P_inv r)`` (lap None) or ``e + (0 + P_inv (r - lap))``, the
    product as ``block_precond_plain``'s fixed-shape products; the 0 makes
    a -0 product +0, as kernel 8 with a zero e did."""
    z = block_precond_plain(r if lap is None else r - lap, p_inv) + 0.0
    return z if e is None else e + z


def _block_jacobi_operands(name, e, r, lap, p_inv) -> int:
    """Check kernel 8's operands (the absent ones None) and return N."""
    n = r.shape[0]
    ts = {"e": e, "r": r, "lap": lap}
    if (any(t is not None and t.shape != (n, 8, 8) for t in ts.values())
            or p_inv.shape != (64, 64)):
        raise ValueError(
            f"{name}: " + ", ".join(f"{k} {tuple(t.shape)}"
                                    for k, t in ts.items() if t is not None)
            + f", p_inv {tuple(p_inv.shape)}: expected [N, 8, 8] block "
            "stacks and [64, 64]")
    _check(name, _WIDE, **ts, p_inv=p_inv)
    if not _aligned_copies(e, r, lap, p_inv):
        raise ValueError(f"{name}: operands must start on 16-byte "
                         "boundaries (the kernel copies 16 bytes at a time)")
    return n


def fused_block_jacobi_update(e, r, lap, p_inv):
    """e + P_inv (r - lap) over [N, 8, 8] f32 stacks, P_inv [64, 64]: the
    kernel for CUDA tensors (an f32 FMA chain, no TF32; its f64 form for
    f64 operands; every operand 16-byte aligned), the twin for CPU
    ones."""
    if not _on_cuda(e, r, lap, p_inv):
        return block_jacobi_plain(e, r, lap, p_inv)
    n = _block_jacobi_operands("fused_block_jacobi_update", e, r, lap,
                               p_inv)
    out = torch.empty_like(r)
    if n == 0:
        return out
    f64 = r.dtype == torch.float64
    ctas = BLOCK_JACOBI_CTAS_PER_SM_F64[3] if f64 else \
        BLOCK_JACOBI_CTAS_PER_SM
    _launch("block_jacobi+f64" if f64 else "block_jacobi", r.device,
            p_inv.data_ptr(), e.data_ptr(), r.data_ptr(), lap.data_ptr(),
            out.data_ptr(), n, block_jacobi_grid(n, _sm_count(r.device),
                                                 ctas))
    _count("fused_block_jacobi_update", f64=f64)
    return out


def block_precond(r, p_inv, e=None, lap=None):
    """The forest's block-Jacobi preconditioner on [N, 8, 8] blocks as one
    launch of kernel 8 in the form that streams only the operands given:
    ``0 + P_inv r`` (the P form: r in, z out), ``e + (0 + P_inv r)`` (the
    E form, lap None) or ``e + (0 + P_inv (r - lap))`` (the update form
    inside a preconditioner). Adding the product to 0 first gives the bits
    of kernel 8 with a zero e and lap and a separate add, which the forms
    replace. On CUDA tensors each launch counts under
    ``fused_block_jacobi_update`` and its ``+pinv`` form (the E form also
    under ``+pinv+e``, an f64 form also under ``+f64``): one f32 (f64) FMA
    chain a row, k in order, so a row's bits do not depend on how many rows
    the call holds (a cuBLAS GEMM may pick a split-K plan from N). On CPU
    tensors the twin (``block_precond_form_plain``)."""
    if lap is not None and e is None:
        raise ValueError("block_precond: lap without e")
    if not _on_cuda(e, r, lap, p_inv):
        return block_precond_form_plain(r, p_inv, e, lap)
    n = _block_jacobi_operands("block_precond", e, r, lap, p_inv)
    out = torch.empty_like(r)
    if n == 0:
        return out
    f64 = r.dtype == torch.float64
    nops = 1 + (e is not None) + (lap is not None)
    ctas = BLOCK_JACOBI_CTAS_PER_SM_F64[nops] if f64 else \
        BLOCK_JACOBI_CTAS_PER_SM
    _launch("block_jacobi+pinv+f64" if f64 else "block_jacobi+pinv",
            r.device, p_inv.data_ptr(), None if e is None else e.data_ptr(),
            r.data_ptr(), None if lap is None else lap.data_ptr(),
            out.data_ptr(), n, block_jacobi_grid(n, _sm_count(r.device),
                                                 ctas))
    _count("fused_block_jacobi_update", f64=f64)
    launches["fused_block_jacobi_update+pinv"] += 1
    if e is not None and lap is None:
        launches["fused_block_jacobi_update+pinv+e"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: one Heun substage on an x slab of a split field (free-slip box, and
# the boundary-table form)
# ---------------------------------------------------------------------------

def advect_substage_halo_plain(v, vold, aux, facs, cfac, ih2, is_lo, is_hi,
                               out_dtype=None, bc=None, h=None, col0=0,
                               nx_tot=None):
    """Plain twin of one substage on an x slab: v, vold [L, 2, Ny, w]
    (vold None on the first substage); aux [L, 2, Ny, 6] the three columns
    either side of the slab (the neighbours' edge columns; ignored on a
    side whose wall the slab owns, ``is_lo``/``is_hi``); facs [L, 2]
    per-member (afac, dfac), or with a boundary table ``bc`` (not
    free-slip) [L, 3] with the raw dt, the ghosts painted by
    ``bc.pad_vector_bc_slab`` (grid spacing ``h``; the slab's first column
    is global column ``col0`` of ``nx_tot``; a periodic table's wrap, with
    the ring's columns in aux along a periodic x). The slabs of a split
    field give ``advect_substage_plain`` of the whole field bit for bit.
    bf16 v,
    vold and aux are widened and the result rounded to ``out_dtype``, as
    in ``advect_substage_plain``."""
    out_dtype = _out_dtype("advect_substage_halo", v, out_dtype)
    v, vold, aux = _widen(v, vold, aux)
    # lint: allow[leading-dim] -- facs is the flat [L, 3] factor table of the C entry, one row per flattened lead
    afac = facs[:, 0].reshape(-1, 1, 1, 1)
    dfac = facs[:, 1].reshape(-1, 1, 1, 1)  # lint: allow[leading-dim] -- the flat [L, 3] factor table
    if bc is None:
        lab = pad_vector_slab(v, aux, 3, is_lo, is_hi)
    else:
        lab = pad_vector_bc_slab(v, aux, 3, bc, h,
                                 # lint: allow[leading-dim] -- the flat [L, 3] factor table of the C entry
                                 facs[:, 2].reshape(-1, 1, 1, 1), col0,
                                 nx_tot, is_lo, is_hi)
    rhs = advect_diffuse_core(lab, 3, afac, dfac)
    return heun_substage(v if vold is None else vold, cfac, rhs,
                         ih2).to(out_dtype)


def advect_substage_halo(v, vold, aux, facs, cfac, ih2, is_lo, is_hi,
                         out_dtype=None, bc=None, h=None, col0=0,
                         nx_tot=None):
    """One substage on an x slab: the kernel for CUDA tensors (its
    boundary-table form where ``bc`` is given, its wrap form, f32, where
    the table has a periodic axis, its bf16 form for bf16 v, vold and
    aux), the twin for CPU ones. Same arguments and result as the twin;
    along a periodic x aux holds the ring's columns and neither wall is
    the slab's."""
    if not _on_cuda(v, vold, aux, facs):
        return advect_substage_halo_plain(v, vold, aux, facs, cfac, ih2,
                                          is_lo, is_hi, out_dtype, bc, h,
                                          col0, nx_tot)
    L, two, ny, nxl = v.shape
    cols = 2 if bc is None else 3
    if (two != 2 or facs.shape != (L, cols)
            or aux.shape != (L, 2, ny, 6)):
        raise ValueError(
            f"advect_substage_halo: v {tuple(v.shape)}, aux "
            f"{tuple(aux.shape)}, facs {tuple(facs.shape)}: expected "
            f"[L,2,Ny,w], [L,2,Ny,6], [L,{cols}]")
    if bc is not None and (min(ny, nxl) < 2 or nx_tot is None
                           or not 0 <= col0 <= nx_tot - nxl):
        raise ValueError(
            f"advect_substage_halo: a table's ghosts need Ny, w >= 2 and "
            f"the slab inside the field (v {tuple(v.shape)}, col0 {col0}, "
            f"nx_tot {nx_tot})")
    if vold is not None and vold.shape != v.shape:
        raise ValueError("advect_substage_halo: vold shape differs from v")
    _check("advect_substage_halo", _STORAGE, v=v, vold=vold, aux=aux)
    _check("advect_substage_halo", facs=facs)
    out_dtype = _out_dtype("advect_substage_halo", v, out_dtype)
    bf16 = v.dtype == torch.bfloat16
    wrap = bc is not None and any(periodic_axes(bc))
    if wrap and bf16:
        raise ValueError(f"advect_substage_halo: boundary table {bc.token}: "
                         "a periodic table has no bf16 form")
    if wrap and periodic_axes(bc)[0] and (is_lo or is_hi):
        raise ValueError("advect_substage_halo: a periodic x has no wall "
                         "slab (its halo is the ring's)")
    out = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    vec, grid = substage_plan(L, ny, nxl, _sm_count(v.device),
                              _aligned_copies(v))
    args = (v.data_ptr(), None if vold is None else vold.data_ptr(),
            aux.data_ptr(), out.data_ptr(), facs.data_ptr(), L, ny, nxl,
            float(cfac), float(ih2))
    walls = (int(bool(is_lo)), int(bool(is_hi)))
    form = (int(out_dtype == torch.bfloat16),) if bf16 else ()
    key = ("advect_heun_halo"
           + ("" if bc is None else "+wrap" if wrap else "+bc")
           + ("+bf16" if bf16 else ""))
    if bc is None:
        _launch(key, v.device, *args, *walls, *form, vec, grid)
    else:
        _launch(key, v.device, *args, float(h), _faces(bc), *walls,
                int(col0), int(nx_tot), *form, vec, grid)
    _count("advect_substage_halo", bc is not None, bf16, wrap)
    return out


# ---------------------------------------------------------------------------
# K7: one damped-Jacobi sweep on an x slab of a split field (Neumann walls,
# and a table's signs)
# ---------------------------------------------------------------------------

def jacobi_halo_sweep_plain(e, r, aux, omega, is_lo, is_hi,
                            from_zero=False, edge_signs=None):
    """Plain twin of one sweep e + omega*(r - lap(e))*inv_d on an x slab
    [..., Ny, w]: aux [..., Ny, 2] the neighbours' edge columns (zeros at
    a wall); the x-wall diagonal only on the sides the slab owns;
    ``edge_signs`` a table's (sx_lo, sx_hi, sy_lo, sy_hi) pressure signs
    (``laplacian5_bc_slab``; None: all Neumann). ``from_zero`` gives
    omega*r*inv_d and reads neither e nor aux. The slabs of a split field
    give one sweep of ``jacobi_sweeps_plain`` bit for bit, in any
    dtype. A periodic table's signs (a (0, 0) pair) wrap the y shifts
    inside the slab where y is periodic; along a periodic x aux holds the
    ring's columns and the slab owns no wall."""
    ny, w = r.shape[-2:]
    signs = (NEUMANN_SIGNS if edge_signs is None
             else tuple(float(x) for x in edge_signs))
    py = edge_signs is not None and _wrap_axes(_signs(signs))[1]
    inv_d = inv_diag_bc_slab(ny, w, r.dtype, r.device, signs, bool(is_lo),
                             bool(is_hi))
    if from_zero:
        return omega * r * inv_d
    return e + omega * (r - laplacian5_bc_slab(e, aux, signs, is_lo, is_hi,
                                               py)) * inv_d


def jacobi_halo_sweep_bf16_plain(e, r, aux, omega, is_lo, is_hi,
                                 from_zero=False, edge_signs=None):
    """Plain twin of the bf16 form of the halo sweep: e, r, aux bf16,
    ``jacobi_halo_sweep_plain`` in f32 on the widened operands, rounded to
    bf16 once."""
    e, r, aux = _widen(e, r, aux)
    return jacobi_halo_sweep_plain(e, r, aux, omega, is_lo, is_hi,
                                   from_zero, edge_signs).to(torch.bfloat16)


def jacobi_halo_sweep(e, r, aux, omega, is_lo, is_hi, from_zero=False,
                      edge_signs=None):
    """One sweep on an x slab: the kernel for CUDA tensors (one launch;
    its signed form where ``edge_signs`` is given, its y-wrap form, f32,
    where they make y periodic, its bf16 form for bf16 operands), the twin
    for CPU ones (``jacobi_halo_sweep_bf16_plain`` for bf16). Same
    arguments and result as the twin."""
    if from_zero:
        e = aux = None
    bf16 = r.dtype == torch.bfloat16
    if not _on_cuda(e, r, aux):
        twin = (jacobi_halo_sweep_bf16_plain if bf16
                else jacobi_halo_sweep_plain)
        return twin(e, r, aux, omega, is_lo, is_hi, from_zero, edge_signs)
    ny, nxl = r.shape[-2:]
    L = math.prod(r.shape[:-2])
    if e is not None and (e.shape != r.shape
                          or aux.shape != r.shape[:-1] + (2,)):
        raise ValueError(
            f"jacobi_halo_sweep: e {tuple(e.shape)}, r {tuple(r.shape)}, "
            f"aux {tuple(aux.shape)}: expected [...,Ny,w] x2, [...,Ny,2]")
    _check("jacobi_halo_sweep", _STORAGE, e=e, r=r, aux=aux)
    signs, wrap = ((), False) if edge_signs is None else _split_signs(
        edge_signs)
    if wrap and bf16:
        raise ValueError("jacobi_halo_sweep: the y-wrap form is f32 only")
    key = ("jacobi_halo" + ("+wrap" if wrap else "+bc" if signs else "")
           + ("+bf16" if bf16 else ""))
    out = torch.empty_like(r)
    _launch(key, r.device, None if e is None else e.data_ptr(),
            r.data_ptr(), None if aux is None else aux.data_ptr(),
            out.data_ptr(), L, ny, nxl, float(omega), int(bool(is_lo)),
            int(bool(is_hi)), int(e is None), *signs)
    _count("jacobi_halo_sweep", bool(signs), bf16, wrap)
    return out


def _edge_columns(es, ring: bool = False):
    """Per slab of a field split along x (``es`` its slabs in order, on
    one device) the aux [..., Ny, 2] of one sweep: the left neighbour's
    last column and the right neighbour's first, zeros where the slab owns
    a wall, or on the ``ring`` of a periodic x the last slab's last column
    left of slab 0 and slab 0's first right of the last
    (``parallel.shard_halo.exchange_x(., 1, ring)``)."""
    D = len(es)
    out = []
    for d, p in enumerate(es):
        zero = p.new_zeros(p.shape[:-1] + (1,))
        left = es[d - 1][..., -1:] if d > 0 or ring else zero
        right = es[(d + 1) % D][..., :1] if d < D - 1 or ring else zero
        out.append(torch.cat([left, right], dim=-1))
    return out


def jacobi_halo_sweep_slabs_plain(es, rs, omega, from_zero=False,
                                  edge_signs=None):
    """Plain twin of the slab-list sweep: ``rs`` (and ``es``, ignored
    ``from_zero``) the slabs [..., Ny, w_d] of a field split along x, in
    order, slab 0 owning the low x wall and the last the high one (no
    wall, the slabs a ring, where ``edge_signs`` make x periodic); per
    slab its neighbours' edge columns (``_edge_columns``) and
    ``jacobi_halo_sweep_plain`` (``jacobi_halo_sweep_bf16_plain`` for
    bf16). Returns the swept slabs."""
    bf16 = rs[0].dtype == torch.bfloat16
    twin = jacobi_halo_sweep_bf16_plain if bf16 else jacobi_halo_sweep_plain
    D = len(rs)
    ring = edge_signs is not None and _wrap_axes(_signs(edge_signs))[0]
    aux = [None] * D if from_zero else _edge_columns(es, ring)
    return [twin(None if from_zero else es[d], rs[d], aux[d], omega,
                 d == 0 and not ring, d == D - 1 and not ring, from_zero,
                 edge_signs) for d in range(D)]


def _overlaps(a, b) -> bool:
    pa, pb = a.data_ptr(), b.data_ptr()
    return (pa < pb + b.numel() * b.element_size()
            and pb < pa + a.numel() * a.element_size())


def jacobi_halo_sweep_slabs(es, rs, omega, from_zero=False, edge_signs=None,
                            out=None):
    """One sweep of every slab of a field split along x whose slabs lie on
    one device, the same arguments and result as the twin: on CUDA
    tensors one launch for all of them (at most ``HALO_MAX_SLABS``; its
    signed form where ``edge_signs`` is given, its bf16 form for bf16
    operands), each slab reading its neighbours' edge columns in place;
    on CPU tensors the twin. Where ``edge_signs`` make y periodic the
    y-wrap form (f32) runs; where they make x periodic no slab is a wall
    and the edge-column sources close into a ring (slab 0 reads the last
    slab's last column, the last slab slab 0's first; one slab its own).
    ``out`` (default: fresh tensors) receives the slabs; no out may
    overlap any slab of ``es``, which the launch reads while it writes."""
    D = len(rs)
    es = [None] * D if from_zero else list(es)
    bf16 = rs[0].dtype == torch.bfloat16
    if not _on_cuda(*es, *rs):
        return jacobi_halo_sweep_slabs_plain(es, rs, omega, from_zero,
                                             edge_signs)
    if len({t.device for t in es + rs if t is not None}) != 1:
        raise ValueError("jacobi_halo_sweep_slabs: slabs on several "
                         "devices (exchange their columns and sweep each "
                         "with jacobi_halo_sweep)")
    if not 1 <= D <= HALO_MAX_SLABS:
        raise ValueError(f"jacobi_halo_sweep_slabs: {D} slabs: one launch "
                         f"takes 1 to {HALO_MAX_SLABS}")
    lead = rs[0].shape[:-1]
    for d in range(D):
        if rs[d].shape[:-1] != lead or (
                es[d] is not None and es[d].shape != rs[d].shape):
            raise ValueError(
                f"jacobi_halo_sweep_slabs: slab {d}: r "
                f"{tuple(rs[d].shape)}, e "
                f"{None if es[d] is None else tuple(es[d].shape)}: "
                f"expected [...,{lead[-1]},w] both")
    _check("jacobi_halo_sweep", _STORAGE,
           **{f"r{d}": t for d, t in enumerate(rs)},
           **{f"e{d}": t for d, t in enumerate(es)})
    out = [torch.empty_like(t) for t in rs] if out is None else list(out)
    for d, o in enumerate(out):
        if o.shape != rs[d].shape or o.dtype != rs[d].dtype or (
                not o.is_contiguous()) or o.device != rs[d].device:
            raise ValueError(f"jacobi_halo_sweep_slabs: out {d} "
                             f"{tuple(o.shape)} {o.dtype}: expected r's "
                             "shape, dtype and device, contiguous")
        if any(e is not None and _overlaps(o, e) for e in es):
            raise ValueError(f"jacobi_halo_sweep_slabs: out {d} overlaps a "
                             "slab of e, which the launch reads while it "
                             "writes out")
    signs, wrap = ((), False) if edge_signs is None else _split_signs(
        edge_signs)
    ring = bool(signs) and _wrap_axes(signs)[0]
    if wrap and bf16:
        raise ValueError("jacobi_halo_sweep_slabs: the y-wrap form is f32 "
                         "only")
    item = rs[0].element_size()
    table = (_Slab * D)()
    for d in range(D):
        w = rs[d].shape[-1]
        s = table[d]
        s.e = None if es[d] is None else es[d].data_ptr()
        s.r, s.out, s.nxl = rs[d].data_ptr(), out[d].data_ptr(), w
        s.is_lo = int(d == 0 and not ring)
        s.is_hi = int(d == D - 1 and not ring)
        if es[d] is not None and (d > 0 or ring):
            left = es[d - 1]
            wl = left.shape[-1]
            s.left, s.lstride = left.data_ptr() + (wl - 1) * item, wl
        if es[d] is not None and (d < D - 1 or ring):
            right = es[(d + 1) % D]
            s.right, s.rstride = right.data_ptr(), right.shape[-1]
    key = ("jacobi_halo+slabs" + ("+wrap" if wrap else "+bc" if signs
                                  else "") + ("+bf16" if bf16 else ""))
    _launch(key, rs[0].device, table, D, math.prod(lead[:-1]), lead[-1],
            float(omega), int(bool(from_zero)), *signs)
    _count("jacobi_halo_sweep", bool(signs), bf16, wrap)
    return out


# ---------------------------------------------------------------------------
# K1: WENO5 advect-diffuse RHS over a pre-padded lab (single op)
# ---------------------------------------------------------------------------

def advect_diffuse_rhs_plain(vlab, h, nu, dt):
    """Plain twin: ``stencil.advect_diffuse_rhs(vlab, 3, h, nu, dt)`` on a
    lab [..., 2, Ny+6, Nx+6] -> [..., 2, Ny, Nx]."""
    return stencil.advect_diffuse_rhs(vlab, 3, h, nu, dt)


@functools.lru_cache(maxsize=4096)
def advect_rhs_plan(L: int, ny: int, nx: int, sms: int,
                    aligned: bool) -> tuple[int, int]:
    """Launch plan of the single-op RHS (``advect_rhs.cu``) over L labs
    [2, ny+6, nx+6] on a card of ``sms`` SMs: (vec, grid). 8-byte copies
    where the lab's pitch nx + 6 is even and the lab ``aligned`` to 8
    bytes, else 4-byte ones (a pitch of 8198 floats is no whole number of
    16-byte words, so the substages' 16-byte copies cannot read a lab);
    the substages' persistent grid (``substage_plan``)."""
    vec = 2 if nx % 2 == 0 and aligned else 1
    return vec, substage_plan(L, ny, nx, sms, False)[1]


@functools.lru_cache(maxsize=64)
def _rhs_facs(device: torch.device, afac: float, dfac: float):
    """The kernel's facs [2] = (afac, dfac) on ``device``, made once per
    value (a copy to the card per call could not be captured in a CUDA
    graph)."""
    return torch.tensor([afac, dfac], dtype=torch.float32, device=device)


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
    _check("advect_diffuse_rhs", vlab=vlab)
    # lint: allow[cache-key] -- the single-op RHS lies on no production path (chip_smoke and kernel_ab call it); a new dt costs one of the 64 entries and one small copy
    facs = _rhs_facs(vlab.device, float(-dt * h), float(nu * dt))
    out = vlab.new_empty(vlab.shape[:-2] + (ny, nx))
    vec, grid = advect_rhs_plan(L, ny, nx, _sm_count(vlab.device),
                                vlab.data_ptr() % 8 == 0)
    _launch("advect_rhs", vlab.device, vlab.data_ptr(), out.data_ptr(),
            facs.data_ptr(), L, ny, nx, vec, grid)
    launches["advect_diffuse_rhs"] += 1
    return out


# ---------------------------------------------------------------------------
# The FFT direct solve's batched Thomas scans (no TPU kernel: lax.scan in
# the JAX package's FFTDiagPlan.solve)
# ---------------------------------------------------------------------------

def tridiag_scan_plain(b, inv_denom, cp):
    """Plain twin: per member and mode of b [L, n_s, nk] (complex), the
    forward recurrence dp_j = (b_j - dp_{j-1}) * inv_denom_j and the
    backward x_j = dp_j - cp_j * x_{j+1} along j (coefficients
    [n_s, nk], real, of b's precision): the two ``lax.scan``s of the JAX
    package's ``FFTDiagPlan.solve``, as a loop over rows, the real and
    imaginary parts each scaled by the real coefficient. Returns x."""
    br = torch.view_as_real(b)
    out = torch.empty_like(br)
    dp = torch.zeros_like(br[:, 0])
    for j in range(b.shape[1]):
        dp = (br[:, j] - dp) * inv_denom[j, :, None]
        out[:, j] = dp
    xn = torch.zeros_like(dp)
    for j in range(b.shape[1] - 1, -1, -1):
        xn = out[:, j] - cp[j, :, None] * xn
        out[:, j] = xn
    return torch.view_as_complex(out)


def tridiag_scan(b, inv_denom, cp):
    """The batched Thomas scans: ``tridiag.cu`` for CUDA tensors (b
    complex64 [L, n_s, nk], inv_denom and cp f32 [n_s, nk], all
    contiguous; one launch), the twin for CPU ones. Same arguments and
    result as ``tridiag_scan_plain``."""
    if not _on_cuda(b, inv_denom, cp):
        return tridiag_scan_plain(b, inv_denom, cp)
    if b.dim() != 3 or b.shape[1:] != inv_denom.shape or (
            cp.shape != inv_denom.shape):
        raise ValueError(f"tridiag_scan: b {tuple(b.shape)}, inv_denom "
                         f"{tuple(inv_denom.shape)}, cp {tuple(cp.shape)}: "
                         "expected [L, n_s, nk] and [n_s, nk] twice")
    if b.dtype != torch.complex64 or not b.is_contiguous():
        raise TypeError(f"tridiag_scan: b must be contiguous complex64 on "
                        f"the card, got {b.dtype}")
    _check("tridiag_scan", inv_denom=inv_denom, cp=cp)
    L, n_s, nk = b.shape
    x = torch.empty_like(b)
    _launch("tridiag", b.device, b.data_ptr(), inv_denom.data_ptr(),
            cp.data_ptr(), x.data_ptr(), L, n_s, nk)
    launches["tridiag_scan"] += 1
    return x


# ---------------------------------------------------------------------------
# The forest's group partials (no TPU kernel: XLA's reductions in the JAX
# package)
# ---------------------------------------------------------------------------

# the most values one row of a group_sum launch takes (group_sum.cu)
GROUP_SUM_MAX = 8192


def group_sum_plain(a, c=None, acc_dtype=None):
    """Plain twin: per row of a [R, m] (the dot form: of a * c, rounded in
    a's dtype), widened to ``acc_dtype`` (default a's), the sum by
    ``group_sum.cu``'s pairwise tree (while m > 1: h = ceil(m / 2),
    x[j] + x[j + h] for j < m - h, x[h - 1] kept where m is odd) written
    as elementwise ops on the [R, m] view. Each add rounds each element
    on its own, so a row's bits are fixed by the tree alone, whatever R,
    the device or the thread count. Returns [R]."""
    x = a if c is None else a * c
    x = x.to(acc_dtype or a.dtype)
    m = x.shape[-1]
    while m > 1:
        h = (m + 1) // 2
        s = x[..., :m - h] + x[..., h:m]
        x = s if m == 2 * h else torch.cat([s, x[..., m - h:h]], dim=-1)
        m = h
    return x[..., 0]


def group_sum(a, c=None, acc_dtype=None):
    """Per row of a [R, m] (f32 or f64), its sum (``c`` None) or its dot
    with c (same shape and dtype), accumulated in ``acc_dtype`` (default
    a's; an f64 operand takes f64): ``group_sum.cu`` for CUDA tensors (one
    launch; a row's bits the same at any R), the twin for CPU ones. Same
    result as ``group_sum_plain``, bit for bit."""
    acc = acc_dtype or a.dtype
    if not _on_cuda(a, c):
        return group_sum_plain(a, c, acc)
    if a.dim() != 2 or (c is not None and c.shape != a.shape):
        raise ValueError(f"group_sum: a {tuple(a.shape)}, c "
                         f"{None if c is None else tuple(c.shape)}: "
                         "expected [R, m] (and c of a's shape)")
    _check("group_sum", (torch.float32, torch.float64), a=a, c=c)
    if acc not in (torch.float32, torch.float64) or (
            a.dtype == torch.float64 and acc != torch.float64):
        raise TypeError(f"group_sum: {a.dtype} operands accumulate in f32 "
                        f"or f64 (f64 ones in f64), not {acc}")
    R, m = a.shape
    if not 1 <= m <= GROUP_SUM_MAX:
        raise ValueError(f"group_sum: rows of {m} values: the kernel takes "
                         f"1 .. {GROUP_SUM_MAX}")
    out = torch.empty((R,), dtype=acc, device=a.device)
    if R == 0:
        return out
    _launch("group_sum", a.device, a.data_ptr(),
            None if c is None else c.data_ptr(), out.data_ptr(), R, m,
            int(a.dtype == torch.float64), int(acc == torch.float64))
    launches["group_sum"] += 1
    return out
