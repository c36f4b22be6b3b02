"""The slab-list halo sweep: one sweep over every slab of a device in one
launch, each slab reading its neighbours' edge columns in place
(``hopper_kernels.jacobi_halo_sweep_slabs``, taken by
``shard_halo.overlap_jacobi_sweeps`` on a one-device mesh). On the CPU
its twin runs; the kernel runs on the card (tests/test_torch_cuda.py).

* ``overlap_jacobi_sweeps`` on a CPU mesh equals the per-slab sequence it
  replaced (``exchange_x`` of one column, then the per-slab sweep twin)
  bit for bit: f64, f32 and bf16, Neumann and the channel's signs
  (1, -1, 1, 1), D = 1, 2, 4, slab widths that are no whole 16-byte
  word, a member stack, from zero and from e; no exchange runs and each
  sweep counts once.
* Slabs of unequal widths: the same, and the whole-field chain's twin.
* The Neumann forms against the JAX package's ``_jacobi_halo_kernel``
  (``fused_jacobi_halo_sweep``, interpret mode) per shard: the same
  per-cell expression on the same operands, which XLA's CPU backend
  evaluates with fused multiply-adds where the twin rounds each
  operation, so f32 is held to 1e-6 relative to max |ref| (the bar of
  tests/test_torch_shard_kernels.py; ~2e-7 seen) and bf16 to one bf16 ulp
  (2^-7 of max |ref|) with at least 99% of the values bit-equal.
* Each C entry point of a kernel form takes the arguments its wrapper
  passes; the lab RHS's reconstruction count (``ops.timing``)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.ops import pallas_kernels as jpk  # noqa: E402
from cup2d_tpu_torch.kernel_ab import _arity, wind_field  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.ops.timing import (OPS_LAB_RHS_REST,  # noqa: E402
                                        OPS_WENO_FACE, advect_rhs_ops,
                                        lab_weno_faces)
from cup2d_tpu_torch.parallel import shard_halo as sh  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cup2d_tpu_torch.parallel.shard_halo import (  # noqa: E402
    Slabs, exchange_x, gather_x, overlap_jacobi_sweeps, split_x)

SIGNS = (1.0, -1.0, 1.0, 1.0)     # the channel's pressure signs
OMEGA = 0.8
NSWEEPS = 3


def _rand(shape, seed, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(a, dtype=torch.float64).to(dtype)


def per_slab_sweeps(e, r, n, from_zero, signs):
    """n sweeps as every sweep ran before the slab list: one edge column
    exchanged, then the per-slab twin on every slab."""
    bf16 = r.dtype == torch.bfloat16
    twin = (hk.jacobi_halo_sweep_bf16_plain if bf16
            else hk.jacobi_halo_sweep_plain)
    D = len(r.parts)
    walls = [(d == 0, d == D - 1) for d in range(D)]
    for k in range(n):
        if from_zero and k == 0:
            e = Slabs([twin(None, rp, None, OMEGA, lo, hi, True, signs)
                       for rp, (lo, hi) in zip(r.parts, walls)], r.mesh)
            continue
        aux = exchange_x(e, 1)
        e = Slabs([twin(ep, rp, aux[d], OMEGA, lo, hi, False, signs)
                   for d, (ep, rp, (lo, hi))
                   in enumerate(zip(e.parts, r.parts, walls))], r.mesh)
    return e


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("signs", [None, SIGNS])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("from_zero", [False, True])
def test_slab_list_equals_the_per_slab_sequence(dtype, signs, D,
                                                from_zero):
    # 52 columns: slabs of 52, 26 and 13, none a whole number of 16-byte
    # words in every dtype; two members
    e = _rand((2, 24, 52), 1, dtype)
    r = _rand((2, 24, 52), 2, dtype)
    mesh = make_mesh(devices=["cpu"] * D)
    es, rs = split_x(e, mesh), split_x(r, mesh)
    sh.sweep_stats.update(sweeps=0, exchanges=0)
    hk.reset_launches()
    got = overlap_jacobi_sweeps(es, rs, OMEGA, NSWEEPS, from_zero,
                                edge_signs=signs)
    assert sh.sweep_stats == {"sweeps": NSWEEPS, "exchanges": 0}
    assert hk.launches == {k: 0 for k in hk.launches}
    ref = per_slab_sweeps(es, rs, NSWEEPS, from_zero, signs)
    for g, p in zip(got.parts, ref.parts):
        assert g.dtype == dtype
        assert torch.equal(g, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("signs", [None, SIGNS])
def test_slab_list_of_unequal_widths(dtype, signs):
    """Slabs of 5, 12 and 7 columns (a mesh that split_x would not make):
    the per-slab sequence and the whole field's chain twin, bit for bit."""
    e = _rand((20, 24), 3, dtype)
    r = _rand((20, 24), 4, dtype)
    mesh = make_mesh(devices=["cpu"] * 3)
    cuts = [(0, 5), (5, 17), (17, 24)]
    es = Slabs([e[:, a:b].contiguous() for a, b in cuts], mesh)
    rs = Slabs([r[:, a:b].contiguous() for a, b in cuts], mesh)
    chain = (hk.jacobi_sweeps_bf16_plain if dtype == torch.bfloat16
             else hk.jacobi_sweeps_plain)
    for fz in (False, True):
        got = overlap_jacobi_sweeps(es, rs, OMEGA, NSWEEPS, fz,
                                    edge_signs=signs)
        ref = per_slab_sweeps(es, rs, NSWEEPS, fz, signs)
        for g, p in zip(got.parts, ref.parts):
            assert torch.equal(g, p)
        assert torch.equal(gather_x(got),
                           chain(e, r, OMEGA, NSWEEPS, fz, signs))


def test_plain_sweeps_keep_the_exchange():
    """``fused=False`` (the bf16 preconditioner's plain sweeps) stays an
    exchange and the plain twin per slab, and counts as no kernel
    sweep."""
    mesh = make_mesh(devices=["cpu"] * 4)
    e = split_x(_rand((16, 32), 5, torch.bfloat16), mesh)
    r = split_x(_rand((16, 32), 6, torch.bfloat16), mesh)
    sh.sweep_stats.update(sweeps=0, exchanges=0)
    got = overlap_jacobi_sweeps(e, r, OMEGA, 2, fused=False)
    assert sh.sweep_stats == {"sweeps": 0, "exchanges": 0}
    aux = exchange_x(e, 1)
    one = Slabs([hk.jacobi_halo_sweep_plain(ep, rp, aux[d], OMEGA, d == 0,
                                            d == 3)
                 for d, (ep, rp) in enumerate(zip(e.parts, r.parts))],
                mesh)
    aux = exchange_x(one, 1)
    for d in range(4):
        assert torch.equal(got.parts[d], hk.jacobi_halo_sweep_plain(
            one.parts[d], r.parts[d], aux[d], OMEGA, d == 0, d == 3))


def test_slab_list_wrapper_on_the_cpu_is_its_twin():
    es = [_rand((8, 12), 7 + d) for d in range(3)]
    rs = [_rand((8, 12), 17 + d) for d in range(3)]
    hk.reset_launches()
    for fz in (False, True):
        got = hk.jacobi_halo_sweep_slabs(es, rs, OMEGA, fz, SIGNS)
        ref = hk.jacobi_halo_sweep_slabs_plain(es, rs, OMEGA, fz, SIGNS)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert hk.launches == {k: 0 for k in hk.launches}
    assert not hk._fns, "a CPU call must not build or load a kernel"


_jitted = {}


def _pallas_sweep(e, r, aux, info):
    key = (e.shape, str(e.dtype))
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda e, r, a, i: jpk.fused_jacobi_halo_sweep(
            e, r, a, i, OMEGA, interpret=True))
    return np.asarray(_jitted[key](e, r, aux, info).astype(jnp.float32))


@pytest.mark.skipif(not jpk.HAVE_PALLAS,
                    reason="needs jax.experimental.pallas")
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_slab_list_vs_pallas_halo_kernel(bf16, D):
    """One sweep of the slab list against the JAX package's per-shard
    halo kernel on each slab (aux lane-padded to 128 columns there), the
    Neumann forms, f32 and bf16."""
    ny, nx = 32, 64
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    e = _rand((ny, nx), 30 + D, tdt)
    r = _rand((ny, nx), 40 + D, tdt)
    mesh = make_mesh(devices=["cpu"] * D)
    got = overlap_jacobi_sweeps(split_x(e, mesh), split_x(r, mesh), OMEGA,
                                1)
    ef = e.float().numpy()
    rf = r.float().numpy()
    w = nx // D
    for d in range(D):
        sl = slice(d * w, (d + 1) * w)
        aux = np.zeros((ny, 128), np.float32)
        if d > 0:
            aux[:, 0] = ef[:, d * w - 1]
        if d < D - 1:
            aux[:, 1] = ef[:, (d + 1) * w]
        info = np.asarray([[d == 0, d == D - 1]], np.int32)
        ref = _pallas_sweep(jnp.asarray(ef[:, sl], jdt),
                            jnp.asarray(rf[:, sl], jdt),
                            jnp.asarray(aux, jdt), jnp.asarray(info))
        g = got.parts[d].float().numpy()
        rel = np.max(np.abs(g - ref)) / np.max(np.abs(ref))
        if bf16:
            assert rel <= 2.0 ** -7 and np.mean(g == ref) >= 0.99, d
        else:
            assert rel <= 1e-6, (d, rel)


@pytest.mark.parametrize("key", sorted(hk._FORM_ENTRIES))
def test_form_entry_points_take_the_arguments_their_wrappers_pass(key):
    """ctypes passes what argtypes lists: a count that differs from the C
    signature shifts every later argument (the stream last)."""
    stem, name, argtypes = hk._FORM_ENTRIES[key]
    src = (hk._CSRC / f"{stem}.cu").read_text()
    assert _arity(src, name) == len(argtypes)


@pytest.mark.parametrize("pattern", ["normal", "checker", "positive"])
def test_lab_weno_faces_counts_each_face_once_where_its_winds_agree(
        pattern):
    """A lab's 8 x 8 block has 9 faces a row and column per component; an
    interior face is reconstructed twice where its two cells' winds differ
    in sign (u along x, v along y)."""
    lab = wind_field((5, 2, 14, 14), pattern, 3, "cpu")
    u = lab[:, 0, 3:11, 3:11] > 0
    v = lab[:, 1, 3:11, 3:11] > 0
    brute = 0
    for b in range(5):
        for y in range(8):
            for f in range(9):
                brute += 1 + (0 < f < 8 and bool(u[b, y, f - 1] != u[b, y, f]))
                brute += 1 + (0 < f < 8 and bool(v[b, f - 1, y] != v[b, f, y]))
    # the count per component; both components share the winds
    assert lab_weno_faces(lab) == 2 * brute
    if pattern == "positive":
        assert brute == 5 * 2 * 8 * 9
    if pattern == "checker":
        assert brute == 5 * 2 * 8 * 16
    assert advect_rhs_ops(lab) == 2 * (OPS_WENO_FACE * brute
                                       + OPS_LAB_RHS_REST * 5 * 64)
