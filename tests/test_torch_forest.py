"""Port parity for the forest's modules and the two forest kernels' twins.

The same topology and the same numpy inputs (from a seed) go through the
JAX package and the port at f64:

* halo labs of every table set (vec3, vec1, sca1, vec1t, sca1t) on the
  two-level forest of tests/test_amr.py and on the multilevel forest of
  validation/poisson_ab.py: <= 1e-12;
* the structured makeFlux operator, the flux correction with each deposit
  kind, the DCT-II base solve, the two-level transfers, one forest FAS
  cycle (V and F) and one regrid: <= 1e-10.

The twins of the lab-RHS and block-Jacobi kernels against the Pallas
kernels run in interpret mode at f32 (<= 1e-6 relative) and against the
XLA compositions at f64 (<= 1e-12)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import flux as jflux  # noqa: E402
from cup2d_tpu import halo as jhalo  # noqa: E402
from cup2d_tpu import poisson as jpois  # noqa: E402
from cup2d_tpu.amr import AMRSim as JSim  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.ops import pallas_kernels as pk  # noqa: E402
from cup2d_tpu.ops import stencil as jst  # noqa: E402
from cup2d_tpu_torch import flux as tflux  # noqa: E402
from cup2d_tpu_torch import halo as thalo  # noqa: E402
from cup2d_tpu_torch import poisson as tpois  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     forest_from_numpy, forest_to_numpy)
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from validation.poisson_ab import build_multilevel_sim  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAB_BAR = 1e-12
OP_BAR = 1e-10
TWIN_F32_REL = 1e-6
KINDS = ["vec3", "vec1", "sca1", "vec1t", "sca1t"]


def _pair(js):
    """The port twin of JAX sim ``js`` (same config and topology, carried
    through convert.py), both refreshed with the startup maps built."""
    js.sync_fields()
    ts = TSim(config_from_dict(dataclasses.asdict(js.cfg)), shapes=[],
              device="cpu")
    forest_from_numpy(ts, js.forest.blocks,
                      {k: np.asarray(v) for k, v in js.forest.fields.items()})
    js.step_count = ts.step_count = 0
    js._tables_version = -1
    js._refresh()
    ts._refresh()
    assert js._npad_hwm == ts._npad_hwm and js._n_real == ts._n_real
    return js, ts


def _two_level():
    cfg = SimConfig(bpdx=2, bpdy=2, level_max=3, level_start=1,
                    extent=1.0, dtype="float64")
    js = JSim(cfg, shapes=[])
    f = js.forest
    f.release(1, 1, 1)
    for a in (0, 1):
        for b in (0, 1):
            f.allocate(2, 2 + a, 2 + b)
    return _pair(js)


@pytest.fixture(scope="module", params=["two_level", "multilevel"])
def pair(request):
    if request.param == "two_level":
        return _two_level()
    return _pair(build_multilevel_sim(dtype="float64"))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _n(js):
    return js._npad_hwm


@pytest.mark.parametrize("kind", KINDS)
def test_halo_labs_match_jax(pair, kind):
    js, ts = pair
    dim = 2 if kind.startswith("vec") else 1
    x = _rand((_n(js), dim, 8, 8), 1)
    a = np.asarray(jhalo.assemble_labs_ordered(jnp.asarray(x),
                                               js._tables[kind]))
    b = thalo.assemble_labs_ordered(torch.tensor(x), ts._tables[kind])
    assert np.abs(a - b.numpy()).max() <= LAB_BAR
    if kind.endswith("t"):
        # the regrid's slot-layout form (different slot numbering in the
        # two forests: feed each its own slots of the same ordered data)
        fj = np.zeros((js.forest.capacity, dim, 8, 8))
        fj[js._order] = x[:js._n_real]
        ft = np.zeros((ts.forest.capacity, dim, 8, 8))
        ft[ts._order] = x[:ts._n_real]
        a = np.asarray(jhalo.assemble_labs(jnp.asarray(fj), js._order_j,
                                           js._tables[kind]))
        b = thalo.assemble_labs(torch.tensor(ft), ts._order_j,
                                ts._tables[kind])
        n = js._n_real
        assert np.abs(a[:n] - b.numpy()[:n]).max() <= LAB_BAR


def test_poisson_operator_matches_jax(pair):
    js, ts = pair
    x = _rand((_n(js), 8, 8), 2)
    a = np.asarray(jflux.poisson_apply_structured(jnp.asarray(x),
                                                  js._tables["pois"]))
    b = tflux.poisson_apply_structured(torch.tensor(x), ts._tables["pois"])
    assert np.abs(a - b.numpy()).max() <= OP_BAR


@pytest.mark.parametrize("deposit", ["diffusive", "divergence", "gradient"])
def test_flux_correction_matches_jax(pair, deposit):
    js, ts = pair
    n = _n(js)
    vals3 = _rand((n, 8, 8), 3)
    vals4 = _rand((n, 2, 8, 8), 4)
    fac = _rand((n,), 5)
    if deposit == "diffusive":
        lab = _rand((n, 2, 14, 14), 6)
        dj = jflux.diffusive_deposits(jnp.asarray(lab), 3, 0.37)
        dt = tflux.diffusive_deposits(torch.tensor(lab), 3, 0.37)
        vals = vals4
    elif deposit == "divergence":
        lab = _rand((n, 2, 10, 10), 7)
        dj = jflux.divergence_deposits(jnp.asarray(lab), None, None,
                                       jnp.asarray(fac))
        dt = tflux.divergence_deposits(torch.tensor(lab), None, None,
                                       torch.tensor(fac))
        vals = vals3
    else:
        lab = _rand((n, 10, 10), 8)
        dj = jflux.gradient_deposits(jnp.asarray(lab), jnp.asarray(fac))
        dt = tflux.gradient_deposits(torch.tensor(lab), torch.tensor(fac))
        vals = vals4
    assert np.abs(np.asarray(dj) - dt.numpy()).max() <= OP_BAR
    a = np.asarray(jflux.apply_flux_corr(jnp.asarray(vals), dj, js._corr))
    b = tflux.apply_flux_corr(torch.tensor(vals), dt, ts._corr)
    assert np.abs(a - b.numpy()).max() <= OP_BAR


def test_flux_correction_segments_repeat_no_destination(pair):
    """The port's correction rows are the JAX package's rows, reordered
    into two ``index_add`` segments in which no real destination repeats
    (so the card's atomics add in a fixed order): each corner cell's
    second face sits in the second segment."""
    js, ts = pair
    t = ts._corr
    m = int(t.valid.sum())
    assert m == int(np.asarray(js._corr.valid).sum())
    k = t.n_first
    dest = t.dest.numpy()
    assert len(np.unique(dest[:k])) == k
    assert len(np.unique(dest[k:m])) == m - k
    assert np.isin(dest[k:m], dest[:k]).all()
    fields = ("dest", "cidx", "fidx1", "fidx2")
    rows_t = sorted(zip(*(getattr(t, f).numpy()[:m].tolist()
                          for f in fields)))
    rows_j = sorted(zip(*(np.asarray(getattr(js._corr, f))[:m].tolist()
                          for f in fields)))
    assert rows_t == rows_j


def test_coarse_dct_solve_matches_jax():
    ops_j = jpois.dct_neumann_operators(16, 32, dtype=np.float64)
    ops_t = tpois.dct_neumann_operators(16, 32, dtype=np.float64)
    for a, b in zip(ops_j, ops_t):
        assert np.array_equal(a, b)
    rc = _rand((16, 32), 9)
    a = np.asarray(jpois.coarse_neumann_solve_dct(
        jnp.asarray(rc), tuple(jnp.asarray(o) for o in ops_j), 0.01))
    b = tpois.coarse_neumann_solve_dct(
        torch.tensor(rc), tuple(torch.tensor(o) for o in ops_t), 0.01)
    assert np.abs(a - b.numpy()).max() <= OP_BAR


def test_two_level_transfers_match_jax(pair):
    js, ts = pair
    dj, ij = js._coarse_transfers(js._use_coarse(True))
    dt, it = ts._coarse_transfers(ts._use_coarse(True))
    r = _rand((_n(js), 8, 8), 10)
    r[js._n_real:] = 0.0
    a = np.asarray(dj(jnp.asarray(r)))
    b = dt(torch.tensor(r)).numpy()
    assert np.abs(a - b).max() <= OP_BAR
    ec = _rand(a.shape, 11)
    a = np.asarray(ij(jnp.asarray(ec), jnp.asarray(r)))
    b = it(torch.tensor(ec), torch.tensor(r)).numpy()
    assert np.abs(a - b).max() <= OP_BAR


@pytest.mark.parametrize("cycle", ["v", "f"])
def test_forest_fas_cycle_matches_jax(pair, cycle):
    js, ts = pair

    def aj(v):
        return jflux.poisson_apply_structured(v, js._tables["pois"])

    def at(v):
        return tflux.poisson_apply_structured(v, ts._tables["pois"])

    hj, ht = js._hsq_flat, ts._hsq_flat
    cj = jnp.where(hj > 0, 1.0 / jnp.where(hj > 0, hj, 1.0), 0.0)
    ct = torch.where(ht > 0, 1.0 / torch.where(ht > 0, ht, 1.0), 0.0)
    mj = jpois.ForestFASCycle(
        aj, js._fas_block_smoother(aj, js._tables["pois"]),
        *js._fas_transfers(js._use_coarse(True)), cj)
    mt = tpois.ForestFASCycle(
        at, ts._fas_block_smoother(at),
        *ts._fas_transfers(ts._use_coarse(True)), ct)
    r = _rand((_n(js), 8, 8), 12)
    r[js._n_real:] = 0.0
    if cycle == "v":
        a, b = mj(jnp.asarray(r)), mt(torch.tensor(r))
    else:
        a, b = mj.fcycle(jnp.asarray(r)), mt.fcycle(torch.tensor(r))
    assert np.abs(np.asarray(a) - b.numpy()).max() <= OP_BAR


def _ordered(sim, jax_side):
    sim.sync_fields()
    o = sim.forest.order()
    f = sim.forest
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in o]
    get = (lambda a: np.asarray(a)[o]) if jax_side else \
        (lambda a: a.numpy()[o])
    return keys, {k: get(v) for k, v in f.fields.items()}


def test_regrid_matches_jax():
    """One refine + compress dispatch on a linear-plus-noise field:
    equal topologies and prolonged/restricted fields."""
    js, ts = _two_level()
    bs = 8
    for sim, jax_side in ((js, True), (ts, False)):
        f = sim.forest
        vals = np.zeros((f.capacity, 2, bs, bs))
        for (l, i, j), s in f.blocks.items():
            seed = 100 * l + 10 * i + j
            vals[s] = _rand((2, bs, bs), seed)
        f.fields["vel"] = jnp.asarray(vals) if jax_side else \
            torch.tensor(vals)
        sim._refresh()
        sim._apply_regrid([(1, 0, 0)],
                          [[(2, 2, 2), (2, 3, 2), (2, 2, 3), (2, 3, 3)]])
    kj, fj = _ordered(js, True)
    kt, ft = _ordered(ts, False)
    assert kj == kt
    for k in fj:
        assert np.abs(fj[k] - ft[k]).max() <= OP_BAR


def test_convert_forest_round_trip():
    js, ts = _two_level()
    blocks, fields = forest_to_numpy(ts)
    assert set(blocks) == set(js.forest.blocks)
    back = TSim(ts.cfg, shapes=[], device="cpu")
    forest_from_numpy(back, blocks, fields)
    k1, f1 = _ordered(ts, False)
    k2, f2 = _ordered(back, False)
    assert k1 == k2
    for k in f1:
        assert np.array_equal(f1[k], f2[k])


def _labs_h(n, dtype, seed):
    lab = _rand((n, 2, 14, 14), seed).astype(dtype)
    h = np.asarray([1 / 64, 1 / 128, 1 / 32, 1.0])[np.arange(n) % 4]
    return lab, h.astype(dtype).reshape(n, 1, 1, 1)


def test_lab_rhs_twin_vs_pallas_interpret_f32():
    lab, h = _labs_h(16, np.float32, 13)
    dt = np.float32(0.5 / 128)
    ref = np.asarray(pk.fused_lab_rhs(jnp.asarray(lab), jnp.asarray(h),
                                      4e-5, jnp.asarray(dt),
                                      interpret=True))
    got = hk.fused_lab_rhs(torch.tensor(lab), torch.tensor(h), 4e-5,
                           torch.tensor(dt)).numpy()
    assert np.abs(got - ref).max() <= TWIN_F32_REL * np.abs(ref).max()


def test_lab_rhs_twin_vs_xla_f64():
    lab, h = _labs_h(24, np.float64, 14)
    dt = 0.5 / 128
    ref = np.asarray(jst.advect_diffuse_rhs(jnp.asarray(lab), 3,
                                            jnp.asarray(h), 4e-5, dt))
    got = hk.fused_lab_rhs(torch.tensor(lab), torch.tensor(h), 4e-5,
                           torch.tensor(dt)).numpy()
    assert np.abs(got - ref).max() <= LAB_BAR


def _jacobi_operands(dtype, seed):
    e, r, lap = (_rand((40, 8, 8), seed + k).astype(dtype)
                 for k in range(3))
    p_inv = tpois.block_precond_matrix(8, dtype=dtype)
    return e, r, lap, p_inv


def test_block_jacobi_twin_vs_pallas_interpret_f32():
    e, r, lap, p = _jacobi_operands(np.float32, 20)
    ref = np.asarray(pk.fused_block_jacobi_update(
        *(jnp.asarray(a) for a in (e, r, lap, p)), interpret=True))
    got = hk.fused_block_jacobi_update(
        *(torch.tensor(a) for a in (e, r, lap, p))).numpy()
    assert np.abs(got - ref).max() <= TWIN_F32_REL * np.abs(ref).max()


@pytest.mark.parametrize("n", [1, 33])
def test_block_jacobi_twin_vs_pallas_interpret_block_counts_f32(n):
    """One block, and a count that is no multiple of the card kernel's
    32-block tile."""
    e, r, lap = (_rand((n, 8, 8), 50 + k).astype(np.float32)
                 for k in range(3))
    p = tpois.block_precond_matrix(8, dtype=np.float32)
    ref = np.asarray(pk.fused_block_jacobi_update(
        *(jnp.asarray(a) for a in (e, r, lap, p)), interpret=True))
    got = hk.fused_block_jacobi_update(
        *(torch.tensor(a) for a in (e, r, lap, p))).numpy()
    assert np.abs(got - ref).max() <= TWIN_F32_REL * np.abs(ref).max()


def test_block_jacobi_twin_vs_xla_f64():
    e, r, lap, p = _jacobi_operands(np.float64, 30)
    ref = np.asarray(jnp.asarray(e) + jpois.apply_block_precond_blocks(
        jnp.asarray(r) - jnp.asarray(lap), jnp.asarray(p)))
    got = hk.fused_block_jacobi_update(
        *(torch.tensor(a) for a in (e, r, lap, p))).numpy()
    assert np.abs(got - ref).max() <= LAB_BAR


def test_forest_kernels_count_only_on_the_card():
    """On CPU tensors the wrappers run their twins and count nothing."""
    hk.reset_launches()
    lab, h = _labs_h(4, np.float32, 40)
    hk.fused_lab_rhs(torch.tensor(lab), torch.tensor(h), 4e-5, 1e-3)
    e, r, lap, p = _jacobi_operands(np.float32, 41)
    hk.fused_block_jacobi_update(*(torch.tensor(a) for a in (e, r, lap, p)))
    assert hk.launches["fused_lab_rhs"] == 0
    assert hk.launches["fused_block_jacobi_update"] == 0
