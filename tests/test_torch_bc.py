"""Port parity for the boundary-condition tables (``cup2d_tpu_torch.bc``)
and the per-face stencil forms (``ops.stencil.*_bc``).

* Tables: tokens, flags, validation errors, ``pressure_signs``,
  ``divergence_coeffs``, ``periodic_axes`` and ``divergence_affine_bc``
  equal to the JAX package's for every kind (cf. tests/test_bc.py).
* ``pad_vector_bc`` for every kind, corners included (moving lid, clamped
  parabolic inflow on an x face and on a y face, outflow with and without
  dt and with per-member dt, periodic, the mixed periodic channel): f64
  within 1e-12 of JAX; the free-slip table is ``pad_vector`` bit for bit.
* The four ``_bc`` stencils for every sign set, wrap included: f64 within
  1e-12 of JAX; all-(+1) (and the free-slip divergence coefficients) give
  the Neumann forms bit for bit.
* ``convert.bc_from_fields`` carries a JAX table over."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import bc as jbc  # noqa: E402
from cup2d_tpu import cases as jcases  # noqa: E402
from cup2d_tpu.ops import stencil as jst  # noqa: E402
from cup2d_tpu_torch import bc as tbc  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch.convert import bc_from_fields  # noqa: E402
from cup2d_tpu_torch.ops import stencil as tst  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64_BAR = 1e-12


def _tables(pkg, cases):
    """The same named tables built by one package's constructors."""
    return {
        "free_slip": pkg.FREE_SLIP,
        "cavity": cases.cavity_table(0.7),
        "channel": cases.channel_table(0.2),
        "channel_parabolic": cases.channel_table(0.4, profile="parabolic"),
        # parabolic inflow through a y face (normal component v), outflow
        # opposite, no-slip x walls reading the y-painted corners
        "outflow_y": pkg.BCTable(pkg.no_slip(), pkg.no_slip(),
                                 pkg.dirichlet_inflow(0.1, 0.6,
                                                      profile="parabolic"),
                                 pkg.convective_outflow()),
        # wall-normal moving walls: the affine divergence term on x and y
        "normal_walls": pkg.BCTable(pkg.no_slip(0.3, 0.2),
                                    pkg.dirichlet_inflow(-0.5),
                                    pkg.no_slip(0.1, -0.4),
                                    pkg.free_slip()),
        "periodic": cases.periodic_table(),
        "periodic_channel": cases.periodic_channel_table(),
    }


NAMES = sorted(_tables(tbc, tcases))


def _pair(name):
    return _tables(jbc, jcases)[name], _tables(tbc, tcases)[name]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("name", NAMES)
def test_table_semantics_match_jax(name):
    j, t = _pair(name)
    assert t.token == j.token
    assert t.is_free_slip == j.is_free_slip
    assert t.all_neumann == j.all_neumann
    assert tbc.pressure_signs(t) == jbc.pressure_signs(j)
    assert tbc.divergence_coeffs(t) == jbc.divergence_coeffs(j)
    assert tbc.periodic_axes(t) == jbc.periodic_axes(j)
    assert bc_from_fields(j) == t
    ja = jbc.divergence_affine_bc(j, 6, 10, jnp.float64)
    ta = tbc.divergence_affine_bc(t, 6, 10, torch.float64)
    assert (ja is None) == (ta is None)
    if ja is not None:
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=F64_BAR)


@pytest.mark.parametrize("build", [
    lambda m: m.BCTable(x_lo=m.free_slip()._replace(kind="bogus")),
    lambda m: m.BCTable(x_lo=m.periodic()),
    lambda m: m.BCTable(y_hi=m.periodic()),
])
def test_validation_errors_match_jax(build):
    with pytest.raises(ValueError) as je:
        build(jbc).validate()
    with pytest.raises(ValueError) as te:
        build(tbc).validate()
    assert str(te.value) == str(je.value)


def test_inflow_profile_refusal_matches_jax():
    for m in (jbc, tbc):
        with pytest.raises(ValueError, match="uniform|parabolic"):
            m.dirichlet_inflow(1.0, profile="plug")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dt", [None, "scalar", "members"])
def test_pad_vector_bc_matches_jax(name, dt):
    """Every paint kind with its corners, g = 3 (the substage's) on a
    field whose edge and inner lines differ, at f64."""
    j, t = _pair(name)
    L, ny, nx, h = 3, 10, 14, 0.1
    v = _rand((L, 2, ny, nx), 1)
    if dt == "scalar":
        jdt = tdt = 0.04
    elif dt == "members":
        d = np.asarray([0.04, 0.2, 0.07])[:, None, None, None]
        jdt, tdt = jnp.asarray(d), torch.tensor(d)
    else:
        jdt = tdt = None
    ref = np.asarray(jbc.pad_vector_bc(jnp.asarray(v), 3, j, h, jdt))
    got = tbc.pad_vector_bc(torch.tensor(v), 3, t, h, tdt).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=F64_BAR)


def test_pad_free_slip_table_is_pad_vector_bit_for_bit():
    v = torch.tensor(_rand((2, 6, 9), 2))
    assert torch.equal(tbc.pad_vector_bc(v, 3, tbc.FREE_SLIP, 0.1),
                       tst.pad_vector(v, 3))


# (sx_lo, sx_hi, sy_lo, sy_hi, px, py): Neumann, the channel's Dirichlet
# outflow, mixed Dirichlet faces, the periodic channel, the torus
SIGN_SETS = [(1.0, 1.0, 1.0, 1.0, False, False),
             (1.0, -1.0, 1.0, 1.0, False, False),
             (-1.0, -1.0, 1.0, -1.0, False, False),
             (0.0, 0.0, 1.0, 1.0, True, False),
             (1.0, -1.0, 0.0, 0.0, False, True),
             (0.0, 0.0, 0.0, 0.0, True, True)]


@pytest.mark.parametrize("signs", SIGN_SETS)
def test_bc_stencils_match_jax(signs):
    *s, px, py = signs
    p = _rand((2, 7, 9), 3)
    v = _rand((2, 2, 7, 9), 4)
    h, dt = 0.1, 0.03
    pairs = [
        (jst.laplacian5_bc(jnp.asarray(p), *s, px=px, py=py),
         tst.laplacian5_bc(torch.tensor(p), *s, px=px, py=py)),
        (jst.divergence_bc(jnp.asarray(v), *s, px=px, py=py),
         tst.divergence_bc(torch.tensor(v), *s, px=px, py=py)),
        (jst.pressure_gradient_update_bc(jnp.asarray(p), h, dt, *s, px=px,
                                         py=py),
         tst.pressure_gradient_update_bc(torch.tensor(p), h, dt, *s, px=px,
                                         py=py)),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=F64_BAR)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        np.testing.assert_array_equal(
            tst._shift_bc(torch.tensor(p), dy, dx, px, py).numpy(),
            np.asarray(jst._shift_bc(jnp.asarray(p), dy, dx, px, py)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bc_stencils_at_neumann_signs_are_the_neumann_forms(dtype):
    p = torch.tensor(_rand((7, 9), 5), dtype=dtype)
    v = torch.tensor(_rand((2, 7, 9), 6), dtype=dtype)
    assert torch.equal(tst.laplacian5_bc(p, 1.0, 1.0, 1.0, 1.0),
                       tst.laplacian5_neumann(p))
    assert torch.equal(tst.divergence_bc(v, 1.0, -1.0, 1.0, -1.0),
                       tst.divergence_freeslip(v))
    assert torch.equal(
        tst.pressure_gradient_update_bc(p, 0.1, 0.03, 1.0, 1.0, 1.0, 1.0),
        tst.pressure_gradient_update_fused(p, 0.1, 0.03))
    assert torch.equal(
        tst.inv_diag_bc(7, 9, dtype, p.device, (1.0, 1.0, 1.0, 1.0)),
        tst.inv_diag_neumann(7, 9, dtype, p.device))
