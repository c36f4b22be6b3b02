"""Port parity: the shape models and the obstacle, collision and force
operators of the shaped uniform step against the JAX package on the same
seeded numpy inputs.

f64 bar 1e-12 for every operator (both sides evaluate the same
expressions; only the order of the reductions can differ). The models'
host state is held bit for bit after 20 advect/midline calls. Also: the
window scatters' clamp, the first-index rule of argmin/argmax on a tie,
the sum on ties of the combined udef, and the force pass's clamped
gathers where the probe walk and its stencils reach past the lab. The
forest's packed forms (the segment and midline tables, their SDF and
udef, a midline tie) and its batched force pass (``surface_forces_blocks``
at G = 4 with a per-block h), at the same bar."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.models import DiskShape as JDisk  # noqa: E402
from cup2d_tpu.models import FishShape as JFish  # noqa: E402
from cup2d_tpu.ops import collision as jc  # noqa: E402
from cup2d_tpu.ops import forces as jf  # noqa: E402
from cup2d_tpu.ops import obstacle as jo  # noqa: E402
from cup2d_tpu.sim import ObstacleFields as JObs  # noqa: E402
from cup2d_tpu.sim import Simulation as JSim  # noqa: E402
from cup2d_tpu_torch.convert import (copy_shape_state,  # noqa: E402
                                     obstacle_from_numpy, obstacle_to_numpy)
from cup2d_tpu_torch.models import DiskShape, FishShape  # noqa: E402
from cup2d_tpu_torch.ops import collision as tc  # noqa: E402
from cup2d_tpu_torch.ops import forces as tf  # noqa: E402
from cup2d_tpu_torch.ops import obstacle as to  # noqa: E402
from cup2d_tpu_torch.sim import ObstacleFields, Simulation  # noqa: E402

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
EXTENTS = (4.0, 2.0)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(j, t, bar=F64_BAR, rel=False):
    j = np.asarray(j)
    t = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == bool:
        assert np.array_equal(j, t)
        return
    err = np.max(np.abs(j - t)) if j.size else 0.0
    scale = max(np.max(np.abs(j)), 1.0) if rel else 1.0
    assert err <= bar * scale, err


def _fish(cls, time=0.3):
    f = cls(0.2, 1.8, 0.8, 30.0, 4.0 / 256)
    f.advect(0.0, EXTENTS)
    f.midline(time)
    return f


def _window(ox=40, oy=50, wx=44, wy=36, h=4.0 / 256):
    x, y = jo.window_coords(ox, oy, wx, wy, h, jnp.float64)
    return np.asarray(x), np.asarray(y)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _host_state(shape):
    out = {}
    for k, v in vars(shape).items():
        if hasattr(v, "__dict__"):
            out.update({f"{k}.{a}": b for a, b in vars(v).items()})
        else:
            out[k] = v
    return out


def _bit_equal(a, b):
    sa, sb = _host_state(a), _host_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        x, y = np.asarray(sa[k]), np.asarray(sb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert x.tobytes() == y.tobytes(), k


def test_models_host_state_bit_equal_after_20_steps():
    rng = _rng(0)
    pairs = [(JFish(0.2, 1.8, 0.8, 0.0, 0.25), FishShape(0.2, 1.8, 0.8, 0.0,
                                                         0.25)),
             (JFish(0.3, 2.0, 1.0, 180.0, 4.0 / 512, period=0.8),
              FishShape(0.3, 2.0, 1.0, 180.0, 4.0 / 512, period=0.8)),
             (JDisk(0.1, 1.0, 1.0), DiskShape(0.1, 1.0, 1.0))]
    t = 0.0
    for _ in range(20):
        dt = float(0.01 + 0.02 * rng.random())
        uvw = 0.05 * rng.standard_normal(3)
        for j, p in pairs:
            for s in (j, p):
                s.u, s.v, s.omega = (float(c) for c in uvw)
                s.advect(dt, EXTENTS)
                s.midline(t)
        t += dt
    for j, p in pairs:
        _bit_equal(j, p)
        assert np.array_equal(j.surface_polygon(), p.surface_polygon())
        for a, b in zip(j.midline_comp_frame(), p.midline_comp_frame()):
            assert np.array_equal(a, b)


def test_copy_shape_state_carries_the_gait():
    """A port fish given a JAX fish's host state continues it bit for
    bit (the schedulers and the gait clock included)."""
    j = JFish(0.2, 1.8, 0.8, 0.0, 4.0 / 256)
    t = 0.0
    for _ in range(5):
        j.u, j.omega = 0.01, 0.2
        j.advect(0.03, EXTENTS)
        j.midline(t)
        t += 0.03
    p = FishShape(0.2, 1.0, 1.0, 90.0, 4.0 / 256)
    copy_shape_state(j, p)
    _bit_equal(j, p)
    for s in (j, p):
        s.advect(0.03, EXTENTS)
        s.midline(t)
    _bit_equal(j, p)
    with pytest.raises(TypeError, match="DiskShape"):
        copy_shape_state(j, DiskShape(0.1, 1.0, 1.0))


# ---------------------------------------------------------------------------
# ops/obstacle.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fish", "disk"])
def test_polygon_sdf(kind):
    s = _fish(JFish) if kind == "fish" else JDisk(0.1, 1.0, 0.9)
    poly = s.surface_polygon()
    c = poly.mean(axis=0)
    rng = _rng(1)
    px = c[0] + 0.15 * rng.standard_normal((30, 40))
    py = c[1] + 0.15 * rng.standard_normal((30, 40))
    _close(jo.polygon_sdf(jnp.asarray(px), jnp.asarray(py),
                          jnp.asarray(poly)),
           to.polygon_sdf(_t(px), _t(py), _t(poly)))
    # points exactly on vertices and on a horizontal edge's height
    _close(jo.polygon_sdf(jnp.asarray(poly[:, 0]), jnp.asarray(poly[:, 1]),
                          jnp.asarray(poly)),
           to.polygon_sdf(_t(poly[:, 0]), _t(poly[:, 1]), _t(poly)))


def test_midline_udef():
    f = _fish(JFish)
    mid = [np.asarray(a) for a in f.midline_comp_frame()]
    c = mid[0].mean(axis=0)
    rng = _rng(2)
    px = c[0] + 0.1 * rng.standard_normal((25, 33))
    py = c[1] + 0.1 * rng.standard_normal((25, 33))
    _close(jo.midline_udef(jnp.asarray(px), jnp.asarray(py),
                           *map(jnp.asarray, mid), jnp.asarray(f.width)),
           to.midline_udef(_t(px), _t(py), *map(_t, mid), _t(f.width)))


def test_midline_udef_tie_takes_the_first_node():
    """Points equidistant from two nodes take the first (jnp.argmin)."""
    mid_r = np.array([[-1.0, 0.0], [1.0, 0.0], [5.0, 5.0]])
    mid_v = np.array([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]])
    nor = np.array([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0]])
    vnor = np.array([[0.5, 0.0], [0.0, 0.5], [0.0, 0.0]])
    width = np.array([0.3, 0.3, 0.3])
    px = np.zeros(5)
    py = np.array([-1.0, -0.1, 0.0, 0.2, 2.0])
    got = to.midline_udef(_t(px), _t(py), _t(mid_r), _t(mid_v), _t(nor),
                          _t(vnor), _t(width))
    ref = jo.midline_udef(*map(jnp.asarray, (px, py, mid_r, mid_v, nor,
                                             vnor, width)))
    _close(ref, got, bar=0.0)
    w = np.clip(py, -0.3, 0.3)
    assert np.array_equal(got.numpy(), np.stack([1.0 + 0.5 * w,
                                                 2.0 + 0.0 * w]))


@pytest.mark.parametrize("kind", ["fish", "disk"])
def test_packed_polygon_sdf(kind):
    """The forest's packed form: the [E, 6] table equal to JAX's (both f64
    numpy), the SDF from it <= 1e-12, in a body frame (CoM subtracted)."""
    s = _fish(JFish) if kind == "fish" else JDisk(0.1, 1.0, 0.9)
    com = np.asarray(s.com, np.float64)
    poly = s.surface_polygon() - com
    seg = to.pack_polygon_segments(poly)
    assert np.array_equal(seg, jo.pack_polygon_segments(poly))
    rng = _rng(11)
    px = 0.15 * rng.standard_normal((6, 8, 8))
    py = 0.15 * rng.standard_normal((6, 8, 8))
    _close(jo.polygon_sdf_seg(jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(seg)),
           to.polygon_sdf_seg(_t(px), _t(py), _t(seg)))
    # on vertices and at a horizontal edge's height
    _close(jo.polygon_sdf_seg(jnp.asarray(poly[:, 0]),
                              jnp.asarray(poly[:, 1]), jnp.asarray(seg)),
           to.polygon_sdf_seg(_t(poly[:, 0]), _t(poly[:, 1]), _t(seg)))


def test_packed_midline_udef():
    f = _fish(JFish)
    mid_r, mid_v, mid_nor, mid_vnor = f.midline_comp_frame()
    com = np.asarray(f.com, np.float64)
    mid = to.pack_midline(mid_r - com, mid_v, mid_nor, mid_vnor, f.width)
    assert np.array_equal(mid, jo.pack_midline(mid_r - com, mid_v, mid_nor,
                                               mid_vnor, f.width))
    rng = _rng(12)
    px = 0.1 * rng.standard_normal((5, 8, 8))
    py = 0.1 * rng.standard_normal((5, 8, 8))
    _close(jo.midline_udef_packed(jnp.asarray(px), jnp.asarray(py),
                                  jnp.asarray(mid)),
           to.midline_udef_packed(_t(px), _t(py), _t(mid)))


def test_packed_midline_udef_tie_takes_the_first_node():
    mid = to.pack_midline(
        np.array([[-1.0, 0.0], [1.0, 0.0], [5.0, 5.0]]),
        np.array([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]]),
        np.array([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0]]),
        np.array([[0.5, 0.0], [0.0, 0.5], [0.0, 0.0]]),
        np.array([0.3, 0.3, 0.3]))
    px = np.zeros(5)
    py = np.array([-1.0, -0.1, 0.0, 0.2, 2.0])
    got = to.midline_udef_packed(_t(px), _t(py), _t(mid))
    ref = jo.midline_udef_packed(jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(mid))
    _close(ref, got, bar=0.0)
    w = np.clip(py, -0.3, 0.3)
    assert np.array_equal(got.numpy(), np.stack([1.0 + 0.5 * w,
                                                 2.0 + 0.0 * w]))


def test_chi_from_sdf_and_window_coords():
    rng = _rng(3)
    h = 4.0 / 256
    lab = 3 * h * rng.standard_normal((38, 46))
    own = lab[1:-1, 1:-1] + h * rng.standard_normal((36, 44))
    _close(jo.chi_from_sdf(jnp.asarray(lab), jnp.asarray(own), h),
           to.chi_from_sdf(_t(lab), _t(own), h))
    for args in ((40, 50, 44, 36), (0, 0, 7, 5)):
        jx, jy = jo.window_coords(*args, h, jnp.float64)
        tx, ty = to.window_coords(*args, h, torch.float64, "cpu")
        _close(jx, tx, bar=0.0)
        _close(jy, ty, bar=0.0)


@pytest.mark.parametrize("oy,ox", [(3, 5), (0, 0), (20, 27),
                                   (25, 40), (-4, -2)])
def test_window_scatters_clamp_as_dynamic_slice(oy, ox):
    """In range, on the edge and past it: the origin clamps so that the
    window fits, as lax.dynamic_slice / dynamic_update_slice clamp."""
    rng = _rng(4)
    field = rng.standard_normal((2, 24, 32))
    win = rng.standard_normal((2, 4, 5))
    _close(jo.scatter_window_max(jnp.asarray(field[0]), jnp.asarray(win[0]),
                                 oy, ox),
           to.scatter_window_max(_t(field[0]), _t(win[0]), oy, ox),
           bar=0.0)
    _close(jo.scatter_window_set(jnp.asarray(field), jnp.asarray(win),
                                 jnp.asarray(oy), jnp.asarray(ox)),
           to.scatter_window_set(_t(field), _t(win), oy, ox), bar=0.0)
    _close(jax.lax.dynamic_slice(jnp.asarray(field[0]), (oy, ox), (6, 7)),
           to.window_of(_t(field[0]), 6, 7, oy, ox), bar=0.0)


def _integral_inputs(seed=5):
    x, y = _window()
    rng = _rng(seed)
    chi = np.clip(rng.random(x.shape) * 1.6 - 0.3, 0.0, 1.0)
    udef = 0.1 * rng.standard_normal((2,) + x.shape)
    vel = rng.standard_normal((2,) + x.shape)
    com = np.array([x.mean(), y.mean()]) + 0.01
    return chi, udef, vel, x - com[0], y - com[1]


def test_shape_and_penalization_integrals():
    chi, udef, vel, xr, yr = _integral_inputs()
    hsq = (4.0 / 256) ** 2
    for j, t in zip(jo.shape_integrals(*map(jnp.asarray,
                                            (chi, udef, xr, yr)), hsq),
                    to.shape_integrals(*map(_t, (chi, udef, xr, yr)), hsq)):
        _close(j, t)
    lamdt = 1e7 * 2e-4
    jsum = jo.penalization_integrals(
        *map(jnp.asarray, (vel, chi, udef, xr, yr)), lamdt, hsq)
    tsum = to.penalization_integrals(
        *map(_t, (vel, chi, udef, xr, yr)), _t(lamdt), hsq)
    for j, t in zip(jsum, tsum):
        _close(j, t)
    _close(jo.solve_rigid_momentum(*jsum),
           to.solve_rigid_momentum(*[_t(np.asarray(a)) for a in jsum]))
    # no mass: zero motion, not NaN (both integral sets)
    z = np.zeros_like(chi)
    for j, t in zip(jo.shape_integrals(*map(jnp.asarray,
                                            (z, udef, xr, yr)), hsq),
                    to.shape_integrals(*map(_t, (z, udef, xr, yr)), hsq)):
        _close(j, t, bar=0.0)
    zero = [torch.tensor(0.0, dtype=torch.float64)] * 7
    assert torch.equal(to.solve_rigid_momentum(*zero),
                       torch.zeros(3, dtype=torch.float64))


def test_solve_rigid_momentum_random_systems():
    rng = _rng(6)
    for _ in range(8):
        pm = 1e-3 * (1 + rng.random())
        px, py = 1e-4 * rng.standard_normal(2)
        pj = pm * 1e-2 + (px * px + py * py) / pm
        rhs = 1e-4 * rng.standard_normal(3)
        args = [pm, pj, px, py, *rhs]
        _close(jo.solve_rigid_momentum(*map(jnp.asarray, args)),
               to.solve_rigid_momentum(*map(_t, args)), rel=True)


# ---------------------------------------------------------------------------
# ops/collision.py
# ---------------------------------------------------------------------------

def _coll_fields(S=3, ny=24, nx=28, seed=7):
    rng = _rng(seed)
    x = np.linspace(0, 1, nx)[None, :].repeat(ny, 0)
    y = np.linspace(0, 1, ny)[:, None].repeat(nx, 1)
    chi = np.clip(rng.random((S, ny, nx)) - 0.35, 0.0, 1.0)
    sdf = rng.standard_normal((S, ny, nx))
    udef = 0.1 * rng.standard_normal((S, 2, ny, nx))
    uvw = rng.standard_normal((S, 3))
    com = rng.random((S, 2))
    return chi, sdf, udef, uvw, com, x, y


def test_overlap_integrals_merged_and_pairwise():
    chi, sdf, udef, uvw, com, x, y = _coll_fields()
    J = [jnp.asarray(a) for a in (chi, sdf, udef, uvw, com, x, y)]
    T = [_t(a) for a in (chi, sdf, udef, uvw, com, x, y)]
    _close(jc.merged_overlap_integrals(*J), tc.merged_overlap_integrals(*T),
           rel=True)
    _close(jc.overlap_integrals(J[0][0], J[0][1], J[1][0], J[2][0], J[3][0],
                                J[4][0], J[5], J[6]),
           tc.overlap_integrals(T[0][0], T[0][1], T[1][0], T[2][0], T[3][0],
                                T[4][0], T[5], T[6]), rel=True)


def _hit_colls(S=4):
    colls = np.zeros((S, 7))
    for k in range(S):
        colls[k] = [10.0, 10 * (0.4 + 0.05 * k), 10 * 0.5,
                    10.0 * (1 - k), 0.0, (-1.0) ** k * 10, 1.0]
    return colls


def test_pairwise_collision_update_and_response():
    rng = _rng(3)
    S = 4
    colls = _hit_colls(S)
    uvw = rng.standard_normal((S, 3))
    mass = 1.0 + rng.random(S)
    inertia = 0.1 + rng.random(S)
    com = rng.random((S, 2))
    lengths = 0.2 + 0.1 * rng.random(S)
    args = (colls, uvw, mass, inertia, com, lengths)
    got = tc.pairwise_collision_update(*map(_t, args))
    ref = jc.pairwise_collision_update(*map(jnp.asarray, args))
    _close(ref, got, rel=True)
    assert not np.allclose(got.numpy(), uvw)       # some pair hit
    # each gate (tests/test_collision_forces.py's head-on pair): a hit, a
    # receding pair, a tiny overlap, separated centroids
    ci = np.array([10.0, 4.5, 5.0, 10.0, 0.0, -10.0, 0.0])
    cj = np.array([10.0, 5.5, 5.0, -10.0, 0.0, 10.0, 0.0])
    rec_i, rec_j = ci.copy(), cj.copy()
    rec_i[3], rec_j[3] = -10.0, 10.0
    hits = []
    for a_i, a_j, l in ((ci, cj, 1.0), (rec_i, rec_j, 1.0),
                        (np.r_[1.0, ci[1:]], cj, 1.0), (ci, cj, 1e-3)):
        a = (a_i, a_j, [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], 1.0, 1.0, 1e-3,
             1e-3, [0.4, 0.5], [0.6, 0.5], l)
        jr = jc.collision_response(*map(jnp.asarray, a))
        tr = tc.collision_response(*map(_t, a))
        for x_, y_ in zip(jr, tr):
            _close(x_, y_, rel=True)
        hits.append(bool(tr[2]))
    assert hits == [True, False, False, False]


# ---------------------------------------------------------------------------
# ops/forces.py
# ---------------------------------------------------------------------------

def _force_fields(ny=48, nx=64, cx=0.5, cy=0.4, r=0.12, seed=8):
    """A disk's chi/sdf on a unit-height grid, a random velocity and
    pressure: every surface cell probes and every stencil is evaluated."""
    h = 1.0 / ny
    x = (np.arange(nx) + 0.5) * h
    y = (np.arange(ny) + 0.5) * h
    X, Y = np.meshgrid(x, y)
    own = r - np.hypot(X - cx, Y - cy)
    chi = np.clip(0.5 + own / (2 * h), 0.0, 1.0)
    rng = _rng(seed)
    vel = rng.standard_normal((2, ny, nx))
    pres = rng.standard_normal((ny, nx))
    udef = 0.1 * rng.standard_normal((2, ny, nx))
    return vel, pres, chi, own, udef, own, np.array([cx, cy]), h


@pytest.mark.parametrize("where", ["inside", "touching_the_wall"])
def test_surface_forces(where):
    """The uniform wrapper (G = 10). A disk touching the x_hi and y_lo
    walls sends probes into the ghost lab."""
    if where == "inside":
        vel, pres, chi, sdf, udef, own, com, h = _force_fields()
    else:
        vel, pres, chi, sdf, udef, own, com, h = _force_fields(
            cx=1.3, cy=0.08, r=0.12)
    uvw = np.array([0.3, -0.1, 0.7])
    args = (vel, pres, chi, sdf, udef, own, com, uvw)
    ref = jf.surface_forces(*map(jnp.asarray, args), 1e-3, h)
    got = tf.surface_forces(*map(_t, args), 1e-3, h)
    assert tuple(got) == tuple(ref)
    assert set(got) == set(tf.FORCE_KEYS)
    for k in tf.FORCE_KEYS:
        _close(ref[k], got[k], rel=True)
    assert float(got["perimeter"]) > 0


@pytest.mark.parametrize("G", [4, 2])
def test_surface_forces_block_clamps_out_of_range_gathers(G):
    """The block core on a tile whose body runs off its edges, with the
    forest's G = 4 ghosts and with 2: the probe walk reaches the lab edge
    and the 5-point, 2nd-order and cross stencils index past it (negative
    and beyond the end). JAX wraps and clamps those indices and drops the
    values; the port does the same, and raises no IndexError."""
    vel, pres, chi, sdf, udef, own, com, h = _force_fields(
        ny=16, nx=16, cx=0.05, cy=0.95, r=0.3)
    pad = ((G, G), (G, G))
    velp = np.stack([np.pad(vel[c], pad, mode="edge") for c in range(2)])
    chip = np.pad(chi, pad, mode="edge")
    sdfp = np.pad(sdf, pad, mode="edge")
    ny, nx = pres.shape
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    xc, yc = (ix + 0.5) * h, (iy + 0.5) * h
    uvw = np.array([0.3, -0.1, 0.7])
    args = (velp, pres, chip, sdfp, udef, own, xc, yc, com, uvw)
    # the walk and the stencils do leave the lab here
    lo = np.minimum.reduce([iy, ix]) - 4 - 5
    assert lo.min() + G < 0
    ref = jf.surface_forces_block(*map(jnp.asarray, args), 1e-3, h, G)
    got = tf.surface_forces_block(*map(_t, args), 1e-3, h, G)
    for k in ref:
        _close(ref[k], got[k], rel=True)


def test_surface_forces_blocks_g4():
    """The forest form: [N] blocks with G = 4 labs cut from one field, a
    per-block h (alternate blocks twice as coarse) and a body across
    several blocks, so that probes reach the lab edge and stencils index
    past it; summed over the blocks <= 1e-12 relative to JAX's vmap."""
    G, bs = 4, 8
    vel, pres, chi, sdf, udef, own, com, h = _force_fields(
        ny=24, nx=32, cx=0.45, cy=0.55, r=0.3)
    pad = ((G, G), (G, G))
    velp = np.stack([np.pad(vel[c], pad, mode="edge") for c in range(2)])
    chip = np.pad(chi, pad, mode="edge")
    sdfp = np.pad(sdf, pad, mode="edge")
    ny, nx = pres.shape
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    xg, yg = (ix + 0.5) * h, (iy + 0.5) * h
    blocks = [(j, i) for j in range(ny // bs) for i in range(nx // bs)]

    def lab(a, j, i):
        return a[..., j * bs:j * bs + bs + 2 * G, i * bs:i * bs + bs + 2 * G]

    def tile(a, j, i):
        return a[..., j * bs:(j + 1) * bs, i * bs:(i + 1) * bs]

    args = (np.stack([lab(velp, j, i) for j, i in blocks]),
            np.stack([tile(pres, j, i) for j, i in blocks]),
            np.stack([lab(chip, j, i) for j, i in blocks]),
            np.stack([lab(sdfp, j, i) for j, i in blocks]),
            np.stack([tile(udef, j, i) for j, i in blocks]),
            np.stack([tile(own, j, i) for j, i in blocks]),
            np.stack([tile(xg, j, i) for j, i in blocks]),
            np.stack([tile(yg, j, i) for j, i in blocks]))
    hb = h * (1.0 + (np.arange(len(blocks)) % 2))
    uvw = np.array([0.3, -0.1, 0.7])
    ref = jf.surface_forces_blocks(*map(jnp.asarray, args),
                                   jnp.asarray(com), jnp.asarray(uvw), 1e-3,
                                   jnp.asarray(hb), G=G)
    got = tf.surface_forces_blocks(*map(_t, args), _t(com), _t(uvw), 1e-3,
                                   _t(hb), G=G)
    assert set(got) == set(ref) == set(tf.FORCE_KEYS)
    for k in tf.FORCE_KEYS:
        assert got[k].dim() == 0
        _close(ref[k], got[k], rel=True)
    assert float(got["perimeter"]) > 0
    # the surface crosses block edges: probes walk to the lab edge
    surf = (np.abs(own) < 2 * h)
    edge = np.zeros_like(surf)
    edge[:, ::bs] = edge[:, bs - 1::bs] = True
    edge[::bs, :] = edge[bs - 1::bs, :] = True
    assert (surf & edge).sum() > 10


# ---------------------------------------------------------------------------
# ties of overlapping bodies, and the obstacle carriers
# ---------------------------------------------------------------------------

def _overlap_obs(seed=9):
    """Two bodies whose chi is 1 on a shared patch (a tie of the winner
    argmax and of the combined udef)."""
    rng = _rng(seed)
    S, ny, nx = 2, 16, 20
    chi_s = np.zeros((S, ny, nx))
    chi_s[0, 3:10, 2:12] = 1.0
    chi_s[1, 6:14, 8:18] = 1.0
    chi_s[0, 2, 2:12] = 0.4
    chi_s[1, 14, 8:18] = 0.6
    chi = chi_s.max(axis=0)
    fields = dict(chi=chi, sdf=rng.standard_normal((ny, nx)), chi_s=chi_s,
                  sdf_s=rng.standard_normal((S, ny, nx)),
                  udef_s=rng.standard_normal((S, 2, ny, nx)),
                  com=rng.random((S, 2)), mass=1 + rng.random(S),
                  inertia=1 + rng.random(S))
    return fields


def test_overlap_ties_first_winner_and_summed_udef():
    f = _overlap_obs()
    jobs = JObs(**{k: jnp.asarray(v) for k, v in f.items()})
    tobs = obstacle_from_numpy(f, "cpu", torch.float64)
    _close(JSim._combined_udef(jobs), Simulation._combined_udef(tobs),
           bar=0.0)
    both = (f["chi_s"][0] == 1.0) & (f["chi_s"][1] == 1.0)
    assert both.any()
    ud = Simulation._combined_udef(tobs).numpy()
    assert np.array_equal(ud[:, both], (f["udef_s"][0] + f["udef_s"][1])
                          [:, both])
    win = torch.argmax(tobs.chi_s, dim=0).numpy()
    assert np.array_equal(win, np.asarray(jnp.argmax(jobs.chi_s, axis=0)))
    assert (win[both] == 0).all()


def test_obstacle_carriers_round_trip():
    f = _overlap_obs()
    obs = obstacle_from_numpy(f, "cpu", torch.float64)
    assert isinstance(obs, ObstacleFields)
    back = obstacle_to_numpy(obs)
    assert back.keys() == set(ObstacleFields._fields)
    for k in ObstacleFields._fields:
        assert np.array_equal(back[k], f[k])
    with pytest.raises(ValueError, match="missing"):
        obstacle_from_numpy({"chi": f["chi"]}, "cpu", torch.float64)
