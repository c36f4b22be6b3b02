"""Port parity for the shaped forest (``amr.AMRSim`` with shapes) against
the JAX package, f64 on the CPU.

* ``initialize()`` of a fish and a disk (a climb to level 4): equal block
  keys in equal slots, chi <= 1e-12.
* The g = 4 tensorial tables (``sca4t``, ``vec4t``: the chi tags and the
  force pass) on that multilevel forest: face-copy structure, indices and
  weights equal to the JAX package's, labs <= 1e-12.
* ``_rasterize_impl`` on one fish and one disk across level interfaces:
  every obstacle field and com/mass/inertia <= 1e-12; the window scatter
  with repeated padding rows equal to JAX's, bit for bit.
* ``_chi_tag_impl`` and the fused tags, on a forest whose body crosses a
  level interface: equal.
* The disk forest against the port's uniform ``Simulation`` (the JAX
  package's ``test_disk_forest_matches_uniform``, <= 1e-10) and against
  the JAX forest.
* The golden two-disk collision (validation/golden_collision.py's
  configuration): against tests/golden_collision.json at the reference
  test's own bars, and against a live JAX run <= 1e-10.
* ``convert.copy_amr_state``: two port sims from one state step alike,
  bit for bit.
* A shaped ``AMRSim`` runs on the CPU, forces and the force log on."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import halo as jhalo  # noqa: E402
from cup2d_tpu.amr import AMRSim as JSim  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.models import DiskShape as JDisk  # noqa: E402
from cup2d_tpu.models import FishShape as JFish  # noqa: E402
from cup2d_tpu_torch import halo as thalo  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     copy_amr_state)
from cup2d_tpu_torch.models import DiskShape, FishShape  # noqa: E402
from cup2d_tpu_torch.sim import Simulation  # noqa: E402
from validation import golden_collision  # noqa: E402

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
TRAJ_BAR = 1e-10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_collision.json")


def _tcfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def _ordered(sim, jax_side):
    """(block keys in SFC order, {field: ordered numpy})."""
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in o]
    get = (lambda a: np.asarray(a)[o]) if jax_side else \
        (lambda a: a.detach().cpu().numpy()[o])
    return keys, {k: get(v) for k, v in f.fields.items()}


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# a multilevel forest with a fish and a disk, both packages
# ---------------------------------------------------------------------------

def _two_body_cfg():
    return SimConfig(bpdx=2, bpdy=1, level_max=5, level_start=2,
                     extent=1.0, dtype="float64", nu=1e-4, lam=1e6,
                     rtol=2.0, ctol=1.0)


@pytest.fixture(scope="module")
def pair():
    """A fish and a disk after ``initialize()`` in each package (a climb to
    level 4 around both, coarser blocks elsewhere)."""
    cfg = _two_body_cfg()
    mk = (lambda F, D: [F(0.2, 0.3, 0.25, 20.0, cfg.min_h),
                        D(0.05, 0.72, 0.22)])
    js = JSim(cfg, shapes=mk(JFish, JDisk))
    ts = TSim(_tcfg(cfg), shapes=mk(FishShape, DiskShape), device="cpu")
    for s in (js, ts):
        s.compute_forces_every = 0
        s.initialize()
        s._refresh()
    return js, ts


def test_initialize_matches_jax(pair):
    """The same climb: equal block keys in equal slots, chi <= 1e-12, the
    chi-blended velocity and the shapes' CoM sync."""
    js, ts = pair
    assert dict(js.forest.blocks) == dict(ts.forest.blocks)
    levels = {k[0] for k in js.forest.blocks}
    assert len(levels) >= 3 and max(levels) == 4
    kj, fj = _ordered(js, True)
    kt, ft = _ordered(ts, False)
    assert kj == kt
    for name in ("vel", "pres", "chi"):
        assert _err(fj[name], ft[name]) <= F64_BAR, name
    for a, b in zip(js.shapes, ts.shapes):
        assert _err(a.com, b.com) <= F64_BAR and abs(a.M - b.M) <= F64_BAR
    assert ts._initialized and ts._n_real == js._n_real
    assert ts._npad_hwm == js._npad_hwm and ts._wcap == js._wcap


def _host_g4(ts, dim):
    f = ts.forest
    topo = thalo._TopoIndex(f, ts._order)
    nb, mask = thalo.build_face_copy(f, ts._order, ts._npad_hwm, topo)
    return thalo.make_fast_tables(
        thalo.build_tables(f, ts._order, 4, True, dim, topo=topo),
        nb, mask, ts._npad_hwm, corners=True)


@pytest.mark.parametrize("kind,dim", [("sca4t", 1), ("vec4t", 2)])
def test_g4_tables_equal_jax(pair, kind, dim):
    """The face-copy structure (8 regions at g = 4), indices into the
    ordered state and weights equal to JAX's; the port's device tables
    are these host tables; labs <= 1e-12."""
    js, ts = pair
    jf = js._tables[kind]
    hf = _host_g4(ts, dim)
    assert jf.corners and hf.corners
    assert np.array_equal(np.asarray(jf.nb), hf.nb)
    assert np.array_equal(np.asarray(jf.mask), hf.mask)
    jt, ht = jf.t, hf.t
    assert (ht.L, ht.g, ht.dim) == (16, 4, dim) == (jt.L, jt.g, jt.dim)
    for name in ("dest_s", "src", "src_ord", "sign", "dest", "idx",
                 "idx_ord", "w"):
        a, b = np.asarray(getattr(jt, name)), getattr(ht, name)
        assert a.shape == b.shape and np.array_equal(a, b), name
    # coarse-fine interpolation rows exist at this depth
    assert (np.asarray(jt.w) != 0).any(axis=(1, 2)).sum() > 0
    dt = ts._tables[kind]
    ref = thalo.lab_tables(hf, "cpu", torch.float64)
    for name in ("s_blk", "s_cell", "src", "src_ord", "sign", "g_blk",
                 "g_cell", "idx", "idx_ord", "w", "nb", "mask"):
        assert torch.equal(getattr(dt, name), getattr(ref, name)), name
    x = np.random.default_rng(4).standard_normal(
        (js._npad_hwm, dim, 8, 8))
    a = np.asarray(jhalo.assemble_labs_ordered(jnp.asarray(x), jf))
    b = thalo.assemble_labs_ordered(torch.tensor(x), dt).numpy()
    n = js._n_real
    assert _err(a[:n], b[:n]) <= F64_BAR


def test_rasterize_matches_jax(pair):
    js, ts = pair
    jo, to = js._rasterize(), ts._rasterize()
    for name in jo._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape, name
        assert _err(a, b) <= F64_BAR * max(1.0, np.abs(a).max()), name
    assert (np.asarray(jo.chi) > 0.5).sum() > 20        # both bodies
    assert (np.asarray(jo.chi_s)[0] > 0.5).sum() > 5     # the fish
    assert float(np.asarray(jo.mass)[0]) > 0


def test_window_raster_padding_row_matches_jax(pair):
    """Every padding window of a capacity-64 window writes row N of the
    scratch buffer, which is dropped: the window mask equals JAX's, the
    rows outside the window hold exactly the sentinel and 0, the window
    rows JAX's values <= 1e-12."""
    js, ts = pair
    ts._wcap = [max(c, 64) for c in ts._wcap]
    js._wcap = list(ts._wcap)
    N = ts._npad_hwm
    jin, tin = js._shape_inputs(), ts._shape_inputs()
    for k in range(2):
        pos = tin[k]["pos"].numpy()
        assert (pos < 0).sum() > 1                   # row N repeated
        assert np.array_equal(np.asarray(jin[k]["pos"]), pos)
        (js_, ju, jw) = (np.asarray(x) for x in js._window_raster(jin[k], N))
        (ts_, tu, tw) = (x.numpy() for x in ts._window_raster(tin[k], N))
        assert np.array_equal(jw, tw)
        out = tw == 0
        assert out.sum() == N - (pos >= 0).sum()
        assert (ts_[out] == -js.cfg.extent).all() and (tu[:, out] == 0).all()
        assert _err(js_, ts_) <= F64_BAR and _err(ju, tu) <= F64_BAR


def test_chi_tags_match_jax(pair):
    """The chi tags (offset 4 at the finest level, else 2) and the fused
    tags, after the disk has moved 0.06 (two finest blocks) toward the
    coarser blocks, so that its chi lies across a level interface. Runs
    last on the module's pair: it moves the disk."""
    js, ts = pair
    for sim in (js, ts):
        d = sim.shapes[1]
        d.u = 1.0
        d.advect(0.06, sim.cfg.extents)
        d.u = 0.0
        sim._write_chi(sim._rasterize())
    n = js._n_real
    finest = np.zeros(len(js._mask), bool)
    finest[:n] = js.forest.level[js._order] == js.cfg.level_max - 1
    jord, tord = js._ordered_state(), ts._ordered_state()
    assert _err(jord["chi"], tord["chi"].numpy()) <= F64_BAR
    a = np.asarray(js._chi_tag_impl(jord["chi"], js._tables["sca4t"],
                                    jnp.asarray(finest)))
    b = ts._chi_tag_impl(tord["chi"], ts._tables["sca4t"],
                         torch.as_tensor(finest)).numpy()
    assert np.array_equal(a[:n], b[:n])
    # tagged blocks on both sides of an interface
    lv = js.forest.level[js._order]
    assert len(set(lv[a[:n]])) >= 2
    a = np.asarray(js._tags_impl(jord["vel"], jord["chi"], js._h,
                                 js._tables["vec1"], js._tables["sca4t"],
                                 jnp.asarray(finest)))
    b = ts._tags_impl(tord["vel"], tord["chi"], ts._h, ts._tables["vec1"],
                      ts._tables["sca4t"], torch.as_tensor(finest)).numpy()
    assert _err(a[:n], b[:n]) <= F64_BAR
    # and the adapt those tags drive refines the same blocks
    assert js.adapt() and ts.adapt()
    assert dict(js.forest.blocks) == dict(ts.forest.blocks)


# ---------------------------------------------------------------------------
# the disk forest against the uniform step (test_amr_obstacles.py)
# ---------------------------------------------------------------------------

def _fill_tg(sim, tensor):
    """Taylor-Green velocity on every active block."""
    f = sim.forest
    cfg = sim.cfg
    bs = cfg.bs
    vals = np.zeros((f.capacity, 2, bs, bs))
    for s in f.order():
        h = cfg.h_at(int(f.level[s]))
        i, j = int(f.bi[s]), int(f.bj[s])
        x = (i * bs + np.arange(bs) + 0.5) * h
        y = (j * bs + np.arange(bs) + 0.5) * h
        X, Y = np.meshgrid(x, y, indexing="xy")
        vals[s, 0] = np.sin(np.pi * X) * np.cos(np.pi * Y)
        vals[s, 1] = -np.cos(np.pi * X) * np.sin(np.pi * Y)
    f.fields["vel"] = tensor(vals)


def test_disk_forest_matches_uniform_and_jax():
    """A single-level forest with a prescribed disk reproduces the port's
    uniform ``Simulation`` (the same algorithms at the same resolution)
    to 1e-10, as the JAX forest reproduces JAX's, and the JAX forest
    itself."""
    cfg = SimConfig(bpdx=2, bpdy=2, level_max=2, level_start=1,
                    extent=1.0, dtype="float64", nu=1e-3, lam=1e6,
                    rtol=1e9, ctol=-1.0)   # topology frozen
    tc = _tcfg(cfg)
    asim = TSim(tc, shapes=[DiskShape(0.08, 0.5, 0.55,
                                      prescribed=(0.0, 0.0))], device="cpu")
    usim = Simulation(tc, shapes=[DiskShape(0.08, 0.5, 0.55,
                                            prescribed=(0.0, 0.0))],
                      level=1, device="cpu")
    jsim = JSim(cfg, shapes=[JDisk(0.08, 0.5, 0.55, prescribed=(0.0, 0.0))])
    for s in (asim, usim, jsim):
        s.compute_forces_every = 0
    X, Y = usim.grid.cell_centers()
    u = np.sin(np.pi * X) * np.cos(np.pi * Y)
    v = -np.cos(np.pi * X) * np.sin(np.pi * Y)
    usim.state = usim.state._replace(vel=torch.tensor(np.stack([u, v])))
    _fill_tg(asim, torch.tensor)
    _fill_tg(jsim, jnp.asarray)
    for _ in range(3):
        asim.step_once(dt=2e-3)
        usim.step_once(dt=2e-3)
        jsim.step_once(dt=2e-3)
    f = asim.forest
    bs = cfg.bs
    vel = asim.fields()["vel"].numpy()
    gv = usim.state.vel.numpy()
    err = 0.0
    for s in f.order():
        i, j = int(f.bi[s]), int(f.bj[s])
        err = max(err, _err(vel[s], gv[:, j * bs:(j + 1) * bs,
                                        i * bs:(i + 1) * bs]))
    assert err < TRAJ_BAR, err
    kj, fj = _ordered(jsim, True)
    kt, ft = _ordered(asim, False)
    assert kj == kt
    assert _err(fj["vel"], ft["vel"]) < TRAJ_BAR
    assert jsim.time == asim.time


# ---------------------------------------------------------------------------
# the golden two-disk collision
# ---------------------------------------------------------------------------

def _port_collision_sim():
    """validation/golden_collision.py's ``build_sim`` on the port."""
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=3, level_start=2,
                    extent=1.0, dtype="float64", nu=2e-4, lam=1e6,
                    cfl=0.4, rtol=1e9, ctol=-1.0,
                    max_poisson_iterations=60, poisson_tol=1e-6,
                    poisson_tol_rel=1e-4)
    r = 0.06
    sim = TSim(cfg, shapes=[DiskShape(r, 0.42, 0.5), DiskShape(r, 0.58, 0.5)],
               device="cpu")
    sim.compute_forces_every = 0
    sim.initialize()
    f = sim.forest
    vel = sim.fields()["vel"].numpy().copy()
    order = f.order()
    bs = cfg.bs
    h = f.h_per_block(order)
    ar = np.arange(bs) + 0.5
    xc = (f.bi[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, None, :] * h[:, None, None]
    yc = (f.bj[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, :, None] * h[:, None, None]
    blob = np.zeros((len(order), bs, bs))
    for (cx, cy, uu) in ((0.42, 0.5, 0.6), (0.58, 0.5, -0.6)):
        rr2 = (xc - cx) ** 2 + (yc - cy) ** 2
        blob += uu * np.exp(-rr2 / (2.0 * r ** 2))
    vel[order, 0] = blob
    vel[order, 1] = 0.0
    f.fields["vel"] = torch.tensor(vel)
    return sim


def _bodies(sim):
    return [{"com": [float(s.com[0]), float(s.com[1])], "u": float(s.u),
             "v": float(s.v), "omega": float(s.omega)} for s in sim.shapes]


@pytest.fixture(scope="module")
def collision():
    """Both packages' 6 steps at dt 0.008 from the golden's start."""
    ts = _port_collision_sim()
    js = golden_collision.build_sim()
    rows = []
    for _ in range(golden_collision.N_STEPS):
        ts.step_once(dt=0.008)
        js.step_once(dt=0.008)
        _, fj = _ordered(js, True)
        _, ft = _ordered(ts, False)
        rows.append({"time": (js.time, ts.time),
                     "bodies": (_bodies(js), _bodies(ts)),
                     "vel_err": _err(fj["vel"], ft["vel"])})
    return rows


def test_golden_collision_matches_json(collision):
    """The reference test's bars (tests/test_golden_collision.py)."""
    with open(GOLDEN) as f:
        want = json.load(f)
    assert len(collision) == len(want["steps"]) == golden_collision.N_STEPS
    for i, (row, w) in enumerate(zip(collision, want["steps"])):
        np.testing.assert_allclose(row["time"][1], w["time"], rtol=1e-12)
        for k, (bg, bw) in enumerate(zip(row["bodies"][1], w["bodies"])):
            np.testing.assert_allclose(
                bg["com"], bw["com"], rtol=0, atol=1e-7,
                err_msg=f"step {i} body {k} com")
            for q in ("u", "v", "omega"):
                np.testing.assert_allclose(
                    bg[q], bw[q], rtol=1e-6, atol=1e-9,
                    err_msg=f"step {i} body {k} {q}")
    gap = [r["bodies"][1][1]["com"][0] - r["bodies"][1][0]["com"][0]
           for r in collision]
    np.testing.assert_allclose(min(gap), want["min_gap"], rtol=0,
                               atol=1e-7)
    # the impulse: body 0 flips from approaching to receding
    assert collision[0]["bodies"][1][0]["u"] > 0.1
    assert collision[1]["bodies"][1][0]["u"] < -0.01


def test_golden_collision_matches_live_jax(collision):
    for i, row in enumerate(collision):
        assert row["time"][0] == row["time"][1], i
        assert row["vel_err"] <= TRAJ_BAR, (i, row["vel_err"])
        for bj, bt in zip(*row["bodies"]):
            for q in ("com", "u", "v", "omega"):
                assert _err(bj[q], bt[q]) <= TRAJ_BAR, (i, q)


# ---------------------------------------------------------------------------
# the state carrier and a shaped run on the CPU
# ---------------------------------------------------------------------------

def test_copy_amr_state_port_to_port():
    """Two port sims from one state make the same steps, bit for bit,
    adapts and cached dt included."""
    a = _port_collision_sim()
    for _ in range(2):
        a.step_once()
    b = TSim(a.cfg, shapes=[DiskShape(0.06, 0.42, 0.5),
                            DiskShape(0.06, 0.58, 0.5)], device="cpu")
    b.compute_forces_every = 0
    copy_amr_state(a, b)
    assert b._next_dt == a._next_dt and b._next_dt_version == b.forest.version
    for k in range(3):
        if k == 1:
            assert a.adapt() == b.adapt()
        da, db = a.step_once(), b.step_once()
        assert da == db
    ka, fa = _ordered(a, False)
    kb, fb = _ordered(b, False)
    assert ka == kb
    for name in fa:
        assert np.array_equal(fa[name], fb[name]), name
    assert _bodies(a) == _bodies(b) and a.time == b.time


def test_shaped_run_logs_forces():
    """``run()`` on a free disk in a quiescent box: the force pass every
    step (one CSV row per shape), the perimeter near 2 pi r, nothing
    moves, and the step's phases are timed."""
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=3, level_start=1,
                    extent=1.0, dtype="float64", nu=4e-5, lam=1e6,
                    rtol=2.0, ctol=1.0)
    sim = TSim(cfg, shapes=[DiskShape(0.08, 0.55, 0.25)], device="cpu")
    sim.force_log = io.StringIO()
    sim.initialize()
    assert sim._wcap[0] >= 16
    d = sim.run(tend=100.0, max_steps=3)
    assert sim.step_count == 3 and d["finite"]
    assert isinstance(d["poisson_iters"], int)
    rows = sim.force_log.getvalue().strip().splitlines()
    assert len(rows) == 3 and rows[0].split(",")[1] == "0"
    per = sim.shapes[0].forces["perimeter"]
    assert abs(per - 2 * np.pi * 0.08) < 0.15 * 2 * np.pi * 0.08, per
    assert abs(sim.shapes[0].u) < 1e-12
    assert set(sim.phase_seconds) == {"kinematics", "megastep", "forces"}
    sim.async_diag = True
    d = sim.step_once()
    assert sim.step_count == 4 and d["finite"]
    assert not any(torch.is_tensor(v) for v in d.values())
    from cup2d_tpu_torch.profiling import PhaseTimers
    sim.timers = PhaseTimers()
    sim.async_diag = False
    sim.step_once()
    sim.adapt()
    assert {"kinematics", "rasterize", "flow", "forces", "adapt"} \
        <= set(sim.timers.report())


# ---------------------------------------------------------------------------
# the fish-contact golden (tests/test_golden_fish_contact.py)
# ---------------------------------------------------------------------------

def _port_fish_contact_run(n_steps, dt):
    """validation/golden_fish_contact.py's trajectory on the port: two fish
    driven nose to nose by seeded flow blobs, forces every step."""
    cfg = SimConfig(bpdx=2, bpdy=1, level_max=4, level_start=3,
                    extent=1.0, dtype="float64", nu=2e-4, lam=1e6,
                    cfl=0.4, rtol=1e9, ctol=-1.0,
                    max_poisson_iterations=60, poisson_tol=1e-6,
                    poisson_tol_rel=1e-4)
    L = 0.3
    sim = TSim(cfg, shapes=[FishShape(L, 0.66, 0.25, 180.0, cfg.min_h),
                            FishShape(L, 0.34, 0.25, 0.0, cfg.min_h)],
               device="cpu")
    sim.compute_forces_every = 1
    sim.initialize()
    f = sim.forest
    vel = sim.fields()["vel"].numpy().copy()
    order = f.order()
    bs = cfg.bs
    h = f.h_per_block(order)
    ar = np.arange(bs) + 0.5
    xc = (f.bi[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, None, :] * h[:, None, None]
    yc = (f.bj[order].astype(np.float64) * bs * h)[:, None, None] \
        + ar[None, :, None] * h[:, None, None]
    blob = np.zeros((len(order), bs, bs))
    for (cx, cy, uu) in ((0.66, 0.25, -0.6), (0.34, 0.25, 0.6)):
        rr2 = (xc - cx) ** 2 + (yc - cy) ** 2
        blob += uu * np.exp(-rr2 / (2.0 * (0.5 * L) ** 2))
    vel[order, 0] = blob
    vel[order, 1] = 0.0
    f.fields["vel"] = torch.tensor(vel)
    steps = []
    for _ in range(n_steps):
        sim.step_once(dt=dt)
        steps.append({"time": sim.time, "bodies": [
            dict(com=list(map(float, s.com)), u=float(s.u), v=float(s.v),
                 omega=float(s.omega), fx=s.forces["forcex"],
                 fy=s.forces["forcey"], torque=s.forces["torque"])
            for s in sim.shapes]})
    return steps


@pytest.mark.slow   # the reference marks its own fish-contact golden slow
def test_golden_fish_contact_event():
    """The fish-contact golden's event on the port: the pair closes hard,
    then the closing velocity reverses at the JSON's ``impulse_step`` (the
    e = 1 pair impulse), with forces live through it; the first step's
    rigid state (made before any pressure solve acts on the bodies) at
    the reference test's bars.

    The JSON's later numbers are not an oracle here: the run lies inside
    the exact startup steps, whose solves stall at the precision floor on
    a Poisson RHS that is not mean-free, and the JAX package's own run
    under jax 0.9.0 departs from its JSON by up to 9e-2 relative in v and
    O(1) in the forces (tests/test_golden_fish_contact.py fails there),
    as the port's does (ROADMAP queue 3)."""
    from validation import golden_fish_contact as gfc
    with open(gfc.GOLDEN_PATH) as f:
        want = json.load(f)
    got = _port_fish_contact_run(gfc.N_STEPS, gfc.DT)
    assert len(got) == len(want["steps"]) == gfc.N_STEPS
    du = [st["bodies"][0]["u"] - st["bodies"][1]["u"] for st in got]
    imin = du.index(min(du))
    assert min(du) < -0.15
    s = next(i for i in range(imin, gfc.N_STEPS) if du[i] > 0.05)
    assert s == want["impulse_step"]
    assert got[s - 1]["bodies"][0]["u"] < -0.05
    assert got[s]["bodies"][0]["u"] > 0.05
    assert any(abs(st["bodies"][0]["fx"]) > 0.0 for st in got)
    g, w = got[0], want["steps"][0]
    np.testing.assert_allclose(g["time"], w["time"], rtol=1e-12)
    for k, (bg, bw) in enumerate(zip(g["bodies"], w["bodies"])):
        np.testing.assert_allclose(bg["com"], bw["com"], rtol=0, atol=1e-7)
        for q in ("u", "v", "omega"):
            np.testing.assert_allclose(bg[q], bw[q], rtol=1e-6, atol=1e-9,
                                       err_msg=f"body {k} {q}")
