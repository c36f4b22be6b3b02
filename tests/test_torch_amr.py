"""Port parity for the whole obstacle-free forest step (``AMRSim``).

* A 12-step f64 trajectory on the dynamic-vortex forest of
  tests/test_amr.py, with ``adapt()`` every 3 steps, so that it crosses
  the step-10 switch from the exact startup solves to production solves:
  under CUP2D_POIS=structured, fft, fas and fas-f, and under fft with
  CUP2D_TWOLEVEL=additive. Bars: ordered velocity and pressure <= 1e-10
  from JAX after every step, equal iteration counts and solver labels,
  equal block key sets after every adapt.
* The production two-level trigger (iters > 15) on the multilevel forest
  engages at the same step as in JAX, with equal iteration counts.
* The device policy, and a ValueError for every latch value that the port
  (or the JAX package) refuses: ``CUP2D_PREC=bf16`` needs fas|fas-f; a
  shaped sim builds and steps."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu.amr import AMRSim as JSim  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.amr import multilevel_forest  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     forest_from_numpy)
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


TRAJ_BAR = 1e-10
RUNS = {"structured": ("structured", None), "fft": ("fft", None),
        "fas": ("fas", None), "fas-f": ("fas-f", None),
        "fft+additive": ("fft", "additive")}


def _vortex_cfg(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=4, level_start=1, extent=1.0,
                nu=1e-4, cfl=0.4, dtype="float64",
                max_poisson_iterations=100, poisson_tol=1e-4,
                poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)
    base.update(kw)
    return SimConfig(**base)


def _vortex_vel(cfg, blocks, capacity):
    """The Gaussian vortex of tests/test_amr.py, slot layout."""
    bs = cfg.bs
    vals = np.zeros((capacity, 2, bs, bs))
    for (l, i, j), s in blocks.items():
        h = cfg.h_at(l)
        x = (i * bs + np.arange(bs) + 0.5) * h - 0.5
        y = (j * bs + np.arange(bs) + 0.5) * h - 0.5
        X, Y = np.meshgrid(x, y, indexing="xy")
        r2 = X ** 2 + Y ** 2
        ut = 0.5 / (2 * np.pi * np.sqrt(r2 + 1e-12)) \
            * (1 - np.exp(-r2 / (2 * 0.0064)))
        th = np.arctan2(Y, X)
        vals[s, 0] = -ut * np.sin(th)
        vals[s, 1] = ut * np.cos(th)
    return vals


def _ordered(sim, jax_side):
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in o]
    get = (lambda a: np.asarray(a)[o]) if jax_side else \
        (lambda a: a.numpy()[o])
    return keys, get(f.fields["vel"]), get(f.fields["pres"])


@pytest.fixture(scope="module", params=list(RUNS))
def trajectory(request):
    """One 12-step run of each package per solver setting."""
    pois, twolevel = RUNS[request.param]
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", pois)
    if twolevel:
        mp.setenv("CUP2D_TWOLEVEL", twolevel)
    try:
        cfg = _vortex_cfg()
        js = JSim(cfg, shapes=[])
        ts = TSim(config_from_dict(dataclasses.asdict(cfg)), shapes=[],
                  device="cpu")
    finally:
        mp.undo()
    vel = _vortex_vel(cfg, js.forest.blocks, js.forest.capacity)
    js.forest.fields["vel"] = jnp.asarray(vel)
    ts.forest.fields["vel"] = torch.tensor(vel)
    rows = []
    for k in range(12):
        row = {}
        if k % 3 == 0:
            row["adapt"] = (js.adapt(), ts.adapt())
            row["keys"] = (set(js.forest.blocks), set(ts.forest.blocks))
        jd, td = js.step_once(), ts.step_once()
        kj, vj, pj = _ordered(js, True)
        kt, vt, pt = _ordered(ts, False)
        row.update(jd={k_: np.asarray(v) for k_, v in jd.items()}, td=td,
                   same_order=kj == kt, n=len(kj),
                   modes=(js.poisson_mode, ts.poisson_mode),
                   err=(np.abs(vj - vt).max(), np.abs(pj - pt).max()))
        rows.append(row)
    return rows


def test_trajectory_matches_jax(trajectory):
    for k, row in enumerate(trajectory):
        assert row["same_order"], k
        ev, ep = row["err"]
        assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (k, ev, ep)


def test_iterations_and_solver_match_jax(trajectory):
    assert any(r["td"]["poisson_iters"] for r in trajectory)
    for k, row in enumerate(trajectory):
        jd, td = row["jd"], row["td"]
        assert td["poisson_iters"] == int(jd["poisson_iters"]), k
        assert td["poisson_converged"] == bool(jd["poisson_converged"]), k
        assert td["precond_cycles"] == int(jd["precond_cycles"]), k
        assert row["modes"][0] == row["modes"][1], k


def test_topology_matches_after_every_adapt(trajectory):
    adapts = [r for r in trajectory if "adapt" in r]
    assert len(adapts) == 4 and adapts[0]["adapt"] == (True, True)
    for row in adapts:
        assert row["adapt"][0] == row["adapt"][1]
        assert row["keys"][0] == row["keys"][1]
    assert trajectory[-1]["n"] > trajectory[0]["n"] > 4


def test_step_diagnostics_match_jax(trajectory):
    for k, row in enumerate(trajectory):
        jd, td = row["jd"], row["td"]
        # dt comes from umax, a reduction: equal to the last bit or two
        assert abs(td["dt"] - float(jd["dt"])) <= 1e-15
        for key in ("umax", "energy", "div_linf"):
            assert abs(td[key] - float(jd[key])) <= TRAJ_BAR, (k, key)
        assert td["finite"] and bool(jd["finite"])


def test_two_level_trigger_matches_jax():
    """Structured solves on the multilevel forest: the first production
    solve takes > 15 block-Jacobi iterations, and the two-level
    correction engages on the next step in both packages. Iterations
    match. The states are held to 1e-7 (velocity) and 1e-6 (pressure)
    relative, not 1e-10: a 34-iteration BiCGSTAB solve of the singular
    Neumann problem at tolerance 1e-3 amplifies the operators' rounding-
    level differences (<= 2e-15, tests/test_torch_forest.py) into smooth
    near-nullspace pressure modes (measured 3.6e-7 relative; 1e-11 on the
    velocity when both solves are converged to 1e-10)."""
    js = build_multilevel_sim(dtype="float64")
    js.sync_fields()
    ts = TSim(config_from_dict(dataclasses.asdict(js.cfg)), shapes=[],
              device="cpu")
    forest_from_numpy(ts, js.forest.blocks,
                      {k: np.asarray(v) for k, v in js.forest.fields.items()})
    ts.step_count = js.step_count
    modes = []
    for _ in range(2):
        jd, td = js.step_once(), ts.step_once()
        assert td["poisson_iters"] == int(jd["poisson_iters"])
        modes.append((js.poisson_mode, ts.poisson_mode))
        _, vj, pj = _ordered(js, True)
        _, vt, pt = _ordered(ts, False)
        assert np.abs(vj - vt).max() <= 1e-7 * np.abs(vj).max()
        assert np.abs(pj - pt).max() <= 1e-6 * np.abs(pj).max()
    assert modes == [("bicgstab+jacobi",) * 2, ("bicgstab+twolevel",) * 2]


def test_port_multilevel_forest_matches_jax_builder():
    """The port's own multilevel builder reaches the JAX builder's
    topology."""
    js = build_multilevel_sim(dtype="float64")
    ts = multilevel_forest(device="cpu")
    assert set(ts.forest.blocks) == set(js.forest.blocks)
    assert ts.step_count == js.step_count == 20


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(_vortex_cfg(), shapes=[])


def test_f64_on_the_card_refuses():
    with pytest.raises(ValueError, match="f32 state only"):
        TSim(_vortex_cfg(), shapes=[], device="cuda")


@pytest.mark.parametrize("env,value,match", [
    ("CUP2D_POIS", "fftd", "uniform-family"),
    ("CUP2D_POIS", "", "expected structured"),
    ("CUP2D_POIS", "typo", "expected structured"),
    ("CUP2D_TWOLEVEL", "typo", "expected additive"),
    ("CUP2D_PREC", "bf16", "requires CUP2D_POIS=fas"),
    ("CUP2D_PREC", "f16", "expected f32"),
])
def test_latches_refuse_loudly(monkeypatch, env, value, match):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=match) as info:
        TSim(_vortex_cfg(), shapes=[], device="cpu")
    assert env in str(info.value)


@pytest.mark.parametrize("pois,twolevel,mode", [
    ("structured", None, "bicgstab+jacobi"), ("fft", "mg2", "bicgstab+fft"),
    ("fas", "mult", "fas+forest"), ("fas-f", None, "fas-f+forest"),
    ("tables", None, "bicgstab+jacobi")])
def test_latches_accepted(monkeypatch, pois, twolevel, mode):
    monkeypatch.setenv("CUP2D_POIS", pois)
    if twolevel:
        monkeypatch.setenv("CUP2D_TWOLEVEL", twolevel)
    assert TSim(_vortex_cfg(), shapes=[], device="cpu").poisson_mode == mode


def test_shapes_refuse():
    """Shapes no longer refuse: a shaped ``AMRSim`` (from the shapes given,
    or from the config's -shapes string) builds on the CPU and steps, its
    forces logged. ``async_diag`` is accepted and the shaped step still
    returns host diagnostics (it verdicts eagerly, as the reference's
    does); the phase timers (``timers``, item 9) refuse."""
    from cup2d_tpu_torch.models import DiskShape
    cfg = _vortex_cfg(shapes="angle=0 L=0.2 xpos=0.5 ypos=0.5",
                      level_max=3, lam=1e6)
    ts = TSim(cfg, device="cpu")
    assert len(ts.shapes) == 1 and "chi" in ts.forest.fields
    ts = TSim(_vortex_cfg(level_max=3, lam=1e6),
              shapes=[DiskShape(0.1, 0.5, 0.5)], device="cpu")
    d = ts.step_once()
    assert d["finite"] and ts.step_count == 1 and ts._initialized
    assert set(ts.shapes[0].forces) >= {"forcex", "perimeter"}
    ts.async_diag = True
    d = ts.step_once()
    assert ts.step_count == 2 and ts.time > 0
    assert not any(torch.is_tensor(v) for v in d.values())
    with pytest.raises(NotImplementedError, match="item 9"):
        ts.timers = object()
    assert TSim(_vortex_cfg(), device="cpu").shapes == []


def test_non_free_slip_table_refuses():
    TSim(_vortex_cfg(), shapes=[], device="cpu", bc="fs,fs,fs,fs")
    with pytest.raises(ValueError, match="ns,ns,ns,ns"):
        TSim(_vortex_cfg(), shapes=[], device="cpu", bc="ns,ns,ns,ns")
