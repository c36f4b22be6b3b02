"""Port parity for the forest's left-overs: the lab-table form of the
Poisson operator (``CUP2D_POIS=tables``), the bf16 FAS ladder legs
(``CUP2D_PREC=bf16`` with fas) and the native regrid helper, against the
JAX package on the CPU.

* ``flux.build_poisson_tables`` arrays equal JAX's exactly on a forest
  built alike in both packages, and the tables operator ``laplacian5`` of
  its labs is within 1e-12 of JAX's at f64. (The tables trajectory, on
  one and on several shards, is in tests/test_torch_forest_mesh.py.)
* One bf16-leg ``ForestFASCycle`` application against JAX's on the same
  input at f32: within one bf16 ulp (2^-7) of max |ref| (each package
  rounds every leg op to bf16; XLA's CPU backend may keep some in f32
  inside a fusion). A bf16-leg fas trajectory, 6 production steps with an
  adapt: equal iterations, state within 1e-5 of max |JAX| and within the
  2e-2 bf16 band of the f32-leg run; labels ``strip+bf16`` / ``xla+bf16``.
* The C ``fix_states`` equals ``AMRSim._fix_states_py`` and the JAX
  package's Python sweep on randomized forests and states; a failed build
  raises with the compiler's output."""

import copy
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
from cup2d_tpu.ops import stencil as jst  # noqa: E402
from cup2d_tpu_torch import flux as tflux  # noqa: E402
from cup2d_tpu_torch import halo as thalo  # noqa: E402
from cup2d_tpu_torch import native  # noqa: E402
from cup2d_tpu_torch import poisson as tpois  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.config import SimConfig as TCfg  # noqa: E402
from cup2d_tpu_torch.convert import config_from_dict  # noqa: E402
from cup2d_tpu_torch.forest import Forest as TForest  # noqa: E402
from cup2d_tpu_torch.ops.stencil import laplacian5  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OP_BAR = 1e-12
BF16_ULP = 2.0 ** -7
BF16_BAND = 2e-2
TRAJ_REL = 1e-5


def _vortex_vel(cfg, blocks, capacity):
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


def _twins(dtype, level_max, env, monkeypatch, level_start=2):
    """A JAX and a port forest built alike (same config, velocity and
    adapt, hence the same slots), under the latches ``env``."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = SimConfig(bpdx=2, bpdy=2, level_max=level_max,
                    level_start=level_start,
                    extent=1.0, nu=1e-4, cfl=0.4, dtype=dtype,
                    max_poisson_iterations=100, poisson_tol=1e-4,
                    poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)
    js = JSim(cfg, shapes=[])
    ts = TSim(config_from_dict(dataclasses.asdict(cfg)), shapes=[],
              device="cpu")
    vel = _vortex_vel(cfg, js.forest.blocks, js.forest.capacity)
    js.forest.fields["vel"] = jnp.asarray(vel, dtype=js.forest.dtype)
    ts.forest.fields["vel"] = torch.tensor(vel).to(ts.dtype)
    assert js.adapt() and ts.adapt()
    js._refresh()
    ts._refresh()
    assert js.forest.blocks == ts.forest.blocks
    return js, ts


def test_poisson_tables_and_operator_match_jax(monkeypatch):
    js, ts = _twins("float64", 4, {"CUP2D_POIS": "tables"}, monkeypatch)
    tj = jflux.build_poisson_tables(js.forest, js._order)
    tt = tflux.build_poisson_tables(ts.forest, ts._order)
    for name in tt._fields:
        a, b = getattr(tt, name), getattr(tj, name)
        if isinstance(a, np.ndarray):
            b = np.asarray(b)
            assert a.shape == b.shape and np.array_equal(a, b), name
        else:
            assert a == b, name
    n_pad = ts._npad_hwm
    pj, pt = js._tables["pois"], ts._tables["pois"]
    assert not hasattr(pt, "nba") and isinstance(pt, thalo.LabTables)
    x = np.random.default_rng(4).standard_normal((n_pad, 8, 8))
    x[ts._n_real:] = 0.0
    a = jst.laplacian5(jhalo.assemble_labs_ordered(
        jnp.asarray(x)[:, None], pj), 1)[:, 0]
    b = laplacian5(thalo.assemble_labs_ordered(
        torch.tensor(x)[:, None], pt), 1)[:, 0]
    assert np.abs(np.asarray(a) - b.numpy()).max() <= OP_BAR
    # the tables operator is the structured one (the same matrix)
    op = tflux.poisson_op(tflux.build_poisson_structured(
        ts.forest, ts._order, n_pad), "cpu", torch.float64)
    c = tflux.poisson_apply_structured(torch.tensor(x), op)
    real = slice(0, ts._n_real)
    assert float((b[real] - c[real]).abs().max()) <= OP_BAR
    assert ts.poisson_mode == js.poisson_mode == "bicgstab+jacobi"


def test_bf16_leg_fas_cycle_matches_jax(monkeypatch):
    """levelMax 5 from level 3: the adapted forest has level-4 blocks
    above the coarse base level 3, so the cycle walks a window-image
    ladder leg."""
    js, ts = _twins("float32", 5, {"CUP2D_POIS": "fas",
                                   "CUP2D_PREC": "bf16"}, monkeypatch, 3)
    assert ts._fas_leg_dtype == torch.bfloat16
    assert ts.smoother_tier == js.smoother_tier == "xla+bf16"

    def aj(v):
        return jflux.poisson_apply_structured(v, js._tables["pois"])

    def at(v):
        return tflux.poisson_apply_structured(v, ts._tables["pois"])
    hj, ht = js._hsq_flat, ts._hsq_flat
    cj = jnp.where(hj > 0, 1.0 / jnp.where(hj > 0, hj, 1.0), 0.0)
    ct = torch.where(ht > 0, 1.0 / torch.where(ht > 0, ht, 1.0), 0.0)
    tj, tt = js._use_coarse(True), ts._use_coarse(True)
    assert tt.get("levf"), "no window-image level above the base"
    mj = jpois.ForestFASCycle(
        aj, js._fas_block_smoother(aj, js._tables["pois"]),
        *js._fas_transfers(tj), cj, leg_dtype=jnp.bfloat16)
    mt = tpois.ForestFASCycle(
        at, ts._fas_block_smoother(at, ts._tables["pois"]),
        *ts._fas_transfers(tt), ct, leg_dtype=torch.bfloat16)
    r = np.random.default_rng(12).standard_normal(
        (ts._npad_hwm, 8, 8)).astype(np.float32)
    r[ts._n_real:] = 0.0
    for cyc in ("__call__", "fcycle"):
        a = np.asarray(getattr(mj, cyc)(jnp.asarray(r)))
        b = getattr(mt, cyc)(torch.tensor(r)).numpy()
        assert b.dtype == np.float32
        assert np.abs(a - b).max() <= BF16_ULP * np.abs(a).max(), cyc


def test_bf16_leg_fas_trajectory_matches_jax(monkeypatch):
    """6 production FAS steps with an adapt after the third: equal
    iterations, state within 1e-5 of max |JAX|; and within the bf16 band
    of the port's f32-leg run."""
    js, ts = _twins("float32", 5, {"CUP2D_POIS": "fas",
                                   "CUP2D_PREC": "bf16"}, monkeypatch, 3)
    monkeypatch.setenv("CUP2D_PREC", "f32")
    f32 = TSim(ts.cfg, shapes=[], device="cpu")
    from cup2d_tpu_torch.convert import copy_amr_state
    copy_amr_state(ts, f32)
    sims = (js, ts, f32)
    for s in sims:
        s.step_count = 10
    for k in range(6):
        if k == 3:
            assert len({s.adapt() for s in sims}) == 1
        dj, dt_, df = (s.step_once() for s in sims)
        assert int(dj["poisson_iters"]) == dt_["poisson_iters"], k
        assert dt_["poisson_converged"]
    js.sync_fields()
    o = js.forest.order()
    vj = np.asarray(js.forest.fields["vel"])[o]
    vt = ts.fields()["vel"].numpy()[ts.forest.order()]
    vf = f32.fields()["vel"].numpy()[f32.forest.order()]
    assert np.abs(vj - vt).max() <= TRAJ_REL * np.abs(vj).max()
    assert np.abs(vf - vt).max() <= BF16_BAND * np.abs(vf).max()


def _random_forest(rng, level_max=4):
    cfg = TCfg(bpdx=2, bpdy=1, level_max=level_max, level_start=1,
               extent=1.0, dtype="float64")
    f = TForest(cfg, "cpu")
    for _ in range(2):
        for key in list(f.blocks):
            l, i, j = key
            if l < level_max - 1 and rng.random() < 0.35:
                f.release(l, i, j)
                for a in (0, 1):
                    for b in (0, 1):
                        f.allocate(l + 1, 2 * i + a, 2 * j + b)
    return cfg, f


@pytest.mark.parametrize("level_max", [4, 6])
def test_native_fix_states_matches_python_and_jax(level_max):
    from cup2d_tpu.forest import Forest as JForest
    rng = np.random.default_rng(7 + level_max)
    for trial in range(6):
        cfg, f = _random_forest(rng, level_max)
        jcfg = SimConfig(**{k: getattr(cfg, k) for k in (
            "bpdx", "bpdy", "level_max", "level_start", "extent",
            "dtype")})
        jf = JForest(jcfg)
        for key in list(jf.blocks):
            jf.release(*key)
        for key in f.blocks:
            jf.allocate(*key)
        base = {k: (int(rng.choice([-1, 0])) if k[0] == level_max - 1
                    else int(rng.choice([-1, 0, 1]))) for k in f.blocks}
        sim = TSim.__new__(TSim)         # the sweep reads forest and cfg
        sim.forest, sim.cfg = f, cfg
        jsim = JSim.__new__(JSim)
        jsim.forest, jsim.cfg = jf, jcfg
        st_py = copy.deepcopy(base)
        sim._fix_states_py(st_py)
        st_j = copy.deepcopy(base)
        jsim._fix_states_py(st_j)
        keys = list(base)
        lvl = np.array([k[0] for k in keys], np.int64)
        bi = np.array([k[1] for k in keys], np.int64)
        bj = np.array([k[2] for k in keys], np.int64)
        st = np.array([base[k] for k in keys], np.int8)
        sim._fix_states(lvl, bi, bj, st)
        assert dict(zip(keys, st.tolist())) == st_py == st_j, trial


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "amr_host.c"
    bad.write_text("int fix_states( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed") as info:
        native.load()
    assert "amr_host.c" in str(info.value) and "error" in str(info.value)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="not found"):
        native.load()
