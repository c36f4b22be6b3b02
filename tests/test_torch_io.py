"""Dumps and checkpoints of the port (``cup2d_tpu_torch.io``) against the
JAX package's, f64 on the CPU.

* Dumps: ``dump_uniform`` of a uniform f64 state and ``dump_forest`` of a
  small multilevel shaped forest (seeded fields) carried from JAX
  (``convert.copy_amr_state``) write triplets byte-equal to
  ``cup2d_tpu.io``'s.
* The port's own restart: bit for bit (``torch.equal``) on the shaped
  forest across a regridding adapt and into the production steps; on the uniform disk case to the JAX
  test's own 1e-12 (the uniform checkpoint carries no cached dt, in both
  packages).
* A checkpoint the JAX package wrote loads into the port: on the forest
  the block keys come back in equal order and the fields bit for bit;
  the fish come back as the port's ``FishShape`` with the same state.
  The shapes unpickler refuses every other ``cup2d_tpu`` name.
* The crash-safe install: a missing checkpoint falls back to ``.old``
  with a ``checkpoint_fallback_old`` event; a second save replaces the
  first.

The production steps of the port from a JAX checkpoint of the fish at
512 x 256 are held in tests/test_torch_cli.py, which shares that
checkpoint with the CLI parity test."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import io as jio  # noqa: E402
from cup2d_tpu.amr import AMRSim as JAMR  # noqa: E402
from cup2d_tpu.config import SimConfig as JConfig  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim  # noqa: E402
from cup2d_tpu_torch.config import SimConfig  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     copy_amr_state)
from cup2d_tpu_torch.models import DiskShape, FishShape  # noqa: E402
from cup2d_tpu_torch.resilience import EventLog, set_event_log  # noqa: E402
from cup2d_tpu_torch.sim import Simulation  # noqa: E402

FOREST_FLAGS = ("-bpdx 2 -bpdy 1 -levelMax 4 -levelStart 2 -Rtol 2 -Ctol 1 "
                "-extent 2 -CFL 0.5 -tend 10 -lambda 1e7 -nu 0.00004 "
                "-poissonTol 1e-3 -poissonTolRel 0.01 -maxPoissonRestarts 0 "
                "-maxPoissonIterations 1000 -AdaptSteps 4 -tdump 0 "
                "-dtype float64").split()
FOREST_FISH = "angle=0 L=0.4 xpos=1.0 ypos=0.5"
UNIFORM_BAR = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and under the suite's parallel workers extra threads only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(path):
    return {suf: open(path + suf, "rb").read()
            for suf in (".xyz.raw", ".attr.raw", ".xdmf2")}


def _ordered(sim):
    """(block keys in SFC order, {field: ordered numpy}) of either
    package's forest."""
    sim.sync_fields()
    f = sim.forest
    order = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in order]
    out = {}
    for k, v in f.fields.items():
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        out[k] = a[np.asarray(order)]
    return keys, out


@pytest.fixture(scope="module")
def jax_forest():
    """The JAX package's shaped forest (the fish), three level-2 blocks
    refined to level 3 by hand (2:1 balanced) and every slot field drawn
    from a seed: a multilevel state without a JAX compile."""
    argv = FOREST_FLAGS + ["-shapes", FOREST_FISH]
    js = JAMR(JConfig.from_argv(argv))
    f = js.forest
    for (l, i, j) in ((2, 3, 1), (2, 4, 1), (2, 3, 2)):
        f.release(l, i, j)
        for a in (0, 1):
            for b in (0, 1):
                f.allocate(l + 1, 2 * i + a, 2 * j + b)
    rng = np.random.default_rng(7)
    for k, v in list(f.fields.items()):
        f.fields[k] = jnp.asarray(rng.standard_normal(v.shape))
    js.time, js.step_count = 0.375, 12
    return js


def _port_forest(**kw):
    return AMRSim(SimConfig.from_argv(FOREST_FLAGS + ["-shapes",
                                                      FOREST_FISH]),
                  device="cpu", **kw)


def test_dump_uniform_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    vel = rng.standard_normal((2, 24, 40))
    h = 1.0 / 40
    jio.dump_uniform(str(tmp_path / "j"), 0.375, jnp.asarray(vel), h)
    tio.dump_uniform(str(tmp_path / "t"), 0.375,
                     torch.tensor(vel, dtype=torch.float64), h)
    j, t = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert j[".xyz.raw"] == t[".xyz.raw"]
    assert j[".attr.raw"] == t[".attr.raw"]
    assert j[".xdmf2"].replace(b"j.", b"t.") == t[".xdmf2"]
    time, xyz, attr = tio.read_dump(str(tmp_path / "t"))
    assert time == 0.375 and xyz.shape == (24 * 40, 4, 2)
    assert np.array_equal(attr[:, 0], vel[0].ravel().astype(np.float32))


def test_dump_forest_bytes_equal_jax(jax_forest, tmp_path):
    js = jax_forest
    ts = AMRSim(config_from_dict(dataclasses.asdict(js.cfg)), device="cpu")
    copy_amr_state(js, ts)
    assert len({k[0] for k in ts.forest.blocks}) > 1     # multilevel
    js.sync_fields()
    jio.dump_forest(str(tmp_path / "j"), js.time, js.forest)
    ts.sync_fields()
    tio.dump_forest(str(tmp_path / "t"), ts.time, ts.forest)
    j, t = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert j[".xyz.raw"] == t[".xyz.raw"]
    assert j[".attr.raw"] == t[".attr.raw"]
    assert j[".xdmf2"].replace(b"j.", b"t.") == t[".xdmf2"]
    _, _, attr = tio.read_dump(str(tmp_path / "t"))
    assert len(attr) == 41 * 64 and np.abs(attr[:, :2]).min() > 0


def test_jax_forest_checkpoint_loads_bit_for_bit(jax_forest, tmp_path):
    js = jax_forest
    ck = str(tmp_path / "ck")
    jio.save_checkpoint(ck, js)
    ts = _port_forest()
    tio.load_checkpoint(ck, ts)
    jkeys, jf = _ordered(js)
    tkeys, tf = _ordered(ts)
    assert tkeys == jkeys
    assert set(tf) == set(jf) == {"vel", "pres", "chi"}
    for k in jf:
        assert np.array_equal(tf[k], jf[k]), k
    assert (ts.time, ts.step_count) == (js.time, js.step_count)
    assert ts._initialized
    (a,), (b,) = js.shapes, ts.shapes
    assert type(b) is FishShape
    assert sorted(vars(a)) == sorted(vars(b))
    for key in ("com", "center", "orientation", "u", "v", "omega", "M",
                "J", "length"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    # a dump of the loaded state is the JAX dump's bytes
    tio.dump_forest(str(tmp_path / "t"), ts.time, ts.forest)
    jio.dump_forest(str(tmp_path / "j"), js.time, js.forest)
    assert _files(str(tmp_path / "t"))[".attr.raw"] == \
        _files(str(tmp_path / "j"))[".attr.raw"]


def test_shapes_unpickler_refuses_other_jax_names():
    import io as _io
    # a pickle naming a JAX-package class other than the two models
    data = b"ccup2d_tpu.sim\nSimulation\n."
    with pytest.raises(pickle.UnpicklingError, match="cup2d_tpu.sim"):
        tio._ShapesUnpickler(_io.BytesIO(data)).load()
    for mod in ("jax", "jax._src.array", "jaxlib.xla_extension"):
        data = f"c{mod}\nArrayImpl\n.".encode()
        with pytest.raises(pickle.UnpicklingError, match=mod):
            tio._ShapesUnpickler(_io.BytesIO(data)).load()
    fish = b"ccup2d_tpu.models.fish\nFishShape\n."
    assert tio._ShapesUnpickler(_io.BytesIO(fish)).load() is FishShape


def _run_forest(sim, steps, save_at=None, ck=None):
    """The CLI's schedule: adapt at steps <= 10 and every AdaptSteps, then
    the step; a checkpoint after step ``save_at``. Returns the adapts'
    results from step ``save_at`` on."""
    changed = []
    while sim.step_count < steps:
        if sim.step_count <= 10 or \
                sim.step_count % sim.cfg.adapt_steps == 0:
            c = sim.adapt()
            if save_at is None or sim.step_count >= save_at:
                changed.append(c)
        sim.step_once()
        if sim.step_count == save_at:
            tio.save_checkpoint(ck, sim)
    return changed


def test_port_forest_restart_bit_for_bit(tmp_path):
    ck = str(tmp_path / "ck")
    a = _port_forest()
    a.initialize()
    a.compute_forces_every = 1
    changed = _run_forest(a, 13, save_at=2, ck=ck)
    assert any(changed)                  # a regrid after the checkpoint
    b = _port_forest()
    tio.load_checkpoint(ck, b)
    assert b.step_count == 2 and b._npad_hwm == 128
    _run_forest(b, 13)
    assert a.time == b.time and a._coarse_on == b._coarse_on
    ka, fa = _ordered(a)
    kb, fb = _ordered(b)
    assert ka == kb
    for k in fa:
        assert torch.equal(torch.from_numpy(fa[k]),
                           torch.from_numpy(fb[k])), k
    for sa, sb in zip(a.shapes, b.shapes):
        assert sa.forces == sb.forces
        assert (sa.u, sa.v, sa.omega) == (sb.u, sb.v, sb.omega)
    assert a._next_dt == b._next_dt
    assert b._n_refined > 0                 # counted for the metrics


def _disk_sim():
    cfg = SimConfig(bpdx=1, bpdy=1, level_max=1, level_start=0, extent=1.0,
                    nu=1e-3, cfl=0.4, lam=1e6, dtype="float64",
                    max_poisson_iterations=100)
    disk = DiskShape(0.1, 0.4, 0.5, prescribed=(0.2, 0.0))
    return Simulation(cfg, shapes=[disk], level=3, device="cpu")


def test_port_uniform_restart_resumes(tmp_path):
    """The JAX package's tests/test_io.py::test_checkpoint_resume_bitexact
    on the port: 3 steps, a checkpoint, 3 more; a restart's 3 steps agree
    to 1e-12 (the restart recomputes dt from the state instead of the
    cached one)."""
    a = _disk_sim()
    for _ in range(3):
        a.step_once()
    ck = str(tmp_path / "ck")
    tio.save_checkpoint(ck, a)
    for _ in range(3):
        a.step_once()
    b = _disk_sim()
    tio.load_checkpoint(ck, b)
    assert b.step_count == 3 and b._next_dt is None
    for _ in range(3):
        b.step_once()
    assert float((a.state.vel - b.state.vel).abs().max()) <= UNIFORM_BAR
    assert abs(a.time - b.time) <= UNIFORM_BAR
    assert abs(a.shapes[0].com[0] - b.shapes[0].com[0]) <= UNIFORM_BAR
    with np.load(os.path.join(ck, "fields.npz")) as d:
        assert set(d.files) == {"vel", "pres", "chi", "us", "udef"}
        assert d["vel"].dtype == np.float64


def test_checkpoint_install_is_crash_safe(tmp_path):
    sim = _disk_sim()
    ck = str(tmp_path / "ck")
    tio.save_checkpoint(ck, sim)
    sim.step_once()
    tio.save_checkpoint(ck, sim)            # replaces, leaves no .old
    assert not os.path.exists(ck + ".old")
    assert json.load(open(os.path.join(ck, "meta.json")))["step_count"] == 1
    os.replace(ck, ck + ".old")             # a save died between renames
    log = EventLog(str(tmp_path / "events.jsonl"))
    set_event_log(log)
    try:
        b = _disk_sim()
        tio.load_checkpoint(ck, b)
    finally:
        set_event_log(None)
        log.close()
    assert b.step_count == 1
    ev = [json.loads(x) for x in open(tmp_path / "events.jsonl")]
    assert [e["event"] for e in ev] == ["checkpoint_fallback_old"]
    assert ev[0]["used"] == ck + ".old"
