"""Port parity for the forest on a mesh (``parallel.forest_mesh.
ShardedAMRSim`` and the forest half of ``parallel.shard_halo``), f64 on
the CPU, the shards on ``["cpu"] * D``.

* The per-device tables: the port's ``ShardTables`` (the vec3 / vec1 /
  sca1 halo sets with the shard-local face-copy paint, and the tables
  form of the Poisson operator), ``ShardPoissonOp`` and ``ShardFluxCorr``
  leaves equal the JAX package's host-built ``shard_tables`` /
  ``shard_poisson_op`` / ``shard_flux_corr`` leaves array for array, for
  D = 2, 4 and 8 and both exchange modes (the flux-correction rows in the
  two-segment order of ``flux.FluxCorrTables``, the JAX rows taken in
  that order). ``exchange_padding_stats`` equals JAX's dict for D = 2, 4,
  8 and 64.
* The overlapped block-Jacobi sweeps equal the unoverlapped composition
  e + P_inv (r - A e) with the split operator to 1e-12, and the
  single-device JAX forest smoother to 1e-10.
* ``ShardedAMRSim`` on 2 and 4 shards, and the port's ``AMRSim``,
  against single-device JAX ``AMRSim``: 8 steps of the vortex forest with
  an adapt every 4, under structured, fas and tables (the lab-table
  operator): velocity and pressure <= 1e-10, equal iterations, equal
  block sets. The JAX package's own ``ShardedAMRSim`` trajectory is
  no oracle here: its sharded smoother fails under jax 0.9.0.
* Against the port's own ``AMRSim`` (<= 1e-11; every full reduction of
  both sums the same 16-block group partials in the same order
  (``shard_halo.block_sum``), so the split step is bit for bit on the
  CPU): D = 3 (the replicated fallback), the ``allgather`` exchange, and
  the shaped
  canonical forest at levelMax 6 through ``initialize()``, the exact
  startup steps and an adapt.
* Split snapshots: the device ring clones every shard, and a restore
  installs fresh clones, bit for bit the uninterrupted steps.
* ``Blocks`` follows its block axis: ops along it (an index, a reduction,
  ``cat``, ``index_select``, ``gather``, ``narrow``, a merging reshape)
  raise ``TypeError``; ops beside it keep the whole tensor's values."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import flux as jflux  # noqa: E402
from cup2d_tpu import halo as jhalo  # noqa: E402
from cup2d_tpu.amr import AMRSim as JSim  # noqa: E402
from cup2d_tpu.config import SimConfig  # noqa: E402
from cup2d_tpu.parallel import shard_halo as jsh  # noqa: E402
from cup2d_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from cup2d_tpu_torch import flux as tflux  # noqa: E402
from cup2d_tpu_torch import halo as thalo  # noqa: E402
from cup2d_tpu_torch import io as tio  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim as TSim  # noqa: E402
from cup2d_tpu_torch.config import SimConfig as TCfg  # noqa: E402
from cup2d_tpu_torch.convert import (config_from_dict,  # noqa: E402
                                     copy_amr_state)
from cup2d_tpu_torch.parallel import shard_halo as tsh  # noqa: E402
from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from cup2d_tpu_torch.poisson import apply_block_precond_blocks  # noqa: E402


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
OWN_BAR = 1e-11
# the vortex forest of tests/test_torch_amr.py on a 2x2 root grid from
# level 2: 88 blocks after the first adapt, n_pad 128, so every shard of
# D = 2 and three of D = 4 hold real blocks
VORTEX = dict(bpdx=2, bpdy=2, level_max=4, level_start=2, extent=1.0,
              nu=1e-4, cfl=0.4, dtype="float64", max_poisson_iterations=100,
              poisson_tol=1e-4, poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)


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


def _ordered(sim, jax_side):
    """(block keys in SFC order, ordered vel, ordered pres) as numpy."""
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in o]
    get = (lambda a: np.asarray(a)[o]) if jax_side else \
        (lambda a: a.numpy()[o])
    return keys, get(f.fields["vel"]), get(f.fields["pres"])


@pytest.fixture(scope="module")
def twins():
    """One JAX and one port forest built alike (same config, velocity and
    adapt, so the same slots), refreshed."""
    cfg = SimConfig(**VORTEX)
    js = JSim(cfg, shapes=[])
    ts = TSim(config_from_dict(dataclasses.asdict(cfg)), shapes=[],
              device="cpu")
    vel = _vortex_vel(cfg, js.forest.blocks, js.forest.capacity)
    js.forest.fields["vel"] = jnp.asarray(vel)
    ts.forest.fields["vel"] = torch.tensor(vel)
    assert js.adapt() and ts.adapt()
    js._refresh()
    ts._refresh()
    assert js.forest.blocks == ts.forest.blocks
    assert js._npad_hwm == ts._npad_hwm == 128 and js._n_real > 64
    return js, ts


def _raw_sets(sim, mod_halo, mod_flux):
    f, order = sim.forest, sim._order
    topo = mod_halo._TopoIndex(f, order)
    n_pad = sim._npad_hwm
    raw = {"vec3": mod_halo.build_tables(f, order, 3, True, 2, topo=topo),
           "vec1": mod_halo.build_tables(f, order, 1, False, 2, topo=topo),
           "sca1": mod_halo.build_tables(f, order, 1, False, 1, topo=topo),
           "pois": mod_flux.build_poisson_tables(f, order, topo=topo)}
    fc = mod_halo.build_face_copy(f, order, n_pad, topo)
    return raw, fc, topo


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    assert np.array_equal(a, b), what


SHARD_LEAVES = ("src_l", "sign_l", "dest_sl", "idx_l", "w_l", "dest_l",
                "src_r", "sign_r", "dest_sr", "idx_r", "w_r", "dest_r",
                "fc_nb", "fc_mask")


def _same_plan(t, j, what):
    assert t.offsets == j.offsets and t.S == j.S and t.B == j.B, what
    assert tuple(map(tuple, t.perms)) == tuple(map(tuple, j.perms)), what
    assert len(t.pack) == len(j.pack), what
    for k, (a, b) in enumerate(zip(t.pack, j.pack)):
        _eq(a, b, f"{what} pack[{k}]")


@pytest.mark.parametrize("mode", ["ppermute", "allgather"])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_tables_match_jax(twins, D, mode):
    js, ts = twins
    n_pad = ts._npad_hwm
    jraw, jfc, jtopo = _raw_sets(js, jhalo, jflux)
    traw, tfc, ttopo = _raw_sets(ts, thalo, tflux)
    jmesh, tmesh = jmake_mesh(D), make_mesh(devices=["cpu"] * D)
    fast = {"vec3": True, "vec1": False, "sca1": False}
    for k in ("vec3", "vec1", "sca1", "pois"):
        kw_j = kw_t = {}
        if k in fast:
            kw_j = dict(fc=jfc, corners=fast[k])
            kw_t = dict(fc=tfc, corners=fast[k])
        j = jsh.shard_tables(jraw[k], n_pad, jmesh, mode=mode, **kw_j)
        t = tsh.shard_tables(traw[k], n_pad, tmesh, torch.float64,
                             mode=mode, **kw_t)
        _same_plan(t, j, k)
        assert t.n_regions == j.n_regions
        for leaf in SHARD_LEAVES:
            _eq(getattr(t, leaf), getattr(j, leaf), f"{k}.{leaf}")
    # the structured operator
    jop = jflux.build_poisson_structured(js.forest, js._order, n_pad,
                                         topo=jtopo)
    top = tflux.build_poisson_structured(ts.forest, ts._order, n_pad,
                                         topo=ttopo)
    j = jsh.shard_poisson_op(jop, n_pad, jmesh, mode=mode)
    t = tsh.shard_poisson_op(top, n_pad, tmesh, torch.float64, mode=mode)
    _same_plan(t, j, "pois op")
    for leaf in ("nba", "nbb", "m_same", "m_coarse", "m_fine", "m_wall",
                 "par", "wc0", "wc1", "mcl", "mfr", "d2own"):
        _eq(getattr(t, leaf), getattr(j, leaf), f"op.{leaf}")
    # the flux correction, in the two-segment order per device
    jc = jflux.build_flux_corr(js.forest, js._order, topo=jtopo)
    tc = tflux.build_flux_corr(ts.forest, ts._order, topo=ttopo)
    j = jsh.shard_flux_corr(jc, n_pad, jmesh, 8, dtype=np.float64,
                            mode=mode)
    t = tsh.shard_flux_corr(tc, n_pad, tmesh, 8, torch.float64, mode=mode)
    _same_plan(t, j, "corr")
    jv = np.asarray(j.valid)
    for d in range(D):
        n = int((jv[d] > 0).sum())
        dest = np.asarray(j.dest)[d, :n]
        first = np.zeros(n, bool)
        first[np.unique(dest, return_index=True)[1]] = True
        perm = np.concatenate([np.nonzero(first)[0],
                               np.nonzero(~first)[0],
                               np.arange(n, jv.shape[1])])
        assert t.n_first[d] == int(first.sum())
        for leaf in ("dest", "cidx", "fidx1", "fidx2", "valid"):
            _eq(getattr(t, leaf)[d], np.asarray(getattr(j, leaf))[d][perm],
                f"corr.{leaf}[{d}]")


@pytest.mark.parametrize("mode", ["ppermute", "allgather"])
def test_exchange_padding_stats_match_jax(twins, mode):
    js, ts = twins
    n_pad = ts._npad_hwm
    jraw = _raw_sets(js, jhalo, jflux)[0]
    traw = _raw_sets(ts, thalo, tflux)[0]
    for D in (2, 4, 8, 64):
        j = jsh.exchange_padding_stats(jraw["vec3"], n_pad, D, mode=mode)
        t = tsh.exchange_padding_stats(traw["vec3"], n_pad, D, mode=mode)
        assert t == j, (D, t, j)


def test_overlap_block_jacobi_matches_composition_and_jax(twins):
    js, ts = twins
    n_pad = ts._npad_hwm
    sh = ShardedAMRSim(ts.cfg, make_mesh(devices=["cpu"] * 4), shapes=[])
    copy_amr_state(ts, sh)
    sh._refresh()
    op = sh._tables["pois"]
    assert isinstance(op, tsh.ShardPoissonOp)
    rng = np.random.default_rng(5)
    e0 = rng.standard_normal((n_pad, 8, 8))
    r0 = rng.standard_normal((n_pad, 8, 8))
    e0[ts._n_real:] = r0[ts._n_real:] = 0.0
    e = tsh.split_blocks(torch.tensor(e0), sh.mesh)
    r = tsh.split_blocks(torch.tensor(r0), sh.mesh)
    got = tsh.overlap_block_jacobi_sweeps(e, r, sh.p_inv, op, 3)
    want = e
    for _ in range(3):
        want = want + apply_block_precond_blocks(
            r - tflux.poisson_apply_structured(want, op), sh.p_inv)
    got, want = tsh.gather_blocks(got), tsh.gather_blocks(want)
    assert float((got - want).abs().max()) <= 1e-12

    def aj(v):
        return jflux.poisson_apply_structured(v, js._tables["pois"])
    ref = js._fas_block_smoother(aj, js._tables["pois"])(
        jnp.asarray(e0), jnp.asarray(r0), 3)
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= TRAJ_BAR


@pytest.fixture(scope="module", params=["structured", "fas", "tables"])
def mesh_runs(request):
    """8 steps of the vortex forest, an adapt before steps 0 and 4, by
    single-device JAX, the port's ``AMRSim`` (key 1) and the port on 2
    and 4 shards."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CUP2D_POIS", request.param)
    try:
        cfg = SimConfig(**VORTEX)
        tcfg = config_from_dict(dataclasses.asdict(cfg))
        js = JSim(cfg, shapes=[])
        ports = {1: TSim(tcfg, shapes=[], device="cpu")}
        ports.update({D: ShardedAMRSim(tcfg, make_mesh(
            devices=["cpu"] * D), shapes=[]) for D in (2, 4)})
    finally:
        mp.undo()
    vel = _vortex_vel(cfg, js.forest.blocks, js.forest.capacity)
    js.forest.fields["vel"] = jnp.asarray(vel)
    for s in ports.values():
        s.forest.fields["vel"] = torch.tensor(vel)
    rows = []
    for k in range(8):
        row = {}
        if k % 4 == 0:
            row["adapt"] = [js.adapt()] + [s.adapt() for s in ports.values()]
        jd = js.step_once()
        row["iters"] = [int(jd["poisson_iters"])] + [
            s.step_once()["poisson_iters"] for s in ports.values()]
        kj, vj, pj = _ordered(js, True)
        row["keys"] = [kj]
        row["err"] = []
        for s in ports.values():
            kt, vt, pt = _ordered(s, False)
            row["keys"].append(kt)
            row["err"].append((np.abs(vj - vt).max(),
                               np.abs(pj - pt).max()))
        rows.append(row)
    return request.param, ports, rows


def test_sharded_forest_matches_jax(mesh_runs):
    pois, ports, rows = mesh_runs
    assert ports[2]._split and ports[4]._split
    for k, row in enumerate(rows):
        assert len(set(row["iters"])) == 1, (pois, k, row["iters"])
        assert all(kk == row["keys"][0] for kk in row["keys"]), (pois, k)
        for ev, ep in row["err"]:
            assert ev <= TRAJ_BAR and ep <= TRAJ_BAR, (pois, k, ev, ep)
        if "adapt" in row:
            assert len(set(row["adapt"])) == 1
    assert rows[0]["adapt"][0]
    assert any(r["iters"][0] for r in rows)
    # the split state really spans the shards, and the metrics see it
    s4 = ports[4]
    assert s4._comm_stats["halo_real_bytes"] > 0
    assert s4._comm_stats["halo_padded_bytes"] \
        >= s4._comm_stats["halo_real_bytes"]
    vel = s4._ordered_state()["vel"]
    assert isinstance(vel, tsh.Blocks) and len(vel.parts) == 4
    assert sum(bool(p.abs().max() > 0) for p in vel.parts) >= 2


def _own_pair(D, pois, exchange="ppermute", monkeypatch=None):
    monkeypatch.setenv("CUP2D_POIS", pois)
    monkeypatch.setenv("CUP2D_SHARD_EXCHANGE", exchange)
    cfg = TCfg(**VORTEX)
    solo = TSim(cfg, shapes=[], device="cpu")
    split = ShardedAMRSim(TCfg(**VORTEX), make_mesh(devices=["cpu"] * D),
                          shapes=[])
    for s in (solo, split):
        s.forest.fields["vel"] = torch.tensor(_vortex_vel(
            s.cfg, s.forest.blocks, s.forest.capacity))
    return solo, split


@pytest.mark.parametrize("D,pois,exchange", [
    (3, "fas", "ppermute"), (4, "tables", "allgather"),
    (4, "fft", "ppermute")])
def test_sharded_forest_matches_own_forest(D, pois, exchange, monkeypatch):
    """D = 3 runs the replicated fallback (128 blocks do not divide by 3);
    the tables form and the allgather exchange, and fft's mg2 two-level
    form, on four shards."""
    solo, split = _own_pair(D, pois, exchange, monkeypatch)
    for k in range(6):
        if k % 3 == 0:
            assert solo.adapt() == split.adapt()
        a, b = solo.step_once(), split.step_once()
        assert a["poisson_iters"] == b["poisson_iters"]
        ka, va, pa = _ordered(solo, False)
        kb, vb, pb = _ordered(split, False)
        assert ka == kb
        assert np.abs(va - vb).max() <= OWN_BAR
        assert np.abs(pa - pb).max() <= OWN_BAR
    assert split._split == (D != 3)
    assert (split._comm_stats is None) == (D == 3)


SHAPES = ("angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
          "angle=180 L=0.2 xpos=1.6 ypos=0.8")
CANON = ("-AdaptSteps 20 -bpdx 2 -bpdy 1 -CFL 0.5 -Ctol 1 -extent 4 "
         "-lambda 1e7 -levelMax 6 -levelStart 3 -maxPoissonIterations 1000 "
         "-maxPoissonRestarts 0 -nu 0.00004 -poissonTol 1e-3 "
         "-poissonTolRel 1e-2 -Rtol 2 -tdump 0 -tend 10.0 -dtype float64")


def test_shaped_forest_on_a_mesh_matches_own_forest():
    """The canonical two-fish forest at levelMax 6 (both fish penalized):
    ``initialize()`` once, then the same state on 4 shards; the exact
    startup steps (which part the packages; here both runs sum alike),
    the rasterization, momentum solve, collisions and force pass, and an
    adapt, every step within 1e-11, forces and body velocities too."""
    argv = CANON.split() + ["-shapes", SHAPES]
    solo = TSim(TCfg.from_argv(argv), device="cpu")
    solo.initialize()
    split = ShardedAMRSim(TCfg.from_argv(argv),
                          make_mesh(devices=["cpu"] * 4))
    copy_amr_state(solo, split)
    for k in range(4):
        if k == 2:
            assert solo.adapt() == split.adapt()
        a, b = solo.step_once(), split.step_once()
        assert a["poisson_iters"] == b["poisson_iters"]
        ka, va, pa = _ordered(solo, False)
        kb, vb, pb = _ordered(split, False)
        assert ka == kb
        assert np.abs(va - vb).max() <= OWN_BAR
        assert np.abs(pa - pb).max() <= OWN_BAR
        for s, t in zip(solo.shapes, split.shapes):
            assert abs(s.u - t.u) <= OWN_BAR and abs(s.omega - t.omega) \
                <= OWN_BAR
            assert abs(s.forces["forcex"] - t.forces["forcex"]) <= OWN_BAR
    chi = split._ordered_state()["chi"]
    assert isinstance(chi, tsh.Blocks)
    assert float(tsh.gather_blocks(chi).max()) >= 0.5


def test_split_snapshot_clones_every_shard(monkeypatch):
    """The StepGuard's device snapshot of a split forest holds clones of
    every shard; a restore installs fresh clones (twice from one entry),
    and the steps replayed after it are bit for bit the first ones."""
    _, split = _own_pair(2, "fas", monkeypatch=monkeypatch)
    split.adapt()
    split.step_once()
    snap = tio.snapshot_state_device(split)
    ordf = split._ordered_state()
    for k, v in snap.payload.items():
        assert isinstance(v, tsh.Blocks)
        assert all(p.data_ptr() != q.data_ptr()
                   for p, q in zip(v.parts, ordf[k].parts))
    assert tio.snapshot_nbytes(snap) == sum(
        p.numel() * 8 for v in snap.payload.values() for p in v.parts)
    runs = []
    for _ in range(2):
        tio.restore_snapshot_device(split, snap)
        assert all(p.data_ptr() != q.data_ptr()
                   for k, v in snap.payload.items()
                   for p, q in zip(v.parts,
                                   split._ordered_state()[k].parts))
        split.step_once()
        split.step_once()
        runs.append(_ordered(split, False))
    assert runs[0][0] == runs[1][0]
    assert np.array_equal(runs[0][1], runs[1][1])
    assert np.array_equal(runs[0][2], runs[1][2])


def _split_pair(D=2, n=8):
    x = torch.arange(n * 2 * 3, dtype=torch.float64).reshape(n, 2, 3)
    return x, tsh.split_blocks(x, make_mesh(devices=["cpu"] * D))


@pytest.mark.parametrize("op", [
    lambda b: b[:3],
    lambda b: b[1],
    lambda b: b[torch.tensor([0, 2])],
    lambda b: b[..., 0, 0, 1],
    lambda b: b.sum(dim=0),
    lambda b: torch.sum(b, dim=(0, 2)),
    lambda b: torch.amax(b, -3),
    lambda b: b.mean(dim=0),
    lambda b: torch.cat([b, b], dim=0),
    lambda b: torch.cat([b, b]),
    lambda b: b.index_select(0, torch.tensor([0])),
    lambda b: torch.gather(b, 0, torch.zeros((1, 2, 3), dtype=torch.long)),
    lambda b: b.narrow(0, 0, 2),
    lambda b: torch.roll(b, 1),
    lambda b: b.reshape(-1),
    lambda b: b.flatten(),
    lambda b: torch.stack([b, b])[:, 1:],
    lambda b: b.transpose(0, 1).sum(dim=1),
], ids=["slice", "int", "tensor index", "ellipsis", "sum dim 0",
        "sum dims (0, 2)", "amax dim -3", "mean dim 0", "cat dim 0",
        "cat default", "index_select", "gather", "narrow", "roll flat",
        "reshape -1", "flatten", "stacked slice", "transposed sum"])
def test_blocks_refuse_ops_along_the_block_axis(op):
    _, b = _split_pair()
    with pytest.raises(TypeError, match="block"):
        op(b)


def test_blocks_ops_beside_the_block_axis_follow_it():
    x, b = _split_pair()
    cases = [
        (lambda t: t[:, 1], 0),
        (lambda t: t[..., 1:], 0),
        (lambda t: t[:, None, 0], 0),
        (lambda t: t[None], 1),
        (lambda t: torch.sum(t, dim=(1, 2)), 0),
        (lambda t: torch.amax(t, dim=-1, keepdim=True), 0),
        (lambda t: torch.sum(torch.stack([t, 2 * t]), dim=0), 0),
        (lambda t: torch.stack([t, t], dim=1)[:, 0], 0),
        (lambda t: t.transpose(0, 1), 1),
        (lambda t: t.permute(2, 0, 1), 1),
        (lambda t: t.unsqueeze(0) * t[:, :1], 1),
        (lambda t: torch.cat([t, t], dim=-1), 0),
        (lambda t: t.reshape(t.shape[0], 6), 0),
    ]
    for fn, axis in cases:
        got = fn(b)
        assert got.axis == axis
        assert torch.equal(tsh.gather_blocks(got), fn(x))
    # full reductions still combine every shard: a sum through the
    # forest's group partials (whole groups of 16 blocks on each shard),
    # bit for bit the helper's solo value; a bare full sum refuses
    xg, bg = _split_pair(n=64)
    assert torch.equal(tsh.block_sum(bg), tsh.block_sum(xg))
    with pytest.raises(TypeError, match="block_sum"):
        torch.sum(bg)
    assert torch.equal(torch.amax(b), torch.amax(x))
