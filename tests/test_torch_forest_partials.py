"""The forest's full reductions in one order, and its per-shard
preconditioner, f64 on the CPU.

Every full reduction of the forest over its ordered blocks is the sum of
fixed groups of 16 blocks (``hopper_kernels.group_sum``: one pairwise
tree a group), then one ``torch.sum`` of the group partials
(``parallel.shard_halo.block_sum``); P_inv r runs per shard through kernel
8's twin, whose products have one fixed shape. So the split forest adds
the solo forest's terms in the solo forest's order:

* ``group_sum``'s twin gives a group the same bits whatever the number of
  groups in the call (1, 2, 8, 64) and the intra-op thread count, in the
  sum and the dot form, f32, f32 into f64 and f64, rows of odd length
  too; within a few ulps of an exact sum.
* ``block_precond_plain`` (kernel 8's twin) gives a block the same bits
  whatever N, and ``apply_block_precond_blocks``'s values.
* ``ShardedAMRSim`` at D = 2, 4 and 8 (D = 8: shards of exactly one
  group) is the solo ``AMRSim`` bit for bit: topology, iterations,
  velocity and pressure, under the default solver and fas.
* So through the 10 exact startup solves of a canonical-like shaped
  forest, which stall at the floor, and 4 production steps after them:
  the case whose per-shard partials parted from the solo run by O(1)
  within 14 steps while their order followed D.
* On a one-rank gloo world of 4 shards, no all-gather of a step carries
  more than the group partials of a reduction, and none carries the
  preconditioner's operand (``shard_halo.comm_stats`` by kind).

The solo forest's bars against the JAX package stand in
tests/test_torch_amr.py, test_torch_forest_mesh.py and
test_torch_canonical.py."""

import math
import socket

import numpy as np
import pytest
import torch

from cup2d_tpu_torch.amr import AMRSim
from cup2d_tpu_torch.config import SimConfig
from cup2d_tpu_torch.convert import copy_amr_state
from cup2d_tpu_torch.ops import hopper_kernels as hk
from cup2d_tpu_torch.parallel import shard_halo as tsh
from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
from cup2d_tpu_torch.parallel.mesh import make_mesh
from cup2d_tpu_torch.poisson import (apply_block_precond_blocks,
                                     block_precond_matrix)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the vortex forest of tests/test_torch_forest_mesh.py: n_pad 128, so
# D = 8 gives every shard one group of 16 blocks
VORTEX = dict(bpdx=2, bpdy=2, level_max=4, level_start=2, extent=1.0,
              nu=1e-4, cfl=0.4, dtype="float64", max_poisson_iterations=100,
              poisson_tol=1e-4, poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)
FORMS = [(torch.float32, torch.float32), (torch.float32, torch.float64),
         (torch.float64, torch.float64)]


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


def _state(sim):
    """(block keys in SFC order, ordered vel, ordered pres)."""
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    keys = [(int(f.level[s]), int(f.bi[s]), int(f.bj[s])) for s in o]
    return keys, f.fields["vel"].numpy()[o], f.fields["pres"].numpy()[o]


def _same(a, b):
    sa, sb = _state(a), _state(b)
    assert sa[0] == sb[0]
    assert np.array_equal(sa[1], sb[1])
    assert np.array_equal(sa[2], sb[2])


# ---------------------------------------------------------------------------
# the twins: a group's bits whatever the call holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dot", [False, True], ids=["sum", "dot"])
@pytest.mark.parametrize("ind,acc", FORMS,
                         ids=["f32", "f32-into-f64", "f64"])
@pytest.mark.parametrize("m", [1024, 2048, 16, 7])
def test_group_sum_twin_fixes_each_group(dot, ind, acc, m):
    rng = np.random.default_rng(m)
    rows = rng.standard_normal((64, m)) * np.exp(
        rng.uniform(-8, 8, (64, m)))
    a = torch.tensor(rows, dtype=ind)
    c = torch.tensor(rng.standard_normal((64, m)), dtype=ind) if dot \
        else None
    want = hk.group_sum(a[:1], None if c is None else c[:1], acc)
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            for G in (1, 2, 8, 64):
                got = hk.group_sum(a[:G], None if c is None else c[:G],
                                   acc)
                assert got.dtype == acc and got.shape == (G,)
                assert torch.equal(got[:1], want), (threads, G)
        finally:
            torch.set_num_threads(1)
    # an exact sum of the same terms (the products rounded in a's dtype)
    terms = (a * c if dot else a).to(torch.float64).numpy()
    exact = np.array([math.fsum(r) for r in terms])
    scale = np.abs(terms).sum(axis=1)
    got = hk.group_sum(a, c, acc).to(torch.float64).numpy()
    eps = torch.finfo(acc).eps
    assert np.all(np.abs(got - exact) <= 2 * math.log2(m + 1) * eps * scale)


def test_block_sum_splits_into_the_solo_order():
    """A split operand's block_sum is the whole operand's bit for bit at
    D = 1, 2, 4 and 8, for the dot and the sum, block axis 0 and 1; an
    operand whose shards would hold part of a group refuses."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((128, 8, 8)))
    y = torch.tensor(rng.standard_normal((128, 8, 8)))
    s = torch.tensor(rng.standard_normal((3, 128, 2, 8)))
    want = (tsh.block_sum(x, y), tsh.block_sum(x), tsh.block_sum(s, axis=1))
    for D in (1, 2, 4, 8):
        mesh = make_mesh(devices=["cpu"] * D)
        bx, by = tsh.split_blocks(x, mesh), tsh.split_blocks(y, mesh)
        bs = tsh.Blocks([p.contiguous() for p in torch.chunk(s, D, dim=1)],
                        mesh, axis=1)
        got = (tsh.block_sum(bx, by), tsh.block_sum(bx), tsh.block_sum(bs))
        for g, w in zip(got, want):
            assert torch.equal(g, w), D
    with pytest.raises(ValueError, match="whole groups"):
        tsh.block_sum(tsh.split_blocks(x, make_mesh(devices=["cpu"] * 16)))


def test_block_precond_twin_fixes_each_block():
    p_inv = torch.tensor(block_precond_matrix(8))
    rng = np.random.default_rng(4)
    r = torch.tensor(rng.standard_normal((1000, 8, 8)))
    want = hk.block_precond_plain(r, p_inv)
    for n in (16, 32, 128, 992):      # whole groups, as a shard holds
        assert torch.equal(hk.block_precond_plain(r[:n], p_inv), want[:n])
    ref = apply_block_precond_blocks(r, p_inv)
    assert float((want - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
    z = torch.zeros_like(r)
    assert torch.equal(hk.fused_block_jacobi_update(z, r, z, p_inv), want)


# ---------------------------------------------------------------------------
# the split forest is the solo forest, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["default", "fas"])
def vortex_runs(request):
    """6 steps of the vortex forest, an adapt before steps 0 and 3, solo
    and on 2, 4 and 8 shards; per step the states and iterations."""
    mp = pytest.MonkeyPatch()
    if request.param == "fas":
        mp.setenv("CUP2D_POIS", "fas")
    else:
        mp.delenv("CUP2D_POIS", raising=False)
    try:
        sims = {1: AMRSim(SimConfig(**VORTEX), shapes=[], device="cpu")}
        sims.update({D: ShardedAMRSim(SimConfig(**VORTEX), make_mesh(
            devices=["cpu"] * D), shapes=[]) for D in (2, 4, 8)})
    finally:
        mp.undo()
    for s in sims.values():
        s.forest.fields["vel"] = torch.tensor(_vortex_vel(
            s.cfg, s.forest.blocks, s.forest.capacity))
    rows = []
    for k in range(6):
        row = {}
        if k % 3 == 0:
            row["adapt"] = {D: s.adapt() for D, s in sims.items()}
        row["iters"] = {D: s.step_once()["poisson_iters"]
                        for D, s in sims.items()}
        row["state"] = {D: _state(s) for D, s in sims.items()}
        rows.append(row)
    return request.param, sims, rows


@pytest.mark.parametrize("D", [2, 4, 8])
def test_split_forest_equals_solo_bit_for_bit(vortex_runs, D):
    pois, sims, rows = vortex_runs
    assert sims[D]._split
    assert sims[D]._npad_hwm // D >= tsh.GROUP_BLOCKS
    for k, row in enumerate(rows):
        if "adapt" in row:
            assert row["adapt"][D] == row["adapt"][1]
        assert row["iters"][D] == row["iters"][1], (pois, k)
        solo, split = row["state"][1], row["state"][D]
        assert split[0] == solo[0]
        assert np.array_equal(split[1], solo[1]), (pois, k)
        assert np.array_equal(split[2], solo[2]), (pois, k)
    assert any(row["iters"][1] for row in rows)
    vel = sims[D]._ordered_state()["vel"]
    assert isinstance(vel, tsh.Blocks) and len(vel.parts) == D


SHAPES = ("angle=0 L=0.2 xpos=1.8 ypos=0.8\n"
          "angle=180 L=0.2 xpos=1.6 ypos=0.8")
CANON_LIKE = ("-AdaptSteps 20 -bpdx 2 -bpdy 1 -CFL 0.5 -Ctol 1 -extent 4 "
              "-lambda 1e7 -levelMax 5 -levelStart 3 "
              "-maxPoissonIterations 1000 -maxPoissonRestarts 0 "
              "-nu 0.00004 -poissonTol 1e-3 -poissonTolRel 1e-2 -Rtol 2 "
              "-tdump 0 -tend 10.0 -dtype float64")


def test_stalled_startup_solves_stay_bit_for_bit():
    """The canonical run's flags at levelMax 5 (two fish, 256 padded
    blocks): ``initialize()``, then the 10 exact startup steps, whose
    solves stall at the precision floor, and 4 production steps, solo and
    on 4 shards."""
    argv = CANON_LIKE.split() + ["-shapes", SHAPES]
    solo = AMRSim(SimConfig.from_argv(argv), device="cpu")
    solo.initialize()
    split = ShardedAMRSim(SimConfig.from_argv(argv),
                          make_mesh(devices=["cpu"] * 4))
    copy_amr_state(solo, split)
    stalled = 0
    for k in range(14):
        a, b = solo.step_once(), split.step_once()
        assert a["poisson_iters"] == b["poisson_iters"], k
        stalled += k < 10 and a["poisson_iters"] > 20
        _same(solo, split)
        for s, t in zip(solo.shapes, split.shapes):
            assert s.u == t.u and s.omega == t.omega, k
    assert split._split and stalled >= 3


# ---------------------------------------------------------------------------
# what a step all-gathers on a world
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_world():
    from cup2d_tpu_torch.parallel.launch import (init_distributed,
                                                 shutdown_distributed,
                                                 world_mesh)
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu",
                     timeout=60.0)
    try:
        yield world_mesh(4, "cpu")
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("pois", ["default", "fas"])
def test_world_step_gathers_partials_only(one_rank_world, pois,
                                          monkeypatch):
    """A production step and a startup step of the vortex forest on a
    one-rank world of 4 shards: each reduction all-gather carries at most
    one f64 partial per group (n_pad / 16 x 8 bytes), no all-gather
    carries the preconditioner's operand, and the step equals the solo
    step bit for bit."""
    if pois == "fas":
        monkeypatch.setenv("CUP2D_POIS", "fas")
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    solo = AMRSim(SimConfig(**VORTEX), shapes=[], device="cpu")
    split = ShardedAMRSim(SimConfig(**VORTEX), one_rank_world, shapes=[])
    for s in (solo, split):
        s.forest.fields["vel"] = torch.tensor(_vortex_vel(
            s.cfg, s.forest.blocks, s.forest.capacity))
        s.adapt()
    seen = []
    real = tsh.all_shards

    def recorder(parts, mesh, device=None, kind="state"):
        before = tsh.comm_stats["allgather_bytes"]
        out = real(parts, mesh, device, kind)
        seen.append((kind, tsh.comm_stats["allgather_bytes"] - before))
        return out
    monkeypatch.setattr(tsh, "all_shards", recorder)
    bound = split._npad_hwm // tsh.GROUP_BLOCKS * 8
    for step_count in (0, 10):
        solo.step_count = split.step_count = step_count
        tsh.reset_comm_stats()
        seen.clear()
        a, b = solo.step_once(), split.step_once()
        assert a["poisson_iters"] == b["poisson_iters"]
        _same(solo, split)
        by = tsh.comm_by_kind()
        assert by["preconditioner"] == (0, 0)
        red = [n for k, n in seen if k == "reductions"]
        assert red and max(red) <= bound, (max(red), bound)
        assert by["reductions"] == (len(red), sum(red))
        assert sum(c for c, _ in by.values()) \
            == tsh.comm_stats["allgathers"]
