"""Re-meshing a split run and the resharded snapshot restore, f64 on the
CPU: ports of the JAX package's elastic contracts (tests/test_elastic.py
``test_remesh_rejects_indivisible`` and
``test_forest_snapshot_reshard_matches_checkpoint``), held against the
port's own checkpoint path.

* ``ShardedUniformSim.remesh`` raises ``ValueError`` where Nx does not
  divide by the new mesh's size.
* A forest ``DeviceSnapshot`` taken on 4 shards, restored onto 2
  (``io.restore_snapshot_resharded``), matches ``load_checkpoint`` of the
  same state within 1e-12 on both branches: a fresh sim on 2 shards (the
  topology reinstall), and the donor itself after ``remesh`` (the ordered
  state's fast path, re-placed on the new mesh). ``snapshot_covers``
  keeps the reference's owner rule.
* A forest and a uniform run re-meshed from 4 shards to 2 mid-run step bit
  for bit like a sim built on 2 shards from the same state; the uniform
  resharded restore installs the snapshot's state on the new mesh.
* A re-mesh onto the mesh of another world refuses, naming item 8."""

import numpy as np
import pytest
import torch

from cup2d_tpu_torch.config import SimConfig
from cup2d_tpu_torch.convert import copy_amr_state
from cup2d_tpu_torch.io import (load_checkpoint, restore_snapshot_resharded,
                                save_checkpoint, snapshot_covers,
                                snapshot_state_device)
from cup2d_tpu_torch.parallel import shard_halo as tsh
from cup2d_tpu_torch.parallel.forest_mesh import ShardedAMRSim
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim, SlabMesh,
                                           make_mesh, unshard_state)
from cup2d_tpu_torch.uniform import taylor_green_state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(D):
    return make_mesh(devices=["cpu"] * D)


def _cfg(**kw):
    base = dict(bpdx=2, bpdy=1, level_max=1, level_start=0, extent=2.0,
                nu=1e-3, cfl=0.4, dtype="float64",
                max_poisson_iterations=200)
    base.update(kw)
    return SimConfig(**base)


def _sharded(mesh, level=2):
    sim = ShardedUniformSim(_cfg(), mesh, level=level)
    sim.set_state(taylor_green_state(sim.grid))
    # production steps from the start: nothing here depends on the exact
    # startup solves
    sim.step_count = 20
    return sim


def test_remesh_rejects_indivisible():
    sim = _sharded(_cpu(4))                      # nx = 64
    with pytest.raises(ValueError):
        sim.remesh(_cpu(3))


def _world_mesh_of_others(D=2):
    """A mesh as ``SlabMesh.over_world`` builds it on rank 0 of a 2-rank
    world, without a process group: its second shard is another rank's."""
    m = SlabMesh.__new__(SlabMesh)
    m.devices = (torch.device("cpu"), None)[:D]
    m.owners = tuple(range(D))
    m.rank, m.world, m.distributed = 0, D, True
    m.local = (0,)
    return m


def test_remesh_onto_another_world_refuses():
    sim = _sharded(_cpu(4))
    with pytest.raises(NotImplementedError, match="item 8"):
        sim.remesh(_world_mesh_of_others())
    forest = ShardedAMRSim(_forest_cfg(), _cpu(4), shapes=[])
    with pytest.raises(NotImplementedError, match="item 8"):
        forest.remesh(_world_mesh_of_others())
    # a single-controller mesh takes any other one, a smaller one too
    sim.remesh(_cpu(2))
    assert sim.mesh.size == 2 and len(sim.state.vel.parts) == 2


def _forest_cfg():
    return SimConfig(bpdx=1, bpdy=1, level_max=2, level_start=1,
                     extent=1.0, dtype="float64", nu=1e-3,
                     max_poisson_iterations=40)


def test_forest_snapshot_reshard_matches_checkpoint(tmp_path):
    cfg = _forest_cfg()
    mesh2 = _cpu(2)
    rng = np.random.default_rng(0)
    sim = ShardedAMRSim(cfg, _cpu(4), shapes=[])
    f = sim.forest
    f.fields["vel"] = f.fields["vel"] + torch.tensor(
        0.1 * rng.standard_normal(tuple(f.fields["vel"].shape)))
    sim.time, sim.step_count = 0.125, 17

    snap = snapshot_state_device(sim)
    assert snapshot_covers(snap)      # single process: every shard local
    assert snapshot_covers(snap, lost_processes=(1,))
    assert not snapshot_covers(snap, lost_hosts=(1,), shards_destroyed=True)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, sim)

    # branch 1: a fresh sim on the smaller mesh (another forest version:
    # the topology reinstall)
    over = ShardedAMRSim(cfg, mesh2, shapes=[])
    restore_snapshot_resharded(over, snap)
    ref = ShardedAMRSim(cfg, mesh2, shapes=[])
    load_checkpoint(ck, ref)
    over.sync_fields()
    ref.sync_fields()
    assert over.time == ref.time and over.step_count == ref.step_count
    for k in f.fields:
        a = over.forest.fields[k].numpy()
        b = ref.forest.fields[k].numpy()
        assert np.max(np.abs(a - b)) <= 1e-12, k

    # branch 2: the donor re-meshed in place (the same forest version: the
    # ordered state's fast path), then the snapshot re-placed
    sim.remesh(mesh2)
    restore_snapshot_resharded(sim, snap)
    ordv = sim._ordered_state()["vel"]
    assert isinstance(ordv, tsh.Blocks) and ordv.mesh is mesh2
    assert len(ordv.parts) == 2
    sim.sync_fields()
    # compare in SFC order: slot numbers are an allocator detail
    oa = sim.forest.order()
    ob = ref.forest.order()
    for k in f.fields:
        a = sim.forest.fields[k].numpy()[oa]
        b = ref.forest.fields[k].numpy()[ob]
        assert np.max(np.abs(a - b)) <= 1e-12, k
    assert sim.mesh.size == 2 and sim._split


# the vortex forest of tests/test_torch_forest_mesh.py (n_pad 128)
VORTEX = dict(bpdx=2, bpdy=2, level_max=4, level_start=2, extent=1.0,
              nu=1e-4, cfl=0.4, dtype="float64", max_poisson_iterations=100,
              poisson_tol=1e-4, poisson_tol_rel=1e-3, rtol=2.0, ctol=0.5)


def _vortex(sim):
    bs = sim.cfg.bs
    vals = np.zeros((sim.forest.capacity, 2, bs, bs))
    for (l, i, j), s in sim.forest.blocks.items():
        h = sim.cfg.h_at(l)
        x = (i * bs + np.arange(bs) + 0.5) * h - 0.5
        y = (j * bs + np.arange(bs) + 0.5) * h - 0.5
        X, Y = np.meshgrid(x, y, indexing="xy")
        r2 = X ** 2 + Y ** 2
        ut = 0.5 / (2 * np.pi * np.sqrt(r2 + 1e-12)) \
            * (1 - np.exp(-r2 / (2 * 0.0064)))
        th = np.arctan2(Y, X)
        vals[s, 0] = -ut * np.sin(th)
        vals[s, 1] = ut * np.cos(th)
    sim.forest.fields["vel"] = torch.tensor(vals)


def _ordered(sim):
    sim.sync_fields()
    f = sim.forest
    o = f.order()
    return f.fields["vel"].numpy()[o], f.fields["pres"].numpy()[o]


@pytest.mark.parametrize("pois", ["default", "fas"])
def test_forest_remesh_mid_run_steps_like_a_fresh_mesh(pois, monkeypatch):
    if pois == "fas":
        monkeypatch.setenv("CUP2D_POIS", "fas")
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    sim = ShardedAMRSim(SimConfig(**VORTEX), _cpu(4), shapes=[])
    _vortex(sim)
    sim.adapt()
    for _ in range(2):
        sim.step_once()
    fresh = ShardedAMRSim(SimConfig(**VORTEX), _cpu(2), shapes=[])
    copy_amr_state(sim, fresh)
    sim.remesh(_cpu(2))
    assert sim._split and len(sim._ordered_state()["vel"].parts) == 2
    for k in range(2):
        a, b = sim.step_once(), fresh.step_once()
        assert a["poisson_iters"] == b["poisson_iters"], k
        va, pa = _ordered(sim)
        vb, pb = _ordered(fresh)
        assert np.array_equal(va, vb) and np.array_equal(pa, pb), k


@pytest.mark.parametrize("pois", ["default", "fas"])
def test_uniform_remesh_mid_run_steps_like_a_fresh_mesh(pois, monkeypatch):
    if pois == "fas":
        monkeypatch.setenv("CUP2D_POIS", "fas")
    else:
        monkeypatch.delenv("CUP2D_POIS", raising=False)
    sim = _sharded(_cpu(4))
    for _ in range(2):
        sim.step_once()
    fresh = _sharded(_cpu(2))
    fresh.set_state(unshard_state(sim.state))
    fresh.time, fresh.step_count = sim.time, sim.step_count
    fresh._next_dt = sim._next_dt
    snap = snapshot_state_device(sim)
    sim.remesh(_cpu(2))
    assert len(sim.state.vel.parts) == 2
    for k in range(2):
        a, b = sim.step_once(), fresh.step_once()
        assert a["poisson_iters"] == b["poisson_iters"], k
        for x, y in zip(unshard_state(sim.state), unshard_state(fresh.state)):
            assert torch.equal(x, y), k
    # the ring's entry of 4 shards, installed on the 2-shard mesh
    restore_snapshot_resharded(sim, snap)
    assert sim.state.vel.mesh is sim.mesh and len(sim.state.vel.parts) == 2
    for x, y in zip(unshard_state(sim.state), snap.payload.values()):
        assert torch.equal(x, tsh.gather_x(y))
