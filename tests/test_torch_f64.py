"""f64 state on the card, as far as this CPU box can show it, and the regrid
helper's fallback to the Python sweep.

* The paths whose kernels have no f64 form yet (the x-split step: kernels 3
  and 7; ``CUP2D_POIS=fftd``: ``tridiag.cu``; a fleet on spatial
  placement) refuse f64 state on the card at construction, before any
  allocation (a ``cuda`` allocation would raise here: there is no card),
  naming the ROADMAP entry; so does the bf16 tier with f64 state, as in
  the JAX package. The f64 forms themselves run on the card only
  (tests/test_torch_cuda.py).
* The f64 forms' launch plans, chains and counters, which are pure
  functions of the shape.
* The one f64 twin pin the other files lack: the signed sweep chain
  against the JAX package's XLA sweeps, <= 1e-12 (the free-slip, BC and
  wrap substage pins, the Neumann, signed and wrap corrections, the
  Neumann and wrap chains, the lab RHS and every kernel-8 form are pinned
  in test_torch_kernels.py, test_torch_cavity.py, test_torch_periodic.py,
  test_torch_forest.py and test_torch_precond_forms.py).
* With no C compiler the regrid runs the Python sweep, bit for bit the
  helper's adapt, warns once, writes one build-ledger row and never calls
  the compiler again; ``CUP2D_NATIVE_CACHE`` names the helper's directory.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from cup2d_tpu import poisson as jp  # noqa: E402
from cup2d_tpu_torch import SimConfig, native, tracing  # noqa: E402
from cup2d_tpu_torch import cases as tcases  # noqa: E402
from cup2d_tpu_torch.amr import AMRSim, multilevel_forest  # noqa: E402
from cup2d_tpu_torch.convert import (forest_from_numpy,  # noqa: E402
                                     forest_to_numpy, state_from_numpy)
from cup2d_tpu_torch.fleet import FleetSim  # noqa: E402
from cup2d_tpu_torch.ops import hopper_kernels as hk  # noqa: E402
from cup2d_tpu_torch.parallel.mesh import (ShardedUniformSim,  # noqa: E402
                                           make_mesh)
from cup2d_tpu_torch.uniform import UniformGrid, check_card_f64  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_BAR = 1e-12
NY, NX = 32, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(bpdx=1, bpdy=1, level_max=4, level_start=3, extent=1.0,
                nu=1e-3, cfl=0.4, dtype="float64")
    base.update(kw)
    return SimConfig(**base)


def _card_mesh(n=2):
    return make_mesh(devices=["cuda:0"] * n)


# ---------------------------------------------------------------------------
# the refusals that remain, at construction
# ---------------------------------------------------------------------------

def _split():
    return ShardedUniformSim(_cfg(), _card_mesh(), level=3)


def _split_case():
    return tcases.make_sim("cavity", level=3, dtype="float64",
                           mesh=_card_mesh())


def _fftd():
    return UniformGrid(_cfg(), 3, device="cuda",
                       bc=tcases.periodic_table())


def _spatial_fleet():
    return FleetSim(_cfg(), level=3, members=2, mesh=_card_mesh(),
                    placement="spatial")


def _auto_spatial_fleet():
    # above member_cells_cap, auto places the members spatially
    return FleetSim(_cfg(), level=3, members=2, mesh=_card_mesh(),
                    member_cells_cap=0)


def _bf16_uniform():
    return UniformGrid(_cfg(), 3, device="cuda")


def _bf16_forest():
    return AMRSim(_cfg(level_start=1), shapes=[], device="cuda")


REFUSALS = {
    "split": (_split, {}, r"kernels 3 and 7.*note \(c\)"),
    "split_case": (_split_case, {}, r"kernels 3 and 7.*note \(c\)"),
    "fftd": (_fftd, {"CUP2D_POIS": "fftd"}, r"tridiag\.cu.*note \(c\)"),
    "spatial_fleet": (_spatial_fleet, {}, r"spatial.*note \(c\)"),
    "auto_spatial_fleet": (_auto_spatial_fleet, {}, r"spatial.*note \(c\)"),
    "bf16_uniform": (_bf16_uniform, {"CUP2D_PREC": "bf16"},
                     "needs f32 state"),
    "bf16_forest": (_bf16_forest, {"CUP2D_PREC": "bf16",
                                   "CUP2D_POIS": "fas"},
                    "needs f32 solver state"),
}


@pytest.mark.parametrize("path", sorted(REFUSALS))
def test_f64_paths_without_f64_kernels_refuse_on_the_card(path,
                                                          monkeypatch):
    build, env, match = REFUSALS[path]
    for k in ("CUP2D_POIS", "CUP2D_PREC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        build()


@pytest.mark.parametrize("device,dtype", [("cuda", torch.float32),
                                          ("cpu", torch.float64),
                                          ("cpu", "float64"),
                                          ("cuda:0", "float32")])
def test_card_f64_check_passes_what_runs(device, dtype):
    check_card_f64(device, dtype, "x")


@pytest.mark.parametrize("dtype", [torch.float64, "float64"])
def test_card_f64_check_names_the_roadmap_entry(dtype):
    with pytest.raises(ValueError, match=r"the split step at float64 on "
                       r"cuda:1.*ROADMAP\.md queue 2, note \(c\)"):
        check_card_f64("cuda:1", dtype, "the split step")


def test_f64_on_a_cpu_mesh_still_splits():
    """The refusal is the card's: the split step at f64 on CPU devices
    builds as before."""
    sim = ShardedUniformSim(_cfg(), make_mesh(devices=["cpu"] * 2), level=3)
    assert sim.grid.dtype == torch.float64 and sim.grid.mesh is not None


# ---------------------------------------------------------------------------
# the f64 forms' launch plans, chains and counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,aligned,vec", [(96, True, 2), (151, True, 1),
                                            (96, False, 1), (8, True, 2)])
def test_f64_substage_plan(nx, aligned, vec):
    """Copies of two values (16 bytes) where rows are whole 16-byte words
    and v is aligned, else of one; one persistent CTA an SM."""
    got_vec, grid = hk.substage_plan(3, 40, nx, 132, aligned, f64=True)
    tiles = 3 * -(-40 // hk.SUBSTAGE_TILE[0]) * -(-nx // hk.SUBSTAGE_TILE[1])
    assert got_vec == vec
    assert grid == min(tiles, 132 * hk.SUBSTAGE_CTAS_PER_SM_F64)
    # the f32 plan is what it was
    assert hk.substage_plan(3, 40, nx, 132, aligned) == (
        4 if nx % 4 == 0 and aligned else 1,
        min(tiles, 132 * hk.SUBSTAGE_CTAS_PER_SM))


@pytest.mark.parametrize("shape", [(1, 8192, 8192, 2), (1, 8192, 8192, 6),
                                   (1, 64, 64, 24), (3, 40, 71, 2)])
def test_f64_jacobi_plan(shape):
    """The f64 big tile has 32 rows out (its five f64 buffers fit one SM);
    copies of two values where nx is even and the pointers aligned."""
    L, ny, nx, n = shape
    big, vec, grid = hk.jacobi_plan(L, ny, nx, n, 132, True, f64=True)
    hx = 4 * -(-n // 4)
    ty, w = hk.JACOBI_TILES_F64[big]
    tiles = L * -(-ny // ty) * -(-nx // (w - 2 * hx))
    assert grid == min(tiles, 132 * hk.JACOBI_CTAS_PER_SM[big])
    assert vec == (2 if nx % 2 == 0 else 1)
    assert hk.JACOBI_TILES_F64[True] == (32, 128)
    assert hk.JACOBI_TILES_F64[False] == hk.JACOBI_TILES[False]


@pytest.mark.parametrize("nops,ctas", [(1, 3), (2, 2), (3, 1)])
def test_f64_block_jacobi_grid_is_one_wave(nops, ctas):
    """Kernel 8's f64 forms launch as many CTAs an SM as their shared
    memory (P_inv and a ring of ``nops`` operands, in f64, plus the 1 KB
    an SM reserves a CTA) lets one SM of 228 KB hold."""
    smem = 8 * (64 * 64 + 4 * 2 * nops * 8 * 68) + 1024
    assert hk.BLOCK_JACOBI_CTAS_PER_SM_F64[nops] == ctas
    assert ctas * smem <= 228 * 1024 < (ctas + 1) * smem
    assert hk.block_jacobi_grid(16384, 132, ctas) == 132 * ctas
    assert hk.block_jacobi_grid(33, 132, ctas) == 2


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 24])
def test_f64_chains_cut_into_the_built_launch_sizes(n):
    chain = hk.sweep_chain(n, f64=True)
    assert sum(chain) == n and set(chain) <= set(hk.BF16_CHAIN)
    assert chain == hk.sweep_chain(n, bf16=True)


@pytest.mark.parametrize("kernel", ["fused_advect_heun", "fused_correction",
                                    "fused_jacobi_sweeps", "fused_lab_rhs",
                                    "fused_block_jacobi_update"])
def test_f64_forms_have_a_counter_and_entries(kernel):
    assert hk.launches[kernel + "+f64"] == 0
    stem = os.path.basename(hk.source_of(kernel + "+f64"))[:-3]
    assert stem in hk._ENTRIES
    keys = [k for k, (s, name, _) in hk._FORM_ENTRIES.items()
            if s == stem and k.endswith("+f64")]
    assert keys and all(hk._FORM_ENTRIES[k][1].endswith("_f64")
                        for k in keys)
    assert not any(k.startswith(("advect_heun_halo", "jacobi_halo",
                                 "tridiag")) and k.endswith("+f64")
                   for k in hk._FORM_ENTRIES)


def test_f64_face_table_carries_double_wall_velocities():
    bc = tcases.channel_table(1.0 / 3.0, profile="parabolic")
    f32, f64 = hk._faces(bc), hk._faces(bc, f64=True)
    assert isinstance(f64, hk._Faces64)
    assert f64.x_lo.u == 1.0 / 3.0 and f32.x_lo.u != 1.0 / 3.0
    assert f64.x_lo.parabolic == f32.x_lo.parabolic == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_convert_keeps_the_dtype(dtype):
    rng = np.random.default_rng(3)
    fields = {k: rng.standard_normal(s) for k, s in (
        ("vel", (2, 8, 8)), ("pres", (8, 8)), ("chi", (8, 8)),
        ("us", (2, 8, 8)), ("udef", (2, 8, 8)))}
    st = state_from_numpy(fields, "cpu", dtype)
    assert st.vel.dtype == dtype
    if dtype == torch.float64:
        assert np.array_equal(st.vel.numpy(), fields["vel"])


# ---------------------------------------------------------------------------
# the signed sweep chain's twin against the JAX package's XLA sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signs", [(1.0, -1.0, 1.0, 1.0),
                                   (-1.0, 1.0, 1.0, -1.0)])
@pytest.mark.parametrize("n,from_zero", [(2, False), (3, True), (24, False),
                                         (6, True)])
def test_signed_sweeps_twin_vs_xla_f64(signs, n, from_zero):
    rng = np.random.default_rng(n + 10 * from_zero)
    e, r = rng.standard_normal((2, 2, NY, NX))
    mg = jp.MultigridPreconditioner(NY, NX, jnp.float64,
                                    cycle_dtype=jnp.float64,
                                    edge_signs=signs)
    ref = np.asarray(mg._smooth(jnp.asarray(e), jnp.asarray(r), 0, n,
                                from_zero=from_zero))
    got = hk.fused_jacobi_sweeps(torch.tensor(e), torch.tensor(r), 0.8, n,
                                 from_zero, signs).numpy()
    assert np.max(np.abs(got - ref)) <= F64_BAR * np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# the regrid helper's fallback
# ---------------------------------------------------------------------------

def _tags_recorder(monkeypatch):
    """Record each ``_fix_states``' tags after the sweep."""
    out = []
    fix = AMRSim._fix_states

    def rec(self, lv, bi, bj, st):
        fix(self, lv, bi, bj, st)
        out.append(st.copy())
    monkeypatch.setattr(AMRSim, "_fix_states", rec)
    return out


def _adapted(cfg, snap):
    sim = AMRSim(cfg, shapes=[], device="cpu")
    forest_from_numpy(sim, *snap)
    assert sim.adapt()
    return sim


def _fields(sim):
    order = sim.forest.order()
    return {k: v[order] for k, v in sim.fields().items()}


def test_regrid_falls_back_to_the_python_sweep_without_a_compiler(
        tmp_path, monkeypatch):
    start = multilevel_forest(dtype="float64", device="cpu", rounds=1)
    cfg, snap = start.cfg, forest_to_numpy(start)
    tags = _tags_recorder(monkeypatch)
    assert native.available()
    ref = _adapted(cfg, snap)
    ref_tags = tags.pop()
    # no compiler, a fresh cache directory, no helper loaded
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "_CACHE", [])
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setenv("CUP2D_NATIVE_CACHE", str(tmp_path / "native"))
    calls = []
    run = native.subprocess.run

    def counted(*a, **kw):
        calls.append(a)
        return run(*a, **kw)
    monkeypatch.setattr(native.subprocess, "run", counted)
    rec = tracing.FlightRecorder(spans=False).install()
    try:
        with pytest.warns(RuntimeWarning, match="Python 2:1 sweep"):
            got = _adapted(cfg, snap)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            again = _adapted(cfg, snap)
    finally:
        rec.uninstall()
    assert len(calls) == 1
    assert native._lib_path().parent == (tmp_path / "native").resolve()
    assert not native._lib_path().exists()
    rows = {k: e["count"] for k, e in rec.ledger.items() if e["count"]}
    assert rows == {"native.fix_states": 1}
    got_tags, again_tags = tags
    assert np.array_equal(got_tags, ref_tags)
    assert np.array_equal(again_tags, ref_tags)
    for sim in (got, again):
        assert set(sim.forest.blocks) == set(ref.forest.blocks)
        assert len(sim.forest.blocks) == len(ref.forest.blocks)
        a, b = _fields(sim), _fields(ref)
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_native_cache_directory_is_latched(tmp_path, monkeypatch):
    """``CUP2D_NATIVE_CACHE`` names the helper's directory, read once; the
    helper builds there and loads."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "_CACHE", [])
    monkeypatch.setenv("CUP2D_NATIVE_CACHE", str(tmp_path / "a"))
    first = native._lib_path()
    monkeypatch.setenv("CUP2D_NATIVE_CACHE", str(tmp_path / "b"))
    assert native._lib_path() == first
    assert first.parent == (tmp_path / "a").resolve()
    assert native.available() and first.exists()


def test_port_lint_is_clean_with_the_fallback():
    out = subprocess.run([sys.executable, "-m", "cup2d_tpu_torch.analysis"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
