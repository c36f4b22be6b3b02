"""graftlint for the port (cup2d_tpu_torch.analysis) — framework, rules,
policy tables, CLI.

Every rule is demonstrated LIVE on a seeded-violation snippet compiled
from strings (never from repo files, so the fixtures cannot rot with the
tree) next to a clean twin that must pass; host-sync has a fixture for
each torch form it flags, and the numpy ``.tolist()`` of
``ops/collision.py`` stays quiet. Each table's stale-row check fires on a
fixture whose scope is gone; the suppression syntax is pinned including
its failure modes (rc 2); the package lints clean with every ``.py``
scanned; the lint runs in a pristine interpreter without torch, jax or
the JAX package; and the CLI is pinned as a subprocess. No jax here: the
parity with the JAX package's lint is tests/test_torch_analysis_parity.py.
"""

import ast
import io
import json
import os
import subprocess
import sys
import tokenize

import pytest

from cup2d_tpu_torch.analysis import (RULE_NAMES, LintConfigError,
                                      lint_package, lint_sources, policy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cup2d_tpu_torch")
RULES = {"env-latch", "host-sync", "alias-safety", "cache-key",
         "leading-dim"}


def _findings(sources, only=None):
    return lint_sources(sources, only=only).findings


def _live(sources, only=None):
    """Findings other than stale policy rows (a one-scope fixture of a
    policy file leaves that file's other rows unmatched)."""
    return [f for f in _findings(sources, only=only)
            if "stale policy row" not in f.message]


def _stale(sources, only=None):
    return [f for f in _findings(sources, only=only)
            if "stale policy row" in f.message]


def _py_count(root):
    n = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        n += sum(fn.endswith(".py") for fn in filenames)
    return n


@pytest.fixture(scope="module")
def package_report():
    return lint_package()


# ---------------------------------------------------------------------------
# env-latch
# ---------------------------------------------------------------------------

ENV_BAD = """\
import os

def refresh(self):
    mode = os.environ.get("CUP2D_POIS", "structured")
    return mode
"""

ENV_CLEAN = """\
import os

def refresh(self):
    return self._pois_mode       # reads the latched value, not the env
"""

ENV_WRITES = """\
import os

def run(pois):
    os.environ["CUP2D_POIS"] = pois
    try:
        return build()
    finally:
        os.environ.pop("CUP2D_POIS", None)
"""


def test_env_latch_flags_unsanctioned_read():
    fs = _findings({"somefile.py": ENV_BAD}, only=["env-latch"])
    assert len(fs) == 1
    assert fs[0].rule == "env-latch" and fs[0].scope == "refresh"
    assert fs[0].line == 4 and "CUP2D_POIS" in fs[0].message


def test_env_latch_clean_twin_passes():
    assert not _findings({"somefile.py": ENV_CLEAN}, only=["env-latch"])


def test_env_latch_flags_writes_and_pops():
    fs = _findings({"driver.py": ENV_WRITES}, only=["env-latch"])
    assert [(f.line, f.scope) for f in fs] == [(4, "run"), (8, "run")]


def test_env_latch_sanctioned_sites_pass():
    src = ENV_BAD.replace("def refresh(self):", "def build_dir(default):") \
        .replace("CUP2D_POIS", "CUP2D_CACHE")
    assert not _findings({"cache.py": src}, only=["env-latch"])
    # an entry point's write row: profile_step's solver profile
    src = ENV_WRITES.replace("def run(pois):", "def profile_solver(pois):")
    assert not _live({"profile_step.py": src}, only=["env-latch"])


def test_env_latch_stale_row_when_scope_is_gone():
    src = ENV_BAD.replace("def refresh(self):", "def other_dir(default):") \
        .replace("CUP2D_POIS", "CUP2D_CACHE")
    fs = _findings({"cache.py": src}, only=["env-latch"])
    stale = [f for f in fs if "stale policy row" in f.message]
    assert len(stale) == 1 and stale[0].scope == "build_dir"
    assert "CUP2D_CACHE" in stale[0].message
    # and the moved read itself is a finding
    assert [f.scope for f in fs if f not in stale] == ["other_dir"]


def test_env_latch_planted_row_is_stale(monkeypatch):
    bogus = dict(policy.ENV_LATCH_SITES)
    bogus[("cache.py", "build_dir")] = (
        bogus[("cache.py", "build_dir")] | {"CUP2D_NO_SUCH_GATE"})
    monkeypatch.setattr(policy, "ENV_LATCH_SITES", bogus)
    report = lint_package(only=["env-latch"])
    stale = [f for f in report.findings if "stale policy row" in f.message]
    assert stale and all("CUP2D_NO_SUCH_GATE" in f.message for f in stale)


def test_pois_latch_is_the_two_constructors_plus_entry_point_writes():
    # fftd and every other solver are VALUES of CUP2D_POIS: the library
    # reads it in the two constructors only; the measurement entry points
    # write it around a construction, each row named by its scope
    sites = sorted(site for site, vars_ in policy.ENV_LATCH_SITES.items()
                   if "CUP2D_POIS" in vars_)
    assert sites == [
        ("amr.py", "AMRSim.__init__"),
        ("dist_check.py", "_latched.__enter__"),
        ("dist_check.py", "_latched.__exit__"),
        ("profile_step.py", "profile_channel"),
        ("profile_step.py", "profile_forest"),
        ("profile_step.py", "profile_solver"),
        ("uniform.py", "UniformGrid.__init__")]
    assert not lint_package(only=["env-latch"]).findings
    # no tier latch in the port; the regrid helper's cache directory is
    # latched once, where the helper's path is built
    every = set().union(*policy.ENV_LATCH_SITES.values())
    assert "CUP2D_PALLAS" not in every
    assert [site for site, vars_ in policy.ENV_LATCH_SITES.items()
            if "CUP2D_NATIVE_CACHE" in vars_] == [
        ("native/__init__.py", "_lib_path")]


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

HS_HEAD = "import numpy as np\nimport torch\n\n"

# (form, body of `def step(self, vel, ev):`) — each must raise exactly one
# finding, on the body's marked line
SYNC_FORMS = {
    "item": "umax = vel.abs().max().item()  # <-",
    "tolist": "t = torch.amax(vel, dim=-1)\n    return t.tolist()  # <-",
    "cpu": "t = torch.abs(vel)\n    return t.cpu()  # <-",
    "numpy": "t = torch.abs(vel)\n    return t.numpy()  # <-",
    "int": "return int(torch.sum(vel))  # <-",
    "float": "t = torch.linalg.norm(vel)\n    return float(t * 2)  # <-",
    "bool": "ok = torch.isfinite(vel).all()\n    return bool(ok)  # <-",
    "np.asarray": "n = torch.linalg.norm(vel)\n"
                  "    return np.asarray(n)  # <-",
    "np.array": "return np.array(torch.max(vel))  # <-",
    "if": "done = torch.all(vel < 1)\n    if done:  # <-\n        return 1",
    "while": "r = torch.linalg.norm(vel)\n    while r > 1e-6:  # <-\n"
             "        r = r / 2",
    "synchronize": "torch.cuda.synchronize()  # <-",
    "event": "ev.synchronize()  # <-",
    "stream": "s = torch.cuda.Stream()\n    s.synchronize()  # <-",
    "detach": "return vel.detach().cpu()  # <-",
    "pull": "from .shapes_host import pull\n"
            "    return pull(torch.max(vel))[0]  # <-",
    "pull_diag": "from .shapes_host import pull_diag\n"
                 "    return pull_diag({'u': vel})  # <-",
}


def _sync_src(body):
    src = HS_HEAD + "def step(self, vel, ev):\n    " + body + "\n"
    line = next(i for i, ln in enumerate(src.splitlines(), 1)
                if ln.endswith("# <-"))
    return src.replace("  # <-", ""), line


@pytest.mark.parametrize("form", sorted(SYNC_FORMS))
def test_host_sync_flags_each_torch_form(form):
    src, line = _sync_src(SYNC_FORMS[form])
    fs = _findings({"driver.py": src}, only=["host-sync"])
    assert [(f.rule, f.line, f.scope) for f in fs] == [
        ("host-sync", line, "step")], [str(f) for f in fs]


SYNC_CLEAN = HS_HEAD + """\
def step(self, vel, dt):
    # stays on the card; the driver's ONE pull fetches it
    umax = torch.amax(torch.abs(vel))
    ny, nx = vel.shape[-2], int(vel.shape[-1])
    n = int(vel.numel())
    eps = float(torch.finfo(vel.dtype).eps)
    sms = int(torch.cuda.get_device_properties(0).multi_processor_count)
    if torch.is_tensor(dt) and vel.dtype == torch.float32:
        pass
    if not torch.is_tensor(dt):
        dt = torch.tensor(float(dt), device=vel.device)
    host = np.asarray([1.0, 2.0])
    return umax, ny, nx, n, eps, sms, float(host.sum()), dt


def pairs(n):
    # the numpy shape of ops/collision.py: a host index pair list
    ii, jj = np.triu_indices(n, 1)
    out = []
    for i, j in zip(ii.tolist(), jj.tolist()):
        out.append((int(i), int(j)))
    return out


def cold_restore(path, host_buf):
    return float(sum(host_buf))
"""


def test_host_sync_clean_twin_passes():
    assert not _findings({"driver.py": SYNC_CLEAN}, only=["host-sync"])


def test_host_sync_collision_pairs_stay_quiet():
    src = open(os.path.join(PKG, "ops", "collision.py")).read()
    assert ".tolist()" in src and "np.triu_indices" in src
    assert not _findings({"ops/collision.py": src}, only=["host-sync"])


def test_host_sync_sanctioned_scope_passes():
    src = HS_HEAD + """\
from .shapes_host import pull


def _handshake(device):
    me = torch.tensor([0], device=device)
    return [int(g.item()) for g in [me]]
"""
    assert not _findings({"parallel/launch.py": src}, only=["host-sync"])
    # the same body anywhere else is a finding
    assert _findings({"parallel/other.py": src}, only=["host-sync"])


def test_host_sync_sanctioned_measurement_file_passes():
    src, _ = _sync_src(SYNC_FORMS["synchronize"])
    assert not _findings({"ops/timing.py": src}, only=["host-sync"])


def test_host_sync_stale_rows():
    # the sanctioned scope is gone
    fs = _stale({"parallel/launch.py": "def other():\n    pass\n"},
                only=["host-sync"])
    assert [(f.scope, f.line) for f in fs] == [("_handshake", 1)]
    assert "no longer exists" in fs[0].message
    # the scope is there but reads nothing any more
    fs = _stale({"parallel/launch.py":
                 "def _handshake(device):\n    return device\n"},
                only=["host-sync"])
    assert [f.scope for f in fs] == ["_handshake"]
    assert "reads nothing" in fs[0].message
    # a sanctioned measurement file that reads nothing
    fs = _stale({"ops/timing.py": "X = 1\n"}, only=["host-sync"])
    assert [(f.file, f.scope) for f in fs] == [("ops/timing.py", "<module>")]


# ---------------------------------------------------------------------------
# alias-safety
# ---------------------------------------------------------------------------

AL_HEAD = "import numpy as np\nimport torch\n\n"

ALIAS_BAD = {
    "from_numpy into FlowState": """\
def load(path):
    npz = np.load(path)
    return FlowState(torch.from_numpy(npz["vel"]),
                     torch.from_numpy(npz["pres"]))
""",
    "as_tensor of numpy into .state": """\
def load(sim, path):
    data = np.load(path)
    vel = torch.as_tensor(data["vel"])
    sim.state = sim.state._replace(vel=vel)
""",
    "snapshot payload into .state": """\
def restore(sim, snap):
    sim.state = type(sim.state)(
        **{k: v for k, v in snap.payload.items()})
""",
    "numpy view into set_state": """\
def install(sim, arr):
    sim.set_state(torch.from_numpy(arr).reshape(1, *arr.shape))
""",
    "numpy views through a list": """\
def install(sim, arrays):
    parts = [torch.from_numpy(a).reshape(1, *a.shape) for a in arrays]
    st = sim.state._replace(vel=parts[0])
    sim.state = st
""",
    "from_numpy into forest fields": """\
def write(f, vals):
    f.fields["vel"] = torch.from_numpy(vals)
""",
}

ALIAS_CLEAN = AL_HEAD + """\
def load(path, device, dtype):
    npz = np.load(path)
    return FlowState(torch.tensor(npz["vel"], dtype=dtype, device=device),
                     torch.from_numpy(npz["pres"]).clone())


def restore(sim, snap):
    sim.state = type(sim.state)(
        **{k: v.clone() for k, v in snap.payload.items()})


def install(sim, arrays, device):
    sim.set_state(FlowState(*(torch.from_numpy(a).to(device)
                              for a in arrays)))


def write(f, vals, dtype):
    f.fields["vel"] = torch.as_tensor(vals) * 1.0
    f.fields["chi"] = torch.from_numpy(vals).to(dtype=dtype)


def wipe(sim):
    sim.state = type(sim.state)(
        **{k: v * 0 for k, v in sim.state._asdict().items()})
"""


@pytest.mark.parametrize("case", sorted(ALIAS_BAD))
def test_alias_safety_flags_shared_memory_installs(case):
    fs = _findings({"io2.py": AL_HEAD + ALIAS_BAD[case]},
                   only=["alias-safety"])
    assert len(fs) == 1 and fs[0].rule == "alias-safety", \
        [str(f) for f in fs]


def test_alias_safety_clean_twin_passes():
    assert not _findings({"io2.py": ALIAS_CLEAN}, only=["alias-safety"])


def test_alias_safety_stale_sink_rows():
    fs = _stale({"fleet.py": "class FleetSim:\n    pass\n"},
                only=["alias-safety"])
    assert [f.scope for f in fs] == ["FleetSim.set_state"]
    fs = _stale({"forest.py": "class Forest:\n    def grow(self):\n"
                 "        self.fields = {}\n"}, only=["alias-safety"])
    assert [f.scope for f in fs] == ["Forest.fields"]
    assert not _stale({"forest.py": "class Forest:\n    def grow(self):\n"
                       "        self.fields['v'] = 0\n"},
                      only=["alias-safety"])


# ---------------------------------------------------------------------------
# cache-key
# ---------------------------------------------------------------------------

CK_HEAD = """\
import functools
import time

import torch


@functools.lru_cache(maxsize=64)
def _rhs_facs(device, afac, dfac):
    return torch.tensor([afac, dfac], device=device)


@functools.cache
def _plan(L, ny, nx, mode):
    return (L, ny, nx, mode)

"""

CACHE_BAD = {
    "float of dt": "def rhs(v, dt, h, nu):\n"
                   "    return _rhs_facs(v.device, float(-dt * h), "
                   "float(nu * dt))\n",
    "f-string": "def go(v, i):\n    return _plan(1, 8, 8, f'm{i}')\n",
    "format": "def go(v, i):\n    return _plan(1, 8, 8, '{}'.format(i))\n",
    "percent": "def go(v, i):\n    return _plan(1, 8, 8, 'm%d' % i)\n",
    "formatted name": "def go(v, i):\n    m = f'm{i}'\n"
                      "    return _plan(1, 8, 8, mode=m)\n",
    "list": "def go(v):\n    return _plan(1, 8, 8, [v.shape[-1]])\n",
    "varying": "def go(v):\n    return _plan(1, 8, 8, time.time())\n",
}

CACHE_CLEAN = CK_HEAD + """\
def go(v, mode):
    L, ny, nx = v.shape[0], v.shape[-2], v.shape[-1]
    a = _plan(L, ny, nx, mode)
    b = _plan(1, 8, 8, (ny, nx))
    return a, b, _rhs_facs(v.device, float(1), -1.0)
"""


@pytest.mark.parametrize("case", sorted(CACHE_BAD))
def test_cache_key_flags_per_call_keys(case):
    fs = _findings({"k.py": CK_HEAD + CACHE_BAD[case]}, only=["cache-key"])
    assert fs and {f.rule for f in fs} == {"cache-key"}
    assert {f.line for f in fs} == {CK_HEAD.count("\n") + 1
                                    + CACHE_BAD[case].count("\n") - 1}


def test_cache_key_float_of_dt_flags_both_arguments():
    fs = _findings({"k.py": CK_HEAD + CACHE_BAD["float of dt"]},
                   only=["cache-key"])
    assert len(fs) == 2 and all("float()" in f.message for f in fs)


def test_cache_key_clean_twin_passes():
    assert not _findings({"k.py": CACHE_CLEAN}, only=["cache-key"])


def test_cache_key_needs_a_module_local_cache():
    # the same call against a cached function of ANOTHER module is out
    # of a per-module check's reach
    src = "from . import hk\n\ndef rhs(v, dt):\n" \
          "    return hk._rhs_facs(v.device, float(dt), 0.0)\n"
    assert not _findings({"k.py": src}, only=["cache-key"])


def test_cache_key_kernel1_hit_is_allowed_in_place():
    report = lint_package(only=["cache-key"])
    assert report.clean and report.suppressed == {"cache-key": 2}
    src = open(os.path.join(PKG, "ops", "hopper_kernels.py")).read()
    lines = src.splitlines()
    i = next(i for i, ln in enumerate(lines)
             if "_rhs_facs(vlab.device, float(-dt * h)" in ln)
    assert "lint: allow[cache-key] --" in lines[i - 1]


# ---------------------------------------------------------------------------
# leading-dim
# ---------------------------------------------------------------------------

LEAD_BAD = """\
import torch

def laplacian(u, h):
    ny = u.shape[0]                          # front-counted rank
    c = u[1, 2]                              # hard positional index
    return torch.sum(u, axis=0) / h          # positional axis
"""

LEAD_CLEAN = """\
import torch

def laplacian(u, h):
    ny = u.shape[-2]
    c = u[..., 1, 2]
    ex = u[:, None]                          # newaxis shaping is legal
    return torch.sum(u, axis=-2) / h
"""


def test_leading_dim_flags_front_indexing():
    fs = _findings({"ops/stencil.py": LEAD_BAD}, only=["leading-dim"])
    assert [f.line for f in fs] == [4, 5, 6]
    assert {f.rule for f in fs} == {"leading-dim"}


def test_leading_dim_clean_twin_passes():
    assert not _findings({"ops/stencil.py": LEAD_CLEAN},
                         only=["leading-dim"])


def test_leading_dim_flags_torch_dim_keyword():
    src = ("import torch\n\ndef grad(p, q):\n"
           "    a = torch.stack([p, q], dim=0)\n"
           "    return torch.cat([a, a], dim=-3).sum(dim=(-2, -1))\n")
    fs = _findings({"ops/stencil.py": src}, only=["leading-dim"])
    assert [(f.line, f.scope) for f in fs] == [(4, "grad")]
    assert "axis=0" in fs[0].message


def test_leading_dim_only_in_contract_scopes():
    assert not _findings({"somewhere_else.py": LEAD_BAD},
                         only=["leading-dim"])
    # in poisson.py only the listed scopes are checked
    src = LEAD_BAD.replace("def laplacian", "def mg_solve")
    assert len(_live({"poisson.py": src}, only=["leading-dim"])) == 3
    assert not _live({"poisson.py": LEAD_BAD}, only=["leading-dim"])


def test_leading_dim_stale_scope_rows():
    fs = _stale({"parallel/shard_halo.py": "def other():\n    pass\n"},
                only=["leading-dim"])
    assert sorted(f.scope for f in fs) == sorted(
        policy.LEADING_DIM_SCOPES["parallel/shard_halo.py"])


def test_leading_dim_fftd_plan_allows_are_reasoned():
    # the five host-numpy precompute rows of FFTDiagPlan, allowed in
    # place with their reasons (the JAX package carries the same)
    src = open(os.path.join(PKG, "poisson.py")).read()
    plan = [ln for ln in src.splitlines()
            if "lint: allow[leading-dim] -- host numpy precompute" in ln]
    assert len(plan) == 5
    fs = _findings({"poisson.py": src}, only=["leading-dim"])
    assert not fs


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

SUP_BAD = HS_HEAD + """\
def step_diag(self, vel):
    umax = vel.max().item()      # per-scalar read
    return umax
"""


def test_suppression_with_reason_silences_finding():
    src = SUP_BAD.replace(
        "    umax = vel.max().item()      # per-scalar read",
        "    # lint: allow[host-sync] -- cold path, once per restore\n"
        "    umax = vel.max().item()")
    rep = lint_sources({"driver.py": src}, only=["host-sync"])
    assert rep.clean and rep.suppressed == {"host-sync": 1}
    inline = SUP_BAD.replace(
        "# per-scalar read", "# lint: allow[host-sync] -- once per run")
    assert lint_sources({"driver.py": inline}, only=["host-sync"]).clean


def test_suppression_without_reason_is_config_error():
    src = SUP_BAD.replace("# per-scalar read", "# lint: allow[host-sync]")
    with pytest.raises(LintConfigError, match="without a reason"):
        lint_sources({"driver.py": src})


def test_suppression_unknown_rule_is_config_error():
    for name in ("no-such-rule", "donation-safety", "retrace-hazard"):
        src = SUP_BAD.replace("# per-scalar read",
                              f"# lint: allow[{name}] -- because")
        with pytest.raises(LintConfigError, match="unknown"):
            lint_sources({"driver.py": src})


def test_unknown_rule_selection_is_config_error():
    with pytest.raises(LintConfigError, match="unknown rule"):
        lint_sources({"x.py": "pass\n"}, only=["no-such-rule"])


# ---------------------------------------------------------------------------
# the package: clean, fully scanned, every row reasoned, torch-free
# ---------------------------------------------------------------------------

def test_package_lints_clean_in_process(package_report):
    assert package_report.clean, "\n".join(
        str(f) for f in package_report.findings)
    assert package_report.files_scanned == _py_count(PKG)
    assert set(package_report.rules_run) == RULES == set(RULE_NAMES)
    assert sum(package_report.suppressed.values()) >= 1


def _table_rows(tree, name):
    """(first line, last line) of every row of the table ``name``."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            v = node.value
            if isinstance(v, ast.Call):         # frozenset({...})
                v = v.args[0]
            if isinstance(v, ast.Dict):
                return [(k.lineno, val.end_lineno)
                        for k, val in zip(v.keys, v.values)]
            return [(e.lineno, e.end_lineno) for e in v.elts]
    raise AssertionError(f"no table {name}")


def test_every_policy_row_carries_a_reason():
    path = os.path.join(PKG, "analysis", "policy.py")
    src = open(path).read()
    comments = {tok.start[0] for tok in tokenize.generate_tokens(
        io.StringIO(src).readline) if tok.type == tokenize.COMMENT}
    tree = ast.parse(src)
    tables = ("ENV_LATCH_SITES", "HOST_SYNC_FILES", "HOST_SYNC_SITES",
              "ALIAS_SINKS", "LEADING_DIM_SCOPES")
    for name in tables:
        prev = None
        for first, last in _table_rows(tree, name):
            lo = first if prev is None else prev + 1
            if prev is None:
                lo = first - 1
                while lo - 1 in comments:
                    lo -= 1
            assert any(ln in comments for ln in range(lo, last + 1)), \
                f"{name} row at policy.py:{first} has no reason"
            prev = last


def test_every_allow_in_the_port_has_a_reason():
    # Module.parse raises on a reasonless allow; the package parses, so
    # count them and hold each to a written reason of some length
    n = 0
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py") or dirpath.endswith("analysis"):
                continue
            for ln in open(os.path.join(dirpath, fn)):
                if "lint: allow[" in ln:
                    n += 1
                    reason = ln.split("lint: allow[", 1)[1].split("--", 1)
                    assert len(reason) == 2 and len(reason[1].strip()) > 20
    assert n == 12


def test_lint_imports_neither_torch_nor_jax():
    code = ("import sys; import cup2d_tpu_torch.analysis as a; "
            "r = a.lint_package(); assert r.clean; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'cup2d_tpu')); "
            "print(bad); sys.exit(2 if bad else 0)")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lazy_package_keeps_its_names():
    import cup2d_tpu_torch
    for name in cup2d_tpu_torch.__all__:
        assert getattr(cup2d_tpu_torch, name).__name__ == name
    assert set(cup2d_tpu_torch.__all__) <= set(dir(cup2d_tpu_torch))
    with pytest.raises(AttributeError):
        cup2d_tpu_torch.NoSuchName


# ---------------------------------------------------------------------------
# CLI (subprocess)
# ---------------------------------------------------------------------------

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cup2d_tpu_torch.analysis", *args],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=120)


def test_cli_json_clean_on_head():
    proc = _run_cli("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, "ONE machine-readable JSON line"
    payload = json.loads(lines[0])
    assert payload["graftlint"] == 1
    assert payload["clean"] is True and payload["findings"] == []
    assert set(payload["counts"]) == RULES
    assert all(v == 0 for v in payload["counts"].values())
    assert payload["files_scanned"] == _py_count(PKG)


def test_cli_only_env_latch_agrees_in_process():
    proc = _run_cli("--json", "--only", "env-latch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout.strip())
    assert payload["rules"] == ["env-latch"]
    report = lint_package(only=["env-latch"])
    assert payload["clean"] == report.clean
    assert payload["counts"]["env-latch"] == len(report.findings)
    assert payload["files_scanned"] == report.files_scanned


def test_cli_rc1_on_findings(tmp_path):
    bad = tmp_path / "dirty.py"
    bad.write_text("import os\nV = os.environ['CUP2D_POIS']\n"
                   "import torch\nX = torch.zeros(1).item()\n")
    proc = _run_cli(str(bad))
    assert proc.returncode == 1
    assert "env-latch" in proc.stdout and "host-sync" in proc.stdout
    proc = _run_cli("--json", "--skip", "host-sync", str(bad))
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["counts"] == {
        "env-latch": 1, "alias-safety": 0, "cache-key": 0,
        "leading-dim": 0}


def test_cli_rc2_on_config_error(tmp_path):
    proc = _run_cli("--only", "no-such-rule")
    assert proc.returncode == 2
    bad = tmp_path / "noreason.py"
    bad.write_text("x = 1  # lint: allow[host-sync]\n")
    proc = _run_cli("--json", str(bad))
    assert proc.returncode == 2
    assert json.loads(proc.stdout)["graftlint"] == 1
    assert _run_cli(str(tmp_path / "missing.py")).returncode == 2


def test_cli_list_rules_names_the_reference_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rule, ref in (("env-latch", "env-latch"), ("host-sync", "host-sync"),
                      ("alias-safety", "donation-safety"),
                      ("cache-key", "retrace-hazard"),
                      ("leading-dim", "leading-dim")):
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith(rule + " "))
        assert ref in line
