"""The port's lint (cup2d_tpu_torch.analysis) held against the JAX
package's (cup2d_tpu.analysis) on the fixtures both can read: env-latch
reads and writes, leading-dim under ``ops/stencil.py`` (``"*"`` in both
tables), the ``.item()`` read, and the suppression syntax with its
config errors. The bar is equal ``(rule, line, scope)`` findings from
the in-process entries and the same CLI rc on the same files.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from cup2d_tpu.analysis import LintConfigError as RefConfigError  # noqa
from cup2d_tpu.analysis import lint_sources as ref_lint  # noqa: E402
from cup2d_tpu_torch.analysis import LintConfigError  # noqa: E402
from cup2d_tpu_torch.analysis import lint_sources as port_lint  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV_READS = """\
import os
from os import environ, getenv


def refresh(self):
    mode = os.environ.get("CUP2D_POIS", "structured")
    tier = environ["CUP2D_PREC"]
    return mode, tier, getenv("CUP2D_TRACE"), os.getenv("HOME")


class Grid:
    def rebuild(self):
        return os.environ.setdefault("CUP2D_TWOLEVEL", "mult")
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

LEAD = """\
import numpy as np


def laplacian(u, h):
    ny = u.shape[0]
    nx = u.shape[-1]
    c = u[1, 2]
    d = u[..., 1, 2]
    e = u[:, None]
    return np.sum(u, axis=0) / h + np.sum(u, axis=-2)


class Op:
    def apply(self, x):
        return x[0, :] + x.shape[1]
"""

ITEM = """\
def diag(self, vel, lo):
    umax = vel.max().item()
    return umax, lo.item(3)


class Sim:
    def step(self, st):
        return [g.item() for g in st]
"""

# (relpath, source, rule) the two lints must agree on
SHARED = [
    ("somefile.py", ENV_READS, "env-latch"),
    ("driver.py", ENV_WRITES, "env-latch"),
    ("ops/stencil.py", LEAD, "leading-dim"),
    ("driver.py", ITEM, "host-sync"),
]


def _key(report):
    return sorted((f.rule, f.line, f.scope) for f in report.findings)


@pytest.mark.parametrize("rel,src,rule", SHARED,
                         ids=[f"{r}:{p}" for p, _, r in SHARED])
def test_equal_findings_on_shared_fixtures(rel, src, rule):
    ref = ref_lint({rel: src}, only=[rule])
    port = port_lint({rel: src}, only=[rule])
    assert _key(ref) == _key(port)
    assert _key(port), "the fixture must raise findings"


def test_equal_findings_with_every_rule():
    # all rules over all four fixtures at once: the rules only one lint
    # has stay quiet on them
    for rel, src, _ in SHARED:
        assert _key(ref_lint({rel: src})) == _key(port_lint({rel: src}))


def test_equal_suppression():
    src = ITEM.replace(
        "    umax = vel.max().item()",
        "    # lint: allow[host-sync] -- cold path, once per restore\n"
        "    umax = vel.max().item()")
    ref, port = ref_lint({"d.py": src}), port_lint({"d.py": src})
    assert _key(ref) == _key(port)
    assert ref.suppressed == port.suppressed == {"host-sync": 1}


@pytest.mark.parametrize("comment", [
    "# lint: allow[host-sync]",             # no reason
    "# lint: allow[host-sync] --   ",       # an empty reason
    "# lint: allow[no-such-rule] -- why",   # unknown rule
    "# lint: allow[] -- why",               # no rule
    "# lint: nonsense",                     # malformed
])
def test_equal_config_errors(comment):
    src = ITEM.replace("return umax, lo.item(3)",
                       f"return umax, lo.item(3)  {comment}")
    with pytest.raises(RefConfigError):
        ref_lint({"d.py": src})
    with pytest.raises(LintConfigError):
        port_lint({"d.py": src})


def _rc(pkg, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.analysis", *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
        text=True, timeout=120).returncode


def test_equal_cli_rc(tmp_path):
    dirty = tmp_path / "dirty.py"
    dirty.write_text(ENV_WRITES)
    noreason = tmp_path / "noreason.py"
    noreason.write_text("x = 1  # lint: allow[host-sync]\n")
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    for path, rc in ((dirty, 1), (noreason, 2), (clean, 0)):
        assert _rc("cup2d_tpu", str(path)) == _rc(
            "cup2d_tpu_torch", str(path)) == rc, path.name
