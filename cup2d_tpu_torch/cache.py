"""Where the kernel libraries are built and loaded: the counterpart of
``cup2d_tpu.cache`` (which points XLA's persistent compilation cache at
``CUP2D_CACHE``).

The port compiles no executables at run time; what it builds is one
shared library per kernel source (``ops.hopper_kernels.build``, ``nvcc``)
and the regrid's C helper (``native``), each under a name that hashes its
source and flags, so a library built once is loaded again by any later
process of the same sources. ``CUP2D_CACHE``, when set, is the directory
they build into and load from; unset, each module's own default
(``build/torch_ext/`` at the repository root, listed in ``.gitignore``).
The variable is read once, when the first build starts, and the answer
kept for the process. A checkout unpacked elsewhere (a ``git archive``
copy) then reuses the libraries an earlier run of the same sources built
when both name the same ``CUP2D_CACHE``.
"""

from __future__ import annotations

import os
from pathlib import Path

_LATCHED: list = []        # [] until the first call, then [Path or None]


def build_dir(default) -> Path:
    """The build directory: ``CUP2D_CACHE`` (latched at the first call)
    where set, else ``default``."""
    if not _LATCHED:
        raw = os.environ.get("CUP2D_CACHE", "").strip()
        _LATCHED.append(Path(raw).expanduser().resolve() if raw else None)
    return _LATCHED[0] if _LATCHED[0] is not None else Path(default)
