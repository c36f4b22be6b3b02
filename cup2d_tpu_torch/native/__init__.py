"""Native (C) host helpers of the regrid, bound with ctypes: the port's
copy of ``cup2d_tpu.native``.

``amr_host.c`` holds ``fix_states``, the 2:1-balance sweeps of
``AMRSim.adapt`` (the reference's C++ bookkeeping, main.cpp:4717-4861).
It is compiled at first use with the system C compiler (``$CC``, default
``cc -O2 -shared -fPIC``) into ``build/torch_ext/`` at the repository
root, under a name that hashes the source, and loaded with ctypes. The
same path serves the CPU and the card's host. A failed build raises with
the compiler's output: nothing falls back to the Python sweep
(``AMRSim._fix_states_py``), which stays as the helper's twin in the
tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "amr_host.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
CFLAGS = ("-O2", "-shared", "-fPIC")

_lib = None


def _lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(CFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libamr_host-{tag[:16]}.so"


def load():
    """The helper library, built on first use. Raises RuntimeError with
    the compiler's output when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = _lib_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cc = os.environ.get("CC", "cc")
        try:
            proc = subprocess.run([cc, *CFLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"native regrid helper: C compiler {cc!r} not found") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native regrid helper: {cc} failed (rc {proc.returncode}) "
                f"on {_SRC.name}:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, so)   # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(so))
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.fix_states.restype = ctypes.c_int
    lib.fix_states.argtypes = [
        ctypes.c_int64, i32, i32, i32,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    _lib = lib
    return lib


def fix_states(lvl, bi, bj, state: np.ndarray, level_max: int, bpdx: int,
               bpdy: int) -> None:
    """In-place 2:1-balance state fixing of ``state`` (contiguous int8,
    1 refine / 0 leave / -1 compress) for the blocks (lvl, bi, bj)."""
    # the C map packs 29 bits per coordinate
    if level_max >= 29 or (max(bpdx, bpdy) << level_max) >= (1 << 29):
        raise ValueError(
            f"fix_states: levelMax {level_max} with {bpdx}x{bpdy} blocks "
            "exceeds the helper's 29-bit block coordinates")
    if state.dtype != np.int8 or not state.flags.c_contiguous:
        raise ValueError("fix_states: state must be a contiguous int8 "
                         "array (it is updated in place)")
    n = len(state)
    arrs = [np.ascontiguousarray(a, np.int32) for a in (lvl, bi, bj)]
    if any(len(a) != n for a in arrs):
        raise ValueError("fix_states: lvl, bi, bj and state differ in "
                         "length")
    rc = load().fix_states(n, *arrs, state, level_max, bpdx, bpdy)
    if rc != 0:
        raise MemoryError("fix_states: the helper's block map could not "
                          "be allocated")
