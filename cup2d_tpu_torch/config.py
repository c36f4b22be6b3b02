"""Configuration and CLI parsing: the port's own copy of
``cup2d_tpu.config`` (the port imports nothing of the JAX package).

``CommandlineParser`` follows the reference's argv semantics
(main.cpp:459-501): ``-key value...`` pairs (multi-token values joined
by spaces), bare ``-flag`` -> "true", ``+key`` force-override, and abort
on a missing key; ``LineParser`` (main.cpp:6288-6305) reads the
``key=value`` obstacle descriptor lines of ``-shapes``. ``SimConfig`` is
the typed config object (the reference's ``sim`` fields,
main.cpp:309-341).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class MissingKeyError(KeyError):
    pass


def _strtod_prefix(tok: str) -> Optional[float]:
    """Longest-numeric-prefix parse, like C strtod ("5x" -> 5.0)."""
    for n in range(len(tok), 0, -1):
        try:
            return float(tok[:n])
        except ValueError:
            continue
    return None


def _is_numeric(tok: str) -> bool:
    return _strtod_prefix(tok) is not None


class Value:
    """String-backed value with asDouble/asInt/asString accessors
    (reference `Value`, main.cpp:451-458)."""

    def __init__(self, content: str = ""):
        self.content = content

    def asDouble(self) -> float:
        # C atof semantics: longest numeric prefix, 0.0 if none.
        toks = self.content.split()
        if not toks:
            return 0.0
        v = _strtod_prefix(toks[0])
        return 0.0 if v is None else v

    def asInt(self) -> int:
        return int(self.asDouble())

    def asString(self) -> str:
        return self.content

    def __repr__(self):
        return f"Value({self.content!r})"


class CommandlineParser:
    """Reference-compatible ``-key value`` argv parser (main.cpp:459-501)."""

    def __init__(self, argv: list[str]):
        self.args: dict[str, Value] = {}
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("-") and not _is_numeric(tok):
                values = []
                j = i + 1
                while j < len(argv):
                    nxt = argv[j]
                    if nxt.startswith("-") and not _is_numeric(nxt):
                        break
                    values.append(nxt)
                    j += 1
                content = " ".join(values) if values else "true"
                key = tok[1:]
                if key.startswith("+"):
                    self.args[key[1:]] = Value(content)
                else:
                    self.args.setdefault(key, Value(content))
                i = j
            else:
                i += 1

    def __call__(self, key: str) -> Value:
        if key not in self.args:
            raise MissingKeyError(f"runtime {key} is not set")
        return self.args[key]

    def has(self, key: str) -> bool:
        return key in self.args


class LineParser:
    """``key=value`` descriptor parser for shape lines (main.cpp:6288-6305)."""

    def __init__(self, line: str):
        self.args: dict[str, Value] = {}
        for tok in line.split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                self.args[k.strip()] = Value(v.strip())

    def __call__(self, key: str) -> Value:
        if key not in self.args:
            raise MissingKeyError(f"shape descriptor {key} is not set")
        return self.args[key]

    def has(self, key: str) -> bool:
        return key in self.args


@dataclasses.dataclass
class SimConfig:
    """Typed simulation configuration (reference `sim` fields,
    main.cpp:309-341, populated at main.cpp:6321-6341)."""

    bpdx: int = 2
    bpdy: int = 1
    level_max: int = 1
    level_start: int = 0
    adapt_steps: int = 20
    rtol: float = 2.0
    ctol: float = 1.0
    extent: float = 4.0
    cfl: float = 0.5
    end_time: float = 10.0
    lam: float = 1e7
    nu: float = 4e-5
    poisson_tol: float = 1e-3
    poisson_tol_rel: float = 1e-2
    max_poisson_restarts: int = 0
    max_poisson_iterations: int = 1000
    dump_time: float = 0.0
    shapes: str = ""
    bs: int = 8               # block size (reference _BS_=8, Makefile:12)
    dtype: str = "float32"    # TPU-first default; float64 for CPU validation
    precond: bool = True
    # --- derived (computed in __post_init__) ---
    h0: float = dataclasses.field(init=False, default=0.0)
    extents: tuple = dataclasses.field(init=False, default=(0.0, 0.0))
    min_h: float = dataclasses.field(init=False, default=0.0)

    def __post_init__(self):
        # reference main.cpp:6338-6341
        self.h0 = self.extent / max(self.bpdx, self.bpdy) / self.bs
        self.extents = (self.bpdx * self.h0 * self.bs, self.bpdy * self.h0 * self.bs)
        self.min_h = self.h0 / (1 << max(self.level_max - 1, 0))

    def h_at(self, level: int) -> float:
        return self.h0 / (1 << level)

    @property
    def cells(self) -> tuple[int, int]:
        """Finest-level cell resolution cap."""
        s = 1 << max(self.level_max - 1, 0)
        return (self.bpdx * self.bs * s, self.bpdy * self.bs * s)

    @classmethod
    def from_argv(cls, argv: list[str]) -> "SimConfig":
        """Build from reference-style flags (same names as run.sh:1-22)."""
        p = CommandlineParser(argv)
        return cls(
            bpdx=p("bpdx").asInt(),
            bpdy=p("bpdy").asInt(),
            level_max=p("levelMax").asInt(),
            level_start=p("levelStart").asInt(),
            adapt_steps=p("AdaptSteps").asInt(),
            rtol=p("Rtol").asDouble(),
            ctol=p("Ctol").asDouble(),
            extent=p("extent").asDouble(),
            cfl=p("CFL").asDouble(),
            end_time=p("tend").asDouble(),
            lam=p("lambda").asDouble(),
            nu=p("nu").asDouble(),
            poisson_tol=p("poissonTol").asDouble(),
            poisson_tol_rel=p("poissonTolRel").asDouble(),
            max_poisson_restarts=p("maxPoissonRestarts").asInt(),
            max_poisson_iterations=p("maxPoissonIterations").asInt(),
            dump_time=p("tdump").asDouble(),
            shapes=p("shapes").asString() if p.has("shapes") else "",
            bs=p("bs").asInt() if p.has("bs") else 8,
            dtype=p("dtype").asString() if p.has("dtype") else "float32",
        )

    def parse_shapes(self) -> list[dict]:
        """Parse the -shapes multi-line descriptor string into dicts
        (reference main.cpp:6378-6446)."""
        out = []
        for raw_line in self.shapes.splitlines():
            for line in raw_line.split(","):
                line = line.strip()
                if not line:
                    continue
                p = LineParser(line)
                # angle/L/xpos/ypos are required, like the reference's aborting
                # accessor (main.cpp:6388-6390); the rest have defaults.
                out.append({
                    "angle": p("angle").asDouble(),
                    "length": p("L").asDouble(),
                    "xpos": p("xpos").asDouble(),
                    "ypos": p("ypos").asDouble(),
                    "T": p("T").asDouble() if p.has("T") else 1.0,
                    "kind": p("kind").asString() if p.has("kind") else "fish",
                    "radius": p("radius").asDouble() if p.has("radius") else 0.0,
                })
        return out
