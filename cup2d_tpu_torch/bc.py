"""Per-face boundary-condition tables: the counterpart of
``cup2d_tpu.bc``.

* ``FaceBC``: one face's treatment, ``free_slip`` | ``no_slip``
  (optionally a moving wall, ``u_wall``) | ``inflow`` (Dirichlet
  velocity, uniform or parabolic profile) | ``outflow`` (convective
  outflow) | ``periodic`` (paired wrap).
* ``BCTable``: the four faces ``(x_lo, x_hi, y_lo, y_hi)``; hashable and
  comparable, with the JAX package's tokens.

Discretization (zeroth-order ghosts: every ghost layer is one painted
line, as the free-slip mirror paint has it):

velocity ghosts (``pad_vector_bc``)
    free_slip   mirror: tangential copied, normal negated
    no_slip     2*u_wall - edge  (both components)
    inflow      2*u_in - edge    (u_in possibly a profile)
    outflow     edge + c*(edge - inner), c = clip(u_n*dt/h, 0, 1)
                (c = 0 without a dt)
    periodic    the opposite side's interior lines
    The y faces paint first over the interior columns, the x faces then
    over the y-completed columns, so corners compose y then x.
    ``pad_vector_bc_slab`` paints one x slab of a split field to the same
    values (its halo columns' y ghosts as their owner paints them).

pressure (``pressure_signs``): +1 homogeneous Neumann on prescribed
velocity faces, -1 homogeneous Dirichlet at the mid-face for outflow, 0
for periodic (the wrap shift supplies the neighbour).

divergence (``divergence_coeffs``): the free-slip (+1 lo, -1 hi) edge
pattern on the wall-normal component, flipped for outflow (ghost =
edge), 0 for periodic; a prescribed nonzero wall-normal velocity adds
the constant ``divergence_affine_bc``.

A table with an outflow face has a non-singular pressure operator, so the
projection keeps its mean (``BCTable.all_neumann`` gates the removal).
The default table ``FREE_SLIP`` routes every consumer through the
free-slip code unchanged: ``pad_vector_bc`` of it is ``pad_vector``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

_KINDS = ("free_slip", "no_slip", "inflow", "outflow", "periodic")
_FACES = ("x_lo", "x_hi", "y_lo", "y_hi")

__all__ = ["BCTable", "FREE_SLIP", "FaceBC", "convective_outflow",
           "dirichlet_inflow", "divergence_affine_bc", "divergence_coeffs",
           "free_slip", "no_slip", "pad_vector_bc", "pad_vector_bc_slab",
           "periodic", "periodic_axes", "pressure_signs"]


class FaceBC(NamedTuple):
    """One face's treatment. ``u_wall`` is the prescribed wall velocity
    (u, v): the moving lid (no_slip) or the inflow velocity (inflow);
    ignored by the other kinds. ``profile`` shapes an inflow along the
    face: ``uniform`` or ``parabolic`` (4 s (1 - s), s in [0, 1] along
    the face tangent)."""

    kind: str = "free_slip"
    u_wall: Tuple[float, float] = (0.0, 0.0)
    profile: str = "uniform"


def free_slip() -> FaceBC:
    return FaceBC("free_slip")


def no_slip(u: float = 0.0, v: float = 0.0) -> FaceBC:
    return FaceBC("no_slip", (float(u), float(v)))


def dirichlet_inflow(u: float, v: float = 0.0,
                     profile: str = "uniform") -> FaceBC:
    if profile not in ("uniform", "parabolic"):
        raise ValueError(
            f"inflow profile {profile!r}: expected uniform|parabolic")
    return FaceBC("inflow", (float(u), float(v)), profile)


def convective_outflow() -> FaceBC:
    return FaceBC("outflow")


def periodic() -> FaceBC:
    return FaceBC("periodic")


class BCTable(NamedTuple):
    """The four faces' treatments, order (x_lo, x_hi, y_lo, y_hi)."""

    x_lo: FaceBC = FaceBC()
    x_hi: FaceBC = FaceBC()
    y_lo: FaceBC = FaceBC()
    y_hi: FaceBC = FaceBC()

    @staticmethod
    def default() -> "BCTable":
        return FREE_SLIP

    def validate(self) -> "BCTable":
        """Raise on an unknown kind or an unpaired periodic face."""
        for name, f in zip(_FACES, self):
            if f.kind not in _KINDS:
                raise ValueError(
                    f"BCTable.{name}: unknown kind {f.kind!r} "
                    f"(expected one of {_KINDS})")
        for lo, hi in (("x_lo", "x_hi"), ("y_lo", "y_hi")):
            klo = getattr(self, lo).kind
            khi = getattr(self, hi).kind
            if (klo == "periodic") != (khi == "periodic"):
                raise ValueError(
                    f"BCTable: periodic faces must be paired — "
                    f"{lo} is {klo!r} but {hi} is {khi!r}")
        return self

    @property
    def is_free_slip(self) -> bool:
        """Every face plain free-slip: the consumers run the free-slip
        code unchanged."""
        return all(f.kind == "free_slip" for f in self)

    @property
    def all_neumann(self) -> bool:
        """No outflow face: the pressure operator keeps its constant
        nullspace and the projection removes the means."""
        return all(f.kind != "outflow" for f in self)

    @property
    def token(self) -> str:
        """Per-face token string x_lo,x_hi,y_lo,y_hi, e.g. ``fs,fs,fs,fs``
        for the free-slip box, ``ns,ns,ns,ns(1,0)`` for the cavity."""
        short = {"free_slip": "fs", "no_slip": "ns",
                 "inflow": "in", "outflow": "out", "periodic": "pd"}
        toks = []
        for f in self:
            t = short.get(f.kind, f.kind)
            if f.kind in ("no_slip", "inflow") and any(f.u_wall):
                u, v = f.u_wall
                t += f"({u:g},{v:g})"
            if f.kind == "inflow" and f.profile != "uniform":
                t += f"[{f.profile}]"
            toks.append(t)
        return ",".join(toks)


FREE_SLIP = BCTable()


# ---------------------------------------------------------------------------
# per-face coefficients of the operators (ops/stencil.*_bc)
# ---------------------------------------------------------------------------

def pressure_signs(bc: BCTable) -> Tuple[float, float, float, float]:
    """Per-face pressure-ghost sign (x_lo, x_hi, y_lo, y_hi): +1 Neumann,
    -1 Dirichlet (outflow), 0 periodic."""
    sign = {"outflow": -1.0, "periodic": 0.0}
    return tuple(sign.get(f.kind, 1.0) for f in bc)


def divergence_coeffs(bc: BCTable) -> Tuple[float, float, float, float]:
    """Per-face edge coefficient of the wall-normal velocity in the
    undivided central divergence (x_lo, x_hi, y_lo, y_hi)."""
    lo = {True: -1.0, False: 1.0}

    def c(face, flip):
        if face.kind == "periodic":
            return 0.0
        return flip * lo[face.kind == "outflow"]

    return (c(bc.x_lo, 1.0), c(bc.x_hi, -1.0),
            c(bc.y_lo, 1.0), c(bc.y_hi, -1.0))


def periodic_axes(bc: BCTable) -> Tuple[bool, bool]:
    """(px, py): whether x / y is periodic (validated tables pair the
    faces, so the lo face speaks for the axis)."""
    return (bc.x_lo.kind == "periodic", bc.y_lo.kind == "periodic")


def _profile_1d(face: FaceBC, n: int, dtype, device=None, start: int = 0,
                n_tot: Optional[int] = None):
    """Inflow profile along the face tangent: None (uniform) or
    4 s (1 - s) at cell centres, s = (i + 0.5)/n_tot over the ``n`` cells
    from global index ``start`` (a slab's part of a face of ``n_tot``
    cells; the whole face by default)."""
    if face.kind != "inflow" or face.profile == "uniform":
        return None
    n_tot = n if n_tot is None else n_tot
    s = (torch.arange(start, start + n, dtype=dtype, device=device)
         + 0.5) / n_tot
    return 4.0 * s * (1.0 - s)


def divergence_affine_bc(bc: BCTable, ny: int, nx: int, dtype,
                         device=None) -> Optional[torch.Tensor]:
    """The state-independent edge-line term of prescribed nonzero
    wall-normal velocities in the undivided divergence: -2 uw_n on a lo
    edge line, +2 uw_n on a hi one (no_slip and inflow faces). None when
    every term vanishes, as for the cavity, whose walls move only
    tangentially."""
    out = None
    specs = ((bc.x_lo, 0, False, "x"), (bc.x_hi, 0, True, "x"),
             (bc.y_lo, 1, False, "y"), (bc.y_hi, 1, True, "y"))
    for face, comp, is_hi, axis in specs:
        if face.kind not in ("no_slip", "inflow"):
            continue
        uw_n = face.u_wall[comp]
        if uw_n == 0.0:
            continue
        n_tan = ny if axis == "x" else nx
        prof = _profile_1d(face, n_tan, dtype, device)
        amp = (2.0 if is_hi else -2.0) * uw_n
        line = (torch.full((n_tan,), amp, dtype=dtype, device=device)
                if prof is None else amp * prof)
        field = torch.zeros((ny, nx), dtype=dtype, device=device)
        if axis == "x":
            field[:, nx - 1 if is_hi else 0] = line
        else:
            field[ny - 1 if is_hi else 0, :] = line
        out = field if out is None else out + field
    return out


# ---------------------------------------------------------------------------
# velocity ghost paint
# ---------------------------------------------------------------------------

def _face_wall(face: FaceBC, n_tan: int, dtype, device, along_rows: bool,
               start: int = 0, n_tot: Optional[int] = None):
    """Wall velocity (u, v) of a no_slip/inflow face over the face line
    (``n_tan`` cells from ``start`` of ``n_tot``, as ``_profile_1d``):
    numbers, or profiled lines broadcastable against it (``along_rows``:
    the tangent runs along rows, an x face)."""
    prof = _profile_1d(face, n_tan, dtype, device, start, n_tot)
    uw = []
    for comp in range(2):
        val = face.u_wall[comp]
        if prof is None or val == 0.0:
            uw.append(val)
        else:
            line = val * prof
            uw.append(line[:, None] if along_rows else line[None, :])
    return uw


def _x_face_wall_padded(face: FaceBC, ny: int, g: int, dtype, device):
    """x-face wall velocity over the padded rows (ny + 2g), the profile
    coordinate clamped to the face, so a parabolic inflow closes to 0 at
    the corners."""
    if face.kind not in ("no_slip", "inflow"):
        return (0.0, 0.0)
    if face.profile == "uniform" or face.kind == "no_slip":
        return face.u_wall
    s = (torch.arange(ny + 2 * g, dtype=dtype, device=device) - g + 0.5) / ny
    s = torch.clamp(s, 0.0, 1.0)
    prof = (4.0 * s * (1.0 - s))[:, None]
    return tuple(v * prof if v != 0.0 else 0.0 for v in face.u_wall)


def _ghost(face, edge_u, edge_v, inner_u, inner_v, normal_comp,
           outward_sign, uw, h, dt):
    """One face's ghost line (gu, gv) from its edge and inner lines (module
    docstring)."""
    if face.kind == "free_slip":
        return ((-edge_u, edge_v) if normal_comp == 0
                else (edge_u, -edge_v))
    if face.kind in ("no_slip", "inflow"):
        return (2.0 * uw[0] - edge_u, 2.0 * uw[1] - edge_v)
    edge_n = edge_u if normal_comp == 0 else edge_v
    if dt is None:
        c = 0.0
    else:
        c = torch.clamp(outward_sign * edge_n * dt / h, 0.0, 1.0)
    return (edge_u + c * (edge_u - inner_u),
            edge_v + c * (edge_v - inner_v))


def _paint(out, sl_u, sl_v, gu, gv):
    # clone: a ghost line may be a view of ``out`` itself
    out[sl_u] = gu.clone().expand_as(out[sl_u])
    out[sl_v] = gv.clone().expand_as(out[sl_v])


def _paint_y_faces(out, src, g: int, bc: BCTable, h, dt, cols: slice,
                   col0: int, nx_tot: int) -> None:
    """Paint the y faces of ``out`` [..., 2, Ny+2g, C] (the ghost rows) over
    its columns ``cols``, from ``src`` [..., 2, Ny, n] (those columns'
    interior), whose first column is global column ``col0`` of ``nx_tot``
    (the parabolic profile's coordinate)."""
    e = Ellipsis
    ny, n = src.shape[-2], src.shape[-1]
    for f, er, ir, rows, sign in ((bc.y_lo, 0, 1, slice(0, g), -1.0),
                                  (bc.y_hi, ny - 1, ny - 2,
                                   slice(ny + g, ny + 2 * g), 1.0)):
        uw = (_face_wall(f, n, src.dtype, src.device, False, col0, nx_tot)
              if f.kind in ("no_slip", "inflow") else (0.0, 0.0))
        gu, gv = _ghost(f, src[e, 0:1, er:er + 1, :], src[e, 1:2, er:er + 1, :],
                        src[e, 0:1, ir:ir + 1, :], src[e, 1:2, ir:ir + 1, :],
                        1, sign, uw, h, dt)
        _paint(out, (e, slice(0, 1), rows, cols),
               (e, slice(1, 2), rows, cols), gu, gv)


def _paint_x_faces(out, g: int, bc: BCTable, h, dt, paint_lo: bool,
                   paint_hi: bool) -> None:
    """Paint the x faces of ``out`` [..., 2, Ny+2g, n+2g] over full rows
    (the y faces painted first), reading the y-completed edge columns; a
    side only where ``paint_lo`` / ``paint_hi``."""
    e = Ellipsis
    ny, nx = out.shape[-2] - 2 * g, out.shape[-1] - 2 * g
    for f, ec, ic, cols, sign, on in (
            (bc.x_lo, g, g + 1, slice(0, g), -1.0, paint_lo),
            (bc.x_hi, nx + g - 1, nx + g - 2, slice(nx + g, nx + 2 * g), 1.0,
             paint_hi)):
        if not on:
            continue
        uw = _x_face_wall_padded(f, ny, g, out.dtype, out.device)
        gu, gv = _ghost(f, out[e, 0:1, :, ec:ec + 1], out[e, 1:2, :, ec:ec + 1],
                        out[e, 0:1, :, ic:ic + 1], out[e, 1:2, :, ic:ic + 1],
                        0, sign, uw, h, dt)
        _paint(out, (e, slice(0, 1), slice(None), cols),
               (e, slice(1, 2), slice(None), cols), gu, gv)


def pad_vector_bc(v: torch.Tensor, g: int, bc: BCTable, h: float,
                  dt=None) -> torch.Tensor:
    """[..., 2, Ny, Nx] -> [..., 2, Ny+2g, Nx+2g]: zero pad, then paint
    each face per the table (module docstring). ``dt`` (a number or a
    tensor that broadcasts against [..., 1, 1, 1]) feeds the outflow
    speed; None gives c = 0. A free-slip table is ``pad_vector``."""
    if bc.is_free_slip:
        from .ops.stencil import pad_vector
        return pad_vector(v, g)
    ny, nx = v.shape[-2], v.shape[-1]
    out = F.pad(v, (g, g, g, g))

    # y faces, interior columns (normal component v)
    if bc.y_lo.kind == "periodic":
        out[..., :g, g:-g] = v[..., ny - g:, :]
        out[..., -g:, g:-g] = v[..., :g, :]
    else:
        _paint_y_faces(out, v, g, bc, h, dt, slice(g, g + nx), 0, nx)

    # x faces over full rows, reading the y-painted columns
    if bc.x_lo.kind == "periodic":
        out[..., :, :g] = out[..., :, nx:nx + g].clone()
        out[..., :, -g:] = out[..., :, g:2 * g].clone()
        return out
    _paint_x_faces(out, g, bc, h, dt, True, True)
    return out


def pad_vector_bc_slab(v: torch.Tensor, aux: torch.Tensor, g: int,
                       bc: BCTable, h: float, dt, col0: int, nx_tot: int,
                       is_lo: bool, is_hi: bool) -> torch.Tensor:
    """``pad_vector_bc`` on one x slab [..., 2, Ny, w] of a split field
    whose first column is global column ``col0`` of ``nx_tot``: aux
    [..., 2, Ny, 2g] holds the g columns left of the slab ([..., :g]) and
    the g right of it ([..., g:]), ignored on a side whose wall the slab
    owns (``is_lo`` / ``is_hi``). The y faces are painted first over the
    extended width (halo + slab + halo), the parabolic profile at global
    columns ``col0 - g`` on, so a halo column gets the paint its owner
    gives it; then the x faces over the y-completed columns, only on the
    sides the slab owns. Every value is the one ``pad_vector_bc`` of the
    whole field puts at the same global place. A free-slip table is
    ``ops.stencil.pad_vector_slab``. A periodic y wraps the rows of the
    extended width inside the slab; along a periodic x aux holds the
    ring's columns (the slab owns no wall) and the y faces paint each
    halo column at its source column's profile (global columns mod
    ``nx_tot``), as ``pad_vector_bc`` copies its painted columns across
    the wrap."""
    if bc.is_free_slip:
        from .ops.stencil import pad_vector_slab
        return pad_vector_slab(v, aux, g, is_lo, is_hi)
    px, py = periodic_axes(bc)
    ext = torch.cat([aux[..., :g], v, aux[..., g:]], dim=-1)
    out = F.pad(ext, (0, 0, g, g))
    ny, w = v.shape[-2], v.shape[-1]
    if py:
        out[..., :g, :] = ext[..., ny - g:, :]
        out[..., -g:, :] = ext[..., :g, :]
    elif px:
        # three runs of consecutive global columns: the left halo, the
        # slab, the right halo
        for cols, start in ((slice(0, g), (col0 - g) % nx_tot),
                            (slice(g, g + w), col0),
                            (slice(g + w, None), (col0 + w) % nx_tot)):
            _paint_y_faces(out, ext[..., cols], g, bc, h, dt, cols, start,
                           nx_tot)
    else:
        _paint_y_faces(out, ext, g, bc, h, dt, slice(None), col0 - g,
                       nx_tot)
    if not px:
        _paint_x_faces(out, g, bc, h, dt, bool(is_lo), bool(is_hi))
    return out
