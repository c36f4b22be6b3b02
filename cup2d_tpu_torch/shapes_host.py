"""Host-side shape bookkeeping of the shaped drivers, the counterpart of
``cup2d_tpu.shapes_host``: the CoM/inertia sync after rasterization, the
deforming-body dt cap and the force-diagnostic log. Each device read is
one stacked copy to the host, and every read of a step, the solvers'
flag reads included, goes through ``pull``."""

from __future__ import annotations

import numpy as np
import torch

from .ops.forces import FORCE_KEYS


# device-to-host reads made through ``pull`` since import: every read of
# a step goes through it (profiling.HostCounters reads the deltas)
pulls = 0


def pull(*tensors, keep_dtype: bool = False) -> list:
    """The tensors as float64 numpy arrays of their own shapes, read from
    the device in ONE copy (flattened into a single buffer first, cast to
    float64 on the device only where their dtypes differ) and counted in
    ``pulls``. ``keep_dtype``: arrays in the tensors' one common dtype
    instead (the checkpoint's fields)."""
    global pulls
    pulls += 1
    flat = [torch.as_tensor(t).reshape(-1) for t in tensors]
    dtypes = {t.dtype for t in flat}
    if keep_dtype and (len(dtypes) > 1 or torch.bfloat16 in dtypes):
        raise ValueError(f"pull(keep_dtype=True) of dtypes {dtypes}")
    if len(dtypes) > 1 or torch.bfloat16 in dtypes:
        flat = [t.to(torch.float64) for t in flat]
    buf = flat[0] if len(flat) == 1 else torch.cat(flat)
    flat = buf.cpu().numpy()
    flat = flat.copy() if keep_dtype else flat.astype(np.float64)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


def pull_diag(diag: dict, *extra) -> tuple[dict, list]:
    """The step diagnostics with every tensor value read to the host (bool
    tensors as bool, integer ones as int, the rest as float), and
    ``extra`` tensors as numpy arrays, in one ``pull``."""
    keys = [k for k, v in diag.items() if torch.is_tensor(v)]
    vals = pull(*(diag[k] for k in keys), *extra)
    out = dict(diag)
    for k, v in zip(keys, vals):
        dt = diag[k].dtype
        out[k] = (bool(v) if dt == torch.bool else float(v)
                  if dt.is_floating_point else int(v))
    return out, vals[len(keys):]


class ShapeHostMixin:
    """Requires: self.shapes, self.time, self.force_log."""

    def _sync_shape_scalars(self, obs):
        """CoM correction and M/J/d_gm bookkeeping (main.cpp:4480-4541),
        from one copy of (com, mass, inertia)."""
        self._sync_shape_scalars_np(*pull(obs.com, obs.mass, obs.inertia))

    def _sync_shape_scalars_np(self, com, mass, inertia):
        """Same, from host arrays."""
        com = np.asarray(com, dtype=np.float64)
        mass = np.asarray(mass, dtype=np.float64)
        inertia = np.asarray(inertia, dtype=np.float64)
        for k, s in enumerate(self.shapes):
            s.com[:] = com[k]
            s.M = float(mass[k])
            s.J = float(inertia[k])
            dc = s.center - s.com
            cth, sth = np.cos(s.orientation), np.sin(s.orientation)
            s.d_gm[0] = dc[0] * cth + dc[1] * sth
            s.d_gm[1] = -dc[0] * sth + dc[1] * cth

    def _kinematic_dt_cap(self) -> float:
        """Deforming bodies need dt well under their gait period: the grid
        umax CFL (main.cpp:6579-6595) cannot see the midline's coming
        motion while the flow is quiescent, and on coarse grids the
        diffusive limit 0.25 h^2/nu can exceed the period. 1/20th of the
        fastest period resolves the gait; obstacle-free and rigid-shape
        runs are uncapped, as in the reference."""
        periods = [float(s.current_period) for s in self.shapes
                   if getattr(s, "current_period", 0.0) > 0.0]
        return 0.05 * min(periods) if periods else float("inf")

    @staticmethod
    def force_log_header() -> str:
        return ",".join(["time", "shape"] + list(FORCE_KEYS))

    @staticmethod
    def stack_forces(results) -> torch.Tensor:
        """The per-shape force dicts as one [S, 19] tensor, ``FORCE_KEYS``
        order."""
        return torch.stack([torch.stack([r[key] for key in FORCE_KEYS])
                            for r in results])

    def _record_forces(self, results):
        """Store the 19 diagnostics on each shape and append the CSV rows;
        the S x 19 device scalars come over in one copy."""
        self._record_forces_np(pull(self.stack_forces(results))[0])

    def _record_forces_np(self, vals):
        """Same, from the [S, 19] host array."""
        for k, s in enumerate(self.shapes):
            s.forces = {key: float(vals[k, i])
                        for i, key in enumerate(FORCE_KEYS)}
            if self.force_log is not None:
                row = [f"{self.time:.8g}", str(k)] + [
                    f"{s.forces[key]:.8g}" for key in FORCE_KEYS]
                self.force_log.write(",".join(row) + "\n")
