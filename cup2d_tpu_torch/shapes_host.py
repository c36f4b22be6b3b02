"""Host-side shape bookkeeping of the shaped drivers, the counterpart of
``cup2d_tpu.shapes_host``: the CoM/inertia sync after rasterization, the
deforming-body dt cap and the force-diagnostic log. Each device read is
one stacked copy to the host."""

from __future__ import annotations

import numpy as np
import torch

from .ops.forces import FORCE_KEYS


def pull(*tensors) -> list:
    """The tensors as float64 numpy arrays of their own shapes, read from
    the device in ONE copy (each is cast to float64 and flattened into a
    single buffer first)."""
    flat = torch.cat([torch.as_tensor(t).reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out


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
