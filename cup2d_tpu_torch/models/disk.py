"""Rigid disk obstacle: validation shape for the penalization machinery.

The port's own copy of ``cup2d_tpu.models.disk`` (numpy only). The
reference only ships the fish (its ``-shapes`` parser, main.cpp:6378-6446),
but its immersed-boundary method is shape-agnostic: the disk exercises
penalization, the momentum solve and the forces with an analytic geometry
(a fixed cylinder, a towed or a free disk). It goes through the fish's
device pipeline: a surface polygon for the SDF and a one-node midline
table for the (identically zero) deformation velocity.
"""

from __future__ import annotations

import numpy as np


class DiskShape:
    """Rigid disk; ``prescribed=(u, v)`` pins its motion (towed / fixed
    cylinder — the Galilean twin of an inflow past a fixed body, which the
    reference's closed free-slip box cannot express), otherwise it moves
    freely under the penalization momentum solve like any shape."""

    def __init__(self, radius, xpos, ypos, n_surface=256, prescribed=None):
        self.radius = float(radius)
        self.length = 2.0 * self.radius   # window sizing
        self.center = np.array([xpos, ypos], dtype=np.float64)
        self.com = np.array([xpos, ypos], dtype=np.float64)
        self.orientation = 0.0
        self.u, self.v, self.omega = 0.0, 0.0, 0.0
        self.d_gm = np.zeros(2)
        self.prescribed = prescribed
        if prescribed is not None:
            self.u, self.v = float(prescribed[0]), float(prescribed[1])
        self.M = 0.0
        self.J = 0.0
        self.n_surface = int(n_surface)
        self.nm = 1

    @property
    def free(self) -> bool:
        return self.prescribed is None

    def advect(self, dt, extents):
        self.com[0] += dt * self.u
        self.com[1] += dt * self.v
        self.orientation += dt * self.omega
        self.center[:] = self.com
        if not (0 < self.center[0] < extents[0]
                and 0 < self.center[1] < extents[1]):
            raise RuntimeError("a body out of the domain")

    def midline(self, time):
        pass  # rigid: no deformation kinematics

    def surface_polygon(self):
        th = np.linspace(0.0, 2.0 * np.pi, self.n_surface, endpoint=False)
        return np.stack([
            self.center[0] + self.radius * np.cos(th),
            self.center[1] + self.radius * np.sin(th),
        ], axis=1)

    def midline_comp_frame(self):
        """One node at the center with zero deformation velocity: the
        udef gather returns exactly 0 everywhere."""
        r = self.com[None, :].copy()
        z = np.zeros((1, 2))
        nor = np.array([[1.0, 0.0]])
        return r, z, nor, z

    @property
    def width(self):
        return np.array([self.radius])
