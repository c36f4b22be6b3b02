"""PyTorch/CUDA port of ``cup2d_tpu``: the uniform-grid projection step
(``UniformGrid``, ``UniformSim``) in the free-slip box or walled by a
boundary table (``bc.py``; the case catalog ``cases.py``), the shaped
uniform step with fish and disks, collisions and surface forces
(``sim.Simulation``, the two-fish flagship step; the catalog's channel and
towed cylinder), the adaptive forest step with or without shapes
(``amr.AMRSim``; with them the canonical two-fish run) and the x-split
sharded uniform step
(``parallel.mesh.ShardedUniformSim``), with hand-written Hopper kernels
for the Heun substage, the projection correction, the Jacobi smoother
chains (the three with boundary-table forms), the forest lab RHS, the
forest block-Jacobi update, the halo-mode substage and Jacobi sweep of
the split step, and the single-op advection RHS
(``ops/hopper_kernels.py``).

The port imports torch and numpy only, never jax and nothing of
``cup2d_tpu``. Entry points run on ``cuda`` unless given
``device="cpu"``.
"""

from .amr import AMRSim
from .config import SimConfig
from .sim import Simulation
from .uniform import FlowState, UniformGrid, UniformSim

__all__ = ["AMRSim", "FlowState", "SimConfig", "Simulation", "UniformGrid",
           "UniformSim"]
