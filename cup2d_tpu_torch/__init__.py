"""PyTorch/CUDA port of ``cup2d_tpu``: the obstacle-free uniform-grid
projection step (``UniformGrid``, ``UniformSim``) with hand-written Hopper
kernels for the Heun substage, the projection correction and the Jacobi
smoother chains (``ops/hopper_kernels.py``).

The port imports torch and numpy only, never jax and nothing of
``cup2d_tpu``. Entry points run on ``cuda`` unless given
``device="cpu"``.
"""

from .config import SimConfig
from .uniform import FlowState, UniformGrid, UniformSim

__all__ = ["FlowState", "SimConfig", "UniformGrid", "UniformSim"]
