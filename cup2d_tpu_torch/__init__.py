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
(``ops/hopper_kernels.py``); and the run driver, ``python -m
cup2d_tpu_torch <reference flags>`` (``__main__.py``), with its
reference-format dumps and checkpoints (``io.py``, with the device
snapshot ring), metrics stream (``profiling.py``), supervised stepping
(``resilience.py``: the recovery ladder and the lagged verdict; fault
injection in ``faults.py``) and ``post.py``; and fleets and the serving
pool (``fleet.py``: ``FleetSim``, ``FleetServer``; per-member supervision
in ``resilience.FleetStepGuard``; ``-fleet B [-serve N]``).

The port imports torch and numpy only, never jax and nothing of
``cup2d_tpu``. Entry points run on ``cuda`` unless given
``device="cpu"``.
"""

# the entry points load torch, so they are exposed lazily: the lint
# (``cup2d_tpu_torch.analysis``) imports this package and must run where
# torch is not installed
_LAZY = {
    "AMRSim": ("cup2d_tpu_torch.amr", "AMRSim"),
    "FlowState": ("cup2d_tpu_torch.uniform", "FlowState"),
    "SimConfig": ("cup2d_tpu_torch.config", "SimConfig"),
    "Simulation": ("cup2d_tpu_torch.sim", "Simulation"),
    "UniformGrid": ("cup2d_tpu_torch.uniform", "UniformGrid"),
    "UniformSim": ("cup2d_tpu_torch.uniform", "UniformSim"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'cup2d_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
