"""Obstacle models, the port's own copies of ``cup2d_tpu.models``:
the self-propelled fish and the rigid disk (numpy host state)."""

from .disk import DiskShape  # noqa: F401
from .fish import FishShape  # noqa: F401
