"""dis_tpu — a dense optical flow engine (DIS) in JAX.

A from-scratch JAX/XLA/Pallas implementation of Fast Optical Flow using
Dense Inverse Search (Kroeger et al., ECCV 2016), with the capabilities
of the reference C++ implementation at
``nejcgalof/Optical-Flow-using-Dense-Inverse-Search`` plus the paper's
variational refinement step (which the reference skips), batched
multi-pair data parallelism, spatial frame tiling with halo exchange,
and multi-host sequence sharding via ``jax.sharding``.
"""

from .config import (DISConfig, DIS_ULTRAFAST, DIS_FAST, DIS_MEDIUM,
                     DIS_FULL, DIS_COMPAT_DEFAULT, PRESETS)
from .models.dis import dis_flow, dis_flow_padded, dis_flow_stripe

__all__ = [
    "DISConfig", "DIS_ULTRAFAST", "DIS_FAST", "DIS_MEDIUM", "DIS_FULL",
    "DIS_COMPAT_DEFAULT", "PRESETS", "dis_flow", "dis_flow_padded",
    "dis_flow_stripe",
]

__version__ = "0.1.0"
