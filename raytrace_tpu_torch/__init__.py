"""raytrace_tpu_torch — the PyTorch/CUDA port of raytrace_tpu.

Kerr null-geodesic ray tracing on tensors, with the geodesic march as a
hand-written CUDA kernel for Hopper (``ops/march_kernel.py``) beside its
plain PyTorch version (``ops/integrate.py``). The module layout mirrors
``raytrace_tpu``; this package imports torch and numpy only.
"""

from raytrace_tpu_torch.geometry import kerr
from raytrace_tpu_torch.rays import RayBatch

__version__ = "0.1.0"

__all__ = ["kerr", "RayBatch", "__version__"]
