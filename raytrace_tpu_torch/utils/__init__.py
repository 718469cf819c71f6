"""Host-side utilities (torch port): checkpoints, profiling, progress."""

from raytrace_tpu_torch.utils.checkpoint import load_rays, save_rays
from raytrace_tpu_torch.utils.profiling import profile_trace
from raytrace_tpu_torch.utils.progress import ProgressBar, app_phase

__all__ = ["ProgressBar", "app_phase", "load_rays", "profile_trace", "save_rays"]
