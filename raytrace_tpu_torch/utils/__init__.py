"""Host-side utilities (torch port)."""

from raytrace_tpu_torch.utils.progress import ProgressBar

__all__ = ["ProgressBar"]
