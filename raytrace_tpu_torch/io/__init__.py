"""Output writers."""

from raytrace_tpu_torch.io.text import TextOutput

__all__ = ["TextOutput"]
