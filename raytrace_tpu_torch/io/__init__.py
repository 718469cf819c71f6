"""Output writers."""

from raytrace_tpu_torch.io.fits import FITSOutput, read_fits
from raytrace_tpu_torch.io.text import TextOutput

__all__ = ["FITSOutput", "TextOutput", "read_fits"]
