"""Output writers and the input line-spectrum reader."""

from raytrace_tpu_torch.io.fits import FITSOutput, read_fits
from raytrace_tpu_torch.io.spectrum import read_spectrum
from raytrace_tpu_torch.io.text import TextOutput

__all__ = ["FITSOutput", "TextOutput", "read_fits", "read_spectrum"]
