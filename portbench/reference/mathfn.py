"""Elementwise square root, sine and cosine that round alike on every host.

The port's one route to ``sqrt``, ``sin`` and ``cos`` of a tensor; it has
no counterpart in ``raytrace_tpu``. On a CUDA tensor each function is
torch's own op: the same kernel, the same bits (CUDA's ``sqrt`` is
correctly rounded), so the march kernel and its plain version stay bitwise
alike. On a CPU tensor torch's results depend on the host's math library:
on an AVX-512 host with torch 2.13's CPU build, ``torch.sqrt`` (and
``torch.pow(x, 0.5)``) is off by one ulp on about 1.4% of float64 and 19%
of float32 inputs, where XLA's and numpy's square roots are correctly
rounded. An ulp in ``r = sqrt(D^2 + x^2 + y^2)`` then grows through the
``arccos`` of the image-plane seeding (``sources/imageplane.py``) to
4e-12 relative, and the float32 trig of the step adds the rest of the
march's drift from the JAX package. So on the CPU:

- ``sqrt`` of float64 and float32 is correctly rounded (IEEE 754): it is
  numpy's, which takes the processor's square-root instruction. For
  float32 this equals the float64 square root rounded once to float32,
  since 53 >= 2 * 24 + 2 makes that double rounding innocuous.
- ``sin`` and ``cos`` of float32 are taken in float64 and rounded to
  float32 once, so they no longer depend on torch's float32 vector code.
- ``sin`` and ``cos`` of float64, and every other dtype, are torch's.

Special values are torch's: ``sqrt(-0.) = -0.``, NaN below zero, inf at
inf. Derivatives are the ops' own (``1 / (2 sqrt(x))``, ``cos``, ``-sin``)
in reverse mode, forward mode (``torch.autograd.forward_ad``) and under
``torch.func``: a tensor that carries a derivative goes through a
``torch.autograd.Function`` with a ``jvp`` and a vmap rule, as
``ops/integrate.py::_Quotient`` does; any other takes the value alone.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd import forward_ad as _fwad

_is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
_FLOATS = (torch.float32, torch.float64)


def _sqrt_value(x):
    out = torch.empty_like(x)
    with np.errstate(invalid="ignore"):
        np.sqrt(x.detach().numpy(), out=out.numpy())
    return out


def _sin_value(x):
    return torch.sin(x.detach().double()).to(x.dtype)


def _cos_value(x):
    return torch.cos(x.detach().double()).to(x.dtype)


def _function(value, derivative):
    """A ``torch.autograd.Function`` of one tensor ``x``: its value is
    ``value(x)``, and its derivative applied to a cotangent or tangent
    ``t`` is ``derivative(t, x, y)``, ``y`` being the value."""

    class Elementwise(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return value(x)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[0], output)
            ctx.save_for_forward(inputs[0], output)

        @staticmethod
        def backward(ctx, grad):
            return derivative(grad, *ctx.saved_tensors)

        @staticmethod
        def jvp(ctx, x_t):
            return derivative(x_t, *ctx.saved_tensors)

        @staticmethod
        def vmap(info, in_dims, x):
            return value(x), in_dims[0]

    return Elementwise


# each op's derivative as torch's own derivatives.yaml takes it
_Sqrt = _function(_sqrt_value, lambda t, x, y: t / (2 * y))
_Sin = _function(_sin_value, lambda t, x, y: t * torch.cos(x))
_Cos = _function(_cos_value, lambda t, x, y: t * -torch.sin(x))


def _carries_derivative(x):
    return x.requires_grad or _fwad._current_level >= 0 or _is_wrapped(x)


def sqrt(x):
    """``torch.sqrt(x)``, correctly rounded on a float32 or float64 CPU tensor."""
    if x.device.type != "cpu" or x.dtype not in _FLOATS:
        return torch.sqrt(x)
    return _Sqrt.apply(x) if _carries_derivative(x) else _sqrt_value(x)


def sin(x):
    """``torch.sin(x)``; on a float32 CPU tensor, taken in float64 and rounded once."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.sin(x)
    return _Sin.apply(x) if _carries_derivative(x) else _sin_value(x)


def cos(x):
    """``torch.cos(x)``; on a float32 CPU tensor, taken in float64 and rounded once."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.cos(x)
    return _Cos.apply(x) if _carries_derivative(x) else _cos_value(x)
