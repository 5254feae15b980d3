"""Quantized projection path: the paper's precision knob (counterpart of
``repro/kernels/quant.py``).

StreamDCIM runs attention at INT16 on its CIM arrays (§III-A).  The JAX
package's analogue is int8 matmuls: weights quantized per output channel,
activations per row (dynamic), int32 accumulation, dequantized on the way
out.  ``runtime.flags(quantize_proj=True)`` routes ``ops.projection``
(every MLP product) here.  The functions compute exactly what the JAX
ones compute, bit for bit: the same scale formula, round half to even,
the same order of the dequantizing products.

The int8 product is ``torch._int_mm`` on CUDA tensors (the JAX package
computes it with ``lax.dot_general``, outside any Pallas kernel) and an
int32 ``matmul`` on CPU tensors.  ``torch._int_mm`` takes only more than
16 rows and K and N multiples of 8, so the operands are zero-padded to
that and the result sliced: zero rows and columns leave the int32 sums
exact.  The weights are quantized on every call, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # A 0-dim tensor on amax's device, not a Python scalar: CUDA divides by
    # a host scalar as a product with its reciprocal, one ulp off the true
    # quotient that the CPU and the JAX package compute.
    return amax / amax.new_tensor(127.0) + 1e-12


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x (..., K) -> (int8, scales (..., 1))."""
    scale = _scale(x.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8: w (K, N) -> (int8, scales (1, N))."""
    scale = _scale(w.abs().amax(dim=0, keepdim=True))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, summed exactly:
    ``torch._int_mm`` on CUDA tensors, an int32 matmul on CPU tensors."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    (M, K), N = a.shape, b.shape[1]
    Mp, Kp, Np = M if M > 16 else 32, _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    int8_mm.launches += 1
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


int8_mm.launches = 0


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) through int8 with int32 accumulation, output in
    x's dtype.  Under autograd the gradient flows through the scales only
    (the rounded values carry none), as ``jax.grad`` gives it."""
    lead = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]).float())
    wq, sw = quantize_cols(w.float())
    out = int8_mm(xq, wq).float() * sx * sw
    return out.reshape(*lead, w.shape[1]).to(x.dtype)
