"""Shared model primitives (counterpart of ``repro/models/layers.py``).

Parameters live in small ``nn.Module``s whose attribute names are the JAX
parameter tree's keys (``gamma``/``beta``, ``embedding``, ``w_up``/...), so
that ``convert.vilbert_from_jax`` maps one onto the other by name.  The
forward functions take the module and mirror the JAX functions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import ModelConfig, pad_to
from repro_torch.kernels import ops


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter of the inference-only port (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(shape: Sequence[int], dtype: torch.dtype, *,
               generator: torch.Generator, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, scale) with scale = fan_in^-0.5 by default (layers.py:31),
    drawn in f32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=generator.device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.gamma = param(torch.ones(dim, dtype=dtype, device=device))
        self.beta = param(torch.zeros(dim, dtype=dtype, device=device))


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p.gamma.to(x.dtype) + p.beta.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding (vocab padded to a multiple of 128, as layers.py:69)
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """The input embedding only: the crossmodal model never unembeds."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.embedding = param(dense_init((pad_to(vocab, 128), dim), dtype,
                                          generator=generator, scale=0.02))


def embed_lookup(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.embedding[tokens]


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU) through ops.projection
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, f: int,
                 generator: torch.Generator):
        super().__init__()
        dt = torch_dtype(cfg.param_dtype)
        if cfg.act == "silu":
            self.w_gate = param(dense_init((d, f), dt, generator=generator))
        self.w_up = param(dense_init((d, f), dt, generator=generator))
        self.w_down = param(dense_init((f, d), dt, generator=generator))


def mlp_forward(p: MLP, x: torch.Tensor) -> torch.Tensor:
    if hasattr(p, "w_gate"):
        g = ops.projection(x, p.w_gate)
        u = ops.projection(x, p.w_up)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(ops.projection(x, p.w_up), approximate="tanh")
    return ops.projection(h, p.w_down)
