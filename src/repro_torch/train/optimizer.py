"""AdamW with f32 moments over (possibly bf16) parameters, a cosine LR
schedule and global-norm clipping (counterpart of
``repro/train/optimizer.py``, which it follows step for step).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``).  ``apply`` updates the
parameters and moments in place, as the JAX loop donates its buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import jax_path

Tree = Dict[str, torch.Tensor]
_SLICE = 1 << 26   # elements per slice of a parameter in ``apply``


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """Linear warm-up to ``learning_rate``, then cosine decay to
    ``min_lr_ratio`` of it at ``decay_steps`` (optimizer.py:36)."""
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def init(params: Tree) -> OptState:
    """Zero moments in f32, one per parameter, on its device."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return OptState(step=0, mu=zeros(), nu=zeros())


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for g in tree.values():
        s = g.float().square().sum()
        total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: OptimizerConfig, params: Tree, grads: Tree, state: OptState,
           *, gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[OptState, torch.Tensor, float]:
    """One AdamW step (optimizer.py:59): clip the gradients by their global
    norm, update the f32 moments, bias-correct them, and take a step with
    decoupled weight decay on JAX leaves of two or more dimensions only
    (a layer's vectors in a stack among them: ``jax_path``); each
    parameter keeps its dtype.  Returns (state, the global norm, the
    learning rate), the tensors updated in place, nothing read back from
    the device.  ``gnorm``: the global norm when ``grads`` hold only this
    rank's blocks (the mesh step computes it over the whole reduced
    gradients)."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for name, p in params.items():
        # JAX decays a leaf of two or more dims; one layer of a stack is a
        # slice of a leaf with the stack dim in front (``jax_path``)
        ndim = p.dim() + jax_path(name)[1]
        decay = cfg.weight_decay if ndim >= 2 else 0.0
        flat = [t.view(-1) for t in (p, state.mu[name], state.nu[name])]
        flat.insert(1, grads[name].reshape(-1))
        # in slices, so that the f32 temporaries of a large matrix (the
        # unembed) stay small
        for i in range(0, p.numel(), _SLICE):
            pp, g, m, v = (t[i:i + _SLICE] for t in flat)
            g = g.float() * scale.to(p.device)
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if decay:
                delta.add_(pp.float(), alpha=decay)
            pp.copy_((pp.float() - lr * delta).to(pp.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu), gnorm, lr


def apply(cfg: OptimizerConfig, params: Tree, grads: Tree, state: OptState,
          *, gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[Tree, OptState, Dict[str, float]]:
    """``update``, returning (params, state, {"grad_norm", "lr"})."""
    state, gnorm, lr = update(cfg, params, grads, state, gnorm=gnorm)
    return params, state, {"grad_norm": float(gnorm), "lr": lr}
