"""The train step (counterpart of ``repro/train/steps.py``'s
``make_train_step``; the serving steps are ``Transformer.prefill`` and
``decode_step``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.train import optimizer as opt


def make_train_step(cfg: ModelConfig,
                    ocfg: Optional[opt.OptimizerConfig] = None, *,
                    mode: Optional[ExecutionMode] = None, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics): the loss and its gradients (``microbatches > 1`` accumulates
    them in f32 over equal slices of the batch's leading axis and averages),
    then one ``optimizer.apply``.  The model's parameters must require
    grad; they are updated in place."""
    ocfg = ocfg or opt.OptimizerConfig()
    mod = registry.model_module(cfg)

    def single_grads(model, params, batch) -> Tuple[torch.Tensor, list]:
        loss = mod.loss_fn(model, batch, mode=mode, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        # a parameter the loss never reads (deepseek-v3's mtp_proj, carried
        # unused as in JAX) gets the zero gradient jax.grad gives it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params.values(), grads)]

    def train_step(model, opt_state: opt.OptState,
                   batch: Dict[str, torch.Tensor]):
        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        if microbatches > 1:
            loss = 0.0
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params.values()]
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                mloss, grads = single_grads(model, params, mb)
                loss = loss + mloss
                for a, g in zip(acc, grads):
                    a += g
            loss = loss / microbatches
            grads = [a / microbatches for a in acc]
        else:
            loss, grads = single_grads(model, params, batch)
        _, opt_state, metrics = opt.apply(
            ocfg, params, dict(zip(params, grads)), opt_state)
        metrics["loss"] = float(loss)
        return model, opt_state, metrics

    return train_step
