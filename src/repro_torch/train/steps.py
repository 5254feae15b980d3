"""The train step (counterpart of ``repro/train/steps.py``'s
``make_train_step``; the serving steps are ``Transformer.prefill`` and
``decode_step``), on one device or on a ``DeviceMesh``.

On a mesh (``MeshTrainStep``) every parameter and both AdamW moments are
stored as DTensors placed by the rule table
(``distributed.sharding.param_shardings``): each rank holds its blocks
(ZeRO-3 over 'data' above the FSDP threshold, 'model' by the rules).  A
step gathers them into the model's parameters (``full_tensor``), runs the
single-device forward and backward on the rank's block of the batch
(``batch_shardings``: rows over (pod, data)), reduces each gradient over
(pod, data) straight to its parameter's placements (Partial -> Shard, a
reduce-scatter, where the parameter is sharded over a batch axis;
Partial -> Replicate, an all-reduce, where it is not), takes the mean
over the data-parallel ranks, the global norm from the blocks, and
updates the rank's blocks.  The compute runs on whole (gathered)
tensors, so the model's kernels launch as on one device, and on a
(1, 1) mesh every number is the single-device step's.  Not yet done:
gathering per layer and freeing after use (the gathered copy of the
parameters, and the backward's whole gradients, live for the step) and
tensor- or context-parallel compute over 'model' (ranks of one 'model'
row compute the same step).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.train import optimizer as opt


def split_microbatch(k: str, v: torch.Tensor, n: int, i: int
                     ) -> torch.Tensor:
    """Microbatch i of n of one batch leaf: equal slices of its batch axis,
    dim 1 of the VLM positions (3, B, S) and dim 0 of the rest (as
    steps.py:35-41 split them)."""
    if k == "positions":
        return v.reshape(3, n, v.shape[1] // n, *v.shape[2:])[:, i]
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def make_loss_and_grads(cfg: ModelConfig, *,
                        mode: Optional[ExecutionMode] = None,
                        remat: bool = True, microbatches: int = 1
                        ) -> Callable:
    """Returns f(model, params, batch) -> (loss, [gradient per params
    entry]): the loss and its gradients (``microbatches > 1`` accumulates
    them in f32 over equal slices of the batch and averages)."""
    mod = registry.model_module(cfg)

    def single_grads(model, params, batch) -> Tuple[torch.Tensor, list]:
        loss = mod.loss_fn(model, batch, mode=mode, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        # a parameter the loss never reads (deepseek-v3's mtp_proj, carried
        # unused as in JAX) gets the zero gradient jax.grad gives it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params.values(), grads)]

    def loss_and_grads(model, params, batch):
        if microbatches == 1:
            return single_grads(model, params, batch)
        loss = 0.0
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params.values()]
        for i in range(microbatches):
            mb = {k: split_microbatch(k, v, microbatches, i)
                  for k, v in batch.items()}
            mloss, grads = single_grads(model, params, mb)
            loss = loss + mloss
            for a, g in zip(acc, grads):
                a += g
        return loss / microbatches, [a / microbatches for a in acc]

    return loss_and_grads


def make_train_step(cfg: ModelConfig,
                    ocfg: Optional[opt.OptimizerConfig] = None, *,
                    mode: Optional[ExecutionMode] = None, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics): the loss and its gradients (``make_loss_and_grads``), then
    one ``optimizer.apply``.  The model's parameters must require grad;
    they are updated in place."""
    ocfg = ocfg or opt.OptimizerConfig()
    loss_and_grads = make_loss_and_grads(cfg, mode=mode, remat=remat,
                                         microbatches=microbatches)

    def train_step(model, opt_state: opt.OptState,
                   batch: Dict[str, torch.Tensor]):
        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        loss, grads = loss_and_grads(model, params, batch)
        _, opt_state, metrics = opt.apply(
            ocfg, params, dict(zip(params, grads)), opt_state)
        metrics["loss"] = float(loss)
        return model, opt_state, metrics

    return train_step


def local_batch(batch: Dict[str, np.ndarray], shardings, mesh
                ) -> Dict[str, np.ndarray]:
    """This rank's block of a global batch placed by ``shardings``
    (``sharding.batch_shardings``) on ``mesh``."""
    from repro_torch.distributed.sharding import local_index
    return {k: v[local_index(v.shape, mesh, shardings[k].placements)]
            for k, v in batch.items()}


class MeshTrainStep:
    """The train step on a ``DeviceMesh`` (the module docstring):
    ``self.params`` and ``self.opt_state`` hold the DTensor state, placed
    by ``self.shardings``; calling it with the rank's block of a batch
    (``local_batch``) trains one step and returns the metrics, the same
    keys as ``make_train_step``'s.  ``gather()`` writes the state's values
    into the model's parameters."""

    def __init__(self, cfg: ModelConfig, model, mesh,
                 ocfg: Optional[opt.OptimizerConfig] = None, *,
                 mode: Optional[ExecutionMode] = None, remat: bool = True,
                 microbatches: int = 1, fsdp_threshold: float = 8e9):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from repro_torch.distributed import sharding as SH
        self.cfg, self.model, self.mesh = cfg, model, mesh
        self.ocfg = ocfg or opt.OptimizerConfig()
        self.loss_and_grads = make_loss_and_grads(
            cfg, mode=mode, remat=remat, microbatches=microbatches)
        self.names = [k for k, p in model.named_parameters()
                      if p.requires_grad]
        self.shardings = SH.param_shardings(model, cfg, mesh,
                                            fsdp_threshold=fsdp_threshold)
        self.batch_axes = SH.batch_axes(mesh)
        sizes = SH.axis_sizes(mesh)
        self.dp = int(np.prod([sizes[a] for a in self.batch_axes]))
        self._partial = tuple(
            Partial() if a in self.batch_axes else Replicate()
            for a in mesh.mesh_dim_names)
        self._replicate = (Replicate(),) * mesh.ndim
        # ranks holding each parameter's block: the sizes of the mesh dims
        # it is replicated over
        self._copies = {k: int(np.prod([
            mesh.size(d) for d, pl in enumerate(self.shardings[k].placements)
            if isinstance(pl, Replicate)])) for k in self.names}
        params = dict(model.named_parameters())

        def place(t: torch.Tensor, name: str):
            pl = self.shardings[name].placements
            block = t[SH.local_index(t.shape, mesh, pl)]
            return DTensor.from_local(block.detach().clone(
                memory_format=torch.contiguous_format), mesh, pl,
                run_check=False)

        self.params = {k: place(params[k], k) for k in self.names}

        def zeros():
            out = {}
            for k in self.names:
                pl = self.shardings[k].placements
                idx = SH.local_index(params[k].shape, mesh, pl)
                out[k] = DTensor.from_local(torch.zeros(
                    [s.stop - s.start for s in idx], dtype=torch.float32,
                    device=params[k].device), mesh, pl, run_check=False)
            return out
        self.opt_state = opt.OptState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def gather(self) -> None:
        """Write the (sharded) parameter state into the model's whole
        parameters: an all-gather per sharded tensor."""
        params = dict(self.model.named_parameters())
        for k in self.names:
            params[k].copy_(self.params[k].full_tensor())

    def _reduce(self, t: torch.Tensor, placements) -> torch.Tensor:
        """This rank's block, by ``placements``, of the mean over the
        data-parallel ranks of each rank's ``t``: Partial over (pod, data)
        redistributed to the target placements (a reduce-scatter on a
        sharded mesh dim, an all-reduce on a replicated one, a local slice
        over 'model')."""
        from torch.distributed.tensor import DTensor
        if self.mesh.size() == 1:
            return t
        out = DTensor.from_local(t, self.mesh, self._partial,
                                 run_check=False).redistribute(
            self.mesh, placements).to_local()
        return out / self.dp if self.dp > 1 else out

    def _global_norm(self, local: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients from the rank's blocks:
        each block's sum of squares over the number of ranks that hold it,
        summed over the mesh (one all-reduce a mesh dim); on one rank
        ``optimizer.global_norm`` itself."""
        from torch.distributed.tensor import DTensor, Partial
        if self.mesh.size() == 1:
            return opt.global_norm(local)
        total = None
        for k, g in local.items():
            sq = g.float().square().sum() / self._copies[k]
            total = sq if total is None else total + sq
        total = DTensor.from_local(total, self.mesh,
                                   (Partial(),) * self.mesh.ndim,
                                   run_check=False).full_tensor()
        return torch.sqrt(total)

    def step(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """One step, nothing read back from the device: (the loss, the
        global gradient norm, the learning rate)."""
        self.gather()
        params = dict(self.model.named_parameters())
        params = {k: params[k] for k in self.names}
        loss, grads = self.loss_and_grads(self.model, params, batch)
        loss = self._reduce(loss, self._replicate)
        local = {k: self._reduce(g, self.shardings[k].placements)
                 for k, g in zip(self.names, grads)}
        del grads
        gnorm = self._global_norm(local)
        st = self.opt_state
        new, gnorm, lr = opt.update(
            self.ocfg, {k: p.to_local() for k, p in self.params.items()},
            local, opt.OptState(step=st.step,
                                mu={k: m.to_local() for k, m in st.mu.items()},
                                nu={k: v.to_local() for k, v in st.nu.items()}),
            gnorm=gnorm)
        self.opt_state = opt.OptState(step=new.step, mu=st.mu, nu=st.nu)
        return loss, gnorm, lr

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        loss, gnorm, lr = self.step(batch)
        return {"grad_norm": float(gnorm), "lr": lr, "loss": float(loss)}

