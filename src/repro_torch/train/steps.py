"""The train step (counterpart of ``repro/train/steps.py``'s
``make_train_step``; the serving steps are ``Transformer.prefill`` and
``decode_step``), on one device or on a ``DeviceMesh``.

On a mesh (``MeshTrainStep``) every parameter and both AdamW moments are
stored as DTensors placed by the rule table
(``distributed.sharding.param_shardings``): each rank holds its blocks
(ZeRO-3 over 'data' above the FSDP threshold, 'model' by the rules).  The
step computes sharded, as GSPMD partitions the JAX step
(``repro/train/loop.py:49-74``):

* over 'model', the layers compute on the rank's blocks where
  ``distributed.parallel`` splits them (dense attention's heads, the MLP's
  d_ff, the MoE's experts or each expert's d_ff, MLA's heads, the SSM's
  heads or its out-projection's rows, vilbert's heads in both streams,
  whisper's encoder, decoder and cross-attention heads, the vocabulary):
  nothing of them is gathered over 'model'.  Under the caller's hint
  table (``runtime.flags(sharding_hints=...)``, which the step reads as
  the layers run, the recomputation included), dense attention whose
  heads do not split runs context-parallel on the rank's query rows
  (whisper's 8 heads at 16; its 1500 encoder frames, which 16 does not
  divide, on blocks of 94).  The replicated weights that feed only the
  rank's share (the router, context-parallel attention's weights, a kv
  group's K/V, the SSM's conv and gains), and MLA's latent activations,
  enter by ``parallel``'s ``copy``, so that their gradients arrive summed
  over 'model'.  A parameter whose split dim the 'model' size does not
  divide is gathered whole over 'model' and computed replicated
  (``parallel.replicated_over_model``: none at the production mesh);
* over the batch axes, the parameters are gathered a unit at a time, as
  the model code asks for them (``parallel.unit``): one layer, the
  embedding, or the final norm with the output matrix.  A unit is gathered
  just before its forward and freed after it, and gathered again for its
  recomputation in the backward.  Under ``remat`` (the default) a rank
  then holds at most two gathered units beside its blocks
  (``max_live_units``); without it autograd keeps every unit's gathered
  tensors for the backward, so that the whole model can sit gathered.
  A gradient of a parameter sharded over a batch axis goes straight to
  its block through the gather's backward, a reduce-scatter each
  microbatch: no whole gradient of a sharded parameter is formed.  A
  parameter replicated over the batch axes keeps the rank's own gradient
  through the microbatches and is all-reduced once a step.  Both are the
  mean over the data-parallel ranks.
  Parameters outside every unit (``unit_names`` of the model: the
  encoder-decoder family's, whose layers are no units yet, the
  crossmodal family's embeddings, projections and heads) are gathered
  for the whole step, over the batch axes only where the layers take
  their 'model' blocks.

The loss is reduced over the batch axes, the global norm taken from the
blocks, and AdamW updates the rank's blocks.  On a (1, 1) mesh nothing is
gathered or reduced: the layers read the blocks, and every number is the
single-device step's.
"""
from __future__ import annotations

import contextlib
import weakref
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


class _Gather(torch.autograd.Function):
    """A parameter's block (stored placements) -> the tensor its layers
    compute on (``MeshTrainStep._gathered_pl``); backward: the rank's
    gradient of that tensor -> its share of the mean gradient, at the
    stored placements (``MeshTrainStep._reduce``)."""

    @staticmethod
    def forward(ctx, block, step, name):
        ctx.step, ctx.name = step, name
        return step._gather(block, name)

    @staticmethod
    def backward(ctx, g):
        return ctx.step._reduce(g, ctx.name), None, None


class MeshTrainStep:
    """The train step on a ``DeviceMesh`` (the module docstring):
    ``self.params`` and ``self.opt_state`` hold the DTensor state, placed
    by ``self.shardings``; calling it with the rank's block of a batch
    (``local_batch``) trains one step and returns the metrics, the same
    keys as ``make_train_step``'s.  ``blocks`` ({name: the rank's block}),
    when given, is the state's initial values and ``model`` only its
    structure (``loop.build_sharded``: parameters on ``meta``); otherwise
    each block is cut from ``model``'s parameters.  ``gather()`` writes
    the state's whole values into the model's parameters."""

    def __init__(self, cfg: ModelConfig, model, mesh,
                 ocfg: Optional[opt.OptimizerConfig] = None, *,
                 mode: Optional[ExecutionMode] = None, remat: bool = True,
                 microbatches: int = 1, fsdp_threshold: float = 8e9,
                 blocks: Optional[Dict[str, torch.Tensor]] = None):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.distributed import parallel as PL
        from repro_torch.distributed import sharding as SH
        self.cfg, self.model, self.mesh = cfg, model, mesh
        self.ocfg = ocfg or opt.OptimizerConfig()
        self.loss_and_grads = make_loss_and_grads(
            cfg, mode=mode, remat=remat, microbatches=microbatches)
        params = dict(model.named_parameters())
        self.names = [k for k, p in params.items() if p.requires_grad]
        self.shardings = SH.param_shardings(model, cfg, mesh,
                                            fsdp_threshold=fsdp_threshold)
        self.batch_axes = SH.batch_axes(mesh)
        sizes = SH.axis_sizes(mesh)
        self.dp = int(np.prod([sizes[a] for a in self.batch_axes]))
        self.local = PL.local_names(
            {k: tuple(params[k].shape) for k in self.names}, cfg, sizes)
        dims = mesh.mesh_dim_names
        self._replicate = (Replicate(),) * mesh.ndim
        self._partial = tuple(Partial() if a in self.batch_axes
                              else Replicate() for a in dims)

        def target(k, partial):
            # the placements a parameter's layers compute on (gathered
            # over every axis but 'model' where they take its block), or
            # those of its rank's gradient (Partial over the batch axes)
            stored = self.shardings[k].placements
            return tuple(
                st if a == "model" and k in self.local else
                Partial() if partial and a in self.batch_axes else
                Replicate() for a, st in zip(dims, stored))
        self._gathered_pl = {k: target(k, False) for k in self.names}
        self._partial_pl = {k: target(k, True) for k in self.names}
        # the parameters replicated over every batch axis: their
        # gradients stay Partial over those axes through the microbatches
        # (at the stored placements over 'model') and are summed once a
        # step (``_sum_held``); ``_held_now`` names those that got one
        self._held_pl = {
            k: tuple(Partial() if a in self.batch_axes else st
                     for a, st in zip(dims, self.shardings[k].placements))
            for k in self.names
            if not any(isinstance(st, Shard) for a, st in
                       zip(dims, self.shardings[k].placements)
                       if a in self.batch_axes)}
        self._held_now: set = set()
        # ranks holding each parameter's block: the sizes of the mesh dims
        # it is replicated over
        self._copies = {k: int(np.prod([
            mesh.size(d) for d, pl in enumerate(self.shardings[k].placements)
            if isinstance(pl, Replicate)])) for k in self.names}

        def block_of(k):
            if blocks is not None:
                return blocks[k]
            t = params[k]
            return t[SH.local_index(t.shape, mesh,
                                    self.shardings[k].placements)].detach(
                ).clone(memory_format=torch.contiguous_format)
        # the rank's blocks: the leaves the step differentiates, and the
        # storage of ``self.params``
        self.blocks = {k: block_of(k).requires_grad_(True)
                       for k in self.names}
        self.params = {k: DTensor.from_local(
            self.blocks[k].detach(), mesh, self.shardings[k].placements,
            run_check=False) for k in self.names}
        self.opt_state = opt.OptState(step=0, mu=self._zeros(),
                                      nu=self._zeros())
        # units: the model's parameters by module, and those no unit of
        # the model code covers (gathered for the whole step)
        self._prefix = {id(m): n for n, m in model.named_modules()}
        units = set(model.unit_names()) if hasattr(model, "unit_names") \
            else set()
        self.resident = [k for k in self.names if k not in units]
        coord = mesh.get_coordinate()
        m = sizes.get("model", 1)
        group = mesh.get_group("model") if m > 1 else None
        self.tp = PL.ModelParallel(
            coord[dims.index("model")] if "model" in dims else 0, m, group,
            [self._owner(k) for k in self.local], gatherer=self)
        # gathered units: alive now, at most at once, and in all
        self.live_units = self.max_live_units = self.units_gathered = 0

    def _zeros(self) -> Dict[str, object]:
        from torch.distributed.tensor import DTensor
        return {k: DTensor.from_local(
            torch.zeros(b.shape, dtype=torch.float32, device=b.device),
            self.mesh, self.shardings[k].placements, run_check=False)
            for k, b in self.blocks.items()}

    def _owner(self, name: str):
        owner, _, leaf = name.rpartition(".")
        return self.model.get_submodule(owner), leaf

    # -- gathering ------------------------------------------------------

    def _gather(self, block: torch.Tensor, name: str) -> torch.Tensor:
        """The block redistributed to the placements its layers compute on
        (an all-gather over each batch axis it is sharded on, and over
        'model' where the layers do not take its 'model' block)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            block.detach(), self.mesh, self.shardings[name].placements,
            run_check=False).redistribute(
            self.mesh, self._gathered_pl[name]).to_local()

    def _reduce(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block, by the stored placements, of the mean over
        the data-parallel ranks of each rank's gradient ``g`` (Partial
        over the batch axes): a reduce-scatter on a sharded batch axis, a
        local slice over 'model' where the layers computed on the whole
        tensor.  A parameter replicated over the batch axes keeps ``g``
        Partial over them (``_sum_held`` reduces it once a step)."""
        from torch.distributed.tensor import DTensor
        held = self._held_pl.get(name)
        out = DTensor.from_local(
            g.contiguous(), self.mesh, self._partial_pl[name],
            run_check=False).redistribute(
            self.mesh, held or self.shardings[name].placements).to_local()
        if held:
            self._held_now.add(name)
            return out
        return out / self.dp if self.dp > 1 else out

    def _sum_held(self, g: torch.Tensor, name: str) -> torch.Tensor:
        """The mean over the data-parallel ranks of a replicated
        parameter's gradient ``g``, summed over the step's microbatches:
        one all-reduce over the batch axes."""
        from torch.distributed.tensor import DTensor
        out = DTensor.from_local(
            g.contiguous(), self.mesh, self._held_pl[name],
            run_check=False).redistribute(
            self.mesh, self.shardings[name].placements).to_local()
        return out / self.dp if self.dp > 1 else out

    def _track(self, tensors) -> None:
        """Count a gathered unit live until every tensor of it is freed."""
        left = [len(tensors)]

        def freed():
            left[0] -= 1
            if left[0] == 0:
                self.live_units -= 1
        self.live_units += 1
        self.units_gathered += 1
        self.max_live_units = max(self.max_live_units, self.live_units)
        for t in tensors:
            weakref.finalize(t, freed)

    @contextlib.contextmanager
    def gathered(self, root, names=None):
        """``root``'s parameters ``names`` (relative to ``root``; all of
        them: None) gathered (``_Gather``) and standing in the model's
        modules for the block; on a one-rank mesh the blocks themselves."""
        from repro_torch.distributed.parallel import swapped
        prefix = self._prefix[id(root)]
        if names is None:
            names = [n for n, _ in root.named_parameters()]
        full = {n: f"{prefix}.{n}" if prefix else n for n in names}
        if self.mesh.size() == 1:
            tensors = {n: self.blocks[k] for n, k in full.items()}
        else:
            tensors = {n: _Gather.apply(self.blocks[k], self, k)
                       for n, k in full.items()}
            self._track(list(tensors.values()))
        with swapped(root, tensors):
            yield

    # -- the step -------------------------------------------------------

    @torch.no_grad()
    def gather(self) -> None:
        """Write the (sharded) parameter state into the model's whole
        parameters: an all-gather per sharded tensor.  A model on ``meta``
        (``loop.build_sharded``) gets storage on the blocks' device
        first."""
        device = next(iter(self.blocks.values())).device
        if any(p.is_meta for p in self.model.parameters()):
            self.model.to_empty(device=device)
        params = dict(self.model.named_parameters())
        for k in self.names:
            params[k].copy_(self.params[k].full_tensor())

    def _reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean over the data-parallel ranks of each rank's loss."""
        from torch.distributed.tensor import DTensor
        if self.mesh.size() == 1:
            return loss
        out = DTensor.from_local(loss, self.mesh, self._partial,
                                 run_check=False).redistribute(
            self.mesh, self._replicate).to_local()
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
        from repro_torch.distributed import parallel as PL
        resident = (self.gathered(self.model, self.resident)
                    if self.resident else contextlib.nullcontext())
        with PL.using(self.tp), resident:
            loss, grads = self.loss_and_grads(self.model, self.blocks, batch)
        loss = self._reduce_loss(loss)
        local = dict(zip(self.names, grads))
        del grads
        # in the parameters' order, the same on every rank
        for k in [k for k in self.names if k in self._held_now]:
            local[k] = self._sum_held(local[k], k)
        self._held_now.clear()
        gnorm = self._global_norm(local)
        st = self.opt_state
        new, gnorm, lr = opt.update(
            self.ocfg, {k: b.detach() for k, b in self.blocks.items()},
            local, opt.OptState(step=st.step,
                                mu={k: m.to_local() for k, m in st.mu.items()},
                                nu={k: v.to_local() for k, v in st.nu.items()}),
            gnorm=gnorm)
        self.opt_state = opt.OptState(step=new.step, mu=st.mu, nu=st.nu)
        return loss, gnorm, lr

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        loss, gnorm, lr = self.step(batch)
        return {"grad_norm": float(gnorm), "lr": lr, "loss": float(loss)}
