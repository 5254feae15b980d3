"""The training loop (counterpart of ``repro/train/loop.py``), on one
device or on a ``DeviceMesh``: deterministic resumable data, asynchronous
atomic sharded checkpoints, exact restart from the latest complete
checkpoint, and metrics.

Fault-tolerance contract (DESIGN.md §5): a restart resumes from the latest
complete checkpoint; the data stream is a pure function of (seed, step),
so the resumed run equals an uninterrupted one; checkpoint writes run off
the step loop; a restore places each saved tensor on the current mesh,
whatever mesh saved it (elastic).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode, Family, ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.train import optimizer as OPT
from repro_torch.train import steps as ST
from repro_torch.train.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    microbatches: int = 1
    mode: Optional[ExecutionMode] = None
    opt: OPT.OptimizerConfig = dataclasses.field(
        default_factory=OPT.OptimizerConfig)


def build_model(cfg: ModelConfig, device: torch.device, seed: int):
    """The model of ``cfg`` with weights drawn from ``seed`` on ``device``,
    its parameters requiring grad."""
    mod = registry.model_module(cfg)
    cls = {Family.CROSSMODAL: "ViLBERT", Family.ENCDEC: "EncDec"}.get(
        cfg.family, "Transformer")
    cls = getattr(mod, cls)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cls(cfg, device=device, generator=gen).requires_grad_(True)


def build_sharded(cfg: ModelConfig, device: torch.device, seed: int, mesh,
                  fsdp_threshold: float = 8e9):
    """``build_model``'s weights, of which only this rank's blocks are
    kept: (the model with its parameters on ``meta``, requiring grad,
    {name: the rank's block on ``device``}), the blocks placed by the rule
    table (``sharding.param_shardings`` at ``fsdp_threshold``).  A first
    build that allocates nothing (``FakeTensorMode``, nothing drawn) reads
    the order in which the model creates its parameters
    (``layers.param``); the second draws them from ``seed`` on
    ``device`` in that order, as ``build_model`` does (the same values),
    and keeps each one's block as it is drawn, so that no whole model
    exists on the rank (at most one whole parameter at a time)."""
    from torch import nn
    from torch._subclasses.fake_tensor import FakeTensorMode
    order = []

    def record(t):
        order.append(nn.Parameter(t, requires_grad=False))
        return order[-1]
    with FakeTensorMode(allow_non_fake_inputs=True), runtime.flags(
            abstract_init=True, param_hook=record):
        shape_model = build_model(cfg, torch.device("cpu"), seed)
    names = {id(p): k for k, p in shape_model.named_parameters()}
    order = [names[id(p)] for p in order]
    shardings = SH.param_shardings(shape_model, cfg, mesh,
                                   fsdp_threshold=fsdp_threshold)
    blocks, calls = {}, iter(order)

    def keep(t):
        name = next(calls)
        pl = shardings[name].placements
        blocks[name] = t[SH.local_index(t.shape, mesh, pl)].clone(
            memory_format=torch.contiguous_format)
        return nn.Parameter(torch.empty(t.shape, dtype=t.dtype,
                                        device="meta"), requires_grad=False)
    with runtime.flags(param_hook=keep):
        model = build_model(cfg, device, seed)
    return model.requires_grad_(True), blocks


def to_device(batch: Dict[str, np.ndarray], cfg: ModelConfig,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: integers as int64 (indices),
    floats in f32 (the model casts them to its dtype)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, torch.int64 if t.dtype in (
            torch.int32, torch.int64) else torch.float32)
    return out


def train(cfg: ModelConfig, shape: ShapeConfig, source, tcfg: TrainConfig, *,
          device: Optional[Union[str, torch.device]] = None,
          hooks: Optional[Dict[str, Callable]] = None, mesh: Any = None,
          fsdp_threshold: float = 8e9,
          gather_model: bool = False) -> Dict[str, Any]:
    """Run the loop on one device (the card unless ``device`` names
    another; without a card and without ``device="cpu"`` this raises), or
    on a ``DeviceMesh`` of such devices (``launch.mesh``; ``device`` then
    names the mesh's device type): each parameter and both AdamW moments
    placed by the rule table (``fsdp_threshold`` as in
    ``sharding.param_shardings``), the batch by ``batch_shardings``, the
    gradients reduced over (pod, data) (``steps.MeshTrainStep``); with
    ``mesh=None`` the single-device step.  On a mesh no rank holds the
    whole model: it is built with only the rank's blocks
    (``build_sharded``), and the step gathers them a unit at a time.
    Returns {"model", "opt_state", "metrics"}; on a mesh also "params",
    the DTensor parameters, ``opt_state`` holds the DTensor moments, and
    the model the whole final parameters only with ``gather_model``
    (otherwise its parameters stay on ``meta``).  ``hooks["on_log"]``
    gets each logged metrics dict."""
    device = runtime.resolve_device(device)
    if mesh is not None and getattr(mesh, "device_type", None) != \
            device.type:
        raise ValueError(f"train: the mesh {mesh!r} is not a DeviceMesh of "
                         f"{device.type} devices")
    hooks = hooks or {}
    specs = registry.input_specs(cfg, shape)
    if mesh is None:
        model = build_model(cfg, device, tcfg.seed)
        params = {k: p for k, p in model.named_parameters()}
        opt_state = OPT.init(params)
        step_fn = ST.make_train_step(cfg, tcfg.opt, mode=tcfg.mode,
                                     microbatches=tcfg.microbatches)
        bshard = None
    else:
        model, blocks = build_sharded(cfg, device, tcfg.seed, mesh,
                                      fsdp_threshold)
        mstep = ST.MeshTrainStep(cfg, model, mesh, tcfg.opt, mode=tcfg.mode,
                                 microbatches=tcfg.microbatches,
                                 fsdp_threshold=fsdp_threshold, blocks=blocks)
        del blocks
        params, opt_state = mstep.params, mstep.opt_state
        bshard = SH.batch_shardings(specs, mesh)
    ckpt = Checkpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
    start_step = 0
    if ckpt is not None:
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {
                "params": params, "opt": {"step": 0, "mu": opt_state.mu,
                                          "nu": opt_state.nu}})
            opt_state = OPT.OptState(step=int(state["opt"]["step"]),
                                     mu=opt_state.mu, nu=opt_state.nu)
            if mesh is not None:
                mstep.opt_state = opt_state
            start_step = latest

    metrics_hist = []
    t_last = time.time()
    for step in range(start_step, tcfg.steps):
        batch = source.batch(step)
        got = {k: tuple(v.shape) for k, v in batch.items()}
        if got != specs:
            raise ValueError(f"train: the source's batch {got} does not fit "
                             f"{shape.name} ({specs})")
        if mesh is None:
            model, opt_state, metrics = step_fn(
                model, opt_state, to_device(batch, cfg, device))
        else:
            metrics = mstep(to_device(ST.local_batch(batch, bshard, mesh),
                                      cfg, device))
            opt_state = mstep.opt_state
        if (step + 1) % tcfg.log_every == 0 or step == tcfg.steps - 1:
            m = dict(metrics)
            dt = time.time() - t_last
            m["steps_per_s"] = tcfg.log_every / max(dt, 1e-9)
            t_last = time.time()
            m["step"] = step + 1
            metrics_hist.append(m)
            if "on_log" in hooks:
                hooks["on_log"](m)
        if ckpt is not None and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save_async(step + 1, {
                "params": params, "opt": {"step": opt_state.step,
                                          "mu": opt_state.mu,
                                          "nu": opt_state.nu}})
    if ckpt is not None:
        ckpt.wait()
    out = {"model": model, "opt_state": opt_state, "metrics": metrics_hist}
    if mesh is not None:
        if gather_model:
            mstep.gather()
        out["params"] = params
    return out
