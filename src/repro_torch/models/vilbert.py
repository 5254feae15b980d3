"""ViLBERT-style two-stream multimodal encoder (arXiv:1908.02265), the
paper's own workload (counterpart of ``repro/models/vilbert.py``).

The language stream runs ``num_layers - num_coattn_layers`` plain encoder
layers, then both streams run ``num_coattn_layers`` co-TRM blocks.  A co-TRM
block per stream is co-attention (Q from its own stream, K/V generated from
the other modality's activations: the cross-forwarding case), then
self-attention, then the FFN.  DTPU pruning runs between co-TRM blocks: each
stream keeps the tokens the other stream attends to most.  The vision
frontend is a stub: region embeddings arrive precomputed (B, S_x, D_x).
Structure and order are those of vilbert.py:147-211.  ``logits`` is the
forward recorded by autograd (remat of the text-only layers and of each
co-TRM block as the JAX ``pre_step``/``co_body``), and ``loss_fn`` the VQA
cross-entropy (vilbert.py:214); the pruning's token choice is not
differentiated, its gather is.  Each text-only layer and each co-TRM
block (both streams) is a unit of the mesh train step
(``distributed.parallel.unit``), gathered for its forward, for its
recomputation, and for the pruning scores that read it; over 'model'
its attention runs on the rank's heads (``_attn``), its MLP on the
rank's d_ff block (``layers.mlp_forward``), and the text embedding on
the rank's vocabulary rows (``layers.embed_lookup``).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import pruning as P
from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops
from repro_torch.models.layers import (MLP, Embedding, LayerNorm, dense_init,
                                       embed_lookup, layer_norm, mlp_forward,
                                       move_to, param, torch_dtype)
from repro_torch.plan.heuristics import resolve_layer_mode

VQA_ANSWERS = 3129   # VQA v2 answer vocabulary


class XAttn(nn.Module):
    """Attention weights: wq (d_q, H, hd), wk/wv (d_kv, H, hd), wo (H, hd, d_q)."""

    def __init__(self, cfg: ModelConfig, d_q: int, d_kv: int, heads: int,
                 head_dim: int, generator: torch.Generator):
        super().__init__()
        dt, g = torch_dtype(cfg.param_dtype), generator
        self.wq = param(dense_init((d_q, heads, head_dim), dt, generator=g))
        self.wk = param(dense_init((d_kv, heads, head_dim), dt, generator=g))
        self.wv = param(dense_init((d_kv, heads, head_dim), dt, generator=g))
        self.wo = param(dense_init((heads, head_dim, d_q), dt, generator=g))


class TextLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, h, dev = cfg.d_model_y, cfg.num_heads_y, generator.device
        dt = torch_dtype(cfg.param_dtype)
        self.ln1 = LayerNorm(d, dt, dev)
        self.attn = XAttn(cfg, d, d, h, d // h, generator)
        self.ln2 = LayerNorm(d, dt, dev)
        self.mlp = MLP(cfg, d, cfg.d_ff_y, generator)


class StreamBlock(nn.Module):
    """One stream's half of a co-TRM block."""

    def __init__(self, cfg: ModelConfig, d: int, d_other: int, heads: int,
                 d_ff: int, generator: torch.Generator):
        super().__init__()
        hd, dev = d // heads, generator.device
        dt = torch_dtype(cfg.param_dtype)
        self.ln_co = LayerNorm(d, dt, dev)
        self.co_attn = XAttn(cfg, d, d_other, heads, hd, generator)
        self.ln_self = LayerNorm(d, dt, dev)
        self.self_attn = XAttn(cfg, d, d, heads, hd, generator)
        self.ln_ff = LayerNorm(d, dt, dev)
        self.mlp = MLP(cfg, d, d_ff, generator)


def _resolve(cfg: ModelConfig, mode: ExecutionMode, d_kv: int,
             kv_heads: int, head_dim: int) -> ExecutionMode:
    """The planner's per-layer rule on the true K/V-source width:
    cross-attention resolves against the other modality's width."""
    return resolve_layer_mode(mode, d_kv=d_kv, num_kv_heads=kv_heads,
                              head_dim=head_dim,
                              fuse_kv_generation=cfg.fuse_kv_generation)


def _attn(p: XAttn, cfg: ModelConfig, x_q: torch.Tensor,
          x_kv: torch.Tensor, mode: ExecutionMode) -> torch.Tensor:
    """Q from x_q; K/V from x_kv (x_q itself for self-attention).  Where
    the active mesh step hands the layers the rank's heads (``p.wq`` (d,
    H/m, hd): ``parallel`` takes vilbert's attention weights wherever the
    rule splits them evenly), Q comes from the rank's ``wq`` block, the
    kernels generate only the rank's heads' K/V from x_kv (the stream
    kernel from the other modality's activations, in TILE_STREAM), and
    ``wo`` is row-parallel; x_q and x_kv enter by ``copy``.  The mode
    resolves at the layer's whole head count, as the JAX step's trace
    does."""
    tp = parallel.active()
    split = tp is not None and tp.local(p, "wq")
    heads = p.wq.shape[1]
    if split:
        same = x_kv is x_q
        x_q = tp.copy(x_q)
        x_kv = x_q if same else tp.copy(x_kv)
        heads *= tp.size
    q = torch.einsum("bsd,dhe->bhse", x_q, p.wq.to(x_q.dtype))
    mode = _resolve(cfg, mode, x_kv.shape[-1], heads, q.shape[-1])
    out = ops.attention_by_mode(mode, q, x_kv, p.wk, p.wv, causal=False)
    out = torch.einsum("bhse,hed->bsd", out, p.wo.to(x_q.dtype))
    return tp.reduce(out) if split else out


def _stream_block(p: StreamBlock, cfg: ModelConfig, x_own: torch.Tensor,
                  x_other: torch.Tensor, mode: ExecutionMode) -> torch.Tensor:
    h = layer_norm(p.ln_co, x_own, eps=cfg.norm_eps)
    ho = layer_norm(p.ln_co, x_other, eps=cfg.norm_eps) \
        if x_other.shape[-1] == x_own.shape[-1] else x_other
    x_own = x_own + _attn(p.co_attn, cfg, h, ho, mode)
    h2 = layer_norm(p.ln_self, x_own, eps=cfg.norm_eps)
    x_own = x_own + _attn(p.self_attn, cfg, h2, h2, mode)
    h3 = layer_norm(p.ln_ff, x_own, eps=cfg.norm_eps)
    return x_own + mlp_forward(p.mlp, h3)


def _text_layer(p: TextLayer, cfg: ModelConfig, y: torch.Tensor,
                mode: ExecutionMode) -> torch.Tensor:
    """One text-only encoder layer (the JAX ``pre_body``)."""
    h = layer_norm(p.ln1, y, eps=cfg.norm_eps)
    y = y + _attn(p.attn, cfg, h, h, mode)
    h2 = layer_norm(p.ln2, y, eps=cfg.norm_eps)
    return y + mlp_forward(p.mlp, h2)


def _co_block(px: StreamBlock, py: StreamBlock, cfg: ModelConfig,
              x: torch.Tensor, y: torch.Tensor, mode: ExecutionMode):
    """One co-TRM block, both streams from the block's inputs (the JAX
    ``co_body``)."""
    return (_stream_block(px, cfg, x, y, mode),
            _stream_block(py, cfg, y, x, mode))


def _co_unit(model: "ViLBERT", i: int, cfg: ModelConfig, x: torch.Tensor,
             y: torch.Tensor, mode: ExecutionMode):
    """Co-TRM block ``i`` inside its unit: what the block loop
    checkpoints, so that the recomputation gathers it again."""
    names = model.co_names(i) if parallel.active() else None
    with parallel.unit(model, names):
        return _co_block(model.co_x[i], model.co_y[i], cfg, x, y, mode)


def _dtpu_cross_scores(p: StreamBlock, x: torch.Tensor, y: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Rank y's tokens by the attention mass x's queries pay them (the
    mean over heads).  On the rank's heads of a mesh step, each rank's
    mean over its heads, summed over 'model' and divided by m, so that
    every rank prunes the same tokens."""
    q = torch.einsum("bsd,dhe->bhse", x, p.co_attn.wq.to(x.dtype))
    k = torch.einsum("bsd,dhe->bhse", y, p.co_attn.wk.to(y.dtype))
    s = P.attention_column_scores(q, k, causal=False, sample_stride=stride)
    tp = parallel.active()
    if tp is not None and tp.local(p.co_attn, "wq"):
        s = tp.all_reduce(s, "sum") / tp.size
    return s


class ViLBERT(nn.Module):
    """Vision stream X has width ``cfg.d_model``; language stream Y has
    ``cfg.d_model_y``.  Weights are drawn from ``generator`` (seed 0 on the
    model's device by default) with the shapes and scales of the JAX init."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = runtime.resolve_device(device)
        g = generator or torch.Generator(device=device).manual_seed(0)
        dt = torch_dtype(cfg.param_dtype)
        n_pre = cfg.num_layers - cfg.num_coattn_layers
        self.cfg = cfg
        self.text_embed = Embedding(cfg.vocab_size, cfg.d_model_y, dt, g)
        self.text_pos = param(dense_init((cfg.seq_y or 4096, cfg.d_model_y),
                                         dt, generator=g, scale=0.01))
        self.vis_proj = param(dense_init((cfg.d_model, cfg.d_model), dt,
                                         generator=g))
        self.text_pre = nn.ModuleList(TextLayer(cfg, g) for _ in range(n_pre))
        self.co_x = nn.ModuleList(
            StreamBlock(cfg, cfg.d_model, cfg.d_model_y, cfg.num_heads,
                        cfg.d_ff, g) for _ in range(cfg.num_coattn_layers))
        self.co_y = nn.ModuleList(
            StreamBlock(cfg, cfg.d_model_y, cfg.d_model, cfg.num_heads_y,
                        cfg.d_ff_y, g) for _ in range(cfg.num_coattn_layers))
        self.pool_x = param(dense_init((cfg.d_model, cfg.d_model), dt,
                                       generator=g))
        self.pool_y = param(dense_init((cfg.d_model_y, cfg.d_model), dt,
                                       generator=g))
        self.vqa_head = param(dense_init((cfg.d_model, VQA_ANSWERS), dt,
                                         generator=g))
        move_to(self, device)

    def co_names(self, i: int) -> list:
        """Co-TRM block ``i``'s parameters, both streams (one unit)."""
        return [f"{side}.{i}.{n}" for side in ("co_x", "co_y")
                for n, _ in getattr(self, side)[i].named_parameters()]

    def unit_names(self) -> list:
        """The parameters the encoder asks the mesh step for a unit at a
        time: the text-only layers' and the co-TRM blocks' (the
        embeddings, projections and heads are gathered for the step)."""
        return [k for k, _ in self.named_parameters()
                if k.split(".")[0] in ("text_pre", "co_x", "co_y")]

    @torch.no_grad()
    def encode(self, batch: Dict[str, torch.Tensor], *,
               mode: Optional[ExecutionMode] = None):
        """The two-stream encoder.  batch: {"regions": (B, S_x, D_x) vision
        embeddings, "tokens": (B, S_y) text ids}.  Returns the final vision
        and language streams (B, n_x, D_x), (B, n_y, D_y) and the per-block
        kept-token counts ((n_x, n_y), ...)."""
        return self._encode(batch, mode=mode)

    def _encode(self, batch: Dict[str, torch.Tensor], *,
                mode: Optional[ExecutionMode] = None, remat: bool = False):
        """``encode`` as autograd records it; ``remat`` recomputes each
        text-only layer and each co-TRM block in the backward."""
        cfg = self.cfg
        remat = remat and torch.is_grad_enabled()
        mode = ExecutionMode(mode or cfg.execution_mode)
        dt = torch_dtype(cfg.dtype)
        x = torch.matmul(batch["regions"].to(dt), self.vis_proj.to(dt))
        y = embed_lookup(self.text_embed, batch["tokens"])
        y = y + self.text_pos[:y.shape[1]].to(y.dtype)[None]

        for lp in self.text_pre:
            y = (checkpoint(parallel.run_unit, lp, _text_layer, cfg, y, mode,
                            use_reentrant=False)
                 if remat else parallel.run_unit(lp, _text_layer, cfg, y,
                                                 mode))

        # Co-TRM blocks with DTPU pruning between blocks (static keep plan).
        n_co = cfg.num_coattn_layers
        on = cfg.pruning.enabled
        plan_x = P.keep_plan(cfg.pruning, n_co, x.shape[1]) if on \
            else (x.shape[1],) * n_co
        plan_y = P.keep_plan(cfg.pruning, n_co, y.shape[1]) if on \
            else (y.shape[1],) * n_co
        counts = []
        for i, (px, py) in enumerate(zip(self.co_x, self.co_y)):
            # the token choice is not differentiated; the gather is
            if on and plan_x[i] < x.shape[1]:
                with torch.no_grad(), parallel.unit(py):
                    sx = _dtpu_cross_scores(py, y, x)   # X tokens scored by Y
                x, _, _ = P.prune_stream(x, sx, plan_x[i])
            if on and plan_y[i] < y.shape[1]:
                with torch.no_grad(), parallel.unit(px):
                    sy = _dtpu_cross_scores(px, x, y)   # Y tokens scored by X
                y, _, _ = P.prune_stream(y, sy, plan_y[i])
            counts.append((x.shape[1], y.shape[1]))
            x, y = (checkpoint(_co_unit, self, i, cfg, x, y, mode,
                               use_reentrant=False)
                    if remat else _co_unit(self, i, cfg, x, y, mode))
        return x, y, tuple(counts)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], *,
                mode: Optional[ExecutionMode] = None,
                return_token_counts: bool = False):
        """VQA logits (B, 3129) in f32 from ``encode``'s two streams (and
        the per-block kept-token counts with ``return_token_counts``)."""
        logits, counts = self.logits(batch, mode=mode)
        if return_token_counts:
            return logits, counts
        return logits

    def logits(self, batch: Dict[str, torch.Tensor], *,
               mode: Optional[ExecutionMode] = None, remat: bool = False):
        """``forward`` as autograd records it: (logits, kept counts)."""
        x, y, counts = self._encode(batch, mode=mode, remat=remat)
        hx = torch.tanh(torch.matmul(x.mean(dim=1), self.pool_x.to(x.dtype)))
        hy = torch.tanh(torch.matmul(y.mean(dim=1), self.pool_y.to(y.dtype)))
        return torch.matmul(hx * hy, self.vqa_head.to(hx.dtype)).float(), \
            counts


def loss_fn(model: ViLBERT, batch: Dict[str, torch.Tensor], *,
            mode: Optional[ExecutionMode] = None,
            remat: bool = False) -> torch.Tensor:
    """VQA answer cross-entropy (vilbert.py:214): batch {"regions",
    "tokens", "answers" (B,)}."""
    logits, _ = model.logits(batch, mode=mode, remat=remat)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, batch["answers"].long()[:, None]).mean()
