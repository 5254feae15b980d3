"""Decoder-only transformer, dense, MoE, VLM, SSM and hybrid families
(counterpart of ``repro/models/transformer.py``): forward, single-pass
prefill that fills the cache, and one-token decode steps.

Layers loop in Python (the JAX package scans stacked parameters).  Every
prefill attention layer dispatches under its planner-resolved mode
(``kernels.ops.attention_by_plan``); a heterogeneous plan splits the
layers into same-mode segments (``_dispatch_segments``).  Decode attention
runs through ``layers.attention_decode``,
``ops.batched_decode_attention_by_plan`` and the ``decode_attention``
kernel.  SSM mixers (``models.ssm``) run the ``ssd_scan`` kernel at
prefill and a plain recurrence at decode; a hybrid layer (hymba) runs
attention and the SSM side by side on the same normed input and mixes
them by ``softmax(mix_beta)``.  The MoE family (grok-1, deepseek-v3)
replaces the MLP by ``layers.moe_forward``; deepseek's first
``first_dense_layers`` layers keep their MLP and live in ``dense_layers``
(the JAX package's separate stack), the rest in ``layers``, and its
``mtp_proj`` is drawn and carried unused, as in JAX.  MLA attention
(``models.mla``) runs its absorbed latent form through the flash kernel
at prefill, whatever the mode, and plain f32 decode; its RoPE tables are
``qk_rope_head_dim`` wide.  A VLM (qwen2-vl) forward given
``batch["positions"]`` (3, B, S) ropes Q and K with M-RoPE tables
(``layers.mrope_tables``) and attends through the flash kernel in every
mode (``layers.attention_forward_mrope``); its prefill and decode take the
dense family's 1-D RoPE path, as the JAX ones do (they never read the
positions).

The cache is the JAX tree with a Python int for the position, ``{"layers":
tree, "len": int}``, every leaf stacked over layers:

* dense: ``{"k": (L, B, Hkv, W, hd), "v": ...}``;
* SSM: ``{"conv": (L, B, K-1, d_inner+2N), "state": (L, B, H, P, N) f32}``;
* hybrid: ``{"attn": {"k", "v"}, "ssm": {"conv", "state"}}``;
* MLA: ``{"c": (L, B, W, kv_lora_rank), "k_rope": (L, B, W, dr)}``.

Layer i of the cache is model layer i: deepseek's dense prefix first.

Sliding-window attention (dense, as h2o-danube3, or hybrid) keeps a ring
of ``W = min(max_len, window)`` slots: absolute position p lives in slot
p % W.  ``decode_step`` updates the cache's buffers in place.  A config's
``use_bias`` is read by no model code, as in the JAX package.

Under an active ``sim.replay`` recording, a planned prefill runs one
dispatch segment per layer, so that each layer's ``KernelTrace`` carries
its own plan op's name (transformer.py:524-536).

Training (every family of this module): ``Transformer.hidden`` is the
forward with autograd, each layer optionally recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX
``_scan_stack``); ``loss_fn`` is next-token cross-entropy through
``chunked_xent`` (transformer.py:177-214).  The SSM scan differentiates
through ``SSDScanFn`` (the ``ssd_scan_bwd`` kernel), MLA's latent
attention through ``FlashAttentionFn`` (the flash backward's wide route),
the MoE layer's gathers and batched products through autograd (a dropped
slot gets no gradient, as in JAX).  The serving entry points keep
``torch.no_grad()``.  Serving on a mesh replicates the model and runs
these entry points on every rank (``shard.serve``, ``serve.Engine``).
Training on a mesh (``train.steps.MeshTrainStep``) gathers the
parameters a unit at a time where the loss asks for them
(``distributed.parallel.unit``: the embedding, each layer, the final norm
with the output matrix), and the layers compute on the rank's 'model'
blocks where the step hands them blocks (``distributed.parallel``).
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import runtime
from repro_torch.core.types import AttnKind, ExecutionMode, Family, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (MLP, Attention, Embedding, MoE,
                                       RMSNorm, apply_rope_bsd,
                                       attention_decode, attention_forward,
                                       attention_forward_mrope, dense_init,
                                       embed_lookup, mlp_forward,
                                       moe_forward, move_to, mrope_tables,
                                       nll_sum, param,
                                       rms_norm, rope_tables_for,
                                       torch_dtype, unembed, unembed_weight)
from repro_torch.models.mla import (MLA, _latent, mla_decode, mla_forward,
                                    mla_init_cache)
from repro_torch.models.ssm import (SSM, ssm_decode, ssm_forward,
                                    ssm_init_cache)

Cache = Dict[str, object]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the JAX transformer the port does not run,
    and for the families that another model module runs.  ``use_bias`` is
    accepted and ignored: no model code of the JAX package reads it."""
    other = {Family.ENCDEC: "models.encdec", Family.CROSSMODAL:
             "models.vilbert"}.get(cfg.family)
    if other:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family runs in {other}, "
            f"not in the decoder Transformer")
    if cfg.family == Family.SSM:
        return
    if cfg.attn_kind == AttnKind.NONE:
        raise NotImplementedError(
            f"{cfg.name}: attention-free layers outside the SSM family are "
            f"not ported: no registry arch has them")


def _window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attn_kind == AttnKind.SLIDING else 0


class Block(nn.Module):
    """One layer (transformer.py:30): ``norm1`` and ``ssm`` (SSM family);
    ``norm1``, ``attn`` (``MLA`` for MLA attention), ``norm2`` and ``mlp``
    (dense), or ``moe`` in place of ``mlp`` (``moe=True``); a hybrid layer
    adds ``ssm`` and the mixing logits ``mix_beta`` (2,) f32, ones."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 moe: bool = False):
        super().__init__()
        dt, dev = torch_dtype(cfg.param_dtype), generator.device
        self.norm1 = RMSNorm(cfg.d_model, dt, dev)
        if cfg.family == Family.SSM:
            self.ssm = SSM(cfg, generator)
            return
        self.attn = (MLA(cfg, generator) if cfg.attn_kind == AttnKind.MLA
                     else Attention(cfg, generator))
        if cfg.family == Family.HYBRID:
            self.ssm = SSM(cfg, generator)
            self.mix_beta = param(torch.ones(2, device=dev))
        self.norm2 = RMSNorm(cfg.d_model, dt, dev)
        if moe:
            self.moe = MoE(cfg, generator)
        else:
            self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, generator)


def _ffn(p: Block, cfg: ModelConfig, h2: torch.Tensor) -> torch.Tensor:
    """The layer's MoE or MLP on the normed residual."""
    if hasattr(p, "moe"):
        return moe_forward(p.moe, cfg, h2)
    return mlp_forward(p.mlp, h2)


def _mix(p: Block, x: torch.Tensor, attn_out: torch.Tensor,
         ssm_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The residual add of the mixers: x + attn, or for a hybrid layer
    x + β0·attn + β1·ssm with β = softmax(mix_beta) in x's dtype
    (transformer.py:72-75)."""
    if ssm_out is None:
        return x + attn_out
    beta = torch.softmax(p.mix_beta, dim=0).to(x.dtype)
    return x + beta[0] * attn_out + beta[1] * ssm_out


def _layer_apply(p: Block, cfg: ModelConfig, x: torch.Tensor, *, sin, cos,
                 mode: Optional[ExecutionMode],
                 mrope_tabs=None) -> torch.Tensor:
    h = rms_norm(p.norm1, x, eps=cfg.norm_eps)
    if cfg.family == Family.SSM:
        return x + ssm_forward(p.ssm, cfg, h)
    if cfg.attn_kind == AttnKind.MLA:
        attn_out = mla_forward(p.attn, cfg, h, sin=sin, cos=cos, causal=True)
    elif mrope_tabs is not None:
        attn_out = attention_forward_mrope(p.attn, cfg, h, sin_b=mrope_tabs[0],
                                           cos_b=mrope_tabs[1], causal=True)
    else:
        attn_out = attention_forward(p.attn, cfg, h, sin=sin, cos=cos,
                                     causal=True, mode=mode)
    x = _mix(p, x, attn_out, ssm_forward(p.ssm, cfg, h)
             if cfg.family == Family.HYBRID else None)
    h2 = rms_norm(p.norm2, x, eps=cfg.norm_eps)
    return x + _ffn(p, cfg, h2)


def _decode_layer(p: Block, cfg: ModelConfig, x: torch.Tensor,
                  cache_l: Cache, pos: int, lp=None) -> torch.Tensor:
    """One layer of a decode step (transformer.py:246); ``cache_l`` is the
    layer's slice of the cache tree, updated in place."""
    h = rms_norm(p.norm1, x, eps=cfg.norm_eps)
    if cfg.family == Family.SSM:
        return x + ssm_decode(p.ssm, cfg, h, cache_l)
    if cfg.attn_kind == AttnKind.MLA:
        x = x + mla_decode(p.attn, cfg, h, {**cache_l, "len": pos})
        return x + _ffn(p, cfg, rms_norm(p.norm2, x, eps=cfg.norm_eps))
    hybrid = cfg.family == Family.HYBRID
    kv = cache_l["attn"] if hybrid else cache_l
    out, _ = attention_decode(p.attn, cfg, h, {**kv, "len": pos}, lp)
    x = _mix(p, x, out, ssm_decode(p.ssm, cfg, h, cache_l["ssm"])
             if hybrid else None)
    h2 = rms_norm(p.norm2, x, eps=cfg.norm_eps)
    return x + _ffn(p, cfg, h2)


def _layer_cache(tree, i: int):
    """Layer ``i``'s slice of a layer-stacked cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer_cache(v, i) for k, v in tree.items()}
    return tree[i]


def _project_kv(p: Attention, cfg: ModelConfig, h: torch.Tensor, sin, cos):
    k = torch.einsum("bsd,dhe->bhse", h, p.wk.to(h.dtype))
    v = torch.einsum("bsd,dhe->bhse", h, p.wv.to(h.dtype))
    if cfg.use_qk_norm:
        k = ref.rms_norm(k, p.k_gamma, eps=cfg.norm_eps)
    if sin is not None:
        k = apply_rope_bsd(k, sin, cos)
    return k, v


def _fill_kv(kv: Cache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, Hkv, S, hd) into a layer's cache buffers
    (B, Hkv, W, hd).  A ring (S > W) keeps the last W keys, rolled so
    that absolute position p lands in slot p % W (transformer.py:413)."""
    S, W = k.shape[2], kv["k"].shape[2]
    if S > W:
        k = torch.roll(k[:, :, -W:], S % W, dims=2)
        v = torch.roll(v[:, :, -W:], S % W, dims=2)
    kv["k"][:, :, :k.shape[2]] = k.to(kv["k"].dtype)
    kv["v"][:, :, :v.shape[2]] = v.to(kv["v"].dtype)


def _prefill_layer(p: Block, cfg: ModelConfig, x: torch.Tensor,
                   cache_l: Cache, *, sin, cos, lp=None) -> torch.Tensor:
    """One layer of single-pass prefill (transformer.py:352): the layer
    output, with the layer's cache (its slice of the tree) filled in
    place.  The attention dispatches under ``lp`` (a ``plan.LayerPlan``)
    through ``ops.attention_by_plan``, else through flash attention
    (LAYER_STREAM semantics); the SSM side leaves its conv history and
    final SSD state in the cache."""
    h = rms_norm(p.norm1, x, eps=cfg.norm_eps)
    if cfg.family == Family.SSM:
        return x + ssm_forward(p.ssm, cfg, h, cache_l)
    if cfg.attn_kind == AttnKind.MLA:
        c, k_rope = _latent(p.attn, cfg, h, sin, cos)
        S = c.shape[1]
        cache_l["c"][:, :S] = c.to(cache_l["c"].dtype)
        cache_l["k_rope"][:, :S] = k_rope[:, 0].to(cache_l["k_rope"].dtype)
        x = x + mla_forward(p.attn, cfg, h, sin=sin, cos=cos, causal=True)
        return x + _ffn(p, cfg, rms_norm(p.norm2, x, eps=cfg.norm_eps))
    a, window = p.attn, _window(cfg)
    q = torch.einsum("bsd,dhe->bhse", h, a.wq.to(h.dtype))
    if cfg.use_qk_norm:
        q = ref.rms_norm(q, a.q_gamma, eps=cfg.norm_eps)
    if sin is not None:
        q = apply_rope_bsd(q, sin, cos)
    k, v = _project_kv(a, cfg, h, sin, cos)
    if lp is not None:
        attn_out = ops.attention_by_plan(
            lp, q, h, a.wk, a.wv, sin=sin, cos=cos,
            k_gamma=getattr(a, "k_gamma", None), causal=True, window=window,
            norm_eps=cfg.norm_eps, kv=(k, v))
    else:
        attn_out = ops.multi_head_attention(q, k, v, causal=True,
                                            window=window)
    attn_out = torch.einsum("bhse,hed->bsd", attn_out, a.wo.to(h.dtype))
    hybrid = cfg.family == Family.HYBRID
    _fill_kv(cache_l["attn"] if hybrid else cache_l, k, v)
    x = _mix(p, x, attn_out, ssm_forward(p.ssm, cfg, h, cache_l["ssm"])
             if hybrid else None)
    h2 = rms_norm(p.norm2, x, eps=cfg.norm_eps)
    return x + _ffn(p, cfg, h2)


def _dispatch_segments(cfg: ModelConfig, plan, lo: int, hi: int,
                       per_layer: bool = False
                       ) -> List[Tuple[int, int, object]]:
    """Maximal runs ``[a, b)`` of layers in ``[lo, hi)`` that share one
    dispatch decision (mode + block tiling), each with a representative
    ``LayerPlan`` (transformer.py:444).  A uniform or absent plan gives
    one segment; a heterogeneous plan splits at mode boundaries, so no
    layer runs under another layer's mode.  ``per_layer`` gives one
    segment per layer, each with its own ``LayerPlan``: under an active
    ``sim.replay`` recording each layer's trace then carries its own op
    name."""
    if plan is None:
        return [(lo, hi, None)]
    reps = []
    for i in range(lo, hi):
        lps = [lp for lp in plan.layers if lp.layer_index == i]
        reps.append(lps[0] if lps else None)
    if per_layer:
        return [(lo + i, lo + i + 1, reps[i]) for i in range(hi - lo)]

    def key(lp):
        return (lp.mode, lp.block_q, lp.block_kv)

    segs = []
    start = 0
    seg_rep = None
    for i in range(hi - lo):
        r = reps[i]
        if r is None:
            continue
        if seg_rep is None:
            seg_rep = r
        elif key(r) != key(seg_rep):
            segs.append((lo + start, lo + i, seg_rep))
            start, seg_rep = i, r
    segs.append((lo + start, hi, seg_rep))
    return segs


class Transformer(nn.Module):
    """Dense, MoE, SSM or hybrid decoder.  Weights are drawn from
    ``generator`` (seed 0 on the model's device by default) with the
    shapes and scales of the JAX init; ``device`` defaults to the card and
    raises without one.  The MoE family's dense prefix is
    ``dense_layers`` and its MoE layers ``layers``; ``blocks`` lists every
    layer in model order."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        device = runtime.resolve_device(device)
        g = generator or torch.Generator(device=device).manual_seed(0)
        dt = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, g,
                               unembed=not cfg.tie_embeddings)
        self.final_norm = RMSNorm(cfg.d_model, dt, g.device)
        moe = cfg.family == Family.MOE
        n_dense = cfg.first_dense_layers if moe else 0
        if n_dense:
            self.dense_layers = nn.ModuleList(Block(cfg, g)
                                              for _ in range(n_dense))
        self.layers = nn.ModuleList(Block(cfg, g, moe=moe)
                                    for _ in range(cfg.num_layers - n_dense))
        if cfg.mtp_depth:
            self.mtp_proj = param(dense_init((2 * cfg.d_model, cfg.d_model),
                                             dt, generator=g))
        move_to(self, device)

    @property
    def blocks(self) -> List[Block]:
        """Every layer in model order (the dense prefix first)."""
        return list(getattr(self, "dense_layers", ())) + list(self.layers)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def _rope(self, seq_len: int, device=None):
        """RoPE tables (``qk_rope_head_dim`` wide for MLA), or (None, None)
        for attention-free models; on ``device`` (the model's by
        default)."""
        cfg = self.cfg
        if not cfg.num_heads or cfg.attn_kind == AttnKind.NONE:
            return None, None
        hd = (cfg.qk_rope_head_dim if cfg.attn_kind == AttnKind.MLA
              else cfg.head_dim)
        return rope_tables_for(cfg, seq_len, head_dim=hd,
                               device=device or self.device)

    def unit_names(self) -> List[str]:
        """The parameters that ``loss_fn`` asks the mesh step for a unit at
        a time where it reads them (``_trunk``, ``head_names``): all of
        them (``mtp_proj``, which it never reads, is never gathered)."""
        return [k for k, _ in self.named_parameters()]

    def head_names(self) -> Tuple[str, ...]:
        """The head unit's parameters: the final norm and the output
        matrix."""
        return ("final_norm.gamma", "embed.embedding"
                if self.cfg.tie_embeddings else "embed.unembed")

    def _trunk(self, batch: Dict[str, torch.Tensor], *,
               mode: Optional[ExecutionMode] = None,
               remat: bool = False) -> torch.Tensor:
        """The embedding and every layer, before the final norm.  Each is a
        unit of the active mesh step (``parallel.unit``): the embedding's
        rows are gathered for the lookup, each layer's parameters for its
        forward and, under ``remat``, again for its recomputation, which
        runs under the forward's ``runtime`` flags."""
        cfg = self.cfg
        mode = mode or cfg.execution_mode
        with parallel.unit(self, ("embed.embedding",)):
            x = embed_lookup(self.embed, batch["tokens"])
        sin = cos = mrope_tabs = None
        if (cfg.family == Family.VLM and cfg.mrope_sections
                and "positions" in batch):
            mrope_tabs = mrope_tables(cfg, batch["positions"])
        else:
            sin, cos = self._rope(x.shape[1], x.device)
        kw = dict(sin=sin, cos=cos, mode=mode, mrope_tabs=mrope_tabs)
        # the recomputation runs under the forward's flags (moe_groups,
        # the hint table), also on autograd's device thread
        flags = runtime.snapshot()
        for p in self.blocks:
            if remat and torch.is_grad_enabled():
                x = checkpoint(runtime.call_with, flags, parallel.run_unit,
                               p, _layer_apply, cfg, x, use_reentrant=False,
                               **kw)
            else:
                x = parallel.run_unit(p, _layer_apply, cfg, x, **kw)
        return x

    def hidden(self, batch: Dict[str, torch.Tensor], *,
               mode: Optional[ExecutionMode] = None,
               remat: bool = False) -> torch.Tensor:
        """``forward`` up to the unembed, recorded by autograd where grad
        mode is on (the training path; transformer.py:151).  ``remat``
        keeps only each layer's input and recomputes the layer in the
        backward (its kernels then launch twice a step).  A VLM batch
        with "positions" (3, B, S) takes M-RoPE tables
        (transformer.py:160-163)."""
        x = self._trunk(batch, mode=mode, remat=remat)
        return rms_norm(self.final_norm, x, eps=self.cfg.norm_eps)

    @torch.no_grad()
    def forward_hidden(self, batch: Dict[str, torch.Tensor], *,
                       mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """``forward`` up to (but excluding) the unembed projection."""
        return self.hidden(batch, mode=mode)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], *,
                mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """batch: {"tokens": (B, S)} and, for a VLM, optionally
        {"positions": (3, B, S)} -> logits (B, S, vocab padded to 128) in
        f32."""
        return unembed(self.embed, self.forward_hidden(batch, mode=mode),
                       self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Zeroed cache for ``batch`` rows of ``max_len`` positions
        (transformer.py:220): the tree of the module docstring.  A
        sliding-window ring holds ``min(max_len, window)`` slots."""
        cfg = self.cfg
        dt, dev, L = torch_dtype(cfg.dtype), self.device, cfg.num_layers
        if cfg.family == Family.SSM:
            return {"layers": ssm_init_cache(cfg, L, batch, dt, dev),
                    "len": 0}
        if cfg.attn_kind == AttnKind.MLA:
            return {"layers": mla_init_cache(cfg, L, batch, max_len, dt, dev),
                    "len": 0}
        W = min(max_len, _window(cfg) or max_len)
        shape = (L, batch, cfg.num_kv_heads, W, cfg.head_dim)
        kv = {"k": torch.zeros(shape, dtype=dt, device=dev),
              "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.family == Family.HYBRID:
            kv = {"attn": kv, "ssm": ssm_init_cache(cfg, L, batch, dt, dev)}
        return {"layers": kv, "len": 0}

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, *,
                    plan=None) -> Tuple[torch.Tensor, Cache]:
        """One serving step: tokens (B, 1) -> (logits (B, 1, V) f32, cache
        advanced by one; its buffers are updated in place).

        ``plan``: the step's ``DecodePlan``; each layer's attention runs
        through ``ops.batched_decode_attention_by_plan`` under its own
        ``DecodeLayerPlan`` (which blocks only the plain version)."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens)
        pos = int(cache["len"])
        lps = {} if plan is None else {lp.layer_index: lp
                                       for lp in plan.layers}
        for i, p in enumerate(self.blocks):
            x = _decode_layer(p, cfg, x, _layer_cache(cache["layers"], i),
                              pos, lps.get(i))
        x = rms_norm(self.final_norm, x, eps=cfg.norm_eps)
        return (unembed(self.embed, x, cfg),
                {"layers": cache["layers"], "len": pos + 1})

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int, *,
                mode: Optional[ExecutionMode] = None,
                plan=None) -> Tuple[torch.Tensor, Cache]:
        """Single-pass prompt processing (transformer.py:485): fills a
        fresh cache of ``max_len`` positions and returns full-prompt
        logits (B, S, V) in f32.

        ``plan``: an ``ExecutionPlan`` for this model; each layer's
        attention dispatches under its own resolved mode and tiling, and a
        heterogeneous plan splits the layers into same-mode segments.
        Attention-free models take None.  ``mode`` is the JAX package's
        legacy knob and is not read (the cache fill does not depend on
        it).  A prompt longer than ``max_len`` is refused where the cache
        holds every position; a sliding-window ring keeps the last W keys
        and an SSM cache has no length."""
        del mode
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if (S > max_len and cfg.family != Family.SSM
                and cfg.attn_kind != AttnKind.SLIDING):
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        cache = self.init_cache(B, max_len)
        x = embed_lookup(self.embed, tokens)
        sin, cos = self._rope(S)
        blocks = self.blocks
        replay = sys.modules.get("repro_torch.sim.replay")
        per_layer = replay is not None and replay.active_recorder() is not None
        for a, b, lp in _dispatch_segments(cfg, plan, 0, cfg.num_layers,
                                           per_layer=per_layer):
            for i in range(a, b):
                x = _prefill_layer(blocks[i], cfg, x,
                                   _layer_cache(cache["layers"], i),
                                   sin=sin, cos=cos, lp=lp)
        x = rms_norm(self.final_norm, x, eps=cfg.norm_eps)
        cache["len"] = S
        return unembed(self.embed, x, cfg), cache


# ---------------------------------------------------------------------------
# Training: the loss (transformer.py:177-214)
# ---------------------------------------------------------------------------

def chunked_xent(model: Transformer, hidden: torch.Tensor,
                 labels: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy with the unembed computed per sequence chunk of
    ``chunk`` positions (the whole sequence when it does not divide).  Each
    chunk's f32 logits are recomputed in the backward, so the (B, S, vocab)
    logits never exist at once, not even as saved residuals.  The output
    matrix is read once and handed to every chunk, so that the chunks'
    recomputations (in the same order on every rank) read the tensor the
    forward read.  Where the active mesh step hands the layers the rank's
    vocabulary columns, every chunk's loss is vocabulary-parallel."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    if S % c:
        c = S
    w = unembed_weight(model.embed, model.cfg)
    tp = parallel.active()
    name = "embedding" if model.cfg.tie_embeddings else "unembed"
    if tp is not None and tp.local(model.embed, name):
        hidden = tp.copy(hidden)
    else:
        tp = None
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, S, c):
        args = (w, hidden[:, i:i + c], labels[:, i:i + c], tp)
        total = total + (checkpoint(nll_sum, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else nll_sum(*args))
    # the count stays a tensor: no host sync, and a fake tensor (the dry
    # run's) has no value to read
    return total / (labels >= 0).sum().clamp(min=1)


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor], *,
            mode: Optional[ExecutionMode] = None,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` ({"tokens", "labels"} (B, S));
    labels == -1 are masked.  The final norm and the loss are the head
    unit of the active mesh step."""
    x = model._trunk(batch, mode=mode, remat=remat)
    with parallel.unit(model, model.head_names()):
        h = rms_norm(model.final_norm, x, eps=model.cfg.norm_eps)
        return chunked_xent(model, h, batch["labels"])
