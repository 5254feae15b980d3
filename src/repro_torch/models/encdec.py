"""Whisper-style encoder-decoder (arXiv:2212.04356), the audio backbone
(counterpart of ``repro/models/encdec.py``).

The conv frontend is a stub: the input is precomputed frame embeddings
(B, S_enc, D).  The decoder's cross-attention generates K/V from the
encoder output, the textbook StreamDCIM cross-modal case (modal X = text
queries, modal Y = audio memory): in TILE_STREAM ``layers.attention_forward``
reaches the ``stream_attention`` kernel with x_kv = the encoder states.
LayerNorm, GELU MLPs and learned decoder positions, as in whisper.

Entry points, on the card unless the model was built on the CPU:

* ``EncDec.encode`` / ``decode_train`` / ``forward`` (encdec.py:61-115),
  every attention layer under the execution mode; ``loss_fn`` the
  teacher-forced cross-entropy, the training path (``train.loop`` builds
  ``EncDec``; the backward of the stream and flash kernels, and autograd
  through the rest).  In the mesh train step every layer computes on
  the rank's 'model' blocks as ``layers.attention_forward`` and
  ``mlp_forward`` do (heads, or under the ``attn_q`` hint the query rows
  of a sequence the 'model' size divides; d_ff), and the loss on the
  rank's vocabulary;
* ``EncDec.prefill``: the encoder, then the decoder over the prompt, its
  causal self-attention through ``ops.multi_head_attention`` (the flash
  kernel) while the cache fills, its cross-attention under the mode;
* ``EncDec.decode_step``: one token.  Self-attention writes the new K/V at
  ``len`` in place and runs ``ops.batched_decode_attention_by_plan`` (the
  ``decode_attention`` kernel; the JAX step calls the oracle
  ``ref.ref_decode_attention``, the same function) over ``len + 1``
  entries; cross-attention is requested in TILE_STREAM (encdec.py:213)
  and resolved per layer, so each new token's query row streams the
  encoder states through the stream kernel.

The cache is ``{"layers": {"k": (L, B, H, max_len, hd), "v": ...}, "enc":
(B, S_enc, D), "len": int}``: a plain tensor per side, not the paged pool.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode, ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops
from repro_torch.models.layers import (MLP, Attention, Embedding, LayerNorm,
                                       attention_forward, dense_init,
                                       embed_lookup, layer_norm, mlp_forward,
                                       move_to, nll_sum, param, torch_dtype,
                                       unembed, unembed_weight)

Cache = Dict[str, object]
#: Rows of the learned decoder position table, enlarged beyond whisper's
#: 448 (encdec.py:50).
DEC_POSITIONS = 32768


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        dt, dev = torch_dtype(cfg.param_dtype), generator.device
        self.ln1 = LayerNorm(cfg.d_model, dt, dev)
        self.attn = Attention(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model, dt, dev)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, generator)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        dt, dev = torch_dtype(cfg.param_dtype), generator.device
        self.ln1 = LayerNorm(cfg.d_model, dt, dev)
        self.self_attn = Attention(cfg, generator)
        self.ln2 = LayerNorm(cfg.d_model, dt, dev)
        self.cross_attn = Attention(cfg, generator)
        self.ln3 = LayerNorm(cfg.d_model, dt, dev)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, generator)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhe->bhse", x, w.to(x.dtype))


def _cross_mlp(p: DecLayer, cfg: ModelConfig, x: torch.Tensor,
               enc: torch.Tensor, mode: ExecutionMode) -> torch.Tensor:
    """The decoder layer after its self-attention: cross-attention to the
    encoder states under ``mode``, then the MLP."""
    h2 = layer_norm(p.ln2, x, eps=cfg.norm_eps)
    x = x + attention_forward(p.cross_attn, cfg, h2, x_kv=enc, causal=False,
                              mode=mode)
    h3 = layer_norm(p.ln3, x, eps=cfg.norm_eps)
    return x + mlp_forward(p.mlp, h3)


class EncDec(nn.Module):
    """Parameters named as the JAX tree: ``embed`` (tied unembed),
    ``dec_pos`` (32768, d), ``enc_layers``, ``enc_ln``, ``dec_layers``,
    ``dec_ln``.  Weights are drawn from ``generator`` (seed 0 on the
    model's device by default) with the shapes and scales of the JAX init;
    ``device`` defaults to the card and raises without one."""

    def __init__(self, cfg: ModelConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = runtime.resolve_device(device)
        g = generator or torch.Generator(device=device).manual_seed(0)
        dt = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, g,
                               unembed=not cfg.tie_embeddings)
        self.dec_pos = param(dense_init((DEC_POSITIONS, cfg.d_model), dt,
                                        generator=g, scale=0.01))
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, g)
            for _ in range(cfg.num_encoder_layers or cfg.num_layers))
        self.enc_ln = LayerNorm(cfg.d_model, dt, g.device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, g)
                                        for _ in range(cfg.num_layers))
        self.dec_ln = LayerNorm(cfg.d_model, dt, g.device)
        move_to(self, device)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def _mode(self, mode: Optional[ExecutionMode]) -> ExecutionMode:
        return ExecutionMode(mode or self.cfg.execution_mode)

    def _embed(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        x = embed_lookup(self.embed, tokens)
        return x + self.dec_pos[pos:pos + tokens.shape[1]].to(x.dtype)[None]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = layer_norm(self.dec_ln, x, eps=self.cfg.norm_eps)
        return unembed(self.embed, x, self.cfg)

    def _encode(self, frames: torch.Tensor,
                mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        cfg, mode = self.cfg, self._mode(mode)
        x = frames.to(torch_dtype(cfg.dtype))
        for p in self.enc_layers:
            h = layer_norm(p.ln1, x, eps=cfg.norm_eps)
            x = x + attention_forward(p.attn, cfg, h, causal=False,
                                      mode=mode)
            h2 = layer_norm(p.ln2, x, eps=cfg.norm_eps)
            x = x + mlp_forward(p.mlp, h2)
        return layer_norm(self.enc_ln, x, eps=cfg.norm_eps)

    def _decoder(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                 mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """The teacher-forced decoder's layers: hidden states before
        ``dec_ln``."""
        cfg, mode = self.cfg, self._mode(mode)
        x = self._embed(tokens, 0)
        for p in self.dec_layers:
            h = layer_norm(p.ln1, x, eps=cfg.norm_eps)
            x = x + attention_forward(p.self_attn, cfg, h, causal=True,
                                      mode=mode)
            x = _cross_mlp(p, cfg, x, enc_out, mode)
        return x

    def _decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                      mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        return self._head(self._decoder(tokens, enc_out, mode))

    @torch.no_grad()
    def encode(self, frames: torch.Tensor, *,
               mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """frames (B, S_enc, D), the stub frontend's output -> encoder
        states (B, S_enc, D) in the model's dtype."""
        return self._encode(frames, mode)

    @torch.no_grad()
    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                     mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """Teacher-forced decoder: tokens (B, S) -> logits (B, S, V) f32."""
        return self._decode_train(tokens, enc_out, mode)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], *,
                mode: Optional[ExecutionMode] = None) -> torch.Tensor:
        """batch: {"frames": (B, S_enc, D), "tokens": (B, S)} -> logits
        (B, S, vocab padded to 128) in f32."""
        return self._decode_train(batch["tokens"],
                                  self._encode(batch["frames"], mode), mode)

    def init_cache(self, batch: int, max_len: int,
                   enc_out: torch.Tensor) -> Cache:
        """Zeroed self-attention K/V of ``max_len`` positions per layer
        (encdec.py:131), with the encoder states for cross-attention."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        dt, dev = torch_dtype(cfg.dtype), self.device
        return {"layers": {"k": torch.zeros(shape, dtype=dt, device=dev),
                           "v": torch.zeros(shape, dtype=dt, device=dev)},
                "enc": enc_out, "len": 0}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int, *,
                mode: Optional[ExecutionMode] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """The encoder pass and the teacher-forced decoder prompt
        (encdec.py:142): returns (logits (B, S, V) f32, a cache of
        ``max_len`` positions holding the prompt's self-attention K/V and
        the encoder states)."""
        cfg, mode = self.cfg, self._mode(mode)
        tokens = batch["tokens"]
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        enc = self._encode(batch["frames"], mode)
        cache = self.init_cache(B, max_len, enc)
        x = self._embed(tokens, 0)
        for i, p in enumerate(self.dec_layers):
            a = p.self_attn
            h = layer_norm(p.ln1, x, eps=cfg.norm_eps)
            q, k, v = _heads(h, a.wq), _heads(h, a.wk), _heads(h, a.wv)
            attn = ops.multi_head_attention(q, k, v, causal=True)
            x = x + torch.einsum("bhse,hed->bsd", attn, a.wo.to(h.dtype))
            for side, t in (("k", k), ("v", v)):
                buf = cache["layers"][side][i]
                buf[:, :, :S] = t.to(buf.dtype)
            x = _cross_mlp(p, cfg, x, enc, mode)
        cache["len"] = S
        return self._head(x), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, *,
                    plan=None) -> Tuple[torch.Tensor, Cache]:
        """One decoder token (encdec.py:189): tokens (B, 1) -> (logits
        (B, 1, V) f32, the cache advanced by one; its buffers are updated
        in place).  ``plan``: the step's ``DecodePlan``; each layer's
        self-attention runs under its ``dec{i}_self`` entry (which blocks
        only the plain version)."""
        cfg, pos, enc = self.cfg, int(cache["len"]), cache["enc"]
        lps = {} if plan is None else {lp.layer_index: lp
                                       for lp in plan.layers if not lp.cross}
        x = self._embed(tokens, pos)
        for i, p in enumerate(self.dec_layers):
            a = p.self_attn
            h = layer_norm(p.ln1, x, eps=cfg.norm_eps)
            q = _heads(h, a.wq)
            kc, vc = cache["layers"]["k"][i], cache["layers"]["v"][i]
            kc[:, :, pos:pos + 1] = _heads(h, a.wk).to(kc.dtype)
            vc[:, :, pos:pos + 1] = _heads(h, a.wv).to(vc.dtype)
            attn = ops.batched_decode_attention_by_plan(lps.get(i), q, kc, vc,
                                                        pos + 1)
            x = x + torch.einsum("bhse,hed->bsd", attn, a.wo.to(h.dtype))
            x = _cross_mlp(p, cfg, x, enc, ExecutionMode.TILE_STREAM)
        return self._head(x), {"layers": cache["layers"], "enc": enc,
                               "len": pos + 1}


def loss_fn(model: EncDec, batch: Dict[str, torch.Tensor], *,
            mode: Optional[ExecutionMode] = None,
            remat: bool = False) -> torch.Tensor:
    """Teacher-forced next-token cross-entropy (encdec.py:117): batch
    {"frames", "tokens", "labels"}; labels == -1 are masked.  The training
    path (``train.steps``) differentiates it; ``remat`` is accepted and
    not read, as in JAX.  Where the active mesh step hands the layers the
    rank's vocabulary rows of the (tied) output matrix, the loss is
    vocabulary-parallel (``parallel.vocab_nll`` of the rank's logit
    columns): no rank forms the whole (B, S, vocab) logits."""
    del remat
    cfg = model.cfg
    enc = model._encode(batch["frames"], mode)
    h = layer_norm(model.dec_ln, model._decoder(batch["tokens"], enc, mode),
                   eps=cfg.norm_eps)
    labels = batch["labels"]
    tp = parallel.active()
    name = "embedding" if cfg.tie_embeddings else "unembed"
    if tp is not None and tp.local(model.embed, name):
        h = tp.copy(h)
    else:
        tp = None
    nll = nll_sum(unembed_weight(model.embed, cfg), h, labels, tp)
    return nll / (labels >= 0).sum().clamp(min=1)
