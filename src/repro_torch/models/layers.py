"""Shared model primitives (counterpart of ``repro/models/layers.py``).

Parameters live in small ``nn.Module``s whose attribute names are the JAX
parameter tree's keys (``gamma``/``beta``, ``embedding``/``unembed``,
``wq``/``wk``/``wv``/``wo``, ``w_up``/...) and whose shapes are the JAX
layouts, so that ``convert`` maps one tree onto the other by name.  The
forward functions take the module and mirror the JAX functions.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import runtime
from repro_torch.core.types import AttnKind, ExecutionMode, ModelConfig, pad_to
from repro_torch.distributed import parallel
from repro_torch.distributed.hints import constrain
from repro_torch.kernels import ops, ref


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, created without gradient: the serving paths never need
    one, and the train loop switches them on (``requires_grad_(True)``).
    Under ``runtime.flags(param_hook=f)`` the parameter is ``f(t)``: the
    sharded build (``train.loop.build_sharded``) keeps only the rank's
    block of each parameter as it is drawn."""
    hook = runtime.get("param_hook")
    if hook is not None:
        return hook(t)
    return nn.Parameter(t, requires_grad=False)


def move_to(module: nn.Module, device: torch.device) -> None:
    """``module.to(device)``, skipped when every tensor of ``module`` is
    there already or on ``meta``: a model built under ``FakeTensorMode``
    (the dry run's and ``registry.param_specs``') cannot be moved, and
    needs no move; one whose parameters the mesh step holds as blocks
    (``train.loop.build_sharded``) keeps them on ``meta``."""
    tensors = list(module.parameters()) + list(module.buffers())
    if any(t.device != device and t.device.type != "meta" for t in tensors):
        module.to(device)


def dense_init(shape: Sequence[int], dtype: torch.dtype, *,
               generator: torch.Generator, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, scale) with scale = fan_in^-0.5 by default (layers.py:31),
    drawn in f32 on the generator's device and cast to ``dtype``."""
    if runtime.get("abstract_init"):
        # shapes only (registry.param_specs, the dry run under
        # FakeTensorMode): nothing drawn, the generator untouched
        return torch.empty(tuple(shape), dtype=dtype, device=generator.device)
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
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.gamma = param(torch.ones(dim, dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ref.rms_norm(x, p.gamma, eps=eps)


# ---------------------------------------------------------------------------
# Embedding (vocab padded to a multiple of 128, as layers.py:69)
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """The input embedding and, with ``unembed=True`` (untied decoders),
    the output projection (dim, vocab) drawn at fan_in^-0.5.  The
    crossmodal model never unembeds."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype,
                 generator: torch.Generator, unembed: bool = False):
        super().__init__()
        v = pad_to(vocab, 128)
        self.embedding = param(dense_init((v, dim), dtype,
                                          generator=generator, scale=0.02))
        if unembed:
            self.unembed = param(dense_init((dim, v), dtype,
                                            generator=generator))


def embed_lookup(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``; vocabulary-parallel (``parallel.vocab_embed``)
    where the active mesh step hands the layers the rank's rows.  Through
    ``F.embedding``, whose gradient on the CPU sums a row's tokens in one
    order every call (an index's accumulating scatter does not)."""
    tp = parallel.active()
    if tp is not None and tp.local(p, "embedding"):
        return constrain(parallel.vocab_embed(tp, p.embedding, tokens),
                         "embed_out")
    return constrain(F.embedding(tokens, p.embedding), "embed_out")


#: Vocabulary columns per f32 product in ``unembed`` of a narrower dtype,
#: so that the f32 copy of the matrix never exists whole (3.1 GB at
#: qwen3-32b).
UNEMBED_CHUNK = 16384


def unembed_weight(p: Embedding, cfg: ModelConfig) -> torch.Tensor:
    """The (dim, vocab) output matrix: the unembed, or the embedding's
    transpose when they are tied."""
    return p.embedding.t() if cfg.tie_embeddings else p.unembed


def unembed(p: Embedding, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in f32 (layers.py:84-90): x and the matrix in x's dtype, the
    products and sums in f32."""
    return unembed_with(unembed_weight(p, cfg), x)


def unembed_with(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``unembed`` by the (dim, vocab) matrix ``w``: a rank's vocabulary
    columns give that rank's logit columns."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    xf = x.float()
    out = torch.empty(x.shape[:-1] + (w.shape[1],), dtype=torch.float32,
                      device=x.device)
    for c in range(0, w.shape[1], UNEMBED_CHUNK):
        out[..., c:c + UNEMBED_CHUNK] = torch.matmul(
            xf, w[:, c:c + UNEMBED_CHUNK].float())
    return out


def nll_sum(w: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
            tp: Optional["parallel.ModelParallel"]) -> torch.Tensor:
    """Summed next-token negative log-likelihood of hidden states ``h``
    under the output matrix ``w``; labels -1 are masked.  With ``tp``,
    ``w`` holds the rank's vocabulary columns and the loss is
    vocabulary-parallel (``parallel.vocab_nll``): no rank forms the whole
    logits."""
    logits = unembed_with(w, h)
    valid = labels >= 0
    if tp is not None:
        nll = parallel.vocab_nll(tp, logits.float(), labels)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
    return (nll * valid).sum()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables_for(cfg: ModelConfig, seq_len: int, offset: int = 0,
                    head_dim: Optional[int] = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ref.rope_tables(seq_len, head_dim or cfg.head_dim,
                           theta=cfg.rope_theta, offset=offset, device=device)


def mrope_tables(cfg: ModelConfig, positions: torch.Tensor,
                 head_dim: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (3, B, S) t/h/w position streams (text: all equal) ->
    sin/cos (B, S, hd//2) f32 (layers.py:103): section s of the frequency
    bands reads position stream s (M-RoPE, arXiv:2409.12191)."""
    half = (head_dim or cfg.head_dim) // 2
    freqs = 1.0 / (cfg.rope_theta
                   ** (torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half))
    idx = [s for s, n in enumerate(cfg.mrope_sections or (half,))
           for _ in range(n)][:half]
    pos_sel = positions[torch.tensor(idx, device=positions.device)]
    ang = pos_sel.movedim(0, -1).to(torch.float32) * freqs   # (B, S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope_bsd(x: torch.Tensor, sin: torch.Tensor,
                   cos: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, hd); sin/cos: (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if sin.dim() == 2:
        sin_b, cos_b = sin[None, None], cos[None, None]
    else:
        sin_b, cos_b = sin[:, None], cos[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    sin_b, cos_b = sin_b.to(x.dtype), cos_b.to(x.dtype)
    return torch.cat([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b],
                     dim=-1)


def rope_at(pos: int, head_dim: int, theta: float, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos (1, hd//2) for a single position, O(hd), no table."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    ang = freqs * float(pos)        # f32 products, as pos.astype(f32) * freqs
    return torch.sin(ang)[None], torch.cos(ang)[None]


# ---------------------------------------------------------------------------
# Attention mixer (dense GQA)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq (d, Hq, hd), wk/wv (d, Hkv, hd), wo (Hq, hd, d) and, with
    qk-norm, the gains q_gamma/k_gamma (hd,): the JAX layouts."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        dt, g = torch_dtype(cfg.param_dtype), generator
        self.wq = param(dense_init((d, hq, hd), dt, generator=g))
        self.wk = param(dense_init((d, hkv, hd), dt, generator=g))
        self.wv = param(dense_init((d, hkv, hd), dt, generator=g))
        self.wo = param(dense_init((hq, hd, d), dt, generator=g))
        if cfg.use_qk_norm:
            self.q_gamma = param(torch.ones(hd, dtype=dt, device=g.device))
            self.k_gamma = param(torch.ones(hd, dtype=dt, device=g.device))


def _context_rows(tp, cfg: ModelConfig) -> bool:
    """Whether this sublayer runs context-parallel (``parallel.
    context_split`` under the active hint table)."""
    return tp is not None and parallel.context_split(
        cfg, tp.size, runtime.get("sharding_hints"))


def _row_block(tp, S: int) -> Tuple[int, int]:
    """(first row, rows) of the rank's block of query rows of a sequence
    of S: n = ceil(S/m) rows from min(r·n, S − n).  Where m does not
    divide S (whisper's 1500 frames over 16), the last blocks end at S
    and repeat rows of the block before, which ``_gather_row_blocks``
    drops (JAX pads the last block instead)."""
    n = -(-S // tp.size)
    return min(tp.rank * n, S - n), n


def _gather_row_blocks(tp, out: torch.Tensor, S: int) -> torch.Tensor:
    """The whole (B, S, D) from each rank's block of rows
    (``_row_block``): rows r·n … min((r+1)·n, S) − 1 are rank r's."""
    y = tp.gather_rows(out)
    n = out.shape[1]
    if n * tp.size == S:
        return y
    rank_of = [i // n for i in range(S)]
    idx = [r * n + i - min(r * n, S - n) for i, r in enumerate(rank_of)]
    return y.index_select(1, torch.tensor(idx, device=y.device))


def _replicated(tp, p: nn.Module, names: Sequence[str]) -> list:
    """``p``'s parameters ``names`` (None where absent), each entering by
    ``copy``: the rank's work gives each a partial gradient."""
    return [tp.copy(getattr(p, n)) if hasattr(p, n) else None
            for n in names]


def attention_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                      x_kv: Optional[torch.Tensor] = None,
                      sin: Optional[torch.Tensor] = None,
                      cos: Optional[torch.Tensor] = None,
                      causal: bool = True,
                      mode: Optional[ExecutionMode] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Full attention sublayer on pre-normed x (layers.py:165); x_kv
    defaults to x.  The mode goes through the planner's per-layer rule
    (at the config's head counts).  Where the active mesh step hands the
    layers the rank's query heads (``p.wq`` (D, Hq/m, hd),
    ``parallel.attention_split``), the sublayer runs on them: the kernels
    see Hq/m query heads over the kv heads they read
    (``parallel.head_block``; generated from x_kv, whisper's encoder
    states in its cross-attention), and ``wo`` is row-parallel.  Where it
    runs context-parallel (``parallel.context_split``: the ``attn_q``
    hint, heads that do not split), rank r projects Q for its block of
    rows of x (whole after ``copy``; r·S/m … (r+1)·S/m where the 'model'
    size m divides the query sequence S, else ``_row_block``'s) with
    their rope rows, attends against the whole K/V (which the stream
    kernel generates from the whole x_kv) at the block's ``q_offset``
    where the mask reads it (causal or windowed; a non-causal call keeps
    the caller's), applies ``wo`` to its rows and gathers them
    (``_gather_row_blocks``); the weights enter by ``copy``.  In both, a
    separate x_kv enters by ``copy`` too."""
    from repro_torch.plan.heuristics import resolve_layer_mode
    tp = parallel.active()
    split = tp is not None and tp.local(p, "wq")
    rows = tp is not None and not split and _context_rows(tp, cfg)
    wq, wo = p.wq, p.wo
    if split:
        x = tp.copy(x)
        wk, wv, q_gamma, k_gamma = parallel.head_block(tp, p, cfg)
    elif rows:
        x = tp.copy(x)
        wq, wk, wv, wo, q_gamma, k_gamma = _replicated(
            tp, p, ("wq", "wk", "wv", "wo", "q_gamma", "k_gamma"))
    else:
        wk, wv = p.wk, p.wv
        q_gamma = getattr(p, "q_gamma", None)
        k_gamma = getattr(p, "k_gamma", None)
    if x_kv is None:
        x_kv = x
    elif split or rows:
        x_kv = tp.copy(x_kv)
    window = cfg.sliding_window if cfg.attn_kind == AttnKind.SLIDING else 0
    xq, q_pos, S = x, q_offset, x.shape[1]
    if rows:
        r0, n = _row_block(tp, S)
        q_pos += r0
        xq = x[:, r0:r0 + n]
        if causal or window:
            q_offset = q_pos
    mode = resolve_layer_mode(
        ExecutionMode(mode or cfg.execution_mode), d_kv=x_kv.shape[-1],
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        attn_kind=cfg.attn_kind, fuse_kv_generation=cfg.fuse_kv_generation)
    q = torch.einsum("bsd,dhe->bhse", xq, wq.to(x.dtype))
    if cfg.use_qk_norm:
        q = ref.rms_norm(q, q_gamma, eps=cfg.norm_eps)
    if sin is not None:
        q_sin, q_cos = sin, cos
        if q_pos or q.shape[2] != x_kv.shape[1]:
            q_sin = sin[q_pos:q_pos + q.shape[2]]
            q_cos = cos[q_pos:q_pos + q.shape[2]]
        q = apply_rope_bsd(q, q_sin, q_cos)
    q = constrain(q, "attn_q")      # context-parallel hint (hints.py)
    out = ops.attention_by_mode(
        mode, q, x_kv, wk, wv, sin=sin, cos=cos, k_gamma=k_gamma,
        causal=causal, window=window, q_offset=q_offset,
        norm_eps=cfg.norm_eps)
    out = constrain(out, "attn_out")
    out = torch.einsum("bhse,hed->bsd", out, wo.to(x.dtype))
    if split:
        return tp.reduce(out)
    return _gather_row_blocks(tp, out, S) if rows else out


def attention_forward_mrope(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                            *, sin_b: torch.Tensor, cos_b: torch.Tensor,
                            causal: bool = True) -> torch.Tensor:
    """qwen2-vl's attention sublayer on pre-normed x with batch-dependent
    M-RoPE tables (B, S, hd//2) (layers.py:217): Q and K are roped outside
    any kernel and attention runs through ``ops.multi_head_attention``,
    the flash kernel, whatever the execution mode, as in the JAX function
    (which takes a ``mode`` and does not read it).  The stream kernel
    takes only (Sk, hd//2) tables.  On the rank's query heads, or
    context-parallel on its query rows (the tables' rows of Q sliced on
    their sequence dim, ``q_offset`` at the block), as
    ``attention_forward``'s."""
    tp = parallel.active()
    split = tp is not None and tp.local(p, "wq")
    rows = tp is not None and not split and _context_rows(tp, cfg)
    wq, wo, q_offset = p.wq, p.wo, 0
    if split:
        x = tp.copy(x)
        wk, wv, _, _ = parallel.head_block(tp, p, cfg)
    elif rows:
        x = tp.copy(x)
        wq, wk, wv, wo = _replicated(tp, p, ("wq", "wk", "wv", "wo"))
    else:
        wk, wv = p.wk, p.wv
    xq, q_sin, q_cos = x, sin_b, cos_b
    if rows:
        q_offset, n = _row_block(tp, x.shape[1])
        xq = x[:, q_offset:q_offset + n]
        q_sin, q_cos = (t[:, q_offset:q_offset + n] for t in (sin_b, cos_b))
    q = torch.einsum("bsd,dhe->bhse", xq, wq.to(x.dtype))
    k = torch.einsum("bsd,dhe->bhse", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dhe->bhse", x, wv.to(x.dtype))
    q = apply_rope_bsd(q, q_sin, q_cos)
    k = apply_rope_bsd(k, sin_b, cos_b)
    out = ops.multi_head_attention(q, k, v, causal=causal, q_offset=q_offset)
    out = torch.einsum("bhse,hed->bsd", out, wo.to(x.dtype))
    if split:
        return tp.reduce(out)
    return _gather_row_blocks(tp, out, x.shape[1]) if rows else out


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, object], lp=None
                     ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """x: (B, 1, D) pre-normed; cache: {"k": (B, Hkv, W, hd), "v": ...,
    "len": int} (layers.py:247); ``lp``: the layer's ``DecodeLayerPlan``
    or None.

    The new token's K/V (qk-normed, RoPE at its absolute position) are
    written at slot ``len % W`` *in place* (the JAX function returns new
    buffers; updating the cache where it lies saves a copy of it per layer
    and step), then ``ops.batched_decode_attention_by_plan`` runs over the
    ``len + 1`` valid entries, or ``min(len + 1, W)`` for a sliding-window
    ring (RoPE was applied at each key's absolute position, so the ring's
    order does not matter): the ``decode_attention`` kernel on CUDA
    tensors, its plain version on CPU tensors.  The JAX function reaches
    the oracle ``ref_decode_attention`` here instead; the two compute the
    same function.
    """
    pos = int(cache["len"])
    k_cache, v_cache = cache["k"], cache["v"]
    W = k_cache.shape[2]
    q = torch.einsum("bsd,dhe->bhse", x, p.wq.to(x.dtype))
    k_new = torch.einsum("bsd,dhe->bhse", x, p.wk.to(x.dtype))
    v_new = torch.einsum("bsd,dhe->bhse", x, p.wv.to(x.dtype))
    if cfg.use_qk_norm:
        q = ref.rms_norm(q, p.q_gamma, eps=cfg.norm_eps)
        k_new = ref.rms_norm(k_new, p.k_gamma, eps=cfg.norm_eps)
    if cfg.head_dim:
        sin_t, cos_t = rope_at(pos, cfg.head_dim, cfg.rope_theta,
                               device=x.device)
        q = apply_rope_bsd(q, sin_t, cos_t)
        k_new = apply_rope_bsd(k_new, sin_t, cos_t)
    slot = pos % W
    k_cache[:, :, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, :, slot:slot + 1] = v_new.to(v_cache.dtype)
    valid = min(pos + 1, W) if cfg.attn_kind == AttnKind.SLIDING else pos + 1
    out = ops.batched_decode_attention_by_plan(lp, q, k_cache, v_cache,
                                               valid)
    o = torch.einsum("bhse,hed->bsd", out, p.wo.to(x.dtype))
    return o, {"k": k_cache, "v": v_cache, "len": pos + 1}


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
    """The MLP through ``ops.projection``; where the active mesh step hands
    the layers the rank's d_ff block, ``w_gate``/``w_up`` column-parallel
    (x enters by ``copy``) and ``w_down`` row-parallel (its partial
    products summed by ``reduce``)."""
    tp = parallel.active()
    split = tp is not None and tp.local(p, "w_up")
    if split:
        x = tp.copy(x)
    if hasattr(p, "w_gate"):
        g = ops.projection(x, p.w_gate)
        u = ops.projection(x, p.w_up)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(ops.projection(x, p.w_up), approximate="tanh")
    out = ops.projection(h, p.w_down)
    return tp.reduce(out) if split else out


# ---------------------------------------------------------------------------
# MoE FFN: gather-based static-capacity dispatch (layers.py:316-412)
# ---------------------------------------------------------------------------

def _expert_stack(shape: Sequence[int], dtype: torch.dtype,
                  generator: torch.Generator) -> torch.Tensor:
    """An (E, ...) expert stack drawn as ``dense_init`` draws it, with
    fan_in = E (the JAX init reads shape[0]), one expert at a time so that
    no f32 copy of the whole stack exists (15 GB at deepseek-v3's
    (256, 7168, 2048))."""
    out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    if runtime.get("abstract_init"):
        return out
    for e in range(shape[0]):
        out[e] = dense_init(shape[1:], dtype, generator=generator,
                            scale=shape[0] ** -0.5)
    return out


class MoE(nn.Module):
    """router (d, E) at scale 0.02; the experts' w_gate/w_up (E, d, f) and
    w_down (E, f, d); with shared experts, ``shared``, an MLP of width
    f x num_shared_experts (layers.py:316)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
        dt, g = torch_dtype(cfg.param_dtype), generator
        self.router = param(dense_init((d, e), dt, generator=g, scale=0.02))
        self.w_gate = param(_expert_stack((e, d, f), dt, g))
        self.w_up = param(_expert_stack((e, d, f), dt, g))
        self.w_down = param(_expert_stack((e, f, d), dt, g))
        if cfg.num_shared_experts:
            self.shared = MLP(cfg, d, f * cfg.num_shared_experts, g)


def moe_capacity(tokens: int, cfg: ModelConfig,
                 capacity_factor: float) -> int:
    """Slots per expert for a group of ``tokens``: max(int(T·K/E·cf), 4),
    padded to 4 and capped at T."""
    cap = max(int(tokens * cfg.experts_per_token / cfg.num_experts
                  * capacity_factor), 4)
    return min(pad_to(cap, 4), tokens)


def moe_route(p: MoE, cfg: ModelConfig, xt: torch.Tensor, cap: int,
              router: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing of token groups xt (G, Tg, D): the f32 router's softmax, its
    top-k renormalised, and each (token, k) pair's slot ``e·cap + pos``
    (G, Tg, K), where pos counts the earlier pairs of the group that chose
    expert e in (token, k) order; a pair past capacity is dropped and
    gets slot E·cap.  Returns (slot, weights (G, Tg, K) f32, topi).
    ``router`` stands in for ``p.router``."""
    E, K = cfg.num_experts, cfg.experts_per_token
    G, Tg, _ = xt.shape
    router = p.router if router is None else router
    logits = torch.einsum("gtd,de->gte", xt.float(), router.float())
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, K, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = topi.reshape(G, Tg * K)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, flat_e[..., None])[..., 0]
    slot = torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))
    return slot.reshape(G, Tg, K), topw, topi


def moe_forward(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                capacity_factor: Optional[float] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (layers.py:332): top-k routing with a
    static capacity per expert, counted per token group
    (``runtime.flags(moe_groups=G)`` when G divides B·S, else one group;
    ``moe_capacity`` sets the factor, 1.25 by default).  Dispatch gathers
    each expert's slots' tokens (zero rows for unused slots); the experts
    are SiLU gate/up/down whatever ``cfg.act`` is, as batched products
    (the JAX einsums, outside any kernel there too); the combine gathers
    each token's K slot outputs, weighs each by its gate in x's dtype and
    sums them in f32 in k order (deterministic: no scatter-add).  The
    shared expert runs through ``mlp_forward`` (``tile_gemm``).  Under
    autograd the gathers and products differentiate (the router through
    the gate weights); a dropped slot gets no gradient, as in JAX.

    Where the active mesh step hands the layers the rank's experts (their
    (E/m, ...) block: EP) or each expert's d_ff block (expert-TP), every
    rank routes all of its data shard's tokens alike (the same capacity
    and slots; x and the router enter by ``copy``), dispatches and runs
    only its experts' slots (EP) or every slot on its d_ff block, and its
    f32 partial combine is summed over 'model' (``reduce``) before the
    cast to x's dtype."""
    if capacity_factor is None:
        capacity_factor = runtime.get("moe_capacity", 1.25)
    tp = parallel.active()
    split = tp is not None and tp.local(p, "w_up")
    x_in, router = x, p.router
    if split:
        x, router = tp.copy(x), tp.copy(p.router)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    groups = runtime.get("moe_groups", 1)
    if (B * S) % groups:
        groups = 1
    Tg = B * S // groups
    xt = x.reshape(groups, Tg, D)
    cap = moe_capacity(Tg, cfg, capacity_factor)
    slot, topw, _ = moe_route(p, cfg, xt, cap, router)
    flat = slot.reshape(groups, Tg * K)
    # the experts this rank runs: [e0, e0 + El) (all of them but under EP)
    El = p.w_up.shape[0]
    e0 = tp.rank * El if split and El < E else 0
    lo, n_loc = e0 * cap, El * cap
    pairs = torch.arange(Tg * K, device=x.device).expand(groups, -1)
    token_of_slot = torch.zeros((groups, E * cap + 1), dtype=torch.long,
                                device=x.device)
    token_of_slot.scatter_(1, flat, pairs // K)
    used = torch.zeros((groups, E * cap + 1), dtype=x.dtype, device=x.device)
    used.scatter_(1, flat, torch.ones_like(flat, dtype=x.dtype))
    xe = torch.gather(xt, 1, token_of_slot[:, lo:lo + n_loc, None].expand(
        -1, -1, D))
    xe = (xe * used[:, lo:lo + n_loc, None]).reshape(groups, El, cap, D)
    xe = constrain(xe.transpose(0, 1), "moe_dispatch")     # (E, G, C, D)
    xe = xe.reshape(El, groups * cap, D)
    g = torch.bmm(xe, p.w_gate.to(x.dtype))
    u = torch.bmm(xe, p.w_up.to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, p.w_down.to(x.dtype))
    ye = ye.reshape(El, groups, cap, D).transpose(0, 1).reshape(
        groups, n_loc, D)
    ye = torch.cat([ye, ye.new_zeros(groups, 1, D)], dim=1)  # not run here
    local = flat - lo
    local = torch.where((local >= 0) & (local < n_loc), local,
                        torch.full_like(local, n_loc))
    parts = torch.gather(ye, 1, local[..., None].expand(-1, -1, D))
    parts = (parts.reshape(groups, Tg, K, D)
             * topw.to(x.dtype)[..., None]).float()
    y = parts[:, :, 0]
    for k in range(1, K):
        y = y + parts[:, :, k]
    if split:
        y = tp.reduce(y)
    out = y.to(x.dtype).reshape(B, S, D)
    if hasattr(p, "shared"):
        out = out + mlp_forward(p.shared, x_in)
    return out
