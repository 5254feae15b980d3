"""Multi-head latent attention, DeepSeek-V3 (arXiv:2412.19437); counterpart
of ``repro/models/mla.py``.

MLA compresses K and V into a latent c_kv (kv_lora_rank wide) plus one
shared roped key (qk_rope_head_dim wide).  Prefill absorbs wk_b into the
query, so attention runs in latent space as MQA: one "key" [c ; k_rope]
(kvr + dr wide) and one "value" c (kvr wide) shared by every query head,
through ``ops.mla_latent_attention`` (the flash kernel at those widths on
CUDA tensors; under autograd its backward takes the flash backward's
wide route).  K and V never exist as tensors: the latent is the cache.
Decode keeps the absorbed form in plain PyTorch, in f32, as the JAX
function does (it reaches no kernel there).

Where the active mesh step hands the layers the rank's heads (the rule
table splits ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` on their head dim),
the prefill runs on them: the latent and the query's low-rank projection
are computed whole on every rank, the latent activations (``cq``, ``c``,
``k_rope``) enter the split region by ``copy`` (their gradients, partial
over the rank's heads, are summed there, so that the low-rank weights get
whole gradients on every rank), the latent attention runs at H/m query
heads, and ``wo`` is row-parallel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.core.types import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init, param, rope_at, torch_dtype

NEG_INF = ref.NEG_INF


class MLA(nn.Module):
    """wq_a (d, qr), q_norm (qr,), wq_b (qr, H, dn + dr), wkv_a (d, kvr + dr),
    kv_norm (kvr,), wk_b (kvr, H, dn), wv_b (kvr, H, dv), wo (H, dv, d): the
    JAX names and layouts (mla.py:25), each drawn at fan_in^-0.5."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        dt, g = torch_dtype(cfg.param_dtype), generator

        def w(*shape):
            return param(dense_init(shape, dt, generator=g))

        self.wq_a = w(d, qr)
        self.q_norm = param(torch.ones(qr, dtype=dt, device=g.device))
        self.wq_b = w(qr, H, dn + dr)
        self.wkv_a = w(d, kvr + dr)
        self.kv_norm = param(torch.ones(kvr, dtype=dt, device=g.device))
        self.wk_b = w(kvr, H, dn)
        self.wv_b = w(kvr, H, dv)
        self.wo = w(H, dv, d)


def _project_q(p: MLA, cfg: ModelConfig, x: torch.Tensor, sin, cos,
               enter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B, H, S, dn), q_rope (B, H, S, dr)) (mla.py:44); ``enter``
    (the active step's ``copy``) takes the normed latent query before
    ``wq_b``."""
    dn = cfg.qk_nope_head_dim
    cq = torch.matmul(x, p.wq_a.to(x.dtype))
    cq = ref.rms_norm(cq, p.q_norm, eps=cfg.norm_eps)
    if enter is not None:
        cq = enter(cq)
    q = torch.einsum("bsr,rhe->bhse", cq, p.wq_b.to(x.dtype))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    if sin is not None:
        q_rope = ref.apply_rope(q_rope, sin, cos)
    return q_nope, q_rope


def _latent(p: MLA, cfg: ModelConfig, x: torch.Tensor, sin, cos
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (B, S, kvr) rms-normed, k_rope (B, 1, S, dr) roped)
    (mla.py:57)."""
    kvr = cfg.kv_lora_rank
    ckv = torch.matmul(x, p.wkv_a.to(x.dtype))
    c, k_rope = ckv[..., :kvr], ckv[..., kvr:]
    c = ref.rms_norm(c, p.kv_norm, eps=cfg.norm_eps)
    k_rope = k_rope[:, None]
    if sin is not None:
        k_rope = ref.apply_rope(k_rope, sin, cos)
    return c, k_rope


def mla_forward(p: MLA, cfg: ModelConfig, x: torch.Tensor, *,
                sin=None, cos=None, causal: bool = True) -> torch.Tensor:
    """Prefill/forward on pre-normed x (B, S, D) -> (B, S, D) (mla.py:69).
    The scores q_nope·k_nope + q_rope·k_rope are taken in latent space:
    q_lat = q_nope wk_b^T, so attention is MQA over the key [c ; k_rope]
    and the value c.  q_cat arrives scaled so that attention at the
    default hd^-0.5 of its width kvr + dr gives the model's
    (dn + dr)^-0.5 (a factor of the widths alone: the same at H/m heads).
    There is no mode here: every execution mode runs this path, as in JAX
    (whose ``mode`` argument is not read).  On the rank's heads where the
    active mesh step hands them to the layers (module docstring)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    tp = parallel.active()
    split = tp is not None and tp.local(p, "wq_b")
    q_nope, q_rope = _project_q(p, cfg, x, sin, cos,
                                tp.copy if split else None)
    c, k_rope = _latent(p, cfg, x, sin, cos)
    if split:
        c, k_rope = tp.copy(c), tp.copy(k_rope)
    q_lat = torch.einsum("bhse,rhe->bhsr", q_nope, p.wk_b.to(x.dtype))
    rescale = (dn + dr) ** -0.5 * (kvr + dr) ** 0.5
    q_cat = torch.cat([q_lat, q_rope], dim=-1) * rescale
    k_cat = torch.cat([c, k_rope[:, 0]], dim=-1)[:, None]
    ctx_lat = ops.mla_latent_attention(
        q_cat, k_cat.to(q_cat.dtype), c[:, None].to(q_cat.dtype),
        causal=causal)                                   # (B, H, S, kvr)
    out = torch.einsum("bhsr,rhe->bhse", ctx_lat, p.wv_b.to(x.dtype))
    out = torch.einsum("bhse,hed->bsd", out, p.wo.to(x.dtype))
    return tp.reduce(out) if split else out


def mla_init_cache(cfg: ModelConfig, layers: int, batch: int, max_len: int,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The latent cache stacked over ``layers``: c (L, B, W, kvr) and
    k_rope (L, B, W, dr), kvr + dr values a position (mla.py:109)."""
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {"c": torch.zeros((layers, batch, max_len, kvr), dtype=dtype,
                             device=device),
            "k_rope": torch.zeros((layers, batch, max_len, dr), dtype=dtype,
                                  device=device)}


def mla_decode(p: MLA, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, object]) -> torch.Tensor:
    """Absorbed-form decode step (mla.py:116): x (B, 1, D) pre-normed;
    cache {"c": (B, W, kvr), "k_rope": (B, W, dr), "len": int}.  The new
    position's latent is written at slot ``len`` in place; scores and
    context are taken in latent space in f32 over positions <= len, as in
    JAX."""
    pos = int(cache["len"])
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    sin_t, cos_t = rope_at(pos, dr, cfg.rope_theta, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, sin_t, cos_t)
    c_new, kr_new = _latent(p, cfg, x, sin_t, cos_t)
    c_cache, kr_cache = cache["c"], cache["k_rope"]
    c_cache[:, pos:pos + 1] = c_new.to(c_cache.dtype)
    kr_cache[:, pos:pos + 1] = kr_new[:, 0].to(kr_cache.dtype)
    q_lat = torch.einsum("bhse,rhe->bhsr", q_nope, p.wk_b.to(x.dtype))
    cf = c_cache.float()
    s = (torch.einsum("bhsr,btr->bhst", q_lat.float(), cf)
         + torch.einsum("bhse,bte->bhst", q_rope.float(),
                        kr_cache.float())) * (dn + dr) ** -0.5
    t = torch.arange(c_cache.shape[1], device=x.device)
    s = torch.where(t <= pos, s, torch.full_like(s, NEG_INF))
    ctx_lat = torch.einsum("bhst,btr->bhsr", torch.softmax(s, dim=-1), cf)
    out = torch.einsum("bhsr,rhe->bhse", ctx_lat.to(x.dtype),
                       p.wv_b.to(x.dtype))
    return torch.einsum("bhse,hed->bsd", out, p.wo.to(x.dtype))
