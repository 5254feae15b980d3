"""Mamba-2 (SSD) mixer, the attention-free state-space layer
(arXiv:2405.21060; counterpart of ``repro/models/ssm.py``).  Used alone
(mamba2-780m) and beside attention in hymba's hybrid layers.

Prefill and training run the SSD scan through ``ops.ssd`` (the
``ssd_scan`` kernel on CUDA tensors; under autograd ``SSDScanFn``, whose
backward is the ``ssd_scan_bwd`` kernel); the in/out projections are
``torch.matmul``, as the
reference's ``jnp.dot``; the causal conv, the gated RMSNorm and the
one-token decode recurrence are plain PyTorch.  Where the active mesh
step hands the layer the rank's 'model' block of ``out_proj``
(``distributed.parallel``), ``ssm_forward`` computes the rank's share
of the layer.  ``ssm_forward`` also
serves the reference's ``transformer._ssm_prefill_state``: given a layer
cache it writes the conv state and the final SSD state into it.  The
per-layer cache is ``{"conv": (B, K-1, d_inner+2N), "state": (B, H, P, N)
f32}``; the position counter lives in the model's cache, not here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, param, torch_dtype

Cache = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d, d_inner, heads, head width) of the mixer (ssm.py:22)."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nheads = cfg.ssm_heads or max(d_inner // cfg.ssm_head_dim, 1)
    return d, d_inner, nheads, d_inner // nheads


class SSM(nn.Module):
    """The mixer's parameters with the JAX init's shapes, scales and
    constants (ssm.py:30): ``in_proj`` (d, 2·d_inner + 2N + H) producing
    [x, z, B, C, dt]; ``conv_w`` (K, d_inner + 2N) at scale 0.5;
    ``a_log`` 0, ``dt_bias`` 0 and ``d_skip`` 1 (H,) in f32;
    ``norm_gamma`` (d_inner,) ones; ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        d, d_inner, nheads, _ = ssm_dims(cfg)
        N = cfg.ssm_state
        dt, g = torch_dtype(cfg.param_dtype), generator
        dev = g.device
        self.in_proj = param(dense_init((d, 2 * d_inner + 2 * N + nheads), dt,
                                        generator=g))
        self.conv_w = param(dense_init((cfg.conv_kernel, d_inner + 2 * N), dt,
                                       generator=g, scale=0.5))
        self.a_log = param(torch.zeros(nheads, device=dev))
        self.dt_bias = param(torch.zeros(nheads, device=dev))
        self.d_skip = param(torch.ones(nheads, device=dev))
        self.norm_gamma = param(torch.ones(d_inner, dtype=dt, device=dev))
        self.out_proj = param(dense_init((d_inner, d), dt, generator=g))


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, d_inner: int):
    """[x, z, B, C, dt] of the in-projection's output (ssm.py:48)."""
    N = cfg.ssm_state
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner],
            proj[..., 2 * d_inner:2 * d_inner + N],
            proj[..., 2 * d_inner + N:2 * d_inner + 2 * N],
            proj[..., 2 * d_inner + 2 * N:])


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d (ssm.py:58).  x (B, S, C), w (K, C); state
    (B, K-1, C) is the history before x (zeros if None).  Returns the
    output and the new history, the last K-1 inputs."""
    K, S = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out, (xp[:, -(K - 1):] if K > 1 else pad)


def _conv_and_gates(p: SSM, cfg: ModelConfig, xin: torch.Tensor,
                    conv_state: Optional[torch.Tensor],
                    tp: "parallel.ModelParallel"):
    """in_proj, causal conv and SiLU, softplus(dt) of 'model' rank
    ``tp.rank`` (a rank of one: the whole layer): (x, z, B, C, dt f32, a,
    D, the norm's gains, new conv history).  Where the rank's
    ``out_proj`` rows are whole SSD heads, x, z, dt and the per-channel
    and per-head parameters are its heads', B and C whole; otherwise all
    heads'.  ``in_proj`` is column-parallel where it is the rank's block
    (its fused columns put back together by ``gather_cols``, whose
    backward reduce-scatters), else replicated; x and the replicated
    weights enter by ``copy``: the rank's share gives each a partial
    gradient."""
    _, d_inner, _, P = ssm_dims(cfg)
    N = cfg.ssm_state
    rows = p.out_proj.shape[0]
    x = tp.copy(xin)
    if tp.local(p, "in_proj"):
        proj = tp.gather_cols(torch.matmul(x, p.in_proj.to(x.dtype)))
    else:
        proj = torch.matmul(x, tp.copy(p.in_proj).to(x.dtype))
    xs, z, b, c, dt = _split_proj(cfg, proj, d_inner)
    conv_w, dt_bias, a_log, d_skip, gamma = (
        tp.copy(getattr(p, n)) for n in ("conv_w", "dt_bias", "a_log",
                                         "d_skip", "norm_gamma"))
    if rows < d_inner and rows % P == 0:   # heads h0 ... h0 + nh - 1
        r0, nh = tp.rank * rows, rows // P
        h0 = tp.rank * nh
        xs, z, dt = (xs[..., r0:r0 + rows], z[..., r0:r0 + rows],
                     dt[..., h0:h0 + nh])
        conv_w = torch.cat([conv_w[:, r0:r0 + rows], conv_w[:, d_inner:]],
                           dim=1)
        dt_bias, a_log, d_skip = (t[h0:h0 + nh]
                                  for t in (dt_bias, a_log, d_skip))
        gamma = gamma[r0:r0 + rows]
    w = xs.shape[-1]
    xbc, conv = _causal_conv(torch.cat([xs, b, c], dim=-1),
                             conv_w.to(x.dtype), conv_state)
    xbc = F.silu(xbc)
    dt = F.softplus(dt.float() + dt_bias)
    return (xbc[..., :w], z, xbc[..., w:w + N], xbc[..., w + N:], dt,
            -torch.exp(a_log), d_skip, gamma, conv)


def _out(p: SSM, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
         gamma: torch.Tensor, dtype: torch.dtype,
         tp: "parallel.ModelParallel") -> torch.Tensor:
    """Gated RMSNorm over d_inner (mamba2's norm before the
    out-projection), then ``out_proj`` on 'model' rank ``tp.rank``,
    row-parallel (its product summed by ``reduce``).  y and z are the
    rank's heads' channels (``_conv_and_gates``), whose mean square,
    weighted by their share of d_inner, is summed over 'model'
    (``sum_over``), or all d_inner channels, of which the rank's rows
    feed its rows of ``out_proj``."""
    d_inner = ssm_dims(cfg)[1]
    rows = p.out_proj.shape[0]
    g = y * F.silu(z)
    g32 = g.float()
    ms = (g32 * g32).mean(dim=-1, keepdim=True)
    if g.shape[-1] < d_inner:
        ms = tp.sum_over(ms * (g.shape[-1] / d_inner))
    elif rows < d_inner:
        r0 = tp.rank * rows
        g32, gamma = g32[..., r0:r0 + rows], gamma[r0:r0 + rows]
    g = (g32 * torch.rsqrt(ms + cfg.norm_eps)).to(g.dtype) * gamma.to(g.dtype)
    return tp.reduce(torch.matmul(g, p.out_proj.to(dtype)))


def ssm_forward(p: SSM, cfg: ModelConfig, xin: torch.Tensor,
                cache: Optional[Cache] = None) -> torch.Tensor:
    """xin (B, S, D) pre-normed -> (B, S, D) (ssm.py:73).  With a layer
    ``cache`` (prefill, transformer.py:312), the conv history and the
    final SSD state are written into its buffers in place.  Where the
    active mesh step hands the layer the rank's 'model' block of
    ``out_proj`` (a training step), the rank computes its share
    (``_conv_and_gates``, ``_out``): the conv and ``ops.ssd`` on its
    heads where its rows are whole heads, else the SSD whole and only its
    rows of y into ``out_proj``."""
    tp = parallel.active()
    if cache is not None or tp is None or not tp.local(p, "out_proj"):
        tp = parallel.ModelParallel(0, 1)
    B, S, _ = xin.shape
    P = ssm_dims(cfg)[3]
    x, z, b, c, dt, a, d_skip, gamma, conv = _conv_and_gates(
        p, cfg, xin, None, tp)
    xh = x.reshape(B, S, -1, P)
    y, state = ops.ssd(xh, dt, a, b, c, chunk=cfg.ssm_chunk)
    y = y + xh * d_skip[None, None, :, None].to(xh.dtype)
    if cache is not None:
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
    return _out(p, cfg, y.reshape(B, S, -1), z, gamma, xin.dtype, tp)


def ssm_init_cache(cfg: ModelConfig, num_layers: int, batch: int,
                   dtype: torch.dtype, device) -> Cache:
    """Zeroed conv history (dtype) and SSD state (f32) of ``num_layers``
    layers for ``batch`` rows (ssm.py:101, stacked over layers)."""
    _, d_inner, nheads, headdim = ssm_dims(cfg)
    return {"conv": torch.zeros((num_layers, batch, cfg.conv_kernel - 1,
                                 d_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=device),
            "state": torch.zeros((num_layers, batch, nheads, headdim,
                                  cfg.ssm_state),
                                 dtype=torch.float32, device=device)}


def ssm_decode(p: SSM, cfg: ModelConfig, xin: torch.Tensor,
               cache: Cache) -> torch.Tensor:
    """One-token recurrent step (ssm.py:112): xin (B, 1, D) pre-normed ->
    (B, 1, D).  The conv history and the state are updated in place (the
    JAX function returns new buffers)."""
    _, d_inner, nheads, headdim = ssm_dims(cfg)
    B = xin.shape[0]
    tp = parallel.ModelParallel(0, 1)
    x, z, b, c, dt, a, d_skip, gamma, conv = _conv_and_gates(
        p, cfg, xin, cache["conv"], tp)
    xh = x.reshape(B, nheads, headdim).float()
    decay = torch.exp(dt[:, 0, :, None, None] * a[None, :, None, None])
    state = cache["state"] * decay + torch.einsum(
        "bhp,bn->bhpn", xh * dt[:, 0, :, None], b[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", state, c[:, 0].float())
    y = y + xh * d_skip[None, :, None]
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    return _out(p, cfg, y.reshape(B, 1, d_inner).to(xin.dtype), z, gamma,
                xin.dtype, tp)
