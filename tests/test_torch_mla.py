"""The port's MLA attention against ``repro.models.mla`` on deepseekv3-smoke
(f32): the JAX parameters carried over by ``convert``, the same numpy
inputs; ``mla_forward`` and ``mla_decode`` (its latent cache too) within
1e-5.  ``ops.mla_latent_attention`` against the JAX function with
``use_pallas=True`` (the Pallas flash kernel in interpret mode, the widths
padded to 128) and False, at the smoke widths and at deepseek-v3's true
576/512 widths with a few heads and Sq = 128, within 2e-4 (the flash
tolerance).  The kernel's tensor-core route rounds like
``blocked.flash_attention_split``: at those widths the mirror holds
chip_smoke's bf16 limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro.models import mla as jMLA
from repro_torch.configs.registry import get_config
from repro_torch.convert import _load
from repro_torch.kernels import blocked, ops
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 MAX_V_HEAD_DIM)
from repro_torch.models import layers as L
from repro_torch.models import mla as M

TOL = 1e-5
FLASH_TOL = 2e-4


@pytest.fixture(scope="module")
def mla():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    jcfg = jregistry.get_config("deepseek-v3-671b", smoke=True)
    params = jMLA.mla_init(jax.random.PRNGKey(5), jcfg)
    mod = M.MLA(cfg, torch.Generator().manual_seed(0))
    _load(mod, jax.tree.map(np.asarray, params), ())
    return cfg, jcfg, params, mod


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_mla_forward_matches_jax(mla):
    cfg, jcfg, params, mod = mla
    S, dr = 19, cfg.qk_rope_head_dim
    x = np.random.default_rng(0).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jsin, jcos = jL.rope_tables_for(jcfg, S, head_dim=dr)
    sin, cos = L.rope_tables_for(cfg, S, head_dim=dr)
    want = jMLA.mla_forward(params, jcfg, jnp.asarray(x), sin=jsin, cos=jcos)
    got = M.mla_forward(mod, cfg, torch.from_numpy(x), sin=sin, cos=cos)
    _close(got, want)
    c, k_rope = M._latent(mod, cfg, torch.from_numpy(x), sin, cos)
    jc, jk = jMLA._latent(params, jcfg, jnp.asarray(x), jsin, jcos)
    _close(c, jc)
    _close(k_rope, jk)


def test_mla_decode_matches_jax(mla):
    """Five decode steps from an empty latent cache: outputs and cache
    within 1e-5; the port writes its cache in place."""
    cfg, jcfg, params, mod = mla
    B, W = 2, 8
    rng = np.random.default_rng(1)
    jcache = jMLA.mla_init_cache(jcfg, B, W, jnp.float32)
    cache = {k: v[0] for k, v in M.mla_init_cache(
        cfg, 1, B, W, torch.float32, "cpu").items()}
    for pos in range(5):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jMLA.mla_decode(params, jcfg, jnp.asarray(x), jcache)
        got = M.mla_decode(mod, cfg, torch.from_numpy(x),
                           {**cache, "len": pos})
        _close(got, want)
        for key in ("c", "k_rope"):
            _close(cache[key], jcache[key])
    assert int(jcache["len"]) == 5


def _latent_inputs(B, H, Sq, Sk, dqk, kvr, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, dqk)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, 1, Sk, dqk)).astype(np.float32) * 0.5
    c = rng.standard_normal((B, 1, Sk, kvr)).astype(np.float32) * 0.5
    return q, k, c


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("B,H,Sq,Sk,dqk,kvr", [
    (2, 4, 24, 24, 48, 32),        # deepseekv3-smoke: 32 + 16, latent 32
    (1, 4, 128, 128, 576, 512),    # deepseek-v3: 512 + 64, latent 512
])
def test_mla_latent_attention_matches_jax(use_pallas, B, H, Sq, Sk, dqk,
                                          kvr):
    q, k, c = _latent_inputs(B, H, Sq, Sk, dqk, kvr)
    want = jops.mla_latent_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(c), causal=True,
                                     use_pallas=use_pallas)
    got = ops.mla_latent_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(c), causal=True)
    assert got.shape == (B, H, Sq, kvr)
    _close(got, want, FLASH_TOL)


def test_wide_route_limits_are_deepseek_widths():
    cfg = get_config("deepseek-v3-671b")
    assert MAX_HEAD_DIM == cfg.kv_lora_rank + cfg.qk_rope_head_dim == 576
    assert MAX_V_HEAD_DIM == cfg.kv_lora_rank == 512


def test_split_operands_hold_the_bf16_limit_at_mla_widths():
    """The wide tensor-core route takes bf16 Q, K, V and P as P_hi + P_lo:
    its mirror stays within chip_smoke's bf16 limit of the f32 plain
    version at 576/512, MQA over 8 heads, causal."""
    q, k, c = (torch.from_numpy(t).bfloat16()
               for t in _latent_inputs(1, 8, 256, 256, 576, 512, seed=3))
    got = blocked.flash_attention_split(q, k, c, causal=True)
    want = blocked.flash_attention_plain(q, k, c, causal=True)
    assert got.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    assert ((g - w).abs() <= 1e-4 + 2 ** -7 * w.abs()).all()


@pytest.mark.parametrize("hd,hdv", [(576, 512), (128, 128)])
def test_flash_backward_at_mla_widths(hd, hdv):
    """The latent attention under autograd equals its no-grad forward, and
    its backward (the wide route's plain version at 576/512) gives the
    plain flash backward's gradients."""
    q, k, c = (torch.from_numpy(t).requires_grad_()
               for t in _latent_inputs(1, 2, 16, 16, hd, hdv))
    out = ops.mla_latent_attention(q, k, c, causal=True)
    with torch.no_grad():
        _close(out, ops.mla_latent_attention(q, k, c, causal=True))
    dout = torch.ones_like(out)
    got = torch.autograd.grad(out, (q, k, c), dout)
    with torch.no_grad():
        _, lse = blocked.flash_attention_plain(q, k, c, causal=True,
                                               return_lse=True)
        want = blocked.flash_attention_bwd_plain(q, k, c, out, lse, dout,
                                                 causal=True)
    for g, w in zip(got, want):
        assert bool(w.any())
        _close(g, w)
