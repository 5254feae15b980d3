"""The port's attention backward (``kernels/flash_vjp.py``: the autograd
Functions over the plain backwards of ``kernels/blocked.py``) against
``jax.grad`` of the JAX package: ``jnp_blocked.flash_attention_jnp`` and
``stream_attention_jnp`` (whose custom VJPs are ``flash_vjp._flash_bwd``
and ``_stream_bwd``) at the reference's tolerances (flash 2e-4, stream
5e-4; tests/test_kernels.py:179, :196), and ``ref.ref_attention`` where a
query row has no live key.  Inputs are made with numpy from a seed.  The
CUDA backward kernels are held against these plain versions on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_vjp as jvjp
from repro.kernels import jnp_blocked as JB
from repro.kernels import ref as jref
from repro_torch.kernels import blocked, ops, ref
from repro_torch.kernels.flash_vjp import (FlashAttentionFn,
                                           StreamAttentionFn,
                                           flash_attention_bwd,
                                           stream_attention_bwd)

T = torch.from_numpy


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _torch_grads(fn, inputs, cot):
    """Gradients of sum(fn(*inputs) * cot) with respect to the inputs."""
    xs = [T(a).requires_grad_() for a in inputs]
    out = fn(*xs)
    return torch.autograd.grad(out, xs, T(cot))


def _jax_grads(fn, inputs, cot):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                    argnums=tuple(range(len(inputs))))(*inputs)


# B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset, block_k
FLASH_CASES = [
    (2, 4, 2, 64, 128, 32, True, 0, 64, 64),      # test_kernels.py:179
    (1, 4, 4, 48, 48, 16, False, 0, 0, 16),       # MHA, square
    (2, 6, 2, 40, 72, 16, True, 0, 32, 32),       # GQA 3, causal, ragged Sk
    (1, 4, 1, 50, 50, 16, True, 12, 0, 16),       # MQA, sliding window
    (2, 4, 2, 33, 90, 8, False, 20, 40, 32),      # window, offset, ragged
    (1, 2, 2, 64, 64, 32, False, 0, 0, 64),       # one kv block
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_jax_grad(case):
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset, bk = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (_rand(rng, B, Hq, Sq, hd), _rand(rng, B, Hkv, Sk, hd),
               _rand(rng, B, Hkv, Sk, hd))
    cot = _rand(rng, B, Hq, Sq, hd, scale=1.0)
    got = _torch_grads(lambda a, b, c: FlashAttentionFn.apply(
        a, b, c, causal, window, q_offset, bk), (q, k, v), cot)
    want = _jax_grads(lambda a, b, c: JB.flash_attention_jnp(
        a, b, c, causal=causal, window=window, q_offset=q_offset,
        block_k=bk), (q, k, v), cot)
    for g, w in zip(got, want):
        _close(g, w, 2e-4)


# B, Hq, Hkv, Sq, Sk, hd, D, causal, window, q_offset, rope, norm, block_k
STREAM_CASES = [
    (2, 4, 2, 64, 128, 32, 96, True, 0, 64, True, True, 64),  # :196
    (1, 4, 4, 48, 48, 16, 40, False, 0, 0, False, False, 16),
    (2, 6, 2, 40, 72, 16, 24, True, 0, 32, True, False, 32),  # ragged Sk
    (1, 4, 1, 50, 50, 16, 32, True, 12, 0, False, True, 16),  # window, MQA
    (2, 2, 2, 30, 70, 8, 20, False, 0, 0, True, True, 32),    # ragged
    (1, 8, 2, 24, 64, 32, 48, True, 0, 40, True, True, 64),   # GQA 4
]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_backward_matches_jax_grad(case):
    B, Hq, Hkv, Sq, Sk, hd, D, causal, window, q_offset, rope, norm, bk = \
        case
    rng = np.random.default_rng(sum(case[:7]))
    q, x = _rand(rng, B, Hq, Sq, hd), _rand(rng, B, Sk, D)
    wk = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    wv = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    g = (rng.standard_normal(hd) * 0.1 + 1.0).astype(np.float32)
    cot = _rand(rng, B, Hq, Sq, hd, scale=1.0)
    sin = cos = None
    if rope:
        sin, cos = (np.array(t) for t in jref.rope_tables(Sk, hd))
    inputs = (q, x, wk, wv) + ((g,) if norm else ())
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def port(a, b, c, d, gam=None):
        return StreamAttentionFn.apply(
            a, b, c, d, gam, None if sin is None else T(sin),
            None if cos is None else T(cos), causal, window, q_offset, 1e-6,
            bk)

    def jax_fn(a, b, c, d, gam=None):
        return JB.stream_attention_jnp(a, b, c, d, sin=sin, cos=cos,
                                       k_gamma=gam, block_k=bk, **kw)

    got = _torch_grads(port, inputs, cot)
    want = _jax_grads(jax_fn, inputs, cot)
    for gt, w in zip(got, want):
        _close(gt, w, 5e-4)


# B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset: some or all query rows
# have no live key (positions past Sk + window - 1, or before key 0)
DEAD_CASES = [
    (1, 2, 1, 40, 30, 16, False, 5, 20),     # rows 15.. of 40 dead
    (2, 4, 2, 16, 24, 8, False, 4, 100),     # every row dead
    (1, 4, 2, 32, 32, 16, True, 0, -8),      # causal, first 8 rows dead
]


@pytest.mark.parametrize("case", DEAD_CASES)
def test_rows_with_no_live_key_match_ref_attention_grad(case):
    """The port's forward gives a row with no live key the mean of V (as
    ``ref_attention``); its backward is the gradient of that forward."""
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, B, Hq, Sq, hd), _rand(rng, B, Hkv, Sk, hd),
               _rand(rng, B, Hkv, Sk, hd))
    cot = _rand(rng, B, Hq, Sq, hd, scale=1.0)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _torch_grads(lambda a, b, c: FlashAttentionFn.apply(
        a, b, c, causal, window, q_offset, 16), (q, k, v), cot)
    want = _jax_grads(lambda a, b, c: jref.ref_attention(a, b, c, **kw),
                      (q, k, v), cot)
    for g, w in zip(got, want):
        _close(g, w, 2e-4)


@pytest.mark.parametrize("case", DEAD_CASES)
def test_stream_rows_with_no_live_key_match_ref_grad(case):
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    D = 24
    rng = np.random.default_rng(8)
    q, x = _rand(rng, B, Hq, Sq, hd), _rand(rng, B, Sk, D)
    wk = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    wv = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    cot = _rand(rng, B, Hq, Sq, hd, scale=1.0)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _torch_grads(lambda a, b, c, d: StreamAttentionFn.apply(
        a, b, c, d, None, None, None, causal, window, q_offset, 1e-6, 16),
        (q, x, wk, wv), cot)
    want = _jax_grads(lambda a, b, c, d: jref.ref_stream_attention(
        a, b, c, d, **kw), (q, x, wk, wv), cot)
    for g, w in zip(got, want):
        _close(g, w, 5e-4)


@pytest.mark.parametrize("case", FLASH_CASES[:3])
def test_forward_lse_matches_flash_vjp_residual(case):
    """The plain forwards' lse against the JAX forward pass's residual
    (flash_vjp._flash_fwd_pass / _stream_fwd_pass)."""
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset, bk = case
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, B, Hq, Sq, hd), _rand(rng, B, Hkv, Sk, hd),
               _rand(rng, B, Hkv, Sk, hd))
    nkb = -(-Sk // bk)
    pad = ((0, 0), (0, 0), (0, nkb * bk - Sk), (0, 0))
    cfg = jvjp._Cfg(causal=causal, window=window, q_offset=q_offset,
                    block_k=bk, unroll=False, kv_len=Sk)
    _, want = jvjp._flash_fwd_pass(q, np.pad(k, pad), np.pad(v, pad), cfg)
    _, lse = blocked.flash_attention_plain(
        T(q), T(k), T(v), causal=causal, window=window, q_offset=q_offset,
        block_k=bk, return_lse=True)
    _close(lse, np.asarray(want).reshape(B, Hq, Sq), 2e-5)
    D = 24
    x = _rand(rng, B, Sk, D)
    wk = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    wv = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    sin, cos = (np.array(t) for t in jref.rope_tables(nkb * bk, hd))
    scfg = cfg._replace(use_rope=True)
    _, want = jvjp._stream_fwd_pass(q, np.pad(x, ((0, 0), (0, nkb * bk - Sk),
                                                  (0, 0))),
                                    wk, wv, np.zeros(hd, np.float32), sin,
                                    cos, scfg)
    _, lse = blocked.stream_attention_plain(
        T(q), T(x), T(wk), T(wv), sin=T(sin[:Sk]), cos=T(cos[:Sk]),
        causal=causal, window=window, q_offset=q_offset, block_k=bk,
        return_lse=True)
    _close(lse, np.asarray(want).reshape(B, Hq, Sq), 2e-5)


@pytest.mark.parametrize("block_k", [16, 64])
def test_backward_wrappers_take_the_plain_versions_on_the_cpu(block_k):
    """On CPU tensors the backward wrappers are their plain versions, at
    any kv blocking."""
    rng = np.random.default_rng(5)
    q, k, v = (T(_rand(rng, 1, 4, 20, 16)), T(_rand(rng, 1, 2, 36, 16)),
               T(_rand(rng, 1, 2, 36, 16)))
    do = T(_rand(rng, 1, 4, 20, 16))
    out, lse = blocked.flash_attention_plain(q, k, v, causal=True,
                                             q_offset=16, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                              q_offset=16, block_k=block_k)
    want = blocked.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=True, q_offset=16)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    x = T(_rand(rng, 1, 36, 12))
    wk, wv = T(_rand(rng, 12, 2, 16)), T(_rand(rng, 12, 2, 16))
    out, lse = blocked.stream_attention_plain(q, x, wk, wv, return_lse=True)
    got = stream_attention_bwd(q, x, wk, wv, out, lse, do, block_k=block_k)
    want = blocked.stream_attention_bwd_plain(q, x, wk, wv, out, lse, do)
    assert got[4] is None and want[4] is None
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("mode", ["non_stream", "layer_stream", "tile_stream"])
def test_ops_dispatch_gradients_agree_across_modes(mode):
    """ops.attention_by_mode under autograd: the three modes' gradients of
    q, x_kv, wk, wv and the qk-norm gain agree with autograd of the
    materialized reference (RoPE + qk-norm, causal GQA)."""
    from repro_torch.core.types import ExecutionMode
    rng = np.random.default_rng(11)
    B, Hq, Hkv, S, hd, D = 2, 4, 2, 24, 16, 20
    arrs = (_rand(rng, B, Hq, S, hd), _rand(rng, B, S, D),
            _rand(rng, D, Hkv, hd, scale=D ** -0.5),
            _rand(rng, D, Hkv, hd, scale=D ** -0.5),
            (rng.standard_normal(hd) * 0.1 + 1).astype(np.float32))
    cot = _rand(rng, B, Hq, S, hd, scale=1.0)
    sin, cos = ref.rope_tables(S, hd)

    def via_ops(q, x, wk, wv, g):
        return ops.attention_by_mode(ExecutionMode(mode), q, x, wk, wv,
                                     sin=sin, cos=cos, k_gamma=g,
                                     causal=True)

    def reference(q, x, wk, wv, g):
        k = ref.apply_rope(ref.rms_norm(
            torch.einsum("bsd,dhe->bhse", x, wk), g), sin, cos)
        v = torch.einsum("bsd,dhe->bhse", x, wv)
        return ref.ref_attention(q, k, v, causal=True)

    for g, w in zip(_torch_grads(via_ops, arrs, cot),
                    _torch_grads(reference, arrs, cot)):
        _close(g, w, 2e-5)


def test_projection_backward_is_the_matmul_gradient():
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 3, 5, 12), _rand(rng, 12, 7)
    cot = _rand(rng, 3, 5, 7, scale=1.0)
    got = _torch_grads(ops.projection, (x, w), cot)
    want = _torch_grads(torch.matmul, (x, w), cot)
    for g, ww in zip(got, want):
        _close(g, ww, 1e-6)


def test_serving_calls_stay_off_the_autograd_functions():
    """Without grad the entry points return plain tensors (no graph), as
    the serving paths need."""
    rng = np.random.default_rng(4)
    q, k, v = (T(_rand(rng, 1, 2, 8, 8)) for _ in range(3))
    with torch.no_grad():
        out = ops.multi_head_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    out = ops.multi_head_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
