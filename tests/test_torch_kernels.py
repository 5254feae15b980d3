"""The port's kernel plain versions and oracles against the JAX package:
the Pallas kernels in interpret mode (at block-dividing shapes),
``repro.kernels.jnp_blocked`` and ``repro.kernels.ref``, at the reference's
own tolerances (flash 2e-4, stream 5e-4, GEMM 1e-3).  Inputs are made with
numpy from a seed and handed to both packages.  The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import jnp_blocked as JB
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.stream_attention import stream_attention as pallas_stream
from repro.kernels.tile_gemm import tile_gemm as pallas_gemm
from repro_torch.kernels import blocked, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.stream_attention import stream_attention
from repro_torch.kernels.tile_gemm import tile_gemm


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


T = torch.from_numpy

FLASH_CASES = [
    # B, Hq, Hkv, Sq, Sk, hd, causal, window  (tests/test_kernels.py:32)
    (1, 4, 4, 128, 128, 128, False, 0),          # MHA square
    (2, 8, 2, 256, 256, 128, True, 0),           # GQA causal
    (1, 4, 2, 128, 384, 128, True, 0),           # causal, offset KV
    (2, 4, 4, 128, 256, 128, True, 100),         # sliding window
    (1, 2, 1, 256, 256, 128, False, 0),          # MQA
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_jnp_ref(case):
    B, Hq, Hkv, Sq, Sk, hd, causal, window = case
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, B, Hq, Sq, hd), _rand(rng, B, Hkv, Sk, hd),
               _rand(rng, B, Hkv, Sk, hd))
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq if causal else 0)
    got = blocked.flash_attention_plain(T(q), T(k), T(v), block_k=128, **kw)
    pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       block_q=128, block_k=128, interpret=True, **kw)
    _close(got, pal, 2e-4)
    _close(got, JB.flash_attention_jnp(q, k, v, block_k=128, **kw), 2e-4)
    _close(got, jref.ref_attention(q, k, v, **kw), 2e-4)


def test_flash_plain_ragged_kv_len_and_hdv():
    """Ragged Sk with a kv_len mask, and a V width that differs from hd
    (MLA), against the Pallas kernel and the jnp mirror."""
    rng = np.random.default_rng(2)
    B, Hq, Hkv, Sq, Sk, hd, hdv = 2, 4, 2, 128, 256, 128, 64
    q, k, v = (_rand(rng, B, Hq, Sq, hd), _rand(rng, B, Hkv, Sk, hd),
               _rand(rng, B, Hkv, Sk, hdv))
    got = blocked.flash_attention_plain(T(q), T(k), T(v), causal=True,
                                        q_offset=Sk - Sq, kv_len=200,
                                        block_k=64)
    pal = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, q_offset=Sk - Sq, kv_len=200,
                       block_q=128, block_k=128, interpret=True)
    _close(got, pal, 2e-4)
    # kv_len == the jnp mirror over only the first kv_len keys
    want = JB.flash_attention_jnp(q, k[:, :, :200], v[:, :, :200],
                                  causal=True, q_offset=Sk - Sq, block_k=64)
    _close(got, want, 2e-4)


def test_flash_plain_ragged_matches_ref():
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 2, 4, 100, 32), _rand(rng, 2, 2, 200, 32),
               _rand(rng, 2, 2, 200, 32))
    kw = dict(causal=True, window=50, q_offset=100)
    got = blocked.flash_attention_plain(T(q), T(k), T(v), block_k=64, **kw)
    _close(got, jref.ref_attention(q, k, v, **kw), 2e-4)
    _close(got, ref.ref_attention(T(q), T(k), T(v), **kw), 2e-4)


STREAM_CASES = [
    # B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm
    # (tests/test_kernels.py:65)
    (1, 4, 4, 128, 128, 128, 256, False, 0, False, False),   # cross-attn MHA
    (2, 8, 2, 128, 256, 128, 256, True, 0, True, False),     # GQA LM
    (1, 4, 2, 128, 128, 128, 384, True, 0, True, True),      # qwen3-style
    (1, 4, 2, 128, 256, 128, 256, True, 96, True, False),    # SWA
]


def _stream_inputs(rng, B, Hq, Hkv, Sq, Sk, hd, D, rope, knorm):
    q, x = _rand(rng, B, Hq, Sq, hd), _rand(rng, B, Sk, D)
    wk = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    wv = _rand(rng, D, Hkv, hd, scale=D ** -0.5)
    sin = cos = kg = None
    if rope:
        sin, cos = (np.array(t) for t in jref.rope_tables(Sk, hd))
    if knorm:
        kg = _rand(rng, hd, scale=0.1) + 1.0
    return q, x, wk, wv, sin, cos, kg


def _t(a):
    return None if a is None else T(a)


@pytest.mark.parametrize("case", STREAM_CASES)
def test_stream_plain_matches_pallas_jnp_ref(case):
    B, Hq, Hkv, Sq, Sk, hd, D, causal, window, rope, knorm = case
    rng = np.random.default_rng(4)
    q, x, wk, wv, sin, cos, kg = _stream_inputs(rng, B, Hq, Hkv, Sq, Sk, hd,
                                                D, rope, knorm)
    kw = dict(causal=causal, window=window, q_offset=Sk - Sq if causal else 0)
    got = blocked.stream_attention_plain(
        T(q), T(x), T(wk), T(wv), sin=_t(sin), cos=_t(cos), k_gamma=_t(kg),
        block_k=128, **kw)
    jkw = dict(sin=sin, cos=cos, k_gamma=kg, **kw)
    pal = pallas_stream(jnp.asarray(q), jnp.asarray(x), jnp.asarray(wk),
                        jnp.asarray(wv), block_q=128, block_k=128,
                        interpret=True, **jkw)
    _close(got, pal, 5e-4)
    _close(got, JB.stream_attention_jnp(q, x, wk, wv, block_k=128, **jkw),
           5e-4)
    _close(got, jref.ref_stream_attention(q, x, wk, wv, **jkw), 5e-4)


def test_stream_plain_ragged_kv_len():
    """Ragged Sq/Sk (no block divides them) with RoPE + k_gamma, against
    the jnp mirror and the oracle; an explicit kv_len masks the tail."""
    rng = np.random.default_rng(5)
    q, x, wk, wv, sin, cos, kg = _stream_inputs(rng, 2, 4, 2, 100, 200, 32,
                                                96, True, True)
    jkw = dict(sin=sin, cos=cos, k_gamma=kg, causal=True, q_offset=100)
    tkw = dict(sin=T(sin), cos=T(cos), k_gamma=T(kg), causal=True,
               q_offset=100)
    got = blocked.stream_attention_plain(T(q), T(x), T(wk), T(wv),
                                         block_k=64, **tkw)
    _close(got, JB.stream_attention_jnp(q, x, wk, wv, block_k=64, **jkw),
           5e-4)
    _close(got, jref.ref_stream_attention(q, x, wk, wv, **jkw), 5e-4)
    short = blocked.stream_attention_plain(
        T(q), T(x), T(wk), T(wv), block_k=64, kv_len=170,
        **dict(tkw, causal=False, q_offset=0))
    want = jref.ref_stream_attention(q, x[:, :170], wk, wv, sin=sin[:170],
                                     cos=cos[:170], k_gamma=kg)
    _close(short, want, 5e-4)


@pytest.mark.parametrize("shape", [(256, 128, 192), (512, 384, 256),
                                   (128, 256, 128)])
def test_gemm_plain_matches_pallas_and_ref(shape):
    M, K, N = shape
    rng = np.random.default_rng(6)
    x, w = _rand(rng, M, K, scale=1.0), _rand(rng, K, N, scale=1.0)
    got = blocked.tile_gemm_plain(T(x), T(w))
    pal = pallas_gemm(jnp.asarray(x), jnp.asarray(w), block_m=128,
                      block_n=128, block_k=128, interpret=True)
    _close(got, pal, 1e-3)
    _close(got, jref.ref_tile_gemm(x, w), 1e-3)


@pytest.mark.parametrize("shape", [(128, 768, 256), (100, 770, 130)])
def test_gemm_plain_ragged_k_matches_ref(shape):
    """K = 768 (vilbert's language stream) and a fully ragged shape, held
    against ref_tile_gemm only: the Pallas kernel reads unmasked padding at
    K % 512 != 0 (ROADMAP Queue 3)."""
    M, K, N = shape
    rng = np.random.default_rng(7)
    x, w = _rand(rng, M, K, scale=1.0), _rand(rng, K, N, scale=1.0)
    got = blocked.tile_gemm_plain(T(x), T(w))
    _close(got, jref.ref_tile_gemm(x, w), 1e-3)
    _close(ref.ref_tile_gemm(T(x), T(w)), jref.ref_tile_gemm(x, w), 1e-3)


# ---------------- the port's oracles against the JAX oracles ----------------

def test_rope_and_rms_norm_match_jax():
    sin, cos = ref.rope_tables(37, 16, theta=500.0, offset=3)
    jsin, jcos = jref.rope_tables(37, 16, theta=500.0, offset=3)
    _close(sin, jsin, 1e-6)
    _close(cos, jcos, 1e-6)
    rng = np.random.default_rng(8)
    x, g = _rand(rng, 2, 3, 37, 16), _rand(rng, 16) + 1.0
    _close(ref.apply_rope(T(x), sin, cos),
           jref.apply_rope(x, jsin, jcos), 1e-6)
    _close(ref.rms_norm(T(x), T(g)), jref.rms_norm(x, g), 1e-6)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 9)])
def test_ref_attention_and_scores_match_jax(causal, window):
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, 2, 4, 24, 16), _rand(rng, 2, 2, 40, 16),
               _rand(rng, 2, 2, 40, 16))
    kw = dict(causal=causal, window=window, q_offset=16,
              return_scores=True)
    o, s = ref.ref_attention(T(q), T(k), T(v), **kw)
    jo, js = jref.ref_attention(q, k, v, **kw)
    _close(o, jo, 2e-5)
    _close(s, js, 2e-6)


def test_ref_stream_attention_matches_jax():
    rng = np.random.default_rng(10)
    q, x, wk, wv, sin, cos, kg = _stream_inputs(rng, 1, 4, 2, 24, 40, 16,
                                                48, True, True)
    got = ref.ref_stream_attention(T(q), T(x), T(wk), T(wv), sin=T(sin),
                                   cos=T(cos), k_gamma=T(kg), causal=True,
                                   q_offset=16)
    want = jref.ref_stream_attention(q, x, wk, wv, sin=sin, cos=cos,
                                     k_gamma=kg, causal=True, q_offset=16)
    _close(got, want, 2e-5)


# ---------------- the wrappers route by device, never by fallback -------------

def test_wrappers_take_plain_versions_on_cpu_without_counting():
    rng = np.random.default_rng(11)
    q, x, wk, wv, *_ = _stream_inputs(rng, 1, 2, 2, 16, 24, 8, 12, False,
                                      False)
    k, v = _rand(rng, 1, 2, 24, 8), _rand(rng, 1, 2, 24, 8)
    before = (flash_attention.launches, stream_attention.launches,
              tile_gemm.launches)
    _close(flash_attention(T(q), T(k), T(v), block_k=8),
           blocked.flash_attention_plain(T(q), T(k), T(v), block_k=8), 0)
    _close(stream_attention(T(q), T(x), T(wk), T(wv), block_k=8),
           blocked.stream_attention_plain(T(q), T(x), T(wk), T(wv),
                                          block_k=8), 0)
    _close(tile_gemm(T(x[0]), T(wk.reshape(12, 16))),
           blocked.tile_gemm_plain(T(x[0]), T(wk.reshape(12, 16))), 0)
    assert (flash_attention.launches, stream_attention.launches,
            tile_gemm.launches) == before


def test_cpu_calls_leave_the_route_counters_at_zero():
    """CPU tensors take the plain versions at the shapes of every flash
    route (tc, wide, simt), and neither the launch count nor the route
    counters move."""
    rng = np.random.default_rng(12)
    flash_attention.launches = 0
    flash_attention.routes = dict.fromkeys(flash_attention.routes, 0)
    for dt, hd, hdv, Hkv in ((torch.bfloat16, 64, 64, 2),
                             (torch.bfloat16, 576, 512, 1),
                             (torch.float32, 96, 32, 1)):
        q = T(_rand(rng, 1, 4, 16, hd)).to(dt)
        k, v = T(_rand(rng, 1, Hkv, 24, hd)).to(dt), T(_rand(rng, 1, Hkv, 24,
                                                            hdv)).to(dt)
        kw = dict(causal=True, q_offset=8, block_k=8)
        _close(flash_attention(q, k, v, **kw).float(),
               blocked.flash_attention_plain(q, k, v, **kw).float(), 0)
    assert flash_attention.launches == 0
    assert flash_attention.routes == dict.fromkeys(blocked.FLASH_ROUTES, 0)


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device raises: the kernel
    path never falls back to a plain version."""
    x = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tile_gemm(x, x)
    q = torch.empty(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        stream_attention(q, torch.empty(1, 4, 8, device="meta"),
                         torch.empty(8, 1, 8, device="meta"),
                         torch.empty(8, 1, 8, device="meta"))
