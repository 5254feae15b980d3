"""The port's decode attention against the JAX package on the CPU: the plain
version (``blocked.decode_attention_plain``, which the kernel wrapper takes
for CPU tensors) against the oracle ``ref_decode_attention`` and the Pallas
kernel in interpret mode, at the JAX tolerance 1e-5 (f32), and the ops
entry points against theirs.  The CUDA kernel itself is checked against
the plain version on the card by ``chip_smoke.py`` (phase 3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.ref import ref_decode_attention as jref
from repro.plan import plan_decode_step as jplan_decode_step
from repro_torch.configs.registry import get_config
from repro_torch.core import runtime
from repro_torch.kernels import blocked, ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.plan import DEFAULT_BLOCK, plan_decode_step

T = torch.from_numpy
TOL = 1e-5     # tests/test_decode_attention.py


def _inputs(B, Hq, Hkv, W, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Hq, 1, hd), (B, Hkv, W, hd), (B, Hkv, W, hd)))


# B, Hq, Hkv, W, hd, cache_len (tuple: per row; int: scalar), window.
# Rows hold at least one valid key: for cache_len 0 the reference averages
# V over masked keys, the port gives 0 (test_empty_row_gives_zero).
CASES = [
    (3, 8, 2, 50, 32, (17, 50, 5), 0),     # GQA, ragged, W % block != 0
    (2, 4, 4, 37, 24, (1, 37), 0),         # MHA, hd = 24
    (3, 8, 2, 50, 32, 23, 0),              # scalar cache_len
    (3, 4, 2, 48, 16, (17, 48, 5), 4),     # window, edges around the lens
    (2, 8, 1, 70, 32, (70, 33), 17),       # MQA, window
]


def _clen(clen, B):
    return (np.asarray(clen, np.int32) if isinstance(clen, tuple)
            else np.int32(clen))


@pytest.mark.parametrize("B,Hq,Hkv,W,hd,clen,window", CASES)
@pytest.mark.parametrize("block_k", [16, 512])
def test_plain_matches_jax_oracle(B, Hq, Hkv, W, hd, clen, window, block_k):
    q, k, v = _inputs(B, Hq, Hkv, W, hd)
    c = _clen(clen, B)
    got = blocked.decode_attention_plain(T(q), T(k), T(v), torch.as_tensor(c),
                                         window=window, block_k=block_k)
    want = jref(q, k, v, c, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # the port's own oracle is the JAX one
    np.testing.assert_allclose(
        ref.ref_decode_attention(T(q), T(k), T(v), torch.as_tensor(c),
                                 window=window).numpy(),
        np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("B,Hq,Hkv,W,hd,clen,window", CASES[:4])
def test_plain_matches_pallas_interpret(B, Hq, Hkv, W, hd, clen, window):
    q, k, v = _inputs(B, Hq, Hkv, W, hd, seed=1)
    c = _clen(clen, B)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(c), window=window, block_k=16, interpret=True)
    got = decode_attention(T(q), T(k), T(v), torch.as_tensor(c),
                           window=window, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = _inputs(2, 8, 2, 40, 32)
    lens = torch.tensor([40, 9], dtype=torch.int32)
    got = decode_attention(T(q), T(k), T(v), lens, block_k=16)
    assert torch.equal(got, blocked.decode_attention_plain(
        T(q), T(k), T(v), lens, block_k=16))
    assert decode_attention.launches == 0      # no kernel on the CPU


def test_empty_row_gives_zero():
    """Masked keys carry no weight: a row with cache_len 0 is 0 (the CUDA
    kernel skips every tile of it); its neighbours are unaffected."""
    q, k, v = _inputs(3, 4, 2, 20, 16)
    lens = torch.tensor([0, 20, 7])
    got = blocked.decode_attention_plain(T(q), T(k), T(v), lens, block_k=8)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = jref(q[1:], k[1:], v[1:], np.asarray([20, 7], np.int32))
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_plain_rows_are_batch_independent():
    q, k, v = _inputs(3, 8, 2, 50, 32, seed=2)
    lens = torch.tensor([17, 50, 5])
    batched = blocked.decode_attention_plain(T(q), T(k), T(v), lens,
                                             block_k=16)
    for i in range(3):
        solo = blocked.decode_attention_plain(
            T(q[i:i + 1]), T(k[i:i + 1]), T(v[i:i + 1]), lens[i], block_k=16)
        np.testing.assert_allclose(batched[i:i + 1].numpy(), solo.numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_by_plan_entry_point_matches_jax():
    """``batched_decode_attention_by_plan`` against the JAX one on a ragged
    bucket planned for starcoder2-smoke, and each of its rows, called as a
    bucket of one, against the JAX per-slot ``decode_attention_by_plan``
    (flash attention over the slot's valid K/V)."""
    lens = (17, 48, 5)
    cfg = get_config("starcoder2-7b", smoke=True)
    jcfg = jregistry.get_config("starcoder2-7b", smoke=True)
    lp = plan_decode_step(cfg, lens).layers[0]
    jlp = jplan_decode_step(jcfg, lens).layers[0]
    q, k, v = _inputs(3, lp.heads, lp.kv_heads, max(lens), lp.head_dim)
    c = np.asarray(lens, np.int32)
    got = ops.batched_decode_attention_by_plan(lp, T(q), T(k), T(v),
                                               torch.as_tensor(c))
    want = jops.batched_decode_attention_by_plan(jlp, q, k, v,
                                                 jnp.asarray(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for i, n in enumerate(lens):
        solo = ops.batched_decode_attention_by_plan(
            lp, T(q[i:i + 1]), T(k[i:i + 1]), T(v[i:i + 1]), n)
        assert torch.equal(got[i:i + 1], solo)
        jsolo = jops.decode_attention_by_plan(
            jlp, q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n])
        np.testing.assert_allclose(solo.numpy(), np.asarray(jsolo),
                                   atol=TOL, rtol=TOL)


def test_by_plan_blocks_the_plain_version_as_the_plan_says():
    """The plan's ``block_kv`` reaches the plain version; without a plan
    it is ``DEFAULT_BLOCK``, and ``runtime.flags(block_k=)`` wins."""
    lens = torch.tensor([37, 9])
    q, k, v = (T(a) for a in _inputs(2, 8, 2, 40, 32, seed=3))
    lp = plan_decode_step(get_config("qwen3-32b", smoke=True), (37, 9),
                          block_kv=8).layers[0]
    assert lp.block_kv == 8

    def plain(block_k):
        return blocked.decode_attention_plain(q, k, v, lens, block_k=block_k)

    assert torch.equal(ops.batched_decode_attention_by_plan(lp, q, k, v,
                                                            lens), plain(8))
    assert torch.equal(ops.batched_decode_attention_by_plan(None, q, k, v,
                                                            lens),
                       plain(DEFAULT_BLOCK))
    with runtime.flags(block_k=16):
        assert torch.equal(ops.batched_decode_attention_by_plan(
            lp, q, k, v, lens), plain(16))


def test_cuda_only_checks_raise_before_any_launch():
    """Shapes the kernel does not take are refused on the host (these
    checks run only for CUDA tensors; here they are reached through a
    tensor on the 'meta' device, which is not the CPU)."""
    q = torch.empty((2, 4, 2, 32), device="meta")
    k = torch.empty((2, 2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention(q, k, k, 16)


# ---- the bf16 kernel's split-then-merge sum

def split_mirror(q, k, v, cache_len, *, window=0, scale=None, split_p=False):
    """``decode_attention_plain`` summed as the bf16 kernel sums it: W is
    cut into ``decode_splits(W, Hkv)`` splits of whole 64-key tiles; each
    split runs the online softmax over its tiles into (m, l, acc), and the
    splits are merged online in split order, as the kernel merges them:
    m' = max(m, m_s), l = l e^(m - m') + l_s e^(m_s - m'), acc likewise,
    out = acc / l.  A split, or a tile, that holds no valid key adds
    nothing (the kernel skips it).  ``split_p``: P enters P V as P_hi +
    P_lo, the kernel's operands (else f32 products); the scores are
    (q K^T) * scale.  A row with no valid key gives 0."""
    B, Hq, _, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5 if scale is None else scale
    nsplit, per = blocked.decode_splits(W, Hkv)
    bk = blocked.DECODE_BK
    k, _ = blocked._pad_axis(k, 2, bk)
    v, _ = blocked._pad_axis(v, 2, bk)
    ntiles = k.shape[2] // bk
    clen = torch.as_tensor(cache_len).reshape(-1).expand(B)
    hi = clen.clamp(max=W)
    lo = (clen - window).clamp(min=0) if window > 0 else torch.zeros_like(clen)
    if split_p:
        qk, pv = blocked._split_products("split", False, scale)
    else:
        def qk(qf, k_j):
            return blocked._qk(qf, k_j) * scale
        pv = blocked._pv
    qf = q.float().reshape(B, Hkv, G, 1, hd)
    shape = (B, Hkv, G, 1)
    neg = blocked.NEG_INF
    m_all, l_all = torch.full(shape, neg), torch.zeros(shape)
    acc_all = torch.zeros(shape + (hd,))
    for s in range(nsplit):
        m, l, acc = torch.full(shape, neg), torch.zeros(shape), \
            torch.zeros(shape + (hd,))
        for j in range(s * per, min((s + 1) * per, ntiles)):
            kpos = j * bk + torch.arange(bk)
            ok = ((kpos[None, :] >= lo[:, None]) & (kpos[None, :] < hi[:, None])
                  )[:, None, None, None, :]                  # (B, 1, 1, 1, bk)
            sc = qk(qf, k[:, :, j * bk:(j + 1) * bk].float())
            sc = torch.where(ok, sc, torch.full_like(sc, neg))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.where(ok, torch.exp(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + pv(p, v[:, :, j * bk:(j + 1) * bk]
                                              .float())
            m = m_new
        m_new = torch.maximum(m_all, m)
        a, w = torch.exp(m_all - m_new), torch.exp(m - m_new)
        l_all = l_all * a + l * w
        acc_all = acc_all * a[..., None] + acc * w[..., None]
        m_all = m_new
    l_safe = torch.where(l_all == 0.0, torch.ones_like(l_all), l_all)
    return (acc_all / l_safe[..., None]).reshape(B, Hq, 1, hd).to(q.dtype)


# CASES, then: hymba-1.5b's ring at its decode shape (Hq 25, Hkv 5, hd 64,
# W 1024; a full ring and a partial one), a window over several splits,
# W not a multiple of the 64-key tile, and W split in 32 tiles of one.
SPLIT_CASES = CASES + [
    (2, 25, 5, 1024, 64, (1024, 700), 0),
    (3, 8, 2, 500, 128, (500, 99, 300), 100),
    (2, 8, 2, 200, 32, (200, 130), 0),
    (1, 16, 2, 2048, 32, (1537,), 0),
]


@pytest.mark.parametrize("W,Hkv", [(50, 2), (200, 2), (1024, 5), (2048, 8),
                                   (2048, 1), (4096, 8), (130, 64), (64, 8)])
def test_split_rule(W, Hkv):
    """Whole 64-key tiles, none empty, every tile in one split; Hkv x
    splits reaches at least half the block target when the tiles allow it
    (a split holds whole tiles).  The rule takes no B: it cannot depend on
    it."""
    splits, per = blocked.decode_splits(W, Hkv)
    tiles = -(-W // blocked.DECODE_BK)
    assert (splits - 1) * per < tiles <= splits * per
    assert 2 * Hkv * splits >= min(Hkv * tiles, blocked.DECODE_SPLIT_BLOCKS)


def test_split_rule_at_the_main_shapes():
    assert blocked.decode_splits(2048, 8) == (16, 2)     # qwen3-32b
    assert blocked.decode_splits(1024, 5) == (16, 1)     # hymba-1.5b ring


@pytest.mark.parametrize("B,Hq,Hkv,W,hd,clen,window", SPLIT_CASES)
def test_split_mirror_matches_jax_oracle(B, Hq, Hkv, W, hd, clen, window):
    q, k, v = _inputs(B, Hq, Hkv, W, hd, seed=4)
    c = _clen(clen, B)
    got = split_mirror(T(q), T(k), T(v), torch.as_tensor(c), window=window)
    want = jref(q, k, v, c, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,Hq,Hkv,W,hd,clen,window",
                         SPLIT_CASES[:1] + SPLIT_CASES[3:4]
                         + SPLIT_CASES[5:8])
def test_split_mirror_matches_pallas_interpret(B, Hq, Hkv, W, hd, clen,
                                               window):
    q, k, v = _inputs(B, Hq, Hkv, W, hd, seed=5)
    c = _clen(clen, B)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(c), window=window, block_k=64, interpret=True)
    got = split_mirror(T(q), T(k), T(v), torch.as_tensor(c), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_split_mirror_empty_row_gives_zero():
    q, k, v = _inputs(3, 4, 2, 300, 16, seed=6)
    lens = torch.tensor([0, 300, 70])
    got = split_mirror(T(q), T(k), T(v), lens)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = jref(q[1:], k[1:], v[1:], np.asarray([300, 70], np.int32))
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("split_p", [False, True], ids=["None", "split"])
@pytest.mark.parametrize("B,Hq,Hkv,W,hd,clen,window", SPLIT_CASES[5:])
def test_split_mirror_rows_are_batch_independent(B, Hq, Hkv, W, hd, clen,
                                                 window, split_p):
    """Row i of a batched call equals the B = 1 call on row i, bitwise."""
    q, k, v = (T(a) for a in _inputs(B, Hq, Hkv, W, hd, seed=7))
    lens = torch.as_tensor(_clen(clen, B)).reshape(-1).expand(B)
    got = split_mirror(q, k, v, lens, window=window, split_p=split_p)
    for i in range(B):
        solo = split_mirror(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i], window=window,
            split_p=split_p)
        assert torch.equal(got[i:i + 1], solo)


def test_split_mirror_bf16_operands_hold_one_ulp():
    """With bf16 inputs, P entering P V as P_hi + P_lo (the kernel's
    operands) stays within one output ulp of the plain version; P in bf16
    alone would not be held to it."""
    q, k, v = (T(a).bfloat16() for a in _inputs(2, 25, 5, 1024, 64, seed=8))
    lens = torch.tensor([1024, 700])
    want = blocked.decode_attention_plain(q, k, v, lens).float()
    got = split_mirror(q, k, v, lens, split_p=True).float()
    assert ((got - want).abs() <= 1e-4 + 2 ** -7 * want.abs()).all()
