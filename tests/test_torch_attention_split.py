"""The tensor-core attention kernels' numerical design, on the CPU.

The bf16 kernels (csrc/attention_tc.cuh) multiply bf16 operands on the
tensor cores.  An f32 operand (the softmax's P; the stream kernel's
generated K and V) goes in as two bf16 values hi + lo.  These tests hold
the plain mirror of that rounding (``blocked.flash_attention_split``,
``blocked.stream_attention_split``) to chip_smoke.py's bf16 limit against
the f32 plain versions at a main-path shape, show that rounding those
operands to bf16 alone would not hold it, and check the kernels' live-tile
rule (``blocked.live_kv_tiles``) against the full loop, with the rows that
have no live key at all.  The same holds for the backward kernels'
tensor-core route (csrc/attention_bwd_tc.cuh): its mirrors
``blocked.flash_attention_bwd_split`` and ``stream_attention_bwd_split``
(P, dS, and in the stream kernel the generated K and V and dK, dV in the
dx and dW products, as hi + lo) hold the bf16 limit where bf16 operands
alone do not; its route rules, its dW slots and their fixed-order sum are
checked too.  The tests marked ``cuda`` read the stream kernels' cluster
policy from their CUDA libraries and skip without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import blocked, ref

# chip_smoke.py's bf16 limit: |got - want| <= 1e-4 + 2**-7 |want|
BF16_TOL = (1e-4, 2 ** -7)


def worst(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error over its bf16 limit (> 1 fails chip_smoke's check)."""
    atol, rtol = BF16_TOL
    g, w = got.float(), want.float()
    return ((g - w).abs() / (atol + rtol * w.abs())).max().item()


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    ).bfloat16()


def _flash_inputs(S=2048, hd=128):
    rng = np.random.default_rng(0)
    return [_bf16(rng, 1, 1, S, hd) for _ in range(3)]


def _stream_inputs(S=2048, hd=128, D=512):
    rng = np.random.default_rng(1)
    return (_bf16(rng, 1, 1, S, hd), _bf16(rng, 1, S, D),
            _bf16(rng, D, 1, hd, scale=D ** -0.5),
            _bf16(rng, D, 1, hd, scale=D ** -0.5))


def _run(kernel, rounding):
    if kernel == "flash":
        q, k, v = _flash_inputs()
        return (blocked.flash_attention_split(q, k, v, rounding=rounding),
                blocked.flash_attention_plain(q, k, v))
    q, x, wk, wv = _stream_inputs()
    return (blocked.stream_attention_split(q, x, wk, wv, rounding=rounding),
            blocked.stream_attention_plain(q, x, wk, wv))


@pytest.mark.parametrize("kernel", ["flash", "stream"])
def test_split_operands_hold_the_bf16_limit(kernel):
    """hi + lo operands keep the bf16 output within one ulp of the f32
    plain version at hd 128, S = 2048, unit-scale inputs."""
    got, want = _run(kernel, "split")
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert worst(got, want) <= 1.0


@pytest.mark.parametrize("kernel", ["flash", "stream"])
def test_bf16_operands_alone_break_the_limit(kernel):
    """Why the split exists: P (flash), or K, V and P (stream), rounded to
    bf16 as a plain bf16 product would take them, miss the limit."""
    got, want = _run(kernel, "bf16")
    assert worst(got, want) > 1.0


def test_split_bf16_keeps_sixteen_bits():
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = blocked.split_bf16(t)
    assert torch.equal(hi, hi.bfloat16().float())
    assert torch.equal(lo, lo.bfloat16().float())
    assert ((hi + lo - t).abs() <= 2.0 ** -16 * t.abs()).all()
    assert ((hi - t).abs() > 2.0 ** -16 * t.abs()).any()


def test_live_kv_tiles_ranges():
    kw = dict(sk=1024, kv_len=1024, bk=64)
    assert blocked.live_kv_tiles(0, 128, 1024, causal=True, **kw) == (0, 2)
    assert blocked.live_kv_tiles(896, 1024, 1024, causal=True, **kw) == (0, 16)
    # window 256: rows 512..639 see keys 257..639
    assert blocked.live_kv_tiles(512, 640, 1024, causal=True, window=256,
                                 **kw) == (4, 10)
    # a span across two heads' rows holds queries 0 and Sq - 1
    assert blocked.live_kv_tiles(1000, 1100, 1024, causal=True, **kw) == (0, 16)
    # kv_len and q_offset
    assert blocked.live_kv_tiles(0, 100, 100, sk=200, kv_len=170,
                                 causal=True, q_offset=100, bk=64) == (0, 3)
    assert blocked.live_kv_tiles(5, 5, 64, sk=64, kv_len=64, bk=64) == (0, 0)
    # a row with no live key (kv_len 0; past kv_len + window - 1) makes its
    # span walk every tile of the sk keys
    assert blocked.live_kv_tiles(0, 64, 64, sk=64, kv_len=0, bk=64) == (0, 1)
    assert blocked.live_kv_tiles(0, 128, 300, sk=300, kv_len=100,
                                 window=32, bk=64) == (0, 2)
    assert blocked.live_kv_tiles(128, 256, 300, sk=300, kv_len=100,
                                 window=32, bk=64) == (0, 5)


# B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len: chip_smoke's
# FLASH_CASES with a mask or ragged GQA rows, then causal GQA prefill and a
# windowed one at smaller sizes.
LIVE_CASES = [
    (2, 8, 2, 256, 256, 128, 128, True, 0, None),
    (1, 4, 2, 128, 384, 128, 128, True, 0, None),
    (2, 4, 4, 128, 256, 128, 128, True, 100, None),
    (2, 4, 2, 100, 200, 64, 64, True, 50, 170),
    (1, 4, 1, 77, 150, 96, 32, False, 0, None),
    (2, 4, 2, 96, 200, 32, 32, True, 64, 190),
    (1, 8, 2, 300, 300, 64, 64, True, 0, None),
    (1, 5, 1, 600, 600, 64, 64, True, 128, None),
    (1, 3, 1, 200, 200, 32, 32, False, 96, None),
    # rows with no live key: past kv_len + window - 1, or kv_len 0
    (1, 2, 1, 300, 300, 64, 64, False, 32, 100),
    (2, 4, 2, 200, 260, 64, 32, True, 16, 40),
    (1, 2, 2, 64, 150, 32, 32, False, 0, 0),
]


@pytest.mark.parametrize("case", LIVE_CASES)
def test_live_tiles_equal_the_full_loop(case):
    """Walking each 128-row block over its live tiles only gives the full
    loop's result: a skipped tile carries no weight for any row."""
    B, Hq, Hkv, Sq, Sk, hd, hdv, causal, window, kv_len = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hdv)))
    kw = dict(causal=causal, window=window,
              q_offset=Sk - Sq if causal else 0, kv_len=kv_len)
    got = blocked.flash_attention_live(q, k, v, **kw)
    want = blocked.flash_attention_plain(q, k, v, block_k=64, **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    G = Hq // Hkv
    tiles = [blocked.live_kv_tiles(r0, min(r0 + 128, G * Sq), Sq, sk=Sk,
                                   kv_len=Sk if kv_len is None else kv_len,
                                   causal=causal, window=window,
                                   q_offset=kw["q_offset"])
             for r0 in range(0, G * Sq, 128)]
    full = -(-Sk // 64) * len(tiles)
    walked = sum(hi - lo for lo, hi in tiles)
    assert walked <= full
    if causal and Sq >= 256:
        assert walked < full


@pytest.mark.parametrize("dtype, hd, hdv, kv_aligned, q_aligned, route", [
    (torch.bfloat16, 128, 128, True, True, "tc"),
    (torch.bfloat16, 64, 32, True, True, "tc"),
    (torch.bfloat16, 128, 128, True, False, "tc"),
    (torch.bfloat16, 576, 512, True, True, "wide"),
    (torch.bfloat16, 192, 160, True, True, "wide"),
    (torch.bfloat16, 64, 256, True, True, "wide"),
    (torch.bfloat16, 576, 512, False, True, "simt"),
    (torch.bfloat16, 576, 512, True, False, "simt"),
    (torch.bfloat16, 128, 128, False, True, "simt"),
    (torch.bfloat16, 36, 64, True, True, "simt"),
    (torch.bfloat16, 200, 100, True, True, "simt"),
    (torch.float32, 128, 128, True, True, "simt"),
    (torch.float32, 576, 512, True, True, "simt"),
])
def test_flash_route_rule(dtype, hd, hdv, kv_aligned, q_aligned, route):
    """The forward's routes (flash_attention.cu's tc::dispatch): bf16 over
    128 wide is ``wide`` (q, k and v 16-byte aligned), TMA-readable bf16 up
    to 128 ``tc`` (k and v aligned; Q is not read by TMA), the rest
    ``simt``."""
    assert blocked.flash_route(dtype, hd, hdv, kv_aligned, q_aligned) == route


# B, Hq, Hkv, Sq, Sk, hd, causal, window, kv_len: the query rows at or
# past kv_len + window - 1 (or all rows, at kv_len 0) have no live key.
MASKED_CASES = [
    (1, 2, 1, 300, 300, 64, False, 32, 100),
    (1, 4, 2, 130, 700, 32, True, 8, 600),
    (2, 2, 2, 64, 150, 32, False, 0, 0),
]


@pytest.mark.parametrize("case", MASKED_CASES)
@pytest.mark.parametrize("block_k", [64, 512])
def test_row_with_no_live_key_takes_the_mean_of_v(case, block_k):
    """A row with no live key averages V over the Sk keys, as
    ref_attention's softmax over equal -1e30 scores does, whatever the
    blocking (padding past Sk weighs nothing); the other rows are the
    reference's too."""
    B, Hq, Hkv, Sq, Sk, hd, causal, window, kv_len = case
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd)))
    q_offset = Sk - Sq if causal else 0
    got = blocked.flash_attention_plain(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_len=kv_len, block_k=block_k)
    qpos = np.arange(Sq) + q_offset
    dead = (kv_len == 0) | ((window > 0) & (qpos >= kv_len + window - 1))
    assert dead.any() and (kv_len == 0 or not dead.all())
    mean = v.mean(dim=2).repeat_interleave(Hq // Hkv, dim=1)
    torch.testing.assert_close(
        got[:, :, dead], mean[:, :, None].expand_as(got[:, :, dead]),
        atol=1e-5, rtol=1e-5)
    if kv_len == Sk or kv_len == 0:
        return
    want = ref.ref_attention(q, k[:, :, :kv_len], v[:, :, :kv_len],
                             causal=causal, window=window,
                             q_offset=q_offset)
    torch.testing.assert_close(got[:, :, ~dead], want[:, :, ~dead],
                               atol=1e-5, rtol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: reads the CUDA library's policy")


@pytest.mark.cuda
@pytest.mark.parametrize("G, Sq, want", [
    (1, 4096, 4),     # vilbert-base at N = 4096: 32 row tiles, clusters of 8
    (1, 1408, 2),     # 11 row tiles
    (8, 256, 2),      # qwen3-32b's GQA rows at 256 tokens
    (1, 100, 1),      # one row tile: a cluster of one
])
def test_regeneration_factor(card, G, Sq, want):
    from repro_torch.kernels.stream_attention import regeneration
    assert regeneration(G, Sq) == want



# ---- the backward kernels' tensor-core route ----

def _bwd_run(kernel, rounding):
    """(split mirror, plain) gradients at one head of vilbert-base's vision
    stream (hd 128) cut to 1024 tokens (flash), and with RoPE and the
    qk-norm over D = 512 (stream); bf16 inputs, the forward's lse."""
    rng = np.random.default_rng(5)
    S, hd = 1024, 128
    q, k, v, do = (_bf16(rng, 1, 1, S, hd) for _ in range(4))
    if kernel == "flash":
        out, lse = blocked.flash_attention_plain(q, k, v, return_lse=True)
        return (blocked.flash_attention_bwd_split(q, k, v, out, lse, do,
                                                  rounding=rounding),
                blocked.flash_attention_bwd_plain(q, k, v, out, lse, do))
    D = 512
    x = _bf16(rng, 1, S, D)
    wk, wv = (_bf16(rng, D, 1, hd, scale=D ** -0.5) for _ in range(2))
    sin, cos = ref.rope_tables(S, hd)
    kw = dict(sin=sin, cos=cos, k_gamma=torch.from_numpy(
        (rng.standard_normal(hd) * 0.1 + 1).astype(np.float32)))
    out, lse = blocked.stream_attention_plain(q, x, wk, wv, return_lse=True,
                                              **kw)
    return (blocked.stream_attention_bwd_split(q, x, wk, wv, out, lse, do,
                                               rounding=rounding, **kw),
            blocked.stream_attention_bwd_plain(q, x, wk, wv, out, lse, do,
                                               **kw))


@pytest.mark.parametrize("kernel", ["flash", "stream"])
def test_backward_split_operands_hold_the_bf16_limit(kernel):
    """Every gradient of the tc route's mirror is within one bf16 ulp of the
    f32 plain backward's."""
    got, want = _bwd_run(kernel, "split")
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert worst(g, w) <= 1.0


@pytest.mark.parametrize("kernel", ["flash", "stream"])
def test_backward_bf16_operands_alone_break_the_limit(kernel):
    """Without the lo halves (P and dS, and for the stream kernel K, V,
    dK and dV, rounded to bf16) the gradients miss the limit."""
    got, want = _bwd_run(kernel, "bf16")
    assert max(worst(g, w) for g, w in zip(got, want) if w is not None) > 1.0


@pytest.mark.parametrize("dtype, hd, hdv, route", [
    (torch.bfloat16, 128, 128, "tc"), (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 96, 32, "tc"), (torch.bfloat16, 36, 64, "simt"),
    (torch.bfloat16, 128, 256, "wide"), (torch.float32, 128, 128, "simt"),
    (torch.bfloat16, 576, 512, "wide"), (torch.float32, 576, 512, "wide"),
])
def test_flash_backward_route_rule(dtype, hd, hdv, route):
    assert blocked.flash_bwd_route(dtype, hd, hdv) == route


@pytest.mark.parametrize("dtype, hd, D, Hkv, route, cluster", [
    (torch.bfloat16, 128, 1024, 8, "tc", 8),    # vilbert vision
    (torch.bfloat16, 64, 768, 12, "tc", 6),     # vilbert text: 2 heads a block
    (torch.bfloat16, 128, 5120, 8, "tc", 8),    # qwen3-32b's widths
    (torch.bfloat16, 128, 768, 12, "simt", 0),  # no cluster of 1 head a block
    (torch.bfloat16, 96, 100, 1, "simt", 1),    # D not a multiple of 8
    (torch.bfloat16, 48, 256, 2, "simt", 2),    # a width the forward lacks
    (torch.float32, 128, 1024, 8, "simt", 8),
])
def test_stream_backward_route_rule(dtype, hd, D, Hkv, route, cluster):
    assert blocked.stream_bwd_route(dtype, hd, D, Hkv) == route
    assert blocked.stream_bwd_cluster(Hkv, hd) == cluster


@pytest.mark.parametrize("B, Sk, D, Hkv, hd, tc_bytes, simt_bytes", [
    (2, 4096, 1024, 8, 128, 134_217_728, 536_870_912),   # vision self 4096
    (1, 4096, 5120, 8, 128, 335_544_320, 1_342_177_280), # qwen3-32b widths
    (2, 1408, 1024, 8, 128, 134_217_728, 184_549_376),   # pruned: 22 tiles
    (2, 640, 768, 12, 64, 47_185_920, 47_185_920),       # 10 tiles
])
def test_stream_backward_dw_slots_do_not_grow_with_sk(B, Sk, D, Hkv, hd,
                                                      tc_bytes, simt_bytes):
    """tc: B * min(ceil(Sk / 64), 16) f32 slots of dW_K and of dW_V;
    simt: one a kv tile."""
    assert blocked.stream_bwd_scratch_bytes("tc", B, Sk, D, Hkv, hd) \
        == tc_bytes
    assert blocked.stream_bwd_scratch_bytes("simt", B, Sk, D, Hkv, hd) \
        == simt_bytes
    dw, dg, cluster, groups = blocked.stream_bwd_slots("tc", B, Sk, Hkv, hd)
    assert (dw, dg) == (B * groups, B * groups * cluster)


def test_slots_are_summed_in_order():
    """reduce_in_order is ((s_0 + s_1) + s_2) + ..., bitwise, and its
    result depends on the order (f32 sums are not associative)."""
    rng = np.random.default_rng(6)
    slots = torch.from_numpy(
        (rng.standard_normal((32, 4096)) * 10.0 ** rng.integers(
            -3, 4, (32, 1))).astype(np.float32))
    want = slots[0].clone()
    for s in slots[1:]:
        want = want + s
    assert torch.equal(blocked.reduce_in_order(slots), want)
    assert not torch.equal(blocked.reduce_in_order(slots.flip(0)), want)


def test_stream_backward_dw_is_the_ordered_sum_of_tile_partials():
    """The mirror's dW_K equals the partials of its tiles, x_j^T dK_pre,j
    (the hi + lo split of dK_pre), added into the slot of tile group
    j % NG in tile order and the slots summed in order: the order the tc
    kernels use, with more tiles than groups."""
    rng = np.random.default_rng(7)
    B, S, D, hd = 2, 1100, 64, 32      # 18 tiles over 16 groups
    q, do = (_bf16(rng, B, 1, S, hd) for _ in range(2))
    x = _bf16(rng, B, S, D)
    wk, wv = (_bf16(rng, D, 1, hd, scale=D ** -0.5) for _ in range(2))
    out, lse = blocked.stream_attention_plain(q, x, wk, wv, return_lse=True)
    got = blocked.stream_attention_bwd_split(q, x, wk, wv, out, lse, do)
    dw_slots, _, _, groups = blocked.stream_bwd_slots("tc", B, S, 1, hd)
    assert groups == 16 and dw_slots == 32
    # the tile partials again, from autograd of the generator
    qf, dof, lsef, delta = blocked._bwd_rows(q, out, lse, do, 1)
    slots = torch.zeros((B, groups, D, 1, hd))
    xp, _ = blocked._pad_axis(x, 1, 64)
    for j in range(xp.shape[1] // 64):
        x_j = xp[:, j * 64:(j + 1) * 64].float()
        k_j = torch.einsum("btd,dhe->bthe", x_j, wk.float())
        v_j = torch.einsum("btd,dhe->bthe", x_j, wv.float())
        kpos = j * 64 + torch.arange(64)
        _, dk_j, _ = blocked._tile_grads(
            qf, dof, lsef, delta, k_j.transpose(1, 2), v_j.transpose(1, 2),
            kpos, torch.arange(S), S, S, False, 0, hd ** -0.5,
            ops=blocked._operands("split"), split_kv=True)
        dkt = dk_j.transpose(1, 2)
        slots[:, j % groups] += sum(torch.einsum("btd,bthe->bdhe", x_j, a)
                                    for a in blocked.split_bf16(dkt))
    want = blocked.reduce_in_order(slots.reshape(-1, D, 1, hd))
    assert torch.equal(got[2], want.to(wk.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("G, Sq, want", [
    (1, 4096, 4),     # vilbert-base at N = 4096, against 64 per 64 rows
    (1, 1408, 2),
    (8, 256, 2),
])
def test_backward_regeneration_factor(card, G, Sq, want):
    from repro_torch.kernels.flash_vjp import regeneration
    assert regeneration(G, Sq) == want
