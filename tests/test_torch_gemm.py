"""The CUDA GEMM's route and split rules and its splitk sum, on the CPU.

``csrc/tile_gemm.cu`` picks one of four routes by shape and splits K for
the decode route; ``blocked.gemm_route`` and ``gemm_splits`` mirror those
rules (``chip_smoke.py`` holds the library's against them on the card).
``split_ranges`` and ``splitk_plain`` below mirror the splitk route's K
ranges and its sum: f32 partials of each K split added in split order.
Here: every main-path GEMM of ``chip_smoke.py`` takes its intended route,
the splits cover K once, and the splitk sum matches the JAX Pallas GEMM
(interpret mode, block-dividing shapes) and ``ref_tile_gemm``, with a row
of a batched call equal to the M = 1 call bitwise."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.tile_gemm import tile_gemm as pallas_gemm
from repro_torch.configs.registry import get_config
from repro_torch.kernels import blocked

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.from_numpy
BF16, F32 = torch.bfloat16, torch.float32
SMS = 132                  # the H100's streaming multiprocessors


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def split_ranges(K, N):
    """The K rows [lo, hi) of each split of the splitk route, in split
    order."""
    S, ktiles = blocked.gemm_splits(K, N), -(-K // blocked.GEMM_KT)
    rows = -(-ktiles // S) * blocked.GEMM_KT
    return [(s * rows, min(K, (s + 1) * rows)) for s in range(S)]


def splitk_plain(x, w):
    """The splitk route's sum: an f32 partial of each K split, the partials
    added in split order 0..S-1, cast to x's dtype.  Each row is computed
    on its own (a vector-matrix product per row and split), so row i equals
    the M = 1 call on row i bitwise, as in the kernel."""
    xf, wf = x.float(), w.float()
    out = None
    for lo, hi in split_ranges(x.shape[1], w.shape[1]):
        part = torch.stack([xf[i, lo:hi] @ wf[lo:hi]
                            for i in range(x.shape[0])])
        out = part if out is None else out + part
    return out.to(x.dtype)


def _mlp(name):
    """The (K, N) of a configuration's MLP projections through tile_gemm."""
    cfg = get_config(name)
    if name == "vilbert-base":
        return [(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model),
                (cfg.d_model_y, cfg.d_ff_y), (cfg.d_ff_y, cfg.d_model_y)]
    return [(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)]


# Each main path's GEMM rows: prefill (and vilbert's forward) M, decode M.
# vilbert: B = 2 times every kept-token count; qwen3-32b: its prompt
# lengths, decode buckets of 1..4 slots; hymba-1.5b: its prompt lengths,
# per-slot decode; whisper-base: B = 4 times the encoder's 1500 frames and
# the 4-token prompt, decode B = 4; qwen2-vl-2b: the 4096-token forward,
# its prompt lengths, decode buckets of 1..4 slots.
MAIN_PATHS = {
    "vilbert-base": ({2 * n for pair in chip_smoke.EXPECTED_COUNTS
                      for n in pair}, set()),
    "qwen3-32b": ({p for _, p, _, _ in chip_smoke.SERVE_REQUESTS},
                  {1, 2, 3, 4}),
    "hymba-1.5b": ({p for _, p, _, _ in chip_smoke.HYMBA_REQUESTS}, {1}),
    "vilbert-large": ({2 * n for pair in chip_smoke.EXPECTED_COUNTS_LARGE
                       for n in pair}, set()),
    "whisper-base": ({chip_smoke.WHISPER_B * 1500,
                      chip_smoke.WHISPER_B * chip_smoke.WHISPER_PROMPT},
                     {chip_smoke.WHISPER_B}),
    "qwen2-vl-2b": ({4096} | {p for _, p, _, _ in chip_smoke.QWEN2VL_REQUESTS},
                    {1, 2, 3, 4}),
}


@pytest.mark.parametrize("name", sorted(MAIN_PATHS))
def test_main_path_gemms_take_their_route(name):
    prefill, decode = MAIN_PATHS[name]
    for K, N in _mlp(name):
        for M in prefill:
            assert blocked.gemm_route(M, K, N, BF16) == "wgmma", (M, K, N)
        for M in decode:
            for dt in (BF16, F32):      # f32: phase 6's batched decode check
                assert blocked.gemm_route(M, K, N, dt) == "splitk", (M, K, N)


def test_chip_smoke_main_gemm_shapes_take_their_route():
    for case, (M, K, N) in chip_smoke.MAIN_GEMM.items():
        want = "splitk" if "decode" in case else "wgmma"
        assert blocked.gemm_route(M, K, N, BF16) == want, case


def test_route_edges():
    S = blocked.GEMM_M_SMALL
    assert 4 <= S <= 16
    assert blocked.gemm_route(S, 256, 512, BF16) == "splitk"
    assert blocked.gemm_route(S + 1, 256, 512, BF16) == "wgmma"
    assert blocked.gemm_route(S + 1, 256, 512, F32) == "simt"
    assert blocked.gemm_route(S, 770, 130, F32) == "splitk"
    for K, N in ((770, 256), (256, 130), (0, 256)):
        assert blocked.gemm_route(S + 1, K, N, BF16) == "mma"


# every (K, N) of the configurations' tile_gemm calls (mamba2-780m has none:
# its in/out projections are torch.matmul), plus chip_smoke's ragged cases
SPLIT_SHAPES = sorted({kn for name in MAIN_PATHS for kn in _mlp(name)}
                      | {(K, N) for _, K, N in chip_smoke.GEMM_CASES}
                      | {(0, 8), (64, 8), (65, 8)})


@pytest.mark.parametrize("K, N", SPLIT_SHAPES)
def test_splits_cover_k_once_in_k_tiles(K, N):
    ranges = split_ranges(K, N)
    assert len(ranges) == blocked.gemm_splits(K, N)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert lo % blocked.GEMM_KT == 0
        assert hi % blocked.GEMM_KT == 0 or hi == K
        assert 0 < hi - lo <= blocked.GEMM_KMAX or K == 0


@pytest.mark.parametrize("K, N", [(5120, 25600), (25600, 5120)])
def test_qwen3_decode_splits_fill_the_card(K, N):
    blocks = -(-N // blocked.GEMM_SLAB) * blocked.gemm_splits(K, N)
    assert blocks >= SMS


@pytest.mark.parametrize("shape", [(1, 256, 128), (3, 1024, 256),
                                   (8, 4096, 512)])
def test_splitk_plain_matches_pallas_and_ref(shape):
    """Block-multiple shapes (the Pallas kernel takes no ragged K), one to
    64 splits."""
    M, K, N = shape
    rng = np.random.default_rng(11)
    x, w = _rand(rng, M, K, scale=1.0), _rand(rng, K, N, scale=K ** -0.5)
    got = splitk_plain(T(x), T(w))
    pal = pallas_gemm(jnp.asarray(x), jnp.asarray(w), block_m=M,
                      block_n=128, block_k=512, interpret=True)
    _close(got, pal, 1e-3)
    _close(got, jref.ref_tile_gemm(x, w), 1e-3)


@pytest.mark.parametrize("shape", [(5, 770, 130), (4, 3000, 520),
                                   (8, 40, 136), (3, 776, 264), (1, 65, 8)])
def test_splitk_plain_ragged_matches_ref(shape):
    M, K, N = shape
    rng = np.random.default_rng(12)
    x, w = _rand(rng, M, K, scale=1.0), _rand(rng, K, N, scale=K ** -0.5)
    _close(splitk_plain(T(x), T(w)), jref.ref_tile_gemm(x, w), 1e-3)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(3, 1024, 256), (4, 3000, 520),
                                   (3, 770, 130)])
def test_splitk_rows_equal_the_single_row_call(shape, dtype):
    M, K, N = shape
    rng = np.random.default_rng(13)
    x = T(_rand(rng, M, K, scale=1.0)).to(dtype)
    w = T(_rand(rng, K, N, scale=K ** -0.5)).to(dtype)
    got = splitk_plain(x, w)
    assert got.dtype == dtype
    for i in range(M):
        assert torch.equal(got[i:i + 1], splitk_plain(x[i:i + 1], w))

