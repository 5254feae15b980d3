"""The port's ViLBERT against ``repro.models.vilbert`` on vilbert-smoke
and vilbert-large-smoke:
JAX parameters converted with ``convert.vilbert_from_jax``, the same numpy
batch, logits within 1e-4 (f32) in each execution mode, equal kept-token
counts and equal kept-token indices at every DTPU step; then the layer and
pruning helpers one by one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vilbert_base as jcfg
from repro.configs import vilbert_large as jcfg_large
from repro.core import pruning as jP
from repro.core.types import ExecutionMode as JMode
from repro.models import layers as jL
from repro.models import vilbert as jV
from repro_torch.configs.registry import get_config
from repro_torch.convert import vilbert_from_jax
from repro_torch.core import pruning as P
from repro_torch.core.types import ExecutionMode
from repro_torch.models import layers as L
from repro_torch.models.vilbert import ViLBERT

T = torch.from_numpy


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("vilbert-base", smoke=True)
    params = jV.init(jax.random.PRNGKey(0), jcfg.SMOKE)
    model = vilbert_from_jax(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    batch = {"regions": rng.standard_normal((2, 64, 64)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    return params, model, batch


def _recording(monkeypatch, module):
    """Record the kept indices of every ``prune_stream`` call of module."""
    seen, real = [], module.prune_stream

    def prune_stream(x, scores, keep, positions=None):
        out = real(x, scores, keep, positions)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(module, "prune_stream", prune_stream)
    return seen


@pytest.fixture(scope="module")
def large():
    """vilbert-large-smoke: equal stream widths, three co-TRM blocks."""
    cfg = get_config("vilbert-large", smoke=True)
    params = jV.init(jax.random.PRNGKey(1), jcfg_large.SMOKE)
    model = vilbert_from_jax(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    rng = np.random.default_rng(1)
    batch = {"regions": rng.standard_normal((2, 64, 64)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    return params, model, batch


def _forward_parity(monkeypatch, jsmoke, params, model, batch, mode):
    """Logits within 1e-4 of the JAX forward, equal kept counts and equal
    kept indices at every DTPU step; returns the kept counts."""
    jax_idx = _recording(monkeypatch, jP)
    port_idx = _recording(monkeypatch, P)
    want, want_counts = jV.forward(
        params, jsmoke, {k: jnp.asarray(v) for k, v in batch.items()},
        mode=JMode(mode.value), use_pallas=False, return_token_counts=True)
    got, counts = model({"regions": T(batch["regions"]),
                         "tokens": T(batch["tokens"])},
                        mode=mode, return_token_counts=True)
    assert got.shape == (2, 3129) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert counts == tuple(want_counts)
    # X then Y in every block that prunes
    assert len(port_idx) == len(jax_idx) == 2 * len(counts)
    for a, b in zip(port_idx, jax_idx):
        np.testing.assert_array_equal(a, b)
    return counts


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_forward_matches_jax(smoke, mode, monkeypatch):
    counts = _forward_parity(monkeypatch, jcfg.SMOKE, *smoke, mode)
    assert counts == ((44, 44), (22, 22))


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_large_forward_matches_jax(large, mode, monkeypatch):
    counts = _forward_parity(monkeypatch, jcfg_large.SMOKE, *large, mode)
    assert counts == ((44, 44), (32, 32), (22, 22))


def test_large_config_and_convert(large):
    """vilbert-large's published shape; every parameter of the JAX tree
    lands in the port's model."""
    cfg = get_config("vilbert-large")
    assert (cfg.num_layers, cfg.num_coattn_layers, cfg.d_model,
            cfg.d_model_y, cfg.num_heads, cfg.num_heads_y) == \
        (24, 12, 1024, 1024, 16, 16)
    assert P.keep_plan(cfg.pruning, 12, 4096) == \
        jP.keep_plan(jcfg_large.CONFIG.pruning, 12, 4096) == \
        (4096,) * 3 + (2816,) * 3 + (2048,) * 3 + (1408,) * 3
    params, model, _ = large
    assert len(model.text_pre) == 3 and len(model.co_x) == 3
    np.testing.assert_array_equal(
        model.state_dict()["co_x.2.self_attn.wq"].numpy(),
        np.asarray(params["co_x"]["self_attn"]["wq"][2]))


def test_convert_maps_every_parameter(smoke):
    params, model, _ = smoke
    flat = {k: v for k, v in model.state_dict().items()}
    assert "text_embed.embedding" in flat and not any(
        "unembed" in k for k in flat)
    np.testing.assert_array_equal(
        flat["co_y.1.co_attn.wk"].numpy(),
        np.asarray(params["co_y"]["co_attn"]["wk"][1]))
    np.testing.assert_array_equal(
        flat["text_pre.0.mlp.w_up"].numpy(),
        np.asarray(params["text_pre"]["mlp"]["w_up"][0]))
    bad = jax.tree.map(np.asarray, params)
    del bad["pool_x"]
    with pytest.raises(KeyError, match="pool_x"):
        vilbert_from_jax(bad, get_config("vilbert-base", smoke=True), "cpu")


def test_own_init_has_jax_shapes_and_scales(smoke):
    """The port's torch.Generator init draws the JAX init's shapes at the
    scales of layers.dense_init (fan_in^-0.5, or the fixed ones)."""
    params, converted, _ = smoke
    cfg = get_config("vilbert-base", smoke=True)
    own = ViLBERT(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3)).state_dict()
    ref = converted.state_dict()
    assert own.keys() == ref.keys()
    for name, t in own.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype
        if t.numel() >= 4096:    # large enough for a stable spread
            ratio = t.float().std().item() / ref[name].float().std().item()
            assert 0.9 < ratio < 1.1, name


def test_entry_points_need_a_named_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViLBERT(get_config("vilbert-base", smoke=True))


# ---------------- helpers, one by one ----------------

def test_layer_norm_and_mlps_match_jax(smoke):
    params, model, _ = smoke
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    p_ln = L.LayerNorm(48, torch.float32, torch.device("cpu"))
    p_ln.gamma.copy_(T(rng.standard_normal(48).astype(np.float32)))
    p_ln.beta.copy_(T(rng.standard_normal(48).astype(np.float32)))
    ln = {"gamma": p_ln.gamma.numpy(), "beta": p_ln.beta.numpy()}
    np.testing.assert_allclose(L.layer_norm(p_ln, T(x)).numpy(),
                               np.asarray(jL.layer_norm(ln, x)),
                               atol=1e-5, rtol=1e-5)
    mlp = jax.tree.map(lambda a: a[0], params["co_y"]["mlp"])
    got = L.mlp_forward(model.co_y[0].mlp, T(x))
    want = jL.mlp_forward(mlp, jcfg.SMOKE, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # SwiGLU: the same weights drawn by the port, handed to the JAX MLP
    cfg = dataclasses.replace(get_config("vilbert-base", smoke=True),
                              act="silu")
    swi = L.MLP(cfg, 48, 96, torch.Generator().manual_seed(5))
    want = jL.mlp_forward({k: v.numpy() for k, v in swi.state_dict().items()},
                          dataclasses.replace(jcfg.SMOKE, act="silu"),
                          jnp.asarray(x))
    np.testing.assert_allclose(L.mlp_forward(swi, T(x)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def test_column_scores_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 30, 16)).astype(np.float32)
    for causal, stride in [(False, 1), (False, 8), (True, 3)]:
        got = P.attention_column_scores(T(q), T(k), causal=causal,
                                        sample_stride=stride)
        want = jP.attention_column_scores(q, k, causal=causal,
                                          sample_stride=stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)


def test_select_gather_prune_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.random((3, 50)).astype(np.float32)
    scores[1, 10:20] = 0.5       # ties: the lower index wins, as lax.top_k
    x = rng.standard_normal((3, 50, 6)).astype(np.float32)
    pos = np.tile(np.arange(50), (3, 1))
    for keep in (1, 7, 50):
        idx = P.select_tokens(T(scores), keep)
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jP.select_tokens(scores, keep)))
        np.testing.assert_array_equal(
            P.select_tokens(T(scores), keep, keep_order=False).numpy(),
            np.asarray(jP.select_tokens(scores, keep, keep_order=False)))
        xk, ik, pk = P.prune_stream(T(x), T(scores), keep, T(pos))
        jxk, jik, jpk = jP.prune_stream(x, scores, keep, pos)
        np.testing.assert_array_equal(xk.numpy(), np.asarray(jxk))
        np.testing.assert_array_equal(ik.numpy(), np.asarray(jik))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jpk))
        np.testing.assert_array_equal(
            P.gather_tokens(T(x), ik).numpy(),
            np.asarray(jP.gather_tokens(x, jik)))


def test_keep_plan_matches_jax():
    cfg = get_config("vilbert-base")
    assert P.keep_plan(cfg.pruning, 6, 4096) == \
        (4096, 2816, 2816, 2048, 1408, 1408)
    for n_layers, seq in [(6, 4096), (6, 1024), (2, 64), (4, 300), (3, 17)]:
        for pc, jpc in [(cfg.pruning, jcfg.CONFIG.pruning),
                        (get_config("vilbert-base", True).pruning,
                         jcfg.SMOKE.pruning)]:
            assert P.keep_plan(pc, n_layers, seq) == \
                jP.keep_plan(jpc, n_layers, seq)
