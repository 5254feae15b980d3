"""The port's dense decoder against ``repro.models.transformer`` on
qwen3-smoke and starcoder2-smoke (f32): JAX parameters converted with
``convert.transformer_from_jax``, the same numpy tokens; prefill under the
planner's plan and two decode steps give logits within 1e-4 and caches
within 1e-4; a heterogeneous plan runs each layer under its own mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.plan import plan_model as jplan_model
from repro_torch.configs.registry import get_config, model_module
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import AttnKind, ExecutionMode, Family
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.plan import plan_decode_step, plan_model

TOL = 1e-4
ARCHS = ["qwen3-32b", "starcoder2-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, smoke=True)
    jcfg = jregistry.get_config(request.param, smoke=True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    return cfg, jcfg, params, port, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_prefill_and_decode_match_jax(model):
    cfg, jcfg, params, port, tokens = model
    S = tokens.shape[1]
    plan, jplan = plan_model(cfg, seq_len=S), jplan_model(jcfg, seq_len=S)
    jlogits, jcache = jT.prefill(params, jcfg,
                                 {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 max_len=32, plan=jplan)
    logits, cache = port.prefill({"tokens": torch.as_tensor(tokens)}, 32,
                                 plan=plan)
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    _close(logits, jlogits)
    for side in ("k", "v"):
        _close(cache["layers"][side], jcache["layers"][side])
    assert cache["len"] == int(jcache["len"]) == S
    rng = np.random.default_rng(1)
    for _ in range(2):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1))
        jlogits, jcache = jT.decode_step(params, jcfg, jcache,
                                         jnp.asarray(nxt, jnp.int32))
        logits, cache = port.decode_step(cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
        for side in ("k", "v"):
            _close(cache["layers"][side], jcache["layers"][side])
    assert cache["len"] == int(jcache["len"]) == S + 2


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_forward_matches_jax(model, mode):
    _, jcfg, params, port, tokens = model
    want = jT.forward(params, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)},
                      mode=JMode(mode.value))
    _close(port({"tokens": torch.as_tensor(tokens)}, mode=mode), want)


def test_heterogeneous_plan_runs_each_layer_in_its_mode(model, monkeypatch):
    """Layer 0 NON_STREAM, layer 1 TILE_STREAM: two segments, each layer
    dispatched under its own mode, the logits those of the uniform plan
    and of the JAX prefill under the same plan."""
    cfg, jcfg, params, port, tokens = model
    S = tokens.shape[1]
    overrides = {0: ExecutionMode.NON_STREAM, 1: ExecutionMode.TILE_STREAM}
    plan = plan_model(cfg, seq_len=S).with_layer_modes(overrides)
    jplan = jplan_model(jcfg, seq_len=S).with_layer_modes(
        {i: JMode(m.value) for i, m in overrides.items()})
    assert plan.heterogeneous and plan.to_dict() == jplan.to_dict()
    segs = T._dispatch_segments(cfg, plan, 0, cfg.num_layers)
    jsegs = jT._dispatch_segments(jcfg, jplan, 0, cfg.num_layers)
    assert [(a, b, lp.mode.value) for a, b, lp in segs] == \
        [(a, b, lp.mode.value) for a, b, lp in jsegs] == \
        [(0, 1, "non_stream"), (1, 2, "tile_stream")]

    seen, real = [], ops.attention_by_plan

    def recording(lp, *args, **kw):
        seen.append(lp.mode)
        return real(lp, *args, **kw)

    monkeypatch.setattr(ops, "attention_by_plan", recording)
    batch = {"tokens": torch.as_tensor(tokens)}
    logits, _ = port.prefill(batch, 32, plan=plan)
    assert seen == [ExecutionMode.NON_STREAM, ExecutionMode.TILE_STREAM]
    uniform, _ = port.prefill(batch, 32, plan=plan_model(cfg, seq_len=S))
    _close(logits, uniform)
    jlogits, _ = jT.prefill(params, jcfg,
                            {"tokens": jnp.asarray(tokens, jnp.int32)},
                            max_len=32, plan=jplan)
    _close(logits, jlogits)


def test_decode_step_reads_its_decode_plan(model, monkeypatch):
    """Under a ``DecodePlan`` every layer's decode attention goes through
    ``ops.batched_decode_attention_by_plan`` with that layer's plan; the
    logits are those of the step without a plan, within the JAX decode
    tolerance (only the plain version's blocking differs)."""
    cfg, _, _, port, tokens = model
    S = tokens.shape[1]
    nxt = torch.as_tensor(tokens[:, :1])
    dp = plan_decode_step(cfg, (S + 1, S + 1), block_kv=8)
    seen, real = [], ops.batched_decode_attention_by_plan

    def recording(lp, *args, **kw):
        seen.append((lp.layer_index, lp.block_kv))
        return real(lp, *args, **kw)

    batch = {"tokens": torch.as_tensor(tokens)}
    _, cache = port.prefill(batch, 32)
    want, _ = port.decode_step(cache, nxt)
    monkeypatch.setattr(ops, "batched_decode_attention_by_plan", recording)
    _, cache = port.prefill(batch, 32)
    got, _ = port.decode_step(cache, nxt, plan=dp)
    assert seen == [(i, 8) for i in range(cfg.num_layers)]
    _close(got, want, 1e-5)


def test_dispatch_segments_uniform_and_absent_plans():
    cfg = get_config("qwen3-32b", smoke=True)
    assert T._dispatch_segments(cfg, None, 0, 2) == [(0, 2, None)]
    (seg,) = T._dispatch_segments(cfg, plan_model(cfg), 0, 2)
    assert seg[:2] == (0, 2) and seg[2].mode == ExecutionMode.TILE_STREAM
    big = get_config("qwen3-32b")
    assert plan_model(big).uniform_mode == ExecutionMode.LAYER_STREAM


def test_convert_maps_every_parameter(model):
    cfg, _, params, port, _ = model
    flat = port.state_dict()
    assert "embed.unembed" in flat and "final_norm.gamma" in flat
    np.testing.assert_array_equal(flat["layers.1.attn.wq"].numpy(),
                                  np.asarray(params["layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        flat["layers.0.mlp.w_down"].numpy(),
        np.asarray(params["layers"]["mlp"]["w_down"][0]))
    bad = jax.tree.map(np.asarray, params)
    del bad["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        transformer_from_jax(bad, cfg, device="cpu")


def test_own_init_has_jax_shapes_and_scales(model):
    cfg, _, _, port, _ = model
    own = T.Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3)).state_dict()
    ref = port.state_dict()
    assert own.keys() == ref.keys()
    for name, t in own.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype
        if t.numel() >= 4096:
            ratio = t.float().std().item() / ref[name].float().std().item()
            assert 0.9 < ratio < 1.1, name


@pytest.mark.parametrize("change,item", [
    (dict(family=Family.MOE), "item 6"),
    (dict(family=Family.VLM), "item 6"),
    (dict(attn_kind=AttnKind.SLIDING), "paged ring pool"),
    (dict(attn_kind=AttnKind.MLA), "item 10"),
    (dict(use_bias=True), "item 6"),
])
def test_unported_variants_raise(change, item):
    cfg = dataclasses.replace(get_config("qwen3-32b", smoke=True), **change)
    with pytest.raises(NotImplementedError, match=item):
        T.Transformer(cfg, device="cpu")


def test_registry_dispatches_families():
    assert model_module(get_config("qwen3-32b")) is T
    assert model_module(get_config("vilbert-base")).__name__.endswith("vilbert")
    assert model_module(dataclasses.replace(get_config("qwen3-32b"),
                                            family=Family.SSM)) is T
    with pytest.raises(NotImplementedError):
        model_module(dataclasses.replace(get_config("qwen3-32b"),
                                         family=Family.MOE))
    with pytest.raises(NotImplementedError, match="smoke"):
        get_config("starcoder2-7b")


def test_rope_and_norm_helpers_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    for pos in (0, 7, 1536):
        s, c = L.rope_at(pos, 32, 1e6)
        js, jc = jL.rope_at(jnp.int32(pos), 32, 1e6)
        _close(s, js, 1e-6)
        _close(c, jc, 1e-6)
        _close(L.apply_rope_bsd(torch.from_numpy(x), s, c),
               jL.apply_rope_bsd(x, js, jc), 1e-6)
    s, c = L.rope_tables_for(get_config("qwen3-32b", smoke=True), 5)
    js, jc = jL.rope_tables_for(jregistry.get_config("qwen3-32b", smoke=True),
                                5)
    _close(s, js, 1e-6)
    _close(L.apply_rope_bsd(torch.from_numpy(x), s, c),
           jL.apply_rope_bsd(x, js, jc), 1e-6)
    norm = L.RMSNorm(32, torch.float32, torch.device("cpu"))
    norm.gamma.copy_(torch.from_numpy(rng.standard_normal(32).astype(
        np.float32)))
    _close(L.rms_norm(norm, torch.from_numpy(x), eps=1e-6),
           jL.rms_norm({"gamma": norm.gamma.numpy()}, x, eps=1e-6), 1e-6)


def test_unembed_in_bf16_accumulates_in_f32(model):
    """A bf16 unembed multiplies the bf16 values in f32 chunk by chunk:
    the result is the f32 product of the rounded operands."""
    cfg, _, _, port, _ = model
    emb = L.Embedding(cfg.vocab_size, cfg.d_model, torch.bfloat16,
                      torch.Generator().manual_seed(0), unembed=True)
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    old, L.UNEMBED_CHUNK = L.UNEMBED_CHUNK, 100
    try:
        got = L.unembed(emb, x, cfg)
    finally:
        L.UNEMBED_CHUNK = old
    assert got.dtype == torch.float32
    want = torch.matmul(x.float(), emb.unembed.float())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
