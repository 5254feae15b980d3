"""The port's dense decoder against ``repro.models.transformer`` on
qwen3-smoke, starcoder2-smoke, minitron-smoke (GELU MLP) and danube3-smoke
(a dense sliding window of 16, hd 24: its 21-token prompt wraps the ring)
(f32): JAX parameters converted with
``convert.transformer_from_jax``, the same numpy tokens; prefill under the
planner's plan and two decode steps give logits within 1e-4 and caches
within 1e-4; a heterogeneous plan runs each layer under its own mode.
qwen2vl-smoke (VLM): M-RoPE tables within 1e-6 and the forward within
1e-4 of the JAX package's, with equal t/h/w position streams (the JAX
data pipeline's) and with an image grid whose streams differ; prefill and
decode on the 1-D RoPE path, as in JAX.  grok1-smoke and deepseekv3-smoke
(the MoE family, deepseek with MLA and a dense prefix): the forward in
each mode, prefill and decode steps (logits and caches) within 1e-4 of
the JAX package's, and prefill + decode against the forward with nothing
dropped (``moe_capacity=100``)."""
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
from repro_torch.core import runtime
from repro_torch.core.types import AttnKind, ExecutionMode, Family
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.plan import plan_decode_step, plan_model

TOL = 1e-4
ARCHS = ["qwen3-32b", "starcoder2-7b", "minitron-4b", "h2o-danube3-4b"]


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
    (dict(family=Family.CROSSMODAL), "models.vilbert"),
    (dict(family=Family.ENCDEC), "models.encdec"),
    (dict(attn_kind=AttnKind.NONE), "attention-free"),
])
def test_unported_variants_raise(change, item):
    """What the decoder refuses: the crossmodal and encoder-decoder
    families (their own modules) and attention-free layers outside the SSM
    family (no registry arch has them), at ``check_supported`` and at
    construction."""
    cfg = dataclasses.replace(get_config("qwen3-32b", smoke=True), **change)
    with pytest.raises(NotImplementedError, match=item):
        T.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=item):
        T.Transformer(cfg, device="cpu")


def test_registry_dispatches_families():
    assert model_module(get_config("qwen3-32b")) is T
    assert model_module(get_config("vilbert-base")).__name__.endswith("vilbert")
    assert model_module(dataclasses.replace(get_config("qwen3-32b"),
                                            family=Family.SSM)) is T
    assert model_module(get_config("grok-1-314b")) is T
    assert model_module(get_config("deepseek-v3-671b")) is T


@pytest.mark.parametrize("arch", ["minitron-4b", "starcoder2-7b",
                                  "h2o-danube3-4b"])
def test_last_decoder_configs_are_copies_and_supported(arch):
    """The three decoder configs the port refused until now: full CONFIG
    and SMOKE equal the JAX package's, and the decoder takes both (a
    dense sliding window, and ``use_bias``, which no model code reads)."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke)
        assert dataclasses.asdict(cfg) == {
            **dataclasses.asdict(jregistry.get_config(arch, smoke)),
            "family": cfg.family, "attn_kind": cfg.attn_kind,
            "execution_mode": cfg.execution_mode}
        assert cfg.family.value == jregistry.get_config(arch, smoke)\
            .family.value
        T.check_supported(cfg)
        assert model_module(cfg) is T
    assert get_config("starcoder2-7b").use_bias
    assert get_config("h2o-danube3-4b").head_dim == 120


def test_use_bias_is_read_by_no_model_code():
    """starcoder2-smoke with ``use_bias=True`` (the full config's flag)
    gives the JAX package's logits, forward and prefill + decode, within
    1e-4: neither package draws or adds a bias."""
    cfg = dataclasses.replace(get_config("starcoder2-7b", smoke=True),
                              use_bias=True)
    jcfg = dataclasses.replace(jregistry.get_config("starcoder2-7b",
                                                    smoke=True),
                               use_bias=True)
    params = jT.init(jax.random.PRNGKey(1), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    own = T.Transformer(cfg, device="cpu")
    assert own.state_dict().keys() == port.state_dict().keys()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 13))
    jtok = jnp.asarray(tokens, jnp.int32)
    _close(port({"tokens": torch.as_tensor(tokens)}),
           jT.forward(params, jcfg, {"tokens": jtok}))
    jlogits, jcache = jT.prefill(params, jcfg, {"tokens": jtok}, max_len=16)
    logits, cache = port.prefill({"tokens": torch.as_tensor(tokens)}, 16)
    _close(logits, jlogits)
    nxt = tokens[:, -1:]
    jlogits, _ = jT.decode_step(params, jcfg, jcache,
                                jnp.asarray(nxt, jnp.int32))
    logits, _ = port.decode_step(cache, torch.as_tensor(nxt))
    _close(logits, jlogits)


def test_dense_ring_prefill_then_decode_equals_longer_prefill():
    """danube3-smoke (window 16): prefill(S) and one decode step give the
    last logits of prefill(S + 1) within 1e-4, for prompts that stay
    inside the window, fill it, and wrap the ring."""
    cfg = get_config("h2o-danube3-4b", smoke=True)
    port = T.Transformer(cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 40)))
    for S in (9, 16, 23, 39):
        longer, _ = port.prefill({"tokens": tokens[:, :S + 1]}, 48)
        _, cache = port.prefill({"tokens": tokens[:, :S]}, 48)
        assert cache["layers"]["k"].shape[3] == cfg.sliding_window
        step, _ = port.decode_step(cache, tokens[:, S:S + 1])
        _close(step[:, 0], longer[:, -1])


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


# ---------------------------------------------------------------------------
# VLM (qwen2-vl): M-RoPE
# ---------------------------------------------------------------------------

def grid_positions(batch, text, grid_h, grid_w, after):
    """(3, B, S) t/h/w streams as Qwen2-VL assigns them: ``text`` tokens
    (all three equal), an image of grid_h x grid_w patches (t constant, h
    the row, w the column, all offset by the text before it), then
    ``after`` text tokens from the next free position."""
    t = list(range(text))
    h, w = list(t), list(t)
    for r in range(grid_h):
        for c in range(grid_w):
            t.append(text)
            h.append(text + r)
            w.append(text + c)
    nxt = text + max(grid_h, grid_w)
    tail = list(range(nxt, nxt + after))
    pos = np.array([t + tail, h + tail, w + tail], np.int32)
    return np.broadcast_to(pos[:, None], (3, batch, pos.shape[1])).copy()


VLM_S = 3 + 4 * 5 + 4          # 3 text, a 4 x 5 image grid, 4 text


@pytest.fixture(scope="module")
def vlm():
    cfg = get_config("qwen2-vl-2b", smoke=True)
    jcfg = jregistry.get_config("qwen2-vl-2b", smoke=True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, VLM_S))
    equal = np.broadcast_to(np.arange(VLM_S, dtype=np.int32)[None, None],
                            (3, 2, VLM_S)).copy()
    positions = {"equal": equal,
                 "grid": grid_positions(2, 3, 4, 5, 4)}
    return cfg, jcfg, params, port, tokens, positions


@pytest.mark.parametrize("kind", ["equal", "grid"])
def test_mrope_tables_match_jax(vlm, kind):
    cfg, jcfg, _, _, _, positions = vlm
    pos = positions[kind]
    s, c = L.mrope_tables(cfg, torch.from_numpy(pos))
    js, jc = jL.mrope_tables(jcfg, jnp.asarray(pos))
    assert s.shape == (2, VLM_S, cfg.head_dim // 2)
    _close(s, js, 1e-6)
    _close(c, jc, 1e-6)
    full = get_config("qwen2-vl-2b")
    pos = grid_positions(1, 40, 32, 48, 100)
    s, c = L.mrope_tables(full, torch.from_numpy(pos))
    js, jc = jL.mrope_tables(jregistry.get_config("qwen2-vl-2b"),
                             jnp.asarray(pos))
    _close(s, js, 1e-5)
    _close(c, jc, 1e-5)


def test_mrope_bands_read_their_streams(vlm):
    """Band j of the tables reads stream s(j) (t for the first section, h
    for the second, w for the third): equal streams give the 1-D tables,
    an image grid does not."""
    cfg, _, _, _, _, positions = vlm
    s, c = L.mrope_tables(cfg, torch.from_numpy(positions["equal"]))
    s1, c1 = L.rope_tables_for(cfg, VLM_S)
    _close(s, s1[None].expand(2, -1, -1), 1e-6)
    _close(c, c1[None].expand(2, -1, -1), 1e-6)
    pos = positions["grid"]
    s, _ = L.mrope_tables(cfg, torch.from_numpy(pos))
    half = cfg.head_dim // 2
    freqs = 1.0 / cfg.rope_theta ** (np.arange(half, dtype=np.float32) / half)
    lo = 0
    for stream, n in enumerate(cfg.mrope_sections):
        band = slice(lo, lo + n)
        want = np.sin(pos[stream].astype(np.float32)[..., None]
                      * freqs[band])
        _close(s[..., band], want, 1e-6)
        lo += n
    assert not np.allclose(s.numpy(), s1[None].numpy().repeat(2, 0))


@pytest.mark.parametrize("kind", ["equal", "grid"])
@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_vlm_forward_matches_jax(vlm, kind, mode):
    _, jcfg, params, port, tokens, positions = vlm
    pos = positions[kind]
    want = jT.forward(params, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32),
                                     "positions": jnp.asarray(pos)},
                      mode=JMode(mode.value))
    got = port({"tokens": torch.as_tensor(tokens),
                "positions": torch.from_numpy(pos)}, mode=mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_vlm_attention_is_flash_in_every_mode(vlm, monkeypatch):
    """With M-RoPE tables every mode attends through
    ``ops.multi_head_attention`` and never through the mode dispatch (the
    stream kernel takes only (Sk, hd/2) tables); without positions the
    forward dispatches by mode."""
    cfg, _, _, port, tokens, positions = vlm
    flash, by_mode = [], []
    real_mha, real_mode = ops.multi_head_attention, ops.attention_by_mode

    def mha(*args, **kw):
        flash.append(1)
        return real_mha(*args, **kw)

    def dispatch(mode, *args, **kw):
        by_mode.append(mode)
        return real_mode(mode, *args, **kw)

    monkeypatch.setattr(ops, "multi_head_attention", mha)
    monkeypatch.setattr(ops, "attention_by_mode", dispatch)
    batch = {"tokens": torch.as_tensor(tokens),
             "positions": torch.from_numpy(positions["grid"])}
    for mode in ExecutionMode:
        port(batch, mode=mode)
    assert len(flash) == 3 * cfg.num_layers and by_mode == []
    port({"tokens": batch["tokens"]}, mode=ExecutionMode.TILE_STREAM)
    assert by_mode == [ExecutionMode.TILE_STREAM] * cfg.num_layers


def test_vlm_prefill_and_decode_match_jax(vlm):
    """Prefill and decode of a VLM take the 1-D RoPE path in both
    packages (neither reads positions)."""
    cfg, jcfg, params, port, tokens, _ = vlm
    S = VLM_S - 2
    plan, jplan = plan_model(cfg, seq_len=S), jplan_model(jcfg, seq_len=S)
    assert plan.to_dict() == jplan.to_dict()
    jlogits, jcache = jT.prefill(
        params, jcfg, {"tokens": jnp.asarray(tokens[:, :S], jnp.int32)},
        max_len=32, plan=jplan)
    logits, cache = port.prefill({"tokens": torch.as_tensor(tokens[:, :S])},
                                 32, plan=plan)
    _close(logits, jlogits)
    for t in range(S, VLM_S):
        nxt = tokens[:, t:t + 1]
        jlogits, jcache = jT.decode_step(params, jcfg, jcache,
                                         jnp.asarray(nxt, jnp.int32))
        logits, cache = port.decode_step(cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
        for side in ("k", "v"):
            _close(cache["layers"][side], jcache["layers"][side])
    full = port({"tokens": torch.as_tensor(tokens)})
    _close(logits[:, 0], full[:, -1])


def test_vlm_convert_ties_the_embedding(vlm):
    cfg, _, params, port, _, _ = vlm
    flat = port.state_dict()
    assert "embed.unembed" not in flat
    np.testing.assert_array_equal(flat["embed.embedding"].numpy(),
                                  np.asarray(params["embed"]["embedding"]))
    mtp = T.Transformer(dataclasses.replace(cfg, mtp_depth=1), device="cpu")
    assert mtp.mtp_proj.shape == (2 * cfg.d_model, cfg.d_model)
    assert model_module(cfg) is T


# ---------------------------------------------------------------------------
# The MoE family: grok1-smoke (GQA, every layer MoE) and deepseekv3-smoke
# (MLA, a dense prefix layer, a shared expert, mtp_proj)
# ---------------------------------------------------------------------------

MOE_ARCHS = ["grok-1-314b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    cfg = get_config(request.param, smoke=True)
    jcfg = jregistry.get_config(request.param, smoke=True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21))
    return cfg, jcfg, params, port, tokens


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_moe_family_forward_matches_jax(moe_model, mode):
    _, jcfg, params, port, tokens = moe_model
    want = jT.forward(params, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)},
                      mode=JMode(mode.value))
    _close(port({"tokens": torch.as_tensor(tokens)}, mode=mode), want)


def test_moe_family_prefill_and_decode_match_jax(moe_model):
    """Prefill under the planner's plan and two decode steps: logits and
    every cache leaf ({"k", "v"} for grok, the latent {"c", "k_rope"} for
    deepseek) within 1e-4, at the default MoE capacity."""
    cfg, jcfg, params, port, tokens = moe_model
    S = tokens.shape[1]
    jlogits, jcache = jT.prefill(params, jcfg,
                                 {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 max_len=32, plan=jplan_model(jcfg, seq_len=S))
    logits, cache = port.prefill({"tokens": torch.as_tensor(tokens)}, 32,
                                 plan=plan_model(cfg, seq_len=S))
    _close(logits, jlogits)
    assert set(cache["layers"]) == set(jcache["layers"])
    rng = np.random.default_rng(3)
    for _ in range(2):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1))
        jlogits, jcache = jT.decode_step(params, jcfg, jcache,
                                         jnp.asarray(nxt, jnp.int32))
        logits, cache = port.decode_step(cache, torch.as_tensor(nxt))
        _close(logits, jlogits)
    for side, buf in cache["layers"].items():
        assert buf.shape[0] == cfg.num_layers
        _close(buf, jcache["layers"][side])
    assert cache["len"] == int(jcache["len"]) == S + 2


def test_moe_family_prefill_then_decode_equals_forward(moe_model):
    """With nothing dropped (moe_capacity=100, as tests/test_archs.py):
    prefill(S - 1) then one decode step gives the forward's last logits."""
    cfg, _, _, port, tokens = moe_model
    S = tokens.shape[1]
    with runtime.flags(moe_capacity=100.0):
        full = port({"tokens": torch.as_tensor(tokens)})
        _, cache = port.prefill({"tokens": torch.as_tensor(tokens[:, :S - 1])},
                                32)
        step, _ = port.decode_step(cache, torch.as_tensor(tokens[:, S - 1:]))
    _close(step[:, 0], full[:, -1])


def test_moe_family_convert_and_own_init(moe_model):
    """Every leaf of the JAX tree maps onto a parameter (deepseek: the
    dense prefix, the expert stacks (E, d, f), the shared expert, the MLA
    tree); the port's own init has the same names and shapes, and draws
    mtp_proj (2d, d) when mtp_depth is set (deepseek-v3's full config;
    its smoke config has none)."""
    cfg, _, params, port, _ = moe_model
    flat = port.state_dict()
    if cfg.first_dense_layers:
        assert len(port.dense_layers) == cfg.first_dense_layers
        np.testing.assert_array_equal(
            flat["dense_layers.0.attn.wkv_a"].numpy(),
            np.asarray(params["dense_layers"]["attn"]["wkv_a"][0]))
        np.testing.assert_array_equal(
            flat["layers.0.moe.shared.w_down"].numpy(),
            np.asarray(params["layers"]["moe"]["shared"]["w_down"][0]))
    assert ("mtp_proj" in flat) == bool(cfg.mtp_depth)
    assert len(port.blocks) == cfg.num_layers
    np.testing.assert_array_equal(
        flat["layers.0.moe.w_gate"].numpy(),
        np.asarray(params["layers"]["moe"]["w_gate"][0]))
    assert flat["layers.0.moe.w_down"].shape == (
        cfg.num_experts, cfg.moe_d_ff, cfg.d_model)
    own = T.Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    assert {k: v.shape for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in flat.items()}
    mtp = T.Transformer(dataclasses.replace(cfg, mtp_depth=1), device="cpu")
    assert mtp.mtp_proj.shape == (2 * cfg.d_model, cfg.d_model)
