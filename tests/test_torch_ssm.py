"""The port's SSM and hybrid families against ``repro.models.transformer``
on mamba2-smoke and hymba-smoke (f32): JAX parameters converted with
``convert.transformer_from_jax``, the same numpy tokens.  Forward logits,
prefill logits and the filled cache (conv history, SSD state and, for
hymba, the K/V ring: the prompt is longer than its window of 16) within
1e-4; decode-step logits within 2e-3 (tests/test_serve.py); prefill(S)
then one decode step equals prefill(S + 1); the port's ``Engine`` emits
the JAX ``Engine``'s greedy tokens and ``stats()`` on both (per-slot
decode: the paged pool does not take these caches)."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro_torch.configs.registry import get_config, model_module
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import ExecutionMode, Family
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, Request

TOL = 1e-4
DECODE_TOL = 2e-3
ARCHS = ["mamba2-780m", "hymba-1.5b"]
PROMPT = 21                  # > hymba-smoke's window: the ring wraps
MAX_LEN = 32


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, smoke=True)
    jcfg = jregistry.get_config(request.param, smoke=True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (2, PROMPT))
    return cfg, jcfg, params, port, tokens


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _close_caches(cache, jcache):
    got, want = _flat(cache["layers"]), _flat(jcache["layers"])
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        _close(got[name], want[name])
    assert cache["len"] == int(jcache["len"])


def test_prefill_and_decode_match_jax(model):
    cfg, jcfg, params, port, tokens = model
    jlogits, jcache = jT.prefill(params, jcfg,
                                 {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 max_len=MAX_LEN)
    logits, cache = port.prefill({"tokens": torch.as_tensor(tokens)},
                                 MAX_LEN)
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    _close(logits, jlogits)
    _close_caches(cache, jcache)
    if cfg.family == Family.HYBRID:
        W = cache["layers"]["attn"]["k"].shape[3]
        assert W == cfg.sliding_window < PROMPT
    rng = np.random.default_rng(1)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1))
        jlogits, jcache = jT.decode_step(params, jcfg, jcache,
                                         jnp.asarray(nxt, jnp.int32))
        logits, cache = port.decode_step(cache, torch.as_tensor(nxt))
        _close(logits, jlogits, DECODE_TOL)
        _close_caches(cache, jcache)
    assert cache["len"] == PROMPT + 3


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_forward_matches_jax(model, mode):
    _, jcfg, params, port, tokens = model
    want = jT.forward(params, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)},
                      mode=JMode(mode.value))
    _close(port({"tokens": torch.as_tensor(tokens)}, mode=mode), want)


def test_prefill_then_decode_equals_longer_prefill(model):
    """The final SSD state, the conv history and the ring carry exactly
    what the next position needs."""
    cfg, _, _, port, tokens = model
    full = torch.as_tensor(tokens)
    want, _ = port.prefill({"tokens": full}, MAX_LEN)
    _, cache = port.prefill({"tokens": full[:, :-1]}, MAX_LEN)
    got, cache = port.decode_step(cache, full[:, -1:])
    _close(got[:, 0], want[:, -1])
    assert cache["len"] == PROMPT


def test_ssm_pieces_match_jax(model):
    cfg, jcfg, params, port, _ = model
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        got = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             None if state is None else torch.from_numpy(state))
        want = jssm._causal_conv(x, w, state)
        for g, wt in zip(got, want):
            _close(g, wt, 1e-6)
    assert S.ssm_dims(cfg) == jssm.ssm_dims(jcfg)
    h = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda t: t[0], params["layers"]["ssm"])
    _close(S.ssm_forward(port.layers[0].ssm, cfg, torch.from_numpy(h)),
           jssm.ssm_forward(lp, jcfg, h))


def test_convert_maps_every_parameter(model):
    cfg, _, params, port, _ = model
    flat = port.state_dict()
    np.testing.assert_array_equal(
        flat["layers.1.ssm.in_proj"].numpy(),
        np.asarray(params["layers"]["ssm"]["in_proj"][1]))
    if cfg.family == Family.HYBRID:
        np.testing.assert_array_equal(
            flat["layers.0.mix_beta"].numpy(),
            np.asarray(params["layers"]["mix_beta"][0]))
    bad = jax.tree.map(np.asarray, params)
    del bad["layers"]["ssm"]["a_log"]
    with pytest.raises(KeyError, match="a_log"):
        transformer_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, params)
    bad["layers"]["ssm"]["conv_w"] = bad["layers"]["ssm"]["conv_w"][:, 1:]
    with pytest.raises(ValueError, match="conv_w"):
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
        elif name.endswith(("a_log", "dt_bias", "d_skip", "mix_beta")):
            assert torch.equal(t, ref[name]), name


def test_ring_prefill_ignores_max_len_dense_does_not(model):
    cfg, _, _, port, tokens = model
    long = torch.as_tensor(tokens[:, :12])
    logits, cache = port.prefill({"tokens": long}, 8)      # S > max_len
    want, _ = port.prefill({"tokens": long}, MAX_LEN)
    _close(logits, want)
    if cfg.family == Family.HYBRID:
        assert cache["layers"]["attn"]["k"].shape[3] == 8
    dense = T.Transformer(get_config("qwen3-32b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        dense.prefill({"tokens": long}, 8)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _requests(cls, cfg):
    """tests/test_torch_serve.py's mix, three requests of 3-9 tokens."""
    rng = np.random.default_rng(3)
    return [cls(rid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=(int(rng.integers(3, 10)),)
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 5)),
                arrival_step=int(rng.integers(0, 2)))
            for i in range(3)]


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 0.25


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.rid: list(r.out_tokens) for r in engine.run()}


def test_engine_matches_jax_engine(model):
    cfg, jcfg, params, port, _ = model
    jeng = jengine.Engine(jcfg, params, slots=2, max_len=MAX_LEN,
                          clock=_clock())
    jtokens = _run(jeng, _requests(jengine.Request, jcfg))
    before = ssd_scan.launches
    eng = Engine(cfg, port, slots=2, max_len=MAX_LEN, clock=_clock())
    assert _run(eng, _requests(Request, cfg)) == jtokens
    assert ssd_scan.launches == before          # CPU: the plain version
    assert eng.stats() == jeng.stats()
    assert eng._pool is None and jeng._pool is None
    assert eng.decode_batches == eng.decode_calls == jeng.decode_calls
    assert eng.decode_calls == sum(eng.last_schedule.decode_steps.values())
    assert all(r.buckets is None for r in eng.step_log)
    assert [dataclasses.asdict(r) for r in eng.step_log] == \
        [dataclasses.asdict(r) for r in jeng.step_log]
    assert (eng.plan_for(5) is None) == (cfg.family == Family.SSM)


def test_registry_dispatches_the_families():
    for arch in ARCHS:
        assert model_module(get_config(arch)) is T
        assert get_config(arch).name == arch
