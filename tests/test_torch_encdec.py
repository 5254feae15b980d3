"""The port's encoder-decoder against ``repro.models.encdec`` on
whisper-smoke (f32): JAX parameters converted with
``convert.encdec_from_jax``, the same numpy frames and tokens; ``encode``,
``decode_train``, ``forward``, ``loss_fn``, ``prefill`` and three
``decode_step``s within 1e-4 in each execution mode, caches within 1e-4;
prefill(S) + one decode step equals the teacher-forced decoder at S + 1;
the data pipeline's frames are bitwise those of the JAX pipeline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.core.types import ShapeConfig as JShape
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import encdec as jE
from repro_torch.configs.registry import get_config, input_specs, model_module
from repro_torch.convert import encdec_from_jax
from repro_torch.core.types import ExecutionMode, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.plan import plan_decode_step

TOL = 1e-4
MODES = list(ExecutionMode)
B, S, MAX_LEN = 2, 7, 16


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("whisper-base", smoke=True)
    jcfg = jregistry.get_config("whisper-base", smoke=True)
    params = jE.init(jax.random.PRNGKey(0), jcfg)
    model = encdec_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    frames = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
              * 0.1).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 3))
    return cfg, jcfg, params, model, frames, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _jbatch(frames, tokens):
    return {"frames": jnp.asarray(frames),
            "tokens": jnp.asarray(tokens, jnp.int32)}


def _batch(frames, tokens):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.as_tensor(tokens)}


@pytest.mark.parametrize("mode", MODES)
def test_encode_matches_jax(smoke, mode):
    cfg, jcfg, params, model, frames, _ = smoke
    want = jE.encode(params, jcfg, jnp.asarray(frames), mode=JMode(mode.value))
    got = model.encode(torch.from_numpy(frames), mode=mode)
    assert got.shape == (B, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_decode_train_matches_jax(smoke, mode):
    """The teacher-forced decoder alone, both sides given the same encoder
    states."""
    _, jcfg, params, model, frames, tokens = smoke
    enc = np.array(jE.encode(params, jcfg, jnp.asarray(frames)))
    want = jE.decode_train(params, jcfg, jnp.asarray(tokens, jnp.int32),
                           jnp.asarray(enc), mode=JMode(mode.value))
    got = model.decode_train(torch.as_tensor(tokens), torch.from_numpy(enc),
                             mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_forward_and_loss_match_jax(smoke, mode):
    _, jcfg, params, model, frames, tokens = smoke
    jmode = JMode(mode.value)
    want = jE.forward(params, jcfg, _jbatch(frames, tokens), mode=jmode)
    _close(model(_batch(frames, tokens), mode=mode), want)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -2:] = -1                               # masked positions
    jb = {**_jbatch(frames, tokens), "labels": jnp.asarray(labels, jnp.int32)}
    want = jE.loss_fn(params, jcfg, jb, mode=jmode)
    with torch.no_grad():
        got = E.loss_fn(model, {**_batch(frames, tokens),
                                "labels": torch.as_tensor(labels)}, mode=mode)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(smoke, mode):
    """prefill of S prompt tokens, then three decode steps: logits and the
    self-attention caches within 1e-4 of the JAX package's."""
    _, jcfg, params, model, frames, tokens = smoke
    jlogits, jcache = jE.prefill(params, jcfg,
                                 _jbatch(frames, tokens[:, :S]),
                                 max_len=MAX_LEN, mode=JMode(mode.value))
    logits, cache = model.prefill(_batch(frames, tokens[:, :S]), MAX_LEN,
                                  mode=mode)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    _close(cache["enc"], jcache["enc"])
    for t in range(S, S + 3):
        for side in ("k", "v"):
            _close(cache["layers"][side], jcache["layers"][side])
        assert cache["len"] == int(jcache["len"]) == t
        nxt = tokens[:, t:t + 1]
        jlogits, jcache = jE.decode_step(params, jcfg, jcache,
                                         jnp.asarray(nxt, jnp.int32))
        logits, cache = model.decode_step(cache, torch.as_tensor(nxt))
        assert logits.shape == (B, 1, jlogits.shape[-1])
        _close(logits, jlogits)


def test_decode_step_equals_teacher_forcing(smoke):
    """prefill(S) then one decode step gives the last row of the
    teacher-forced decoder at S + 1 (the relation of
    tests/test_archs.py:49-73), in the port alone."""
    _, _, _, model, frames, tokens = smoke
    full = model(_batch(frames, tokens[:, :S + 1]))
    _, cache = model.prefill(_batch(frames, tokens[:, :S]), MAX_LEN)
    logits, _ = model.decode_step(cache, torch.as_tensor(tokens[:, S:S + 1]))
    _close(logits[:, 0], full[:, -1])


def test_decode_runs_cross_attention_in_tile_stream(smoke, monkeypatch):
    """Whatever the prefill's mode, decode's cross-attention is requested
    in TILE_STREAM and reaches the stream path; self-attention goes
    through the batched decode entry under the step's DecodePlan."""
    cfg, _, _, model, frames, tokens = smoke
    _, cache = model.prefill(_batch(frames, tokens[:, :S]), MAX_LEN,
                             mode=ExecutionMode.NON_STREAM)
    modes, blocks = [], []
    real_mode, real_decode = ops.attention_by_mode, \
        ops.batched_decode_attention_by_plan

    def by_mode(mode, *args, **kw):
        modes.append(mode)
        return real_mode(mode, *args, **kw)

    def decode(lp, *args, **kw):
        blocks.append((lp.layer_index, lp.name, lp.block_kv))
        return real_decode(lp, *args, **kw)

    monkeypatch.setattr(ops, "attention_by_mode", by_mode)
    monkeypatch.setattr(ops, "batched_decode_attention_by_plan", decode)
    dp = plan_decode_step(cfg, (S + 1,) * B, block_kv=8)
    model.decode_step(cache, torch.as_tensor(tokens[:, S:S + 1]), plan=dp)
    assert modes == [ExecutionMode.TILE_STREAM] * cfg.num_layers
    assert blocks == [(i, f"dec{i}_self.decode", 8)
                      for i in range(cfg.num_layers)]


def test_prefill_refuses_a_prompt_longer_than_the_cache(smoke):
    _, _, _, model, frames, tokens = smoke
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(_batch(frames, tokens), 4)


def test_convert_maps_every_parameter(smoke):
    cfg, _, params, model, _, _ = smoke
    flat = model.state_dict()
    assert "embed.unembed" not in flat and "dec_pos" in flat
    assert len(model.enc_layers) == cfg.num_encoder_layers
    np.testing.assert_array_equal(
        flat["dec_layers.1.cross_attn.wk"].numpy(),
        np.asarray(params["dec_layers"]["cross_attn"]["wk"][1]))
    np.testing.assert_array_equal(
        flat["enc_layers.0.mlp.w_down"].numpy(),
        np.asarray(params["enc_layers"]["mlp"]["w_down"][0]))
    bad = jax.tree.map(np.asarray, params)
    del bad["enc_ln"]
    with pytest.raises(KeyError, match="enc_ln"):
        encdec_from_jax(bad, cfg, device="cpu")


def test_own_init_has_jax_shapes_and_scales(smoke):
    cfg, _, _, model, _, _ = smoke
    own = E.EncDec(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3)).state_dict()
    ref = model.state_dict()
    assert own.keys() == ref.keys()
    for name, t in own.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype
        if t.numel() >= 4096:
            ratio = t.float().std().item() / ref[name].float().std().item()
            assert 0.9 < ratio < 1.1, name


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthetic_frames_equal_jax_bitwise(kind):
    cfg = get_config("whisper-base", smoke=True)
    jcfg = jregistry.get_config("whisper-base", smoke=True)
    shape = ShapeConfig("s", 12, 3, kind)
    got = SyntheticLM(cfg, shape, seed=5).batch(2)
    want = JSyntheticLM(jcfg, JShape("s", 12, 3, kind), seed=5).batch(2)
    assert got.keys() == want.keys() >= {"frames", "tokens"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    specs = input_specs(cfg, shape)
    assert specs["frames"] == got["frames"].shape == (3, 48, 64)
    assert ("labels" in specs) == (kind == "train")


def test_registry_gives_the_encdec_module():
    cfg = get_config("whisper-base")
    assert model_module(cfg) is E
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.encoder_seq,
            cfg.d_model, cfg.vocab_size) == (6, 6, 1500, 512, 51865)
    big = dataclasses.replace(cfg, num_layers=1, num_encoder_layers=1)
    assert model_module(big) is E


def test_entry_points_need_a_named_device_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.EncDec(get_config("whisper-base", smoke=True))


def test_layer_norm_matches_jax():
    from repro.models import layers as jL
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ln = L.LayerNorm(64, torch.float32, torch.device("cpu"))
    ln.gamma.copy_(torch.from_numpy(rng.standard_normal(64).astype(
        np.float32)))
    ln.beta.copy_(torch.from_numpy(rng.standard_normal(64).astype(
        np.float32)))
    _close(L.layer_norm(ln, torch.from_numpy(x), eps=1e-6),
           jL.layer_norm({"gamma": ln.gamma.numpy(), "beta": ln.beta.numpy()},
                         x, eps=1e-6), 1e-6)
