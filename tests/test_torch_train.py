"""The port's training path against the JAX package's: the optimizer, the
loss and gradients of one train step on qwen3-smoke and vilbert-smoke (f32,
weights carried across by ``convert``) in the three execution modes, the
data sources bitwise, and the loop's behaviour (loss falls, exact resume
after a crash, partial checkpoint writes ignored; tests/test_system.py:38,
:46, :82, :133).  Everything runs on the CPU, through the kernels' plain
versions."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.types import ExecutionMode as JMode
from repro.core.types import ShapeConfig as JShape
from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.data.pipeline import TextCorpus as JTextCorpus
from repro.train import optimizer as JOPT
from repro.train import steps as JST
from repro_torch.configs import registry
from repro_torch.convert import transformer_from_jax, vilbert_from_jax
from repro_torch.core.types import ExecutionMode, ShapeConfig
from repro_torch.data.pipeline import ShardedLoader, SyntheticLM, TextCorpus
from repro_torch.launch import train as launcher
from repro_torch.train import loop as L
from repro_torch.train import optimizer as OPT
from repro_torch.train import steps as ST
from repro_torch.train.checkpoint import Checkpointer

SHAPE = ShapeConfig("sys", seq_len=64, global_batch=4, kind="train")
MODES = [m.value for m in ExecutionMode]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_scaled(name, got, want, tol):
    """max |got - want| <= tol * max |want|: a tensor's gradients sum many
    f32 terms, in another order in each package, so their error scales
    with the tensor's largest value."""
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{name}: max |diff| {err:.2e} of max |value|"


# ------------------------------- optimizer --------------------------------

def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "k": rng.standard_normal((3, 2, 4)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.05, 3.0, 0.5)]
    return params, grads


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_apply_matches_jax(warmup):
    """Three AdamW steps (the second clipped) against the JAX optimizer:
    params, moments, grad norm and lr at 1e-6."""
    cfg = dict(learning_rate=1e-2, warmup_steps=warmup, decay_steps=5)
    params, grads = _opt_inputs(warmup)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = JOPT.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = OPT.init(tp)
    for g in grads:
        jp, js, jm = JOPT.apply(JOPT.OptimizerConfig(**cfg), jp,
                                {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tm = OPT.apply(OPT.OptimizerConfig(**cfg), tp,
                               {k: torch.from_numpy(v) for k, v in g.items()},
                               ts)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        _close(tm["lr"], jm["lr"], 1e-6)
        for k in params:
            _close(tp[k], jp[k], 1e-6)
            _close(ts.mu[k], js.mu[k], 1e-6)
            _close(ts.nu[k], js.nu[k], 1e-6)
    assert ts.step == int(js.step) == 3


def test_optimizer_decays_a_stacked_layers_vectors_as_jax():
    """A repair: JAX decays by the ndim of its stacked leaf, so a layer's
    norm weight (L, D) in a stack is decayed while the final norm (D,) is
    not; the port's per-layer (D,) tensor follows the stacked leaf
    (1e-6 after three steps)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 8)).astype(np.float32) + 1.0
    f = rng.standard_normal(8).astype(np.float32) + 1.0
    gs = [(rng.standard_normal((2, 8)).astype(np.float32) * 0.1,
           rng.standard_normal(8).astype(np.float32) * 0.1) for _ in range(3)]
    cfg = dict(learning_rate=1e-2, warmup_steps=0, weight_decay=0.5)
    jp = {"layers": {"ln1": {"weight": jnp.asarray(w)}},
          "final_norm": {"weight": jnp.asarray(f)}}
    js = JOPT.init(jp)
    names = ("layers.0.ln1.weight", "layers.1.ln1.weight",
             "final_norm.weight")
    tp = dict(zip(names, (torch.from_numpy(w[0].copy()),
                          torch.from_numpy(w[1].copy()),
                          torch.from_numpy(f.copy()))))
    ts = OPT.init(tp)
    for gw, gf in gs:
        jp, js, _ = JOPT.apply(JOPT.OptimizerConfig(**cfg), jp, {
            "layers": {"ln1": {"weight": jnp.asarray(gw)}},
            "final_norm": {"weight": jnp.asarray(gf)}}, js)
        tp, ts, _ = OPT.apply(OPT.OptimizerConfig(**cfg), tp, dict(zip(
            names, (torch.from_numpy(gw[0]), torch.from_numpy(gw[1]),
                    torch.from_numpy(gf)))), ts)
    for i in (0, 1):
        _close(tp[names[i]], jp["layers"]["ln1"]["weight"][i], 1e-6)
    _close(tp["final_norm.weight"], jp["final_norm"]["weight"], 1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 5000, 10_000, 20_000])
def test_lr_schedule_matches_jax(step):
    cfg = dict(warmup_steps=100, decay_steps=10_000)
    _close(OPT.lr_at(OPT.OptimizerConfig(**cfg), step),
           JOPT.lr_at(JOPT.OptimizerConfig(**cfg), jnp.asarray(step)), 1e-6)


def test_optimizer_keeps_bf16_params_and_f32_moments():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16),
         "g": torch.ones(4, dtype=torch.bfloat16)}
    st = OPT.init(p)
    p, st, _ = OPT.apply(OPT.OptimizerConfig(learning_rate=0.05,
                                             warmup_steps=0), p,
                         {k: torch.full_like(v, 0.1) for k, v in p.items()},
                         st)
    assert p["w"].dtype == torch.bfloat16 and st.mu["w"].dtype == torch.float32
    # decoupled weight decay on the matrix only
    assert p["w"][0, 0].item() < p["g"][0].item()


# --------------------------- one train step vs JAX ------------------------

def _models(arch):
    jcfg = jreg.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    jmod = jreg.model_module(jcfg)
    params = jmod.init(jax.random.PRNGKey(0), jcfg)
    conv = vilbert_from_jax if arch.startswith("vilbert") else \
        transformer_from_jax
    return jcfg, cfg, jmod, params, conv


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["qwen3-32b", "vilbert-base"])
def test_train_step_matches_jax(arch, mode):
    """Loss (1e-5) and gradients (2e-4 of each tensor's largest value; the
    JAX gradient of every attention parameter is non-zero) of one step,
    then the parameters after ``make_train_step``'s update
    (2e-4), against the JAX step."""
    jcfg, cfg, jmod, params, conv = _models(arch)
    shape = ShapeConfig("t", 32, 2, "train")
    batch = SyntheticLM(cfg, shape, seed=1).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmode = JMode(mode)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss_fn(p, jcfg, b, mode=jmode, remat=True)))(
            params, jbatch)

    np_tree = jax.tree.map(np.asarray, params)
    model = conv(np_tree, cfg, device="cpu").requires_grad_(True)
    tbatch = L.to_device(batch, cfg, torch.device("cpu"))
    mod = registry.model_module(cfg)
    named = dict(model.named_parameters())
    loss = mod.loss_fn(model, tbatch, mode=ExecutionMode(mode), remat=True)
    grads = torch.autograd.grad(loss, list(named.values()))
    _close(loss.item(), float(loss_j), 1e-5)
    want = dict(conv(jax.tree.map(np.asarray, grads_j), cfg,
                     device="cpu").named_parameters())
    # the loss reaches every attention layer, so the limit bites there
    attn = [n for n in want if "attn." in n]
    assert attn and all(bool(want[n].any()) for n in attn)
    for (name, g) in zip(named, grads):
        _close_scaled(name, g.detach(), want[name].detach(), 2e-4)

    ocfg = dict(learning_rate=1e-3, warmup_steps=1)
    jnew, _, jm = JST.make_train_step(jcfg, JOPT.OptimizerConfig(**ocfg),
                                      mode=jmode)(params, JOPT.init(params),
                                                  jbatch)
    step = ST.make_train_step(cfg, OPT.OptimizerConfig(**ocfg),
                              mode=ExecutionMode(mode))
    _, state, m = step(model, OPT.init(named), tbatch)
    _close(m["loss"], float(jm["loss"]), 1e-5)
    _close(m["grad_norm"], float(jm["grad_norm"]), 2e-4)
    assert state.step == 1
    after = dict(conv(jax.tree.map(np.asarray, jnew), cfg,
                      device="cpu").named_parameters())
    for name, p in model.named_parameters():
        _close(p.detach(), after[name].detach(), 2e-4)


def test_grad_accumulation_matches_full_batch():
    """microbatches=2 equals the full batch (test_system.py:133)."""
    cfg = registry.get_config("qwen3-32b", smoke=True)
    batch = L.to_device(SyntheticLM(cfg, SHAPE, seed=4).batch(0), cfg,
                        torch.device("cpu"))
    ocfg = OPT.OptimizerConfig(learning_rate=1e-3, warmup_steps=1)
    out = []
    for mb in (1, 2):
        model = L.build_model(cfg, torch.device("cpu"), 0)
        _, _, m = ST.make_train_step(cfg, ocfg, microbatches=mb)(
            model, OPT.init(dict(model.named_parameters())), batch)
        out.append((m["loss"], dict(model.named_parameters())))
    assert abs(out[0][0] - out[1][0]) < 1e-3
    for name, p in out[0][1].items():
        _close(p.detach(), out[1][1][name].detach(), 5e-4)


def test_remat_leaves_the_gradients_unchanged():
    cfg = registry.get_config("qwen3-32b", smoke=True)
    model = L.build_model(cfg, torch.device("cpu"), 0)
    batch = L.to_device(SyntheticLM(cfg, SHAPE, seed=2).batch(0), cfg,
                        torch.device("cpu"))
    params = list(model.parameters())
    mod = registry.model_module(cfg)
    g1 = torch.autograd.grad(mod.loss_fn(model, batch, remat=True), params)
    g0 = torch.autograd.grad(mod.loss_fn(model, batch, remat=False), params)
    for a, b in zip(g1, g0):
        _close(a, b, 1e-6)


# ---------------------------------- data ----------------------------------

@pytest.mark.parametrize("step", [0, 5, 17])
@pytest.mark.parametrize("arch", ["qwen3-32b", "vilbert-base"])
def test_synthetic_batches_equal_the_jax_ones(arch, step):
    cfg = registry.get_config(arch, smoke=True)
    got = SyntheticLM(cfg, SHAPE, seed=3).batch(step)
    want = JSynthetic(jreg.get_config(arch, smoke=True),
                      JShape("sys", 64, 4, "train"), seed=3).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("as_dir", [False, True])
def test_text_corpus_batches_equal_the_jax_ones(tmp_path, as_dir):
    p = tmp_path / "corpus.txt"
    p.write_text("hello world, this is a tiny corpus for packing tests. " * 50)
    (tmp_path / "more.txt").write_text("a second file " * 40)
    path = str(tmp_path if as_dir else p)
    cfg = registry.get_config("qwen3-32b", smoke=True)
    src = TextCorpus(cfg, SHAPE, path, seed=2)
    ref = JTextCorpus(jreg.get_config("qwen3-32b", smoke=True),
                      JShape("sys", 64, 4, "train"), path, seed=2)
    for step in (0, 3):
        b, w = src.batch(step), ref.batch(step)
        np.testing.assert_array_equal(b["tokens"], w["tokens"])
        np.testing.assert_array_equal(b["labels"], w["labels"])
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_sharded_loader_yields_the_stream_in_order():
    cfg = registry.get_config("qwen3-32b", smoke=True)
    src = SyntheticLM(cfg, SHAPE, seed=1)
    loader = ShardedLoader(src, start_step=3, host_count=2, host_id=1)
    try:
        for step in (3, 4, 5):
            got = next(loader)
            np.testing.assert_array_equal(got["tokens"],
                                          src.batch(step)["tokens"][2:])
        assert loader.step == 6
    finally:
        loader.close()


# ---------------------------------- loop ----------------------------------

def _train(cfg, steps, ckpt_dir=None, log_every=None):
    src = SyntheticLM(cfg, SHAPE, seed=0)
    tcfg = L.TrainConfig(steps=steps,
                         log_every=log_every or max(steps // 2, 1),
                         checkpoint_every=max(steps // 2, 1),
                         checkpoint_dir=ckpt_dir,
                         opt=OPT.OptimizerConfig(learning_rate=1e-3,
                                                 warmup_steps=5,
                                                 decay_steps=200))
    return L.train(cfg, SHAPE, src, tcfg, device="cpu")


def test_training_reduces_loss():
    """test_system.py:38: the cross-entropy falls well below its start."""
    out = _train(registry.get_config("qwen3-32b", smoke=True), steps=30,
                 log_every=2)
    hist = out["metrics"]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3, hist


def test_checkpoint_restart_exact_resume(tmp_path):
    """test_system.py:46: a crash after step 10 and a restart end where an
    uninterrupted 20-step run does (the reference's 2e-5; the CPU's
    embedding-gradient scatter is not bitwise reproducible)."""
    cfg = registry.get_config("starcoder2-7b", smoke=True)
    full = _train(cfg, steps=20, ckpt_dir=str(tmp_path / "a"))
    _train(cfg, steps=10, ckpt_dir=str(tmp_path / "b"))
    resumed = _train(cfg, steps=20, ckpt_dir=str(tmp_path / "b"))
    assert resumed["opt_state"].step == full["opt_state"].step == 20
    want = dict(full["model"].named_parameters())
    for name, p in resumed["model"].named_parameters():
        _close(p.detach(), want[name].detach(), 2e-5)
    for name, m in resumed["opt_state"].mu.items():
        _close(m, full["opt_state"].mu[name], 2e-5)


def test_gradients_are_bitwise_reproducible_on_the_cpu():
    """A repair: the embedding's gradient summed a row's tokens in another
    order from call to call (an index's accumulating scatter), which made
    the restart test above fail now and then; eight gradients of one batch
    are bitwise equal."""
    cfg = registry.get_config("starcoder2-7b", smoke=True)
    shape = ShapeConfig("det", 64, 4, "train")
    batch = L.to_device(SyntheticLM(cfg, shape, seed=0).batch(0), cfg,
                        torch.device("cpu"))
    model = L.build_model(cfg, torch.device("cpu"), 0)
    params = dict(model.named_parameters())
    first = None
    for _ in range(8):
        _, grads = ST.make_loss_and_grads(cfg)(model, params, batch)
        if first is None:
            first = grads
        for a, b in zip(first, grads):
            assert torch.equal(a, b)


def test_checkpoint_atomicity_partial_write_ignored(tmp_path):
    """test_system.py:82: a crashed write (a leftover .tmp) is skipped."""
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"p": {"w": torch.ones(3)}})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step() == 5


def test_checkpoint_roundtrip_keeps_dtypes_and_bits(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"params": {"a": torch.randn(3, 4).bfloat16(),
                       "b": torch.randn(5)},
            "opt": {"step": 7, "mu": {"a": torch.randn(3, 4)}}}
    ck.save_async(7, tree)
    ck.wait()
    for s in (8, 9):
        ck.save(s, tree)
    assert ck.all_steps() == [8, 9]              # keep=2 dropped step 7
    target = {"params": {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                         "b": torch.zeros(5)},
              "opt": {"step": 0, "mu": {"a": torch.zeros(3, 4)}}}
    got = ck.restore(9, target)
    assert got["opt"]["step"] == 7
    assert got["params"]["a"] is target["params"]["a"]
    for path in (("params", "a"), ("params", "b"), ("opt", "mu", "a")):
        g, w = got, tree
        for k in path:
            g, w = g[k], w[k]
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_launcher_trains_on_the_cpu_when_asked(capsys):
    out = launcher.main(["--arch", "qwen3-32b", "--smoke", "--steps", "2",
                         "--seq-len", "16", "--global-batch", "2",
                         "--layers", "1", "--device", "cpu"])
    assert len(out["model"].layers) == 1
    assert [m["step"] for m in out["metrics"]] == [1, 2]
    assert "step      2  loss" in capsys.readouterr().out


def test_train_refuses_a_mesh():
    """Training on a mesh is ported (tests/test_torch_mesh.py); a mesh that
    is not a DeviceMesh of the run's device is refused."""
    import types
    cfg = registry.get_config("qwen3-32b", smoke=True)
    for mesh in (object(), types.SimpleNamespace(device_type="cuda")):
        with pytest.raises(ValueError, match="not a DeviceMesh of cpu"):
            L.train(cfg, SHAPE, SyntheticLM(cfg, SHAPE),
                    L.TrainConfig(steps=1), device="cpu", mesh=mesh)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-2b"])
def test_build_model_builds_the_formerly_serving_only_families(arch):
    """The encoder-decoder and VLM families train (they were served only
    before their backward paths were ported)."""
    model = L.build_model(registry.get_config(arch, smoke=True),
                          torch.device("cpu"), 0)
    want = "EncDec" if arch == "whisper-base" else "Transformer"
    assert type(model).__name__ == want
    assert all(p.requires_grad for p in model.parameters())


def test_train_refuses_batches_that_do_not_fit_the_shape():
    cfg = registry.get_config("qwen3-32b", smoke=True)
    other = ShapeConfig("other", seq_len=32, global_batch=4, kind="train")
    with pytest.raises(ValueError, match="does not fit"):
        L.train(cfg, SHAPE, SyntheticLM(cfg, other), L.TrainConfig(steps=1),
                device="cpu")
    assert registry.input_specs(cfg, SHAPE) == {"tokens": (4, 64),
                                                "labels": (4, 64)}
    vil = registry.get_config("vilbert-base", smoke=True)
    assert registry.input_specs(vil, SHAPE) == {
        "regions": (4, 64, vil.d_model), "tokens": (4, 64), "answers": (4,)}
