"""One train step of the SSM, hybrid, VLM, encoder-decoder, MoE and MLA
families, and of the dense sliding-window decoder (h2o-danube3-4b, whose
smoke window of 16 keys the 32-token batch runs past) and minitron-4b,
against the JAX package's: the loss, every parameter's gradient
and the parameters after ``make_train_step``'s update, on each family's
smoke config in f32 (weights carried across by ``convert``), at
tests/test_torch_train.py's tolerances.  Each family runs in the modes
that change what runs: the SSM has no attention, the VLM's M-RoPE path and
MLA take flash in every mode.  Everything runs on the CPU, through the
kernels' plain versions (the SSD scan's backward included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.types import ExecutionMode as JMode
from repro.train import optimizer as JOPT
from repro.train import steps as JST
from repro_torch.configs import registry
from repro_torch.convert import encdec_from_jax, transformer_from_jax
from repro_torch.core.types import ExecutionMode, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as launcher
from repro_torch.train import loop as L
from repro_torch.train import optimizer as OPT
from repro_torch.train import steps as ST

RUNS = [("mamba2-780m", "tile_stream"),
        ("hymba-1.5b", "tile_stream"), ("hymba-1.5b", "layer_stream"),
        ("qwen2-vl-2b", "tile_stream"),
        ("whisper-base", "non_stream"), ("whisper-base", "layer_stream"),
        ("whisper-base", "tile_stream"),
        ("grok-1-314b", "tile_stream"),
        ("deepseek-v3-671b", "tile_stream"),
        ("h2o-danube3-4b", "non_stream"), ("h2o-danube3-4b", "layer_stream"),
        ("h2o-danube3-4b", "tile_stream"),
        ("minitron-4b", "tile_stream")]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _close_scaled(name, got, want, tol):
    """max |got - want| <= tol * max |want| (tests/test_torch_train.py)."""
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{name}: max |diff| {err:.2e} of max |value|"


def _grid_positions(B, S):
    """qwen2-vl's M-RoPE streams for a 4 x 4 image after 8 text tokens:
    t/h/w differ on the image (registry.input_specs' (3, B, S))."""
    pos = np.zeros((3, S), np.int32)
    pos[:, :8] = np.arange(8)
    hh, ww = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    pos[0, 8:24] = 8
    pos[1, 8:24] = 8 + hh.ravel()
    pos[2, 8:24] = 8 + ww.ravel()
    pos[:, 24:] = 12 + np.arange(S - 24)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))


@pytest.mark.parametrize("arch,mode", RUNS)
def test_family_train_step_matches_jax(arch, mode):
    """Loss (1e-5) and gradients (2e-4 of each tensor's largest value) of
    one step, then the parameters after the update (2e-4)."""
    jcfg = jreg.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    jmod = jreg.model_module(jcfg)
    params = jmod.init(jax.random.PRNGKey(0), jcfg)
    conv = encdec_from_jax if arch == "whisper-base" else transformer_from_jax
    batch = SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"),
                        seed=1).batch(0)
    if "positions" in batch:
        batch["positions"] = _grid_positions(2, 32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmode = JMode(mode)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss_fn(p, jcfg, b, mode=jmode, remat=True)))(
            params, jbatch)

    model = conv(jax.tree.map(np.asarray, params), cfg,
                 device="cpu").requires_grad_(True)
    tbatch = L.to_device(batch, cfg, torch.device("cpu"))
    mod = registry.model_module(cfg)
    named = dict(model.named_parameters())
    loss = mod.loss_fn(model, tbatch, mode=ExecutionMode(mode), remat=True)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    _close(loss.item(), float(loss_j), 1e-5)
    want = dict(conv(jax.tree.map(np.asarray, grads_j), cfg,
                     device="cpu").named_parameters())
    for name, g in zip(named, grads):
        w = want[name].detach()
        if g is None:
            assert not bool(w.any()), f"{name}: no gradient here, one in JAX"
            continue
        _close_scaled(name, g.detach(), w, 2e-4)

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


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "qwen2-vl-2b",
                                  "whisper-base", "grok-1-314b",
                                  "deepseek-v3-671b", "vilbert-large",
                                  "minitron-4b", "starcoder2-7b",
                                  "h2o-danube3-4b"])
def test_launcher_trains_each_family_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --smoke
    --device cpu`` builds the family's model and runs its steps."""
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "2",
                         "--seq-len", "16", "--global-batch", "2",
                         "--device", "cpu"])
    assert [m["step"] for m in out["metrics"]] == [1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in out["metrics"])
    assert all(p.requires_grad for p in out["model"].parameters())
    assert "step      2  loss" in capsys.readouterr().out
