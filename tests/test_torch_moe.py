"""The port's MoE layer against ``repro.models.layers.moe_forward`` on
grok1-smoke (4 experts top-2, no shared expert, act gelu: the experts are
SiLU all the same) and deepseekv3-smoke (8 experts top-2 and a shared
expert), f32: the JAX parameters carried over by ``convert``, the same
numpy inputs, within 1e-5.  At the default capacity a skewed router forces
drops; ``moe_capacity=100`` drops nothing; ``moe_groups`` 1 and 2 route
per token group.  The combine is deterministic, and the expert stacks are
drawn with the reference's fan_in = E."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import runtime as jruntime
from repro.models import layers as jL
from repro_torch.configs.registry import get_config
from repro_torch.convert import _load
from repro_torch.core import runtime
from repro_torch.models import layers as L

TOL = 1e-5
ARCHS = ["grok-1-314b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    cfg = get_config(request.param, smoke=True)
    jcfg = jregistry.get_config(request.param, smoke=True)
    params = jL.moe_init(jax.random.PRNGKey(3), jcfg)
    return cfg, jcfg, params


def _port(cfg, params):
    mod = L.MoE(cfg, torch.Generator().manual_seed(0))
    _load(mod, jax.tree.map(np.asarray, params), ())
    return mod


def _skewed(params, boost=0.25):
    """The router pushed towards expert 0 along the inputs' mean (``_x``
    has mean 0.25): nearly every token chooses it, so the default capacity
    drops some of them."""
    out = dict(params)
    out["router"] = params["router"].at[:, 0].add(boost)
    return out


def _x(cfg, B=2, S=24, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) + 0.25).astype(np.float32)


def _dropped(mod, cfg, x, groups=1, capacity=1.25):
    xt = torch.from_numpy(x).reshape(groups, -1, cfg.d_model)
    cap = L.moe_capacity(xt.shape[1], cfg, capacity)
    slot, _, _ = L.moe_route(mod, cfg, xt, cap)
    return int((slot == cfg.num_experts * cap).sum())


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity", [None, 100.0])
def test_moe_forward_matches_jax(moe, groups, capacity):
    cfg, jcfg, params = moe
    params = _skewed(params)
    mod = _port(cfg, params)
    x = _x(cfg)
    flags = {"moe_groups": groups}
    if capacity is not None:
        flags["moe_capacity"] = capacity
    with jruntime.flags(**flags):
        want = jL.moe_forward(params, jcfg, jnp.asarray(x))
    with runtime.flags(**flags):
        got = L.moe_forward(mod, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    drops = _dropped(mod, cfg, x, groups, capacity or 1.25)
    assert (drops > 0) == (capacity is None), drops


def test_moe_capacity_rule():
    cfg = get_config("deepseek-v3-671b")
    # max(int(T K / E cf), 4), padded to 4, capped at T
    assert L.moe_capacity(1024, cfg, 1.25) == 40
    assert L.moe_capacity(3, cfg, 1.25) == 3
    assert L.moe_capacity(100, cfg, 1.25) == 4
    assert L.moe_capacity(1024, cfg, 100.0) == 1024
    grok = get_config("grok-1-314b")
    assert L.moe_capacity(1024, grok, 1.25) == 320
    assert L.moe_capacity(1023, grok, 1.25) == 320


def test_moe_route_counts_positions_in_token_k_order(moe):
    """pos counts the earlier (token, k) pairs that chose the same expert;
    every kept slot is used once."""
    cfg, _, params = moe
    mod = _port(cfg, _skewed(params))
    xt = torch.from_numpy(_x(cfg)).reshape(1, -1, cfg.d_model)
    cap = L.moe_capacity(xt.shape[1], cfg, 1.25)
    slot, w, topi = L.moe_route(mod, cfg, xt, cap)
    E = cfg.num_experts
    seen = {}
    for e, s in zip(topi.reshape(-1).tolist(), slot.reshape(-1).tolist()):
        pos = seen.get(e, 0)
        seen[e] = pos + 1
        assert s == (e * cap + pos if pos < cap else E * cap)
    kept = slot[slot < E * cap]
    assert kept.unique().numel() == kept.numel()
    torch.testing.assert_close(w.sum(-1), torch.ones(w.shape[:-1]))


def test_moe_forward_is_deterministic_and_batch_shaped(moe):
    cfg, _, params = moe
    mod = _port(cfg, params)
    x = torch.from_numpy(_x(cfg, seed=1))
    a, b = L.moe_forward(mod, cfg, x), L.moe_forward(mod, cfg, x)
    assert a.shape == x.shape and torch.equal(a, b)


def test_expert_stacks_are_drawn_with_fan_in_e():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    mod = L.MoE(cfg, torch.Generator().manual_seed(1))
    E = cfg.num_experts
    for name in ("w_gate", "w_up", "w_down"):
        std = getattr(mod, name).std().item()
        assert abs(std * E ** 0.5 - 1) < 0.05, (name, std)
    assert abs(mod.router.std().item() / 0.02 - 1) < 0.1
    assert mod.shared.w_gate.shape == (cfg.d_model, cfg.moe_d_ff)
