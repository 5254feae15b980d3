"""The port's int8 projection path (``kernels/quant.py``, the paper's
precision knob) against the JAX package's on the CPU: the quantizers and
``int8_matmul`` bitwise equal in f32 and bf16, ``ops.projection`` under
``runtime.flags(quantize_proj=True)`` routed to it (and to no
``tile_gemm``), its gradient that of ``jax.grad`` (through the scales
only), the MLP and whole forwards under the flag."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro.configs import registry as jregistry
from repro.configs import vilbert_base as jvilbert
from repro.core import runtime as jruntime
from repro.core.types import ExecutionMode as JMode
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models import vilbert as jV
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_from_jax, vilbert_from_jax
from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode
from repro_torch.kernels import ops, quant
from repro_torch.kernels import tile_gemm as tile_gemm_lib
from repro_torch.models import layers as L

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
# M <= 16 and K, N not multiples of 8 included: the shapes that torch._int_mm
# refuses on the card, which the wrapper pads there.
SHAPES = [(64, 128, 96), (128, 64, 48), (3, 40, 5), (1, 8, 3), (16, 36, 20),
          (17, 3072, 768), (1000, 768, 300)]


def _inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    return x, w


def _both(a, tdt, jdt):
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_int8_matmul_bitwise_equals_jax(shape, dt):
    x, w = _inputs(*shape)
    (tx, jx), (tw, jw) = _both(x, *dt), _both(w, *dt)
    got, want = quant.int8_matmul(tx, tw), jquant.int8_matmul(jx, jw)
    assert got.dtype == dt[0] and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))
    for fn in ("quantize_rows", "quantize_cols"):
        q, s = getattr(quant, fn)(tx)
        jq, js = getattr(jquant, fn)(jx)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_np(s), _np(js))


@given(m=st.integers(1, 32), k=st.integers(8, 64), n=st.integers(1, 32))
@settings(max_examples=15, deadline=None)
def test_quantizers_bitwise_equal_jax_property(m, k, n):
    """test_quant.py:38's ranges: the quantizers and the product equal
    JAX's bitwise, and each quantizer's round trip within half a step."""
    x, w = _inputs(m, k, n, seed=m * 1000 + k * 10 + n)
    q, s = quant.quantize_rows(torch.from_numpy(x))
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float((q.float() * s - torch.from_numpy(x)).abs().max()) \
        <= float(s.max()) / 2 + 1e-6
    qc, sc = quant.quantize_cols(torch.from_numpy(w))
    jqc, jsc = jquant.quantize_cols(jnp.asarray(w))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w))))


def test_int8_mm_sums_exactly_in_int32():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (5, 1000)).astype(np.int8)
    b = rng.integers(-127, 128, (1000, 7)).astype(np.int8)
    got = quant.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("lead", [(4, 32), (7,), (2, 3, 5)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_projection_under_the_flag_is_int8_matmul(lead, dt):
    """Routed before tile_gemm, as ops.py:177-179 does: equal to
    ``int8_matmul`` and to the JAX projection under its flag, bitwise, and
    no tile_gemm call; the flag is scoped by its context manager."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((*lead, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    (tx, jx), (tw, jw) = _both(x, *dt), _both(w, *dt)
    base = ops.projection(tx, tw)
    calls = tile_gemm_lib.tile_gemm.launches
    plain_calls = []
    real = ops.tile_gemm
    try:
        ops.tile_gemm = lambda *a, **k: plain_calls.append(1) or real(*a, **k)
        with runtime.flags(quantize_proj=True):
            assert runtime.get("quantize_proj") is True
            got = ops.projection(tx, tw)
    finally:
        ops.tile_gemm = real
    assert runtime.get("quantize_proj") is None
    assert plain_calls == [] and tile_gemm_lib.tile_gemm.launches == calls
    with jruntime.flags(quantize_proj=True):
        want = jops.projection(jx, jw)
    assert got.shape == base.shape == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(quant.int8_matmul(tx, tw)))
    np.testing.assert_array_equal(_np(got), _np(want))
    rel = (got.float() - base.float()).abs().max() / base.float().abs().max()
    assert 0 < float(rel) < 0.05       # quantized, but close
    assert torch.equal(ops.projection(tx, tw), base)


def _grads_jax(x, w, g):
    f = lambda x, w: jnp.sum(jquant.int8_matmul(x, w) * g)
    return [np.asarray(a) for a in
            jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))]


@pytest.mark.parametrize("case", ["ties", "random", "lead"])
def test_gradient_equals_jax_grad(case):
    """The gradient flows through the scales only (the rounded values carry
    none), through amax: a tie splits evenly in both packages.  Under
    ``jax.grad``, x = ones(4, 8), w = 0.5 ones(8, 3) gives max |dx| 1.5 and
    max |dw| 4.0: not zero."""
    rng = np.random.default_rng(7)
    if case == "ties":
        x, w = np.ones((4, 8), np.float32), np.full((8, 3), 0.5, np.float32)
        x[1, :4] = -1.0                       # ties across signs too
        w[2:5, 1] = -0.5
    else:
        x, w = _inputs(6, 40, 12, seed=9)
        x[0, 3] = x[0, 7] = np.abs(x[0]).max() + 1.0    # one tied row
    if case == "lead":
        x = x.reshape(2, 3, 40)
    g = rng.standard_normal(x.shape[:-1] + (w.shape[1],)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    with runtime.flags(quantize_proj=True):
        (ops.projection(tx, tw) * torch.from_numpy(g)).sum().backward()
    jdx, jdw = _grads_jax(x, w, g)
    assert np.abs(jdx).max() > 0 and np.abs(jdw).max() > 0
    np.testing.assert_allclose(tx.grad.numpy(), jdx, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), jdw, atol=1e-6, rtol=1e-6)
    if case == "ties":
        g1 = np.ones((4, 3), np.float32)
        jdx, jdw = _grads_jax(np.ones((4, 8), np.float32),
                              np.full((8, 3), 0.5, np.float32), g1)
        assert np.abs(jdx).max() == pytest.approx(1.5)
        assert np.abs(jdw).max() == pytest.approx(4.0)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen3-32b"])
def test_mlp_under_the_flag_matches_jax(arch):
    """Each quantized product of the MLP (GELU: up, down; SwiGLU: gate, up,
    down) equals JAX's bitwise on identical input; the whole layer within
    1e-6 of its largest value, because the activations themselves
    (``jax.nn.gelu``/``silu`` against ``F.gelu``/``silu``) differ by an
    ulp, which can move a row's int8 scale by an ulp."""
    jcfg, cfg = jregistry.get_config(arch, True), get_config(arch, True)
    d, f = cfg.d_model, cfg.d_ff
    params = jL.mlp_init(jax.random.PRNGKey(0), jcfg, d, f)
    mlp = L.MLP(cfg, d, f, torch.Generator().manual_seed(0))
    for k, v in params.items():
        getattr(mlp, k).data = torch.from_numpy(np.array(v, np.float32))
    x = np.random.default_rng(0).standard_normal((2, 24, d)).astype(
        np.float32)
    with jruntime.flags(quantize_proj=True):
        want = np.asarray(jL.mlp_forward(params, jcfg, jnp.asarray(x)))
        jup = np.asarray(jops.projection(jnp.asarray(x), params["w_up"]))
        h = (jax.nn.gelu(jup) if cfg.act == "gelu" else
             jax.nn.silu(jops.projection(jnp.asarray(x), params["w_gate"]))
             * jup)
        jdown = np.asarray(jops.projection(h, params["w_down"]))
    with runtime.flags(quantize_proj=True), torch.no_grad():
        got = L.mlp_forward(mlp, torch.from_numpy(x)).numpy()
        up = ops.projection(torch.from_numpy(x), mlp.w_up).numpy()
        down = ops.projection(torch.from_numpy(np.array(h)),
                              mlp.w_down).numpy()
    np.testing.assert_array_equal(up, jup)
    np.testing.assert_array_equal(down, jdown)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                               rtol=0)


@pytest.fixture(scope="module")
def qwen3():
    cfg, jcfg = get_config("qwen3-32b", True), jregistry.get_config(
        "qwen3-32b", True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    port = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    return jcfg, params, port, tokens


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_qwen3_forward_under_the_flag_matches_jax(qwen3, mode):
    """The whole forward under the flag against JAX's at test_quant.py:35's
    relative limit (0.05 of the max).  Not tighter: where the f32 paths
    differ by an ulp before a product (attention, norms, activations), a
    value that sits on a rounding boundary can quantize to the next int8
    step, which moves an output by one step of its row's scale."""
    jcfg, params, port, tokens = qwen3
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    with jruntime.flags(quantize_proj=True):
        want = jT.forward(params, jcfg, batch, mode=JMode(mode.value))
    base = jT.forward(params, jcfg, batch, mode=JMode(mode.value))
    with runtime.flags(quantize_proj=True):
        got = port({"tokens": torch.as_tensor(tokens)}, mode=mode)
    assert np.isfinite(got.numpy()).all()
    assert _rel_max(got, want) < 0.05
    assert _rel_max(want, base) > 0       # the flag changed the JAX side


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_vilbert_forward_under_the_flag_matches_jax(mode):
    """vilbert-smoke's VQA logits under the flag, the same limit (see the
    qwen3 test); the kept counts equal."""
    cfg = get_config("vilbert-base", smoke=True)
    params = jV.init(jax.random.PRNGKey(0), jvilbert.SMOKE)
    model = vilbert_from_jax(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    batch = {"regions": rng.standard_normal((2, 64, 64)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 64))}
    with jruntime.flags(quantize_proj=True):
        want, want_counts = jV.forward(
            params, jvilbert.SMOKE,
            {k: jnp.asarray(v) for k, v in batch.items()},
            mode=JMode(mode.value), use_pallas=False,
            return_token_counts=True)
    with runtime.flags(quantize_proj=True):
        got, counts = model({k: torch.from_numpy(v)
                             for k, v in batch.items()},
                            mode=mode, return_token_counts=True)
    assert counts == tuple(want_counts)
    assert _rel_max(got, want) < 0.05
