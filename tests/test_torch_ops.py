"""The port's ``kernels/ops.py`` against ``repro.kernels.ops`` (jnp paths,
``use_pallas=False``) at 3e-4, the three execution modes against each other,
and a JAX ``LayerPlan`` driving the port's ``attention_by_plan``."""
import numpy as np
import pytest
import torch

from repro.core.types import AttnKind as JAttnKind
from repro.core.types import ExecutionMode as JMode
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.plan import plan_attention
from repro.plan import heuristics as jheur
from repro_torch.core import runtime
from repro_torch.core.types import AttnKind, ExecutionMode
from repro_torch.kernels import ops
from repro_torch.plan import heuristics

TOL = 3e-4
T = torch.from_numpy


def _inputs(seed=0, B=2, Hq=4, Hkv=2, Sq=200, Sk=300, hd=64, D=192):
    """tests/test_execution_modes.py's geometry, from numpy."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, Sq, hd)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((B, Sk, D)) * 0.5).astype(np.float32)
    wk = (rng.standard_normal((D, Hkv, hd)) * D ** -0.5).astype(np.float32)
    wv = (rng.standard_normal((D, Hkv, hd)) * D ** -0.5).astype(np.float32)
    sin, cos = (np.array(t) for t in jref.rope_tables(Sk, hd))
    return q, x, wk, wv, sin, cos


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", list(ExecutionMode))
def test_attention_by_mode_matches_jax(mode):
    q, x, wk, wv, sin, cos = _inputs()
    kw = dict(causal=True, q_offset=x.shape[1] - q.shape[2])
    got = ops.attention_by_mode(mode, T(q), T(x), T(wk), T(wv), sin=T(sin),
                                cos=T(cos), **kw)
    want = jops.attention_by_mode(JMode(mode.value), q, x, wk, wv, sin=sin,
                                  cos=cos, use_pallas=False, **kw)
    _close(got, want)


@pytest.mark.parametrize("mode", [ExecutionMode.LAYER_STREAM,
                                  ExecutionMode.TILE_STREAM])
def test_modes_equivalent(mode):
    """The three systems differ in dataflow only (test_execution_modes.py)."""
    q, x, wk, wv, sin, cos = _inputs(seed=1)
    args = (T(q), T(x), T(wk), T(wv))
    kw = dict(sin=T(sin), cos=T(cos), causal=True,
              q_offset=x.shape[1] - q.shape[2])
    base = ops.attention_by_mode(ExecutionMode.NON_STREAM, *args, **kw)
    _close(ops.attention_by_mode(mode, *args, **kw), base)


@pytest.mark.parametrize("mode", list(JMode))
def test_jax_layer_plan_drives_attention_by_plan(mode):
    """A ``repro.plan.LayerPlan`` (mode + tiling) runs the port unchanged;
    the result equals the JAX ``attention_by_plan`` on the jnp path."""
    q, x, wk, wv, _, _ = _inputs(seed=2, Sq=96, Sk=160)
    B, Hq, Sq, hd = q.shape
    plan = plan_attention(mode, seq_q=Sq, seq_kv=x.shape[1], d_kv=x.shape[2],
                          heads=Hq, kv_heads=wk.shape[1], head_dim=hd,
                          block_q=64, block_kv=64)
    got = ops.attention_by_plan(plan, T(q), T(x), T(wk), T(wv))
    want = jops.attention_by_plan(plan, q, x, wk, wv, use_pallas=False)
    _close(got, want)


def test_attention_by_plan_consumes_materialized_kv():
    """NON/LAYER take a caller's (K, V); TILE_STREAM regenerates them."""
    q, x, wk, wv, _, _ = _inputs(seed=3, Sq=64, Sk=96)
    k = np.einsum("bsd,dhe->bhse", x, wk)
    v = np.einsum("bsd,dhe->bhse", x, wv)
    plan = plan_attention(JMode.LAYER_STREAM, seq_q=64, seq_kv=96, d_kv=192,
                          heads=4, kv_heads=2, head_dim=64)
    got = ops.attention_by_plan(plan, T(q), T(x), T(wk), T(wv),
                                kv=(T(k), T(v)))
    _close(got, jref.ref_attention(q, k, v))


@pytest.mark.parametrize("lead", [(2, 37), (5,)])
def test_projection_matches_jax(lead):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((*lead, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 80)) * 96 ** -0.5).astype(np.float32)
    _close(ops.projection(T(x), T(w)), jops.projection(x, w), 1e-5)


def test_runtime_block_k_and_int8_flag():
    q, x, wk, wv, sin, cos = _inputs(seed=5, Sq=64, Sk=100)
    args = (ExecutionMode.TILE_STREAM, T(q), T(x), T(wk), T(wv))
    base = ops.attention_by_mode(*args)
    with runtime.flags(block_k=32):
        assert runtime.get("block_k") == 32
        _close(ops.attention_by_mode(*args), base, 1e-5)
    assert runtime.get("block_k") is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        with runtime.flags(quantize_proj=True):
            pass


def test_resolve_layer_mode_matches_jax():
    """The copied planner rule agrees with the JAX one, including the four
    vilbert-base attention kinds (all TILE_STREAM)."""
    for d_kv, hkv, hd in [(1024, 8, 128), (768, 12, 64), (768, 8, 128),
                          (1024, 12, 64), (5120, 8, 128), (1025, 4, 128)]:
        for mode in ExecutionMode:
            for kind in (AttnKind.FULL, AttnKind.MLA):
                for fuse in (True, False):
                    got = heuristics.resolve_layer_mode(
                        mode, d_kv=d_kv, num_kv_heads=hkv, head_dim=hd,
                        attn_kind=kind, fuse_kv_generation=fuse)
                    want = jheur.resolve_layer_mode(
                        JMode(mode.value), d_kv=d_kv, num_kv_heads=hkv,
                        head_dim=hd, attn_kind=JAttnKind(kind.value),
                        fuse_kv_generation=fuse)
                    assert got.value == want.value
    for d_kv, hkv, hd in [(1024, 8, 128), (768, 12, 64), (768, 8, 128),
                          (1024, 12, 64)]:
        assert heuristics.resolve_layer_mode(
            ExecutionMode.TILE_STREAM, d_kv=d_kv, num_kv_heads=hkv,
            head_dim=hd) == ExecutionMode.TILE_STREAM

