"""The port's sharding rule table and shape stand-ins against the JAX
package's on the CPU (``repro_torch.distributed.sharding``,
``repro_torch.configs.registry``): every parameter's spec for all 12
registry archs at production axis sizes and three FSDP thresholds (the
JAX spec with its layer-stack entry dropped), the decode caches' and the
batches' specs, ``param_specs``/``cache_specs``/``cell_supported``, the
cases of ``tests/test_distributed.py:19-137``, and the int8 quantizer
bitwise."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import SHAPES as JSHAPES
from repro.distributed import compression as jcompression
from repro.distributed import sharding as JSH
from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import SHAPES, Family, ModelConfig
from repro_torch.distributed import compression, sharding as SH
from repro_torch.distributed.hints import constrain
from repro_torch.models import layers as L

# Production axis sizes, simulated for rule evaluation.
PROD_SIZES = {"data": 16, "model": 16, "pod": 2}
ARCHS = list(registry.ARCHS)
THRESHOLDS = [8e9, 0, 1e15]
#: vilbert's JAX tree carries an unembed the encoder never reads; the port
#: drops it (convert.py).
DROPPED = {"text_embed/unembed"}


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuples as the axis name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return dict(JSH._flatten_with_paths(
        jregistry.param_specs(jregistry.get_config(arch)))[0])


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return registry.param_specs(registry.get_config(arch))


@functools.lru_cache(maxsize=None)
def _jax_specs(arch, threshold):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    sh = JSH.param_shardings(jregistry.param_specs(jregistry.get_config(arch)),
                             jregistry.get_config(arch), mesh,
                             axis_sizes=PROD_SIZES, fsdp_threshold=threshold)
    return {p: _norm(s.spec) for p, s in JSH._flatten_with_paths(sh)[0]}


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, threshold):
    """Every parameter's spec is JAX's for its leaf, the stack entry
    dropped for a layer of a stack; every JAX leaf has its parameters."""
    want = _jax_specs(arch, threshold)
    got = SH.param_shardings(_port_params(arch), registry.get_config(arch),
                             axis_sizes=PROD_SIZES, fsdp_threshold=threshold)
    seen = set()
    for name, sharding in got.items():
        path, stacked = SH.jax_path(name)
        seen.add(path)
        assert sharding.placements is None
        assert _norm(sharding.spec) == (want[path][1:] if stacked
                                        else want[path]), (name, path)
    assert seen == set(want) - DROPPED


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_cover_jax_shapes_and_count(arch):
    """param_specs: each stacked JAX leaf (L, ...) is L parameters of its
    trailing shape, every other leaf one of its shape, in the JAX dtype."""
    jp, tp = _jax_params(arch), _port_params(arch)
    per_path = {}
    for name, spec in tp.items():
        path, stacked = SH.jax_path(name)
        per_path.setdefault(path, []).append((spec, stacked))
    total = 0
    for path, leaf in jp.items():
        if path in DROPPED:
            continue
        specs = per_path[path]
        stacked = specs[0][1]
        want = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        assert len(specs) == (leaf.shape[0] if stacked else 1), path
        for spec, _ in specs:
            assert spec.shape == want, path
            assert str(spec.dtype).replace("torch.", "") == str(leaf.dtype)
        total += int(np.prod(leaf.shape))
    assert sum(int(np.prod(s.shape)) for s in tp.values()) == total


def _jax_tree_specs(tree):
    return {p: _norm(s) for p, s in JSH._flatten_with_paths(tree)[0]}


def _port_tree_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_tree_specs(v, path))
        else:
            out[path] = _norm(v.spec)
    return out


@pytest.fixture
def spec_only(monkeypatch):
    """JAX's batch and cache rules read only ``mesh.shape``; with
    NamedSharding returning its spec they run on simulated sizes."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    return JSH._SimulatedMesh(PROD_SIZES)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_shardings_equal_jax(arch, spec_only):
    """Every decode cell's cache: leaf shapes and dtypes, and its specs
    (batch-sharded, and for a batch-1 cell sequence-sharded), are JAX's."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        if registry.cell_supported(arch, shape_name):
            continue
        shape = SHAPES[shape_name]
        cache = registry.cache_specs(cfg, shape)
        jcache = jregistry.cache_specs(jcfg, JSHAPES[shape_name])
        jflat = dict(JSH._flatten_with_paths(jcache)[0])
        flat = dict(SH._flatten(cache))
        assert set(flat) == set(jflat)
        for path, leaf in flat.items():
            assert leaf.shape == tuple(jflat[path].shape), path
            if path != "len":
                assert str(leaf.dtype).replace("torch.", "") == \
                    str(jflat[path].dtype), path
        seq = shape.global_batch == 1
        got = SH.cache_shardings(cache, cfg, None, seq_sharded=seq,
                                 axis_sizes=PROD_SIZES)
        want = JSH.cache_shardings(jcache, jcfg, spec_only, seq_sharded=seq)
        assert _port_tree_specs(got) == _jax_tree_specs(want), shape_name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_batch_specs_equal_jax(arch, spec_only):
    """Every cell's batch: the shapes of input_specs and batch_shardings
    (rows over (pod, data); VLM positions on dim 1; sequence-sharded
    too) are JAX's; cell_supported is JAX's."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for name in SHAPES:
        assert registry.cell_supported(arch, name) == \
            jregistry.cell_supported(arch, name)
        specs = registry.input_specs(cfg, SHAPES[name])
        jspecs = jregistry.input_specs(jcfg, JSHAPES[name])
        assert specs == {k: tuple(v.shape) for k, v in jspecs.items()}
        for seq in (False, True):
            got = SH.batch_shardings(specs, SH._SimulatedMesh(PROD_SIZES),
                                     seq_sharded=seq)
            want = JSH.batch_shardings(jspecs, spec_only, seq_sharded=seq)
            assert {k: _norm(v.spec) for k, v in got.items()} == \
                {k: _norm(v) for k, v in want.items()}, (name, seq)


# ------------------------ tests/test_distributed.py ------------------------

def _specs_by_path(arch, **kwargs):
    cfg = registry.get_config(arch)
    return {n: s.spec for n, s in SH.param_shardings(
        _port_params(arch), cfg, axis_sizes=PROD_SIZES, **kwargs).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_cover_every_leaf(arch):
    """test_distributed.py:19: every partitioned dim divides."""
    params = _port_params(arch)
    for name, spec in _specs_by_path(arch).items():
        assert SH.spec_divides(spec, params[name].shape,
                               SH._SimulatedMesh(PROD_SIZES)), (name, spec)


def test_head_sharding_rules():
    """test_distributed.py:43."""
    m = SH._SimulatedMesh(PROD_SIZES)
    assert SH.heads_shardable(registry.get_config("qwen3-32b"), m)
    assert not SH.heads_shardable(registry.get_config("starcoder2-7b"), m)
    assert SH.experts_shardable(registry.get_config("deepseek-v3-671b"), m)
    assert not SH.experts_shardable(registry.get_config("grok-1-314b"), m)


def test_megatron_head_split_when_divisible():
    """test_distributed.py:67: qwen3's 64 heads shard over 'model' (the
    port's per-layer spec: JAX's without the stack entry)."""
    specs = _specs_by_path("qwen3-32b", fsdp_threshold=1e15)
    wq = [s for p, s in specs.items() if p.endswith(".attn.wq")]
    wo = [s for p, s in specs.items() if p.endswith(".attn.wo")]
    assert wq and all(s == (None, "model", None) for s in wq)
    assert wo and all(s == ("model", None, None) for s in wo)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-vl-2b"])
def test_context_parallel_fallback_replicates_attention(arch):
    """test_distributed.py:82: non-divisible heads replicate q/k/v/o, the
    MLP keeps its tensor split."""
    specs = _specs_by_path(arch)
    attn = {p: s for p, s in specs.items()
            if p.split(".")[-1] in ("wq", "wk", "wv", "wo")}
    assert attn and all(all(a is None for a in s) for s in attn.values())
    ups = [s for p, s in specs.items() if p.endswith(".w_up")]
    assert ups and all("model" in s for s in ups)


def test_fsdp_threshold_gates_data_axis():
    """test_distributed.py:97: starcoder2 sits under 8e9; at 0 its
    replicated attention weights take 'data'."""
    def data_sharded(specs):
        return [p for p, s in specs.items() if "data" in s]
    assert not data_sharded(_specs_by_path("starcoder2-7b"))
    hit = data_sharded(_specs_by_path("starcoder2-7b", fsdp_threshold=0))
    assert any(p.split(".")[-1] in ("wq", "wk", "wv", "wo") for p in hit)


def test_grouped_moe_matches_plain():
    """test_distributed.py:111: four token groups equal one."""
    cfg = ModelConfig(name="t", family=Family.MOE, num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      num_experts=4, experts_per_token=2, moe_d_ff=96,
                      dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = L.MoE(cfg, gen)
    x = torch.randn((2, 16, 64), generator=gen) * 0.5
    with runtime.flags(moe_capacity=100.0):
        y1 = L.moe_forward(p, cfg, x)
        with runtime.flags(moe_groups=4):
            y4 = L.moe_forward(p, cfg, x)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("key", ["attn_q", "embed_out"])
def test_hints_leave_a_plain_tensor(key):
    """test_distributed.py:125: no table -> the input itself; a table does
    not touch a plain tensor either (only a DTensor has a placement)."""
    x = torch.ones(4, 4)
    assert constrain(x, key) is x
    with runtime.flags(sharding_hints={key: (None, ("data", None))}):
        assert constrain(x, key) is x


def test_quantize_bitwise_equal_jax_and_half_ulp():
    """test_distributed.py:131 on JAX's own input: q and the scale equal
    JAX's bitwise; the round trip stays within half a step."""
    g = jax.random.normal(jax.random.PRNGKey(0), (128, 128)) * 0.02
    jq, js = jcompression._quantize(g)
    q, s = compression._quantize(torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    d = compression._dequantize(q, s)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jcompression._dequantize(jq, js)))
    err = (d - torch.from_numpy(np.array(g))).abs().max()
    assert float(err) <= float(s) / 2 + 1e-9


def test_error_feedback_equals_jax():
    gen = np.random.default_rng(5)
    g = {"w": gen.standard_normal((64, 32)).astype(np.float32) * 0.1}
    r = {"w": gen.standard_normal((64, 32)).astype(np.float32) * 1e-3}
    q, nr = compression.ErrorFeedback.apply(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})
    jq, jnr = jcompression.ErrorFeedback.apply(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
    np.testing.assert_array_equal(nr["w"].numpy(), np.asarray(jnr["w"]))
    z = compression.ErrorFeedback.init(
        {k: torch.from_numpy(v) for k, v in g.items()})
    assert z["w"].dtype == torch.float32 and not z["w"].any()
