"""The port's serving stack against the JAX package on the CPU: the copied
planner, schedule and metrics modules give what the JAX copies give; the
paged pool round-trips exactly and frees its pages; the port's ``Engine``
emits the JAX ``Engine``'s greedy tokens and ``stats()`` (under an injected
clock) on the request mix of ``tests/test_batched_serve.py``, and batched
decode emits what per-slot decode emits.  The MoE family: grok1-smoke is
served from the paged pool with batched decode, deepseekv3-smoke's latent
cache takes the per-slot path, as in the JAX engine; both emit the JAX
engine's tokens, step log and stats.  The last three decoder configs:
minitron-smoke and danube3-smoke are served as the dense ones, and
danube3-smoke (a dense sliding window of 16) also with prompts of 18-29
tokens, whose rings wrap in prefill and decode, batched from the paged
pool: the JAX engine's tokens, step log and stats."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.models import transformer as jT
from repro.plan import plan_decode_step as jplan_decode_step
from repro.plan import plan_model as jplan_model
from repro.serve import engine as jengine
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache
from repro.serve.kv_cache import shape_buckets as jshape_buckets
from repro.serve.schedule import ServeRequest as JServeRequest
from repro.serve.schedule import build_schedule as jbuild_schedule
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import ExecutionMode
from repro_torch.plan import plan_decode_step, plan_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kv_cache import PagedKVCache, shape_buckets
from repro_torch.serve.schedule import ServeRequest, build_schedule

ARCHS = ["starcoder2-7b", "qwen3-32b", "qwen2-vl-2b", "minitron-4b",
         "h2o-danube3-4b"]


# ---------------------------------------------------------------------------
# Copies of the pure-Python layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,smoke", [("qwen3-32b", False),
                                        ("qwen3-32b", True),
                                        ("starcoder2-7b", True),
                                        ("qwen2-vl-2b", False),
                                        ("grok-1-314b", False),
                                        ("deepseek-v3-671b", False),
                                        ("starcoder2-7b", False),
                                        ("minitron-4b", False),
                                        ("h2o-danube3-4b", False)])
@pytest.mark.parametrize("kw", [
    {}, {"seq_len": 1536}, {"shape": "prefill_32k"},
    {"mode": "non_stream", "force_mode": True},
    {"mode": "tile_stream", "force_mode": True, "block_kv": 128},
    {"layer_modes": {1: "non_stream"}}])
def test_plan_model_to_dict_equals_jax(arch, smoke, kw):
    def conv(kw, enum):
        out = dict(kw)
        if "mode" in out:
            out["mode"] = enum(out["mode"])
        if "layer_modes" in out:
            out["layer_modes"] = {k: enum(v)
                                  for k, v in out["layer_modes"].items()}
        return out
    got = plan_model(get_config(arch, smoke), **conv(kw, ExecutionMode))
    want = jplan_model(jregistry.get_config(arch, smoke), **conv(kw, JMode))
    assert got.to_dict() == want.to_dict()
    assert type(got).from_json(got.to_json()) == got


@pytest.mark.parametrize("arch,smoke", [("qwen3-32b", False),
                                        ("qwen3-32b", True),
                                        ("qwen2-vl-2b", False),
                                        ("whisper-base", False),
                                        ("grok-1-314b", False),
                                        ("deepseek-v3-671b", False),
                                        ("h2o-danube3-4b", False),
                                        ("h2o-danube3-4b", True)])
@pytest.mark.parametrize("ctx", [(1025, 1025, 1025, 1537), 9, (4, 7, 4)])
def test_plan_decode_step_to_dict_equals_jax(arch, smoke, ctx):
    got = plan_decode_step(get_config(arch, smoke), ctx)
    want = jplan_decode_step(jregistry.get_config(arch, smoke), ctx)
    assert got.to_dict() == want.to_dict()
    assert type(got).from_json(got.to_json()) == got
    forced = plan_decode_step(get_config(arch, smoke), ctx,
                              mode=ExecutionMode.NON_STREAM, force_mode=True)
    assert forced.to_dict() == jplan_decode_step(
        jregistry.get_config(arch, smoke), ctx, mode=JMode.NON_STREAM,
        force_mode=True).to_dict()


def test_schedule_equals_jax():
    trace = [(0, 6, 5, 0), (1, 4, 3, 0), (2, 9, 4, 1), (3, 6, 6, 2),
             (4, 5, 2, 5), (5, 3, 1, 9)]
    for slots in (1, 2, 3):
        got = build_schedule([ServeRequest(*t) for t in trace], slots)
        want = jbuild_schedule([JServeRequest(*t) for t in trace], slots)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_shape_buckets_equal_jax():
    for lens in ([5, 3, 5, 3, 7], [4], [9, 9, 9], [1, 2, 1]):
        assert shape_buckets(lens) == jshape_buckets(lens)
    with pytest.raises(ValueError):
        shape_buckets([3, 0])


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------

def _cache(L=2, Hkv=2, W=24, hd=8, length=9, seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {side: rng.normal(size=(L, 1, Hkv, W, hd))
                       .astype(np.float32) for side in ("k", "v")},
            "len": length}


def _torch(c):
    return {"layers": {s: torch.from_numpy(a) for s, a in c["layers"].items()},
            "len": c["len"]}


def _jax(c):
    return {"layers": {s: jnp.asarray(a) for s, a in c["layers"].items()},
            "len": jnp.asarray(c["len"], jnp.int32)}


@pytest.mark.parametrize("page_size,width", [(8, 24), (7, 24), (64, 24)])
def test_paged_pool_roundtrip_growth_and_free_equal_jax(page_size, width):
    """Admit, gather, grow across page boundaries through scatter, free:
    every gathered cache equals the JAX pool's, and the valid prefix is
    the admitted one, exactly."""
    kw = dict(slots=3, num_layers=2, kv_heads=2, width=width, head_dim=8,
              page_size=page_size)
    pool = PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    jpool = JPagedKVCache(dtype=jnp.float32, **kw)
    c0, c1 = _cache(W=width, length=13, seed=0), _cache(W=width, length=13,
                                                          seed=1)
    for slot, c in ((0, c0), (1, c1)):
        pool.admit(slot, _torch(c))
        jpool.admit(slot, _jax(c))
    assert pool.pages_in_use == jpool.pages_in_use
    g = pool.gather([0, 1])
    assert g["len"] == 13 and tuple(g["layers"]["k"].shape) == (2, 2, 2,
                                                                width, 8)
    assert torch.equal(g["layers"]["k"][:, 0, :, :13],
                       torch.from_numpy(c0["layers"]["k"][:, 0, :, :13]))
    assert torch.equal(g["layers"]["v"][:, 1, :, :13],
                       torch.from_numpy(c1["layers"]["v"][:, 0, :, :13]))
    cur, jcur = g, jpool.gather([0, 1])
    for new_len in range(14, 18):      # crosses pages at 15 (7) and 17 (8)
        for side, val in (("k", 1.0), ("v", 2.0)):
            cur["layers"][side][:, :, :, new_len - 1] = val + new_len
        cur["len"] = new_len
        jcur = {"layers": {s: jcur["layers"][s].at[:, :, :, new_len - 1]
                           .set(val + new_len)
                           for s, val in (("k", 1.0), ("v", 2.0))},
                "len": jnp.asarray(new_len, jnp.int32)}
        pool.scatter([0, 1], cur)
        jpool.scatter([0, 1], jcur)
        cur, jcur = pool.gather([0, 1]), jpool.gather([0, 1])
        for side in ("k", "v"):
            np.testing.assert_array_equal(cur["layers"][side].numpy(),
                                          np.asarray(jcur["layers"][side]))
        assert pool.pages_in_use == jpool.pages_in_use
    assert pool.page_table(0) == jpool.page_table(0)
    pool.free(0)
    assert pool.len_of(1) == 17
    pool.free(1)
    assert pool.pages_in_use == 0


def test_paged_pool_guards():
    pool = PagedKVCache(slots=2, num_layers=2, kv_heads=2, width=24,
                        head_dim=8, dtype=torch.float32, page_size=8,
                        device="cpu")
    pool.admit(0, _torch(_cache(length=5)))
    with pytest.raises(ValueError, match="already admitted"):
        pool.admit(0, _torch(_cache(length=5)))
    pool.admit(1, _torch(_cache(length=9)))
    with pytest.raises(ValueError, match="unequal"):
        pool.gather([0, 1])
    assert not PagedKVCache.supports({"layers": {"attn": 1, "ssm": 2},
                                      "len": 0})
    assert not PagedKVCache.supports(torch.zeros(3))
    assert PagedKVCache.supports(_torch(_cache()))
    small = PagedKVCache(slots=1, num_layers=1, kv_heads=1, width=16,
                         head_dim=4, dtype=torch.float32, page_size=8,
                         device="cpu")
    small.admit(0, _torch(_cache(L=1, Hkv=1, W=16, hd=4, length=16)))
    with pytest.raises(RuntimeError, match="exhausted"):
        small.admit(1, _torch(_cache(L=1, Hkv=1, W=16, hd=4, length=16)))


def test_gather_of_an_empty_slot_has_separate_buffers():
    """decode_step writes K and V in place: the two buffers of a gathered
    cache must never be one tensor (the JAX pool may share them)."""
    pool = PagedKVCache(slots=1, num_layers=1, kv_heads=1, width=8,
                        head_dim=4, dtype=torch.float32, page_size=4,
                        device="cpu")
    pool.admit(0, _torch(_cache(L=1, Hkv=1, W=8, hd=4, length=0)))
    g = pool.gather([0])
    g["layers"]["k"][:] = 1.0
    assert g["layers"]["v"].abs().sum() == 0


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _requests(cls, cfg, *, n=6, seed=3, arrival_spread=3, max_new=(2, 6),
              plen=(3, 10)):
    """The request mix of tests/test_batched_serve.py::_requests."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=(int(rng.integers(*plen)),)
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(*max_new)),
                arrival_step=int(rng.integers(0, arrival_spread)))
            for i in range(n)]


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 0.25


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {r.rid: list(r.out_tokens) for r in engine.run()}


def _served(arch, max_len=32, **request_kw):
    """One JAX Engine run of ``arch``'s smoke config (the JAX side is the
    slow one) and the converted port model."""
    cfg = get_config(arch, smoke=True)
    jcfg = jregistry.get_config(arch, smoke=True)
    params = jT.init(jax.random.PRNGKey(0), jcfg)
    model = transformer_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    jeng = jengine.Engine(jcfg, params, slots=3, max_len=max_len,
                          clock=_clock())
    jtokens = _run(jeng, _requests(jengine.Request, jcfg, **request_kw))
    return cfg, model, jeng, jtokens


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    return _served(request.param)


def test_engine_matches_jax_engine(served):
    cfg, model, jeng, jtokens = served
    eng = Engine(cfg, model, slots=3, max_len=32, clock=_clock())
    tokens = _run(eng, _requests(Request, cfg))
    assert tokens == jtokens
    assert eng.stats() == jeng.stats()
    assert eng.decode_batches < eng.decode_calls == jeng.decode_calls
    assert eng.decode_calls == sum(eng.last_schedule.decode_steps.values())
    assert eng._pool is not None and eng._pool.pages_in_use == 0
    assert [dataclasses.asdict(r) for r in eng.step_log] == \
        [dataclasses.asdict(r) for r in jeng.step_log]
    assert eng.decode_wall_s() == jeng.decode_wall_s()


def test_batched_engine_matches_per_slot(served):
    cfg, model, _, jtokens = served
    per_slot = Engine(cfg, model, slots=3, max_len=32, batch_decode=False)
    assert _run(per_slot, _requests(Request, cfg)) == jtokens
    assert per_slot.decode_batches == per_slot.decode_calls
    assert per_slot._pool is None
    assert all(r.buckets is None for r in per_slot.step_log)


def test_engine_pinned_and_forced_plans(served):
    """A pinned heterogeneous plan and the deprecated ``mode=`` override
    serve the same tokens (the three modes compute the same function)."""
    cfg, model, _, jtokens = served
    plan = plan_model(cfg).with_layer_modes({0: ExecutionMode.NON_STREAM})
    pinned = Engine(cfg, model, slots=3, max_len=32, plan=plan)
    assert _run(pinned, _requests(Request, cfg)) == jtokens
    assert pinned.plan_for(5) is plan
    forced = Engine(cfg, model, slots=3, max_len=32,
                    mode=ExecutionMode.LAYER_STREAM)
    assert _run(forced, _requests(Request, cfg)) == jtokens
    assert all(r.decode_plan.uniform_mode == ExecutionMode.LAYER_STREAM
               for r in forced.step_log if r.decoded)


@pytest.fixture(scope="module", params=["grok-1-314b", "deepseek-v3-671b"])
def served_moe(request):
    return _served(request.param)


def test_moe_engine_matches_jax_engine(served_moe):
    cfg, model, jeng, jtokens = served_moe
    eng = Engine(cfg, model, slots=3, max_len=32, clock=_clock())
    tokens = _run(eng, _requests(Request, cfg))
    assert tokens == jtokens
    assert eng.stats() == jeng.stats()
    assert [dataclasses.asdict(r) for r in eng.step_log] == \
        [dataclasses.asdict(r) for r in jeng.step_log]
    assert eng.decode_calls == jeng.decode_calls
    paged = cfg.name.startswith("grok")
    assert (eng._pool is not None) == paged
    assert (eng.decode_batches < eng.decode_calls) == paged


def test_moe_engine_per_slot_matches_jax_tokens(served_moe):
    cfg, model, _, jtokens = served_moe
    per_slot = Engine(cfg, model, slots=3, max_len=32, batch_decode=False)
    assert _run(per_slot, _requests(Request, cfg)) == jtokens
    assert per_slot.decode_batches == per_slot.decode_calls


RING = dict(plen=(18, 30), max_new=(3, 8), n=5)   # prompts past window 16


@pytest.fixture(scope="module")
def served_ring():
    return _served("h2o-danube3-4b", max_len=48, **RING)


def test_ring_engine_matches_jax_engine_past_the_window(served_ring):
    """danube3-smoke's prompts (18-29 tokens) are longer than its window
    of 16: the pool holds 16 slots a row and every ring wraps, in prefill
    and while decoding; batched decode emits the JAX engine's tokens."""
    cfg, model, jeng, jtokens = served_ring
    eng = Engine(cfg, model, slots=3, max_len=48, clock=_clock())
    reqs = _requests(Request, cfg, **RING)
    assert min(len(r.prompt) for r in reqs) > cfg.sliding_window
    assert _run(eng, reqs) == jtokens
    assert eng.stats() == jeng.stats()
    assert [dataclasses.asdict(r) for r in eng.step_log] == \
        [dataclasses.asdict(r) for r in jeng.step_log]
    assert eng._pool is not None and eng._pool.pages_in_use == 0
    assert eng.decode_batches < eng.decode_calls == jeng.decode_calls
    assert all(kv > cfg.sliding_window for r in eng.step_log
               for kv in r.kv_lens)


def test_ring_engine_batched_matches_per_slot(served_ring):
    cfg, model, _, jtokens = served_ring
    per_slot = Engine(cfg, model, slots=3, max_len=48, batch_decode=False)
    assert _run(per_slot, _requests(Request, cfg, **RING)) == jtokens
    assert per_slot.decode_batches == per_slot.decode_calls


def test_engine_refuses_what_is_not_ported():
    cfg = get_config("qwen3-32b", smoke=True)
    model = transformer_from_jax(
        jax.tree.map(np.asarray,
                     jT.init(jax.random.PRNGKey(0),
                             jregistry.get_config("qwen3-32b", smoke=True))),
        cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        Engine(cfg, model, mesh=object())
    with pytest.raises(NotImplementedError):
        Engine(get_config("vilbert-base", smoke=True), model)
    eng = Engine(cfg, model, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=0, prompt=np.zeros(6, np.int32),
                           max_new_tokens=4))
