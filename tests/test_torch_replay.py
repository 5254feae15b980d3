"""Record/replay on the port (``repro_torch.sim.replay``) against the JAX
package's (``repro.sim.replay``), on the CPU.

* ``KernelTrace`` round-trips, and the JAX ``from_dict`` reads a port
  trace, the card's ``source="cuda_events"`` included;
* plans with the same injected traces serialize to the JAX plans' JSON
  and replay to equal makespans, per-op spans and bytes;
* ``fit_calibration`` on identical traces equals JAX's report within
  1e-9 relative;
* ``record_plan(device="cpu")`` gives JAX's ``record_plan(
  use_pallas=False)`` op names, kinds, modes, grids, tiles, bytes and
  FLOPs, with positive cycles (the timing fields differ);
* the recorder is inactive outside a block, and ``measure`` suppresses
  nested records;
* ``Transformer.prefill`` under a recording names each layer's record
  after its own plan op, and a decode step's records attach to its
  ``DecodePlan``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.types import ExecutionMode as JMode
from repro.kernels import ops as jops
from repro.plan import plan_attention as jplan_attention
from repro.plan import plan_decode_buckets as jplan_decode_buckets
from repro.plan import plan_decode_step as jplan_decode_step
from repro.plan import plan_model as jplan_model
from repro.sim import replay as jreplay
from repro.sim import simulate_plan as jsimulate_plan
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import ExecutionMode
from repro_torch.kernels import ops
from repro_torch.plan import (plan_attention, plan_decode_buckets,
                              plan_decode_step, plan_model)
from repro_torch.plan.planner import ExecutionPlan
from repro_torch.sim import replay, simulate_plan
from repro_torch.sim.replay import (CalibrationReport, KernelRecorder,
                                    KernelTrace, active_recorder,
                                    analytic_op_profile, fit_calibration,
                                    record_plan, recorder_for, recording)

CAL_RTOL = 1e-9
SEQ = 256


@pytest.fixture(scope="module")
def plans():
    return (plan_model(get_config("vilbert-base"), seq_len=SEQ),
            jplan_model(jregistry.get_config("vilbert-base"), seq_len=SEQ))


def _traces(plan, cls, scale=1):
    """Injected traces for every third op, attention and GEMM, with cycles
    that differ per op."""
    out = []
    for i, p in enumerate(tuple(plan.layers) + tuple(plan.gemms)):
        if i % 3:
            continue
        kind = "attention" if hasattr(p, "seq_q") else "gemm"
        out.append(cls(op=p.name, kind=kind, mode=p.mode.value,
                       grid=(1, 2, 3), block_q=128, block_kv=64,
                       cycles=scale * (10_000 + 977 * i),
                       hbm_bytes=4096 * (i + 1), wall_time_s=1e-5 * (i + 1),
                       flops=1000 * i, source="manual"))
    return out


# ------------------------------------------------------------- KernelTrace

@pytest.mark.parametrize("source", ["wall_time", "cuda_events", "manual"])
def test_kernel_trace_round_trips_and_jax_reads_it(source):
    kt = KernelTrace(op="cox0_co", kind="attention", mode="tile_stream",
                     grid=(16, 12, 1), block_q=128, block_kv=64, cycles=77,
                     hbm_bytes=123, wall_time_s=7.7e-8, flops=999,
                     source=source)
    d = json.loads(json.dumps(kt.to_dict()))
    assert KernelTrace.from_dict(d) == kt
    assert dataclasses.asdict(jreplay.KernelTrace.from_dict(d)) == \
        dataclasses.asdict(kt)
    assert kt.to_dict() == jreplay.KernelTrace.from_dict(d).to_dict()
    assert kt.resource == "ATTN"
    with pytest.raises(ValueError, match="kind"):
        dataclasses.replace(kt, kind="conv")
    with pytest.raises(ValueError, match="cycles"):
        dataclasses.replace(kt, cycles=0)
    with pytest.raises(ValueError, match="version"):
        KernelTrace.from_dict({**kt.to_dict(), "version": 99})


def test_attach_rejects_wrong_op_and_mode_override_drops_traces(plans):
    plan, _ = plans
    lp = plan.layers[0]
    with pytest.raises(ValueError, match="cannot attach"):
        lp.attach_trace(dataclasses.replace(
            _traces(plan, KernelTrace)[0], op="other"))
    traced = plan.attach_traces(_traces(plan, KernelTrace)
                                + [dataclasses.replace(
                                    _traces(plan, KernelTrace)[0],
                                    op=f"{lp.name}/tile_gemm")])
    assert traced.traced_ops[0] == lp.name
    assert traced.without_traces().traced_ops == ()
    moved = traced.with_layer_modes({lp.name: ExecutionMode.NON_STREAM})
    assert moved.layer(lp.name).trace is None


# ------------------------------------------------- injected traces vs JAX

@pytest.mark.parametrize("scale", [1, 1000])
def test_traced_plans_serialize_and_replay_as_in_jax(plans, scale):
    plan, jplan = plans
    traced = plan.attach_traces(_traces(plan, KernelTrace, scale))
    jtraced = jplan.attach_traces(_traces(jplan, jreplay.KernelTrace, scale))
    assert traced.to_json() == jtraced.to_json()
    back = ExecutionPlan.from_json(traced.to_json())
    assert back == traced
    assert traced.traced_ops == jtraced.traced_ops
    got, want = simulate_plan(back), jsimulate_plan(jtraced)
    assert got.cycles == want.cycles and got.replayed_ops == \
        want.replayed_ops == len(traced.traced_ops)
    assert got.trace.summary() == want.trace.summary()
    for name in traced.traced_ops:
        kt = traced.layer(name).trace if any(
            lp.name == name for lp in traced.layers) else next(
            g.trace for g in traced.gemms if g.name == name)
        evs = [e for e in got.trace.events if e.op == name]
        comp = [e for e in evs if e.kind == "compute"]
        assert len(comp) == 1 and comp[0].cycles == kt.cycles
        assert got.op_dma_bytes(name) == kt.hbm_bytes
    assert simulate_plan(traced, replay=False).cycles == \
        simulate_plan(plan).cycles


def test_fit_calibration_equals_jax(plans):
    plan, jplan = plans
    traced = plan.attach_traces(_traces(plan, KernelTrace))
    jtraced = jplan.attach_traces(_traces(jplan, jreplay.KernelTrace))
    got, want = fit_calibration(traced), jreplay.fit_calibration(jtraced)
    assert (got.name, got.model, got.hw, got.clock_hz) == \
        (want.name, want.model, want.hw, want.clock_hz)
    assert got.per_class.keys() == want.per_class.keys()
    for kind, c in want.per_class.items():
        for key, v in c.items():
            assert got.per_class[kind][key] == pytest.approx(
                v, rel=CAL_RTOL), (kind, key)
    assert got.scale.keys() == want.scale.keys()
    for r, s in want.scale.items():
        assert got.scale[r] == pytest.approx(s, rel=CAL_RTOL), r
    assert analytic_op_profile(plan) == jreplay.analytic_op_profile(jplan)
    back = CalibrationReport.from_json(got.to_json())
    assert back.to_dict() == got.to_dict()
    calibrated = simulate_plan(plan, calibration=got)
    assert calibrated.cycles == jsimulate_plan(
        jplan, calibration=jreplay.CalibrationReport.from_json(
            got.to_json())).cycles
    with pytest.raises(ValueError, match="no attached KernelTrace"):
        fit_calibration(plan)
    with pytest.raises(TypeError, match="CalibrationReport"):
        simulate_plan(plan, calibration=42)


# ------------------------------------------------------- live recording

REC_FIELDS = ("op", "kind", "mode", "grid", "block_q", "block_kv",
              "hbm_bytes", "flops", "clock_hz")


def _fields(t):
    return tuple(getattr(t, f) for f in REC_FIELDS)


@pytest.mark.parametrize("mode", [m.value for m in ExecutionMode])
def test_record_plan_on_the_cpu_matches_jax_records(mode):
    """vilbert-smoke at 64 tokens, every op: the records' fields equal the
    JAX package's but for the timing, and every op attaches."""
    kw = dict(seq_len=64, force_mode=True)
    plan = plan_model(get_config("vilbert-base", smoke=True),
                      mode=ExecutionMode(mode), **kw)
    jplan = jplan_model(jregistry.get_config("vilbert-base", smoke=True),
                        mode=JMode(mode), **kw)
    traced, rec = record_plan(plan, iters=1, warmup=0, device="cpu")
    jtraced, jrec = jreplay.record_plan(jplan, iters=1, warmup=0)
    assert [_fields(t) for t in rec.records] == \
        [_fields(t) for t in jrec.records]
    assert all(t.cycles > 0 and t.source == "wall_time"
               for t in rec.records)
    assert traced.traced_ops == jtraced.traced_ops
    assert len(traced.traced_ops) == len(plan.layers) + len(plan.gemms)
    assert simulate_plan(traced).replayed_ops == len(traced.traced_ops)


def test_record_plan_selects_ops_and_casts():
    plan = plan_model(get_config("vilbert-base", smoke=True), seq_len=64)
    names = [plan.layers[1].name, plan.gemms[2].name]
    traced, rec = record_plan(plan, ops=names, iters=2, warmup=1,
                              device="cpu", dtype=torch.bfloat16)
    assert sorted(traced.traced_ops) == sorted(names)
    g = plan.gemms[2]
    kt = traced.gemms[2].trace
    assert kt.hbm_bytes == 2 * (g.m * g.k + g.k * g.n + g.m * g.n)
    traced, _ = record_plan(plan, max_ops=3, device="cpu")
    assert len(traced.traced_ops) == 3


def test_record_plan_defaults_to_the_card():
    plan = plan_model(get_config("vilbert-base", smoke=True), seq_len=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            record_plan(plan, max_ops=1)


def test_recorder_inactive_outside_block_and_nested_suppressed():
    assert active_recorder() is None and recorder_for() is None
    with recording() as rec:
        assert active_recorder() is rec and recorder_for() is rec
        with recording(KernelRecorder(iters=1, warmup=0)) as inner:
            assert recorder_for() is inner
        assert active_recorder() is rec

        def nested():
            assert recorder_for() is None
            rec.add(KernelTrace(op="inner", kind="gemm", mode="",
                                grid=(), block_q=0, block_kv=0, cycles=1,
                                hbm_bytes=0))
            return 3
        assert rec.measure(nested, op="outer", kind="gemm") == 3
    assert active_recorder() is None and recorder_for() is None
    assert [t.op for t in rec.records] == ["outer"]


def test_attention_by_plan_records_as_jax_does():
    cfg = get_config("qwen3-32b", smoke=True)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 8, 24, 32)).astype(np.float32)
    x = rng.normal(size=(1, 40, 128)).astype(np.float32)
    wk = rng.normal(size=(128, 2, 32)).astype(np.float32) * 0.1
    wv = rng.normal(size=(128, 2, 32)).astype(np.float32) * 0.1
    for m in ExecutionMode:
        lp = plan_attention(m, seq_q=24, seq_kv=40, d_kv=128, heads=8,
                            kv_heads=2, head_dim=32, name=f"a_{m.value}")
        jlp = jplan_attention(JMode(m.value), seq_q=24, seq_kv=40, d_kv=128,
                              heads=8, kv_heads=2, head_dim=32,
                              name=f"a_{m.value}")
        assert dataclasses.asdict(lp) == {
            **dataclasses.asdict(jlp), "mode": m}
        with recording(KernelRecorder(iters=1, warmup=0)) as rec:
            out = ops.attention_by_plan(lp, *map(torch.as_tensor,
                                                 (q, x, wk, wv)))
        with jreplay.recording(jreplay.KernelRecorder(iters=1,
                                                      warmup=0)) as jrec:
            want = jops.attention_by_plan(jlp, *map(jnp.asarray,
                                                    (q, x, wk, wv)))
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
        assert [_fields(t) for t in rec.records] == \
            [_fields(t) for t in jrec.records]
    assert cfg.name == "qwen3-smoke"


def test_decode_attention_by_plan_records_as_jax_does():
    cfg, jcfg = get_config("qwen3-32b", smoke=True), jregistry.get_config(
        "qwen3-32b", smoke=True)
    dlp = plan_decode_step(cfg, 30).layers[0]
    jdlp = jplan_decode_step(jcfg, 30).layers[0]
    rng = np.random.default_rng(1)
    q = rng.normal(size=(1, 8, 1, 32)).astype(np.float32)
    k = rng.normal(size=(1, 2, 30, 32)).astype(np.float32)
    v = rng.normal(size=(1, 2, 30, 32)).astype(np.float32)
    with recording(KernelRecorder(iters=1, warmup=0)) as rec:
        out = ops.decode_attention_by_plan(dlp, *map(torch.as_tensor,
                                                     (q, k, v)))
    with jreplay.recording(jreplay.KernelRecorder(iters=1, warmup=0)) as jrec:
        want = jops.decode_attention_by_plan(jdlp, *map(jnp.asarray,
                                                        (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert [_fields(t) for t in rec.records] == \
        [_fields(t) for t in jrec.records]
    assert rec.records[0].kind == "decode"


def test_batched_decode_records_and_refuses_a_foreign_bucket():
    cfg, jcfg = get_config("qwen3-32b", smoke=True), jregistry.get_config(
        "qwen3-32b", smoke=True)
    ctx = (30, 30, 30)
    dlp, jdlp = plan_decode_step(cfg, ctx).layers[1], jplan_decode_step(
        jcfg, ctx).layers[1]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 8, 1, 32)).astype(np.float32)
    k = rng.normal(size=(3, 2, 32, 32)).astype(np.float32)
    v = rng.normal(size=(3, 2, 32, 32)).astype(np.float32)
    lens = np.full((3,), 30, np.int32)
    with recording(KernelRecorder(iters=1, warmup=0)) as rec:
        ops.batched_decode_attention_by_plan(
            dlp, *map(torch.as_tensor, (q, k, v, lens)))
    with jreplay.recording(jreplay.KernelRecorder(iters=1, warmup=0)) as jrec:
        jops.batched_decode_attention_by_plan(jdlp, *map(jnp.asarray,
                                                         (q, k, v, lens)))
    assert [_fields(t) for t in rec.records] == \
        [_fields(t) for t in jrec.records]
    with recording(), pytest.raises(ValueError, match="plan slots"):
        ops.batched_decode_attention_by_plan(
            dlp, *map(torch.as_tensor, (q[:2], k[:2], v[:2], lens[:2])))
    with recording() as rec:                    # no plan, no record
        ops.batched_decode_attention_by_plan(
            None, *map(torch.as_tensor, (q, k, v, lens)))
    assert rec.records == []


@pytest.fixture(scope="module")
def qwen3_smoke():
    cfg, jcfg = get_config("qwen3-32b", smoke=True), jregistry.get_config(
        "qwen3-32b", smoke=True)
    params = jax.tree.map(np.asarray,
                          __import__("repro.models.transformer",
                                     fromlist=["init"]).init(
                              jax.random.PRNGKey(0), jcfg))
    return cfg, transformer_from_jax(params, cfg, device="cpu")


def test_prefill_records_each_layer_under_its_own_op(qwen3_smoke):
    cfg, model = qwen3_smoke
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 20)))
    plan = plan_model(cfg, seq_len=20, mode=ExecutionMode.LAYER_STREAM)
    want, _ = model.prefill({"tokens": tokens}, 32, plan=plan)
    with recording(KernelRecorder(iters=1, warmup=0)) as rec:
        got, _ = model.prefill({"tokens": tokens}, 32, plan=plan)
    assert torch.equal(got, want)
    assert [t.op for t in rec.records] == [lp.name for lp in plan.layers]
    traced = plan.attach_traces(rec.records)
    assert traced.traced_ops == tuple(lp.name for lp in plan.layers)


def test_decode_step_traces_attach_to_its_decode_plan(qwen3_smoke):
    cfg, model = qwen3_smoke
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)))
    _, cache = model.prefill({"tokens": tokens}, 32)
    dp = plan_decode_step(cfg, (13, 13))
    nxt = tokens[:, -1:]
    with recording(KernelRecorder(iters=1, warmup=0)) as rec:
        model.decode_step(cache, nxt, plan=dp)
    assert [t.op for t in rec.records] == [lp.name for lp in dp.layers]
    assert all(t.kind == "decode" and t.op.endswith(".decode")
               for t in rec.records)
    traced = dp.attach_traces(rec.records)
    assert traced.traced_ops == tuple(lp.name for lp in dp.layers)
    back = type(dp).from_json(traced.to_json())
    assert back == traced
    assert back.without_traces() == dp
    # a prefill trace can never attach to a decode op
    assert dp.attach_traces([dataclasses.replace(
        rec.records[0], op=dp.layers[0].name[:-len(".decode")])]) == dp


@pytest.mark.parametrize("ctx", [(9, 4, 9, 7), (5,), (3, 3)])
def test_plan_decode_buckets_equal_jax(ctx):
    cfg, jcfg = get_config("qwen3-32b"), jregistry.get_config("qwen3-32b")
    got, want = plan_decode_buckets(cfg, ctx), jplan_decode_buckets(jcfg,
                                                                   ctx)
    assert [(pos, p.to_dict()) for pos, p in got] == \
        [(pos, p.to_dict()) for pos, p in want]


def test_replay_module_is_found_through_sys_modules():
    """The kernels reach the recorder through ``sys.modules`` only."""
    from repro_torch.kernels import _build
    assert _build.replay_recorder() is None
    with recording() as rec:
        assert _build.replay_recorder(torch.zeros(1)) is rec
    assert replay.DEFAULT_CLOCK_HZ == jreplay.DEFAULT_CLOCK_HZ
    assert replay.TRACE_KINDS == jreplay.TRACE_KINDS


def test_pick_block_equals_jax():
    from repro.kernels.ops import _pick_block as jpick
    for seq in (1, 7, 64, 100, 127, 128, 200, 256, 300, 1500, 4096):
        for pref in (8, 64, 128, 256, 512):
            assert ops._pick_block(seq, pref) == jpick(seq, pref)


def test_launch_hook_reads_the_library_only_after_a_launch(monkeypatch):
    """``_build.launch_hook`` reads the geometry of a card's record from the
    kernel's library (``<name>_last_launch``), and only when the measured
    calls launched: a wrapper whose count did not move (CPU tensors take
    the plain version) gives None and leaves the library alone."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.tile_gemm import tile_gemm
    read = []

    def last_launch(name):
        read.append(name)
        return 2, ((7, 1, 1), 128, 256)
    monkeypatch.setattr(_build, "last_launch", last_launch)
    hook = _build.launch_hook(tile_gemm)
    tile_gemm(torch.ones(4, 8), torch.ones(8, 16))       # the plain version
    assert hook() is None and read == []
    monkeypatch.setattr(tile_gemm, "launches", tile_gemm.launches + 1)
    assert hook() == ((7, 1, 1), 128, 256) and read == ["tile_gemm"]


def test_measure_takes_the_launched_geometry():
    """A ``launched`` hook that reports a launch replaces the given grid
    and tiles; one that reports none keeps them."""
    with recording(KernelRecorder(iters=3, warmup=0)) as rec:
        rec.measure(lambda: 1, op="a", kind="gemm", grid=(1, 2, 3),
                    block_q=8, block_kv=16,
                    launched=lambda: ((4, 5), 128, 256))
        rec.measure(lambda: 1, op="b", kind="gemm", grid=(1, 2, 3),
                    block_q=8, block_kv=16, launched=lambda: None)
    a, b = rec.records
    assert (a.grid, a.block_q, a.block_kv) == ((4, 5), 128, 256)
    assert (b.grid, b.block_q, b.block_kv) == ((1, 2, 3), 8, 16)
    assert a.source == b.source == "wall_time" and a.cycles >= 1


def _staggered(cfg, seed):
    """Two 12-token prompts at step 0 and a 6-token one at step 1: from
    step 2 on a decode step runs two shape buckets."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=4, arrival_step=at)
            for rid, (n, at) in enumerate([(12, 0), (12, 0), (6, 1)])]


@pytest.mark.parametrize("batch_decode", [True, False])
def test_recorded_engine_traces_each_decode_call(qwen3_smoke, batch_decode):
    """``Engine.run()`` under a recording, with steps of more than one
    shape bucket: each ``decode_step`` call runs under the plan of its own
    slots (one ``seq_kv`` entry per row), its records attach to that plan,
    and the tokens are those of an unrecorded run."""
    from repro_torch.serve.engine import Engine
    cfg, model = qwen3_smoke
    want = Engine(cfg, model, slots=3, max_len=32,
                  batch_decode=batch_decode)
    for r in _staggered(cfg, 5):
        want.submit(r)
    want_tokens = {r.rid: r.out_tokens for r in want.run()}
    eng = Engine(cfg, model, slots=3, max_len=32, batch_decode=batch_decode)
    for r in _staggered(cfg, 5):
        eng.submit(r)
    with recording(KernelRecorder(iters=1, warmup=0)):
        got = {r.rid: r.out_tokens for r in eng.run()}
    assert got == want_tokens
    assert want.traced_plans == {}
    multi = 0
    for rec in eng.step_log:
        if not rec.decoded:
            assert rec.step not in eng.traced_plans
            continue
        plans = eng.traced_plans[rec.step]
        calls = (rec.buckets if batch_decode else
                 tuple((kv, (rid,)) for rid, kv in zip(rec.decoded,
                                                        rec.kv_lens)))
        assert len(plans) == len(calls)
        multi += len(calls) > 1
        for plan, (kv, rids) in zip(plans, calls):
            assert plan.without_traces() == plan_decode_step(
                cfg, (kv,) * len(rids))
            assert plan.traced_ops == tuple(lp.name for lp in plan.layers)
            assert all(lp.trace.kind == "decode" for lp in plan.layers)
    assert multi >= 2
