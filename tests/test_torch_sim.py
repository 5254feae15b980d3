"""The port's simulator (``repro_torch.sim``, pure-Python copies) against
the JAX package's: the workload lowering of the paper's models and the
decoders, ``compare_modes`` and ``simulate_plan`` at vilbert-base and
whisper-base (makespans, per-layer cycles, ``Trace.summary()`` and per-op
DMA bytes exactly equal; energy reports within 1e-12 relative), the
§I rewrite-stall micro-simulation, and ``plan_model`` on the paper's
models, whose JSON equals JAX's (the port refused them before it had the
crossmodal and enc-dec lowerings)."""
import dataclasses

import pytest

from repro.configs import registry as jregistry
from repro.configs.hardware import HW_PRESETS as JHW_PRESETS
from repro.core.types import ExecutionMode as JMode
from repro.plan import plan_decode_step as jplan_decode_step
from repro.plan import plan_model as jplan_model
from repro import sim as jsim
from repro_torch import sim
from repro_torch.configs.hardware import HW_PRESETS
from repro_torch.configs.registry import get_config
from repro_torch.core.types import ExecutionMode
from repro_torch.plan import plan_decode_step, plan_model

ENERGY_RTOL = 1e-12
SIM_ARCHS = ["vilbert-base", "whisper-base"]


def _asdict(wl):
    return dataclasses.asdict(wl)


@pytest.mark.parametrize("arch", ["vilbert-base", "vilbert-large",
                                  "whisper-base", "qwen3-32b",
                                  "h2o-danube3-4b", "minitron-4b",
                                  "qwen2-vl-2b"])
@pytest.mark.parametrize("seq_len", [0, 1024])
def test_build_workload_equals_jax(arch, seq_len):
    got = sim.build_workload(get_config(arch), seq_len)
    want = jsim.build_workload(jregistry.get_config(arch), seq_len)
    assert _asdict(got) == _asdict(want)
    assert [(i, op.name) for i, op in got.attention_ops] == \
        [(i, op.name) for i, op in want.attention_ops]


def test_attention_free_arch_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="attention-free"):
        sim.build_workload(get_config("mamba2-780m"))


def _same_result(got, want):
    assert got.cycles == want.cycles
    assert got.hbm_bytes == want.hbm_bytes
    assert got.layer_cycles == want.layer_cycles
    assert got.replayed_ops == want.replayed_ops
    assert got.trace.summary() == want.trace.summary()
    ops = sorted({e.op for e in want.trace.events})
    assert sorted({e.op for e in got.trace.events}) == ops
    for op in ops:
        assert got.op_dma_bytes(op) == want.op_dma_bytes(op), op
    e, je = got.energy(), want.energy()
    assert e.makespan_cycles == je.makespan_cycles
    assert e.total_pj == pytest.approx(je.total_pj, rel=ENERGY_RTOL)
    assert e.edp == pytest.approx(je.edp, rel=ENERGY_RTOL)
    assert e.by_resource.keys() == je.by_resource.keys()
    for r, pj in je.by_resource.items():
        assert e.by_resource[r] == pytest.approx(pj, rel=ENERGY_RTOL), r
    for op, pj in je.by_op.items():
        assert e.by_op[op] == pytest.approx(pj, rel=ENERGY_RTOL), op


@pytest.fixture(scope="module", params=SIM_ARCHS)
def compared(request):
    arch = request.param
    return (arch, sim.compare_modes(get_config(arch)),
            jsim.compare_modes(jregistry.get_config(arch)))


@pytest.mark.parametrize("mode", [m.value for m in ExecutionMode])
def test_compare_modes_equals_jax(compared, mode):
    _, got, want = compared
    _same_result(got[ExecutionMode(mode)], want[JMode(mode)])
    assert got[ExecutionMode(mode)].mode.value == mode


def test_compare_modes_keeps_the_papers_order(compared):
    """TILE < LAYER < NON in simulated cycles, as the JAX simulator has
    it (the order the paper claims)."""
    _, got, _ = compared
    c = {m: r.cycles for m, r in got.items()}
    assert c[ExecutionMode.TILE_STREAM] < c[ExecutionMode.LAYER_STREAM] \
        < c[ExecutionMode.NON_STREAM]


@pytest.mark.parametrize("arch", SIM_ARCHS)
@pytest.mark.parametrize("hw", ["streamdcim-base", "streamdcim-small",
                                "streamdcim-widebus"])
def test_simulate_plan_equals_jax(arch, hw):
    got = sim.simulate_plan(plan_model(get_config(arch), hw=hw))
    want = jsim.simulate_plan(jplan_model(jregistry.get_config(arch), hw=hw))
    _same_result(got, want)


def test_heterogeneous_plan_simulates_as_in_jax():
    cfg, jcfg = get_config("vilbert-base"), jregistry.get_config(
        "vilbert-base")
    got = sim.simulate_plan(plan_model(cfg, seq_len=1024).with_layer_modes(
        {0: ExecutionMode.NON_STREAM, "cox0_co": ExecutionMode.LAYER_STREAM}))
    want = jsim.simulate_plan(jplan_model(jcfg, seq_len=1024)
                              .with_layer_modes({0: JMode.NON_STREAM,
                                                 "cox0_co":
                                                     JMode.LAYER_STREAM}))
    assert got.mode is None and want.mode is None
    _same_result(got, want)


@pytest.mark.parametrize("mode", [m.value for m in ExecutionMode])
def test_simulate_model_equals_jax(mode):
    got = sim.simulate_model(get_config("vilbert-base"),
                             mode=ExecutionMode(mode), seq_len=512)
    want = jsim.simulate_model(jregistry.get_config("vilbert-base"),
                               mode=JMode(mode), seq_len=512)
    _same_result(got, want)


@pytest.mark.parametrize("ping_pong", [False, True])
def test_rewrite_stall_equals_jax(ping_pong):
    got = sim.simulate_rewrite_stall(ping_pong=ping_pong)
    assert got == jsim.simulate_rewrite_stall(ping_pong=ping_pong)
    assert sim.rewrite_stall_trace(ping_pong=ping_pong).summary() == \
        jsim.rewrite_stall_trace(ping_pong=ping_pong).summary()


def test_decode_workload_and_simulation_equal_jax():
    """A decode step's lowering (``DecodeOp``) and its simulation."""
    cfg, jcfg = get_config("qwen3-32b"), jregistry.get_config("qwen3-32b")
    ctx = (1025, 1025, 517)
    got = sim.decode_workload_from_plan(plan_decode_step(cfg, ctx), "s0:")
    want = jsim.decode_workload_from_plan(jplan_decode_step(jcfg, ctx),
                                          "s0:")
    assert _asdict(got) == _asdict(want)
    from repro.sim.pipeline import _simulate_ops as j_simulate_ops
    from repro_torch.sim.pipeline import _simulate_ops
    for m in ExecutionMode:
        hw, jhw = HW_PRESETS["streamdcim-base"], JHW_PRESETS[
            "streamdcim-base"]
        a = _simulate_ops(got, hw, lambda op: sim.pipeline._SCHEDULERS[m](hw),
                          m)
        b = j_simulate_ops(want, jhw,
                           lambda op: jsim.pipeline._SCHEDULERS[JMode(
                               m.value)](jhw), JMode(m.value))
        assert a.cycles == b.cycles and a.trace.summary() == \
            b.trace.summary()


def test_energy_presets_equal_jax():
    assert sorted(sim.ENERGY_PRESETS) == sorted(jsim.ENERGY_PRESETS)
    for name, em in sim.ENERGY_PRESETS.items():
        assert dataclasses.asdict(em) == dataclasses.asdict(
            jsim.ENERGY_PRESETS[name])


def test_critical_path_is_not_ported():
    """``SimResult.critical_path`` gives the JAX package's report: the
    same path, shares and slack, tiling the makespan."""
    res = sim.simulate_plan(plan_model(get_config("vilbert-base"),
                                       seq_len=256))
    want = jsim.simulate_plan(jplan_model(jregistry.get_config(
        "vilbert-base"), seq_len=256)).critical_path()
    got = res.critical_path()
    assert got.to_dict() == want.to_dict()
    assert [(e.task_id, e.start, e.end, e.tag) for e in got.path] == \
        [(e.task_id, e.start, e.end, e.tag) for e in want.path]
    assert got.slack == want.slack
    assert got.path_cycles == got.makespan == res.cycles


@pytest.mark.parametrize("arch", SIM_ARCHS + ["vilbert-large"])
@pytest.mark.parametrize("kw", [
    {}, {"seq_len": 1024},
    {"mode": "tile_stream", "force_mode": True},
    {"mode": "layer_stream", "force_mode": True, "block_kv": 128},
    {"layer_modes": {0: "non_stream"}}])
def test_plan_model_of_the_papers_models_equals_jax(arch, kw):
    def conv(kw, enum):
        out = dict(kw)
        if "mode" in out:
            out["mode"] = enum(out["mode"])
        if "layer_modes" in out:
            out["layer_modes"] = {k: enum(v)
                                  for k, v in out["layer_modes"].items()}
        return out
    got = plan_model(get_config(arch), **conv(kw, ExecutionMode))
    want = jplan_model(jregistry.get_config(arch), **conv(kw, JMode))
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert type(got).from_json(got.to_json()) == got
