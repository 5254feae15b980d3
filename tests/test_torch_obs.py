"""The port's observability analyses (``obs/attribution.py``,
``critpath.py``, ``timeline.py``, ``whatif.py``, ``python -m
repro_torch.obs``; copies of the JAX package's) against the JAX ones on
the CPU, on the same simulator traces: the §I 57% attribution, critical
paths (``SimResult.critical_path`` included) of vilbert-base's plan in
each mode and of a serve trace, Perfetto timelines, what-if projections
(k = 1 the identity), the CLI's text and JSON; and the streaming
deprecation shims (``core/streaming.py``)."""
import dataclasses
import json
import warnings
from fractions import Fraction

import pytest

from repro.configs import registry as jregistry
from repro.core import streaming as jstreaming
from repro.core.types import ExecutionMode as JMode
from repro.obs import __main__ as jcli
from repro.obs import attribution as jattribution
from repro.obs import critpath as jcritpath
from repro.obs import timeline as jtimeline
from repro.obs import whatif as jwhatif
from repro.plan import plan_model as jplan_model
from repro.serve.schedule import ServeRequest as JServeRequest
from repro.sim import rewrite_stall_trace as jrewrite_stall_trace
from repro.sim import simulate_plan as jsimulate_plan
from repro.sim import simulate_serve as jsimulate_serve
from repro.sim.replay import KernelTrace as JKernelTrace
from repro_torch.configs.registry import (get_config, get_energy_model,
                                          get_hw_config)
from repro_torch.core import streaming
from repro_torch.core.types import ExecutionMode as EM
from repro_torch.obs import __main__ as cli
from repro_torch.obs import (attribution, critical_path, format_critpath,
                             headroom, project, run_whatif, timeline,
                             whatif_ping_pong, whatif_resource)
from repro_torch.plan import plan_model
from repro_torch.serve.schedule import ServeRequest
from repro_torch.sim import (rewrite_stall_trace, simulate_plan,
                             simulate_rewrite_stall, simulate_serve)
from repro_torch.sim.replay import KernelTrace

HW = "streamdcim-base"


def _plans(arch="vilbert-base", smoke=False, **kw):
    """(port, JAX) simulate_plan results of the same forced-mode plan."""
    mode = kw.pop("mode", None)
    got = simulate_plan(plan_model(get_config(arch, smoke), hw=HW, mode=mode,
                                   force_mode=mode is not None, **kw))
    want = jsimulate_plan(jplan_model(
        jregistry.get_config(arch, smoke), hw=HW,
        mode=None if mode is None else JMode(mode.value),
        force_mode=mode is not None, **kw))
    return got, want


def _path(rep):
    return [(e.task_id, e.kind, e.resource, e.start, e.end, e.tag)
            for e in rep.path]


def _assert_critpath_equal(got, want):
    assert got.to_dict() == want.to_dict()
    assert _path(got) == _path(want)
    assert got.slack == want.slack
    assert got.path_cycles == got.makespan


def test_registry_hw_and_energy_points_equal_jax():
    for name in jregistry.HW_CONFIGS:
        assert dataclasses.asdict(get_hw_config(name)) == \
            dataclasses.asdict(jregistry.get_hw_config(name))
    for name in jregistry.ENERGY_CONFIGS:
        assert dataclasses.asdict(get_energy_model(name)) == \
            dataclasses.asdict(jregistry.get_energy_model(name))
    with pytest.raises(KeyError):
        get_hw_config("no-such-point")


def test_attribution_reproduces_paper_57_percent():
    trace = rewrite_stall_trace()
    rep = attribution.attribute(trace)
    assert rep.rewrite_stall_fraction == pytest.approx(4 / 7, abs=1e-9)
    assert rep.rewrite_stall_fraction == pytest.approx(
        trace.rewrite_stall_fraction())
    assert rep.rewrite_stall_fraction == pytest.approx(
        simulate_rewrite_stall()["rewrite_frac"])
    assert rep.rewrite_overlapped == 0 and rep.critical_resource == "ATTN"
    assert rep.by_op_class["attention"].rewrite_stall_fraction == \
        pytest.approx(4 / 7, abs=1e-9)
    for pp in (False, True):
        assert attribution.attribute(rewrite_stall_trace(ping_pong=pp)
                                     ).to_dict() == jattribution.attribute(
            jrewrite_stall_trace(ping_pong=pp)).to_dict()


@pytest.mark.parametrize("mode", [None] + list(EM))
def test_attribution_and_critical_path_equal_jax(mode):
    """vilbert-base's plan in each mode: attribution, the critical path
    (through ``SimResult.critical_path`` too), its text, and headroom."""
    got, want = _plans(mode=mode)
    assert got.cycles == want.cycles
    assert attribution.attribute(got.trace).to_dict() == \
        jattribution.attribute(want.trace).to_dict()
    assert attribution.bottleneck_of(got.trace) == \
        jattribution.bottleneck_of(want.trace)
    rep = got.critical_path()
    _assert_critpath_equal(rep, want.critical_path())
    _assert_critpath_equal(critical_path(got.trace),
                           jcritpath.critical_path(want.trace))
    assert format_critpath(rep, title="t") == jcritpath.format_critpath(
        want.critical_path(), title="t")
    assert headroom(got.trace) == jwhatif.headroom(want.trace)


def test_critical_path_exposed_rewrite_is_57_percent():
    serial = critical_path(rewrite_stall_trace(ping_pong=False))
    assert Fraction(serial.exposed_rewrite_cycles, serial.makespan) == \
        Fraction(4, 7)
    pp = critical_path(rewrite_stall_trace(ping_pong=True))
    assert pp.exposed_rewrite_cycles == 0 and pp.makespan < serial.makespan


def test_critical_path_on_serve_trace_equals_jax():
    reqs = [(0, 24, 4, 0), (1, 12, 6, 1)]
    got = simulate_serve(get_config("starcoder2-7b", True),
                         [ServeRequest(*r) for r in reqs], slots=2)
    want = jsimulate_serve(jregistry.get_config("starcoder2-7b", True),
                           [JServeRequest(*r) for r in reqs], slots=2)
    rep = critical_path(got.result.trace)
    assert rep.path_cycles == rep.makespan == got.cycles
    _assert_critpath_equal(rep, jcritpath.critical_path(want.result.trace))
    assert timeline.timeline_from_serve(got, title="s") == \
        jtimeline.timeline_from_serve(want, title="s")


@pytest.mark.parametrize("critical", [False, True])
def test_timelines_equal_jax(critical, tmp_path):
    for pp in (False, True):
        got = timeline.timeline_from_trace(rewrite_stall_trace(ping_pong=pp),
                                           title="x", critical_path=critical)
        want = jtimeline.timeline_from_trace(
            jrewrite_stall_trace(ping_pong=pp), title="x",
            critical_path=critical)
        assert got == want
        timeline.validate_timeline(got)
    res, jres = _plans("vilbert-base", smoke=True, mode=EM.TILE_STREAM)
    got = timeline.timeline_from_sim(res, critical_path=critical)
    assert got == jtimeline.timeline_from_sim(jres, critical_path=critical)
    path = timeline.write_timeline(got, str(tmp_path / "t.json"))
    assert timeline.load_timeline(path) == json.loads(json.dumps(got))


def test_kernel_record_timeline_equals_jax():
    fields = [dict(op="attn0", kind="attention", mode="tile_stream",
                   grid=(1, 2), block_q=64, block_kv=64, wall_time_s=1e-3,
                   cycles=1000, hbm_bytes=4096, flops=1 << 20),
              dict(op="ffn0", kind="gemm", mode="tile_stream", grid=(4,),
                   block_q=0, block_kv=0, wall_time_s=2e-3, cycles=2000,
                   hbm_bytes=8192, flops=1 << 21)]
    got = timeline.timeline_from_records([KernelTrace(**f) for f in fields],
                                         title="k")
    want = jtimeline.timeline_from_records(
        [JKernelTrace(**f) for f in fields], title="k")
    assert got == want
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert [e["ts"] for e in xs] == [0.0, 1000.0]


@pytest.mark.parametrize("spec", ["ATTN:2", "HBM:4", "GEN:2",
                                  "INTERCONNECT:2", "ping_pong"])
def test_whatif_equals_jax(spec):
    for mode in (EM.TILE_STREAM, EM.LAYER_STREAM, EM.NON_STREAM):
        got, want = _plans("vilbert-base", smoke=True, mode=mode)
        assert run_whatif(got.trace, spec).to_dict() == \
            jwhatif.run_whatif(want.trace, spec).to_dict()
    tr, jtr = rewrite_stall_trace(ping_pong=True), jrewrite_stall_trace(
        ping_pong=True)
    assert run_whatif(tr, spec).to_dict() == \
        jwhatif.run_whatif(jtr, spec).to_dict()


def test_whatif_k1_is_identity_and_ping_pong_reconstructs_serial():
    for mode in EM:
        res, _ = _plans("vilbert-base", smoke=True, mode=mode)
        assert project(res.trace, {}).projected_makespan == res.cycles
        p = project(res.trace, {"ATTN": 1.0, "HBM": 1.0, "GEN": 1.0})
        assert p.projected_makespan == res.cycles and p.speedup == 1.0
        assert whatif_resource(res.trace, "ATTN", 1.0).speedup == 1.0
    serial = rewrite_stall_trace(ping_pong=False)
    off = whatif_ping_pong(rewrite_stall_trace(ping_pong=True))
    assert off.projected_makespan == serial.makespan


CLI_ARGS = [["--rewrite-stall"], ["--rewrite-stall", "--ping-pong",
                                   "--critpath"],
            ["--rewrite-stall", "--critpath"],
            ["--model", "vilbert-base", "--mode", "tile_stream",
             "--critpath", "--whatif", "ATTN:2"],
            ["--model", "vilbert-base", "--smoke", "--json", "--critpath",
             "--whatif", "ping_pong", "--whatif", "HBM:4"],
            ["--model", "qwen2-vl-2b", "--smoke", "--seq", "96"]]


@pytest.mark.parametrize("args", CLI_ARGS, ids=lambda a: " ".join(a))
def test_cli_output_equals_jax(args, capsys):
    assert cli.main(args) == 0
    got = capsys.readouterr().out
    assert jcli.main(args) == 0
    assert got == capsys.readouterr().out
    if "--json" in args:
        assert "critical_path" in json.loads(got)


def test_cli_perfetto_plan_artifact_and_refusal(tmp_path, capsys):
    plan = plan_model(get_config("vilbert-base", True), hw=HW)
    art = tmp_path / "plan.json"
    art.write_text(plan.to_json())
    out = tmp_path / "tl.json"
    assert cli.main([str(art), "--perfetto", str(out), "--critpath"]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"plan {art} (")
    timeline.validate_timeline(timeline.load_timeline(str(out)))
    with pytest.raises(SystemExit, match="nothing to report"):
        cli.main([])


def test_streaming_shims_equal_jax_and_warn():
    for arch in ("vilbert-base", "qwen3-32b", "whisper-base", "hymba-1.5b"):
        cfg, jcfg = get_config(arch), jregistry.get_config(arch)
        with pytest.warns(DeprecationWarning, match="choose_mode"):
            got = streaming.choose_mode(cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got.value == jstreaming.choose_mode(jcfg).value
            assert streaming.choose_mode(cfg, num_kv_heads=1).value == \
                jstreaming.choose_mode(jcfg, num_kv_heads=1).value
    for mode in EM:
        args = (512, 1024, 768, 12, 4, 64)
        with pytest.warns(DeprecationWarning, match="streamed_bytes"):
            got = streaming.streamed_bytes_per_layer(*args, mode,
                                                     block_q=128)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got == jstreaming.streamed_bytes_per_layer(
                *args, JMode(mode.value), block_q=128)
    assert streaming.tile_stream_profitable is not None
