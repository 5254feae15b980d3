"""The port's chiplet-mesh scale-out (``repro_torch.shard``: ``noc``,
``partition``, ``sim``, ``sweep``, the CLI; copies of the JAX package's)
against the JAX one on the CPU, on the cases of ``tests/test_shard.py``
but its two mesh-serving tests (tests/test_torch_mesh.py holds mesh
serving on gloo meshes): the sharded plans, their simulation and
sweep equal JAX's by ``to_dict`` and field by field, the checks raise as
JAX's do, ``obs.timeline_from_sharded`` equals JAX's event for event, and
``python -m repro_torch.shard --json`` writes JAX's artifact."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import registry as jregistry
from repro.configs.hardware import STREAMDCIM_BASE as J_BASE
from repro.core.types import ExecutionMode as JEM
from repro.obs import attribution as jattribution
from repro.obs import timeline as jtimeline
from repro.plan import plan_model as jplan_model
from repro import shard as jshard
from repro.shard import __main__ as jcli
from repro_torch import shard
from repro_torch.configs import registry
from repro_torch.configs.hardware import STREAMDCIM_BASE
from repro_torch.core.types import ExecutionMode as EM
from repro_torch.distributed import sharding
from repro_torch.obs import (INTERCONNECT, attribute, base_resource,
                             bottleneck_of, op_class)
from repro_torch.obs import timeline
from repro_torch.obs.attribution import NOC_LINK_PREFIX
from repro_torch.plan import plan_model
from repro_torch.shard import (MeshSpec, ShardedPlan, multicast_span,
                               noc, pipelined_multicast_wins, resolve_axis,
                               shard_plan, simulate_sharded_plan)
from repro_torch.sim import simulate_plan

ROOT = Path(__file__).resolve().parents[1]
SCALE_MODELS = ("vilbert-base", "qwen2-vl-2b")
GENEROUS_NOC = dict(link_bytes_per_cycle=4096, hop_cycles=1)
CHIPS = (1, 2, 4, 8)

_PLANS = {}


def _plans(model, mode, seq=512):
    """(port, JAX) plans of ``model`` in the forced ``mode``."""
    key = (model, mode, seq)
    if key not in _PLANS:
        got = plan_model(registry.get_config(model), hw=STREAMDCIM_BASE,
                         seq_len=seq, mode=mode, force_mode=True)
        want = jplan_model(jregistry.get_config(model), hw=J_BASE,
                           seq_len=seq, mode=JEM(mode.value),
                           force_mode=True)
        assert got.to_dict() == want.to_dict()
        _PLANS[key] = got, want
    return _PLANS[key]


def _events(trace):
    return [dataclasses.astuple(e) for e in trace.events]


def _same_sim(got, want):
    """Every field of two ShardSimResults, the trace event for event."""
    assert got.plan.to_dict() == want.plan.to_dict()
    assert (got.hw, got.cycles, got.per_chip_cycles, got.per_chip_hbm_bytes,
            got.link_bytes, got.hbm_bytes, got.collective_bytes,
            got.chips) == \
        (want.hw, want.cycles, want.per_chip_cycles, want.per_chip_hbm_bytes,
         want.link_bytes, want.hbm_bytes, want.collective_bytes,
         want.chips)
    assert _events(got.trace) == _events(want.trace)


def _pair(model, mode, chips, calibration=None, **mesh):
    """The port's and JAX's sharded plan and its simulation."""
    p, jp = _plans(model, mode)
    splan = shard_plan(p, MeshSpec(chips=chips, **mesh))
    jsplan = jshard.shard_plan(jp, jshard.MeshSpec(chips=chips, **mesh))
    assert splan.to_dict() == jsplan.to_dict()
    assert splan.to_json() == jsplan.to_json()
    return (simulate_sharded_plan(splan, calibration=calibration),
            jshard.simulate_sharded_plan(jsplan, calibration=calibration))


@pytest.mark.parametrize("model", SCALE_MODELS)
@pytest.mark.parametrize("mode", list(EM))
@pytest.mark.parametrize("topology", ["ring", "line"])
def test_sharded_plan_and_simulation_equal_jax(model, mode, topology):
    """SCALE_MODELS x modes x 1/2/4/8 chips on a ring and a line: the
    port's ShardedPlan equals JAX's by to_dict and JSON, its simulation
    every field and event, and the byte-exactness of test_shard.py's
    grid holds."""
    for chips in CHIPS:
        got, want = _pair(model, mode, chips, topology=topology)
        _same_sim(got, want)
        splan = got.plan
        assert got.collective_bytes == splan.total_collective_link_bytes
        attn = sum(lp.hbm_bytes for cp in splan.chip_plans
                   for lp in cp.layers)
        assert got.hbm_bytes >= attn > 0
        assert got.cycles >= max(got.per_chip_cycles)
        if chips == 1:
            assert splan.collectives == ()
            assert got.collective_bytes == 0


@pytest.mark.parametrize("mode", list(EM))
def test_one_chip_is_identity(mode):
    plan, _ = _plans("vilbert-base", mode)
    base = simulate_plan(plan)
    res = simulate_sharded_plan(shard_plan(plan, MeshSpec(chips=1)))
    assert (res.cycles, res.hbm_bytes, res.per_chip_hbm_bytes) == \
        (base.cycles, base.hbm_bytes, (base.hbm_bytes,))


def test_line_topology_and_wrap_penalty_equal_jax():
    ring, jring = _pair("vilbert-base", EM.TILE_STREAM, 4)
    line, jline = _pair("vilbert-base", EM.TILE_STREAM, 4, topology="line")
    _same_sim(line, jline)
    assert MeshSpec(chips=4, topology="line").num_links == 6
    assert line.collective_bytes >= ring.collective_bytes


@pytest.mark.parametrize("model,mode", [("vilbert-base", EM.TILE_STREAM),
                                        ("qwen2-vl-2b", EM.NON_STREAM)])
def test_weak_scaling_equals_jax(model, mode):
    cycles = []
    for chips in CHIPS:
        got, want = _pair(model, mode, chips, **GENEROUS_NOC)
        assert got.cycles == want.cycles
        cycles.append(got.cycles)
    assert all(a >= b for a, b in zip(cycles, cycles[1:])), cycles


def test_interconnect_bound_mesh_equals_jax():
    starved, jstarved = _pair("vilbert-base", EM.TILE_STREAM, 4,
                              link_bytes_per_cycle=1)
    _same_sim(starved, jstarved)
    assert bottleneck_of(starved.trace) == INTERCONNECT == \
        jattribution.bottleneck_of(jstarved.trace)
    roomy, _ = _pair("vilbert-base", EM.TILE_STREAM, 4, **GENEROUS_NOC)
    assert bottleneck_of(roomy.trace) != INTERCONNECT
    assert roomy.cycles < starved.cycles


def test_attribution_folds_chip_prefixes():
    assert base_resource("c3.ATTN") == "ATTN"
    assert base_resource("ATTN") == "ATTN"
    assert base_resource("NOC_L2") == "INTERCONNECT"
    assert noc.LINK_PREFIX == NOC_LINK_PREFIX == jshard.noc.LINK_PREFIX
    assert op_class("c2.l0_ffn_up") == "ffn"
    plan, _ = _plans("vilbert-base", EM.TILE_STREAM)
    base = simulate_plan(plan)
    res = simulate_sharded_plan(shard_plan(plan, MeshSpec(chips=1)))
    assert bottleneck_of(res.trace) == bottleneck_of(base.trace)
    rep, srep = attribute(base.trace), attribute(res.trace)
    assert (srep.busy, srep.rewrite_exposed) == (rep.busy,
                                                 rep.rewrite_exposed)


def test_timeline_from_sharded_equals_jax():
    """obs.timeline_from_sharded of the port's 4-chip run equals JAX's
    event for event, with a process per chip and a track per ring link."""
    got, want = _pair("vilbert-base", EM.TILE_STREAM, 4)
    tl = timeline.timeline_from_sharded(got)
    timeline.validate_timeline(tl)
    assert tl == jtimeline.timeline_from_sharded(want)
    procs = {e["args"]["name"] for e in tl["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {"chip0", "chip1", "chip2", "chip3", "noc"} <= procs
    links = {e["args"]["name"] for e in tl["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "thread_name"
             and e["args"]["name"].startswith(noc.LINK_PREFIX)}
    assert len(links) == 4


def test_calibrated_sharded_simulation_equals_jax():
    """The optional calibration (a resource -> factor mapping, read by the
    base resource of each chip's prefixed one) scales both packages'
    simulations alike."""
    scale = {"ATTN": 0.25, "GEN": 1.5, "HBM": 2.0}
    got, want = _pair("vilbert-base", EM.TILE_STREAM, 4, calibration=scale)
    _same_sim(got, want)
    plain, _ = _pair("vilbert-base", EM.TILE_STREAM, 4)
    assert got.cycles != plain.cycles


@pytest.mark.parametrize("chips,hop,link", [(8, 32, 128), (4, 7, 64),
                                            (2, 1, 4096)])
def test_multicast_calculus_equals_jax(chips, hop, link):
    mesh = MeshSpec(chips=chips, link_bytes_per_cycle=link, hop_cycles=hop)
    jmesh = jshard.MeshSpec(chips=chips, link_bytes_per_cycle=link,
                            hop_cycles=hop)
    for payload in (64, 4096, 1 << 20, (1 << 20) + 3):
        assert pipelined_multicast_wins(mesh, payload) == \
            jshard.pipelined_multicast_wins(jmesh, payload)
        for pipelined in (True, False):
            assert multicast_span(mesh, payload, pipelined=pipelined) == \
                jshard.multicast_span(jmesh, payload, pipelined=pipelined)
    big = MeshSpec(chips=8, link_bytes_per_cycle=128, hop_cycles=32)
    assert pipelined_multicast_wins(big, 1 << 20)
    assert not pipelined_multicast_wins(big, 64)


def test_pipelined_multicast_equals_jax():
    pipe, jpipe = _pair("vilbert-base", EM.NON_STREAM, 4,
                        pipelined_multicast=True)
    saf, jsaf = _pair("vilbert-base", EM.NON_STREAM, 4,
                      pipelined_multicast=False)
    _same_sim(pipe, jpipe)
    _same_sim(saf, jsaf)
    assert pipe.collective_bytes == saf.collective_bytes
    assert pipe.cycles <= saf.cycles


def test_sharded_plan_json_round_trip_replays():
    plan, _ = _plans("qwen2-vl-2b", EM.TILE_STREAM)
    splan = shard_plan(plan, MeshSpec(chips=4))
    back = ShardedPlan.from_json(splan.to_json())
    assert back.to_dict() == splan.to_dict()
    jback = jshard.ShardedPlan.from_json(splan.to_json())
    assert jback.to_dict() == splan.to_dict()
    a, b = simulate_sharded_plan(splan), simulate_sharded_plan(back)
    assert (a.cycles, a.hbm_bytes, a.collective_bytes) == \
        (b.cycles, b.hbm_bytes, b.collective_bytes)


def test_version_check_raises_as_jax():
    plan, jp = _plans("vilbert-base", EM.TILE_STREAM)
    d = shard_plan(plan, MeshSpec(chips=2)).to_dict()
    d["version"] = 99
    with pytest.raises(ValueError, match="version") as got:
        ShardedPlan.from_dict(d)
    with pytest.raises(ValueError, match="version") as want:
        jshard.ShardedPlan.from_dict(d)
    assert str(got.value) == str(want.value)


def test_tampered_collective_bytes_raise_as_jax():
    plan, jp = _plans("vilbert-base", EM.TILE_STREAM)
    errors = []
    for pkg, p in ((shard, plan), (jshard, jp)):
        splan = pkg.shard_plan(p, pkg.MeshSpec(chips=4))
        colls = list(splan.collectives)
        colls[0] = dataclasses.replace(colls[0],
                                       link_bytes=colls[0].link_bytes + 1)
        bad = dataclasses.replace(splan, collectives=tuple(colls))
        with pytest.raises(RuntimeError, match="NoC link bytes") as err:
            pkg.simulate_sharded_plan(bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_axis_resolution_and_validation_as_jax():
    vb, jvb = _plans("vilbert-base", EM.TILE_STREAM)
    for chips in CHIPS:
        assert resolve_axis(vb, MeshSpec(chips=chips)) == \
            jshard.resolve_axis(jvb, jshard.MeshSpec(chips=chips))
    assert resolve_axis(vb, MeshSpec(chips=4)) == "tensor"
    assert resolve_axis(vb, MeshSpec(chips=8)) == "sequence"
    with pytest.raises(ValueError, match="tensor parallelism"):
        shard_plan(vb, MeshSpec(chips=8), axis="tensor")
    g = shard_plan(vb, MeshSpec(chips=4), axis="group")
    jg = jshard.shard_plan(jvb, jshard.MeshSpec(chips=4), axis="group")
    assert g.to_dict() == jg.to_dict()
    assert {c.kind for c in g.collectives} <= {"multicast", "p2p"}
    _same_sim(simulate_sharded_plan(g), jshard.simulate_sharded_plan(jg))
    with pytest.raises(ValueError, match="group parallelism"):
        shard_plan(vb, MeshSpec(chips=1000), axis="group")


def test_mesh_spec_validation_and_round_trip():
    for kw, match in ((dict(chips=0), "chips"),
                      (dict(chips=2, topology="torus"), "topology"),
                      (dict(chips=2, axis="expert"), "axis")):
        with pytest.raises(ValueError, match=match):
            MeshSpec(**kw)
    m = MeshSpec(chips=4, topology="line", hop_cycles=7)
    assert MeshSpec.from_dict(m.to_dict()) == m
    assert m.to_dict() == jshard.MeshSpec(chips=4, topology="line",
                                          hop_cycles=7).to_dict()


def test_sharding_predicates_equal_jax():
    """The port's distributed.sharding predicates over a simulated mesh
    equal the JAX rule table's on every registry arch."""
    from repro.distributed import sharding as jsharding
    for name in jregistry.ARCHS:
        cfg, jcfg = registry.get_config(name), jregistry.get_config(name)
        for m in (1, 2, 3, 4, 8, 16):
            mesh = sharding._SimulatedMesh({"data": 2, "model": m})
            jmesh = jsharding._SimulatedMesh({"data": 2, "model": m})
            for fn in ("heads_shardable", "kv_heads_shardable",
                       "experts_shardable"):
                assert getattr(sharding, fn)(cfg, mesh) == \
                    getattr(jsharding, fn)(jcfg, jmesh), (name, m, fn)
    assert sharding._axis_size(sharding._SimulatedMesh({}), "model") == 1


def test_shard_sweep_equals_jax():
    from repro.dse import run_shard_sweep as jrun
    from repro_torch.dse import run_shard_sweep   # re-exported
    kw = dict(chips=(1, 2), smoke=True, keep_plans=True)
    res = run_shard_sweep(["vilbert-base"], modes=[EM.TILE_STREAM], **kw)
    want = jrun(["vilbert-base"], modes=[JEM.TILE_STREAM], **kw)
    assert res.to_dict() == want.to_dict()
    one = next(r for r in res.rows if r.chips == 1)
    assert one.speedup == 1.0 and one.efficiency == 1.0
    assert all(r.bottleneck for r in res.rows)
    row = next(r for r in res.rows if r.chips == 2)
    replay = simulate_sharded_plan(ShardedPlan.from_dict(row.plan_json))
    assert replay.cycles == row.latency_cycles


def test_cli_writes_jax_artifact(tmp_path, capsys):
    """``python -m repro_torch.shard --json`` (run as a module) writes the
    artifact ``python -m repro.shard`` writes, and prints its table."""
    argv = ["--models", "vilbert-base", "--chips", "1,2,4", "--modes",
            "tile_stream,layer_stream", "--topologies", "ring,line",
            "--smoke", "--json"]
    assert jcli.main(argv + [str(tmp_path / "jax.json")]) == 0
    jtext = capsys.readouterr().out
    out = tmp_path / "port.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.shard", *argv, str(out)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr
    assert json.loads(out.read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    assert run.stdout.replace(str(out), "") == \
        jtext.replace(str(tmp_path / "jax.json"), "")
    assert "speedup" in run.stdout and "bottleneck" in run.stdout


def test_mesh_serving_raises_citing_item_13():
    """Mesh serving is ported (the name is from when both functions raised,
    citing ROADMAP item 13): replicated, each rank's prefill is the
    model's own, and its decode step is ``model.decode_step``
    (tests/test_torch_mesh.py serves with the Engine, which replicates
    the model and then makes the same two calls, on gloo meshes)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import Transformer
    from repro_torch.shard import mesh_decode_fn, mesh_prefill
    cfg = registry.get_config("qwen2-vl-2b", smoke=True)
    model = Transformer(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(np.arange(1, 17)[None, :])}
    got, cache = mesh_prefill(model, batch, mesh=None, max_len=32, plan=None)
    want, _ = model.prefill(batch, max_len=32)
    assert torch.equal(got, want) and cache["len"] == 16
    assert mesh_decode_fn(model, None) == model.decode_step
