"""The port's dry run against the JAX package's on the CPU
(``repro_torch.launch.dryrun``, ``launch.op_analysis``,
``sim.replay.cost_analysis_cycles``): the pure helpers for every arch and
shape, a qwen3-32b smoke train cell on a fake (2, 2) world with every
field of the JAX artifact (dryrun.py:397-427), its per-device FLOPs at
(1, 1) beside ``hlo_analysis.analyze`` of the JAX step compiled on one CPU
device, the collective traffic formulas (tests/test_hlo_analysis.py:
104-119) and the cycles of a matmul chain; the hint table
(``hint_shardings``) against JAX's specs, the CLI's ``--hints``,
``--tag``, ``--moe-groups`` and ``--optimized`` with JAX's meaning, and
smoke train cells of the MoE family (EP, expert-TP, MLA's heads), of
context-parallel attention, and of the SSM, crossmodal and
encoder-decoder families split over 'model'."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jregistry
from repro.core.types import SHAPES as JSHAPES
from repro.launch import hlo_analysis as HA
from repro.sim import replay as jreplay
from repro.train import steps as JST
from repro_torch.configs import registry
from repro_torch.core.types import SHAPES, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.sim.replay import cost_analysis_cycles

# repro/launch/dryrun.py sets XLA_FLAGS (512 host devices) when imported:
# bring the backend up first, and put the variable back after.
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(registry.ARCHS)
SMOKE_SHAPE = ShapeConfig("train_4k", 64, 4, "train")
# every field of the JAX artifact (dryrun.py:397-427)
FIELDS = {"arch", "shape", "mesh", "devices", "status", "lower_s",
          "compile_s", "microbatches", "hlo_flops_per_device",
          "hlo_bytes_per_device", "raw_flops_uncorrected", "probe_corrected",
          "model_flops_global", "model_flops_per_device",
          "useful_flop_ratio", "memory", "collectives", "roofline"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "total_bytes"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "dcn_s", "bottleneck",
            "step_time_est_s", "roofline_fraction"}


class _Sizes:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", ARCHS)
def test_pure_helpers_equal_jax(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert D._stack_depths(cfg) == JD._stack_depths(jcfg)
    names, plan = D.probe_plan(cfg)
    assert (names, plan) == JD.probe_plan(jcfg)
    for depths in plan:
        a, b = D._with_depths(cfg, depths), JD._with_depths(jcfg, depths)
        for f in ("num_layers", "num_encoder_layers", "num_coattn_layers",
                  "first_dense_layers"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.param_count() == b.param_count()
    vals = [3.0 + 7 * i + i * i for i in range(len(plan))]
    real = D._stack_depths(cfg)
    assert D.extrapolate(names, plan, vals, real) == \
        JD.extrapolate(names, plan, vals, real)
    for name in SHAPES:
        assert D.model_flops(cfg, SHAPES[name]) == \
            JD.model_flops(jcfg, JSHAPES[name])
        for sizes in ({"data": 16, "model": 16},
                      {"pod": 2, "data": 16, "model": 16},
                      {"data": 1, "model": 1}):
            assert D.auto_microbatches(cfg, SHAPES[name], _Sizes(sizes)) \
                == JD.auto_microbatches(jcfg, JSHAPES[name], _Sizes(sizes))


@pytest.fixture
def no_group():
    """The fake world must be the process's only group: drop one another
    test file left in this worker."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


def _smoke_cell(mesh_shape, cfg=None, **kw):
    return D.run_cell("qwen3-32b", "train_4k", verbose=False,
                      cfg=cfg or registry.get_config("qwen3-32b", smoke=True),
                      shape=SMOKE_SHAPE, mesh_shape=mesh_shape,
                      microbatches=1, **kw)


def test_smoke_train_cell_on_a_fake_2x2_world(no_group, tmp_path):
    r = _smoke_cell((2, 2), out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("error")
    assert FIELDS <= set(r)
    assert set(r["memory"]) == MEMORY and ROOFLINE <= set(r["roofline"])
    assert r["devices"] == 4 and r["mesh"] == "2x2"
    assert r["memory"]["argument_bytes"] > 0
    # the gradients and the loss reduce over 'data', the 'model' ranks sum
    # their row-parallel products: all-reduces, all inside the one pod.
    # Below the FSDP threshold nothing is sharded over 'data', and every
    # parameter the rules split over 'model' is computed on its block:
    # nothing is gathered
    counts = r["collectives"]["counts"]
    assert counts.get("all-reduce", 0) > 0
    assert "all-gather" not in counts and "reduce-scatter" not in counts
    assert r["replicated_over_model"] == [] and r["fsdp"] is False
    assert "gathered_step" not in r
    # the traffic by axis: the gradients' and the loss's sums over
    # 'data', the row-parallel sums over 'model'; together the in-pod bytes
    by_axis = r["collectives"]["traffic_by_axis"]
    assert set(by_axis) == {"data", "model"}
    assert sum(by_axis.values()) == pytest.approx(
        r["collectives"]["ici_traffic_bytes"])
    assert r["collectives"]["dcn_traffic_bytes"] == 0
    saved = json.loads((tmp_path / "qwen3-32b__train_4k__2x2.json")
                       .read_text())
    assert saved == json.loads(json.dumps(r))


def test_mesh_step_reduce_scatters_the_data_sharded_gradients(no_group):
    """With every parameter sharded over 'data' where the rules allow
    (fsdp_threshold=0), the mesh step reduces each such gradient straight
    to its block (a reduce-scatter) and all-reduces only the others, the
    loss and the global norm's sum (one a mesh dim), beside the 'model'
    axis's own sums.  It gathers a unit at a time over 'data': the
    embedding and the head once, each layer's parameters twice (the
    forward and the recomputation), and nothing whole over 'model'.

    The 'model' sums of qwen3-32b smoke's 2 layers: the embedding's rows,
    each layer's attention and MLP outputs in the forward and in the
    recomputation, but the last one of the recomputation (checkpoint stops
    once the saved tensors are back), the vocabulary-parallel loss's max
    and sums (forward and recomputation), and in the backward each layer's
    attention and MLP inputs, its two qk-norm gains, and the unembed's
    input: 1 + 2 * (4 - 1) + 4 + 2 * 4 + 1."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    from repro_torch.core import runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop as L
    from repro_torch.train import steps as ST
    cfg = registry.get_config("qwen3-32b", smoke=True)
    with D.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            with runtime.flags(abstract_init=True):
                model = L.build_model(cfg, torch.device("cpu"), 0)
            step = ST.MeshTrainStep(cfg, model, mesh, fsdp_threshold=0)
            batch, _ = D._local_inputs(cfg, SMOKE_SHAPE, mesh)
            _, c = OA.analyze(step.step, batch, world=4)
    pls = {k: s.placements for k, s in step.shardings.items()}
    on_data = {k for k, p in pls.items() if isinstance(p[0], Shard)}
    assert on_data
    assert c["counts"]["reduce-scatter"] == len(on_data)
    layers = cfg.num_layers
    model_sums = 1 + layers * (4 - 1) + 4 + layers * 4 + 1
    assert c["counts"]["all-reduce"] == len(pls) - len(on_data) + 1 + 2 \
        + model_sums
    in_layers = sum(k.startswith("layers.") for k in on_data)
    assert c["counts"]["all-gather"] == 2 * in_layers + len(
        on_data) - in_layers


@pytest.mark.parametrize("fsdp_threshold", [0.0, float("inf")])
def test_replicated_gradients_reduce_once_a_step(no_group, fsdp_threshold):
    """On a fake (2, 1) world (no 'model' sums), a step of 2 microbatches
    reduce-scatters each data-sharded gradient once a microbatch and
    all-reduces each gradient replicated over 'data' once a step: as many
    all-reduces as a step of one microbatch, twice its reduce-scatters.
    Below the FSDP threshold (inf) nothing is sharded over 'data', at 0
    everything."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop as L
    from repro_torch.train import steps as ST
    cfg = registry.get_config("qwen3-32b", smoke=True)
    counts = {}
    with D.fake_world(2):
        mesh = make_mesh((2, 1), ("data", "model"), "cpu")
        for mb in (1, 2):
            with FakeTensorMode(allow_non_fake_inputs=True):
                with runtime.flags(abstract_init=True):
                    model = L.build_model(cfg, torch.device("cpu"), 0)
                step = ST.MeshTrainStep(cfg, model, mesh, microbatches=mb,
                                        fsdp_threshold=fsdp_threshold)
                batch, _ = D._local_inputs(cfg, SMOKE_SHAPE, mesh)
                _, c = OA.analyze(step.step, batch, world=2)
            counts[mb] = c["counts"]
    n = len(step.names)
    held = len(step._held_pl)
    # at threshold 0 every parameter of qwen3-32b smoke shards over 'data'
    assert held == (n if fsdp_threshold == float("inf") else 0)
    # each replicated gradient, the loss and the norm's sum (over 'data':
    # the one-rank 'model' dim needs none)
    assert counts[1]["all-reduce"] == counts[2]["all-reduce"] == held + 2
    assert counts[2].get("reduce-scatter", 0) == 2 * counts[1].get(
        "reduce-scatter", 0) == 2 * (n - held)


def _shard_bytes(cfg, sizes, batch_bytes: int = 0,
                 fsdp_threshold: float = 8e9) -> int:
    """The rule table's blocks of every parameter at ``sizes``
    (``param_shardings`` at those axis sizes), each in the parameter's
    dtype plus its two f32 AdamW moments, and the rank's batch."""
    specs = registry.param_specs(cfg)
    sh = SH.param_shardings(specs, cfg, axis_sizes=sizes,
                            fsdp_threshold=fsdp_threshold)
    total = 0
    for k, spec in specs.items():
        n = 1
        for d, entry in zip(spec.shape, sh[k].spec):
            div = 1
            for a in SH._axes(entry):
                div *= sizes[a]
            n *= d // div
        total += n * (torch.empty((), dtype=spec.dtype).element_size() + 8)
    return total + batch_bytes


def test_qwen3_32b_train_cell_computes_sharded(no_group):
    """The production qwen3-32b train_4k cell on the fake (16, 16) world, cut
    to one layer (the rules and the FSDP choice are the whole model's):
    no gathered step, nothing the rules split over 'model' computed
    replicated, the arguments the rule table's blocks (bf16 parameters and
    f32 moments, within 1%), the data-sharded gradients reduce-scattered,
    and at most 2.5x the model's FLOPs a device (the step that gathered
    whole parameters: 18.4x at 4 layers)."""
    r = D.run_cell("qwen3-32b", "train_4k", verbose=False, depth=1,
                   extra_flags={"block_k": D.BLOCK_K})
    assert r["status"] == "ok", r.get("error")
    assert "gathered_step" not in r and r["replicated_over_model"] == []
    assert r["fsdp"] is True and r["microbatches"] == 1
    cfg = D._with_depths(registry.get_config("qwen3-32b"), {"layers": 1})
    sizes = {"data": 16, "model": 16}
    # the whole model's 32.8 B parameters are over the FSDP threshold
    want = _shard_bytes(cfg, sizes, batch_bytes=2 * 16 * 4096 * 8,
                        fsdp_threshold=0)
    assert abs(r["memory"]["argument_bytes"] - want) <= 0.01 * want
    assert r["collectives"]["counts"].get("reduce-scatter", 0) >= 1
    assert r["hlo_flops_per_device"] <= 2.5 * r["model_flops_per_device"]


def test_per_layer_arithmetic_and_memory_on_small_meshes(no_group):
    """qwen3-32b smoke at 1 and 2 layers on fake (1, 1), (1, 4) and (2, 2)
    worlds.  A layer's FLOPs a device on (2, 2) (heads, kv heads and d_ff
    halved, the batch halved) are a quarter of (1, 1)'s exactly; on (1, 4)
    a quarter too but for the K/V projections of the 2 kv heads, which 4
    does not divide: each rank projects the kv head its 2 query heads
    read, a half.  Those projections count five times a step (forward,
    recomputation, the stream backward's regeneration, dW, dX).  The
    arguments are the rule table's blocks and the batch, to the byte."""
    from repro_torch.distributed import sharding as SHD
    cfg = registry.get_config("qwen3-32b", smoke=True)
    flops, args = {}, {}
    for mesh_shape in ((1, 1), (1, 4), (2, 2)):
        for layers in (1, 2):
            c = dataclasses.replace(cfg, num_layers=layers)
            r = _smoke_cell(mesh_shape, cfg=c)
            assert r["status"] == "ok", r.get("error")
            flops[mesh_shape, layers] = r["hlo_flops_per_device"]
            args[mesh_shape, layers] = r["memory"]["argument_bytes"]
            sizes = dict(zip(("data", "model"), mesh_shape))
            dp = sizes["data"]
            assert args[mesh_shape, layers] == _shard_bytes(
                c, sizes, batch_bytes=2 * (4 // dp) * 64 * 8)
    layer = {m: flops[m, 2] - flops[m, 1] for m in ((1, 1), (1, 4), (2, 2))}
    assert layer[2, 2] == layer[1, 1] / 4
    T = 4 * 64
    kv = 5 * 2 * 2 * T * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    assert layer[1, 4] == layer[1, 1] / 4 + kv * (1 / 2 - 1 / 4)
    assert SHD.kv_heads_shardable(cfg, SHD._SimulatedMesh({"model": 2}))


def _jax_step_flops(remat: bool) -> float:
    """hlo_analysis.analyze's FLOPs of the JAX train step on one CPU
    device, qwen3-32b smoke, 4 x 64 tokens."""
    from repro.train import optimizer as JOPT
    jcfg = jregistry.get_config("qwen3-32b", smoke=True)
    pspecs = jregistry.param_specs(jcfg)
    ospecs = jax.eval_shape(JOPT.init, pspecs)
    bspecs = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32)
              for k in ("tokens", "labels")}
    text = jax.jit(JST.make_train_step(jcfg, remat=remat)).lower(
        pspecs, ospecs, bspecs).compile().as_text()
    return HA.analyze(text, total_devices=1, multi_pod=False)["flops"]


def test_per_device_flops_at_1x1_match_the_jax_step(no_group):
    """The port's matmul FLOPs on (1, 1) against the HLO analyzer's count
    of the JAX train step compiled on one CPU device.  Without remat
    within 5% (the gap: the port's chunked cross-entropy recomputes its
    unembed chunk in the backward, 2·T·D·V).  With remat (both steps'
    default) the port's count exceeds JAX's by that and by at most each
    layer's o and down projections: torch.utils.checkpoint recomputes a
    layer whole, where XLA drops recomputed products whose outputs feed
    no gradient."""
    cfg = registry.get_config("qwen3-32b", smoke=True)
    T, D, V = 4 * 64, cfg.d_model, cfg.vocab_size
    unembed = 2 * T * D * V
    last = cfg.num_layers * 2 * T * (
        cfg.num_heads * cfg.head_dim * D + cfg.d_ff * D)
    plain = _smoke_cell((1, 1), remat=False)["hlo_flops_per_device"]
    want = _jax_step_flops(remat=False)
    assert abs(plain - want) <= 0.05 * want and plain - want == unembed
    got = _smoke_cell((1, 1))["hlo_flops_per_device"]
    assert 0 < got - _jax_step_flops(remat=True) - unembed <= last


def test_failed_and_skipped_cells(no_group):
    """A cell whose step cannot run is status "error" with the exception
    (vilbert has no prefill, in JAX either); a cell the registry skips is
    "skipped" with its reason."""
    r = D.run_cell("vilbert-base", "prefill_32k", verbose=False,
                   cfg=registry.get_config("vilbert-base", smoke=True),
                   shape=ShapeConfig("prefill_32k", 64, 2, "prefill"),
                   mesh_shape=(1, 1))
    assert r["status"] == "error" and "prefill" in r["error"]
    r = D.run_cell("qwen3-32b", "long_500k", verbose=False)
    assert r["status"] == "skipped"
    assert r["reason"] == jregistry.cell_supported("qwen3-32b", "long_500k")


def test_fake_world_refuses_a_second_group(no_group):
    with D.fake_world(4):
        with pytest.raises(RuntimeError, match="own process"):
            with D.fake_world(4):
                pass


def test_collective_traffic_reproduces_the_hlo_analyzer():
    """tests/test_hlo_analysis.py:104-119: an all-reduce over groups of 4
    and an all-gather over groups of 2 of a (16, 16) f32 tensor."""
    hlo = """
HloModule m, entry_computation_layout={()->f32[]}

ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ar = f32[16,16]{1,0} all-reduce(%p), replica_groups=[2,4]<=[8], use_global_device_ids=true, to_apply=%add
  ROOT %ag = f32[16,16]{1,0} all-gather(%ar), replica_groups=[4,2]<=[8], dimensions={0}
}
"""
    size = 16 * 16 * 4
    want = HA.analyze(hlo, total_devices=8, multi_pod=False)["ici"]
    got = (OA.collective_traffic("all-reduce", size, 4)
           + OA.collective_traffic("all-gather", size, 2))
    assert got == want == 2 * size * 3 / 4 + size / 2
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert OA.collective_traffic(kind, size, 4) == {
            "reduce-scatter": size * 3, "all-to-all": size * 3 / 4,
            "collective-permute": size}[kind]


def test_cost_analysis_cycles_equals_jax():
    """A chain of matmuls: 5,242,880 FLOPs, 15 cycles of streamdcim-base,
    as the JAX package's XLA cost analysis gives."""
    shapes = ((64, 128), (128, 256), (256, 32))
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    got = cost_analysis_cycles(lambda a, b, c: (a @ b) @ c,
                               *map(torch.from_numpy, arrays))
    want = jreplay.cost_analysis_cycles(lambda a, b, c: (a @ b) @ c,
                                        *map(jnp.asarray, arrays))
    assert got == want == (15, 5242880)


def test_cli_writes_an_ok_artifact(tmp_path):
    """One cell through the CLI, in its own process, at depth 1."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--depth", "1", "--out",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    r = json.loads((tmp_path / "whisper-base__decode_32k__16x16.json")
                   .read_text())
    assert r["status"] == "ok" and r["depths"] == {"enc": 1, "dec": 1}
    assert "[16x16" in res.stdout


def test_hint_shardings_give_the_jax_specs():
    """The four names' specs on small meshes of ("data", "model") and
    ("pod", "data", "model") axes, against dryrun.py:308-322's."""
    from jax.sharding import Mesh
    from repro_torch.distributed.hints import hint_shardings
    names = ["embed_out", "attn_q", "attn_out", "moe_dispatch"]
    for axes in (("data", "model"), ("pod", "data", "model")):
        jmesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)),
                     axes)
        want = {k: tuple(v.spec) for k, v in JD.hint_shardings(
            names, jmesh).items()}
        got = hint_shardings(names, SH._SimulatedMesh(
            {a: 2 for a in axes}))
        assert {k: spec for k, (_, spec) in got.items()} == want
        assert hint_shardings([], jmesh) == {}


def test_cli_switches_reach_run_cell(monkeypatch):
    """--hints, --tag and --moe-groups reach run_cell as given;
    --optimized adds JAX's preset (dryrun.py:503-523): embed_out, attn_q
    and attn_out for heads that 16 does not divide, moe_groups = 16 (32 on
    two pods) for MoE archs, block_k 2048, the tag "optimized"."""
    seen = []

    def fake(arch, shape, **kw):
        seen.append((arch, kw))
        return {"status": "ok"}
    monkeypatch.setattr(D, "run_cell", fake)
    assert D.main(["--arch", "qwen3-32b", "--shape", "train_4k", "--hints",
                   "attn_q,attn_out", "--tag", "cp", "--moe-groups",
                   "4"]) == 0
    kw = seen[-1][1]
    assert kw["hints"] == ["attn_q", "attn_out"] and kw["tag"] == "cp"
    assert kw["extra_flags"] == {"block_k": D.BLOCK_K, "moe_groups": 4}
    for arch, multi_pod, want, groups in (
            ("starcoder2-7b", False, ["embed_out", "attn_q", "attn_out"],
             None),
            ("qwen3-32b", False, ["embed_out"], None),
            ("deepseek-v3-671b", False, ["embed_out"], 16),
            ("grok-1-314b", True, ["embed_out"], 32)):
        argv = ["--arch", arch, "--shape", "train_4k", "--optimized"]
        assert D.main(argv + ["--multi-pod"] * multi_pod) == 0
        kw = seen[-1][1]
        assert kw["hints"] == want and kw["tag"] == "optimized"
        assert kw["extra_flags"].get("moe_groups") == groups
        assert kw["extra_flags"]["block_k"] == 2048


@pytest.mark.parametrize("arch,mesh_shape", [("deepseek-v3-671b", (1, 4)),
                                             ("grok-1-314b", (1, 8))])
def test_moe_smoke_train_cells_compute_on_their_blocks(no_group, arch,
                                                       mesh_shape, tmp_path):
    """deepseek-v3 smoke on a 'model' axis of 4 (EP: 2 of 8 experts; MLA:
    1 of 4 heads) and grok-1 smoke on 8 (expert-TP: 4 experts, each
    expert's d_ff over 8): nothing the rules split is computed replicated,
    and under the hints the result carries them and its tag (and the
    artifact's name); a rank counts under half of one device's FLOPs."""
    cfg = registry.get_config(arch, smoke=True)
    r = D.run_cell(arch, "train_4k", verbose=False, cfg=cfg,
                   shape=SMOKE_SHAPE, mesh_shape=mesh_shape, microbatches=1,
                   hints=["embed_out", "moe_dispatch"], tag="hinted",
                   out_dir=str(tmp_path))
    assert r["status"] == "ok", r.get("error")
    assert r["replicated_over_model"] == []
    assert r["hints"] == ["embed_out", "moe_dispatch"] and r["tag"] == "hinted"
    m = mesh_shape[1]
    saved = json.loads((tmp_path / f"{arch}__train_4k__1x{m}__hinted.json")
                       .read_text())
    assert saved["tag"] == "hinted"
    # a rank computes its share of most of the step (experts or their
    # d_ff, MLA's heads, the MLPs, the vocabulary): under half of one
    # device's step
    one = D.run_cell(arch, "train_4k", verbose=False, cfg=cfg,
                     shape=SMOKE_SHAPE, mesh_shape=(1, 1), microbatches=1)
    assert r["hlo_flops_per_device"] < one["hlo_flops_per_device"] / 2


def test_context_parallel_smoke_cell_counts_fewer_flops(no_group):
    """minitron-4b smoke (6 heads, which 4 does not divide) on a fake
    (1, 4) world: under --optimized's hints (attn_q: context-parallel
    attention) a rank counts fewer FLOPs than without them, where every
    rank runs the whole attention."""
    cfg = registry.get_config("minitron-4b", smoke=True)
    hints, tag, extra = D.cell_options(
        "minitron-4b", hints=[], tag="", moe_groups=1, block_k=D.BLOCK_K,
        optimized=True, multi_pod=False)
    assert "attn_q" in hints and tag == "optimized"
    flops = {}
    for h in ([], hints):
        r = D.run_cell("minitron-4b", "train_4k", verbose=False, cfg=cfg,
                       shape=SMOKE_SHAPE, mesh_shape=(1, 4), microbatches=1,
                       hints=h, extra_flags=extra)
        assert r["status"] == "ok", r.get("error")
        flops[bool(h)] = r["hlo_flops_per_device"]
    assert flops[True] < flops[False]


@pytest.fixture(scope="module")
def one_device_flops():
    """{arch: FLOPs of its smoke train cell on (1, 1)}, each traced once."""
    seen = {}

    def flops(arch):
        if arch not in seen:
            seen[arch] = D.run_cell(
                arch, "train_4k", verbose=False,
                cfg=registry.get_config(arch, smoke=True), shape=SMOKE_SHAPE,
                mesh_shape=(1, 1), microbatches=1)["hlo_flops_per_device"]
        return seen[arch]
    return flops


@pytest.mark.parametrize("arch,m,hinted", [
    ("mamba2-780m", 4, False), ("hymba-1.5b", 4, False),
    ("vilbert-base", 4, False), ("whisper-base", 4, False),
    ("whisper-base", 8, True)])
def test_the_last_families_smoke_train_cells_split_over_model(
        no_group, one_device_flops, arch, m, hinted):
    """The SSM projections (mamba2-780m and hymba-1.5b smoke: a head of 4
    a rank), vilbert's co-TRM and text-only layers (a head of 4 a
    stream) and whisper's encoder and decoder (a head of 4; at 8 under
    the attn_q hint, context-parallel) on a fake (1, m) world: nothing
    the rules split is computed replicated, and a rank counts under half
    of one device's FLOPs."""
    cfg = registry.get_config(arch, smoke=True)
    r = D.run_cell(arch, "train_4k", verbose=False, cfg=cfg,
                   shape=SMOKE_SHAPE, mesh_shape=(1, m), microbatches=1,
                   hints=["attn_q", "attn_out"] if hinted else None)
    assert r["status"] == "ok", r.get("error")
    assert r["replicated_over_model"] == []
    assert r["hlo_flops_per_device"] < one_device_flops(arch) / 2
