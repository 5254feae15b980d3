"""The port's mesh paths on ``torch.distributed`` against the JAX package
and the single-device path on the CPU (gloo): worlds of 4 and 2 ranks
started by ``torchrun --standalone`` (each rank a process, the
rendezvous on a free local port), and the one-rank host mesh in this
process.

* ``cross_pod_mean_int8`` on a (2, 2, 1) (pod, data, model) mesh equals a
  numpy version of the JAX arithmetic bitwise, and the traffic that
  ``launch.op_analysis`` counts is below half of an f32 ring all-reduce of
  the same tree (tests/test_compression_lowering.py:51-57);
* ``gather_matmul_overlapped`` on a 4-rank 'model' axis equals ``x @ w``
  within 1e-4, over point-to-point sends and no all-gather
  (tests/test_pipeline.py:20-26);
* the Engine on starcoder2-7b and qwen2-vl-2b smoke (JAX weights through
  ``convert``): the (1, 1) mesh and every rank of a 2-rank world give the
  JAX Engine's tokens (tests/test_shard.py:266);
* ``train`` on qwen3-32b smoke for 3 steps on the (1, 1) mesh and on a
  (2, 2) world at fsdp_threshold=0 matches the single-device run within
  2e-5 (tests/test_system.py:55-60), and the (1, 1) run from the JAX
  loop's initial weights matches the JAX package's loop within 2e-5; the
  launcher trains under torchrun;
* on the (2, 2) world at fsdp_threshold=0 the step gathers a unit at a
  time (each layer for its forward and its recomputation, the embedding,
  the head) and never holds more than two gathered units at once;
  vilbert-base (a layer a unit), whisper-base (its whole model one
  unit), mamba2-780m and hymba-1.5b (their SSM projections split over
  'model') train there with the single-device losses and gradient norms
  (vilbert-base's third at the mesh run's own parameters);
* on the (1, 4) world vilbert-base and whisper-base train on a head a
  rank with the single-device losses and gradient norms, vilbert's DTPU
  pruning keeping one device's tokens; ``parallel.gather_cols``'s
  backward reduce-scatters on the 'model' group;
* a (1, 4) ("data", "model") world computes tensor-parallel: qwen3-32b
  smoke (8 query heads split, its 2 kv heads replicated and sliced),
  h2o-danube3-4b smoke (a sliding window) and one arch of every other
  decoder family (``TP_ARCHS``: deepseek-v3 smoke on 2 of its 8
  experts and 1 of its 4 MLA heads a rank), and under the attn_q hint
  minitron-4b and hymba-1.5b smoke with context-parallel attention
  (``CP_ARCHS``), train within 2e-5 of the single-device run in losses
  and every parameter, qwen3-32b from the JAX loop's initial weights within
  2e-5 of the JAX loop's losses, and a rank's step counts at most 0.35 of
  the single-device step's FLOPs (FlopCounterMode);
* 2 microbatches a step on the (2, 2) world match the single-device run
  of 2 microbatches within 2e-5;
* a checkpoint saved on the (2, 2) world restores bitwise on one process
  and on a (2, 1) world (tests/test_system.py:63-76).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jregistry
from repro.core.types import ShapeConfig as JShape
from repro.serve.engine import Engine as JEngine, Request as JRequest
from repro_torch.configs import registry
from repro_torch.convert import transformer_from_jax
from repro_torch.core.types import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import loop as L
from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.steps import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARCHS = ["starcoder2-7b", "qwen2-vl-2b"]
# trained on the (1, 4) world: dense GQA (qwen3-32b: kv heads sliced;
# h2o-danube3-4b: a window), M-RoPE with tied embeddings (qwen2-vl-2b),
# SSM with tied embeddings (mamba2-780m: the vocabulary alone splits), a
# hybrid whose 5 heads 4 does not divide (hymba-1.5b), MoE with split
# attention and one expert a rank (grok-1-314b), MLA on a head a rank and
# MoE on 2 experts a rank with a dense prefix and a shared expert
# (deepseek-v3-671b)
TP_ARCHS = ["qwen3-32b", "h2o-danube3-4b", "qwen2-vl-2b", "mamba2-780m",
            "hymba-1.5b", "grok-1-314b", "deepseek-v3-671b"]
# trained on the (1, 4) world under the hint table's attn_q: attention
# context-parallel (heads that 4 does not divide: minitron-4b's 6,
# hymba-1.5b's 5 with its 16-key window)
CP_ARCHS = ["minitron-4b", "hymba-1.5b"]
# trained on the (1, 4) world beside TP_ARCHS: vilbert-base (a head of 4 a
# stream, its pruning's token choice summed over 'model') and whisper-base
# (a head of 4, its cross-attention's K/V from the encoder states, the
# tied vocabulary's loss over 'model')
FAMILY_ARCHS = ["vilbert-base", "whisper-base"]
# trained on the (2, 2) world at fsdp_threshold=0: the families whose
# layers the step splits over 'model' since the SSM projections
OTHER_ARCHS = ["vilbert-base", "whisper-base", "mamba2-780m", "hymba-1.5b"]
REQUESTS = [(8, 4, 0), (12, 3, 1)]           # prompt length, new, arrival
SHAPE = ShapeConfig("sys", seq_len=64, global_batch=4, kind="train")
STEPS = 3

COMMON = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.types import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop as L, optimizer as OPT
    dist.init_process_group("gloo")
    rank, out = dist.get_rank(), sys.argv[1]
    SHAPE = ShapeConfig("sys", seq_len=64, global_batch=4, kind="train")
    cfg = registry.get_config("qwen3-32b", smoke=True)

    def tcfg(ckpt=None):
        return L.TrainConfig(steps=3, log_every=1, checkpoint_every=3,
                             checkpoint_dir=ckpt,
                             opt=OPT.OptimizerConfig(learning_rate=1e-3,
                                                     warmup_steps=5,
                                                     decay_steps=200))

    def dump(name, obj):
        with open(f"{out}/{name}_{rank}.json", "w") as f:
            json.dump(obj, f)
""")

WORLD4 = COMMON + textwrap.dedent("""
    from repro_torch.core.pipeline import gather_matmul_overlapped
    from repro_torch.distributed.compression import cross_pod_mean_int8
    from repro_torch.launch.op_analysis import analyze
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    pod = mesh.get_coordinate()[0]
    g = np.load(f"{out}/grads.npz")
    grads = {k: torch.from_numpy(g[f"{k}{pod}"]) for k in ("w", "b")}
    mean, counts = analyze(cross_pod_mean_int8, grads, mesh, multi_pod=True)
    np.savez(f"{out}/mean_{rank}.npz", **{k: v.numpy() for k, v in
                                          mean.items()})
    dump("compress", counts)
    m4 = make_mesh((4,), ("model",), "cpu")
    x = torch.from_numpy(g["x"])
    w = torch.from_numpy(g["wm"])
    ring, counts = analyze(gather_matmul_overlapped,
                           x[rank * 16:(rank + 1) * 16], w, m4)
    np.save(f"{out}/ring_{rank}.npy", ring.numpy())
    dump("ring", counts)
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    res = L.train(cfg, SHAPE, SyntheticLM(cfg, SHAPE, seed=0),
                  tcfg(f"{out}/ckpt"), device="cpu", mesh=m22,
                  fsdp_threshold=0, gather_model=True)
    from repro_torch.distributed.sharding import batch_shardings
    from repro_torch.train.steps import MeshTrainStep, local_batch
    model, blocks = L.build_sharded(cfg, torch.device("cpu"), 0, m22, 0)
    step = MeshTrainStep(cfg, model, m22, fsdp_threshold=0, blocks=blocks)
    bs = batch_shardings(registry.input_specs(cfg, SHAPE), m22)
    for i in range(2):
        step(L.to_device(local_batch(SyntheticLM(cfg, SHAPE, seed=0)
                                     .batch(i), bs, m22), cfg,
                         torch.device("cpu")))
    dump("units", {"max_live": step.max_live_units,
                   "live": step.live_units, "gathered": step.units_gathered})
    # 2 microbatches below the FSDP threshold: every gradient is held
    # through the microbatches and all-reduced once a step
    tc = tcfg()
    tc.microbatches = 2
    rmb = L.train(cfg, SHAPE, SyntheticLM(cfg, SHAPE, seed=0), tc,
                  device="cpu", mesh=m22, gather_model=True)
    dump("train_mb", [m["loss"] for m in rmb["metrics"]])
    if rank == 0:
        np.savez(f"{out}/params22_mb.npz", **{
            k: p.detach().numpy() for k, p in rmb["model"].named_parameters()})
    # the families whose layers split over 'model' in this slice: the SSM
    # projections, vilbert (a layer, a co-TRM block of both streams, a
    # unit) and whisper (its whole model one unit for the step)
    other = {}
    for arch in %(other_archs)r:
        c = registry.get_config(arch, smoke=True)
        r = L.train(c, SHAPE, SyntheticLM(c, SHAPE, seed=0), tcfg(),
                    device="cpu", mesh=m22, fsdp_threshold=0,
                    gather_model=True)
        model, blocks = L.build_sharded(c, torch.device("cpu"), 0, m22, 0)
        st = MeshTrainStep(c, model, m22, fsdp_threshold=0, blocks=blocks)
        st(L.to_device(local_batch(SyntheticLM(c, SHAPE, seed=0).batch(0),
                                   batch_shardings(registry.input_specs(
                                       c, SHAPE), m22), m22), c,
                       torch.device("cpu")))
        if arch == "vilbert-base":
            # its parameters after 2 steps, where one device's step-3
            # gradient norm is read (_match_single)
            t2 = tcfg()
            t2.steps = 2
            r2 = L.train(c, SHAPE, SyntheticLM(c, SHAPE, seed=0), t2,
                         device="cpu", mesh=m22, fsdp_threshold=0,
                         gather_model=True)
            if rank == 0:
                np.savez(f"{out}/params22_2_{arch}.npz", **{
                    k: p.detach().numpy()
                    for k, p in r2["model"].named_parameters()})
        other[arch] = {"metrics": r["metrics"], "max_live":
                       st.max_live_units, "gathered": st.units_gathered,
                       "resident": len(st.resident),
                       "local": sorted(st.local)}
        if rank == 0:
            np.savez(f"{out}/params22_{arch}.npz", **{
                k: p.detach().numpy() for k, p in r["model"].named_parameters()})
    dump("other22", other)
    dump("train", {"loss": [m["loss"] for m in res["metrics"]],
                   "local": {k: list(p.to_local().shape)
                             for k, p in res["params"].items()}})
    if rank == 0:
        np.savez(f"{out}/params22.npz", **{
            k: p.detach().numpy() for k, p in res["model"].named_parameters()})
""") % {"other_archs": OTHER_ARCHS}

WORLD14 = COMMON + textwrap.dedent("""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.convert import transformer_from_jax
    from repro_torch.distributed.sharding import batch_shardings
    from repro_torch.train.steps import (MeshTrainStep, local_batch,
                                         make_train_step)
    from repro_torch.core import runtime
    from repro_torch.distributed.hints import hint_shardings
    from repro_torch.core import pruning as PR
    from repro_torch.distributed import parallel as PL
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    res = {"blocks": {}, "metrics": {}, "kept": []}
    # gather_cols on the 'model' group: rank r's columns x_r, its loss
    # reading every column with weights w_r
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(rank))
    x.requires_grad_(True)
    w = torch.randn(2, 12, generator=torch.Generator().manual_seed(10 + rank))
    y = PL.ModelParallel(rank, 4, mesh.get_group("model")).gather_cols(x)
    res["gather_cols"] = {"y": y.tolist(), "grad": torch.autograd.grad(
        (y * w).sum(), x)[0].tolist()}
    # the tokens vilbert's DTPU pruning keeps, each call
    prune = PR.prune_stream
    def kept(*a, **k):
        out = prune(*a, **k)
        res["kept"].append(out[1].tolist())
        return out
    PR.prune_stream = kept
    table = hint_shardings(["attn_q", "attn_out"], mesh)
    runs = [(a, a, None) for a in %(tp_archs)r + %(family_archs)r]
    runs += [(a, a + "+cp", table) for a in %(cp_archs)r]
    for arch, key, hints in runs:
        c = registry.get_config(arch, smoke=True)
        with runtime.flags(sharding_hints=hints):
            r = L.train(c, SHAPE, SyntheticLM(c, SHAPE, seed=0), tcfg(),
                        device="cpu", mesh=mesh, gather_model=True)
        res[key] = [m["loss"] for m in r["metrics"]]
        res["metrics"][key] = r["metrics"]
        res["blocks"][key] = {k: list(p.to_local().shape)
                              for k, p in r["params"].items()}
        if rank == 0:
            np.savez(f"{out}/params14_{key}.npz", **{
                k: p.detach().numpy()
                for k, p in r["model"].named_parameters()})
    # vilbert-base's parameters after 2 steps (_match_single), its
    # pruning no longer recorded
    PR.prune_stream = prune
    t2 = tcfg()
    t2.steps = 2
    c = registry.get_config("vilbert-base", smoke=True)
    r = L.train(c, SHAPE, SyntheticLM(c, SHAPE, seed=0), t2, device="cpu",
                mesh=mesh, gather_model=True)
    if rank == 0:
        np.savez(f"{out}/params14_2_vilbert-base.npz", **{
            k: p.detach().numpy()
            for k, p in r["model"].named_parameters()})
    # the JAX loop's initial weights (its losses are the JAX leg's)
    w = dict(np.load(f"{out}/jax_init.npz"))
    tree = {}
    for k, v in w.items():
        node = tree
        *heads, last = k.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    L.build_sharded = lambda c, device, seed, mesh, thr: (
        transformer_from_jax(tree, c, device=device).requires_grad_(True),
        None)
    r = L.train(cfg, SHAPE, SyntheticLM(cfg, SHAPE, seed=0), tcfg(),
                device="cpu", mesh=mesh)
    res["jax_init"] = [m["loss"] for m in r["metrics"]]
    # FLOPs of one step: this rank's against the single-device step's
    batch = SyntheticLM(cfg, SHAPE, seed=0).batch(0)
    cpu = torch.device("cpu")
    step = MeshTrainStep(cfg, L.build_model(cfg, cpu, 0), mesh)
    with FlopCounterMode(display=False) as fc:
        step(L.to_device(local_batch(batch, batch_shardings(
            registry.input_specs(cfg, SHAPE), mesh), mesh), cfg, cpu))
    res["flops"] = fc.get_total_flops()
    single = L.build_model(cfg, cpu, 0)
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg)(single, OPT.init(dict(
            single.named_parameters())), L.to_device(batch, cfg, cpu))
    res["flops_single"] = fc.get_total_flops()
    res["local"] = {k: list(b.shape) for k, b in step.blocks.items()}
    dump("world14", res)
""") % {"tp_archs": TP_ARCHS, "cp_archs": CP_ARCHS,
        "family_archs": FAMILY_ARCHS}

WORLD2 = COMMON + textwrap.dedent("""
    from repro_torch.convert import transformer_from_jax
    from repro_torch.launch import train as launcher
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.steps import MeshTrainStep
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    tokens = {}
    for arch in %(archs)r:
        c = registry.get_config(arch, smoke=True)
        w = dict(np.load(f"{out}/{arch}.npz"))
        tree = {}
        for k, v in w.items():
            node = tree
            *heads, last = k.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = v
        model = transformer_from_jax(tree, c, device="cpu")
        eng = Engine(c, model, slots=2, max_len=48, mesh=mesh)
        for rid, (plen, new, arr) in enumerate(%(reqs)r):
            eng.submit(Request(rid=rid, prompt=np.arange(1, plen + 1,
                                                         dtype=np.int32),
                               max_new_tokens=new, arrival_step=arr))
        tokens[arch] = {str(r.rid): list(r.out_tokens) for r in eng.run()}
    dump("tokens", tokens)
    model = L.build_model(cfg, torch.device("cpu"), 1)
    step = MeshTrainStep(cfg, model, mesh, fsdp_threshold=0)
    ck = Checkpointer(f"{out}/ckpt")
    ck.restore(3, {"params": step.params})
    step.gather()
    if rank == 0:
        np.savez(f"{out}/restored21.npz", **{
            k: p.detach().numpy() for k, p in model.named_parameters()})
    res = launcher.main(["--arch", "qwen3-32b", "--smoke", "--steps", "2",
                         "--seq-len", "16", "--global-batch", "2",
                         "--layers", "1", "--device", "cpu"])
    dump("launcher", [m["loss"] for m in res["metrics"]])
""") % {"archs": SERVE_ARCHS, "reqs": REQUESTS}


def _torchrun(n: int, script: str, out: Path) -> None:
    path = out / f"world{n}.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", str(path), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]


def _load(out: Path, name: str, n: int) -> list:
    return [json.loads((out / f"{name}_{r}.json").read_text())
            for r in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _requests(cls):
    return [cls(rid=rid, prompt=np.arange(1, plen + 1, dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for rid, (plen, new, arr) in enumerate(REQUESTS)]


def _tokens(eng, cls):
    for r in _requests(cls):
        eng.submit(r)
    return {r.rid: list(r.out_tokens) for r in eng.run()}


def _train(mesh=None, arch="qwen3-32b", microbatches=1, **kw):
    cfg = registry.get_config(arch, smoke=True)
    tcfg = L.TrainConfig(steps=STEPS, log_every=1, microbatches=microbatches,
                         opt=OPT.OptimizerConfig(learning_rate=1e-3,
                                                 warmup_steps=5,
                                                 decay_steps=200))
    return L.train(cfg, SHAPE, SyntheticLM(cfg, SHAPE, seed=0), tcfg,
                   device="cpu", mesh=mesh, **kw)


def _jax_loop():
    """The JAX package's loop (repro/train/loop.py) on its host mesh, on
    the config, source, seed and optimizer of ``_train``: its initial
    weights, losses and final weights as numpy trees."""
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.train import loop as JL
    from repro.train import optimizer as JOPT
    jcfg = jregistry.get_config("qwen3-32b", smoke=True)
    jshape = JShape("sys", seq_len=64, global_batch=4, kind="train")
    tcfg = JL.TrainConfig(steps=STEPS, log_every=1,
                          opt=JOPT.OptimizerConfig(learning_rate=1e-3,
                                                   warmup_steps=5,
                                                   decay_steps=200))
    init = jregistry.model_module(jcfg).init(jax.random.PRNGKey(tcfg.seed),
                                             jcfg)
    res = JL.train(jcfg, jshape, JSyntheticLM(jcfg, jshape, seed=0),
                   jmesh(), tcfg)
    return {"init": jax.tree.map(np.asarray, init),
            "losses": [m["loss"] for m in res["metrics"]],
            "params": jax.tree.map(np.asarray, res["params"])}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs made here (the JAX weights and Engine tokens, the gradients
    per pod), the 4- and 2-rank worlds run, and the one-rank host mesh in
    this process (its group destroyed at the end)."""
    out = tmp_path_factory.mktemp("worlds")
    rng = np.random.default_rng(0)
    np.savez(out / "grads.npz",
             **{f"w{p}": rng.standard_normal((256, 256)).astype(np.float32)
                * 0.02 for p in (0, 1)},
             **{f"b{p}": rng.standard_normal(1024).astype(np.float32)
                for p in (0, 1)},
             x=rng.standard_normal((64, 32)).astype(np.float32),
             wm=(rng.standard_normal((32, 48)) * 0.1).astype(np.float32))
    jtokens, weights = {}, {}
    for arch in SERVE_ARCHS:
        cfg = jregistry.get_config(arch, smoke=True)
        params = jregistry.model_module(cfg).init(jax.random.PRNGKey(0), cfg)
        weights[arch] = jax.tree.map(np.asarray, params)
        np.savez(out / f"{arch}.npz", **_flat(weights[arch]))
        jtokens[arch] = _tokens(JEngine(cfg, params, slots=2, max_len=48),
                                JRequest)
    jax_loop = _jax_loop()
    np.savez(out / "jax_init.npz", **_flat(jax_loop["init"]))
    _torchrun(4, WORLD4, out)
    _torchrun(4, WORLD14, out)
    _torchrun(2, WORLD2, out)
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_host_mesh("cpu")
    local = {"tokens": {}}
    for arch in SERVE_ARCHS:
        model = transformer_from_jax(weights[arch],
                                     registry.get_config(arch, smoke=True),
                                     device="cpu")
        cfg = registry.get_config(arch, smoke=True)
        local["tokens"][arch] = {
            m: _tokens(Engine(cfg, model, slots=2, max_len=48, mesh=mm),
                       Request)
            for m, mm in (("none", None), ("mesh", mesh))}
    local["single"] = _train()
    local["single_mb"] = _train(microbatches=2)
    from repro_torch.core import pruning as PR
    kept, prune = [], PR.prune_stream

    def record(*a, **k):
        out = prune(*a, **k)
        kept.append(out[1].tolist())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "prune_stream", record)
        local["single_other"] = {arch: _train(arch=arch)
                                 for arch in OTHER_ARCHS}
    local["kept"] = kept
    local["single_tp"] = {arch: local["single_other"].get(arch)
                          or _train(arch=arch) for arch in TP_ARCHS[1:]}
    local["single_tp"]["qwen3-32b"] = local["single"]
    for arch in CP_ARCHS:
        local["single_tp"][arch + "+cp"] = local["single_tp"].get(
            arch) or _train(arch=arch)
    local["mesh11"] = _train(mesh, gather_model=True)
    local["jax_loop"] = jax_loop
    with pytest.MonkeyPatch.context() as mp:
        # the JAX loop's initial weights, carried across by convert (the
        # mesh path cuts its blocks from the whole model)
        mp.setattr(L, "build_sharded", lambda cfg, device, seed, mesh, thr:
                   (transformer_from_jax(local["jax_loop"]["init"], cfg,
                                         device=device).requires_grad_(True),
                    None))
        local["mesh11_jax_init"] = _train(mesh, gather_model=True)
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.core import runtime
    from repro_torch.distributed.hints import constrain
    x = DTensor.from_local(torch.ones(4, 6, 8), mesh, (Replicate(),) * 2)
    with runtime.flags(sharding_hints={"embed_out": (mesh, (("data",), None,
                                                            "model"))}):
        local["hinted"] = constrain(x, "embed_out").placements
    ck = Checkpointer(str(out / "ckpt"))
    model = L.build_model(registry.get_config("qwen3-32b", smoke=True),
                          torch.device("cpu"), 1)
    params = dict(model.named_parameters())
    ck.restore(3, {"params": params})
    local["restored1"] = {k: p.detach().numpy() for k, p in params.items()}
    dist.destroy_process_group()
    yield out, jtokens, local


def _ring_mean(g: np.ndarray, others: list) -> np.ndarray:
    """The JAX arithmetic (compression.py:25-63) in numpy f32: quantize
    each pod's tensor, sum the dequantized payloads own first, then the
    ring's, and divide by the pods."""
    def quant(x):
        scale = np.float32(np.abs(x).max()) / np.float32(127.0) \
            + np.float32(1e-12)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        return q, np.float32(scale)

    def deq(q, s):
        return q.astype(np.float32) * s
    total = deq(*quant(g))
    for o in others:
        total = total + deq(*quant(o))
    return (total / np.float32(1 + len(others))).astype(np.float32)


def test_cross_pod_mean_int8_equals_numpy_and_halves_traffic(worlds):
    out, _, _ = worlds
    g = np.load(out / "grads.npz")
    for rank in range(4):
        pod = rank // 2
        got = np.load(out / f"mean_{rank}.npz")
        for k in ("w", "b"):
            want = _ring_mean(g[f"{k}{pod}"], [g[f"{k}{1 - pod}"]])
            np.testing.assert_array_equal(got[k], want)
    full = (256 * 256 + 1024) * 4
    f32_ring = 2 * full * (2 - 1) / 2
    for c in _load(out, "compress", 4):
        assert c["counts"] == {"collective-permute": 4}
        assert c["ici"] + c["dcn"] < 0.5 * f32_ring
        assert c["dcn"] > 0                 # the pods' ring crosses pods


def test_ring_matmul_equals_matmul_over_p2p(worlds):
    out, _, _ = worlds
    g = np.load(out / "grads.npz")
    want = g["x"] @ g["wm"]
    for rank, c in enumerate(_load(out, "ring", 4)):
        np.testing.assert_allclose(np.load(out / f"ring_{rank}.npy"), want,
                                   atol=1e-4, rtol=1e-4)
        assert c["counts"] == {"collective-permute": 3}
        assert "all-gather" not in c["counts"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_engine_on_meshes_gives_the_jax_tokens(worlds, arch):
    out, jtokens, local = worlds
    want = jtokens[arch]
    assert local["tokens"][arch]["none"] == want
    assert local["tokens"][arch]["mesh"] == want
    for ranked in _load(out, "tokens", 2):
        assert {int(k): v for k, v in ranked[arch].items()} == want


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def test_train_on_meshes_matches_single_device(worlds):
    out, _, local = worlds
    single = local["single"]
    want = {k: p.detach().numpy()
            for k, p in single["model"].named_parameters()}
    losses = [m["loss"] for m in single["metrics"]]
    for m in ("mesh11",):
        got = local[m]
        _close([x["loss"] for x in got["metrics"]], losses)
        for k, p in got["model"].named_parameters():
            _close(p.detach().numpy(), want[k])
    p22 = np.load(out / "params22.npz")
    for k, v in want.items():
        _close(p22[k], v)
    for r in _load(out, "train", 4):
        _close(r["loss"], losses)
    # fsdp_threshold=0 on (2, 2): the embedding splits over both axes
    shapes = _load(out, "train", 4)[0]["local"]
    full = want["embed.embedding"].shape
    assert tuple(shapes["embed.embedding"]) == (full[0] // 2, full[1] // 2)


def test_microbatches_on_2x2_match_single_device(worlds):
    """2 microbatches a step on (2, 2) below the FSDP threshold (each
    gradient held through the microbatches, then all-reduced once):
    losses and final parameters within 2e-5 of the single-device run of
    2 microbatches."""
    out, _, local = worlds
    single = local["single_mb"]
    losses = [m["loss"] for m in single["metrics"]]
    for r in _load(out, "train_mb", 4):
        _close(r, losses)
    got = np.load(out / "params22_mb.npz")
    for k, p in single["model"].named_parameters():
        _close(got[k], p.detach().numpy())


def test_mesh_step_gathers_a_unit_at_a_time_on_2x2(worlds):
    """fsdp_threshold=0 on (2, 2): every parameter is sharded over 'data'
    where the rules allow, and two steps gather, on every rank, each of
    the 2 layers twice (its forward and its recomputation), the embedding
    and the head once a step, 2 * (2 * 2 + 2) units; the weakref count of
    gathered units that are still alive never exceeds two, and is zero
    after the steps."""
    out, _, _ = worlds
    for r in _load(out, "units", 4):
        assert r["gathered"] == 2 * (2 * 2 + 2)
        assert 1 <= r["max_live"] <= 2
        assert r["live"] == 0


def _one_device_grad_norm(arch: str, params: Path, step: int) -> float:
    """The single-device step's gradient norm at the parameters saved in
    ``params``, on the batch of step ``step`` (from 0) of ``_train``'s
    source."""
    cfg = registry.get_config(arch, smoke=True)
    cpu = torch.device("cpu")
    model = L.build_model(cfg, cpu, 0)
    saved = np.load(params)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(saved[k]))
    batch = L.to_device(SyntheticLM(cfg, SHAPE, seed=0).batch(step), cfg,
                        cpu)
    step_fn = make_train_step(cfg, OPT.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=5, decay_steps=200))
    _, _, metrics = step_fn(model, OPT.init(dict(model.named_parameters())),
                            batch)
    return metrics["grad_norm"]


def _match_single(arch: str, runs: list, single: list, after2: Path):
    """Each mesh rank's losses and gradient norms (``runs``, a metrics
    list a rank) within 2e-5 of the single-device run's, step for step;
    vilbert-base's step-3 gradient norm within 2e-5 of one device's at
    the mesh run's own parameters after 2 steps (``after2``).  Its
    single-device run's reads 6.5e-5 from (2, 2)'s: the two runs'
    parameters after 2 steps differ by up to 3.0e-5 (text_embed), all
    in elements whose gradients are 1e-8 to 1e-7 (the tensors' medians
    1e-3 to 1e-2), where AdamW's eps (1e-8) makes the step follow the
    summation order's last digits; at the mesh's parameters one device
    reads its step-3 norm within 1.2e-6."""
    want = {key: [m[key] for m in single] for key in ("loss", "grad_norm")}
    if arch == "vilbert-base":
        want["grad_norm"][2] = _one_device_grad_norm(arch, after2, 2)
    for metrics in runs:
        for key, w in want.items():
            _close([m[key] for m in metrics], w)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_the_other_families_train_on_2x2(worlds, arch):
    """fsdp_threshold=0 on (2, 2), 3 steps: losses and gradient norms
    within 2e-5 of the single-device run (vilbert-base's third gradient
    norm of one device's at the mesh run's parameters, as
    ``_match_single`` says), each family's layers on the
    rank's 'model' blocks (two heads of 4 a stream for vilbert-base and
    whisper-base; mamba2-780m's SSM on 2 of its 4 heads, its in_proj's
    columns split; hymba-1.5b's too, and its 5 attention heads whole).
    whisper-base (its layers not units) gathers its whole model for the
    step, one unit.  vilbert-base gathers each text-only layer and each
    co-TRM block, its 6 other parameters for the step (2 units at most at
    once: the step's and a layer's); its parameters are not compared: at
    random weights its pooler's tanh saturates, and AdamW turns the
    summation order's noise in those near-zero gradients into steps of
    the learning rate's size (ROADMAP, facts about the reference).  The
    others' parameters end within 2e-5."""
    out, _, local = worlds
    single = local["single_other"][arch]["metrics"]
    _match_single(arch, [r[arch]["metrics"]
                         for r in _load(out, "other22", 4)], single,
                  out / f"params22_2_{arch}.npz")
    want_local = {
        "vilbert-base": ("co_x.0.co_attn.wk", "co_y.1.self_attn.wo",
                         "text_pre.0.attn.wq", "text_embed.embedding"),
        "whisper-base": ("dec_layers.0.cross_attn.wk", "enc_layers.1.attn.wo",
                         "dec_layers.1.mlp.w_up", "embed.embedding"),
        "mamba2-780m": ("layers.0.ssm.in_proj", "layers.1.ssm.out_proj"),
        "hymba-1.5b": ("layers.0.ssm.in_proj", "layers.1.ssm.out_proj",
                       "layers.0.mlp.w_down")}[arch]
    for r in _load(out, "other22", 4):
        got = r[arch]
        assert set(want_local) <= set(got["local"])
        if arch == "whisper-base":
            assert got["gathered"] == 1 and got["max_live"] == 1
        elif arch == "vilbert-base":
            assert got["resident"] == 6 and 2 < got["gathered"]
            assert got["max_live"] == 2
        else:
            assert "layers.0.attn.wq" not in got["local"]
            assert 1 <= got["max_live"] <= 2
    if arch != "vilbert-base":
        p = np.load(out / f"params22_{arch}.npz")
        for k, v in local["single_other"][arch]["model"].named_parameters():
            _close(p[k], v.detach().numpy())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_vilbert_and_whisper_train_on_a_1x4_world(worlds, arch):
    """On (1, 4), one head of 4 a rank: losses and gradient norms within
    2e-5 of the single-device run (``_match_single``; whisper-base's
    parameters too; not vilbert-base's, as on (2, 2)), and every rank
    keeps the tokens one
    device's DTPU pruning keeps, call for call."""
    out, _, local = worlds
    single = local["single_other"][arch]
    _match_single(arch, [r["metrics"][arch] for r in _load(out, "world14", 4)],
                  single["metrics"], out / f"params14_2_{arch}.npz")
    for r in _load(out, "world14", 4):
        b = r["blocks"][arch]
        if arch == "vilbert-base":
            assert b["co_y.0.co_attn.wk"][1] == 1
            assert r["kept"] and r["kept"] == local["kept"]
        else:
            assert b["dec_layers.0.cross_attn.wk"][1] == 1
            assert b["embed.embedding"][0] * 4 == 512
    if arch == "whisper-base":
        got = np.load(out / f"params14_{arch}.npz")
        for k, p in single["model"].named_parameters():
            _close(got[k], p.detach().numpy())


def test_gather_cols_on_gloo_reduce_scatters_its_gradient(worlds):
    """``parallel.gather_cols`` on the (1, 4) world's 'model' group: every
    rank gets the ranks' columns in rank order, and rank r's input
    gradient is its columns of the sum of the ranks' gradients (each
    rank's loss reads all 12 columns with its own weights); the rank's
    columns of its own gradient alone would differ."""
    out, _, _ = worlds
    xs = [torch.randn(2, 3, generator=torch.Generator().manual_seed(r))
          for r in range(4)]
    ws = [torch.randn(2, 12, generator=torch.Generator().manual_seed(10 + r))
          for r in range(4)]
    total = sum(ws)
    for r, res in enumerate(_load(out, "world14", 4)):
        got = res["gather_cols"]
        _close(got["y"], torch.cat(xs, -1).numpy(), 0)
        _close(got["grad"], total[:, 3 * r:3 * r + 3].numpy(), 1e-6)
        assert not np.allclose(got["grad"], ws[r][:, 3 * r:3 * r + 3])


@pytest.mark.parametrize("arch", TP_ARCHS + [a + "+cp" for a in CP_ARCHS])
def test_train_on_a_1x4_world_matches_single_device(worlds, arch):
    """Tensor parallelism over a 'model' axis of 4: losses and final
    parameters within 2e-5 of the single-device run (h2o-danube3-4b smoke:
    4 query heads, 2 kv heads, a 16-key window over 64 tokens; the other
    families as ``TP_ARCHS`` says; "+cp": under the attn_q hint, as
    ``CP_ARCHS`` says).  A replicated weight whose gradient were the
    rank's partial sum alone would end its steps elsewhere."""
    out, _, local = worlds
    single = local["single_tp"][arch]
    losses = [m["loss"] for m in single["metrics"]]
    for r in _load(out, "world14", 4):
        _close(r[arch], losses)
    got = np.load(out / f"params14_{arch}.npz")
    for k, p in single["model"].named_parameters():
        _close(got[k], p.detach().numpy())


def test_1x4_world_blocks_of_the_other_decoder_families(worlds):
    """The rank's blocks on (1, 4): deepseek-v3 smoke's experts (2 of 8:
    EP), MLA's per-head weights (1 of 4 heads: wq_b, wk_b, wv_b, wo, in
    the dense prefix too) and its shared expert's d_ff, its router and
    latent projections whole; grok-1 smoke's experts (1 of 4: EP); under
    the hint, minitron-4b's and hymba-1.5b's attention weights whole
    (context-parallel) beside their MLPs' d_ff blocks."""
    out, _, _ = worlds
    for r in _load(out, "world14", 4):
        ds = r["blocks"]["deepseek-v3-671b"]
        assert ds["layers.0.moe.w_up"] == [2, 96, 64]
        assert ds["layers.0.moe.w_down"] == [2, 64, 96]
        assert ds["layers.0.moe.router"] == [96, 8]
        assert ds["layers.0.moe.shared.w_up"] == [96, 16]
        for k in ("layers.0.attn", "dense_layers.0.attn"):
            assert ds[f"{k}.wq_b"] == [48, 1, 32]
            assert ds[f"{k}.wk_b"] == [32, 1, 16]
            assert ds[f"{k}.wv_b"] == [32, 1, 16]
            assert ds[f"{k}.wo"] == [1, 16, 96]
            assert ds[f"{k}.wkv_a"] == [96, 48]
        assert r["blocks"]["grok-1-314b"]["layers.0.moe.w_up"] == [1, 96, 128]
        for arch, (H, hd, d) in (("minitron-4b", (6, 16, 96)),
                                 ("hymba-1.5b", (5, 20, 100))):
            b = r["blocks"][arch + "+cp"]
            assert b["layers.0.attn.wq"] == [d, H, hd]
            assert b["layers.0.attn.wo"] == [H, hd, d]
            assert b["layers.0.mlp.w_up"] == [d, 192 // 4]


def test_1x4_world_splits_heads_and_matches_the_jax_loop(worlds):
    """On (1, 4) qwen3-32b smoke's query heads, d_ff and vocabulary split
    over 'model' (8 / 4 heads, 256 / 4, 512 / 4), its 2 kv heads (which 4
    does not divide) stay whole; from the JAX loop's initial weights the
    losses are the JAX loop's within 2e-5; and each rank's step counts at
    most 0.35 of the single-device step's FLOPs (the replicated K/V
    projections keep it above a quarter)."""
    out, _, local = worlds
    for r in _load(out, "world14", 4):
        _close(r["jax_init"], local["jax_loop"]["losses"])
        shapes = r["local"]
        assert shapes == r["blocks"]["qwen3-32b"]
        assert shapes["layers.0.attn.wq"] == [128, 2, 32]
        assert shapes["layers.0.attn.wk"] == [128, 2, 32]
        assert shapes["layers.0.mlp.w_up"] == [128, 64]
        assert shapes["embed.unembed"] == [128, 128]
        assert 0.25 < r["flops"] / r["flops_single"] <= 0.35


def test_train_on_the_host_mesh_matches_the_jax_loop(worlds):
    """train(mesh=(1, 1)) from the JAX loop's initial weights (through
    convert) against the JAX package's loop on its host mesh, 3 steps of
    the same config, source and optimizer: losses and final parameters
    within 2e-5 (tests/test_system.py:55-60)."""
    _, _, local = worlds
    jloop, got = local["jax_loop"], local["mesh11_jax_init"]
    _close([m["loss"] for m in got["metrics"]], jloop["losses"])
    cfg = registry.get_config("qwen3-32b", smoke=True)
    want = dict(transformer_from_jax(jloop["params"], cfg, device="cpu")
                .named_parameters())
    for k, p in got["model"].named_parameters():
        _close(p.detach().numpy(), want[k].detach().numpy())


def test_checkpoint_restores_bitwise_on_one_process_and_on_2x1(worlds):
    out, _, local = worlds
    saved = np.load(out / "params22.npz")
    restored21 = np.load(out / "restored21.npz")
    for k in saved.files:
        np.testing.assert_array_equal(local["restored1"][k], saved[k])
        np.testing.assert_array_equal(restored21[k], saved[k])
    manifests = sorted(p.name for p in (out / "ckpt" / "step_00000003")
                       .iterdir() if p.name.startswith("manifest_"))
    assert manifests == [f"manifest_{r:05d}.json" for r in range(4)]


def test_hints_redistribute_a_dtensor(worlds):
    """hints.constrain with a table: a DTensor takes the hinted placements
    (rows over 'data', the last dim over 'model'); the divisibility test
    that leaves a shape the axes do not divide as it is (hints.py:30-38)
    at production sizes."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import sharding as SH
    _, _, local = worlds
    assert local["hinted"] == (Shard(0), Shard(2))
    prod = SH._SimulatedMesh({"data": 16, "model": 16})
    assert SH.spec_divides((("data",), None, "model"), (32, 6, 64), prod)
    assert not SH.spec_divides((("data",), None, "model"), (3, 6, 64), prod)


def test_launcher_trains_under_torchrun(worlds):
    out, _, _ = worlds
    losses = _load(out, "launcher", 2)
    assert losses[0] == losses[1] and len(losses[0]) == 2
    assert all(np.isfinite(losses[0]))


def test_vlm_microbatches_split_positions_on_their_batch_dim():
    """A repair: microbatches of a VLM batch slice the positions (3, B, S)
    on dim 1, as steps.py:35-41 split them; the step equals the whole
    batch's within f32 summation order."""
    from repro_torch.train import steps as ST
    cfg = registry.get_config("qwen2-vl-2b", smoke=True)
    shape = ShapeConfig("mb", 16, 4, "train")
    batch = L.to_device(SyntheticLM(cfg, shape, seed=0).batch(0), cfg,
                        torch.device("cpu"))
    assert batch["positions"].shape == (3, 4, 16)
    grads = []
    for mb in (1, 2):
        model = L.build_model(cfg, torch.device("cpu"), 0)
        params = {k: p for k, p in model.named_parameters()}
        loss, g = ST.make_loss_and_grads(cfg, microbatches=mb)(
            model, params, batch)
        grads.append((float(loss), g))
    assert abs(grads[0][0] - grads[1][0]) < 2e-5
    for a, b in zip(grads[0][1], grads[1][1]):
        _close(a.float().numpy(), b.float().numpy(), 1e-4)
