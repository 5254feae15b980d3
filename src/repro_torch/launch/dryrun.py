"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

The JAX dry run lowers and compiles every (architecture x input shape x
mesh) cell against 256 or 512 placeholder devices.  The port runs the
step it would run there, once, as rank 0 of a *fake* process group of
256 or 512 ranks (``torch.distributed``'s "fake" backend: collectives
return at once) on the production mesh (``launch.mesh``), under
``FakeTensorMode`` (shapes and dtypes, nothing allocated): the mesh train
step (``train.steps.MeshTrainStep``: parameters and AdamW moments placed
by the rule table, built as ``train.loop.build_sharded`` builds them, the
batch by ``batch_shardings``; the layers compute on their 'model' blocks
and gather a unit at a time over 'data'), or the prefill or decode step
the engine serves, on the rank's block of the batch.  It
counts the per-device FLOPs, bytes and collective traffic at the
dispatcher (``launch.op_analysis``, the counterpart of
``hlo_analysis.py``), the peak memory with
``torch.distributed._tools.mem_tracker.MemTracker``, and writes the JSON
fields of dryrun.py:397-427 per cell.  Each cell runs in its own process
(the CLI, ``run_cell_subprocess``) or in a world it destroys afterwards
(``fake_world``), so that no fake group leaks into the caller.  A value
the step would read from the device (a data-dependent shape, ``.item()``)
fails the cell: ``status: "error"`` with the exception, never a guess.

The activation-hint table (``distributed.hints.hint_shardings``: its
names from ``--hints``, or the ``--optimized`` preset of JAX's dry run,
dryrun.py:475-527) is installed around the traced step, as dryrun.py:355
installs it, and the result carries ``hints`` and ``tag`` (the tag also
suffixes the artifact's name).  ``--moe-groups`` and ``--block-k`` set
the runtime flags of those names.

What the counts mean for this port (PERF.md): a train cell's FLOPs are
the rank's share of what ``distributed.parallel`` splits over 'model'
(dense attention on its heads or, under the ``attn_q`` hint where the
heads do not split, on its query rows; the MLP; the MoE's experts or
their d_ff; MLA's heads; the SSM's heads or out-projection rows;
vilbert's and whisper's layers; the vocabulary) and the whole of the
rest, which every 'model' rank repeats: the routing, MLA's latent
projections, B and C of the SSM, attention whose heads do not split
where no hint asks for context parallelism, and a split weight whose
dim the 'model' size does not divide (``replicated_over_model`` lists
those; none at the production mesh).  Attention FLOPs are those
of the plain blocked version the CPU runs (every kv block, masked ones
included); bytes are eager, with nothing fused.  A cell cut in depth
(``depth``) keeps the whole config's FSDP choice (``fsdp``), so that its
placements are the production ones.  Decode and prefill cells run the
model replicated on every rank, as the engine serves it: a hint there is
recorded and changes nothing.  The roofline divides the counts by the
H100 SXM's datasheet rates below, not by measurements.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        starcoder2-7b --shape train_4k --optimized --depth 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import Family, SHAPES, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.hints import hint_shardings

# --- H100 SXM rates (roofline denominators), from NVIDIA's H100 Tensor
# Core GPU datasheet: dense bf16 tensor-core peak (989 TFLOP/s; the
# datasheet's 1,979 is with sparsity), HBM3 bandwidth 3.35 TB/s, NVLink
# 900 GB/s a GPU in both directions (450 GB/s each way).  Across pods:
# one 400 Gb/s ConnectX-7 port a GPU (50 GB/s), the DGX H100 datasheet's
# network.  Datasheet rates, not measurements; the in-pod rate is
# NVLink's, optimistic for groups that span nodes of 8 GPUs.
#: The kv block of the plain attention versions the trace runs (the JAX
#: dry run's --optimized block_k): one block of 2048 keys keeps the op
#: count, and so the trace time, small.
BLOCK_K = 2048

PEAK_FLOPS = 989e12          # bf16 FLOP/s per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU, one direction
NET_BW = 50e9                # bytes/s per GPU across pods


def model_flops(cfg, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    tokens (1 new token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch    # decode: fwd only, 1 tok/seq


def _stack_depths(cfg) -> Dict[str, int]:
    """Named layer-stack sizes (the linear-extrapolation unknowns)."""
    if cfg.family == Family.ENCDEC:
        return {"enc": cfg.num_encoder_layers or cfg.num_layers,
                "dec": cfg.num_layers}
    if cfg.family == Family.CROSSMODAL:
        return {"pre": cfg.num_layers - cfg.num_coattn_layers,
                "co": cfg.num_coattn_layers}
    if cfg.family == Family.MOE and cfg.first_dense_layers:
        return {"dense": cfg.first_dense_layers,
                "moe": cfg.num_layers - cfg.first_dense_layers}
    return {"layers": cfg.num_layers}


def _with_depths(cfg, d: Dict[str, int]):
    if cfg.family == Family.ENCDEC:
        return dataclasses.replace(cfg, num_encoder_layers=d["enc"],
                                   num_layers=d["dec"])
    if cfg.family == Family.CROSSMODAL:
        return dataclasses.replace(cfg, num_layers=d["pre"] + d["co"],
                                   num_coattn_layers=d["co"])
    if cfg.family == Family.MOE and cfg.first_dense_layers:
        return dataclasses.replace(cfg, first_dense_layers=d["dense"],
                                   num_layers=d["dense"] + d["moe"])
    return dataclasses.replace(cfg, num_layers=d["layers"])


def probe_plan(cfg):
    """Probe depth-vectors: base {1,..}, then +1 on each stack."""
    names = list(_stack_depths(cfg))
    base = {n: 1 for n in names}
    plan = [dict(base)]
    for n in names:
        v = dict(base)
        v[n] = 2
        plan.append(v)
    return names, plan


def extrapolate(names, plan, probe_vals, real_depths) -> float:
    """cost = base + sum slope_i * n_i from probe measurements."""
    slopes = {n: probe_vals[i + 1] - probe_vals[0]
              for i, n in enumerate(names)}
    base = probe_vals[0] - sum(slopes[n] for n in names)
    return base + sum(slopes[n] * real_depths[n] for n in names)


def auto_microbatches(cfg, shape: ShapeConfig, mesh) -> int:
    """Smallest power-of-two microbatch count whose per-layer checkpointed
    activations fit the HBM budget (activation-memory lever, DESIGN.md §5).
    ``mesh``: a ``DeviceMesh`` or anything whose ``.shape`` maps axis
    names to sizes."""
    if shape.kind != "train":
        return 1
    sizes = SH.axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in sizes:
            dp *= sizes[a]
    per_dev_seqs = max(shape.global_batch // dp, 1)
    d_eff = cfg.d_model + (cfg.d_model_y if cfg.family == Family.CROSSMODAL
                           else 0)
    if cfg.family == Family.CROSSMODAL:
        d_eff *= 4        # two streams x (co+self) attention per block
    if cfg.family == Family.SSM or cfg.family == Family.HYBRID:
        d_eff += cfg.ssm_expand * cfg.d_model
    seq = shape.seq_len if cfg.family != Family.ENCDEC else \
        (shape.seq_len + cfg.encoder_seq)
    layers = sum(_stack_depths(cfg).values())
    act = layers * per_dev_seqs * seq * d_eff * 2 * 1.5
    budget = 6e9
    mb = 1
    while act / mb > budget and mb < per_dev_seqs:
        mb *= 2
    return mb


# ---------------------------------------------------------------------------
# The fake world and one cell's step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a fake process group of ``world`` ranks, destroyed on
    exit.  Refuses to start inside a process that has a group already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already has a process "
                           "group; run the cell in its own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _local_inputs(cfg, shape: ShapeConfig, mesh, seq_sharded: bool = False
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """This rank's block of one global batch (zeros: fake tensors under
    the active mode) and the batch's Shardings."""
    import torch
    specs = registry.input_specs(cfg, shape)
    bshard = SH.batch_shardings(specs, mesh, seq_sharded=seq_sharded)
    out = {}
    for k, s in specs.items():
        idx = SH.local_index(s, mesh, bshard[k].placements)
        local = [sl.stop - sl.start for sl in idx]
        dt = torch.int64 if k in ("tokens", "labels", "answers",
                                  "positions") else getattr(torch, cfg.dtype)
        out[k] = torch.zeros(local, dtype=dt)
    return out, bshard


def build_cell(cfg, shape: ShapeConfig, mesh, *, microbatches: int = 1,
               remat: bool = True, fsdp_threshold: float = 8e9):
    """(model, the step as a no-argument callable, the per-device argument
    tensors) for one cell; call under a FakeTensorMode, on the fake world.
    train: ``MeshTrainStep`` on the rank's batch block (each layer
    recomputed in the backward unless ``remat`` is False; the model's
    parameters on ``meta``, the rank's blocks as ``build_sharded`` keeps
    them); prefill: the model's prefill of its block at ``max_len`` =
    seq_len; decode: one ``decode_step`` on a cache of seq_len positions
    (batch over (pod, data); a batch-1 cell replicates the row)."""
    import torch
    from repro_torch.train import loop as L
    from repro_torch.train import steps as ST
    if shape.kind == "train":
        with runtime.flags(abstract_init=True):
            model, blocks = L.build_sharded(cfg, torch.device("cpu"), 0,
                                            mesh, fsdp_threshold)
        step = ST.MeshTrainStep(cfg, model, mesh, microbatches=microbatches,
                                remat=remat, fsdp_threshold=fsdp_threshold,
                                blocks=blocks)
        del blocks
        batch, _ = _local_inputs(cfg, shape, mesh)
        state = [p.to_local() for p in step.params.values()]
        state += [t.to_local() for tree in (step.opt_state.mu,
                                            step.opt_state.nu)
                  for t in tree.values()]
        return None, (lambda: step.step(batch)), state + list(
            batch.values())
    with runtime.flags(abstract_init=True):
        model = L.build_model(cfg, torch.device("cpu"), 0)
    params = [p.detach() for p in model.parameters()]
    model.requires_grad_(False)
    if shape.kind == "prefill":
        batch, _ = _local_inputs(cfg, shape, mesh)
        batch = {k: v for k, v in batch.items() if k != "positions"}
        return model, (lambda: model.prefill(batch, max_len=shape.seq_len)
                       ), params + list(batch.values())
    dp = math.prod(SH.axis_sizes(mesh).get(a, 1) for a in ("pod", "data"))
    B = shape.global_batch // dp if shape.global_batch > 1 else 1
    if cfg.family == Family.ENCDEC:
        enc = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype))
        cache = model.init_cache(B, shape.seq_len, enc)
    else:
        cache = model.init_cache(B, shape.seq_len)
    # the decode step runs the whole cache of its rank's rows: the cache's
    # sequence blocks of ``cache_shardings`` (context-parallel decode) are
    # not run apart, so the cache counts whole
    cache["len"] = shape.seq_len - 1
    toks = torch.zeros((B, 1), dtype=torch.int64)
    leaves = [t for t in _leaves(cache) if isinstance(t, torch.Tensor)]
    return model, (lambda: model.decode_step(cache, toks)), \
        params + leaves + [toks]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _measure(cfg, shape: ShapeConfig, mesh, *, multi_pod: bool,
             microbatches: int,
             extra_flags: Optional[Dict[str, Any]] = None,
             remat: bool = True,
             fsdp_threshold: float = 8e9) -> Dict[str, Any]:
    """Build and run one cell under a FakeTensorMode; its counts."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_flatten
    from repro_torch.launch import op_analysis as OA
    world = mesh.size()
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.time()
        model, run, args = build_cell(cfg, shape, mesh,
                                      microbatches=microbatches, remat=remat,
                                      fsdp_threshold=fsdp_threshold)
        t_build = time.time() - t0
        tracker = MemTracker()
        tracker.track_external(*([model] if model is not None else []),
                               *[a for a in args
                                 if isinstance(a, torch.Tensor)])
        with runtime.flags(**(extra_flags or {})):
            with tracker:
                out, counts = OA.analyze(run, world=world,
                                         multi_pod=multi_pod)
        t_run = time.time() - t0 - t_build
        peak = tracker.get_tracker_snapshot("peak")
        peak_bytes = max((v.get("Total", 0) for v in peak.values()),
                         default=0)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
    arg_bytes = _bytes(a for a in args if hasattr(a, "numel"))
    counts.update(build_s=t_build, run_s=t_run, peak_bytes=peak_bytes,
                  argument_bytes=arg_bytes, output_bytes=_bytes(outs))
    return counts


def probe_corrected_costs(cfg, shape: ShapeConfig, mesh, *,
                          multi_pod: bool,
                          fsdp_threshold: Optional[float] = None
                          ) -> Dict[str, Any]:
    """Counts at depth 1 and 2 of each layer stack, extrapolated to the
    config's depths (cost = base + sum slope_i * depth_i), as the JAX
    probes do (dryrun.py:200-223) -- a cross-check of the full-depth run,
    and its stand-in where full depth is too slow to trace."""
    names, plan = probe_plan(cfg)
    vals = [_measure(_with_depths(cfg, depths), shape, mesh,
                     multi_pod=multi_pod, microbatches=1,
                     fsdp_threshold=_fsdp_threshold(cfg) if fsdp_threshold
                     is None else fsdp_threshold)
            for depths in plan]
    real = _stack_depths(cfg)
    out = {key: extrapolate(names, plan, [v[key] for v in vals], real)
           for key in ("flops", "bytes", "ici", "dcn")}
    out["probe_counts"] = vals[0]["counts"]
    return out


def _fsdp_threshold(cfg) -> float:
    """The threshold that gives a config cut in depth its whole config's
    FSDP choice (``sharding.param_shardings``: at or over its default of
    8e9 parameters, they shard over 'data')."""
    return 0.0 if cfg.param_count() >= 8e9 else math.inf


def _by_axis(by_stride: Dict[int, float], names, mesh_shape
             ) -> Dict[str, float]:
    """Collective traffic a device by the mesh axis its group spans (the
    rank stride of an axis is the product of the sizes after it; "other"
    for a group that is no one axis)."""
    strides = {int(math.prod(mesh_shape[i + 1:])): n
               for i, n in enumerate(names) if mesh_shape[i] > 1}
    out: Dict[str, float] = {}
    for stride, traffic in sorted(by_stride.items()):
        axis = strides.get(stride, "other")
        out[axis] = out.get(axis, 0.0) + traffic
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = None, microbatches: int = 0,
             verbose: bool = True, probes: bool = False,
             extra_flags: Optional[Dict[str, Any]] = None, cfg=None,
             depth: int = 0, mesh_shape: Optional[Tuple[int, ...]] = None,
             shape: Optional[ShapeConfig] = None, remat: bool = True,
             hints: Optional[List[str]] = None, tag: str = ""
             ) -> Dict[str, Any]:
    """One cell on a fake world of 256 (or, ``multi_pod``, 512) ranks: the
    fields of dryrun.py:397-427.  ``cfg`` and ``shape`` override the
    registry's config and ``SHAPES[shape_name]`` (tests pass smoke sizes),
    ``mesh_shape`` the production mesh ((pod,) data, model); ``depth``
    cuts every layer stack to that many layers (recorded in the result);
    ``remat=False`` keeps a train step's activations instead of
    recomputing each layer; ``hints`` names the activation hints whose
    table the step runs under (``hint_shardings`` on the cell's mesh),
    and ``tag`` marks the result and its artifact, as JAX's do."""
    from repro_torch.launch.mesh import make_mesh
    mesh_shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    total = 1
    for n in mesh_shape:
        total *= n
    mesh_name = "x".join(map(str, mesh_shape))
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "devices": total}
    if tag:
        result["tag"] = tag
    if hints:
        result["hints"] = list(hints)
    skip = registry.cell_supported(arch, shape_name)
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        _emit(result, out_dir, verbose, tag)
        return result
    names = (("pod", "data", "model") if len(mesh_shape) == 3
             else ("data", "model"))
    try:
        cfg = cfg or registry.get_config(arch)
        fsdp = _fsdp_threshold(cfg)
        if depth:
            cfg = _with_depths(cfg, {k: min(v, depth) for k, v in
                                     _stack_depths(cfg).items()})
            result["depths"] = _stack_depths(cfg)
        shape = shape or SHAPES[shape_name]
        with fake_world(total):
            mesh = make_mesh(mesh_shape, names, "cpu")
            mb = microbatches or auto_microbatches(cfg, shape, mesh)
            flags = dict(extra_flags or {})
            flags["sharding_hints"] = hint_shardings(hints or [], mesh)
            m = _measure(cfg, shape, mesh, multi_pod=multi_pod,
                         microbatches=mb, extra_flags=flags,
                         remat=remat, fsdp_threshold=fsdp)
            corr = None
            if probes:
                try:
                    corr = probe_corrected_costs(cfg, shape, mesh,
                                                 multi_pod=multi_pod,
                                                 fsdp_threshold=fsdp)
                except Exception as e:  # noqa: BLE001
                    result["probe_error"] = f"{type(e).__name__}: {e}"[:500]
    except Exception as e:  # noqa: BLE001 - dry-run failures are findings
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        _emit(result, out_dir, verbose, tag)
        return result
    if corr:
        result["probe_flops"] = corr["flops"]
    flops, nbytes = m["flops"], m["bytes"]
    mf = model_flops(cfg, shape)
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    coll_s = m["ici"] / NVLINK_BW
    dcn_s = m["dcn"] / NET_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s, "dcn_s": dcn_s}
    bottleneck = max(terms, key=terms.get)
    temp = max(m["peak_bytes"] - m["argument_bytes"], 0)
    if shape.kind == "train":
        from repro_torch.distributed import parallel as PL
        sizes = dict(zip(names, mesh_shape))
        result["fsdp"] = fsdp == 0.0 and sizes.get("data", 1) > 1
        result["replicated_over_model"] = PL.replicated_over_model(
            {k: v.shape for k, v in registry.param_specs(cfg).items()}, cfg,
            sizes)
    result.update({
        "status": "ok",
        "lower_s": round(m["build_s"], 1),      # model build and placement
        "compile_s": round(m["run_s"], 1),      # the traced step
        "microbatches": mb,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "raw_flops_uncorrected": flops,
        "probe_corrected": corr is not None,
        "model_flops_global": mf,
        "model_flops_per_device": mf / total,
        "useful_flop_ratio": (mf / total) / flops if flops else None,
        "memory": {
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": 0,
            "total_bytes": m["argument_bytes"] + m["output_bytes"] + temp,
        },
        "collectives": {"counts": m["counts"],
                        "ici_traffic_bytes": m["ici"],
                        "dcn_traffic_bytes": m["dcn"],
                        "num_ops": m["num_ops"],
                        "traffic_by_axis": _by_axis(
                            m["by_stride"], names, mesh_shape)},
        "roofline": {**terms, "bottleneck": bottleneck,
                     "step_time_est_s": max(terms.values()),
                     "roofline_fraction":
                         compute_s / max(max(terms.values()), 1e-30)},
    })
    _emit(result, out_dir, verbose, tag)
    return result


def _emit(result: Dict[str, Any], out_dir: Optional[str], verbose: bool,
          tag: str = ""):
    if verbose:
        status = result["status"]
        line = (f"[{result['mesh']:8s}] {result['arch']:18s} "
                f"{result['shape']:12s} {status}")
        if status == "ok":
            r = result["roofline"]
            mem = result["memory"]["total_bytes"] / 2**30
            line += (f"  flops/dev={result['hlo_flops_per_device']:.3g}"
                     f" mem/dev={mem:.2f}GiB"
                     f" bottleneck={r['bottleneck']}"
                     f" roofline_frac={r['roofline_fraction']:.3f}"
                     f" (build {result['lower_s']}s trace"
                     f" {result['compile_s']}s)")
        elif status == "error":
            line += "  " + result["error"].splitlines()[0][:120]
        else:
            line += "  " + result["reason"]
        print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(
            out_dir, f"{result['arch']}__{result['shape']}__{result['mesh']}"
            f"{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)


def run_cell_subprocess(arch: str, shape_name: str, *, multi_pod: bool,
                        out_dir: str, depth: int = 0, microbatches: int = 0,
                        hints: Optional[List[str]] = None, tag: str = "",
                        optimized: bool = False, moe_groups: int = 1
                        ) -> subprocess.Popen:
    """Start one cell as ``python -m repro_torch.launch.dryrun`` in its
    own process (its artifact lands in ``out_dir``, suffixed by the tag);
    ``hints``, ``tag``, ``optimized`` and ``moe_groups`` are the CLI's
    switches of those names.  Returns the Popen."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape_name, "--out", out_dir,
           "--depth", str(depth), "--microbatches", str(microbatches)]
    if multi_pod:
        cmd.append("--multi-pod")
    if hints:
        cmd += ["--hints", ",".join(hints)]
    if tag:
        cmd += ["--tag", tag]
    if optimized:
        cmd.append("--optimized")
    if moe_groups > 1:
        cmd += ["--moe-groups", str(moe_groups)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def cell_options(arch: str, *, hints: List[str], tag: str, moe_groups: int,
                 block_k: int, optimized: bool, multi_pod: bool
                 ) -> Tuple[List[str], str, Dict[str, Any]]:
    """(hints, tag, runtime flags) of one cell from the CLI's switches,
    with JAX's meaning (dryrun.py:503-523): ``optimized`` adds the
    ``embed_out`` hint, ``attn_q``/``attn_out`` where the heads do not
    divide a 'model' axis of 16, ``moe_groups`` = the data-parallel size
    (16, or 32 across two pods) for MoE archs, kv blocks of 2048 and the
    tag "optimized", unless given."""
    hints = list(hints)
    extra: Dict[str, Any] = {"block_k": block_k}
    if moe_groups > 1:
        extra["moe_groups"] = moe_groups
    if optimized:
        cfg = registry.get_config(arch)
        if "embed_out" not in hints:
            hints.append("embed_out")
        if cfg.num_heads and not SH.heads_shardable(
                cfg, SH._SimulatedMesh({"data": 16, "model": 16})):
            hints += [h for h in ("attn_q", "attn_out") if h not in hints]
        if cfg.num_experts:
            extra.setdefault("moe_groups", 32 if multi_pod else 16)
        extra["block_k"] = 2048
        tag = tag or "optimized"
    return hints, tag, extra


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list(registry.ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) on this mesh, "
                         "each cell in its own process")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (fit activation memory)")
    ap.add_argument("--probes", action="store_true",
                    help="cross-check against depth-1/2 probes, "
                         "extrapolated")
    ap.add_argument("--depth", type=int, default=0,
                    help="cut every layer stack to this depth (0: full)")
    ap.add_argument("--block-k", type=int, default=BLOCK_K,
                    help="kv block of the plain attention the trace runs "
                         "(its FLOPs do not depend on it; its op count, "
                         "bytes and temporaries do)")
    ap.add_argument("--hints", default="",
                    help="comma-separated activation-sharding hints "
                         "(embed_out,attn_q,attn_out,moe_dispatch)")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix (perf-iteration runs)")
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--optimized", action="store_true",
                    help="apply the hillclimbed preset: embed_out hint, "
                         "context-parallel attention for non-divisible-"
                         "head archs, grouped MoE dispatch, block_k=2048")
    args = ap.parse_args(argv)
    hints = [h for h in args.hints.split(",") if h]

    if args.all:
        failures = 0
        for arch in registry.ASSIGNED:
            for shape in SHAPES:
                p = run_cell_subprocess(arch, shape, multi_pod=args.multi_pod,
                                        out_dir=args.out, depth=args.depth,
                                        microbatches=args.microbatches,
                                        hints=hints, tag=args.tag,
                                        optimized=args.optimized,
                                        moe_groups=args.moe_groups)
                out, _ = p.communicate()
                print(out.strip().splitlines()[-1] if out.strip() else
                      f"{arch} {shape}: no output", flush=True)
                failures += p.returncode != 0
        return 1 if failures else 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required unless --all")
    hints, tag, extra = cell_options(
        args.arch, hints=hints, tag=args.tag, moe_groups=args.moe_groups,
        block_k=args.block_k, optimized=args.optimized,
        multi_pod=args.multi_pod)
    r = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                 out_dir=args.out, microbatches=args.microbatches,
                 probes=args.probes, extra_flags=extra, depth=args.depth,
                 hints=hints, tag=tag)
    return 1 if r["status"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
