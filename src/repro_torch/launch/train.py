"""Training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
        --steps 5 --global-batch 1 --seq-len 4096 --layers 4 \\
        [--smoke] [--mode tile_stream] [--checkpoint-dir ckpts/run1] \\
        [--microbatches 4] [--device cpu]

    torchrun --nproc_per_node=N -m repro_torch.launch.train --arch ...

Every registry arch trains.  It runs on the card (one device) unless
``--device`` names another; with no card and no ``--device cpu`` it
refuses to start.  ``--smoke`` takes the arch's small config and a small
shape.  Under ``torchrun`` (``WORLD_SIZE`` set) each rank joins the
process group (``nccl`` on the card, ``gloo`` on the CPU) and trains on a
mesh: the production mesh at 256 ranks, its two-pod form at 512, the
host mesh (world, 1) otherwise, as ``repro/launch/train.py:58-59``
chooses; rank 0 prints the log.  On a mesh no rank holds the whole
model: each builds only its blocks (``train.loop.build_sharded``) and the
step computes sharded (``train.steps.MeshTrainStep``).  The JAX
launcher's ``--use-pallas`` has no counterpart: the kernels run whenever
the tensors are on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from repro_torch.configs import registry
from repro_torch.core.types import SHAPES, ExecutionMode, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM, TextCorpus
from repro_torch.train import loop as L
from repro_torch.train import optimizer as OPT


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=list(registry.ARCHS), required=True)
    ap.add_argument("--shape", choices=list(SHAPES), default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config and a small shape")
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (language "
                         "layers for a crossmodal arch); exists because one "
                         "card cannot hold qwen3-32b's optimizer state at "
                         "full depth")
    ap.add_argument("--mode", choices=[m.value for m in ExecutionMode],
                    default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--corpus", default=None,
                    help="path to a local text corpus (default: synthetic)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card)")
    return ap.parse_args(argv)


def launch_mesh(device):
    """The mesh of a ``torchrun`` world (None outside one): the process
    group from torchrun's environment, then the production mesh at 256 or
    512 ranks and the host mesh otherwise."""
    import os
    if "WORLD_SIZE" not in os.environ:
        return None
    import torch
    import torch.distributed as dist
    from repro_torch.core import runtime
    from repro_torch.launch import mesh as M
    device = runtime.resolve_device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(M.BACKEND[device.type])
    world = dist.get_world_size()
    if world in (256, 512):
        return M.make_production_mesh(multi_pod=world == 512, device=device)
    return M.make_host_mesh(device)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cut = {"num_layers": args.layers}
        if cfg.num_coattn_layers:
            cut["num_coattn_layers"] = min(cfg.num_coattn_layers, args.layers)
        cfg = dataclasses.replace(cfg, **cut)
    shape = SHAPES[args.shape]
    if args.smoke:
        shape = ShapeConfig("smoke", args.seq_len or 128,
                            args.global_batch or 8, "train")
    elif args.global_batch or args.seq_len:
        shape = dataclasses.replace(
            shape, global_batch=args.global_batch or shape.global_batch,
            seq_len=args.seq_len or shape.seq_len)
    source = (TextCorpus(cfg, shape, args.corpus) if args.corpus
              else SyntheticLM(cfg, shape))
    tcfg = L.TrainConfig(
        steps=args.steps, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        mode=ExecutionMode(args.mode) if args.mode else None,
        microbatches=args.microbatches, log_every=1,
        opt=OPT.OptimizerConfig(learning_rate=args.lr,
                                decay_steps=args.steps))

    mesh = launch_mesh(args.device)
    rank0 = mesh is None or mesh.get_coordinate() == (0,) * mesh.ndim

    def on_log(m):
        if rank0:
            print(f"step {m['step']:6d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{m['steps_per_s']:.2f} it/s", flush=True)

    device = args.device if mesh is None else mesh.device_type
    return L.train(cfg, shape, source, tcfg, device=device,
                   hooks={"on_log": on_log}, mesh=mesh)


if __name__ == "__main__":
    main()
