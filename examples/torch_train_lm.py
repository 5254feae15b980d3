"""End-to-end training on the PyTorch port (counterpart of
``examples/train_lm.py``): a ~100M-parameter dense LM trained for a few
hundred steps with the whole stack -- the mesh train step (parameters and
AdamW moments placed by the sharding rule table, the batch by
``batch_shardings``), the deterministic data pipeline, asynchronous
sharded checkpoints and resume-on-restart.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
        [--ckpt DIR] [--device cpu]
    torchrun --nproc_per_node=N examples/torch_train_lm.py --device cpu

Without ``--device`` it runs on the card and refuses without one.  One
process trains on the host mesh (1, 1), a torchrun world of N on (N, 1);
the same code path drives the production mesh (``launch/train.py``).
"""
import argparse
import os

import torch.distributed as dist

from repro_torch.core import runtime
from repro_torch.core.types import Family, ModelConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import launch_mesh
from repro_torch.train import loop as L
from repro_torch.train import optimizer as OPT

# ~100M params: 12L x d512 x ff2048, vocab 32k
CFG = ModelConfig(
    name="demo-100m", family=Family.DENSE,
    num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
    d_ff=2048, vocab_size=32000, head_dim=64,
    act="silu", dtype="float32", param_dtype="float32",
)
# ~0.5k tokens a step, so that a few hundred steps finish in minutes on
# the CPU; production shapes go through launch/train.py.
SHAPE = ShapeConfig("demo", seq_len=128, global_batch=4, kind="train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: ./train_lm_ckpt)")
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)
    device = runtime.resolve_device(args.device)
    ckpt = args.ckpt or os.path.join(os.getcwd(), "train_lm_ckpt")

    mesh = launch_mesh(device) or make_host_mesh(device)
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"model: {CFG.param_count() / 1e6:.1f}M params; "
              f"{SHAPE.global_batch}x{SHAPE.seq_len} tokens/step on a "
              f"{tuple(mesh.shape)} mesh of {device.type}")
    src = SyntheticLM(CFG, SHAPE, seed=0)
    tcfg = L.TrainConfig(
        steps=args.steps, log_every=20, checkpoint_every=100,
        checkpoint_dir=ckpt,
        opt=OPT.OptimizerConfig(learning_rate=1e-3, warmup_steps=30,
                                decay_steps=args.steps))

    def on_log(m):
        if rank0:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  {m['steps_per_s']:.2f} it/s",
                  flush=True)

    out = L.train(CFG, SHAPE, src, tcfg, device=device, mesh=mesh,
                  hooks={"on_log": on_log})
    first, last = out["metrics"][0], out["metrics"][-1]
    if rank0:
        print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} "
              f"over {args.steps} steps")
        print("checkpoints in", ckpt)
    assert last["loss"] < first["loss"], "training did not reduce loss!"
    return out


if __name__ == "__main__":
    main()
