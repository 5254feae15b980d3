"""The paper's full pipeline on ViLBERT, on the PyTorch port (counterpart of
``examples/crossmodal_pruning.py``): two-stream cross-modal encoding with
DTPU dynamic token pruning, comparing execution modes and showing the
pruning schedule shrink token counts across co-TRM blocks (paper Fig. 2-4
narrative).

    PYTHONPATH=src python examples/torch_crossmodal_pruning.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import registry
from repro_torch.core import pruning as P
from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode, PruningConfig
from repro_torch.models.vilbert import ViLBERT


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the card)")
    device = runtime.resolve_device(ap.parse_args(argv).device)

    cfg = registry.get_config("vilbert-base", smoke=True)
    cfg = dataclasses.replace(
        cfg, num_layers=6, num_coattn_layers=4, seq_y=256,
        pruning=PruningConfig(enabled=True, min_tokens=16,
                              keep_schedule=((0.25, 1.0), (0.5, 0.75),
                                             (0.75, 0.5), (1.01, 0.3))))
    model = ViLBERT(cfg, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))

    B, S = 2, 256
    batch = {
        "regions": torch.randn(B, S, cfg.d_model,
                               generator=torch.Generator().manual_seed(1))
        .mul(0.1).to(device),
        "tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                generator=torch.Generator().manual_seed(2))
        .to(device),
    }

    plan = P.keep_plan(cfg.pruning, cfg.num_coattn_layers, S)
    print(f"DTPU keep plan over {cfg.num_coattn_layers} co-TRM blocks: "
          f"{S} -> {' -> '.join(map(str, plan))}")
    print(f"attention compute retained: "
          f"{P.pruning_compute_savings(plan, S):.1%} "
          f"(speedup {1 / P.pruning_compute_savings(plan, S):.2f}x)\n")

    for mode in ExecutionMode:
        model(batch, mode=mode)                     # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        logits, counts = model(batch, mode=mode, return_token_counts=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = (time.time() - t0) * 1e3
        print(f"{mode.value:13s}  vqa logits {tuple(logits.shape)}  "
              f"token counts per block {counts}  {dt:7.1f} ms")

    print("\nTILE_STREAM generates each co-attention K/V tile from the "
          "other modality's tokens in-stream; pruning shrinks the KV-tile "
          "grid between blocks (hybrid->normal mode reconfiguration).")


if __name__ == "__main__":
    main()
