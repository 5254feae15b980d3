"""Quickstart on the PyTorch port: the paper's technique in ~80 lines
(counterpart of ``examples/quickstart.py``).

Builds one ViLBERT-style cross-modal attention layer and runs it through
all three execution systems (the paper's comparison: Non-stream /
Layer-stream / Tile-stream) via the plan API, verifying numerical
equivalence in f32, printing the per-mode HBM-traffic comparison that
produces Fig. 6, and showing the compile→plan→run/simulate path on a full
model (DESIGN.md §8).  On the card TILE_STREAM runs the stream attention
kernel and LAYER_STREAM the flash kernel; on the CPU their plain versions.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import ExecutionMode
from repro_torch.kernels import ops
from repro_torch.plan import ExecutionPlan, plan_attention, plan_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the card)")
    device = runtime.resolve_device(ap.parse_args(argv).device)

    # ViLBERT-base co-attention geometry (paper §III: N_X = N_Y = 4096;
    # reduced here to run fast on CPU)
    B, heads, seq, d_model = 1, 8, 512, 256
    hd = d_model // heads
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, heads, seq, hd, generator=g) * 0.3        # modal X
    x_other = torch.randn(B, seq, d_model, generator=g) * 0.3    # modal Y
    wk = torch.randn(d_model, heads, hd, generator=g) * d_model ** -0.5
    wv = torch.randn(d_model, heads, hd, generator=g) * d_model ** -0.5
    q, x_other, wk, wv = (t.to(device) for t in (q, x_other, wk, wv))

    print("cross-modal attention: Q from modal X, K/V generated from modal Y")
    outs = {}
    for mode in ExecutionMode:
        lp = plan_attention(mode, seq_q=seq, seq_kv=seq, d_kv=d_model,
                            heads=heads, kv_heads=heads, head_dim=hd,
                            cross=True)
        outs[mode] = ops.attention_by_plan(lp, q, x_other, wk, wv,
                                           causal=False).cpu().numpy()
        print(f"  {mode.value:13s} -> out {outs[mode].shape}")
    for mode in ExecutionMode:
        np.testing.assert_allclose(outs[mode],
                                   outs[ExecutionMode.NON_STREAM],
                                   atol=1e-4, rtol=1e-4)
    print("all three execution systems agree (allclose) ✓\n")

    print("analytic HBM traffic per co-attention layer "
          "(paper config: seq 4096, d 1024, MHA; from LayerPlan.hbm_bytes):")
    for mode in ExecutionMode:
        lp = plan_attention(mode, seq_q=4096, seq_kv=4096, d_kv=1024,
                            heads=8, kv_heads=8, head_dim=128,
                            bytes_per_el=2)
        print(f"  {mode.value:13s} {lp.hbm_bytes / 2**20:10.1f} MiB")
    print("\ntile-streaming eliminates the K/V HBM round-trip "
          "('CIM rewriting') entirely — the paper's core claim.")

    print("\nmode auto-selection (TBR-CIM reconfiguration analogue), via "
          "plan_model:")
    for arch in ("vilbert-base", "qwen2-vl-2b"):
        plan = plan_model(registry.get_config(arch))
        modes = plan.uniform_mode.value if plan.uniform_mode else "mixed"
        print(f"  {arch:22s} -> {modes}  "
              f"({len(plan.layers)} attn layers, "
              f"{plan.total_hbm_bytes / 2**20:.0f} MiB predicted)")

    print("\nplans are serializable artifacts (sweep tooling):")
    plan = plan_model(registry.get_config("vilbert-base"))
    restored = ExecutionPlan.from_json(plan.to_json())
    assert restored == plan
    print(f"  to_json -> from_json round-trips "
          f"({len(plan.to_json())} bytes); summary: {plan.summary()}")


if __name__ == "__main__":
    main()
