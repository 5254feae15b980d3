"""Batched serving on the PyTorch port (counterpart of
``examples/serve_batch.py``): a small LM served with the slot-level
continuous-batching engine — per-admission prefill under the
planner-resolved ``ExecutionPlan`` (per-layer modes, TILE_STREAM
cross-forwarding where profitable), per-step ``DecodePlan``s, batched
decode over a paged K/V pool, immediate slot recycling (DESIGN.md §11).
Requests are admitted into free slots while other slots are mid-decode;
pass ``plan=`` to pin one ``ExecutionPlan`` instead of re-planning per
prompt length.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the card)")
    device = runtime.resolve_device(ap.parse_args(argv).device)

    cfg = registry.get_config("starcoder2-7b", smoke=True)
    gen = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device=device, generator=gen)
    eng = Engine(cfg, model, slots=4, max_len=96)
    plan = eng.plan_for(24)
    print(f"planner: {cfg.name} prefill -> "
          f"{eng.mode_for(24).value} "
          f"({len(plan.layers)} attn layers, "
          f"{plan.total_hbm_bytes >> 20} MiB predicted)")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(int(rng.integers(4, 24)),))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 16)),
                    arrival_step=int(rng.integers(0, 6)))
            for i in range(8)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    st = eng.stats()
    where = device.type.upper()
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s on {where}); "
          f"{st['steps']} steps, {st['decode_calls']} decode calls, "
          f"peak concurrency {st['max_concurrency']}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")


if __name__ == "__main__":
    main()
