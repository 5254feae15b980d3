"""Serving launcher: batched generation with the continuous-batching engine
(counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --smoke --requests 8 --max-new 16 [--slots 4] [--max-len 256] \\
        [--device cpu]

Every decoder arch of the registry serves (dense, MoE, MLA, VLM, SSM,
hybrid); the encoder-decoder and crossmodal families are refused, as the
engine refuses them.  Weights are drawn from a seeded ``torch.Generator``
(seed 0) and the requests exactly as the JAX launcher draws them.  It runs
on the card unless ``--device`` names another; with no card and no
``--device cpu`` it refuses to start.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, Request


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=list(registry.ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the card)")
    return ap.parse_args(argv)


def draw_requests(cfg: ModelConfig, n: int, max_len: int,
                  max_new: int) -> List[Request]:
    """``n`` requests of 4 to ``max_len // 4`` prompt tokens, drawn from
    ``np.random.default_rng(0)`` in the JAX launcher's order
    (serve.py:33-39)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, max_len // 4))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                       size=(plen,)).astype(np.int32),
            max_new_tokens=max_new))
    return reqs


def run(args: argparse.Namespace) -> Tuple[Engine, List[Request]]:
    """Build the model and the engine, serve the drawn requests; returns
    the engine and its finished requests."""
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    device = runtime.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device=device, generator=gen)
    eng = Engine(cfg, model, slots=args.slots, max_len=args.max_len)
    for r in draw_requests(cfg, args.requests, args.max_len, args.max_new):
        eng.submit(r)
    return eng, eng.run()


def main(argv: Optional[List[str]] = None) -> None:
    args = parse(argv)
    t0 = time.time()
    _, done = run(args)
    dt = time.time() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {total} new tokens, {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
