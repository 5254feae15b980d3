#!/usr/bin/env python3
"""Where the stream attention backward's tc route spends its time, on one
NVIDIA card.

    python3 chip_bwd_breakdown.py

Builds copies of csrc/ under build/bwd_breakdown/<variant>/ in which one
part of the tc dK/dV kernel (stream_dkv_tc) is left out, and times each
copy's kernels by the profiler at vilbert-base's vision and text
self-attention shapes (B = 2, N = 4096, bf16); each variant runs in its
own process.  A variant computes wrong gradients: the difference of its
stream_dkv_tc time from the base's is what the part costs.  Variants:
  base         the kernels as they are;
  no_walk      no span products (the ring still delivers every span);
  no_dw        no dW products and no read-modify-write of the dW slots;
  no_dx_reduce no distributed-shared-memory sum of the dx partials;
  no_gen_mma   no K/V generation products (the chunks still arrive; in
               both passes).
Prints the card's name and power limit, then one line a variant and shape.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src" / "repro_torch" / "csrc"
WORK = ROOT / "build" / "bwd_breakdown"
LIB = "stream_attention_bwd"
FILE = "stream_attention_bwd.cu"
VARIANTS = {   # variant: (source, its text, the text without the part)
    "base": None,
    "no_walk": (FILE, "          acc.span(sh, j * BK, q0, kv,",
                "          if (0) acc.span(sh, j * BK, q0, kv,"),
    "no_dw": (FILE,
              "        for (int hb = 0; hb < NH; ++hb) {\n"
              "          const uint32_t d = dkv + hb * 4 * PART;\n"
              "          const size_t o",
              "        for (int hb = 0; hb < 0; ++hb) {\n"
              "          const uint32_t d = dkv + hb * 4 * PART;\n"
              "          const size_t o"),
    "no_dx_reduce": (FILE, "        for (int i = rank; i < 8; i += C) {",
                     "        for (int i = 8; i < 8; i += C) {"),
    "no_gen_mma": ("stream_tc.cuh",
                   "      wgmma_ss<1>(g, desc_kmajor(xs + ks * 32), "
                   "desc_mnmajor(ws + ks * 2048), 1);",
                   "      if (0) wgmma_ss<1>(g, desc_kmajor(xs + ks * 32), "
                   "desc_mnmajor(ws + ks * 2048), 1);"),
}
SHAPES = {"vision self 4096": (2, 8, 4096, 128, 1024),
          "text self 4096": (2, 12, 4096, 64, 768)}


def plant(variant: str) -> Path:
    """A copy of csrc/ with the variant's part left out."""
    dst = WORK / variant / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(SRC, dst)
    if VARIANTS[variant]:
        source, text, fault = VARIANTS[variant]
        code = (dst / source).read_text()
        if code.count(text) != 1:
            sys.exit(f"FAIL: {variant}: its site in {source} is not unique")
        (dst / source).write_text(code.replace(text, fault))
    return dst


def measure(variant: str) -> None:
    """Build the variant's library and time its kernels (one process)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_vjp import stream_attention_bwd
    from repro_torch.kernels.stream_attention import stream_attention
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    inputs = {}
    for key, (B, H, S, hd, D) in SHAPES.items():   # the forward, as it is
        q, x, do = randn(B, H, S, hd), randn(B, S, D), randn(B, H, S, hd)
        wk, wv = (randn(D, H, hd, scale=D ** -0.5) for _ in range(2))
        inputs[key] = (q, x, wk, wv, do,
                       *stream_attention(q, x, wk, wv, return_lse=True))
    _build.CSRC, _build.BUILD_DIR = WORK / variant / "csrc", WORK / variant
    for key, (q, x, wk, wv, do, out, lse) in inputs.items():
        def run():
            return stream_attention_bwd(q, x, wk, wv, out, lse, do)

        run()
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        parts = {e.key.split("<")[0].split("(")[0].split("::")[-1]:
                 e.self_device_time_total / reps / 1e3
                 for e in prof.key_averages() if e.self_device_time_total}
        print(f"{variant:>12} {key}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()),
              flush=True)


def main() -> None:
    if len(sys.argv) == 2:
        measure(sys.argv[1])
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device: this breakdown needs one NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    try:
        jobs = [j for j in [_build._start("stream_attention")] if j]
        for variant in VARIANTS:     # every variant's build at once
            _build.CSRC, _build.BUILD_DIR = plant(variant), WORK / variant
            jobs += [j for j in [_build._start(LIB)] if j]
        for proc, tmp, lib, log in jobs:
            rc = proc.wait()
            log.close()
            if rc:
                sys.exit(f"FAIL: nvcc failed for {lib}:\n"
                         + lib.with_suffix(".log").read_text()[-4000:])
            os.replace(tmp, lib)
        for variant in VARIANTS:
            run = subprocess.run([sys.executable, __file__, variant],
                                 timeout=900, env=dict(os.environ))
            if run.returncode:
                sys.exit(f"FAIL: variant {variant} exited {run.returncode}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
