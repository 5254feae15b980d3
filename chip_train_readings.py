#!/usr/bin/env python3
"""The readings behind two settings of chip_smoke.py's phases 19 and 20,
on one NVIDIA card.

    python3 chip_train_readings.py [lr] [whisper]

lr: phase 19's AdamW learning rate.  hymba-1.5b (32 layers) and
deepseek-v3 (its 3 dense-prefix layers) train as in phase 19 (bf16, full
width, TILE_STREAM, the same seed, batch and steps) at 1e-3 (phase 10's
rate) and at 1e-4 (phase 19's), each once on the kernels and once with
every kernel replaced by its plain version (chip_smoke.plain_kernels: no
kernel launches).  Prints the loss and the gradients' global norm of every
step: if the plain path's loss rises at 1e-3 as the kernels' does, the
rise is the optimizer's on this function, not a kernel's.

whisper: phase 20's whisper-base check (f32, 2 + 2 layers, B = 2,
S = 256, every mode) at seeds 1-4 (phase 20 runs seed 1).  Per seed and
mode: the kernel path's largest gradient gap from the plain path and its
parameter, the plain path's gap from NON_STREAM's plain path (overall and
at that parameter), and a control: the same kernels fed their product
operands (q, k, v, dO; the stream kernel's q, x_kv, W_K, W_V, dO) rounded
to bf16, held against the plain path as the kernel path is.  Exits 1 if a
control stays within chip_smoke.WHISPER_GRAD_TOL: the limit would then
pass a kernel that computes its products from bf16 operands.

steps: the single-device train steps of phases 10, 19 and 22 that run
the transformer's embedding, layer loop and loss, and vilbert-base's
(``STEP_RUNS``: bf16, full width, the phases' depths, batches, modes and
optimizers): per arch, one warm-up step, ``STEP_REPS`` steps timed on the
host's clock (synchronized), then one step under torch.profiler: its
device time, its wall time, the device time of the embedding's backward
(``aten::embedding_dense_backward``, or ``aten::_index_put_impl_`` of an
indexing lookup) and the kernels that took the most device time.  One
JSON line an arch.  It times the tree whose ``chip_smoke.py`` it imports:
copied into the root of another checkout and run there, it times that
checkout, so that two trees compare within one call.

No arguments: lr and whisper.  Prints the card's name and power limit
first.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import torch

import chip_smoke as c

LR_ARCHS = ("hymba-1.5b", "deepseek-v3-671b")
LRS = (1e-3, 1e-4)
SEEDS = (1, 2, 3, 4)


def lr_readings(smi: str) -> None:
    runs = {r[0]: r for r in c.FAMILY_TRAIN_RUNS}
    for arch in LR_ARCHS:
        _, cut, B, S, steps, _ = runs[arch]
        for lr in LRS:
            opt = dataclasses.replace(c.FAMILY_OPT, learning_rate=lr)
            for path in ("kernels", "plain"):
                cfg, model = c.train_model(arch, cut)
                batch = c.family_batch(cfg, B, S)
                state = c.OPT.init(dict(model.named_parameters()))
                step = c.ST.make_train_step(cfg, opt, mode=c.FAMILY_MODE)
                losses, norms = [], []
                with (c.plain_kernels() if path == "plain"
                      else contextlib.nullcontext()):
                    c.reset_counts()
                    for _ in range(steps):
                        model, state, m = step(model, state, batch)
                        losses.append(m["loss"])
                        norms.append(m["grad_norm"])
                    launched = sum(c.counts().values())
                if (path == "plain") == bool(launched):
                    c.fail(f"{arch} {path}: {launched} kernel launches")
                print(f"  {arch} ({cfg.num_layers} layers, B = {B}, S = {S}) "
                      f"bf16 AdamW {lr:g} on the {path}: loss "
                      + " -> ".join(f"{x:.4f}" for x in losses)
                      + "; grad norm "
                      + " -> ".join(f"{x:.3f}" for x in norms)
                      + f" [{smi}]", flush=True)
                del model, state, batch, step
                c.free()


# arch, depth cut, B, S, mode, optimizer (the phases' own)
STEP_RUNS = (
    ("qwen3-32b", {"num_layers": 4}, 1, 4096,
     c.ExecutionMode.LAYER_STREAM, c.TRAIN_OPT),
    ("vilbert-base", {}, 2, 4096, c.ExecutionMode.LAYER_STREAM, c.TRAIN_OPT),
    ("mamba2-780m", {}, 1, 2048, c.FAMILY_MODE, c.FAMILY_OPT),
    ("hymba-1.5b", {}, 1, 2048, c.FAMILY_MODE, c.FAMILY_OPT),
)
STEP_REPS = 8
EMBED_BWD = ("aten::embedding_dense_backward", "aten::_index_put_impl_")


def step_readings(smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    for arch, cut, B, S, mode, opt in STEP_RUNS:
        cfg, model = c.train_model(arch, cut)
        batch = c.family_batch(cfg, B, S)
        state = c.OPT.init(dict(model.named_parameters()))
        step = c.ST.make_train_step(cfg, opt, mode=mode)
        model, state, _ = step(model, state, batch)
        ms = []
        for _ in range(STEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, _ = step(model, state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model, state, _ = step(model, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = {e.key: e.self_device_time_total / 1e3 for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        embed = {e.key: e.device_time_total / 1e3 for e in events
                 if e.key in EMBED_BWD}
        top = sorted(kernels.items(), key=lambda kt: -kt[1])[:8]
        print(json.dumps({
            "arch": arch, "layers": cfg.num_layers, "mode": mode.value,
            "B": B, "S": S, "step_ms": [round(x, 3) for x in ms],
            "step_ms_mean": round(sum(ms) / len(ms), 3),
            "profiled_wall_ms": round(wall, 3),
            "profiled_device_ms": round(sum(kernels.values()), 3),
            "embed_bwd_device_ms": {k: round(v, 4)
                                    for k, v in embed.items()},
            "top": [[k[:60], round(v, 3)] for k, v in top],
            "card": smi}), flush=True)
        del model, state, batch, step
        c.free()


def _rounded(t):
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def bf16_operands():
    """The attention backward kernels' product operands rounded to bf16
    (lse and the forward's output as they are)."""
    flash_vjp = c.flash_vjp
    flash = flash_vjp.flash_attention_bwd
    stream = flash_vjp.stream_attention_bwd

    def flash_rounded(q, k, v, out, lse, dout, **kw):
        return flash(*map(_rounded, (q, k, v)), out, lse, _rounded(dout),
                     **kw)

    def stream_rounded(q, x_kv, wk, wv, out, lse, dout, **kw):
        return stream(*map(_rounded, (q, x_kv, wk, wv)), out, lse,
                      _rounded(dout), **kw)

    for fn, wrapped in ((flash_rounded, flash), (stream_rounded, stream)):
        # the wrappers count their launches on the module's name
        fn.launches, fn.routes = 0, dict(wrapped.routes)
    flash_vjp.flash_attention_bwd = flash_rounded
    flash_vjp.stream_attention_bwd = stream_rounded
    try:
        yield
    finally:
        flash_vjp.flash_attention_bwd = flash
        flash_vjp.stream_attention_bwd = stream


def leaf_gap(got: dict, want: dict, k: str) -> float:
    g, w = got[k].float(), want[k].float()
    return ((g - w).abs().max() / w.abs().max()).item()


def whisper_readings(smi: str) -> int:
    arch, cut, B, S, modes, tol = next(e for e in c.FAMILY_CHECKS
                                       if e[0] == "whisper-base")
    caught = True
    for seed in SEEDS:
        cfg, model = c.train_model(arch, cut, dtype="float32", seed=seed)
        batch = c.family_batch(cfg, B, S, seed=seed)
        base = None
        for mode in modes:
            c.reset_counts()
            kernel = c.to_host(c.grads_of(model, cfg, batch, mode))
            backward = (c.flash_attention_bwd.launches
                        + c.stream_attention_bwd.launches)
            with c.plain_kernels():
                plain = c.to_host(c.grads_of(model, cfg, batch, mode))
            base = plain if base is None else base
            gap, leaf = c.grad_gap(kernel, plain)
            floor, fleaf = c.grad_gap(plain, base)
            line = (f"  whisper-base seed {seed} {mode.value}: kernel against "
                    f"plain {gap:.3e} ({leaf}); plain against "
                    f"{modes[0].value}'s plain {floor:.3e} ({fleaf}), at "
                    f"{leaf} {leaf_gap(plain, base, leaf):.3e}")
            if backward:
                with bf16_operands():
                    control = c.to_host(c.grads_of(model, cfg, batch, mode))
                cgap, cleaf = c.grad_gap(control, plain)
                caught &= cgap > tol
                line += (f"; control (bf16 operands) against plain "
                         f"{cgap:.3e} ({cleaf}), limit {tol:g}")
            print(line + f" [{smi}]", flush=True)
            del kernel, plain
        del model, batch, base
        c.free()
    return 0 if caught else 1


def main() -> None:
    if not torch.cuda.is_available():
        c.fail("no CUDA device: these readings need one NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"built in {c._build.build_all():.1f} s", flush=True)
    parts = sys.argv[1:] or ["lr", "whisper"]
    rc = 0
    for part in parts:
        t0 = time.perf_counter()
        if part == "lr":
            lr_readings(smi)
        elif part == "whisper":
            rc |= whisper_readings(smi)
        elif part == "steps":
            step_readings(smi)
        else:
            c.fail(f"unknown part {part!r}: lr, whisper or steps")
        print(f"{part} took {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
