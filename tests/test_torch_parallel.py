"""The 'model'-axis primitives (``repro_torch.distributed.parallel``) on the
CPU, without a process group:

* one layer's attention and MLP (or MoE) sublayers, run in turn as each
  of the m ranks of a 'model' axis on the rank's blocks (``rank_view``:
  ``copy`` and ``reduce`` are the identity, ``gather_rows`` puts the
  rank's rows among zeros), sum to the whole sublayers: outputs and input
  gradients summed, the split weights' gradients the blocks of the whole
  ones, the replicated weights' the sums of the ranks' partial ones,
  within 1e-5 of the largest value, in the three execution modes where
  the split attention reads the mode:
  qwen3-32b smoke (8 query heads over 2 kv heads: each rank's 2 read one)
  and h2o-danube3-4b smoke (a sliding window) at 4; deepseek-v3 smoke at
  4 (EP: 2 of 8 experts a rank; MLA: 1 of 4 heads; the shared expert's
  d_ff); grok-1 smoke at 8 (expert-TP: 4 experts do not divide 8, each
  expert's d_ff does; its 4 heads stay whole); under the ``attn_q`` hint
  minitron-4b (6 heads) and hymba-1.5b (5 heads, a 16-key window) at 4
  and qwen2-vl-2b (M-RoPE) at 8, context-parallel; a sequence of 30,
  which 4 does not divide, context-parallel on blocks of 8 rows, the last
  one ending at row 30;
* a layer's recomputation under remat runs under the forward's runtime
  flags, also on another thread (autograd's device thread on the card);
* the vocabulary-parallel loss and lookup at one rank are the plain ones;
* the SSM mixer (mamba2-780m smoke's heads, hymba-1.5b smoke's heads or
  its out_proj rows alone), vilbert-base smoke's co-TRM block (both
  streams, LAYER and TILE at 4) and whisper-base smoke's decoder layer
  (by heads at 4; context-parallel under the hint at 8) and encoder
  layer (context-parallel over 45 frames, which 8 does not divide) the
  same way, the SSM's ``gather_cols`` and ``sum_over`` through an
  ``Exchange``; ``gather_cols``'s backward sums over the ranks before it
  takes the rank's columns, and a rank without a group or an
  ``Exchange`` refuses both;
* which parameters the layers compute on their block, against the rule
  table at production axis sizes, for every arch (nothing replicated),
  and vilbert-base's language stream at 8 (12 heads) kept whole;
* ``train.loop.build_sharded`` keeps exactly ``build_model``'s values in
  each rank's block, on a fake (2, 2) world.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core import runtime
from repro_torch.core.types import AttnKind, ExecutionMode, Family
from repro_torch.distributed import parallel as PL
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.hints import hint_shardings
from repro_torch.models.layers import (attention_forward,
                                       attention_forward_mrope, embed_lookup,
                                       mlp_forward, moe_forward,
                                       mrope_tables, nll_sum,
                                       rope_tables_for)
from repro_torch.models.mla import mla_forward
from repro_torch.models.transformer import Block
from repro_torch.train import loop as L

PROD = {"data": 16, "model": 16}
# id: (arch, 'model' size, under the attn_q hint, sequence length)
CASES = {"qwen3-32b": ("qwen3-32b", 4, False, 32),
         "h2o-danube3-4b": ("h2o-danube3-4b", 4, False, 32),
         "deepseek-v3-671b": ("deepseek-v3-671b", 4, False, 32),
         "grok-1-314b": ("grok-1-314b", 8, False, 32),
         "minitron-4b-cp": ("minitron-4b", 4, True, 32),
         "hymba-1.5b-cp": ("hymba-1.5b", 4, True, 32),
         "qwen2-vl-2b-cp": ("qwen2-vl-2b", 8, True, 32),
         "minitron-4b-cp-seq30": ("minitron-4b", 4, True, 30)}


def _sublayers(blk, cfg, h, tabs, mode):
    """(attention, MLP or MoE) of the pre-normed h."""
    if cfg.attn_kind == AttnKind.MLA:
        a = mla_forward(blk.attn, cfg, h, sin=tabs[0], cos=tabs[1])
    elif cfg.family == Family.VLM:
        a = attention_forward_mrope(blk.attn, cfg, h, sin_b=tabs[0],
                                    cos_b=tabs[1])
    else:
        a = attention_forward(blk.attn, cfg, h, sin=tabs[0], cos=tabs[1],
                              causal=True, mode=mode)
    f = (moe_forward(blk.moe, cfg, h) if hasattr(blk, "moe")
         else mlp_forward(blk.mlp, h))
    return a, f


def _want_shapes(cfg, m):
    """The rank's shapes of the parameters that tell its split apart."""
    d, H = cfg.d_model, cfg.num_heads
    if cfg.family == Family.MOE:
        E, f = cfg.num_experts, cfg.moe_d_ff
        ep = E % m == 0
        want = {"moe.w_up": (E // m, d, f) if ep else (E, d, f // m),
                "moe.w_down": (E // m, f, d) if ep else (E, f // m, d),
                "moe.router": (d, E)}
    else:
        want = {"mlp.w_up": (d, cfg.d_ff // m)}
    if cfg.attn_kind == AttnKind.MLA:
        want.update({"attn.wq_b": (cfg.q_lora_rank, H // m,
                                   cfg.qk_nope_head_dim
                                   + cfg.qk_rope_head_dim),
                     "attn.wo": (H // m, cfg.v_head_dim, d),
                     "attn.wq_a": (d, cfg.q_lora_rank)})
    else:
        split = PL.attention_split(cfg, m)
        kv = cfg.num_kv_heads
        want["attn.wq"] = (d, H // m if split else H, cfg.head_dim)
        # K/V on their heads only where the kv heads divide too
        want["attn.wk"] = (d, kv // m if split and kv % m == 0 else kv,
                           cfg.head_dim)
    return want


def _rel(got, want):
    return float((got - want).detach().abs().max() / want.abs().max())


def _case_modes():
    """Every mode where the split attention reads it; one for MLA and
    M-RoPE (they read no mode) and expert-TP (the split is the MoE's; the
    attention stays whole)."""
    blind = ("deepseek-v3-671b", "grok-1-314b", "qwen2-vl-2b-cp")
    return [pytest.param(a, m, id=f"{a}-{m.value}") for a in CASES
            for m in ExecutionMode
            if a not in blind or m == ExecutionMode.LAYER_STREAM]


@pytest.mark.parametrize("arch,mode", _case_modes())
def test_ranks_sum_to_the_whole_layer(arch, mode):
    name, m, hinted, S = CASES[arch]
    cfg = registry.get_config(name, smoke=True)
    rng = np.random.default_rng(0)
    blk = Block(cfg, torch.Generator().manual_seed(0),
                moe=cfg.family == Family.MOE).requires_grad_(True)
    B = 2
    h = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    if cfg.family == Family.VLM:
        tabs = mrope_tables(cfg, torch.from_numpy(
            rng.integers(0, 8, (3, B, S))))
    else:
        tabs = rope_tables_for(cfg, S, head_dim=cfg.qk_rope_head_dim
                               if cfg.attn_kind == AttnKind.MLA else None)
    hints = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(
        {"data": 1, "model": m})) if hinted else None
    rows = hinted and PL.context_split(cfg, m, hints)
    # neither the heads nor the rows split: every rank runs the whole
    # attention, of which it contributes 1/m (m a power of two: exact)
    whole_attn = not (rows or PL.attention_split(cfg, m)
                      or cfg.attn_kind == AttnKind.MLA)
    assert rows == hinted
    names = [n for n, _ in blk.named_parameters()]
    with runtime.flags(sharding_hints=hints):
        a, f = _sublayers(blk, cfg, h, tabs, mode)
        whole = torch.autograd.grad(a + f, [h, *blk.parameters()], dy,
                                    allow_unused=True)
        want = {n: g for n, g in zip(names, whole[1:]) if g is not None}
        ys, dh, parts = 0, 0, {}
        n = -(-S // m)     # rank r's rows r·n ... min((r + 1)·n, S) - 1
        for r in range(m):
            with PL.rank_view(blk, "layers", cfg, r, m) as t:
                for k, shape in _want_shapes(cfg, m).items():
                    assert tuple(t[k].shape) == shape, k
                ar, fr = _sublayers(blk, cfg, h, tabs, mode)
                if whole_attn:
                    assert torch.equal(ar, a)
                    ar = ar / m
                elif rows:           # the rank's rows, zeros elsewhere
                    outside = torch.cat([ar[:, :r * n], ar[:, (r + 1) * n:]],
                                        1)
                    assert not outside.any()
                yr = ar + fr
                keys = list(t)
                got = torch.autograd.grad(yr, [h, *(t[k] for k in keys)], dy,
                                          allow_unused=True)
            ys, dh = ys + yr, dh + got[0]
            for k, g in zip(keys, got[1:]):
                if g is not None:
                    parts.setdefault(k, []).append(g)
    y = a + f
    assert _rel(ys, y) < 1e-5 and _rel(dh, whole[0]) < 1e-5
    assert set(parts) == set(want)
    for k, gs in parts.items():
        if gs[0].shape == want[k].shape:         # replicated: partial sums
            got = sum(gs)
        else:                                    # split: the blocks
            d = next(i for i, (a, b) in enumerate(zip(gs[0].shape,
                                                      want[k].shape))
                     if a != b)
            got = torch.cat(gs, d)
        assert _rel(got, want[k]) < 1e-5, k


def test_recomputation_runs_under_the_forward_flags():
    """A repair: under remat a layer's recomputation ran under the flags
    of the thread that runs the backward (on the card, autograd's device
    thread, which starts with none), so that ``moe_groups`` and the hint
    table were lost and the recomputed layer differed from its forward.
    grok-1 smoke with 4 token groups at a capacity that drops tokens: the
    backward on another thread gives the gradients of the step without
    remat."""
    import threading
    from repro_torch.core.types import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import loss_fn
    cfg = registry.get_config("grok-1-314b", smoke=True)
    shape = ShapeConfig("t", 32, 2, "train")
    cpu = torch.device("cpu")
    batch = L.to_device(SyntheticLM(cfg, shape, seed=0).batch(0), cfg, cpu)
    model = L.build_model(cfg, cpu, 0)
    params = [p for p in model.parameters() if p.requires_grad]

    def grads(remat, thread):
        with runtime.flags(moe_groups=4, moe_capacity=0.5):
            loss = loss_fn(model, batch, remat=remat)
        out = {}

        def backward():
            out["g"] = torch.autograd.grad(loss, params, allow_unused=True)
        if thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        return out["g"]
    for a, b in zip(grads(False, False), grads(True, True)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_mrope_attention_ranks_sum_to_the_whole():
    """qwen2-vl-2b smoke's M-RoPE attention (4 query heads over 2 kv heads,
    batch-dependent tables) on 4 ranks: one query head a rank, each pair
    of ranks reading one kv head; outputs and input gradients summed."""
    from repro_torch.models.layers import (attention_forward_mrope,
                                           mrope_tables)
    cfg = registry.get_config("qwen2-vl-2b", smoke=True)
    rng = np.random.default_rng(2)
    blk = Block(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    B, S, m = 2, 16, 4
    h = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    pos = torch.from_numpy(rng.integers(0, 8, (3, B, S)))
    sin_b, cos_b = mrope_tables(cfg, pos)

    def run():
        return attention_forward_mrope(blk.attn, cfg, h, sin_b=sin_b,
                                       cos_b=cos_b)
    y = run()
    dh = torch.autograd.grad(y.square().sum(), h)[0]
    ys, dhs = 0, 0
    for r in range(m):
        with PL.rank_view(blk, "layers", cfg, r, m) as t:
            assert t["attn.wq"].shape[1] == 1
            yr = run()
            # the loss is of the summed output: each rank's share of dy
            dhs = dhs + torch.autograd.grad(yr, h, 2 * y.detach())[0]
        ys = ys + yr.detach()
    assert _rel(ys, y) < 1e-5 and _rel(dhs, dh) < 1e-5


def test_vocab_parallel_loss_and_lookup_at_one_rank_are_the_plain_ones():
    cfg = registry.get_config("qwen3-32b", smoke=True)
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((cfg.d_model, 512)).astype(
        np.float32) * 0.1).requires_grad_(True)
    h = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 512, (2, 16)))
    labels[0, :3] = -1
    tp = PL.ModelParallel(0, 1)
    plain = nll_sum(w, h, labels, None)
    split = nll_sum(w, h, labels, tp)
    torch.testing.assert_close(split, plain, rtol=1e-6, atol=1e-5)
    gp, = torch.autograd.grad(plain, w)
    gs, = torch.autograd.grad(split, w)
    torch.testing.assert_close(gs, gp, rtol=1e-5, atol=1e-6)
    emb = torch.from_numpy(rng.standard_normal((512, 8)).astype(np.float32))
    tokens = labels.clamp(min=0)
    assert torch.equal(PL.vocab_embed(tp, emb, tokens), emb[tokens])


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_what_the_layers_compute_on_their_block(arch):
    """At (16, 16): every parameter computed on its block is one the rule
    table splits over 'model' (its block is what the step stores), and
    everything the rules split is either computed on its block or listed
    as replicated over 'model'.  No arch lists any: the dense decoders,
    qwen2-vl (whose attention the rules keep whole at 16), the MoE
    family (experts and MLA on their blocks), the SSM projections
    (mamba2's heads; hymba's out_proj rows, its in_proj replicated by the
    rule), vilbert (its heads where they divide) and whisper."""
    cfg = registry.get_config(arch)
    shapes = {k: v.shape for k, v in registry.param_specs(cfg).items()}
    local = PL.local_names(shapes, cfg, PROD)
    listed = set(PL.replicated_over_model(shapes, cfg, PROD))
    sh = SH.param_shardings(shapes, cfg, axis_sizes=PROD)
    for k, s in sh.items():
        on_model = any("model" in SH._axes(e) for e in s.spec)
        path = SH.jax_path(k)[0]
        assert (k in local) + (path in listed) == on_model, k
    assert not listed
    emb = ("text_embed.embedding" if cfg.family == Family.CROSSMODAL
           else "embed.embedding")
    assert emb in local
    if cfg.family == Family.SSM:
        assert {"layers.0.ssm.in_proj", "layers.0.ssm.out_proj"} <= local
    if cfg.family == Family.HYBRID:
        assert "layers.0.ssm.out_proj" in local
        assert "layers.0.ssm.in_proj" not in local
    if cfg.family == Family.CROSSMODAL:
        att = {f"{s}.0.{a}.wq" for s in ("co_x", "co_y")
               for a in ("co_attn", "self_attn")}
        # vilbert-large's 16 heads split; vilbert-base's 8 (the rule's
        # count) do not divide 16, and the rules keep them whole
        assert (att <= local) == (arch == "vilbert-large")
        assert "co_x.0.mlp.w_up" in local and "text_pre.0.mlp.w_down" in local
    if cfg.family == Family.ENCDEC:
        assert {"enc_layers.0.mlp.w_up", "dec_layers.0.mlp.w_down"} <= local
    assert PL.attention_split(cfg, 16) == (arch in ("qwen3-32b",
                                                    "grok-1-314b",
                                                    "h2o-danube3-4b"))
    if cfg.family == Family.MOE:
        assert {"layers.0.moe.w_up", "layers.0.moe.w_down"} <= local
        assert "layers.0.moe.router" not in local
    if cfg.attn_kind == AttnKind.MLA:
        assert {"layers.0.attn.wq_b", "dense_layers.0.attn.wo"} <= local
        assert "layers.0.attn.wkv_a" not in local
    # the attn_q hint makes attention context-parallel where the heads do
    # not split over 'model' (vilbert's attention reaches no hint)
    hints = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(PROD))
    assert PL.context_split(cfg, 16, hints) == (arch in (
        "starcoder2-7b", "minitron-4b", "qwen2-vl-2b", "hymba-1.5b",
        "whisper-base"))
    assert not PL.context_split(cfg, 16, None)


def test_vilbert_base_language_stream_at_8_stays_whole():
    """The rule reads the vision stream's head count (8) for both streams
    of vilbert-base: at 'model' 8 it splits the language stream's 12
    heads too, which 8 does not divide.  Those weights stay whole over
    'model' and are listed as replicated; the vision stream's take their
    blocks; a block of 12 heads over 8 is refused."""
    cfg = registry.get_config("vilbert-base")
    shapes = {k: v.shape for k, v in registry.param_specs(cfg).items()}
    sizes = {"data": 1, "model": 8}
    assert SH.spec_for_param("text_pre/attn/wq", (768, 12, 64), cfg,
                             SH._SimulatedMesh(sizes), False) == (
        None, "model", None)
    local = PL.local_names(shapes, cfg, sizes)
    listed = PL.replicated_over_model(shapes, cfg, sizes)
    lang = [f"{p}/{n}" for p in ("text_pre/attn", "co_y/co_attn",
                                 "co_y/self_attn")
            for n in ("wq", "wk", "wv", "wo")]
    assert listed == sorted(lang)
    for side in ("co_attn", "self_attn"):
        assert f"co_x.0.{side}.wq" in local
        assert f"co_y.0.{side}.wq" not in local
    assert "co_y.0.mlp.w_up" in local and "text_pre.0.mlp.w_up" in local
    with pytest.raises(ValueError, match="evenly"):
        PL.model_block(torch.zeros(768, 12, 64), "text_pre/attn/wq", cfg, 0, 8)
    assert PL.model_block(torch.zeros(1024, 8, 128), "co_x/co_attn/wq", cfg,
                          3, 8).shape == (1024, 1, 128)


def _rank_sums(module, prefix, cfg, m, run, inputs, exchange=None):
    """The whole ``run()`` (a list of outputs) of ``module`` and its m
    ranks in turn (``rank_view``; with an ``exchange``, every pass until
    it holds, the last one's): outputs and input gradients summed, each
    parameter's gradient joined (a block) or summed (replicated), each
    against the whole's, as max |difference| / max |value|."""
    params = dict(module.named_parameters())
    outs = run()
    rng = np.random.default_rng(9)
    dys = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in outs]
    whole = torch.autograd.grad(outs, inputs + list(params.values()), dys,
                                allow_unused=True)
    want = {n: g for n, g in zip(params, whole[len(inputs):])
            if g is not None}
    passes = exchange or PL.Exchange()
    while passes.another_pass():
        ys, dxs, parts = [0] * len(outs), [0] * len(inputs), {}
        for r in range(m):
            with PL.rank_view(module, prefix, cfg, r, m,
                              exchange=exchange) as t:
                o = run()
                keys = list(t)
                got = torch.autograd.grad(o, inputs + [t[k] for k in keys],
                                          dys, allow_unused=True)
            ys = [a + b.detach() for a, b in zip(ys, o)]
            dxs = [a + b for a, b in zip(dxs, got[:len(inputs)])]
            for k, g in zip(keys, got[len(inputs):]):
                if g is not None:
                    parts.setdefault(k, []).append(g)
        if exchange is None:
            break
    gaps = {f"y{i}": _rel(a, b) for i, (a, b) in enumerate(zip(ys, outs))}
    gaps.update({f"d{i}": _rel(a, b)
                 for i, (a, b) in enumerate(zip(dxs, whole))})
    assert set(parts) == set(want)
    for k, gs in parts.items():
        if gs[0].shape == want[k].shape:
            got = sum(gs)
        else:
            d = next(i for i, (a, b) in enumerate(zip(gs[0].shape,
                                                      want[k].shape))
                     if a != b)
            got = torch.cat(gs, d)
        gaps[k] = _rel(got, want[k])
    return gaps


def _inputs(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .requires_grad_(True) for s in shapes]


# (arch, 'model' size): mamba2-780m smoke's 4 heads of 48 channels, 1 or
# 2 a rank (its in_proj's 420 columns split); hymba-1.5b smoke at 4 (1 of
# 4 heads of 50) and at 8, where 25 rows a rank are no whole head and its
# in_proj (420 over 8) stays replicated: out_proj's rows alone split
SSM_CASES = [("mamba2-780m", 4), ("mamba2-780m", 2), ("hymba-1.5b", 4),
             ("hymba-1.5b", 8)]


@pytest.mark.parametrize("arch,m", SSM_CASES)
def test_ssm_ranks_sum_to_the_whole_layer(arch, m):
    """The SSM mixer of a layer on m 'model' ranks in turn, its
    ``gather_cols`` and ``sum_over`` carried by an ``Exchange``: outputs,
    input gradients and every parameter's gradient within 1e-5 of the
    whole mixer's (f32)."""
    from repro_torch.models.ssm import ssm_dims, ssm_forward
    cfg = registry.get_config(arch, smoke=True)
    blk = Block(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    h, = _inputs(np.random.default_rng(0), (2, 32, cfg.d_model))
    _, d_inner, _, P = ssm_dims(cfg)
    heads = (d_inner // m) % P == 0
    split_in = (d_inner * 2 + 2 * cfg.ssm_state + ssm_dims(cfg)[2]) % m == 0
    assert (arch, m, heads, split_in) in (
        ("mamba2-780m", 4, True, True), ("mamba2-780m", 2, True, True),
        ("hymba-1.5b", 4, True, True), ("hymba-1.5b", 8, False, False))
    cols = blk.ssm.in_proj.shape[1]
    with PL.rank_view(blk.ssm, "layers/ssm", cfg, 0, m) as t:
        assert t["out_proj"].shape[0] == d_inner // m
        assert t["in_proj"].shape[1] * (m if split_in else 1) == cols
    ex = PL.Exchange()
    gaps = _rank_sums(blk.ssm, "layers/ssm", cfg, m,
                      lambda: [ssm_forward(blk.ssm, cfg, h)], [h], ex)
    assert ex.passes == (5 if heads else 1)
    assert max(gaps.values()) < 1e-5, gaps


def test_gather_cols_backward_sums_before_it_takes_the_rank_columns():
    """``gather_cols`` through an ``Exchange``: every rank gets the whole
    columns, and its input gradient is its columns of the ranks' summed
    gradients (a reduce-scatter), not its columns of its own gradient
    alone: ranks that read different columns of the whole each hold a
    partial gradient of it."""
    m, n = 4, 3
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
          for _ in range(m)]
    ws = [torch.from_numpy(rng.standard_normal((2, m * n)).astype(np.float32))
          for _ in range(m)]
    ex = PL.Exchange()
    while ex.another_pass():
        grads, outs = [], []
        for r in range(m):
            tp = PL.ModelParallel(r, m, exchange=ex)
            x = xs[r].clone().requires_grad_(True)
            y = tp.gather_cols(x)
            outs.append(y.detach())
            grads.append(torch.autograd.grad((y * ws[r]).sum(), x)[0])
    whole = torch.cat(xs, -1)
    total = sum(ws)
    for r in range(m):
        assert torch.equal(outs[r], whole)
        torch.testing.assert_close(grads[r], total[:, r * n:(r + 1) * n])
        assert not torch.allclose(grads[r], ws[r][:, r * n:(r + 1) * n])


@pytest.mark.parametrize("mode", [ExecutionMode.LAYER_STREAM,
                                  ExecutionMode.TILE_STREAM])
def test_vilbert_co_trm_ranks_sum_to_the_whole(mode):
    """vilbert-base smoke's co-TRM block, both streams, on 4 'model'
    ranks (one of 4 heads a stream): co-attention (Q from the own stream,
    K/V generated from the other modality: in TILE_STREAM the stream
    kernel's plain version on the rank's heads), self-attention and the
    MLP of each stream on pre-normed inputs, summed over the ranks,
    within 1e-5 of the whole, gradients too."""
    from repro_torch.models import vilbert as V
    cfg = registry.get_config("vilbert-base", smoke=True)
    model = V.ViLBERT(cfg, device="cpu").requires_grad_(True)
    x, y = _inputs(np.random.default_rng(1), (2, 32, cfg.d_model),
                   (2, 24, cfg.d_model_y))
    px, py = model.co_x[0], model.co_y[0]
    assert V._resolve(cfg, mode, cfg.d_model_y, cfg.num_heads,
                      cfg.d_model // cfg.num_heads) == mode

    def run():
        return [V._attn(px.co_attn, cfg, x, y, mode),
                V._attn(px.self_attn, cfg, x, x, mode), mlp_forward(px.mlp, x),
                V._attn(py.co_attn, cfg, y, x, mode),
                V._attn(py.self_attn, cfg, y, y, mode), mlp_forward(py.mlp, y)]
    with PL.rank_view(model, None, cfg, 0, 4) as t:
        for side, H in (("co_x", cfg.num_heads), ("co_y", cfg.num_heads_y)):
            assert t[f"{side}.0.co_attn.wk"].shape[1] == H // 4
            assert t[f"{side}.0.self_attn.wo"].shape[0] == H // 4
    gaps = _rank_sums(model, None, cfg, 4, run, [x, y])
    assert max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("m,hinted", [(4, False), (8, True)])
@pytest.mark.parametrize("mode", [ExecutionMode.LAYER_STREAM,
                                  ExecutionMode.TILE_STREAM])
def test_whisper_decoder_layer_ranks_sum_to_the_whole(m, hinted, mode):
    """whisper-base smoke's decoder layer on m 'model' ranks: its causal
    self-attention, its cross-attention to the encoder states (x_kv by
    ``copy``) and its MLP on pre-normed inputs, summed over the ranks
    within 1e-5 of the whole, gradients too: at 4 on one of 4 heads a
    rank; at 8, which its 4 heads do not divide, under the attn_q hint
    context-parallel on 4 of 32 query rows a rank."""
    from repro_torch.models import encdec as E
    cfg = registry.get_config("whisper-base", smoke=True)
    model = E.EncDec(cfg, device="cpu").requires_grad_(True)
    x, enc = _inputs(np.random.default_rng(2), (2, 32, cfg.d_model),
                     (2, cfg.encoder_seq, cfg.d_model))
    p = model.dec_layers[0]
    hints = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(
        {"data": 1, "model": m})) if hinted else None
    assert PL.context_split(cfg, m, hints) == hinted
    assert PL.attention_split(cfg, m) == (not hinted)

    def run():
        return [attention_forward(p.self_attn, cfg, x, causal=True,
                                  mode=mode),
                attention_forward(p.cross_attn, cfg, x, x_kv=enc,
                                  causal=False, mode=mode),
                mlp_forward(p.mlp, x)]
    with runtime.flags(sharding_hints=hints):
        gaps = _rank_sums(model, None, cfg, m, run, [x, enc])
    assert max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("mode", [ExecutionMode.LAYER_STREAM,
                                  ExecutionMode.TILE_STREAM])
def test_whisper_encoder_layer_ranks_sum_over_uneven_rows(mode):
    """whisper-base smoke's encoder layer over 45 frames on 8 'model'
    ranks under the attn_q hint (its 4 heads do not divide 8): the
    non-causal self-attention context-parallel on blocks of 6 query rows,
    the last two ending at frame 45 (rank 7 owns frames 42-44 of its
    block 39-44), and the MLP on its d_ff block, summed over the ranks
    within 1e-5 of the whole, gradients too."""
    from repro_torch.models import encdec as E
    cfg = registry.get_config("whisper-base", smoke=True)
    model = E.EncDec(cfg, device="cpu").requires_grad_(True)
    x, = _inputs(np.random.default_rng(3), (2, 45, cfg.d_model))
    p = model.enc_layers[0]
    hints = hint_shardings(["attn_q", "attn_out"], SH._SimulatedMesh(
        {"data": 1, "model": 8}))
    assert PL.context_split(cfg, 8, hints) and 45 % 8

    def run():
        return [attention_forward(p.attn, cfg, x, causal=False, mode=mode),
                mlp_forward(p.mlp, x)]
    with runtime.flags(sharding_hints=hints):
        with PL.rank_view(model, None, cfg, 7, 8):
            own = run()[0]
        assert not own[:, :42].any() and own[:, 42:].abs().min() > 0
        gaps = _rank_sums(model, None, cfg, 8, run, [x])
    assert max(gaps.values()) < 1e-5, gaps


def test_a_rank_without_group_or_exchange_refuses_to_gather():
    """Without a group, ``gather_cols`` and ``sum_over`` need the other
    ranks' values: with no ``Exchange`` they raise instead of returning
    the rank's share alone."""
    tp = PL.ModelParallel(1, 4)
    x = torch.ones(2, 3)
    for fn in (tp.gather_cols, tp.sum_over):
        with pytest.raises(RuntimeError, match="Exchange"):
            fn(x)
    assert torch.equal(PL.ModelParallel(0, 1).sum_over(x), x)


def test_build_sharded_keeps_build_model_values_in_each_block():
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    cfg = registry.get_config("qwen3-32b", smoke=True)
    want = dict(L.build_model(cfg, torch.device("cpu"), 3).named_parameters())
    with D.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        model, blocks = L.build_sharded(cfg, torch.device("cpu"), 3, mesh, 0)
        sh = SH.param_shardings(model, cfg, mesh, fsdp_threshold=0)
        for k, p in model.named_parameters():
            assert p.is_meta and p.requires_grad
            idx = SH.local_index(p.shape, mesh, sh[k].placements)
            assert torch.equal(blocks[k], want[k][idx]), k
            assert blocks[k].numel() < p.numel() or p.numel() == 1
    assert set(blocks) == set(want)
    # a lookup of the rank's rows at one rank (the whole table) is the
    # plain lookup
    emb = L.build_model(cfg, torch.device("cpu"), 3).embed
    tokens = torch.arange(10)[None]
    with PL.using(PL.ModelParallel(0, 1, local=[(emb, "embedding")])):
        assert torch.equal(embed_lookup(emb, tokens), emb.embedding[tokens])
