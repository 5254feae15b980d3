"""The 'model'-axis primitives (``repro_torch.distributed.parallel``) on the
CPU, without a process group:

* one layer's attention and MLP sublayers, run in turn as each of the 4
  ranks of a 'model' axis on the rank's blocks (``rank_view``: ``copy``
  and ``reduce`` are the identity), sum to the whole sublayers: outputs
  and input gradients summed, the split weights' gradients the blocks of
  the whole ones, the replicated K/V weights' and qk-norm gains' the sums
  of the ranks' partial ones; qwen3-32b smoke (8 query heads over 2 kv
  heads: each rank's 2 read one) and h2o-danube3-4b smoke (a sliding
  window) in the three execution modes, within 1e-5 of the largest value;
* the vocabulary-parallel loss and lookup at one rank are the plain ones;
* which parameters the layers compute on their block, against the rule
  table at production axis sizes, for every arch;
* ``train.loop.build_sharded`` keeps exactly ``build_model``'s values in
  each rank's block, on a fake (2, 2) world.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core.types import ExecutionMode, Family
from repro_torch.distributed import parallel as PL
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import (attention_forward, embed_lookup,
                                       mlp_forward, rope_tables_for)
from repro_torch.models.transformer import Block, _chunk_nll
from repro_torch.train import loop as L

PROD = {"data": 16, "model": 16}


def _sublayers(blk, cfg, h, sin, cos, mode):
    return (attention_forward(blk.attn, cfg, h, sin=sin, cos=cos,
                              causal=True, mode=mode)
            + mlp_forward(blk.mlp, h))


def _rel(got, want):
    return float((got - want).detach().abs().max() / want.abs().max())


@pytest.mark.parametrize("mode", list(ExecutionMode))
@pytest.mark.parametrize("arch", ["qwen3-32b", "h2o-danube3-4b"])
def test_ranks_sum_to_the_whole_layer(arch, mode):
    cfg = registry.get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    blk = Block(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    B, S, m = 2, 32, 4
    h = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    sin, cos = rope_tables_for(cfg, S)
    names = [n for n, _ in blk.named_parameters()]
    y = _sublayers(blk, cfg, h, sin, cos, mode)
    whole = torch.autograd.grad(y, [h, *blk.parameters()], dy,
                                allow_unused=True)
    want = {n: g for n, g in zip(names, whole[1:]) if g is not None}
    ys, dh, parts = 0, 0, {}
    for r in range(m):
        with PL.rank_view(blk, "layers", cfg, r, m) as t:
            assert t["attn.wq"].shape[1] == cfg.num_heads // m
            assert t["mlp.w_up"].shape[1] == cfg.d_ff // m
            assert t["attn.wk"].shape == blk.attn.wk.shape   # 2 kv heads
            yr = _sublayers(blk, cfg, h, sin, cos, mode)
            keys = list(t)
            got = torch.autograd.grad(yr, [h, *(t[k] for k in keys)], dy,
                                      allow_unused=True)
        ys, dh = ys + yr, dh + got[0]
        for k, g in zip(keys, got[1:]):
            if g is not None:
                parts.setdefault(k, []).append(g)
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
    plain = _chunk_nll(w, h, labels, None)
    split = _chunk_nll(w, h, labels, tp)
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
    as replicated over 'model'.  qwen3-32b, the dense decoders and
    qwen2-vl (whose split attention the rules do not allow at 16) list
    none; the families whose layers are a later slice list theirs."""
    cfg = registry.get_config(arch)
    shapes = {k: v.shape for k, v in registry.param_specs(cfg).items()}
    local = PL.local_names(shapes, cfg, PROD)
    listed = set(PL.replicated_over_model(shapes, cfg, PROD))
    sh = SH.param_shardings(shapes, cfg, axis_sizes=PROD)
    for k, s in sh.items():
        on_model = any("model" in SH._axes(e) for e in s.spec)
        path = SH.jax_path(k)[0]
        assert (k in local) + (path in listed) == on_model, k
    dense = ("qwen3-32b", "starcoder2-7b", "minitron-4b", "h2o-danube3-4b",
             "qwen2-vl-2b")
    assert (not listed) == (arch in dense)
    if cfg.family in PL.REPLICATED_FAMILIES:
        assert not local
    else:
        assert "embed.embedding" in local
    assert PL.attention_split(cfg, 16) == (arch in ("qwen3-32b",
                                                    "grok-1-314b",
                                                    "h2o-danube3-4b"))
    if cfg.family == Family.MOE:
        assert all("moe/w_" in p or "attn" in p for p in listed)


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
