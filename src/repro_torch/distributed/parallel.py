"""Tensor parallelism over the 'model' axis at the ``ops`` boundary: the
port's explicit counterpart of what GSPMD does to the JAX train step
(``repro/train/loop.py:49-74`` jits it with the rule table's
``in_shardings``, and XLA partitions the compute by them and by the
activation hints the dry run installs).

A ``ModelParallel`` is the 'model' axis as the layers see it: this rank's
index on it, its size, its process group, and the parameters that the
active train step handed to the layers as this rank's block (``local``:
the rule table splits them over 'model', their split dim divides, and
``computes_local`` says the layers compute on the block).  While one is
active (``using``):

* ``copy`` (identity forward, sum over 'model' backward) enters a
  column-parallel region: the activations are replicated, each rank's
  input gradient covers only its columns, and the sum makes it whole.
  A replicated weight that feeds only the rank's share of the work (the
  K/V projections a kv group shares, context-parallel attention's
  weights, the MoE router, the SSM's conv and gains) enters by ``copy``
  too: its gradient is the rank's partial sum.  MLA enters at its latent
  activations instead, so that its low-rank weights get whole gradients;
* ``reduce`` (sum over 'model' forward, identity backward) leaves a
  row-parallel one: each rank's product covers its rows of the
  contraction;
* ``gather_rows`` (all-gather along the sequence forward, the rank's
  rows backward) leaves a context-parallel one: each rank computed its
  block of query rows;
* ``gather_cols`` (all-gather along the last dim forward, the sum over
  'model' of the gradient and then the rank's columns backward: a
  reduce-scatter) puts a column-parallel product back together where
  the ranks go on to use *different* columns of it (the SSM's fused
  in-projection: each rank its heads' x, z and dt);
* ``sum_over`` (sum over 'model' both ways) joins a quantity that every
  rank's share feeds and reads (the SSM's gated RMSNorm over d_inner:
  its sum of squares);
* between them, the layers run ``ops.projection`` (``tile_gemm``), the
  attention kernels and the SSD scan on the rank's block:
  ``layers.mlp_forward`` (``w_gate``/``w_up`` by columns, ``w_down`` by
  rows), dense attention on the rank's query heads (``attention_split``)
  or, under the ``attn_q`` hint, on its query rows against the whole K/V
  (``context_split``), self-attention or with a separate K/V source
  (whisper's cross-attention), vilbert's co-attention and
  self-attention on the rank's heads (the stream kernel generating only
  their K/V from the other modality), MLA on its heads, the MoE on its
  experts (EP) or on each expert's d_ff block (expert-TP), the SSM on
  its heads (``ssm.ssm_forward``; where its out-projection's rows are no
  whole heads, the SSD stays whole and only the rank's rows of y feed
  the row-parallel out-projection).  No library matmul runs a sharded
  projection, and no DTensor reaches an aten product;
* ``vocab_embed`` looks tokens up in the rank's vocabulary rows, zeroes
  the rows outside them and sums over 'model'; ``vocab_nll`` is the
  cross-entropy of the rank's f32 logit columns, its max and its sum of
  exponentials reduced over 'model', so that no rank holds the whole
  (B, S, vocab) logits.

The collectives are the functional ones that DTensor's redistributions
call (``_c10d_functional``), inside autograd Functions whose backward is
the transpose for a loss that every rank of the axis computes alike.
(``torch.distributed.nn.functional.all_reduce`` differentiates the sum
of every rank's loss instead: its backward would be m times too large.)

The active context is process-wide, not a contextvar: autograd runs the
recomputation of a checkpointed layer on its own device thread, where a
contextvar set by the step is not visible.

A context without a group (``group=None``) stands for one rank of the
axis on its own: ``copy`` and ``reduce`` are the identity, and
``gather_rows`` puts the rank's rows in place among zeros, so that the
caller can sum the ranks' partial outputs and input gradients
(``rank_view``: the 16 'model' ranks of one layer run in turn on one
card).  ``gather_cols`` and ``sum_over`` need the other ranks' values:
an ``Exchange`` keeps each rank's contributions, forward and backward,
from the previous pass over the ranks, and the caller repeats the
passes until they hold (``Exchange.another_pass``).

``unit`` and ``run_unit`` are where the model code lets the active train
step gather a unit of parameters over the batch axes (FSDP) for its
forward: the step's ``gathered`` context, a no-op without a step.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Mapping, Optional, Sequence, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.types import AttnKind, Family, ModelConfig

_ACTIVE: Optional["ModelParallel"] = None


def active() -> Optional["ModelParallel"]:
    """The active 'model'-axis context, or None."""
    return _ACTIVE


@contextlib.contextmanager
def using(tp: Optional["ModelParallel"]):
    """Make ``tp`` the active context (process-wide) for the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tp
    try:
        yield tp
    finally:
        _ACTIVE = prev


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(t, op, group)
    return funcol.wait_tensor(out) if isinstance(
        out, funcol.AsyncCollectiveTensor) else out


class _Copy(torch.autograd.Function):
    """Identity forward, the sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), "sum", ctx.group), None


class _Reduce(torch.autograd.Function):
    """The sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """The ranks' blocks of rows (dim 1) gathered in rank order forward,
    the rank's rows of the gradient backward."""

    @staticmethod
    def forward(ctx, x, rank, group):
        import torch.distributed._functional_collectives as funcol
        ctx.rank, ctx.n = rank, x.shape[1]
        gather = (getattr(funcol, "all_gather_single", None)
                  or funcol.all_gather_tensor)
        out = gather(x.contiguous(), 1, group)
        return funcol.wait_tensor(out) if isinstance(
            out, funcol.AsyncCollectiveTensor) else out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.rank * ctx.n, ctx.n), None, None


class _GatherCols(torch.autograd.Function):
    """The ranks' blocks of columns (the last dim) gathered in rank order
    forward; backward the sum over the group of the gradient, of which
    the rank keeps its columns (a reduce-scatter): the ranks read
    different columns of the whole, so each rank's gradient of it is a
    partial one."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        gather = (getattr(funcol, "all_gather_single", None)
                  or funcol.all_gather_tensor)
        out = gather(x.movedim(-1, 0).contiguous(), 0, group)
        out = funcol.wait_tensor(out) if isinstance(
            out, funcol.AsyncCollectiveTensor) else out
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        scatter = (getattr(funcol, "reduce_scatter_single", None)
                   or funcol.reduce_scatter_tensor)
        out = scatter(g.movedim(-1, 0).contiguous(), "sum", 0, ctx.group)
        out = funcol.wait_tensor(out) if isinstance(
            out, funcol.AsyncCollectiveTensor) else out
        return out.movedim(0, -1), None


class _SumOver(torch.autograd.Function):
    """The sum over the group forward and backward: every rank's share
    feeds the sum, and every rank's share reads it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), "sum", ctx.group), None


class Exchange:
    """What the group would exchange, for ranks that run in turn on one
    device (``rank_view``): each rank's contribution to each call of
    ``gather_cols`` and ``sum_over`` (in call order), forward and
    backward, kept from the last pass over the ranks.  A rank reads the
    other ranks' contributions of the previous pass (zeros in the
    first), so that a chain of k such calls holds after 2k + 1 passes,
    all ranks run in each: ``while ex.another_pass(): <every rank>``;
    the last pass's results are the group's."""

    def __init__(self):
        self.fwd: dict = {}
        self.bwd: dict = {}
        self.passes = 0
        self.calls = 0

    def another_pass(self) -> bool:
        """Whether to run the ranks again: the first pass, and while
        fewer than 2k + 1 passes ran (k the calls a rank made)."""
        if self.passes and self.passes >= 2 * self.calls + 1:
            return False
        self.passes += 1
        return True

    def others(self, table: dict, call: int, rank: int) -> dict:
        """{rank: contribution} of the other ranks to call ``call``."""
        return {r: t for (c, r), t in table.items()
                if c == call and r != rank}

    def plus_others(self, table: dict, call: int, rank: int,
                    t: torch.Tensor) -> torch.Tensor:
        """Keep the rank's ``t`` for call ``call``; ``t`` plus the other
        ranks' of the previous pass."""
        table[(call, rank)] = t.detach().clone()
        for o in self.others(table, call, rank).values():
            t = t + o
        return t


class _ExchangedGatherCols(torch.autograd.Function):
    """``_GatherCols`` through an ``Exchange``: the other ranks' columns
    of the previous pass, and their gradients' sum."""

    @staticmethod
    def forward(ctx, x, tp, call):
        ex = tp.exchange
        ctx.tp, ctx.call, ctx.n = tp, call, x.shape[-1]
        ex.fwd[(call, tp.rank)] = x.detach().clone()
        got = ex.others(ex.fwd, call, tp.rank)
        got[tp.rank] = x
        return torch.cat([got.get(r, torch.zeros_like(x))
                          for r in range(tp.size)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        total = tp.exchange.plus_others(tp.exchange.bwd, ctx.call, tp.rank, g)
        return total.narrow(-1, tp.rank * ctx.n, ctx.n), None, None


class _ExchangedSum(torch.autograd.Function):
    """``_SumOver`` through an ``Exchange``: the rank's value (gradient)
    plus the other ranks' of the previous pass."""

    @staticmethod
    def forward(ctx, x, tp, call):
        ctx.tp, ctx.call = tp, call
        return tp.exchange.plus_others(tp.exchange.fwd, call, tp.rank, x)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return tp.exchange.plus_others(tp.exchange.bwd, ctx.call, tp.rank,
                                       g), None, None


class ModelParallel:
    """The 'model' axis of the active step (module docstring): ``rank``
    and ``size`` on it, its ``group`` (None: one rank on its own), and
    ``local``, the (module, parameter name) pairs the layers take as the
    rank's block; ``gatherer`` the step whose units ``unit`` gathers;
    ``exchange`` (without a group) the other ranks' values for
    ``gather_cols`` and ``sum_over``, which raise without either."""

    def __init__(self, rank: int, size: int, group=None,
                 local: Iterable[Tuple[nn.Module, str]] = (),
                 gatherer=None, exchange: Optional[Exchange] = None):
        self.rank, self.size, self.group = rank, size, group
        self._local: Set[Tuple[int, str]] = {(id(m), n) for m, n in local}
        self.gatherer = gatherer
        self.exchange = exchange
        self._calls = 0

    def local(self, module: nn.Module, name: str) -> bool:
        """Whether ``module.<name>`` is this rank's 'model' block."""
        return (id(module), name) in self._local

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or self.size == 1:
            return x
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or self.size == 1:
            return x
        return _Reduce.apply(x, self.group)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (B, m·n, ...) from each rank's rows (B, n, ...): an
        all-gather on dim 1; without a group, the rank's rows in place
        among zeros (the caller sums the ranks)."""
        if self.size == 1:
            return x
        if self.group is None:
            n = x.shape[1]
            pad = [0, 0] * (x.dim() - 2)
            return F.pad(x, pad + [self.rank * n,
                                   (self.size - 1 - self.rank) * n])
        return _GatherRows.apply(x, self.rank, self.group)

    def _exchanged(self, fn, x: torch.Tensor) -> torch.Tensor:
        if self.exchange is None:
            raise RuntimeError("a 'model' rank without a group needs an "
                               "Exchange for the other ranks' values")
        call = self._calls
        self._calls += 1
        self.exchange.calls = max(self.exchange.calls, self._calls)
        return fn.apply(x, self, call)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (..., m·n) from each rank's columns (..., n): an
        all-gather on the last dim, whose backward reduce-scatters
        (``_GatherCols``); without a group, through the ``exchange``
        (zeros for a rank not yet heard from)."""
        if self.size == 1:
            return x
        if self.group is not None:
            return _GatherCols.apply(x, self.group)
        return self._exchanged(_ExchangedGatherCols, x)

    def sum_over(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over 'model', forward and backward (``_SumOver``);
        without a group, through the ``exchange`` (the ranks it has
        heard from)."""
        if self.size == 1:
            return x
        if self.group is not None:
            return _SumOver.apply(x, self.group)
        return self._exchanged(_ExchangedSum, x)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """A plain (not differentiated) all-reduce over the group."""
        if self.group is None or self.size == 1:
            return t
        return _all_reduce(t.contiguous(), op, self.group)


# ---------------------------------------------------------------------------
# What the layers compute on their block
# ---------------------------------------------------------------------------

def attention_split(cfg: ModelConfig, m: int) -> bool:
    """Whether dense attention (``layers.attention_forward``) runs on the
    rank's query heads at 'model' size ``m``: the heads divide (the rule
    table's ``heads_shardable``), and each rank's query heads read a
    whole kv head group (the kv heads divide too, or a group's query
    heads fall on a whole number of ranks).  vilbert's attention is its
    own (``vilbert._attn``: the rank's heads wherever its weights are
    the rank's blocks)."""
    if (m <= 1 or not cfg.num_heads or cfg.num_heads % m
            or cfg.attn_kind in (AttnKind.MLA, AttnKind.NONE)
            or cfg.family == Family.CROSSMODAL):
        return False
    if cfg.num_kv_heads % m == 0:
        return True
    return (cfg.num_heads // cfg.num_kv_heads) % (cfg.num_heads // m) == 0


def context_split(cfg: ModelConfig, m: int, hints) -> bool:
    """Whether dense attention runs context-parallel at 'model' size
    ``m`` under the hint table ``hints`` (``runtime.flags(sharding_hints
    =...)``, as ``hints.hint_shardings`` builds it): the table names
    ``attn_q`` (the query sequence over 'model', hints.py), and the heads
    do not split (``attention_split``).  Each rank then takes its block
    of query rows against the whole K/V (``layers.attention_forward``,
    self-attention or whisper's cross-attention), an uneven block where
    ``m`` does not divide the sequence (whisper's 1500 encoder frames
    over 16), as GSPMD splits a constrained dim unevenly.  vilbert's
    attention reaches no ``attn_q``
    constraint in JAX (vilbert.py:103-121), so it splits by heads only."""
    return (m > 1 and bool(hints) and "attn_q" in hints
            and bool(cfg.num_heads)
            and cfg.attn_kind not in (AttnKind.MLA, AttnKind.NONE)
            and cfg.family != Family.CROSSMODAL
            and not attention_split(cfg, m))


def _model_dim(path: str, shape: Sequence[int], cfg: ModelConfig,
               sizes: Mapping[str, int]) -> Optional[int]:
    """The dim of the parameter at JAX path ``path`` that the rule table
    splits over 'model', or None."""
    from repro_torch.distributed import sharding as SH
    spec = SH.spec_for_param(path, tuple(shape), cfg,
                             SH._SimulatedMesh(sizes), False)
    return next((d for d, e in enumerate(spec) if "model" in SH._axes(e)),
                None)


def _takes_block(path: str, shape: Sequence[int], cfg: ModelConfig,
                 m: int) -> bool:
    """Whether the layers compute on a 'model' block of the parameter at
    ``path``, given that the rules split it: the vocabulary (embedding,
    unembed), a dense MLP's (a shared expert's too), the MoE's experts
    (their expert dim where ``experts_shardable`` holds, else each
    expert's d_ff), MLA's per-head projections, dense attention's under
    ``attention_split``, vilbert's attention (each stream's heads), and
    the SSM's out-projection rows and, where those divide, its fused
    in-projection's columns."""
    leaf, nd = path.split("/")[-1], len(shape)
    if leaf in ("embedding", "unembed", "out_proj"):
        return True
    if leaf == "in_proj":
        return (cfg.ssm_expand * cfg.d_model) % m == 0
    if leaf in ("w_gate", "w_up", "w_down"):
        return nd in (2, 3)
    if cfg.attn_kind == AttnKind.MLA and nd == 3:
        return leaf in ("wq_b", "wk_b", "wv_b", "wo")
    if leaf in ("wq", "wk", "wv", "wo") and nd == 3:
        return (cfg.family == Family.CROSSMODAL
                or attention_split(cfg, m))
    return False


def computes_local(path: str, shape: Sequence[int], cfg: ModelConfig,
                   sizes: Mapping[str, int]) -> bool:
    """Whether the layers compute on this rank's 'model' block of the
    parameter at JAX path ``path``: the rule table splits it over 'model'
    along a dim that the 'model' size divides, and ``_takes_block``
    holds.  The rest that the rules split is gathered whole over 'model'
    and computed replicated (``replicated_over_model`` lists it)."""
    m = sizes.get("model", 1)
    if m <= 1:
        return False
    d = _model_dim(path, shape, cfg, sizes)
    return (d is not None and shape[d] % m == 0
            and _takes_block(path, shape, cfg, m))


def local_names(shapes: Mapping[str, Sequence[int]], cfg: ModelConfig,
                sizes: Mapping[str, int]) -> Set[str]:
    """The parameter names (the port's, ``layers.3.mlp.w_up``) whose
    'model' block the layers compute on."""
    from repro_torch.distributed.sharding import jax_path
    return {k for k, s in shapes.items()
            if computes_local(jax_path(k)[0], s, cfg, sizes)}


def replicated_over_model(shapes: Mapping[str, Sequence[int]],
                          cfg: ModelConfig, sizes: Mapping[str, int]
                          ) -> list:
    """The JAX paths whose rule splits them over 'model' but whose
    compute the step repeats on every 'model' rank (gathered whole over
    'model'), one entry per path: at the production mesh none; at a
    'model' size that a split dim does not divide, that parameter (the
    language stream's 12 heads of vilbert-base at 8, which the rule
    reads from the vision stream's 8)."""
    from repro_torch.distributed.sharding import jax_path
    m = sizes.get("model", 1)
    if m <= 1:
        return []
    out = set()
    for k, s in shapes.items():
        path = jax_path(k)[0]
        if (_model_dim(path, s, cfg, sizes) is not None
                and not computes_local(path, s, cfg, sizes)):
            out.add(path)
    return sorted(out)


def model_block(t: torch.Tensor, path: str, cfg: ModelConfig, rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` over a 'model' axis of ``size``, by
    the rule table (a view; ``t`` itself where the rule replicates it).
    Raises on a split dim that ``size`` does not divide."""
    d = _model_dim(path, t.shape, cfg, {"model": size})
    if d is None:
        return t
    if t.shape[d] % size:
        raise ValueError(f"{path}: dim {d} of {tuple(t.shape)} does not "
                         f"split evenly over 'model' {size}")
    n = t.shape[d] // size
    return t.narrow(d, rank * n, n)


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

def head_block(tp: ModelParallel, p: nn.Module, cfg: ModelConfig):
    """(wk, wv, q_gamma, k_gamma) for the rank's query heads of the dense
    attention ``p`` (``p.wq`` holds them, (D, Hq/m, hd)): the K/V
    projections of the kv heads they read (the rank's block where the kv
    heads divide, else the replicated weights sliced to the rank's group,
    whose gradients are then partial sums over 'model'), and the qk-norm
    gains, whose gradients are too."""
    if tp.local(p, "wk"):
        wk, wv = p.wk, p.wv
    else:
        hl, g = p.wq.shape[1], cfg.num_heads // cfg.num_kv_heads
        k0, k1 = tp.rank * hl // g, ((tp.rank + 1) * hl - 1) // g + 1
        wk, wv = tp.copy(p.wk)[:, k0:k1], tp.copy(p.wv)[:, k0:k1]
    gains = [tp.copy(getattr(p, n)) if hasattr(p, n) else None
             for n in ("q_gamma", "k_gamma")]
    return wk, wv, gains[0], gains[1]


def vocab_embed(tp: ModelParallel, emb: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens`` from the rank's vocabulary rows ``emb``
    (V/m, D): rows outside the slice zeroed, then summed over 'model'
    (one non-zero term a row: the sum is exact)."""
    n = emb.shape[0]
    local = tokens - tp.rank * n
    inside = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), emb) * inside[..., None].to(
        emb.dtype)
    return tp.reduce(x)


class _VocabNLL(torch.autograd.Function):
    """The negative log-likelihood of ``labels`` under f32 logits of which
    this rank holds the vocabulary columns [rank·n, (rank+1)·n)."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        n = logits.shape[-1]
        mx = tp.all_reduce(logits.max(dim=-1).values, "max")
        e = torch.exp(logits - mx[..., None])
        local = labels - tp.rank * n
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        tgt = torch.gather(logits, -1, idx)[..., 0] * inside
        sums = tp.all_reduce(torch.stack([e.sum(dim=-1), tgt]), "sum")
        nll = torch.log(sums[0]) - (sums[1] - mx)
        e /= sums[0][..., None]
        ctx.save_for_backward(e, idx, inside)
        return nll

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, idx, -(g * inside)[..., None])
        return d, None, None


def vocab_nll(tp: ModelParallel, logits: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-position NLL (labels' shape) from the rank's f32 logit columns
    (module docstring); a label of -1 gets log(sum exp) - max, which the
    caller masks, as the single-device loss masks its label-0 term."""
    return _VocabNLL.apply(logits, labels, tp)


# ---------------------------------------------------------------------------
# Units of the active step, and one rank on its own
# ---------------------------------------------------------------------------

def unit(root: nn.Module, names: Optional[Sequence[str]] = None):
    """A context in which the active step's gathered tensors of ``root``'s
    parameters ``names`` (all of them: None) stand in its modules; a
    no-op without a step."""
    tp = _ACTIVE
    if tp is None or tp.gatherer is None:
        return contextlib.nullcontext()
    return tp.gatherer.gathered(root, names)


def run_unit(module: nn.Module, fn, *args, **kwargs):
    """fn(module, *args, **kwargs) inside ``unit(module)``: what a layer
    loop checkpoints, so that the recomputation gathers the unit again."""
    with unit(module):
        return fn(module, *args, **kwargs)


@contextlib.contextmanager
def swapped(module: nn.Module, tensors: Mapping[str, torch.Tensor]):
    """``module``'s parameters ``tensors`` (names relative to it) replaced
    by these tensors for the block, then put back."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield
    finally:
        for sub, leaf, p in reversed(saved):
            sub._parameters[leaf] = p


@contextlib.contextmanager
def rank_view(module: nn.Module, path_prefix: Optional[str],
              cfg: ModelConfig, rank: int, size: int,
              exchange: Optional[Exchange] = None):
    """One 'model' rank of ``size`` on its own (module docstring): in the
    block, ``module``'s parameters (a ``Block`` or one of its sublayers;
    ``path_prefix`` their JAX path's head, "layers" or "layers/attn";
    None: ``module`` is a whole model, each path ``sharding.jax_path``
    of its name) that ``computes_local`` splits are the rank's blocks,
    fresh leaves that require grad; the others stay.  Yields {name: the
    tensor the rank computes on}, the blocks and the replicated
    parameters, whose gradients after a backward are the rank's blocks
    and partial sums.  ``exchange`` carries ``gather_cols`` and
    ``sum_over`` between the ranks' turns."""
    from repro_torch.distributed.sharding import jax_path
    sizes = {"model": size}
    blocks, local = {}, []
    for name, p in module.named_parameters():
        path = (jax_path(name)[0] if path_prefix is None
                else f"{path_prefix}/{name.replace('.', '/')}")
        if computes_local(path, p.shape, cfg, sizes):
            blocks[name] = model_block(p.detach(), path, cfg, rank,
                                       size).clone().requires_grad_(True)
            owner, _, leaf = name.rpartition(".")
            local.append((module.get_submodule(owner) if owner else module,
                          leaf))
    tp = ModelParallel(rank, size, None, local, exchange=exchange)
    with swapped(module, blocks), using(tp):
        yield {**dict(module.named_parameters()), **blocks}
