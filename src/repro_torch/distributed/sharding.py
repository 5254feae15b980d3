"""Logical-axis sharding rules (counterpart of
``repro/distributed/sharding.py``), adapted per architecture.

Production mesh axes: ``("data", "model")`` single-pod, ``("pod", "data",
"model")`` multi-pod (``launch.mesh``).  Batch shards over (pod, data);
parameters shard over 'model' by these rules:

* embedding / unembed       -> vocab over 'model'
* MLP w_up/w_gate           -> d_ff over 'model' (col-parallel); w_down
                               row-parallel ('model' on its d_ff dim)
* attention q/k/v/o         -> heads over 'model' if num_heads % axis == 0,
                               else replicated (context-parallel archs:
                               starcoder2 36H, minitron 24H, qwen2-vl 12H,
                               hymba 25H, whisper 8H)
* MoE experts               -> the expert dim over 'model' if E % axis == 0
                               (deepseek's 256), else each expert's d_ff
                               over 'model' (grok's 8)
* MLA latent projections    -> low-rank dims replicated, per-head dims over
                               'model'
* FSDP: at fsdp_threshold parameters or more, the largest replicated dim
  that |data| divides also shards over 'data' (ZeRO-3).

Optimizer state takes its parameter's sharding.

A spec is the JAX ``PartitionSpec`` written as a tuple: one entry per
dimension, None, an axis name or a tuple of axis names.  The port names
its parameters after the JAX tree's keys (``convert.py``), but its layer
stacks are ``ModuleList``s: where JAX's rule sees a stacked (L, ...) leaf
and replicates the stack dimension (sharding.py:196-202), the port's sees
one layer's parameter, so its spec is JAX's with the first entry dropped.
``Sharding.placements`` are the matching DTensor placements on a
``DeviceMesh`` (None without a mesh).  The rules read nothing of a mesh
but its axis sizes, so ``axis_sizes`` (or a ``_SimulatedMesh``) evaluates
them at production sizes on any mesh, or on none.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

from repro_torch.core.types import AttnKind, Family, ModelConfig

Spec = Tuple[Any, ...]

#: Top-level keys of the JAX trees whose leaves are stacked over layers.
STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers", "text_pre",
           "co_x", "co_y")


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def heads_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_heads % m == 0 if cfg.num_heads else False


def kv_heads_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_kv_heads % m == 0 if cfg.num_kv_heads else False


def experts_shardable(cfg: ModelConfig, mesh) -> bool:
    m = _axis_size(mesh, "model")
    return cfg.num_experts % m == 0 if cfg.num_experts else False


class _SimulatedMesh:
    """Stand-in with production axis sizes for rule evaluation on a small
    (e.g. single-device test) mesh — only ``.shape`` is consulted by the
    rule table."""

    def __init__(self, axis_sizes):
        self.shape = dict(axis_sizes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (whose ``.shape`` is a tuple)
    or of anything whose ``.shape`` maps names to sizes."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _rule_mesh(mesh, sizes: Optional[Mapping[str, int]]) -> _SimulatedMesh:
    return _SimulatedMesh(sizes if sizes is not None else axis_sizes(mesh))


class Sharding(NamedTuple):
    spec: Spec
    placements: Optional[tuple]      # DTensor placements, one a mesh dim


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements_for(spec: Spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: Shard(d) on every
    mesh dimension named by entry d, Replicate() on the others.  Two mesh
    dimensions on one tensor dimension shard it in mesh order, as a JAX
    spec entry ("pod", "data") does."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(spec) for a in _axes(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def spec_divides(spec: Spec, shape: Tuple[int, ...], mesh) -> bool:
    """Whether every sharded dimension of ``shape`` divides by the product
    of its axes' sizes on ``mesh``."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        f = 1
        for a in _axes(entry):
            f *= sizes.get(a, 1)
        if d >= len(shape) or shape[d] % f:
            return False
    return True


def _sharding(spec: Spec, mesh) -> Sharding:
    return Sharding(tuple(spec), None if mesh is None or isinstance(
        mesh, _SimulatedMesh) else placements_for(spec, mesh))


def _fsdp_wrap(spec: Spec, shape: Tuple[int, ...], mesh, use_fsdp: bool
               ) -> Spec:
    """Add 'data' sharding on the largest unsharded, divisible dim."""
    if not use_fsdp:
        return spec
    d = _axis_size(mesh, "data")
    best, best_size = None, 0
    for i, (s, ax) in enumerate(zip(shape, spec)):
        if ax is None and s % d == 0 and s > best_size:
            best, best_size = i, s
    if best is None:
        return spec
    out = list(spec)
    out[best] = "data"
    return tuple(out)


def spec_for_param(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   mesh, use_fsdp: bool) -> Spec:
    """Rule table keyed on the JAX tree path (slash-joined keys) of one
    parameter (of one layer of a stack); ``mesh`` is read for its axis
    sizes only."""
    m_ok = _axis_size(mesh, "model") > 1
    heads_ok = heads_shardable(cfg, mesh)
    kv_ok = kv_heads_shardable(cfg, mesh)
    ep_ok = experts_shardable(cfg, mesh)
    nd = len(shape)

    def fs(spec):
        spec = tuple(spec) + (None,) * (nd - len(spec))
        return _fsdp_wrap(spec, shape, mesh, use_fsdp)

    leaf = path.split("/")[-1]

    if not m_ok:
        return fs((None,) * nd)

    # --- embeddings ---
    if leaf == "embedding":
        return fs(("model", None))
    if leaf == "unembed":
        return fs((None, "model"))
    if leaf in ("text_pos", "dec_pos"):
        return fs((None, None))

    # --- MoE expert weights (E, D, F) / (E, F, D); router (D, E) ---
    if "moe" in path or (cfg.family == Family.MOE and leaf in
                         ("w_gate", "w_up", "w_down") and nd == 3):
        if nd == 3:
            if ep_ok:
                return fs(("model", None, None))
            # expert-TP (E does not divide |model|, grok's 8): each
            # expert's hidden dim over 'model'; FSDP adds 'data'
            if leaf == "w_down":
                return fs((None, "model", None))
            return fs((None, None, "model"))
        if leaf == "router":
            return fs((None, None))

    # --- MLA ---
    if cfg.attn_kind == AttnKind.MLA and nd >= 2:
        if leaf in ("wq_b", "wk_b", "wv_b") and nd == 3:
            return fs((None, "model", None))       # per-head dim
        if leaf == "wo" and nd == 3:
            return fs(("model", None, None))
        if leaf in ("wq_a", "wkv_a"):
            return fs((None, None))

    # --- dense attention (D, H, hd) / (H, hd, D) ---
    if leaf == "wq" and nd == 3:
        return fs((None, "model", None)) if heads_ok else fs((None,) * 3)
    if leaf in ("wk", "wv") and nd == 3:
        return fs((None, "model", None)) if kv_ok else fs((None,) * 3)
    if leaf == "wo" and nd == 3:
        return fs(("model", None, None)) if heads_ok else fs((None,) * 3)

    # --- MLP (D, F) col / (F, D) row ---
    if leaf in ("w_gate", "w_up") and nd == 2:
        return fs((None, "model"))
    if leaf == "w_down" and nd == 2:
        return fs(("model", None))

    # --- SSM ---
    if leaf == "in_proj":     # (D, 2*d_inner + 2N + H): the fused out dim
        return fs((None, "model")) if shape[1] % _axis_size(mesh, "model") \
            == 0 else fs((None, None))
    if leaf == "out_proj":
        return fs(("model", None)) if shape[0] % _axis_size(mesh, "model") \
            == 0 else fs((None, None))

    # norms / scalars / small tables: replicated
    return fs((None,) * nd)


def jax_path(name: str) -> Tuple[str, bool]:
    """The JAX tree path of the port's parameter ``name`` (dot-joined, a
    stack's layer index after its key), and whether it is one layer of a
    stack: ``layers.3.attn.wq`` -> ("layers/attn/wq", True)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, (tuple, list)) and all(isinstance(d, int)
                                               for d in leaf):
        return tuple(leaf)
    return tuple(getattr(leaf, "shape", ()))


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {k: _shape(v) for k, v in params.items()}


def param_shardings(params, cfg: ModelConfig, mesh=None, *,
                    fsdp_threshold: float = 8e9,
                    axis_sizes: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, Sharding]:
    """{parameter name: Sharding} for a module or a {name: tensor, shape
    or TensorSpec} mapping.  ``axis_sizes`` (name -> size) overrides the
    sizes the *rules* see, so that production divisibility can be checked
    while placements are built on a small mesh (or on ``mesh=None``)."""
    rule_mesh = _rule_mesh(mesh, axis_sizes)
    use_fsdp = (cfg.param_count() >= fsdp_threshold
                and _axis_size(rule_mesh, "data") > 1)
    out = {}
    for name, shape in _named_shapes(params).items():
        path, _ = jax_path(name)
        out[name] = _sharding(spec_for_param(path, shape, cfg, rule_mesh,
                                             use_fsdp), mesh)
    return out


def batch_axes(mesh) -> Tuple[str, ...]:
    """The batch's mesh axes: those of ("pod", "data") the mesh has."""
    names = (mesh.mesh_dim_names if mesh is not None and hasattr(
        mesh, "mesh_dim_names") else tuple(axis_sizes(mesh)))
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh) -> Spec:
    axes = batch_axes(mesh)
    return (axes,) if axes else ()


def batch_shardings(batch: Mapping[str, Any], mesh, *,
                    seq_sharded: bool = False) -> Dict[str, Sharding]:
    """Token batches shard dim 0 (batch) over (pod, data); ``seq_sharded``
    shards dim 1 (sequence) instead, for batch-1 long-context cells; VLM
    positions (3, B, S) shard dim 1.  ``batch`` maps names to tensors or
    shapes (``registry.input_specs``)."""
    baxes = batch_axes(mesh)

    def spec(shape):
        nd = len(shape)
        if nd == 0:
            return ()
        if shape[0] == 3 and nd == 3:               # vlm positions
            return (None, baxes, None)
        if seq_sharded and nd >= 2:
            return (None, baxes) + (None,) * (nd - 2)
        return (baxes,) + (None,) * (nd - 1)

    return {k: _sharding(spec(_shape(v)), mesh) for k, v in batch.items()}


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def cache_shardings(cache, cfg: ModelConfig, mesh, *,
                    seq_sharded: bool = False,
                    axis_sizes: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, Any]:
    """The decode cache's tree of Shardings: batch over (pod, data); K/V
    heads over 'model' when divisible, otherwise the cache *sequence* over
    'model' (context-parallel decode); the layer-stack dim replicated; SSM
    states' heads over 'model' when divisible.  The port's cache is the
    JAX tree (stacked over layers, ``models/transformer.py``), so these
    specs are JAX's, entry for entry.  ``cache`` leaves are tensors,
    shapes or TensorSpecs; ``len`` (an int) is replicated."""
    sizes = _rule_mesh(mesh, axis_sizes)
    baxes = batch_axes(mesh if mesh is not None else sizes)
    dp = 1
    for a in baxes:
        dp *= _axis_size(sizes, a)
    m = _axis_size(sizes, "model")
    kv_ok = kv_heads_shardable(cfg, sizes)
    out = {}
    for path, leaf in _flatten(cache):
        shape = _shape(leaf)
        nd = len(shape)
        leafname = path.split("/")[-1]
        if leafname == "len" or nd == 0:
            out[path] = _sharding((), mesh)
            continue
        core = shape[1:]                    # the layer-stack dim stripped
        batch = () if seq_sharded else baxes   # batch=1 cells replicate B
        if leafname in ("k", "v"):
            # (L, B, Hkv, S, hd); SP: cache sequence over the batch axes
            sq = baxes if (seq_sharded and core[2] % dp == 0) else None
            if kv_ok:
                spec = (None, batch, "model", sq, None)
            elif core[2] % m == 0 and not seq_sharded:
                spec = (None, batch, None, "model", None)
            elif seq_sharded and core[2] % (dp * m) == 0:
                spec = (None, batch, None, baxes + ("model",), None)
            else:
                spec = (None, batch, None, sq, None)
        elif leafname in ("c", "k_rope"):      # MLA latent (L, B, S, r)
            sq = baxes if (seq_sharded and core[1] % dp == 0) else (
                "model" if core[1] % m == 0 and not seq_sharded else None)
            spec = (None, batch, sq, None)
        elif leafname == "state":     # SSD (L, B, H, P, N)
            spec = (None, batch, "model" if core[1] % m == 0 else None,
                    None, None)
        elif leafname == "conv":      # (L, B, K-1, C)
            spec = (None, batch, None,
                    "model" if core[2] % m == 0 else None)
        elif leafname == "enc":       # (B, S_enc, D): not layer-stacked
            spec = (batch, None, None)
        else:
            spec = (None,) * nd
        out[path] = _sharding(spec, mesh)
    return _unflatten(out)


def local_index(shape: Tuple[int, ...], mesh, placements
                ) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` placed by ``placements``
    on ``mesh``: even blocks (the rules shard only dims their axes
    divide), several mesh dims on one tensor dim splitting it in mesh
    order, as ``placements_for`` lays them out."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    index = [slice(0, s, 1) for s in shape]
    for mdim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim, mesh.size(mdim)
            cur = index[d]
            block = (cur.stop - cur.start) // n
            start = cur.start + coord[mdim] * block
            index[d] = slice(start, start + block, 1)
    return tuple(index)
