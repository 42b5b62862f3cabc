"""Sharding policy (``repro.launch.shardings``): the logical-axis ->
mesh-dim rule tables per (arch x shape), and the placements of every
param, optimizer, batch and cache leaf on a mesh.

Policy, as the reference's:
  * tensor parallelism over ``model`` for mlp / heads / experts / vocab,
  * FSDP over ``data`` (x ``pod`` multi-pod) on the ``embed`` dim for
    models that need it (over 2e9 parameters when training, over 40e9
    always: jamba),
  * batch over ``data`` (x ``pod``),
  * long-context decode (batch 1): the KV *sequence* over data x model,
  * every assignment divisibility-checked (``spec_for``), so odd vocabs
    and head counts degrade to replication.

Each ``*_shardings`` function returns a tree of placements (one
``Shard(d)`` or ``Replicate()`` a mesh dim, ``spec_to_placements`` of the
leaf's ``spec_for``); ``*_specs`` the specs themselves, the reference's
``PartitionSpec`` tuples.  The mesh is a ``DeviceMesh`` or a ``MeshShape``
(no process group needed).  ``distribute_tree`` lays a tree out on a
``DeviceMesh`` with them, ``gather_tree`` brings it back whole.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import abstract_params, param_axes
from repro_torch.models.params import (  # noqa: F401
    MeshShape, Replicate, distribute_tree, gather_tree, spec_for,
    spec_to_placements, tree_shardings)
from repro_torch.models.transformer import CACHE_AXES, STATE_H_AXES
from repro_torch.optim.optimizers import OptState

FSDP_TRAIN_THRESHOLD = 2e9
FSDP_ALWAYS_THRESHOLD = 40e9


def needs_fsdp(cfg: ModelConfig, shape_kind: str) -> bool:
    n = cfg.param_count()
    if n > FSDP_ALWAYS_THRESHOLD:
        return True
    return shape_kind == "train" and n > FSDP_TRAIN_THRESHOLD


def param_rules(cfg: ModelConfig, shape_kind: str, multi_pod: bool,
                strategy: str = "tp") -> Dict:
    fsdp = needs_fsdp(cfg, shape_kind)
    if fsdp:
        embed = (("pod", "data"), "data") if multi_pod else ("data",)
    else:
        embed = ()
    # seq_parallel: weights replicated (vocab excepted), activations over
    # (data = batch, model = seq)
    tensor = () if strategy == "seq_parallel" else ("model",)
    return {
        "embed": embed,
        "vocab": ("model",),
        "mlp": tensor,
        "heads": tensor,
        "kv_heads": tensor,
        "head_dim": tensor,
        "heads_flat": tensor,
        "expert": tensor,
        "expert_router": tensor,
        "layers": (),
    }


def act_rules(cfg: ModelConfig, shape_kind: str, multi_pod: bool,
              strategy: str = "tp") -> Dict:
    batch = ((("pod", "data"), "data") if multi_pod else ("data",))
    if shape_kind == "decode":
        # KV sequence sharding takes whatever the batch dim left free
        kvseq = (("data", "model"), "data", "model")
    else:
        kvseq = ("model",) if strategy == "seq_parallel" else ()
    if strategy == "seq_parallel":
        return {
            "batch": batch,
            "seq": ("model",),
            "embed": (),
            "heads": (),
            "kv_heads": (),
            "head_dim": (),
            "vocab": (),
            "kvseq": kvseq,
            "mlp": (),
            "layers": (),
            "moe_group": batch,
            "expert": (),
        }
    return {
        "batch": batch,
        "seq": (),
        "embed": (),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),
        "vocab": ("model",),
        "kvseq": kvseq,
        "mlp": ("model",),
        "layers": (),
        # MoE dispatch: token groups follow batch; experts model-parallel
        "moe_group": batch,
        "expert": ("model",),
    }


SEQPAR_MAX_PARAMS = 8e9


def resolve_strategy(cfg, shape_kind: str, strategy: str) -> str:
    """'auto': sequence-parallel prefill for attention-only models whose
    head counts don't divide the model dim (tensor parallelism there
    degenerates into per-block all-reduces) and that fit replicated;
    tensor parallelism otherwise.  Recurrent stacks (rwkv / mamba) are
    excluded: their time scans cannot shard over seq."""
    if strategy != "auto":
        return strategy
    attention_only = all(k in ("global", "local") for k in cfg.layer_kinds)
    if (shape_kind == "prefill" and attention_only
            and (cfg.num_heads % 16 or cfg.num_kv_heads % 16)
            and cfg.param_count() < SEQPAR_MAX_PARAMS):
        return "seq_parallel"
    return "tp"


# ---------------------------------------------------------------------------
# Param shardings
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, mesh, rules: Dict, abstract=None):
    """Each param leaf's spec (``spec_for`` over ``param_axes``)."""
    abstract = abstract if abstract is not None else abstract_params(cfg)
    return tree_map(lambda a, s: spec_for(tuple(s.shape), a, rules, mesh),
                    param_axes(cfg), abstract)


def param_shardings(cfg: ModelConfig, mesh, rules: Dict, abstract=None):
    abstract = abstract if abstract is not None else abstract_params(cfg)
    return tree_shardings(param_axes(cfg), abstract, rules, mesh)


# ---------------------------------------------------------------------------
# Cache shardings (leaf-name driven)
# ---------------------------------------------------------------------------

_CACHE_AXES = {**CACHE_AXES, "pos": ()}   # "h" by rank, below


def _cache_leaf_axes(path: Tuple[str, ...], leaf) -> Tuple:
    """A cache leaf's logical axes from its name (the last key of
    ``path``) and rank."""
    name = path[-1] if path else None
    shape = tuple(leaf.shape)
    rank = len(shape)
    if name == "h":
        # mamba h: (B, di, n) rank 3 / (L, B, di, n) rank 4 (square only if
        # di == n, impossible for the assigned configs); rwkv h:
        # (B, H, N, N) rank 4 square tail / (L, B, H, N, N) rank 5
        if rank == 3 or (rank == 4 and shape[-1] != shape[-2]):
            base = STATE_H_AXES["mamba"]
        else:
            base = STATE_H_AXES["rwkv"]
    else:
        base = _CACHE_AXES.get(name, ())
    extra = rank - len(base)                 # the leading stacked dim
    return ("layers",) * extra + tuple(base)


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    return fn(prefix, tree)


def cache_specs(cache_abstract, mesh, rules: Dict):
    return _map_with_path(
        lambda path, leaf: spec_for(tuple(leaf.shape),
                                    _cache_leaf_axes(path, leaf), rules,
                                    mesh), cache_abstract)


def cache_shardings(cache_abstract, mesh, rules: Dict):
    return tree_map(lambda s: spec_to_placements(s, mesh),
                    cache_specs(cache_abstract, mesh, rules))


# ---------------------------------------------------------------------------
# Batch shardings
# ---------------------------------------------------------------------------

_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "patches": ("batch", "seq", "embed"),
    "frames": ("batch", "seq", "embed"),
    "images": ("batch", None, None, None),
}


def batch_leaf_axes(name, rank: int, client_leading: bool = False):
    axes = tuple(_BATCH_AXES.get(name, ()))
    if client_leading:
        axes = (None,) + axes
    axes = axes[:rank]
    return axes + (None,) * (rank - len(axes))


def batch_specs(batch_abstract, mesh, rules: Dict,
                client_leading: bool = False):
    return _map_with_path(
        lambda path, leaf: spec_for(
            tuple(leaf.shape),
            batch_leaf_axes(path[-1] if path else None, len(leaf.shape),
                            client_leading), rules, mesh), batch_abstract)


def batch_shardings(batch_abstract, mesh, rules: Dict,
                    client_leading: bool = False):
    return tree_map(lambda s: spec_to_placements(s, mesh),
                    batch_specs(batch_abstract, mesh, rules, client_leading))


def opt_state_shardings(opt_abstract: OptState, p_shardings, mesh):
    """Moments shard like params; the step count replicates."""
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    mu = (tree_map(lambda s, a: s, p_shardings, opt_abstract.mu)
          if opt_abstract.mu is not None else None)
    nu = (tree_map(lambda s, a: s, p_shardings, opt_abstract.nu)
          if opt_abstract.nu is not None else None)
    return OptState(rep, mu, nu)
