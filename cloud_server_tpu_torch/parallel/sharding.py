"""Logical-axis sharding rules.

Every parameter is annotated with *logical* axis names ("embed",
"heads", "mlp", ...) by `models.transformer.param_logical_axes`. A
`ShardingRules` table maps logical names to mesh axes (or None for
replicated): the one place the parallel layout is decided. The table
is the reference's megatron-style layout:
  * tensor parallelism (tp) shards heads / mlp / vocab,
  * fsdp shards the embed (weight-stationary) dimension of every matrix,
  * batch is data-parallel over (dp, fsdp), sequence over sp,
  * experts over ep, pipeline stages over pp.

Where the reference hands a NamedSharding to the compiler, the port
keeps each rank's contiguous slice of every leaf (`shard_params`): a
split dimension of size n over a mesh axis of size k gives rank i
elements [i * n / k, (i + 1) * n / k). The model code then runs on the
local slices and names its collectives (`parallel.collectives`).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from cloud_server_tpu_torch.parallel.mesh import axis_size

# logical axis name -> mesh axis (str), tuple of mesh axes, or None
ShardingRules = Mapping[str, Any]

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "sequence": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "stages": "pp",
    "experts": "ep",
    "expert_mlp": "tp",
    "norm": None,
}


def spec_from_logical(logical_axes: Sequence[str | None],
                      rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """Map a tuple of logical axis names to a partition spec: per
    dimension a mesh axis, a tuple of them, or None (the entries of the
    reference's PartitionSpec)."""
    return tuple(rules[a] if a is not None else None for a in logical_axes)


def constrain(x, logical_axes: Sequence[str | None],
              rules: ShardingRules = DEFAULT_RULES):
    """The reference's activation anchor. Each rank's activations are
    its own local tensors here, laid out by the model code, so there is
    nothing to anchor: returns `x`."""
    del logical_axes, rules
    return x


def _is_axes(x) -> bool:
    return isinstance(x, (tuple, list)) and all(
        isinstance(a, str) or a is None for a in x)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def logical_to_sharding(logical_tree: Any, mesh,
                        rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Map a tree of logical-axis tuples to, per leaf, the splits this
    mesh makes: a tuple of (dimension, mesh axis) pairs, outer axis
    first where one dimension splits over several, leaving out mesh axes
    of size 1. A leaf of () is replicated."""
    def leaf(axes):
        if not _is_axes(axes):
            raise TypeError(f"not a tuple of logical axis names: {axes!r}")
        splits = []
        for dim, entry in enumerate(spec_from_logical(axes, rules)):
            names = entry if isinstance(entry, tuple) else (entry,)
            splits += [(dim, a) for a in names
                       if a is not None and axis_size(mesh, a) > 1]
        return tuple(splits)

    if _is_axes(logical_tree):
        return leaf(logical_tree)
    return _tree_map(leaf, logical_tree)


def shard_tensor(x: torch.Tensor, splits, mesh) -> torch.Tensor:
    """This rank's contiguous slice of `x` under `splits` (one leaf of
    `logical_to_sharding`), as a tensor of its own (the full leaf's
    memory is not kept alive by it)."""
    for dim, axis in splits:
        k = axis_size(mesh, axis)
        n = x.shape[dim]
        if n % k:
            raise ValueError(
                f"dimension {dim} of size {n} does not split evenly over "
                f"mesh axis {axis!r} of size {k}")
        i = mesh.get_local_rank(axis)
        x = x.narrow(dim, i * (n // k), n // k)
    return x.clone() if splits else x


def shard_params(params, logical_tree, mesh,
                 rules: ShardingRules = DEFAULT_RULES):
    """This rank's slice of every leaf of `params` (a nested dict of
    tensors shaped like `logical_tree`); replicated leaves are returned
    as they are."""
    splits = logical_to_sharding(logical_tree, mesh, rules)
    return _tree_map(lambda x, s: shard_tensor(x, s, mesh), params, splits)
