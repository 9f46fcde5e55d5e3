"""Collective-communication layer.

The reference's collectives are XLA's, named by mesh axis inside
`shard_map`; here they are `torch.distributed` calls on a mesh
dimension's process group (`mesh.get_group("tp")`): NCCL on cards, where
they run on the current stream and a CUDA graph captures them, or gloo
on the CPU. Thin on purpose: the rest of the port names its collectives
in one place. A group of one rank (or None) makes each an identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else group.size()


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, in place in `x`; returns `x`."""
    if _size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group's ranks (in place in `x`); returns `x`."""
    n = _size(group)
    return psum(x, group).div_(n) if n > 1 else x


def all_gather(x: torch.Tensor, group, *, tiled_axis: int = 0):
    """Gather the ranks' shards into one tensor, concatenated on
    `tiled_axis` in rank order."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    if tiled_axis % x.dim() == 0:
        return out
    return torch.cat(out.chunk(n, dim=0), dim=tiled_axis)


def reduce_scatter(x: torch.Tensor, group, *, scatter_axis: int = 0):
    """Sum over the ranks, each keeping its `1/n` block of
    `scatter_axis` (rank order)."""
    n = _size(group)
    if n == 1:
        return x
    x = x.movedim(scatter_axis, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, scatter_axis)


def ppermute_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the group (the ring step of ring attention):
    shift=+1 sends this rank's value to the next rank."""
    n = _size(group)
    if n == 1 or shift % n == 0:
        return x
    me = group.rank()
    peer = dist.get_global_rank
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, peer(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def all_to_all(x: torch.Tensor, group, *, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """MoE dispatch/combine: split `split_axis` into n blocks, send block
    j to rank j, and concatenate the received blocks on `concat_axis`
    in rank order."""
    n = _size(group)
    if n == 1:
        return x
    src = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = out.movedim(0, split_axis)
    if concat_axis == split_axis:
        return out
    blocks = out.chunk(n, dim=split_axis)
    return torch.cat(blocks, dim=concat_axis)


def pvary(x, axes):
    """The reference's varying-over-axes mark for its type checker: no
    such check here, so the identity."""
    del axes
    return x


def ring_exchange(chunks, group, *, shift: int = 1):
    """Rotate every tensor of a (nested dict / list / tuple) tree one hop
    around the ring: the k/v rotation of ring attention and the stage
    handoff of the pipeline."""
    if isinstance(chunks, dict):
        return {k: ring_exchange(v, group, shift=shift)
                for k, v in chunks.items()}
    if isinstance(chunks, (list, tuple)):
        return type(chunks)(ring_exchange(v, group, shift=shift)
                            for v in chunks)
    return ppermute_shift(chunks, group, shift)
