"""Collective-communication layer.

The reference's collectives are XLA's, named by mesh axis inside
`shard_map`; here they are `torch.distributed` calls on a mesh
dimension's process group (`mesh.get_group("tp")`): NCCL on cards, where
they run on the current stream and a CUDA graph captures them, or gloo
on the CPU. Thin on purpose: the rest of the port names its collectives
in one place. A group of one rank (or None) makes each an identity.

The forms named `*_ad` are the training step's: differentiable, each
with the backward collective that makes every rank's gradient the
gradient of the one global loss. The plain forms (serving) are
forward-only.
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


# -- host staging for gloo on CUDA tensors ------------------------------------

def _host_staged(op, x: torch.Tensor, group, **kwargs) -> torch.Tensor:
    """`op(x, group, **kwargs)` on a host copy of `x` when the group is
    gloo and `x` lies on a card (the one-card form of a mesh: several
    ranks on one card, which NCCL does not take); gloo's CUDA support
    does not cover every collective. The copy is pinned (PyTorch's
    caching host allocator keeps the buffers), so both copies run at
    the link's rate. Elsewhere `op` on `x` itself."""
    if x.is_cuda and _size(group) > 1 and dist.get_backend(group) == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x.detach())
        return op(host, group, **kwargs).to(x.device)
    return op(x, group, **kwargs)


# -- autograd-aware forms (training) ------------------------------------------
#
# The training step differentiates through its collectives. Each form
# below is the forward collective with the backward that makes every
# rank's gradient the gradient of the one global loss:
#   psum_ad        sum over the group; backward the identity
#   identity_ad    the identity; backward a sum over the group
#   all_gather_ad  gather; backward a reduce_scatter (and the reverse)
#   all_to_all_ad  all_to_all; backward the inverse all_to_all
#   ppermute_ad    shift; backward the reverse shift
# A group of one rank (or None) makes each the identity.


class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _host_staged(lambda t, g: psum(t.clone(), g), x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentityAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _host_staged(lambda t, grp: psum(t.clone(), grp), g,
                            ctx.group), None


class _AllGatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _host_staged(all_gather, x, group, tiled_axis=axis)

    @staticmethod
    def backward(ctx, g):
        return _host_staged(reduce_scatter, g.contiguous(), ctx.group,
                            scatter_axis=ctx.axis), None, None


class _AllToAllAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _host_staged(all_to_all, x, group, split_axis=split_axis,
                            concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _host_staged(all_to_all, g.contiguous(), group,
                            split_axis=concat_axis,
                            concat_axis=split_axis), None, None, None


class _PpermuteAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _host_staged(ppermute_shift, x, group, shift=shift)

    @staticmethod
    def backward(ctx, g):
        return _host_staged(ppermute_shift, g.contiguous(), ctx.group,
                            shift=-ctx.shift), None, None


def psum_ad(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (a new tensor); the backward is the identity:
    the partial sums of a row-parallel product leaving a tp region."""
    return x if _size(group) == 1 else _PsumAD.apply(x, group)


def identity_ad(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums over the group: a replicated
    activation entering a tp region, whose ranks each send back the
    gradient of their own part."""
    return x if _size(group) == 1 else _IdentityAD.apply(x, group)


def all_gather_ad(x: torch.Tensor, group, *, tiled_axis: int = 0):
    """`all_gather` whose backward reduce-scatters (fsdp's parameter
    gather: every rank's gradient of the full leaf is summed into the
    owner's shard)."""
    if _size(group) == 1:
        return x
    return _AllGatherAD.apply(x, group, tiled_axis % x.dim())


def all_to_all_ad(x: torch.Tensor, group, *, split_axis: int,
                  concat_axis: int) -> torch.Tensor:
    """`all_to_all` whose backward is the inverse all_to_all (split the
    concatenated axis, concatenate the split one)."""
    if _size(group) == 1:
        return x
    return _AllToAllAD.apply(x, group, split_axis % x.dim(),
                             concat_axis % x.dim())


def ppermute_ad(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """`ppermute_shift` whose backward shifts the gradient back."""
    if _size(group) == 1 or shift % _size(group) == 0:
        return x
    return _PpermuteAD.apply(x, group, shift)


def ring_exchange_ad(chunks, group, *, shift: int = 1):
    """`ring_exchange` over `ppermute_ad`: a tuple of tensors one hop
    around the ring, differentiable."""
    return tuple(ppermute_ad(c, group, shift) for c in chunks)
