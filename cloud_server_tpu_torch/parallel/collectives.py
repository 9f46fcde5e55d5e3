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

def _psum_copy(x: torch.Tensor, group) -> torch.Tensor:
    """`psum` into a new tensor (`x` unchanged)."""
    return psum(x.clone(), group)


def _host_staged(op, x: torch.Tensor, group, **kwargs) -> torch.Tensor:
    """`op(x, group, **kwargs)` (one of the collectives above; `psum` as
    `_psum_copy`) for a gloo group and `x` on a card: the one-card form
    of a mesh, several ranks on one card, which NCCL does not take.
    When every rank of the group holds the same card, through the
    ranks' mailboxes on it (`_CardMailbox`); else on a host copy of
    `x` (gloo's CUDA support does not cover every collective), pinned
    (PyTorch's caching host allocator keeps the buffers), so both copies
    run at the link's rate. Elsewhere `op` on `x` itself."""
    if x.is_cuda and _size(group) > 1 and dist.get_backend(group) == "gloo":
        box = _CardMailbox.of(group, x.device)
        if box is not None:
            return box.run(op, x.detach(), **kwargs)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x.detach())
        return op(host, group, **kwargs).to(x.device)
    return op(x, group, **kwargs)


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """`psum` in place in `x`, for a gloo group and `x` on a card as
    `_host_staged` runs it, the sum written straight back into `x`: no
    second device buffer of `x`'s size. Returns `x`."""
    if x.is_cuda and _size(group) > 1 and dist.get_backend(group) == "gloo":
        box = _CardMailbox.of(group, x.device)
        if box is not None and x.is_contiguous():
            box.allreduce_(x.view(-1))
            return x
        if box is not None:
            return x.copy_(box.run(psum, x))
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return x.copy_(psum(host, group))
    return psum(x, group)


# -- ranks sharing a card -----------------------------------------------------

class _CardMailbox:
    """The collectives of a gloo group whose ranks all hold one card,
    moved in that card's memory instead of through the host.

    Each process keeps one mailbox, a device buffer of MAILBOX_BYTES,
    which the group's ranks map into each other (CUDA IPC handles,
    exchanged once per group over gloo). A collective runs in pieces:
    each rank writes its piece (for n destinations, into n regions of
    its mailbox), waits for its stream, meets the others at a gloo
    barrier, reads the pieces meant for it from every rank's mailbox
    (summing in rank order, so every rank computes the same bits),
    waits for its stream again and meets them at a second barrier
    before anyone writes the next piece. Collectives of one rank run
    one after another, so groups share the process's mailbox.

    `_CardMailbox(group, buffers, device)` builds one over given
    buffers (one a rank, shared memory on the CPU in the tests)."""

    MAILBOX_BYTES = 64 << 20
    _ALIGN = 256
    _own: dict = {}      # device -> this process's mailbox buffer
    _groups: dict = {}   # (global ranks, device) -> _CardMailbox or None

    def __init__(self, group, buffers: list, device):
        self.group = group
        self.n = group.size()
        self.me = group.rank()
        self.buffers = buffers
        self.device = torch.device(device)
        self.nbytes = min(b.numel() for b in buffers)

    @classmethod
    def of(cls, group, device):
        """The group's mailbox when every rank holds `device`'s card on
        this host, else None (decided once per group: every rank of the
        group must call this at the same collective)."""
        import pickle
        import socket
        from multiprocessing.reduction import ForkingPickler

        import torch.multiprocessing  # noqa: F401 — registers CUDA IPC

        key = (tuple(dist.get_process_group_ranks(group)), str(device))
        if key not in cls._groups:
            mine = cls._own.get(str(device))
            if mine is None:
                mine = cls._allocate(device)
                cls._own[str(device)] = mine
            where = (socket.gethostname(), torch.device(device).index)
            got = [None] * group.size()
            dist.all_gather_object(
                got, (where, bytes(ForkingPickler.dumps(mine))), group=group)
            box = None
            if all(w == where for w, _ in got):
                me = group.rank()
                box = cls(group, [mine if r == me else pickle.loads(h)
                                  for r, (_, h) in enumerate(got)], device)
            cls._groups[key] = box
        box = cls._groups[key]
        if box is not None:
            box.group = group  # a later group over the same ranks
        return box

    @classmethod
    def _allocate(cls, device) -> torch.Tensor:
        """The process's mailbox, in a segment of its own: CUDA IPC of a
        block in an expandable segment needs the pidfd_open syscall,
        which not every kernel has, so the allocator's expandable
        segments are off for this one allocation."""
        import os
        expandable = "expandable_segments:True" in os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF", "")
        if expandable:
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:False")
        try:
            return torch.empty(cls.MAILBOX_BYTES, dtype=torch.uint8,
                               device=device)
        finally:
            if expandable:
                torch.cuda.memory._set_allocator_settings(
                    "expandable_segments:True")

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def _pieces(self, numel: int, elem: int, parts: int):
        region = (self.nbytes // parts) // self._ALIGN * self._ALIGN
        step = region // elem
        for off in range(0, numel, step):
            yield off, min(step, numel - off), region

    def _slot(self, rank: int, part: int, region: int, dtype, k: int):
        """Rank `rank`'s region `part`, its first k values of `dtype`."""
        elem = torch.empty((), dtype=dtype).element_size()
        return self.buffers[rank][part * region:part * region + k * elem] \
            .view(dtype)

    def allreduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of the 1-D `flat`, written into it."""
        for off, k, reg in self._pieces(flat.numel(), flat.element_size(),
                                        1):
            piece = flat[off:off + k]
            self._slot(self.me, 0, reg, flat.dtype, k).copy_(piece)
            self._fence()
            piece.copy_(self._slot(0, 0, reg, flat.dtype, k))
            for r in range(1, self.n):
                piece.add_(self._slot(r, 0, reg, flat.dtype, k))
            self._fence()
        return flat

    def gather(self, flat: torch.Tensor) -> torch.Tensor:
        """(n, numel): row r the 1-D `flat` of rank r."""
        out = flat.new_empty((self.n, flat.numel()))
        for off, k, reg in self._pieces(flat.numel(), flat.element_size(),
                                        1):
            self._slot(self.me, 0, reg, flat.dtype, k).copy_(
                flat[off:off + k])
            self._fence()
            for r in range(self.n):
                out[r, off:off + k].copy_(
                    self._slot(r, 0, reg, flat.dtype, k))
            self._fence()
        return out

    def exchange(self, blocks: torch.Tensor, reduce: bool) -> torch.Tensor:
        """`blocks` (n, m): row q goes to rank q. Returns (n, m), row r
        what rank r sent here; with `reduce`, (m,), their sum in rank
        order."""
        m = blocks.shape[1]
        out = blocks.new_empty((m,) if reduce else (self.n, m))
        for off, k, reg in self._pieces(m, blocks.element_size(), self.n):
            for q in range(self.n):
                self._slot(self.me, q, reg, blocks.dtype, k).copy_(
                    blocks[q, off:off + k])
            self._fence()
            for r in range(self.n):
                got = self._slot(r, self.me, reg, blocks.dtype, k)
                if not reduce:
                    out[r, off:off + k].copy_(got)
                elif r == 0:
                    out[off:off + k].copy_(got)
                else:
                    out[off:off + k].add_(got)
            self._fence()
        return out

    def shift(self, flat: torch.Tensor, shift: int) -> torch.Tensor:
        """The 1-D `flat` of rank (this rank - shift) mod n."""
        src = (self.me - shift) % self.n
        out = torch.empty_like(flat)
        for off, k, reg in self._pieces(flat.numel(), flat.element_size(),
                                        1):
            self._slot(self.me, 0, reg, flat.dtype, k).copy_(
                flat[off:off + k])
            self._fence()
            out[off:off + k].copy_(self._slot(src, 0, reg, flat.dtype, k))
            self._fence()
        return out

    def run(self, op, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """`op(x, group, **kwargs)` for the collectives `_host_staged`
        takes, as a new tensor."""
        n = self.n
        if op is _psum_copy or op is psum:
            return self.allreduce_(x.reshape(-1).clone()).view(x.shape)
        if op is all_gather:
            axis = kwargs.get("tiled_axis", 0) % x.dim()
            out = self.gather(x.reshape(-1)).view(n * x.shape[0],
                                                  *x.shape[1:])
            return out if axis == 0 else torch.cat(out.chunk(n, dim=0),
                                                   dim=axis)
        if op is reduce_scatter:
            axis = kwargs.get("scatter_axis", 0)
            xm = x.movedim(axis, 0).contiguous()
            out = self.exchange(xm.view(n, -1), reduce=True)
            return out.view(xm.shape[0] // n, *xm.shape[1:]).movedim(0,
                                                                    axis)
        if op is all_to_all:
            split, concat = kwargs["split_axis"], kwargs["concat_axis"]
            src = x.movedim(split, 0).contiguous()
            out = self.exchange(src.view(n, -1), reduce=False).view(
                src.shape).movedim(0, split)
            if concat == split:
                return out
            return torch.cat(out.chunk(n, dim=split), dim=concat)
        if op is ppermute_shift:
            shift = kwargs.get("shift", 1)
            if shift % n == 0:
                return x
            return self.shift(x.reshape(-1), shift).view(x.shape)
        raise NotImplementedError(f"no same-card form of {op}")


# -- autograd-aware forms (training) ------------------------------------------
#
# The training step differentiates through its collectives. Each form
# below is the forward collective with the backward that makes every
# rank's gradient the gradient of the one global loss:
#   psum_ad        sum over the group; backward the identity
#   identity_ad    the identity; backward a sum over the group
#   all_gather_ad  gather; backward a reduce_scatter
#   reduce_scatter_ad  reduce_scatter; backward a gather
#   all_to_all_ad  all_to_all; backward the inverse all_to_all
#   ppermute_ad    shift; backward the reverse shift
# A group of one rank (or None) makes each the identity.


class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _host_staged(_psum_copy, x, group)

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
        return _host_staged(_psum_copy, g, ctx.group), None


class _AllGatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _host_staged(all_gather, x, group, tiled_axis=axis)

    @staticmethod
    def backward(ctx, g):
        return _host_staged(reduce_scatter, g.contiguous(), ctx.group,
                            scatter_axis=ctx.axis), None, None


class _ReduceScatterAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _host_staged(reduce_scatter, x, group, scatter_axis=axis)

    @staticmethod
    def backward(ctx, g):
        return _host_staged(all_gather, g.contiguous(), ctx.group,
                            tiled_axis=ctx.axis), None, None


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


def reduce_scatter_ad(x: torch.Tensor, group, *, scatter_axis: int = 0):
    """`reduce_scatter` whose backward gathers (partial sums that every
    rank computed for the whole axis, each keeping its block: the
    inverse of `all_gather_ad`)."""
    if _size(group) == 1:
        return x
    return _ReduceScatterAD.apply(x, group, scatter_axis % x.dim())


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
