"""The float32-output product: operands of any dtype, products summed and
returned in float32 (the reference's preferred_element_type=float32). The
unembed's logits and the plain fused cross-entropy both take it from
here, so one function chooses how each device forms it."""

from __future__ import annotations

import torch


class _MatmulF32Out(torch.autograd.Function):
    """(N, K) @ (K, M) in bf16 with float32 output, on the card: one
    cuBLAS product that accumulates and writes in float32, never an f32
    copy of an operand. The backward is two bf16 products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, M) -> float32, differentiable. float32 operands
    multiply as they are; on the CPU low-precision operands are widened
    first (exact products, float32 sums); on the card they go through
    `_MatmulF32Out`."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    lead = a.shape[:-1]
    out = _MatmulF32Out.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])
