"""Weight-only int8 quantization for inference.

Every weight of the model is consumed as `w.to(cfg.dtype)` right before
its product (models/transformer.py). `QTensor` holds an int8 payload and
float32 per-output-channel scales, and its `.to(dtype)` dequantizes (a
float32 multiply, then the cast), so quantized parameter trees flow
through the unmodified model, engines and servers; indexing a stacked
QTensor (`transformer.layer_params`) slices the payload and its scales
together.

Scales are symmetric and constant along every contracted axis of the
consuming product (`_REDUCE_AXES`), which is what makes scaling after
the product exact. Norm scales and embeddings stay in full precision;
an untied `lm_head` kernel is quantized over its D axis.

The dequantized copy is materialised in `cfg.dtype` at each use (about
a bfloat16 weight's bytes written and read again per product): the
product itself is the plain `torch.matmul` on that copy (for MoE expert
stacks, one (E, D, F) copy per layer and product). Router weights stay
in full precision, as in the reference. Inference only.
"""

from __future__ import annotations

from typing import Any

import torch

# (leaf name, ndim) -> axes of the *stacked* weight that its consuming
# product contracts. Scales reduce over exactly these axes, so they stay
# per-output-channel (and per-layer, per-expert) everywhere else.
_REDUCE_AXES: dict[tuple[str, int], tuple[int, ...]] = {
    # dense attention (L, D, H|KH, Dh): contract D
    ("wq", 4): (1,), ("wk", 4): (1,), ("wv", 4): (1,),
    # attention out (L, H, Dh, D): contract H, Dh
    ("wo", 4): (1, 2),
    # dense MLP (L, D, F) / (L, F, D): contract axis 1
    ("w_gate", 3): (1,), ("w_up", 3): (1,), ("w_down", 3): (1,),
    # MoE experts (L, E, D, F) / (L, E, F, D): contract axis 2
    ("w_gate", 4): (2,), ("w_up", 4): (2,), ("w_down", 4): (2,),
    # untied lm_head (D, V): contract D
    ("kernel", 2): (0,),
}


class QTensor:
    """int8 payload + broadcastable f32 scales; dequantizes on
    `.to(dtype)`."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self):
        return self.q.dtype

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading axes of payload and scales together (the
        scales keep their size-1 contracted axes)."""
        return QTensor(self.q[idx], self.scale[idx])

    def unbind(self, dim: int = 0) -> tuple["QTensor", ...]:
        """The leading-axis slices (the model's per-layer split)."""
        if dim != 0:
            raise ValueError("a QTensor unbinds along its leading axis")
        return tuple(self[i] for i in range(self.q.shape[0]))

    def to(self, target) -> "torch.Tensor | QTensor":
        """A dtype dequantizes (f32 multiply, then the cast, as the
        reference's `astype`); a device moves payload and scales."""
        if isinstance(target, torch.dtype):
            return (self.q.float() * self.scale).to(target)
        return QTensor(self.q.to(target), self.scale.to(target))

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale

    def __repr__(self):
        return (f"QTensor(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def quantize(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> QTensor:
    """Symmetric int8 quantization with scales reduced over
    `reduce_axes`: scale = max(amax, 1e-8) / 127, q = clip(round(w /
    scale), -127, 127) with round half to even."""
    w = w.float()
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_params(params: Any) -> Any:
    """Quantize every weight with a `_REDUCE_AXES` entry; pass the rest
    through untouched. A "kernel" is quantized only under "lm_head"."""

    def walk(tree, parent):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, name)
                continue
            key = (name, leaf.dim())
            if name == "kernel" and parent != "lm_head":
                out[name] = leaf
                continue
            axes = _REDUCE_AXES.get(key)
            out[name] = leaf if axes is None else quantize(leaf, axes)
        return out

    return walk(params, None)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def dequantize_params(params: Any) -> Any:
    """Inverse of `quantize_params` (lossy): QTensor leaves -> f32
    tensors."""
    return {k: (dequantize_params(v) if isinstance(v, dict)
                else v.dequantize() if isinstance(v, QTensor) else v)
            for k, v in params.items()}


def quantized_bytes(params: Any) -> tuple[int, int]:
    """(bytes as stored, bytes if everything were bf16)."""
    stored = bf16 = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            stored += leaf.q.numel() + 4 * leaf.scale.numel()
            bf16 += 2 * leaf.q.numel()
        else:
            stored += leaf.element_size() * leaf.numel()
            bf16 += 2 * leaf.numel()
    return stored, bf16


def params_to(params: Any, device) -> Any:
    """A parameter tree (tensors or QTensors) on `device`."""
    return {k: (params_to(v, device) if isinstance(v, dict)
                else v.to(device) if isinstance(v, QTensor)
                else torch.as_tensor(v).to(device))
            for k, v in params.items()}
