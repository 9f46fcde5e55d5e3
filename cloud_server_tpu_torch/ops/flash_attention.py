"""Flash attention: causal (optionally segment-masked) attention for
training, forward and backward.

Layout is the reference's, `ops.attention`'s: q (B, S, H, Dh), k and v
(B, S, KH, Dh), out (B, S, H, Dh); H a multiple of KH (GQA).

Two versions of one function:

  * `flash_attention_ref` — the plain PyTorch version: a dense masked
    softmax in float32 that also returns the per-row log-sum-exp
    (B, H, S). It differentiates through autograd.
  * `flash_attention` — the kernel wrapper. Its forward is the
    dispatcher op `cloud_server_tpu_torch::flash_fwd` (`flash_fwd_op`),
    which returns (out, lse) and carries its own backward
    (`torch.library.register_autograd`), so a selective-checkpointing
    policy can save its outputs by name (`models.transformer.
    apply_remat`'s "attn" and "dots"). On a CUDA tensor the op launches
    the hand-written Hopper kernel of `csrc/flash_attention.cu` (the
    reference's `_fwd_kernel`) and its backward the fused whole-sequence
    kernel when S <= block (the reference's `_bwd_fused_kernel`) or the
    dK/dV kernel then the dQ kernel (`_bwd_dkdv_kernel`,
    `_bwd_dq_kernel`), by the reference's rule and block sizes. The
    kernels take S in multiples of 64: the op pads S in the layout copy
    it makes anyway, and the wrapper slices the result back, which is
    exact (`to_kernel_layout`). Head dims other than 64 and 128 and
    dtypes other than bfloat16 raise NotImplementedError. On a CPU
    tensor the op runs the plain version, and its backward the plain
    backward from the saved (out, lse) (`flash_backward_ref`).

Launch counters, one per TPU kernel: `launches_fwd`, `launches_bwd_dkdv`,
`launches_bwd_dq`, `launches_bwd_fused`; `plain_calls` counts the plain
version's calls. Under `remat="full"` the forward runs twice per layer
and step (the backward recomputes it); under "attn" and "dots" once.
While a CUDA graph captures (`inference/graphs.py`), this thread's calls
launch nothing and count into the capture's tally (`recording`); each
replay adds the tally (`add_counts`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from cloud_server_tpu_torch.ops import cuda_build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_ROWS = 64  # the kernels take S in multiples of it; the wrapper pads

launches_fwd = 0
launches_bwd_dkdv = 0
launches_bwd_dq = 0
launches_bwd_fused = 0
plain_calls = 0


def reset_counters() -> None:
    global launches_fwd, launches_bwd_dkdv, launches_bwd_dq
    global launches_bwd_fused, plain_calls
    launches_fwd = launches_bwd_dkdv = launches_bwd_dq = 0
    launches_bwd_fused = plain_calls = 0


def counters() -> dict:
    return {"launches_fwd": launches_fwd,
            "launches_bwd_dkdv": launches_bwd_dkdv,
            "launches_bwd_dq": launches_bwd_dq,
            "launches_bwd_fused": launches_bwd_fused,
            "plain_calls": plain_calls}


_counts_lock = threading.Lock()
# per thread: the tally of an open `recording()`, else unset
_recording = threading.local()


def _count(name: str) -> None:
    """One call of counter `name`: into this thread's open recording,
    else into the counters."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _counts_lock:
        globals()[name] += 1


def add_counts(delta: dict) -> None:
    """Add `delta` (shaped like `counters()`): a graph replay launches
    what its capture recorded."""
    with _counts_lock:
        for name, n in delta.items():
            globals()[name] += n


@contextlib.contextmanager
def recording():
    """Count this thread's calls into the yielded dict instead of the
    counters (a CUDA graph's capture, whose calls launch nothing)."""
    tally = dict.fromkeys(counters(), 0)
    _recording.tally = tally
    try:
        yield tally
    finally:
        _recording.tally = None


def default_block(seq: int, want: int) -> int:
    """The reference's `_default_block`: the largest halving of
    min(seq, want) that divides seq."""
    b = min(seq, want)
    while seq % b:
        b //= 2
    return max(b, 1)


def uses_fused_backward(sq: int, skv: int, block_q: int,
                        block_kv: int) -> bool:
    """The reference's dispatch (`_flash_bwd_rule`): the whole-sequence
    backward when the sequence fits one block, else the blocked pair."""
    bq, bkv = default_block(sq, block_q), default_block(skv, block_kv)
    return sq == skv and sq <= bq and skv <= bkv


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def flash_attention_ref(q, k, v, segment_ids=None, scale=None):
    """Plain causal attention with the per-row log-sum-exp.

    q (B, S, H, Dh), k/v (B, S, KH, Dh), segment_ids optional (B, S).
    Scores, mask and softmax in float32; probabilities rounded to q's
    dtype before the product with v. Returns (out (B, S, H, Dh) in
    q.dtype, lse (B, H, S) float32)."""
    _count("plain_calls")
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, s, kh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None]
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        mask = mask & (seg[:, :, None] == seg[:, None, :])
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    lse = torch.logsumexp(scores, dim=-1)                  # (B, KH, G, S)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype).reshape(b, s, h, d), lse.reshape(b, h, s)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, seg, out, lse | batch, heads, kv_heads, seq, head_dim |
    # scale | stream
    "flash_attention_fwd_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, out, dout, lse, seg, delta, dk, dv | ... | scale | stream
    "flash_attention_bwd_dkdv_bf16": [_P] * 10 + [_I] * 5 + [_F, _P],
    # q, k, v, dout, lse, delta, seg, dq | ... | scale | stream
    "flash_attention_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_F, _P],
    # q, k, v, out, dout, lse, seg, delta, dq32, dq, dk, dv | ... | scale |
    # stream
    "flash_attention_bwd_fused_bf16": [_P] * 12 + [_I] * 5 + [_F, _P],
}


def _kernel(name: str):
    """The ctypes function of one C entry of csrc/flash_attention.cu
    (built at first use)."""
    fn = getattr(cuda_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           f"CUDA error {err}")


def _validate(q, k, v, seg) -> None:
    """Raise on anything the CUDA kernels do not take: NotImplementedError
    for a dtype or head dim they were not built for, ValueError for
    shapes that do not fit. q (B, S, H, Dh), k/v (B, S, KH, Dh), seg
    (B, S) or None, on one device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[1] != q.shape[1] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)} (the "
                         "kernels take self-attention, Sq == Skv)")
    b, s, _, d = q.shape
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"flash_attention: dtype {t.dtype} is not ported (the "
                "CUDA kernels take bfloat16 q, k, v)")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: head_dim {d} is not ported (the CUDA "
            f"kernels take {KERNEL_HEAD_DIMS})")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if seg is not None and (seg.shape != (b, s) or seg.device != q.device):
        raise ValueError(f"segment_ids must be (B, S) = {(b, s)} on "
                         f"{q.device}; got {tuple(seg.shape)}")


def _aligned(t):
    """t, or a copy of it if its data is not 16-byte aligned: the TMA
    and bulk copies of the kernels read from 16-byte aligned addresses."""
    return t.clone() if t.data_ptr() % 16 else t


def padded_len(s: int) -> int:
    """S rounded up to the kernels' multiple of KERNEL_ROWS."""
    return -(-s // KERNEL_ROWS) * KERNEL_ROWS


def to_kernel_layout(x, s_pad: int):
    """(B, S, N, Dh) -> a new contiguous (B, N, S_pad, Dh), rows S.. zero.

    The pad is exact for causal attention: the padded keys come after
    every real query, so the causal mask hides them, and the padded query
    rows get zero rows of dout (this copy of the incoming gradient), so
    delta and dS are 0 there and they add nothing to dK or dV. Their own
    outputs are sliced away by `from_kernel_layout`."""
    b, s, n, d = x.shape
    out = x.new_empty((b, n, s_pad, d))
    out[:, :, :s].copy_(x.transpose(1, 2))
    if s_pad > s:
        out[:, :, s:].zero_()
    return out


def from_kernel_layout(x, s: int):
    """(B, N, S_pad, Dh) -> its first S rows as a (B, S, N, Dh) view."""
    return x[:, :, :s].transpose(1, 2)


def pad_segments(seg, s_pad: int):
    """(B, S) ids -> (B, S_pad) int32 (16-byte aligned), padded per row
    with an id no real position of the row has: its largest id + 1."""
    b, s = seg.shape
    seg = seg.to(torch.int32)
    if s_pad == s:
        return _aligned(seg.contiguous())
    out = seg.new_empty((b, s_pad))
    out[:, :s].copy_(seg)
    out[:, s:] = seg.amax(dim=1, keepdim=True) + 1
    return out


def _dims(q, k):
    b, h, s, d = q.shape
    return b, h, k.shape[1], s, d


def forward_bhsd(q, k, v, seg, scale):
    """One launch of the forward kernel on (B, H, S, Dh) bf16 CUDA tensors
    in the kernel layout (S a multiple of KERNEL_ROWS): (out (B, H, S, Dh)
    bf16, lse (B, H, S) float32)."""
    b, h, kh, s, d = _dims(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check(_kernel("flash_attention_fwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), out.data_ptr(),
        lse.data_ptr(), b, h, kh, s, d, float(scale), stream), "forward")
    _count("launches_fwd")
    return out, lse


def flash_backward_ref(q, k, v, seg, out, lse, dout, scale):
    """The plain backward of `flash_attention_ref` from its residuals:
    q (B, S, H, Dh), k/v (B, S, KH, Dh), seg (B, S) or None, out and dout
    (B, H, S, Dh), lse (B, H, S). Recomputes the probabilities from lse
    (no forward), in float32. Returns (dq, dk, dv) in the inputs'
    layouts and dtypes."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, s, kh, g, d)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])
    mask = mask[:, None, None]
    probs = torch.where(
        mask, torch.exp(scores - lse.reshape(b, kh, g, s)[..., None]), 0.0)
    do = dout.float().reshape(b, kh, g, s, d)
    delta = (do * out.float().reshape(b, kh, g, s, d)).sum(-1)
    dv = torch.einsum("bkgqs,bkgqd->bskd", probs, do)
    dp = torch.einsum("bkgqd,bskd->bkgqs", do, vf)
    ds = probs * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _backward_kernels(q, k, v, seg, out, lse, dout, scale, fused):
    """B6, or B4 then B5, on the residuals of `_flash_fwd`'s CUDA path:
    q/k/v (B, S, H|KH, Dh) as given to it, out and dout (B, H, S_pad,
    Dh), lse (B, H, S_pad). Returns (dq, dk, dv) in q/k/v's layout."""
    s0, s_pad = q.shape[1], out.shape[2]
    qt, kt, vt = (to_kernel_layout(x, s_pad) for x in (q, k, v))
    seg = None if seg is None else pad_segments(seg, s_pad)
    # dout's rows past s0 are zero (the slice's gradient), so delta and
    # dS are 0 there (`to_kernel_layout`)
    dout_t = _aligned(dout.contiguous())
    b, h, kh, s, d = _dims(qt, kt)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(qt)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    if fused:
        # the entry zeroes this f32 scratch, adds dQ into it and converts
        # it into dq
        dq32 = torch.empty(qt.shape, dtype=torch.float32, device=q.device)
        _check(_kernel("flash_attention_bwd_fused_bf16")(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            dout_t.data_ptr(), lse.data_ptr(), _ptr(seg), delta.data_ptr(),
            dq32.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            h, kh, s, d, scale, stream), "fused backward")
        _count("launches_bwd_fused")
    else:
        _check(_kernel("flash_attention_bwd_dkdv_bf16")(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            dout_t.data_ptr(), lse.data_ptr(), _ptr(seg), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, kh, s, d, scale, stream),
            "dK/dV")
        _count("launches_bwd_dkdv")
        _check(_kernel("flash_attention_bwd_dq_bf16")(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), dout_t.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(seg), dq.data_ptr(), b, h,
            kh, s, d, scale, stream), "dQ")
        _count("launches_bwd_dq")
    return (from_kernel_layout(dq, s0), from_kernel_layout(dk, s0),
            from_kernel_layout(dv, s0))


# The forward as a dispatcher op, so that a selective-checkpointing
# policy can name its outputs (models.transformer.apply_remat's "attn"
# and "dots" save them) and the backward reads them instead of running
# the forward again.
@torch.library.custom_op(
    "cloud_server_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? seg, float scale, "
           "bool fused) -> (Tensor, Tensor)")
def _flash_fwd(q, k, v, seg, scale, fused):
    """Causal attention's (out (B, H, S', Dh), lse (B, H, S') f32) from
    q (B, S, H, Dh), k/v (B, S, KH, Dh): on a CUDA tensor one launch of
    B3 on padded layout copies (S' = S_pad), on a CPU tensor the plain
    version (S' = S). `fused` picks the backward (B6, else B4 + B5)."""
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(q, k, v, seg, scale)
        return out.transpose(1, 2).contiguous(), lse
    s_pad = padded_len(q.shape[1])
    qt, kt, vt = (to_kernel_layout(x, s_pad) for x in (q, k, v))
    segt = None if seg is None else pad_segments(seg, s_pad)
    return forward_bhsd(qt, kt, vt, segt, scale)


def _flash_setup(ctx, inputs, output):
    q, k, v, seg, scale, fused = inputs
    ctx.save_for_backward(q, k, v, seg, *output)
    ctx.scale = float(scale)
    ctx.fused = fused


def _flash_backward(ctx, dout, dlse):
    q, k, v, seg, out, lse = ctx.saved_tensors
    if q.device.type == "cpu":
        grads = flash_backward_ref(q, k, v, seg, out, lse, dout, ctx.scale)
    else:
        grads = _backward_kernels(q, k, v, seg, out, lse, dout, ctx.scale,
                                  ctx.fused)
    return (*grads, None, None, None)


_flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)
flash_fwd_op = torch.ops.cloud_server_tpu_torch.flash_fwd.default


def flash_attention(q, k, v, *, scale=None, block_q: int = 1024,
                    block_kv: int = 1024, segment_ids=None):
    """Causal flash attention, (B, S, H, Dh) layout like ops.attention.

    q: (B, S, H, Dh); k, v: (B, S, KH, Dh). Returns (B, S, H, Dh).
    segment_ids: optional (B, S) int packed-sequence ids — attention is
    further masked to same-segment pairs, in forward and backward.
    block_q / block_kv choose the backward as the reference does, on the
    unpadded S: the fused whole-sequence kernel when S fits one block,
    else the dK/dV and dQ kernels. Any S runs (padded to a multiple of 64
    for the kernels). On a CPU tensor this is the plain version; on a CUDA
    tensor the kernels run or this raises.
    """
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    seg = None if segment_ids is None else segment_ids.to(q.device)
    if q.device.type == "cuda":
        _validate(q, k, v, seg)
    fused = uses_fused_backward(q.shape[1], k.shape[1], block_q, block_kv)
    out, _ = _flash_fwd(q, k, v, seg, float(scale), fused)
    return from_kernel_layout(out, q.shape[1])
