"""Autoregressive inference engine: the contiguous KV cache, prefill,
decode and verify steps, `generate`, and sequence embeddings.

The cache is a static (L, B, max_len, KH, Dh) buffer per k and v (int8
with (L, B, max_len, KH, 1) f32 scales when cfg.kv_cache_dtype is
"int8"). `prefill` fills each row's prompt region in one batched pass;
`decode_step` runs one token per row against the cache; `verify_step`
scores a K-token window per row in one pass without advancing the
lengths (speculative decoding's target pass: rollback is "do not
advance"). Every step writes its new k/v into the cache's buffers in
place, by index at each row's own position, never by concatenation, so
a captured program reads and writes the same addresses on every replay.

Ragged batches: right-pad prompts and pass `lengths` (B,); prefill
records per-row lengths, decode writes each row's k/v at its own
position and masks attention to the valid region, and RoPE positions
are per row. Causality makes right-padding exact.

Prefill attention is `transformer._get_attention_fn(cfg)`'s: with
attention_impl "flash" the flash-attention forward kernel on the card.
Decode and verify attend with the plain `causal_attention` against the
cache (the reference computes them outside any Pallas kernel); with an
int8 cache the scales fold into its scores and probabilities.

The transformer math comes from `models.transformer`, so inference never
drifts from training numerically. Plain functions on tensors, under
`torch.no_grad()`; the layer loop is eager Python.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.inference.sampling import sample_logits
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import causal_attention, rms_norm, rope_table
from cloud_server_tpu_torch.utils import prng


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, max_len, KH, Dh): cfg.dtype, or int8 when
    #                  cfg.kv_cache_dtype == "int8"
    v: torch.Tensor
    length: torch.Tensor  # (B,) int64 — valid entries per row
    # int8 mode only: per-(position, head) absmax scales, else None
    k_scale: torch.Tensor | None = None  # (L, B, max_len, KH, 1) f32
    v_scale: torch.Tensor | None = None


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last (head_dim) axis, in f32:
    scale = max(max|x| / 127, 1e-8), q = round(x / scale) (half to even,
    as jnp.round). Returns (int8 values, f32 scales with a kept last
    axis of 1)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `_kv_quant`, for tests only: attention folds the scales
    into its scores and probabilities and never builds this copy."""
    return (q.float() * scale).to(dtype)


def _mlp_apply(x, lp, cfg: ModelConfig, lora=None, tp=None):
    """Dense or MoE MLP residual block, chosen by cfg.num_experts.

    MoE routing at inference is per call: prefill routes over the prompt
    batch, each decode step over its B tokens, so capacity is contended
    over the call's rows (padding rows included) and matches training's
    full-batch routing only when nothing drops (a dropless
    expert_capacity_factor >= E/k).

    `lora`: per-row multi-adapter deltas (dense MLP only; the servers
    refuse MLP-targeting adapters on MoE bases). `tp`: the tensor-parallel
    group of a dense MLP sharded over it (`transformer.mlp_block`); the
    paged server refuses MoE models under tensor parallelism."""
    if cfg.num_experts >= 2:
        if tp is not None:
            raise NotImplementedError(
                "MoE MLPs under tensor parallelism (expert parallelism) are "
                "not ported to the PyTorch server yet")
        from cloud_server_tpu_torch.models import moe
        x, _ = moe.moe_mlp_block(x, lp, cfg)
        return x
    return transformer.mlp_block(x, lp, cfg, lora=lora, tp=tp)


@torch.no_grad()
def encode(params, tokens: torch.Tensor, lengths: torch.Tensor, *,
           cfg: ModelConfig) -> torch.Tensor:
    """Sequence embeddings: the decoder run WITHOUT unembedding,
    final-norm hidden states mean-pooled over each sequence's valid
    positions in f32, L2-normalised. tokens: (B, P) right-padded int;
    lengths: (B,) int, both on the parameters' device. Returns
    (B, embed_dim) f32, unit norm.

    Right-padding is exact under causal attention (real positions never
    attend to the trailing pads; pad positions are masked out of the
    pool), so one batched pass serves ragged inputs. Attention is
    `transformer._get_attention_fn(cfg)`'s: with attention_impl "flash"
    the flash-attention forward kernel on the card (its log-sum-exp
    unused), with "xla" the plain causal attention."""
    b, p = tokens.shape
    x = transformer.embed(params, tokens, cfg)
    cos, sin = rope_table(cfg, p, device=x.device)
    attn_fn = transformer._get_attention_fn(cfg)
    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin)
        x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg)
        x = _mlp_apply(x, lp, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    lengths = lengths.to(x.device).long()
    mask = torch.arange(p, device=x.device)[None, :] < lengths[:, None]
    pooled = (x.float() * mask[..., None]).sum(dim=1)
    pooled = pooled / lengths[:, None].clamp(min=1)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    """A zeroed cache for `batch` rows of `max_len` positions."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int64, device=device)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=length,
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device))
    if cfg.kv_cache_dtype != "model":
        raise ValueError(
            f"unknown kv_cache_dtype: {cfg.kv_cache_dtype!r} "
            "(expected 'model' or 'int8')")
    dtype = transformer.torch_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length)


def _rope(cfg: ModelConfig, max_len: int, device, rope):
    return rope if rope is not None else rope_table(cfg, max_len,
                                                    device=device)


def _put(cache: KVCache, layer: int, idx: tuple, k, v) -> None:
    """Write new k/v (quantized for an int8 cache) into `layer` of the
    cache at `idx` (an index over the (B, max_len) axes that k's
    leading axes match), in place."""
    if cache.k_scale is not None:
        kq, ksc = _kv_quant(k)
        vq, vsc = _kv_quant(v)
        cache.k[layer][idx] = kq
        cache.v[layer][idx] = vq
        cache.k_scale[layer][idx] = ksc
        cache.v_scale[layer][idx] = vsc
    else:
        cache.k[layer][idx] = k.to(cache.k.dtype)
        cache.v[layer][idx] = v.to(cache.v.dtype)


def _layer_scales(cache: KVCache, layer: int) -> dict:
    """An int8 cache's scales of `layer` for `causal_attention`."""
    if cache.k_scale is None:
        return {}
    return {"k_scale": cache.k_scale[layer], "v_scale": cache.v_scale[layer]}


def _check_decode_impl(cfg: ModelConfig) -> None:
    if cfg.decode_attention_impl == "pallas":
        raise ValueError(
            "the contiguous engine's pallas decode kernel was removed (it "
            "measured slower than XLA at every serving shape); "
            "decode_attention_impl='pallas' selects ops.paged_attention "
            "in the paged serving stack (inference.paged_server) instead")
    if cfg.decode_attention_impl != "xla":
        raise ValueError(
            f"unknown decode_attention_impl: {cfg.decode_attention_impl!r}")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache: KVCache,
            lengths: torch.Tensor | None = None, *, rows=None, rope=None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, P) through the model, writing its k/v into
    cache[:, rows, :P] (rows 0..B-1 unless `rows` (B,) names them).

    tokens: (B, P) int, right-padded when ragged; lengths: optional (B,)
    valid prompt lengths (defaults to P); rope: optional (cos, sin)
    tables of max_len positions on the cache's device.

    Returns (logits at each row's last valid position (B, V) f32, cache
    with `length` = lengths; its buffers are the ones written)."""
    b, p = tokens.shape
    dev = cache.k.device
    cos, sin = _rope(cfg, cache.k.shape[2], dev, rope)
    x = transformer.embed(params, tokens, cfg)
    # honour cfg.attention_impl (flash for long prompts); decode keeps
    # the dense cache path
    attn_fn = transformer._get_attention_fn(cfg)
    rows_t = (torch.arange(b, device=dev) if rows is None
              else rows.to(dev).long())
    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin)
        _put(cache, layer, (rows_t, slice(0, p)), k, v)
        x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg)
        x = _mlp_apply(x, lp, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if lengths is None:
        lengths = torch.full((b,), p, dtype=torch.int64, device=dev)
        x_last = x[:, -1]
    else:
        lengths = lengths.to(dev).long()
        x_last = x[torch.arange(b, device=dev), lengths - 1]
    logits = transformer.unembed(x_last, params, cfg)
    return logits, cache._replace(length=lengths)


# ---------------------------------------------------------------------------
# Decode and verify
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(params, token: torch.Tensor, cfg: ModelConfig,
                cache: KVCache, *, rope=None
                ) -> tuple[torch.Tensor, KVCache]:
    """One decode step. token: (B,) int; row i sits at position
    cache.length[i] (per row, so ragged batches are exact). Writes the
    new k/v at that position in place; returns (logits (B, V) f32, cache
    with length + 1)."""
    _check_decode_impl(cfg)
    return _window(params, token[:, None], cfg, cache, rope, advance=True)


@torch.no_grad()
def verify_step(params, tokens: torch.Tensor, cfg: ModelConfig,
                cache: KVCache, *, rope=None
                ) -> tuple[torch.Tensor, KVCache]:
    """Process a (B, K) window starting at each row's cache length in
    ONE forward pass, returning logits at every window position (the
    target half of speculative decoding).

    Row i's window occupies positions [length[i], length[i] + K); its
    k/v entries are written into the cache, but `length` is NOT
    advanced: the caller commits however many positions it accepts.
    Stale entries beyond the commit point are masked by `kv_length` and
    overwritten by later writes at the same positions, so rollback is
    "do not advance".

    Returns (logits (B, K, V) f32, cache with the entries written)."""
    return _window(params, tokens, cfg, cache, rope, advance=False)


def _window(params, tokens, cfg: ModelConfig, cache: KVCache, rope, *,
            advance: bool):
    b, kk = tokens.shape
    dev = cache.k.device
    max_len = cache.k.shape[2]
    cos, sin = _rope(cfg, max_len, dev, rope)
    length = cache.length.to(dev).long()
    pos = length[:, None] + torch.arange(kk, device=dev)[None, :]  # (B, K)
    # a position past the cache (no caller here produces one) lands on
    # its last entry, as the reference's clamped gathers do
    wpos = pos.clamp(max=max_len - 1)
    rows = torch.arange(b, device=dev)[:, None]
    x = transformer.embed(params, tokens, cfg)
    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, wpos)
        _put(cache, layer, (rows, wpos), k, v)
        # q positions give the in-window causal structure; kv_length
        # masks stale entries and other rows' longer windows
        o = causal_attention(q, cache.k[layer], cache.v[layer],
                             q_positions=pos, kv_length=length + kk,
                             **_layer_scales(cache, layer))
        x = transformer.attention_out(x, o, lp, cfg)
        x = _mlp_apply(x, lp, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if advance:
        logits = transformer.unembed(x[:, 0], params, cfg)
        return logits, cache._replace(length=length + 1)
    return transformer.unembed(x, params, cfg), cache


# ---------------------------------------------------------------------------
# Generate
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate(params, prompt: torch.Tensor, key: torch.Tensor, *,
             cfg: ModelConfig, infer_cfg: InferConfig,
             max_len: int | None = None,
             prompt_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched generation. prompt: (B, P) int, right-padded when ragged
    (pass prompt_lengths (B,) for the true lengths), on the parameters'
    device; key: a (2,) threefry key (`utils.prng.key(seed)`).

    Returns (B, max_decode_len) int64. Rows that hit eos_token_id emit
    pad_token_id afterwards. Runs max_decode_len - 1 decode steps: the
    first token is sampled from prefill logits and the last sampled token
    is never fed back. Step t draws with key split(key, n)[t], as the
    reference's scan does."""
    b, p = prompt.shape
    n_new = infer_cfg.max_decode_len
    max_len = max_len or (p + n_new)
    if max_len < p + n_new:
        raise ValueError(
            f"max_len={max_len} < prompt ({p}) + max_decode_len ({n_new}); "
            "the cache would silently wrap")
    dev = prompt.device
    cache = init_cache(cfg, b, max_len, device=dev)
    rope = rope_table(cfg, max_len, device=dev)
    logits, cache = prefill(params, prompt, cfg, cache, prompt_lengths,
                            rope=rope)
    keys = prng.split(key.to(dev), n_new)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    for t in range(n_new):
        tok = sample_logits(logits, keys[t], infer_cfg)
        tok = torch.where(done, infer_cfg.pad_token_id, tok)
        out.append(tok)
        if t == n_new - 1:
            break
        done = done | (tok == infer_cfg.eos_token_id)
        logits, cache = decode_step(params, tok, cfg, cache, rope=rope)
    return torch.stack(out, dim=1)
