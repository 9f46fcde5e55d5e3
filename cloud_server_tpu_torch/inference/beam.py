"""Exact width-k beam search over the contiguous engine.

All k beams of all B prompts ride ONE (B*k)-row batched KV cache. Each
step is a single batched `decode_step`, a top-2k candidate selection and
a gather of the cache rows under the surviving beams (the beam
reorder); the prompt is prefilled once and tiled k-fold.

Selection follows the standard 2k-candidate scheme: each step takes the
top 2k of cum_logprob + log p(token) over the k*V continuations;
candidates ending in EOS retire into a per-prompt finished pool (score
length-normalised by `length_penalty`), the best k non-EOS candidates
continue. Live beams still running at max_new join the pool at the end,
so the search always returns k ranked hypotheses.
"""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.inference import engine
from cloud_server_tpu_torch.ops import rope_table

NEG_INF = -1e30


def _norm_score(cum: torch.Tensor, length, length_penalty: float):
    """Length-normalised ranking score: cum_logprob / len**penalty.
    penalty 0 = raw sum (longer means worse); 1 = mean logprob."""
    length = torch.as_tensor(length, device=cum.device).clamp(min=1)
    return cum / length.float() ** length_penalty


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k: the k largest along the last axis, best first; equal
    values keep their index order (torch.topk's sorted order on ties is
    not specified, so the sort is stable on -x)."""
    order = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return x.gather(-1, order), order


@torch.no_grad()
def beam_search(params, prompt: torch.Tensor, *, cfg: ModelConfig,
                k: int = 4, max_new: int = 16, eos_token_id: int = -1,
                pad_token_id: int = 0, length_penalty: float = 1.0,
                max_len: int | None = None,
                prompt_lengths: torch.Tensor | None = None):
    """prompt: (B, P) int (right-padded; pass prompt_lengths when
    ragged), on the parameters' device. Returns (tokens (B, k, max_new)
    int64 padded past EOS, scores (B, k) f32), best first per prompt."""
    b, p = prompt.shape
    if 2 * k > cfg.vocab_size:
        # the 2k-candidate selection needs 2k distinct continuations of
        # ONE live beam at t=0 (the other k-1 start at NEG_INF)
        raise ValueError(
            f"beam width k={k} needs 2*k <= vocab_size "
            f"({cfg.vocab_size}); the top-2k candidate selection "
            "breaks for tiny vocabularies")
    max_len = max_len or (p + max_new)
    if max_len < p + max_new:
        raise ValueError(f"max_len={max_len} < prompt + max_new")
    dev = prompt.device
    rope = rope_table(cfg, max_len, device=dev)
    cache = engine.init_cache(cfg, b, max_len, device=dev)
    logits, cache = engine.prefill(params, prompt, cfg, cache,
                                   prompt_lengths, rope=rope)

    # tile the prompt cache k-fold: rows [i*k, (i+1)*k) are prompt i's
    # beams
    def tile(x):
        return None if x is None else x.repeat_interleave(k, dim=1)

    cache = engine.KVCache(k=tile(cache.k), v=tile(cache.v),
                           length=cache.length.repeat_interleave(k),
                           k_scale=tile(cache.k_scale),
                           v_scale=tile(cache.v_scale))
    logits = logits.repeat_interleave(k, dim=0)  # (B*k, V)
    v = logits.shape[-1]

    # beam 0 is the only live hypothesis at t=0 (all beams are identical
    # until the first selection)
    cum = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    cum[:, 0] = 0.0
    seq = torch.full((b, k, max_new), pad_token_id, dtype=torch.int64,
                     device=dev)
    fin_t = seq.clone()
    fin_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]

    for t in range(max_new):
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = cum[:, :, None] + logp.reshape(b, k, v)  # (B, k, V)
        sc2k, idx2k = _top_k(cand.reshape(b, k * v), 2 * k)
        parent = idx2k // v          # (B, 2k)
        tok = idx2k % v
        parent_seq = seq[bidx, parent]                  # (B, 2k, M)
        cand_seq = parent_seq.clone()
        cand_seq[:, :, t] = tok
        is_eos = tok == eos_token_id

        # EOS candidates retire; the EOS token itself is NOT stored, but
        # its position counts toward the length normalisation (t + 1)
        fin_cand = torch.where(is_eos,
                               _norm_score(sc2k, t + 1, length_penalty),
                               NEG_INF)
        pool_s = torch.cat([fin_s, fin_cand], dim=1)       # (B, 3k)
        pool_t = torch.cat([fin_t, parent_seq], dim=1)     # (B, 3k, M)
        fin_s, fin_idx = _top_k(pool_s, k)
        fin_t = pool_t[bidx, fin_idx]

        # live continuation: the best k non-EOS candidates
        live_sc = torch.where(is_eos, NEG_INF, sc2k)
        cum, live_idx = _top_k(live_sc, k)
        new_parent = parent.gather(1, live_idx)
        new_tok = tok.gather(1, live_idx)
        seq = cand_seq[bidx, live_idx]
        if t == max_new - 1:
            break  # the last step's logits are never read

        # reorder the cache rows under the surviving beams
        flat = (bidx * k + new_parent).reshape(-1)
        cache = engine.KVCache(
            k=cache.k[:, flat], v=cache.v[:, flat],
            length=cache.length[flat],
            k_scale=None if cache.k_scale is None else cache.k_scale[:, flat],
            v_scale=None if cache.v_scale is None else cache.v_scale[:, flat])
        logits, cache = engine.decode_step(params, new_tok.reshape(-1), cfg,
                                           cache, rope=rope)

    # live beams at the horizon join the pool, normalised at max_new
    live_s = _norm_score(cum, max_new, length_penalty)
    pool_s = torch.cat([fin_s, live_s], dim=1)
    pool_t = torch.cat([fin_t, seq], dim=1)
    scores, order = _top_k(pool_s, k)
    return pool_t[bidx, order], scores
