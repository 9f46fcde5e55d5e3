"""Speculative decoding: n-gram proposals, the exact accept/residual
rule and the draws it consumes, and `speculative_generate`, the batch
API on the contiguous engine.

A round proposes G tokens per row, scores the (G+1)-token window in one
target pass, and commits an accepted prefix plus one corrective (or
bonus) token. Draft token d with draft probability q(d) and target
probability p(d) is accepted with probability min(1, p(d)/q(d)); on the
first rejection the corrective is drawn from normalize(max(p - q, 0));
if every draft survives, the bonus is drawn from the target's last
window position. For n-gram drafts q is a point mass at the proposal
(`_accept_point_mass`). Both p and q are post-filter sampling
distributions (`sampling.sampling_probs[_rows]`), so at temperature 0
speculation commits the greedy tokens exactly.

Draws. With one dispatch key (server-global sampling) the accept
uniforms and the corrective draw follow the reference's
`jax.random.split` / `uniform` / `categorical` bit for bit
(`utils/prng.py`). Seeded per-request rows draw on POSITION-KEYED
streams instead: `fold_in(fold_in(key(seed), position), tag)` with
tags 101 (draft-model proposal), 102 (accept uniform) and 103
(corrective / bonus), disjoint from plain sampling's untagged
`fold_in(key(seed), position)`. At a fixed draft length a seeded
request's speculative stream is then the same under either scheduler.
"""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.inference.sampling import (sample_from_probs,
                                                       sampling_probs)
from cloud_server_tpu_torch.utils import prng

_TAG_DRAFT, _TAG_ACCEPT, _TAG_RESIDUAL = 101, 102, 103


def _row_pos_keys(seeds, positions, tag: int) -> torch.Tensor:
    """(N,) seeds and (N,) absolute positions -> (N, 2) keys on the
    `tag` stream."""
    return prng.fold_in(prng.fold_in(prng.key(seeds), positions), tag)


def sample_from_probs_keyed(probs, keys) -> torch.Tensor:
    """Per-row categorical draw: (B, V) probabilities with (B, 2) keys
    -> (B,) int64 (the keyed counterpart of `sample_from_probs`)."""
    return prng.categorical(keys, torch.log(torch.clamp(probs, min=1e-30)))


def _accept_uniforms(key_u, b: int, g: int, seeds, pos0) -> torch.Tensor:
    """The (B, G) accept uniforms: from the dispatch key (seeds None),
    or position-keyed per row on the accept stream (u for drafts[:, j]
    keyed at the draft's absolute position pos0 + j)."""
    if seeds is None:
        return prng.uniform(key_u, (b, g))
    dev = pos0.device
    upos = pos0[:, None] + torch.arange(g, device=dev)[None, :]
    keys = _row_pos_keys(seeds[:, None].expand(b, g), upos, _TAG_ACCEPT)
    return prng.uniform(keys, ())


def _residual_draw(key_x, residual, n_acc, seeds, pos0) -> torch.Tensor:
    """The corrective/bonus draw: from the dispatch key, or keyed at the
    corrective's absolute position (pos0 + n_acc) on the residual
    stream."""
    if seeds is None:
        return sample_from_probs(residual, key_x)
    return sample_from_probs_keyed(
        residual, _row_pos_keys(seeds, pos0 + n_acc, _TAG_RESIDUAL))


def _accept_drafts(drafts, q_probs, p_probs, key, *, seeds=None,
                   pos0=None):
    """The accept/residual rule over a batch of windows.

    drafts: (B, G) proposed tokens; q_probs: (B, G, V) draft sampling
    distributions; p_probs: (B, G+1, V) target sampling distributions
    (position j scores drafts[:, j]; position G is the bonus position).
    `seeds`/`pos0` ((B,) seeds / (B,) absolute position of drafts[:, 0])
    switch the uniforms and the corrective draw to the per-request
    position-keyed streams; None draws from `key`.

    Returns (n_accepted (B,) int64 in [0, G], corrective token x (B,))."""
    b, g = drafts.shape
    key_u, key_x = prng.split(key, 2).unbind(-2)
    bi = torch.arange(b, device=drafts.device)
    d = drafts.long()[..., None]
    q_d = q_probs.gather(-1, d)[..., 0]
    p_d = p_probs[:, :g].gather(-1, d)[..., 0]
    u = _accept_uniforms(key_u, b, g, seeds, pos0)
    accept = u * torch.clamp(q_d, min=1e-30) < p_d  # u < min(1, p/q)
    n_acc = torch.cumprod(accept.long(), dim=-1).sum(dim=-1)
    # the residual at the first rejection; with every draft accepted it
    # is the bonus position's target distribution (q zeroed)
    p_r = p_probs[bi, n_acc]
    q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    q_r = torch.where((n_acc < g)[:, None], q_pad[bi, n_acc], 0.0)
    residual = torch.clamp(p_r - q_r, min=0.0)
    bad = residual.sum(-1, keepdim=True) <= 0.0
    residual = torch.where(bad, p_r, residual)
    return n_acc, _residual_draw(key_x, residual, n_acc, seeds, pos0)


def _accept_point_mass(drafts, p_probs, key, *, seeds=None, pos0=None):
    """`_accept_drafts` for point-mass q (n-gram drafts): accept while
    u < p(d); the residual is p with the rejected proposal zeroed."""
    b, g = drafts.shape
    key_u, key_x = prng.split(key, 2).unbind(-2)
    bi = torch.arange(b, device=drafts.device)
    dl = drafts.long()
    p_d = p_probs[:, :g].gather(-1, dl[..., None])[..., 0]
    u = _accept_uniforms(key_u, b, g, seeds, pos0)
    n_acc = torch.cumprod((u < p_d).long(), dim=-1).sum(dim=-1)
    p_r = p_probs[bi, n_acc]
    rejected = torch.where(n_acc < g, dl[bi, torch.clamp(n_acc, max=g - 1)],
                           -1)
    vocab = torch.arange(p_r.shape[-1], device=p_r.device)
    residual = torch.where((vocab[None, :] == rejected[:, None])
                           & (n_acc < g)[:, None], 0.0, p_r)
    bad = residual.sum(-1, keepdim=True) <= 0.0
    residual = torch.where(bad, p_r, residual)
    return n_acc, _residual_draw(key_x, residual, n_acc, seeds, pos0)


def _ngram_drafts(hist, valid, t_prev2, t_prev, g: int, pad: int):
    """Prompt-lookup proposals: the G tokens that followed the latest
    earlier occurrence of the bigram (t_prev2, t_prev) in
    hist[:, :valid]. Rows with no match (or running off the committed
    region) propose `pad`, an ordinary proposal the accept rule scores
    like any other. Returns (B, G) int64."""
    hl = hist.shape[1]
    dev = hist.device
    i = torch.arange(hl - 1, device=dev)
    match = ((hist[:, :-1] == t_prev2[:, None])
             & (hist[:, 1:] == t_prev[:, None])
             # strictly before the current occurrence at (valid-2, valid-1)
             & (i[None, :] + 1 < (valid - 1)[:, None]))
    last = torch.where(match, i, -1).amax(dim=1)
    found = last >= 0
    pos = (last + 2)[:, None] + torch.arange(g, device=dev)[None, :]
    ok = found[:, None] & (pos < valid[:, None])
    gathered = hist.gather(1, pos.clamp(0, hl - 1)).long()
    return torch.where(ok, gathered, pad)


@torch.no_grad()
def speculative_generate(params, draft_params, prompt: torch.Tensor,
                         key: torch.Tensor, *, cfg: ModelConfig,
                         draft_cfg: ModelConfig | None = None,
                         infer_cfg: InferConfig, num_draft: int = 4,
                         max_len: int | None = None,
                         prompt_lengths: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Speculative counterpart of `engine.generate`, same contract:
    prompt (B, P) int right-padded (pass prompt_lengths when ragged) on
    the parameters' device, key a (2,) threefry key; returns
    (B, max_decode_len) int64 with pad after eos.

    `draft_params`/`draft_cfg` select the draft source: a small model
    sharing the target's vocabulary, or None/None for prompt-lookup
    (n-gram) drafting. `num_draft` (G) proposals are scored per round.

    Cache discipline: at a round's start every committed token except
    the last has been processed into the cache(s). The draft model runs
    G+1 decode steps (the last only processes its own G-th proposal, so
    that when all are accepted its cache is caught up; its sample is
    discarded); `verify_step` writes the window without advancing the
    target's lengths, and the commit advances both caches' lengths by
    the committed count. The rounds run while any row is live, at most
    max_decode_len of them; each round splits fold_in(key, round) into
    the next round's key and its draft and accept keys, as the
    reference's while loop does, so the draws are its own bit for bit."""
    from cloud_server_tpu_torch.inference.engine import (
        decode_step, init_cache, prefill, verify_step)
    from cloud_server_tpu_torch.ops import rope_table
    use_ngram = draft_params is None
    if use_ngram != (draft_cfg is None):
        raise ValueError("pass draft_params and draft_cfg together "
                         "(both None selects n-gram drafting)")
    b, p = prompt.shape
    g = num_draft
    n_new = infer_cfg.max_decode_len
    pad = infer_cfg.pad_token_id
    eos = infer_cfg.eos_token_id
    # + g + 1 slack: the final round's window may overhang the output
    max_len = max_len or (p + n_new + g + 1)
    if max_len < p + n_new + g + 1:
        raise ValueError(
            f"max_len={max_len} < prompt ({p}) + max_decode_len ({n_new}) "
            f"+ window slack ({g + 1}); the cache would silently wrap")
    dev = prompt.device
    key = key.to(dev)
    rope = rope_table(cfg, max_len, device=dev)
    cache = init_cache(cfg, b, max_len, device=dev)
    logits, cache = prefill(params, prompt, cfg, cache, prompt_lengths,
                            rope=rope)
    d_cache = d_rope = None
    if not use_ngram:
        d_rope = rope_table(draft_cfg, max_len, device=dev)
        d_cache = init_cache(draft_cfg, b, max_len, device=dev)
        _, d_cache = prefill(draft_params, prompt, draft_cfg, d_cache,
                             prompt_lengths, rope=d_rope)

    plen = (torch.full((b,), p, dtype=torch.int64, device=dev)
            if prompt_lengths is None else prompt_lengths.to(dev).long())
    key, key0 = prng.split(key, 2).unbind(0)
    t_prev = sample_from_probs(sampling_probs(logits, infer_cfg), key0)
    done = t_prev == eos
    out = torch.full((b, n_new + g + 1), pad, dtype=torch.int64,
                     device=dev)
    # the eos itself is emitted (as generate does); only later tokens pad
    out[:, 0] = t_prev
    n_emit = torch.ones((b,), dtype=torch.int64, device=dev)
    bi = torch.arange(b, device=dev)
    j = torch.arange(g + 1, device=dev)[None, :]

    # committed-token history (prompt + generated) for n-gram lookup
    hl = p + n_new + g + 1
    hist = torch.full((b, hl), pad, dtype=torch.int64, device=dev)
    hist[:, :p] = prompt.long()
    hist[bi, plen] = t_prev
    t_prev2 = hist[bi, (plen - 1).clamp(min=0)]

    for rnd in range(n_new):
        if not bool((~done & (n_emit < n_new)).any()):
            break
        key, r_draft, r_acc = prng.split(prng.fold_in(key, rnd),
                                         3).unbind(0)
        if use_ngram:
            drafts = _ngram_drafts(hist, plen + n_emit, t_prev2, t_prev, g,
                                   pad)
        else:
            d_keys = prng.split(r_draft, g + 1)
            tok, toks, qs = t_prev, [], []
            for s in range(g + 1):
                dlogits, d_cache = decode_step(draft_params, tok, draft_cfg,
                                               d_cache, rope=d_rope)
                qp = sampling_probs(dlogits, infer_cfg)
                tok = sample_from_probs(qp, d_keys[s])
                toks.append(tok)
                qs.append(qp)
            drafts = torch.stack(toks[:g], dim=1)  # (B, G)
            q_probs = torch.stack(qs[:g], dim=1)   # (B, G, V)

        # verify the whole window in one target pass
        window = torch.cat([t_prev[:, None], drafts], dim=1)
        vlogits, cache = verify_step(params, window, cfg, cache, rope=rope)
        p_probs = sampling_probs(vlogits, infer_cfg)  # (B, G+1, V)
        if use_ngram:
            n_acc, x = _accept_point_mass(drafts, p_probs, r_acc)
        else:
            n_acc, x = _accept_drafts(drafts, q_probs, p_probs, r_acc)

        # commit d_1..d_{n_acc} then x, truncated at the first eos
        drafts_x = torch.cat([drafts, x[:, None]], dim=1)  # (B, G+1)
        committed = torch.where(
            j < n_acc[:, None], drafts_x,
            torch.where(j == n_acc[:, None], x[:, None], pad))
        is_eos = committed == eos
        first_eos = torch.argmax(is_eos.int(), dim=1)
        has_eos = is_eos.any(dim=1)
        count = torch.where(has_eos, torch.minimum(n_acc + 1, first_eos + 1),
                            n_acc + 1)
        count = torch.where(done, 0, count)
        emit = torch.where(j < count[:, None], committed, pad)

        # scatter into each row's next output slots; writes past the
        # buffer drop
        cols = n_emit[:, None] + j
        keep = cols < out.shape[1]
        r2 = bi[:, None].expand_as(cols)
        out[r2[keep], cols[keep]] = emit[keep]
        hcols = plen[:, None] + cols
        hkeep = hcols < hl
        hist[r2[hkeep], hcols[hkeep]] = emit[hkeep]

        new_len = cache.length + count
        cache = cache._replace(length=new_len)
        if not use_ngram:
            d_cache = d_cache._replace(length=new_len)
        done = done | (has_eos & (first_eos < count))
        n_emit = n_emit + count
        last_idx = (count - 1).clamp(min=0)
        t_prev = torch.where(count > 0, committed[bi, last_idx], t_prev)
        # rows past their budget keep committing while another row is
        # live: the gather clamps as the reference's does
        t_prev2 = hist[bi, (plen + n_emit - 2).clamp(0, hl - 1)]
    return out[:, :n_new]
