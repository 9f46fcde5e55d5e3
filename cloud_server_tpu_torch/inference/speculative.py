"""Speculative decoding's device rules: n-gram proposals, the exact
accept/residual rule and the draws it consumes (the reference's
`inference/speculative.py`, less `speculative_generate`, the contiguous
engine's batch API).

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

from cloud_server_tpu_torch.inference.sampling import sample_from_probs
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
