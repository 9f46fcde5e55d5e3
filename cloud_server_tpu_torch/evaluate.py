"""Evaluation harness: corpus perplexity and per-request loglikelihood
scoring (the lm-eval-style primitive under multiple-choice accuracy).

The port of the reference's `evaluate.py`, on `training/eval.py`'s eval
step and the model family's forward. Two entry points, teacher-forced
and under torch.no_grad:

  * `perplexity(params, cfg, data_path)` — streams a flat binary token
    file (`data/tokenizer.prepare_corpus` format) through the eval step
    (`next_token_loss`, every auxiliary coefficient 0) in fixed (B, S)
    windows and reports token-mean NLL and perplexity (and, from the
    CLI with the byte tokenizer, bits-per-byte). With ce_impl="pallas"
    on the card the loss runs the fused CE forward kernel.
  * `loglikelihoods(params, cfg, pairs)` — scores (context,
    continuation) token pairs: sum log P(continuation | context) under
    teacher forcing plus whether the continuation is the greedy argmax
    at every position (`is_greedy`). Pairs are bucketed to power-of-two
    lengths and padded to a fixed batch, as the reference buckets them,
    so the scores are the same.

The device is the parameters' (CUDA unless the caller loaded them on the
CPU). CLI (`python -m cloud_server_tpu_torch.evaluate`):

  # corpus perplexity
  python -m cloud_server_tpu_torch.evaluate --config cfg.json \
      --checkpoint-dir ckpt --data val.bin
  # loglikelihood / greedy-match scoring of JSONL requests
  python -m cloud_server_tpu_torch.evaluate --config cfg.json \
      --checkpoint-dir ckpt --requests reqs.jsonl --tokenizer byte

Each `--requests` line is {"context": str, "continuation": str} (or
"context_tokens"/"continuation_tokens" id lists). Output is one JSON
line: aggregate for --data, per-request list + accuracy-style summary
for --requests. `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import json
import math
from typing import Sequence

import numpy as np
import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import moe
from cloud_server_tpu_torch.training.eval import make_eval_step


def _device(params) -> torch.device:
    return params["embed"]["tokens"].device


def _logits(params, tokens: torch.Tensor, cfg: ModelConfig):
    """(B, S) -> (B, S, V) f32 logits of the config's model family."""
    out = moe.module_for(cfg).forward(params, tokens, cfg)
    return out[0] if isinstance(out, tuple) else out


@torch.no_grad()
def _score_pairs(params, tokens: torch.Tensor, ctx_lens: torch.Tensor,
                 total_lens: torch.Tensor, cfg: ModelConfig):
    """Teacher-forced continuation scoring.

    tokens: (B, S) = context + continuation + pad. Position i's logits
    predict token i+1; continuation tokens live at positions
    [ctx_len, total_len), so their scores come from positions
    [ctx_len - 1, total_len - 1).

    Returns (sum_logprob (B,) f32, is_greedy (B,) bool).
    """
    lp = torch.log_softmax(_logits(params, tokens, cfg).float(), dim=-1)
    s = lp.shape[1]
    targets = tokens[:, 1:]
    tok_lp = torch.gather(lp[:, :-1], -1, targets[..., None])[..., 0]
    greedy = lp[:, :-1].argmax(-1) == targets
    pos = torch.arange(s - 1, device=tokens.device)[None, :]
    is_cont = (pos >= (ctx_lens - 1)[:, None]) & (
        pos < (total_lens - 1)[:, None])
    sum_lp = torch.where(is_cont, tok_lp, 0.0).sum(dim=1)
    all_greedy = torch.where(is_cont, greedy, True).all(dim=1)
    return sum_lp, all_greedy


def perplexity(params, cfg: ModelConfig, data_path: str, *,
               batch_size: int = 8, seq_len: int | None = None,
               max_batches: int | None = None) -> dict:
    """Corpus perplexity over a flat binary token file."""
    from cloud_server_tpu_torch.data.dataset import MemmapTokenDataset
    seq_len = seq_len or cfg.max_seq_len
    ds = MemmapTokenDataset(data_path, seq_len)
    n_batches = len(ds) // batch_size  # full batches only: static shapes
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    if n_batches == 0:
        raise ValueError(
            f"{data_path}: {len(ds)} windows of {seq_len} tokens cannot "
            f"fill one batch of {batch_size}")
    step = make_eval_step(cfg)
    dev = _device(params)
    nll = torch.zeros((), dtype=torch.float64, device=dev)
    total_tokens = 0
    for bi in range(n_batches):
        rows = np.stack([ds[bi * batch_size + i]["tokens"]
                         for i in range(batch_size)]).astype(np.int64)
        out = step(params, {"tokens": torch.from_numpy(rows).to(dev)})
        nll += out["nll_sum"].double()
        total_tokens += batch_size * (seq_len - 1)
    loss = float(nll) / max(total_tokens, 1)
    return {"loss": loss, "ppl": math.exp(min(loss, 80.0)),
            "tokens": total_tokens, "windows": n_batches * batch_size}


def _pow2(n: int, lo: int = 16) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def loglikelihoods(params, cfg: ModelConfig,
                   pairs: Sequence[tuple[Sequence[int], Sequence[int]]],
                   *, batch_size: int = 8) -> list[dict]:
    """Score (context_tokens, continuation_tokens) pairs.

    Sequences longer than cfg.max_seq_len keep their TAIL (the
    continuation must stay intact; leading context is dropped — the
    lm-eval convention). Returns one {"sum_logprob", "is_greedy",
    "num_tokens"} per pair, in order.
    """
    prepared = []  # (orig_idx, tokens, ctx_len, total_len)
    for i, (ctx, cont) in enumerate(pairs):
        ctx, cont = list(ctx), list(cont)
        if not cont:
            raise ValueError(f"request {i}: empty continuation")
        if not ctx:
            # unconditional loglikelihood still needs one input position
            # to predict the first continuation token from; condition on
            # token 0 (the BOS/pad convention), as the reference does
            ctx = [0]
        total = ctx + cont
        if len(total) > cfg.max_seq_len:
            drop = len(total) - cfg.max_seq_len
            if drop >= len(ctx):
                raise ValueError(
                    f"request {i}: continuation of {len(cont)} tokens "
                    f"cannot fit max_seq_len={cfg.max_seq_len}")
            ctx = ctx[drop:]
            total = ctx + cont
        prepared.append((i, total, len(ctx), len(total)))

    # bucket by padded length; fixed batch rows, as the reference's
    by_bucket: dict[int, list] = {}
    for item in prepared:
        by_bucket.setdefault(
            _pow2(min(len(item[1]), cfg.max_seq_len)), []).append(item)
    dev = _device(params)
    out: list[dict | None] = [None] * len(prepared)
    for s, items in sorted(by_bucket.items()):
        for start in range(0, len(items), batch_size):
            chunk = items[start:start + batch_size]
            rows = np.zeros((batch_size, s), np.int64)
            ctx_lens = np.ones((batch_size,), np.int64)
            total_lens = np.ones((batch_size,), np.int64)
            for r, (_, toks, cl, tl) in enumerate(chunk):
                rows[r, :len(toks)] = toks
                ctx_lens[r] = cl
                total_lens[r] = tl
            sum_lp, greedy = _score_pairs(
                params, *(torch.from_numpy(x).to(dev)
                          for x in (rows, ctx_lens, total_lens)), cfg)
            sum_lp, greedy = sum_lp.cpu().numpy(), greedy.cpu().numpy()
            for r, (orig, toks, cl, tl) in enumerate(chunk):
                out[orig] = {"sum_logprob": float(sum_lp[r]),
                             "is_greedy": bool(greedy[r]),
                             "num_tokens": tl - cl}
    return out


def _load_requests(path: str, tokenizer) -> list[tuple[list, list]]:
    pairs = []
    with open(path) as f:
        for ln, line in enumerate(f):
            if not line.strip():
                continue
            req = json.loads(line)
            if "context_tokens" in req or "continuation_tokens" in req:
                if "continuation_tokens" not in req:
                    raise ValueError(
                        f"{path}:{ln + 1}: context_tokens without "
                        "continuation_tokens")
                pairs.append((list(req.get("context_tokens", [])),
                              list(req["continuation_tokens"])))
            else:
                if tokenizer is None:
                    raise ValueError(
                        f"{path}:{ln + 1}: text requests need --tokenizer")
                pairs.append((tokenizer.encode(req.get("context", "")),
                              tokenizer.encode(req["continuation"])))
    if not pairs:
        raise ValueError(f"{path}: no requests")
    return pairs


def main(argv=None) -> None:
    import argparse

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.config import from_json
    from cloud_server_tpu_torch.generate import load_params

    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.evaluate",
        description="Perplexity / loglikelihood evaluation.")
    p.add_argument("--config", required=True,
                   help="JSON config with the model section")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--step", type=int)
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA-averaged weights")
    p.add_argument("--data", help="flat binary token file -> perplexity")
    p.add_argument("--requests",
                   help="JSONL context/continuation requests -> "
                        "loglikelihoods")
    p.add_argument("--tokenizer", default=None,
                   help='"byte" (text requests; HF tokenizers are not '
                        "ported yet)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int,
                   help="perplexity window (default: model max_seq_len)")
    p.add_argument("--max-batches", type=int,
                   help="cap perplexity batches (quick looks)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the "
                   "CPU)")
    args = p.parse_args(argv)
    if not args.data and not args.requests:
        p.error("pass --data and/or --requests")

    device = resolve_device(args.device)
    with open(args.config) as f:
        model_cfg = from_json(ModelConfig, json.load(f)["model"])
    if args.ema:
        if args.checkpoint_dir is None:
            p.error("--ema needs --checkpoint-dir")
        from cloud_server_tpu_torch.training.checkpoint import (
            restore_ema_params)
        params = restore_ema_params(args.checkpoint_dir, model_cfg,
                                    step=args.step, device=device)
    else:
        params = load_params(model_cfg, args.checkpoint_dir, args.step,
                             args.seed, device)
    tokenizer = None
    if args.tokenizer:
        from cloud_server_tpu_torch.data.tokenizer import get_tokenizer
        tokenizer = get_tokenizer(args.tokenizer)

    result: dict = {}
    if args.data:
        result["perplexity"] = perplexity(
            params, model_cfg, args.data, batch_size=args.batch_size,
            seq_len=args.seq_len, max_batches=args.max_batches)
        if tokenizer is not None and getattr(tokenizer, "vocab_size",
                                             0) == 259:
            # byte tokenizer: tokens ARE bytes -> bits-per-byte
            result["perplexity"]["bits_per_byte"] = (
                result["perplexity"]["loss"] / math.log(2))
    if args.requests:
        pairs = _load_requests(args.requests, tokenizer)
        scores = loglikelihoods(params, model_cfg, pairs,
                                batch_size=args.batch_size)
        result["requests"] = scores
        result["summary"] = {
            "n": len(scores),
            "mean_logprob": (sum(s["sum_logprob"] for s in scores)
                             / len(scores)),
            "greedy_frac": (sum(s["is_greedy"] for s in scores)
                            / len(scores))}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
