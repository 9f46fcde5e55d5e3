"""Text generation CLI: `python -m cloud_server_tpu_torch.generate`.

The reference's CLI on the port: weights from a training checkpoint
(`--checkpoint-dir`, `--step`; `--ema` for the EMA-averaged weights; a
LoRA run's checkpoint serves its merged weights, the adapter config
read from the checkpoint's sidecar or the `--lora-*` flags), dense or
MoE as the config says,
from a numpy `--params-npz`, or random-init from `--seed`; byte
tokenizer; int8 weight-only params (`--quantize`); the paged
continuous-batching server, optionally with the int8 KV cache
(`--kv-cache-int8`) and in-server speculation (`--spec-drafts` n-gram
drafts, or a draft model from `--draft-config` with `--serve-http`), or
the contiguous server (`--contiguous`, with `--prefix` caching). Batch
mode serves the `--prompt`s and prints them; with `--draft-config` or
`--ngram-draft` it runs the speculative batch API
(`speculative_generate`) on the contiguous engine. `--serve-http PORT`
runs the server behind the HTTP frontend until interrupted. The host
policy layer is the reference's flags: `--qos-config`, `--slo-config`,
`--fault-plan`, `--brownout`, `--anomaly-config`, `--bundle-on-anomaly`
and `--trace-sample-rate` / `--trace-capacity` /
`--trace-tail-capacity`. Runs on the card unless `--device cpu` is
given. The profiler server (`--profiler-port`; trace a live server with
POST /debug/trace) is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.generate",
        description="Generate text with the PyTorch paged server.")
    p.add_argument("--config", help="JSON config with a 'model' section")
    p.add_argument("--checkpoint-dir",
                   help="training checkpoint directory (omit: random init)")
    p.add_argument("--step", type=int, help="checkpoint step (default latest)")
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA-averaged weights from a checkpoint "
                   "trained with ema_decay > 0 (reads the checkpoint's "
                   "'ema' item — one params-sized restore)")
    p.add_argument("--params-npz", metavar="PATH",
                   help="parameters as a .npz of the reference's parameter "
                   "dict under '/'-joined keys (omit: random init from "
                   "--seed)")
    p.add_argument("--prompt", action="append", default=[],
                   help="prompt text (repeatable); '-' reads lines from stdin")
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--quantize", action="store_true",
                   help="serve with int8 weight-only quantization (the "
                   "weights are stored int8 with per-channel scales and "
                   "dequantized at each use)")
    p.add_argument("--prefix", metavar="TEXT",
                   help="shared prompt prefix (e.g. a system prompt): with "
                   "--contiguous its KV is prefilled once and cached, and "
                   "prompts extending it only run their remainder; the "
                   "paged server reuses prefixes on its own")
    p.add_argument("--kv-cache-int8", action="store_true",
                   help="store the KV cache int8-quantized (about half the "
                   "cache memory; the scales fold into the attention "
                   "math, so there is no dequantized cache copy)")
    p.add_argument("--serve-http", type=int, metavar="PORT", default=None,
                   help="instead of batch generation, run the continuous-"
                   "batching server behind the HTTP frontend (POST "
                   "/generate, /v1/completions, /v1/chat/completions; GET "
                   "/healthz, /metrics, /stats); 0 picks a free port")
    p.add_argument("--access-log", metavar="PATH", nargs="?",
                   const="stderr", default=None,
                   help="with --serve-http: structured JSON access log, "
                   "one line per request, to PATH (JSONL) or, with no "
                   "value, stderr. Off by default.")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-len", type=int, default=0,
                   help="server cache length (default: fits prompt+max-new)")
    p.add_argument("--add-bos", action="store_true",
                   help="prepend BOS to prompts (only if training data "
                   "contained BOS)")
    p.add_argument("--decode-chunk", type=int, default=1,
                   help="decode steps per scheduler iteration")
    p.add_argument("--max-slots", type=int, default=8,
                   help="concurrent request slots in the server")
    p.add_argument("--page-size", type=int, default=128,
                   help="tokens per KV page")
    p.add_argument("--num-pages", type=int, default=0,
                   help="page pool size (0 = max_slots * max_context / "
                   "page_size)")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="admission window width")
    p.add_argument("--scheduler", choices=["mixed", "alternating"],
                   default="mixed",
                   help="scheduling under admission churn: 'mixed' "
                   "(default) fuses chunked prefills and decode rows into "
                   "one token-budget program per iteration; 'alternating' "
                   "runs separate prefill-chunk and decode programs")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable the pipelined scheduler: by default the "
                   "host plans each iteration while the card runs the "
                   "previous one (mixed scheduler only)")
    p.add_argument("--mixed-token-budget", type=int, default=0,
                   help="mixed scheduler: tokens per iteration (decode "
                   "rows first, prefill fills the rest; 0 = auto: "
                   "max_slots * (decode window * decode_chunk + "
                   "prefill_chunk), i.e. work-conserving)")
    p.add_argument("--allocation", choices=["ondemand", "reserve"],
                   default="ondemand",
                   help="page policy: 'ondemand' grows chains per "
                   "dispatch and preempts the youngest slot on pool "
                   "exhaustion (higher concurrency per GB); 'reserve' "
                   "reserves prompt + max_new at admission (no "
                   "preemption)")
    p.add_argument("--spec-drafts", type=int, default=0,
                   help="in-server speculative decoding with N n-gram "
                   "draft tokens per round (exact accept rule: the "
                   "output distribution is unchanged)")
    p.add_argument("--spec-control", metavar="FILE_OR_JSON", default=None,
                   help="adaptive speculation knobs (JSON object/string "
                   "or file path: low/high accept-rate hysteresis, ewma, "
                   "cooldown, probe_period, initial draft length). "
                   "Omitted: the default adaptive controller whenever "
                   "speculation is on; 'off' pins the fixed length")
    p.add_argument("--draft-config", metavar="JSON",
                   help="speculation with a small draft model sharing the "
                   "tokenizer (JSON config, model section), proposing "
                   "--num-draft tokens per round: the speculative batch "
                   "API in batch mode, in-server speculation on the paged "
                   "server with --serve-http")
    p.add_argument("--draft-checkpoint-dir",
                   help="draft model checkpoint (omit: random init from "
                   "--seed + 1, only useful for smoke tests)")
    p.add_argument("--num-draft", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    p.add_argument("--contiguous", action="store_true",
                   help="serve through the fixed-slot contiguous server "
                   "instead of the paged server (no paging, no radix "
                   "prefix reuse, no chunked prefill, no in-server "
                   "speculation; supports --prefix caching)")
    p.add_argument("--ngram-draft", action="store_true",
                   help="batch mode: the speculative batch API with "
                   "prompt-lookup (n-gram) drafts (in-server n-gram "
                   "speculation is --spec-drafts)")
    p.add_argument("--profiler-port", type=int, default=None,
                   metavar="PORT",
                   help="the reference's profiler server for on-demand "
                   "remote capture (not ported: torch.profiler has no "
                   "in-process server; use POST /debug/trace)")
    p.add_argument("--qos-config", metavar="FILE_OR_JSON", default=None,
                   help="multi-tenant QoS: a JSON file path (or inline "
                   "JSON object) declaring per-tenant weights, priority "
                   "classes, token-bucket rate limits, pending bounds "
                   "and API-key mappings (schema: inference/qos.py); "
                   "enables weighted fair-share admission, priority "
                   "preemption and per-tenant 429s")
    p.add_argument("--slo-config", metavar="FILE_OR_JSON", default=None,
                   help="per-priority-class SLO targets (ttft/itl/"
                   "queue_wait/e2e), attainment objectives and rolling "
                   "windows (schema: inference/slo.py); surfaced via GET "
                   "/slo and the slo_attainment/slo_burn_rate gauges")
    p.add_argument("--fault-plan", metavar="FILE_OR_JSON", default=None,
                   help="deterministic fault injection: named fault sites "
                   "(submit_reject/dispatch/iteration_stall/wedge/"
                   "alloc_famine) with seeded after/count/p windows "
                   "(schema: inference/faults.py)")
    p.add_argument("--brownout", metavar="FILE_OR_JSON", default=None,
                   help="overload brownout (needs --qos-config): "
                   "OverloadDetector thresholds over pending age, budget "
                   "utilization and host_gap_frac, hysteresis and "
                   "per-level shed classes (schema: inference/faults.py)")
    p.add_argument("--trace-sample-rate", type=float, default=0.0,
                   metavar="RATE",
                   help="per-request tracing: head-sampling probability "
                   "in [0, 1] (span trees at GET /debug/requests/<id>, "
                   "Perfetto export at GET /traces, W3C traceparent in "
                   "and out); 0 disables it unless --trace-tail-capacity "
                   "keeps a tail ring")
    p.add_argument("--trace-capacity", type=int, default=256,
                   metavar="N",
                   help="finished-trace ring size (default 256)")
    p.add_argument("--trace-tail-capacity", type=int, default=0,
                   metavar="N",
                   help="tail retention: keep up to N span trees of "
                   "anomalous head-unsampled requests (failed, deadline-"
                   "expired, cancelled, SLO-violating, repeatedly "
                   "preempted, or finished in an open anomaly window); "
                   "0 disables it")
    p.add_argument("--anomaly-config", metavar="FILE_OR_JSON",
                   default=None,
                   help="anomaly watchdog (inference/anomaly.py): rule "
                   "thresholds, hysteresis hold and the optional "
                   "capture_iters/capture_dir arm of the /debug/trace "
                   "window; {} enables every rule at defaults")
    p.add_argument("--bundle-on-anomaly", action="store_true",
                   help="auto-capture a debug bundle (GET /debug/bundle "
                   "schema) into a bounded ring each time a watchdog "
                   "rule fires (needs --anomaly-config)")
    p.add_argument("--flight-recorder", type=int, default=0, metavar="N",
                   help="per-iteration flight-recorder ring size for "
                   "/stats post-mortems (0 = config default)")
    p.add_argument("--no-iteration-profile", action="store_true",
                   help="disable the iteration-phase profiler (on by "
                   "default: per-iteration sweep/admission/build/device/"
                   "commit/epilogue attribution in flight records, the "
                   "cloud_server_iter_phase_ms histograms, /stats "
                   "iteration_profile and GET /debug/scheduler_trace)")
    p.add_argument("--decode-impl", choices=["xla", "pallas"], default=None,
                   help="cached-attention implementation: 'pallas' selects "
                   "the CUDA paged-attention kernel, 'xla' the plain "
                   "PyTorch gather + attention")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the "
                   "CPU)")
    from cloud_server_tpu_torch.models.lora import add_lora_args
    add_lora_args(p)
    return p


def load_params(model_cfg, checkpoint_dir: str | None, step: int | None,
                seed: int, device, loss_fn_module=None):
    """Params-only restore of a training checkpoint (no optimizer-moment
    reads) on `device`; random init from `seed` without one.
    `loss_fn_module` is the family (of model_cfg by default)."""
    from cloud_server_tpu_torch.models import moe
    from cloud_server_tpu_torch.training.checkpoint import restore_params
    module = loss_fn_module or moe.module_for(model_cfg)
    if checkpoint_dir is None:
        print("[generate] no --checkpoint-dir; using random init",
              file=sys.stderr)
        return module.init_params(model_cfg, seed, device=device)
    return restore_params(checkpoint_dir, model_cfg, step=step,
                          device=device, loss_fn_module=module)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.config import (InferConfig, ModelConfig,
                                               from_json)
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    from cloud_server_tpu_torch.inference.server import InferenceServer
    from cloud_server_tpu_torch.models import transformer

    device = resolve_device(args.device)
    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    model_cfg = from_json(ModelConfig, raw.get("model", {}))
    if args.kv_cache_int8:
        model_cfg = dataclasses.replace(model_cfg, kv_cache_dtype="int8")
    if args.decode_impl is not None:
        if args.contiguous and args.decode_impl != "xla":
            raise SystemExit(
                "--decode-impl pallas needs the paged server; drop "
                "--contiguous")
        model_cfg = dataclasses.replace(
            model_cfg, decode_attention_impl=args.decode_impl)
    if args.spec_drafts and args.contiguous:
        raise SystemExit(
            "--spec-drafts is the paged server's in-server speculation; "
            "it cannot run with --contiguous (use --ngram-draft/"
            "--draft-config for the batch API instead)")
    if args.spec_drafts and args.ngram_draft:
        raise SystemExit(
            "--spec-drafts (in-server n-gram) and --ngram-draft (batch "
            "API) are mutually exclusive speculation paths")
    if args.profiler_port is not None:
        from cloud_server_tpu_torch.utils.tracing import (
            start_profiler_server)
        start_profiler_server(args.profiler_port)  # raises
    tok = ByteTokenizer()
    if tok.vocab_size > model_cfg.vocab_size:
        raise SystemExit(
            f"tokenizer vocab ({tok.vocab_size}) exceeds model vocab "
            f"({model_cfg.vocab_size})")
    prompts = []
    for prm in args.prompt:
        if prm == "-":
            prompts.extend(line.rstrip("\n") for line in sys.stdin)
        else:
            prompts.append(prm)
    if not prompts and args.serve_http is None:
        raise SystemExit("no prompts (use --prompt, repeatable, or '-')")

    if args.params_npz and args.checkpoint_dir:
        raise SystemExit("--params-npz and --checkpoint-dir are mutually "
                         "exclusive")
    from cloud_server_tpu_torch.models import moe
    from cloud_server_tpu_torch.models.lora import (
        export_merged, load_lora_config, lora_config_from_args,
        make_lora_module)
    lcfg = lora_config_from_args(args)
    if args.checkpoint_dir:
        saved = load_lora_config(args.checkpoint_dir)
        if saved is not None:
            # the sidecar written at training time is authoritative: a
            # mismatched alpha would silently rescale the adapters
            if lcfg is not None and lcfg != saved:
                raise SystemExit(
                    f"--lora-* flags {lcfg} contradict the checkpoint's "
                    f"recorded LoRA config {saved}; drop the flags (the "
                    "sidecar is used automatically)")
            lcfg = saved
    if args.ema:
        if args.params_npz or lcfg is not None:
            raise SystemExit("--ema applies to framework checkpoints "
                             "without LoRA flags")
        if not args.checkpoint_dir:
            raise SystemExit("--ema needs --checkpoint-dir")
        from cloud_server_tpu_torch.training.checkpoint import (
            restore_ema_params)
        try:
            params = restore_ema_params(args.checkpoint_dir, model_cfg,
                                        step=args.step, device=device)
        except FileNotFoundError as e:
            raise SystemExit(str(e))
    elif args.params_npz:
        params = transformer.params_from_npz(args.params_npz, model_cfg,
                                             device)
    elif lcfg is not None:
        lora_module = make_lora_module(
            lcfg, base_module=moe.module_for(model_cfg))
        params = export_merged(
            load_params(model_cfg, args.checkpoint_dir, args.step,
                        args.seed, device, loss_fn_module=lora_module),
            lcfg)
    else:
        params = load_params(model_cfg, args.checkpoint_dir, args.step,
                             args.seed, device)
    if args.quantize:
        from cloud_server_tpu_torch.models.quantization import (
            quantize_params)
        params = quantize_params(params)
    infer_cfg = InferConfig(
        max_decode_len=args.max_new, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        eos_token_id=tok.eos_id, pad_token_id=tok.pad_id or 0,
        trace_capacity=args.trace_capacity,
        trace_tail_capacity=args.trace_tail_capacity,
        bundle_on_anomaly=args.bundle_on_anomaly)

    def load_draft():
        """The draft model (--draft-config) for in-server speculation on
        the paged server: the reference's init from --seed + 1 unless a
        checkpoint is given. Returns (params, cfg) or (None, None)."""
        if not args.draft_config or args.contiguous:
            return None, None
        with open(args.draft_config) as f:
            draft_cfg = from_json(ModelConfig, json.load(f).get("model", {}))
        return load_params(draft_cfg, args.draft_checkpoint_dir, None,
                           args.seed + 1, device), draft_cfg

    def make_server(max_len: int, max_slots: int):
        """The serving backend: paged by default, contiguous on
        --contiguous. Same client API either way."""
        policy = dict(
            qos=args.qos_config, slo=args.slo_config,
            tracing=args.trace_sample_rate or None,
            faults=args.fault_plan, anomaly=args.anomaly_config,
            overlap=False if args.no_overlap else None,
            iteration_profile=(False if args.no_iteration_profile
                               else None), device=device)
        if args.contiguous:
            prefix_toks = (tok.encode(args.prefix,
                                      add_bos=args.add_bos
                                      and tok.bos_id is not None)
                           if args.prefix else None)
            return InferenceServer(
                params, model_cfg, infer_cfg, max_slots=max_slots,
                max_len=max_len, seed=args.seed,
                decode_chunk=args.decode_chunk,
                prefix_tokens=prefix_toks, **policy)
        if args.prefix:
            print("[generate] note: the paged server reuses shared "
                  "prefixes automatically (radix page cache); --prefix "
                  "needs no pre-registration — prompts that start with "
                  "the prefix text hit the cache after the first request",
                  file=sys.stderr)
        ps = args.page_size
        max_context = -(-max_len // ps) * ps  # round up to a page multiple
        prefill_chunk = -(-max(ps, args.prefill_chunk) // ps) * ps
        draft_params, draft_cfg = load_draft()
        spec = args.spec_drafts
        if draft_cfg is not None and spec == 0:
            spec = args.num_draft  # --draft-config implies speculation
        return PagedInferenceServer(
            params, model_cfg, infer_cfg, max_slots=max_slots,
            max_context=max_context, page_size=ps,
            num_pages=args.num_pages or None,
            decode_chunk=args.decode_chunk, prefill_chunk=prefill_chunk,
            seed=args.seed, scheduler=args.scheduler,
            allocation=args.allocation,
            mixed_token_budget=args.mixed_token_budget,
            spec_drafts=spec, spec_control=args.spec_control,
            draft_params=draft_params, draft_cfg=draft_cfg,
            flight_recorder_size=args.flight_recorder or None,
            brownout=args.brownout,
            tokenizer=tok,  # regex-constrained requests compile against it
            **policy)

    if args.serve_http is not None:
        if args.ngram_draft or (args.draft_config and args.contiguous):
            raise SystemExit(
                "--ngram-draft is batch-mode only (the serving "
                "equivalent is --spec-drafts), and --draft-config "
                "serving needs the paged server (drop --contiguous)")
        serve_http(make_server(args.max_len or model_cfg.max_seq_len,
                               args.max_slots),
                   tok, args.serve_http, args.access_log)
        return
    encoded = [tok.encode(p, add_bos=args.add_bos
                          and tok.bos_id is not None) or [0]
               for p in prompts]
    longest = max(len(e) for e in encoded)
    if args.draft_config or args.ngram_draft:
        rows = speculative_batch(args, params, model_cfg, infer_cfg,
                                 encoded, device)
        for prompt, row in zip(prompts, rows):
            print(f"=== {prompt!r}")
            print(tok.decode(row))
        return
    max_len = args.max_len or min(model_cfg.max_seq_len,
                                  longest + args.max_new +
                                  (0 if args.contiguous
                                   else args.spec_drafts + 1))
    srv = make_server(max_len, min(args.max_slots, len(encoded)))
    outs = srv.generate(encoded, max_new_tokens=args.max_new)
    for prompt, out in zip(prompts, outs):
        print(f"=== {prompt!r}")
        print(tok.decode(out))


def speculative_batch(args, params, model_cfg, infer_cfg, encoded,
                      device) -> list[list[int]]:
    """Batch mode with --draft-config or --ngram-draft: the speculative
    batch API on the contiguous engine, with the reference's refusals,
    its --max-new clamp to the cache (prompt + new tokens + the window's
    overhang) and its output rule (cut at EOS, strip trailing pads
    only). Returns one token list per prompt."""
    import numpy as np
    import torch

    from cloud_server_tpu_torch.config import ModelConfig, from_json
    from cloud_server_tpu_torch.inference.speculative import (
        speculative_generate)
    from cloud_server_tpu_torch.utils import prng
    if args.quantize:
        raise SystemExit("--quantize + speculative decoding not "
                         "supported yet")
    if args.draft_config and args.ngram_draft:
        raise SystemExit("--draft-config and --ngram-draft are "
                         "mutually exclusive draft sources")
    if args.prefix:
        raise SystemExit(
            "--prefix is a serving-path feature; the speculative "
            "batch path would silently ignore it")
    draft_cfg = draft_params = None
    if args.draft_config:
        with open(args.draft_config) as f:
            draft_cfg = from_json(ModelConfig, json.load(f).get("model", {}))
        draft_params = load_params(draft_cfg, args.draft_checkpoint_dir,
                                   None, args.seed + 1, device)
    longest = max(len(e) for e in encoded)
    cap = args.max_len or model_cfg.max_seq_len
    budget = cap - longest - args.num_draft - 1
    if budget < 1:
        raise SystemExit(
            f"prompt ({longest}) + speculative window "
            f"({args.num_draft + 1}) leaves no room to decode within "
            f"max_len={cap}; raise --max-len or shorten the prompt")
    max_new = min(args.max_new, budget)
    if max_new < args.max_new:
        print(f"[generate] clamping --max-new {args.max_new} -> "
              f"{max_new} to fit max_len={cap}", file=sys.stderr)
        infer_cfg = dataclasses.replace(infer_cfg, max_decode_len=max_new)
    padded = np.zeros((len(encoded), longest), np.int64)
    for i, e in enumerate(encoded):
        padded[i, :len(e)] = e
    toks = speculative_generate(
        params, draft_params, torch.from_numpy(padded).to(device),
        prng.key(args.seed), cfg=model_cfg, draft_cfg=draft_cfg,
        infer_cfg=infer_cfg, num_draft=args.num_draft,
        max_len=longest + max_new + args.num_draft + 1,
        prompt_lengths=torch.tensor([len(e) for e in encoded],
                                    device=device))
    rows = []
    for row in toks.tolist():
        if infer_cfg.eos_token_id >= 0 and infer_cfg.eos_token_id in row:
            row = row[:row.index(infer_cfg.eos_token_id)]
        # only TRAILING pads are padding; a mid-stream token equal to
        # pad_token_id is real output
        while row and row[-1] == infer_cfg.pad_token_id:
            row.pop()
        rows.append(row)
    return rows


def serve_http(srv, tok, port: int, access_log: str | None) -> None:
    """Run `srv` behind the HTTP frontend on 127.0.0.1:`port` until
    interrupted, then stop both."""
    import signal

    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    srv.start()
    front = HttpFrontend(srv, tokenizer=tok, port=port,
                         access_log=(True if access_log == "stderr"
                                     else access_log)).start()
    host, bound = front.address
    print(f"[generate] serving on http://{host}:{bound} — try:\n"
          f"  curl -N -s {host}:{bound}/generate "
          "-d '{\"prompt\": \"hello\"}'", file=sys.stderr, flush=True)
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        front.stop()
        srv.stop()


if __name__ == "__main__":
    main()
