#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together), then runs these phases and prints one JSON line for
each:

  1. device   — the card, its power limit (nvidia-smi), the build time
                and every kernel's registers, spills and shared memory;
  2. kernel   — the two paged-attention kernels against their plain
                PyTorch version on the card at Llama-3.1-8B's head shapes
                (the narrow kernel: decode and verify windows of 32 and
                5; the wide kernel: prefill and a ragged mixed batch with
                a length-0 slot) and at Llama-3.2-1B's head dim 64
                (decode, prefill), and at one tensor-parallel rank's
                share of the heads (KH 4 and KH 2: decode, prefill),
                the kernel timed warm from a CUDA
                graph in turns with one PyTorch library call (SDPA), and
                cold (decode, prefill: a rotation over layers whose K/V
                bytes exceed 4x the L2), beside the plain version's time
                and the card's lower bound; then each case again on the int8 cache
                (kernel_int8 lines: against the int8 plain version, beside
                the bf16 kernel's time, SDPA over the dequantized cache as
                the library yardstick);
     train_kernel — the four flash-attention kernels (forward, dK/dV,
                dQ, fused backward) against the plain version at
                Llama-3.1-8B's head shapes: blocked cases (S 2048; packed
                with segment ids; head dim 64), fused cases (S 1024; the
                same three), S 1984 (a partial 128-row tile), S 1000 and
                S 2000 (padded by the wrapper); each kernel timed in
                turns with SDPA (the blocked pair dK/dV + dQ as a whole
                too);
     unembed  — the f32-logit unembed (bf16 operands) and its backward
                against the widened f32 product at the train shapes;
     ce_kernel — the fused-CE kernels (B7 statistics, B8 d and dx) against
                their plain version at N 8192 x D 4096 x V 128256, timed
                in turns with the cuBLAS products alone (the library
                yardstick) and beside their bound;
     ptrain_kernel — the flash kernels on one tp 2 rank's heads (H 16,
                KH 4, S 2048) and on Ulysses' H/sp heads over the whole
                sequence (S 1024), the fused-CE kernels on one tp 2
                rank's 64128 vocabulary rows and a tp 4 rank's 32064
                (padded to 32128, the pad masked); the flash kernels on
                one pipeline stage's microbatch (B 2, S 2048) and beside
                the experts over ep (B 4), the fused CE at Mixtral's
                vocabulary (N 8192, V 32000): each against its plain
                version and timed as above;
  3. serve    — PagedInferenceServer at the full Llama-3.1-8B width (all
                32 layers, random bf16 weights from a seed) on the path a
                user gets: the mixed scheduler, the overlap pipeline and
                one captured CUDA graph per program shape, serving 8
                greedy requests (the kernels' counts read right after
                it, replays included); the same requests then give the
                same tokens with graphs off (every program launched
                eagerly) and on a second fresh server; a 2-layer slice of
                the model must give the plain dense forward's logits
                through the paged kernel path; under the alternating
                scheduler (programs of other shapes) each request's
                tokens are the same up to a divergence at a near tie
                (both tokens within the run's 25th-percentile top-2 gap
                of the dense forward's top logit), and on a 2-layer
                float32 slice token for token; on the first 8 layers, 8
                server-global seeded requests, and 8 requests each with
                its own seed and top-p, give the same tokens graphed and
                with graphs off, and steady seeded decode steps of both
                graphed servers are timed;
     profile  — on the served server, pipelined mixed steps (admissions
                landing) and steady decode steps (8 live slots), several
                of each under torch.profiler: per step the wall time,
                the host's launch API calls (kernels and graphs), the
                device kernels, busy time and idle share, the busiest
                kernels;
     policy   — a fresh server with every policy of the host layer
                configured (QoS over three tenants with DRR admission,
                SLO tracking, tracing at 100% with a tail ring,
                brownout, the anomaly watchdog arming a profiler window
                and a debug bundle, a seeded fault plan): 12 requests,
                4 a tenant, the plain tokens up to near ties and the
                DRR admission order (the first two steps' captures
                inside a profiler window); one steady decode step under
                torch.profiler against the plain one (1 graph launch,
                the same kernel count, busy within 3%); three 1 ms
                deadlines firing deadline_spike (a bundle, a 2-step
                trace with the narrow kernel's events); two 100 ms
                stalls; the routes over HttpFrontend and POST
                /debug/trace; a dispatch fault with a dispatch in
                flight failing every request, stop() returning;
     serve_int8 — the same 8 requests on the int8 KV cache (same params):
                the pool's bytes against the bf16 pool's, the int8
                kernels' launches and no plain call, the same tokens with
                graphs off, the share of tokens equal to the bf16 run; a
                2-layer slice through the int8 kernel against the int8
                plain path; the profile; then HttpFrontend on 127.0.0.1
                over that server (its programs captured) with 8 fresh
                requests streamed concurrently through /v1/completions
                (32 tokens and [DONE] each, /metrics counting them,
                /v1/embeddings answering the in-process vectors) and the
                client's TTFT and ITL,
                then the same prompts in process on a fresh server with
                graphs off (the share of tokens equal reported);
     spec     — in-server speculation (4 drafts a round, fixed length)
                at the same width and requests: n-gram drafts, then a
                Llama-3.2-1B-width draft model on its own pools (the
                kernels' counts read over both: B1 on the W 5 verify
                windows, both kernels at the draft's head dim 64), each
                held against the plain greedy tokens by the near-tie
                rule, with its acceptance, its capture cost and one
                steady step under torch.profiler (the tokens it
                commits); the target drafting for itself (its own
                pools; steady acceptance >= 0.9 on a 2-layer float32
                slice; in bf16 at full depth every rejected draft at a
                near tie and >= 0.8 accepted); on the first 8 layers, 8
                seeded requests with penalties, logit_bias and min_tokens
                through n-gram speculation under the adaptive controller,
                graphed == graphs off, then a regex request in process,
                a second pattern registered while its decode dispatch is
                in flight (that program released only after its commit),
                and response_format json_object over HTTP, each held
                against its DFA;
     fleet    — two replicas of the serve phase's server on one copy of
                the weights behind the replica router: a migrating drain
                of the 8 requests (pages read back bit-equal, export and
                import GB/s beside a pinned copy of the same bytes),
                prefill/decode handoffs (the exposed ms and its split,
                the share of pages the prefetch copied), a failover
                with each replica on its own scheduler thread
                (completed_frac, the breaker's time), an int8 round trip
                (scale pools bit-equal); the tokens held against the serve
                phase's by the near-tie rule, B1 and B2 counted;
     elastic  — at the same width and weights: allocation="reserve"
                (pages reserved at admission, no preemption, the near-tie
                rule); `embed` on both attention routes (B3 launched 32
                times a (bucket, rows) group on the flash one, cosine >=
                0.999, unit norms, /v1/embeddings), B3 timed at the
                embed's shapes; two random adapters (rank 16 on all seven
                targets, rank 8 on the attention ones) in one batch with
                base rows (base tokens exact, adapted ones against merged
                weights by the near-tie rule), a steady all-adapted step
                profiled in turns with a plain one, an adapter outgrowing
                the stacks while a dispatch is in flight (released after
                its commit, recaptured); the reference bench's autoscaled
                arm — one replica and a spare behind the router, the
                SLOBurnAutoscaler, a 30 s diurnal burst replayed by
                ReplayDriver, the burst at ELASTIC_BURST_X times the rate
                R at which a server completes the scenario's requests
                (measured first on the spare): nothing lost, a scale-up
                and a migrating scale-down, R, the burst's rate and the
                highest queue a replica saw printed — then FleetSim
                calibrated from the replicas' flight records against the
                live attainment;
     tp       — after the serve phase (and its contiguous part):
                tensor-parallel serving at tp 2 (one process a rank,
                `parallel.spawn_ranks`; NCCL with one rank a card and
                graphs on where there are two cards, else both ranks on
                card 0 over gloo with graphs off, printed as backend,
                cards and graphs) on the serve phase's weights, shared
                with the ranks as CUDA memory: the 8 greedy requests
                (all 32 layers on NCCL, the first 8 on one card)
                against the one-card tokens by the near-tie rule (and
                graphed == graphs off on NCCL), a
                2-layer float32 slice token for token, the int8 cache
                against serve_int8's tokens, an n-gram run (committed
                tokens a round); each rank's B1/B2 launches (> 0 on every
                rank), weight and pool bytes and peak memory; a steady
                decode step's wall time (rank 0) and device span per
                rank; the median host time of rank 0's per-dispatch
                broadcast;
  4. train    — the training CLI (`cloud_server_tpu_torch.train.main`)
                at Llama-3.1-8B's widths cut to 8 layers (f32 masters,
                bf16 compute, flash attention, full remat): 6 steps at
                S 2048, then 2 steps at S 1024 (the fused backward), then
                6 steps at S 2048 with the fused CE (ce_impl "pallas")
                and evaluation every 3 steps over 2 batches of a token
                file; the kernels' launch counts against layers x steps
                (+ evaluations); one step of each S 2048 run under
                torch.profiler; 2-layer slices whose loss and gradients
                match the plain attention and the dense CE;
     pack     — the same widths on packed rows (documents of 64-2048
                seeded tokens, `data.packing.pack_documents`): dense and
                fused-CE steps in turns with unpacked steps of the same
                state (packing efficiency, B3-B5 and B7/B8 launches a
                step, step time, busy share, peak memory); a 2-layer f32
                packed row whose loss and gradients equal its documents
                run alone (1e-5); remat "full", "dots" and "attn" (step
                time, peak memory, B3 a step, equal losses);
                `evaluate.perplexity` over a `prepare_corpus` file and
                `loglikelihoods`; the native reader (it must build)
                bit-equal to the numpy path, rows/s of each;
     ptrain   — parallel training at the fused-CE config's widths cut
                to 2 layers: two ranks on card 0 over gloo (their
                collectives through mailboxes on the card), one spawn
                running 2-3 steps each at fsdp 2, tp 2, sp 2 with
                Ulysses and with the ring, pp 2 (the pipelined loss, one
                layer a stage, 2 microbatches), rank-16 adapters at
                fsdp 2, and Mixtral-8x7B's widths (1 layer) with its
                experts over ep 2,
                each from the seeded weights against the one-rank step
                on the same state and batch (losses, gradient norms,
                first moments, every parameter against its update's
                norm, and a control: the one-rank run with one tp-split
                leaf's gradient doubled must fail those checks; a first
                float32 step at a cut width: loss, first moments,
                parameters), B3-B8 launched
                on every rank, each rank's weight and state bytes, peak
                and step times;
     dryrun   — `graft_entry.dryrun_multichip(2)`: the reference's eight
                families (dense, ring and Ulysses sp, MoE over ep, a
                hybrid mesh, the pipeline, tp paged serving with B1/B2,
                the two-replica router), both ranks on card 0 over gloo;
  5. ckpt     — 1 layer at full width with the fused CE: 4 steps
                straight; 2 steps with an async checkpoint, restored bit
                for bit; a resumed run to 4 against the straight run;
                the checkpoint served (restored params and
                `generate --checkpoint-dir`) with the in-memory params'
                tokens; bytes and write/read rates;
     hf       — that checkpoint exported by `convert` to a HuggingFace
                directory (config.json + float32 model.safetensors;
                bytes, write and fsync GB/s), read back by
                `load_hf_checkpoint` bit-equal to `restore_params` with
                its structural config fields equal (read GB/s, warm),
                served by `generate --hf-checkpoint` with the ckpt
                phase's `--checkpoint-dir` text, then with
                `--decode-impl pallas` (B1 and B2 counted, the text of
                `--checkpoint-dir --decode-impl pallas`); `graft_entry.
                entry()` on the card (its forward's time, the logits'
                shape);
  6. moe      — Mixtral-8x7B's public config, random weights: its first
                8 layers in bf16 on the default paged server
                (B1/B2 counted, graphed == graphs off, the tokens
                teacher-forced against the plain MoE forward, nothing
                dropped, the expert load, a steady decode round against
                the weights' read bound), the contiguous server (B3) and
                n-gram speculation on the same weights; the three exact
                on a 2-layer float32 slice; int8 weights (4 layers equal
                to the dequantized bf16 weights; 16 layers, drawn and
                quantized a layer at a time, served and profiled);
                training at 2 layers (dense CE at S 2048, fused CE at S
                1024: B3-B8, the loss falling, MFU over the active and the
                computed expert FLOPs, a narrow float32 slice against the
                CPU); then LoRA rank 16 on the ckpt phase's checkpoint
                (`train --lora-rank --init-from`: the base bit for bit,
                adapter moments only; `generate --checkpoint-dir` serving
                the merged weights);
  7. kernels  — each ported kernel with the TPU kernel it replaces, its
                launches on phases 3 and 4 (the int8 rows: the HTTP run;
                the verify_w5, decode_d64 and prefill_d64 rows: the
                speculating servers of the spec phase; the _kh4 rows,
                bf16 and int8: one tp rank's share of the heads, their
                launches summed over the tp phase's ranks and listed per
                rank, the KH 2 case's numbers beside; the embed row:
                the elastic phase's flash-route embed, timed there), its
                launches on the moe phase's paths (`launches_moe`) and
                on the pack phase's (`launches_pack`) and the hf phase's
                kernel serve (`launches_hf`), and its numbers from phase
                2.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is non-zero. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
`--kernel-only` stops after phase 2 (a quick check of a kernel change)
and prints no result. `--http-rounds N` builds the kernels and then runs
only the int8 serve's 8-stream HTTP part N times over one started server
at Llama-3.1-8B width, counting the rounds that fail (a probe of a rare
fault; it prints no result). `--tp-only` builds the kernels and runs the
tp phase alone, serving its own one-card tokens; on a machine with two
cards or more that is the NCCL form with graphs (it prints no result).
`--ptrain-only` builds the kernels, checks them at the ptrain phase's
per-rank shapes and runs that phase alone; on a machine with four cards
or more it runs fsdp 2 x tp 2 and pp 2 x fsdp 2 over NCCL at 8 layers,
one rank a card, against the one-card step at that depth, and fsdp 2 x
ep 2 at 4 Mixtral layers, each with a step of rank 0 under
torch.profiler for the collectives' share, then dryrun_multichip(4)
(it prints no result).
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense
# Kernel vs plain, bf16 outputs: every element within about one bf16 ulp
# (|err| <= ATOL + RTOL * |plain|), and the error's RMS within REL_RMS of
# the plain output's RMS. ATOL is half a bf16 ulp at 1-2, the size of one
# V entry: the bf16 rounding of each probability errs in proportion to
# the V terms it weights, not to their (often cancelling) sum. The RMS
# bound catches a few mis-masked keys or a dropped tile on small outputs.
ATOL, RTOL, REL_RMS = 8e-3, 1e-2, 1e-2
# The int8 kernel against the int8 plain version: the bf16 limits. Both
# fold the same scales into the same int8 values (exact in bf16); they
# differ where the bf16 kernel does, in the rounding of the scaled
# probabilities and the order of the sums.
INT8_TOL = (ATOL, RTOL, REL_RMS)
# The 2-layer paged path against the plain dense forward: the largest
# logit error within this share of the largest logit.
DENSE_LOGIT_RTOL = 2.5e-2
SEED = 0
CONFIG = "cloud_server_tpu_torch/configs/llama3_1_8b.json"
TRAIN_CONFIG = "cloud_server_tpu_torch/configs/llama3_1_8b_train.json"
FUSED_CE_CONFIG = ("cloud_server_tpu_torch/configs/"
                   "llama3_1_8b_train_fused_ce.json")
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: CUDA events around `iters` back-to-back
    calls after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch
    from cloud_server_tpu_torch.ops import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build_all(["paged_attention", "flash_attention", "fused_ce"])
    build_s = time.perf_counter() - t0
    out = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": round(build_s, 3),
           "ptxas": {name: ptxas_summary(log) for name, log
                     in cuda_build.build_logs.items()}}
    emit(out)
    print(smi, flush=True)
    return out


def ptxas_summary(log: str) -> dict:
    """Per kernel entry: registers, spill bytes and shared memory from
    nvcc's -Xptxas=-v output; its warnings (a setmaxnreg it ignored,
    serialized wgmma) under "warnings"."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        if "warning" in line.lower():
            out.setdefault("warnings", []).append(line.strip())
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# Phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

H, KH, DH, PS, MAX_CTX = 32, 8, 128, 128, 2048


def make_case(gen, lengths, widths, w, layers: int = 2, dh: int = DH,
              tp: int = 1):
    """Random bf16 pools and a distinct random paging of every slot's
    context at Llama-3.1-8B's head shapes (Llama-3.2-1B's at dh 64; one
    tensor-parallel rank's share of the heads, H / tp on KH / tp, at tp
    > 1)."""
    import torch
    b = len(lengths)
    mp = MAX_CTX // PS
    num_pages = b * mp + 3
    dev = DEVICE
    kh, h = KH // tp, H // tp
    k_pool = torch.randn((layers, num_pages, kh, dh, PS), generator=gen,
                         device=dev).to(torch.bfloat16)
    v_pool = torch.randn((layers, num_pages, kh, dh, PS), generator=gen,
                         device=dev).to(torch.bfloat16)
    q = torch.randn((b, w, h, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    tables = perm[:b * mp].reshape(b, mp).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    widths = torch.tensor(widths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, lengths, tables, widths


def bound_ms(q, lengths, widths, kv_elem: int = 2,
             scale_bytes: int = 0) -> tuple[float, str]:
    """Least time on the card for this call's work: bytes (q and the
    output once, every slot's K and V up to its length once, at
    `kv_elem` bytes a value plus `scale_bytes` per position and kv head
    for the int8 cache's scales) over the memory rate, or the causally
    visible operations (4 * Dh per query-row-key pair: the two products)
    over the bf16 tensor rate."""
    b, w, h, d = q.shape
    kh = h // (H // KH)  # the case's kv heads (a group is H / KH heads)
    lens = [int(x) for x in lengths.tolist()]
    wids = [int(x) for x in widths.tolist()]
    nbytes = 2 * q.numel() * 2 + 16 * b
    ops = 0
    for n, wd in zip(lens, wids):
        nbytes += 2 * n * kh * (d * kv_elem + scale_bytes)
        # row j of the window sees keys [0, n - wd + j]
        ops += 4 * d * h * sum(n - wd + j + 1 for j in range(wd))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k_pool, v_pool, lengths, tables, widths, layer):
    """One torch.nn.functional.scaled_dot_product_attention call over the
    gathered pages (the gather is done once, outside the timed call): a
    yardstick only, never called by the port."""
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.ops.paged_attention import gather_pages
    b, w = q.shape[:2]
    k = gather_pages(k_pool, tables, layer).permute(0, 2, 1, 3)
    v = gather_pages(v_pool, tables, layer).permute(0, 2, 1, 3)
    k = k.repeat_interleave(q.shape[2] // k.shape[1], dim=1).contiguous()
    v = v.repeat_interleave(q.shape[2] // v.shape[1], dim=1).contiguous()
    qt = q.permute(0, 2, 1, 3).contiguous()
    pos = (lengths - widths)[:, None] + torch.arange(w, device=q.device)
    col = torch.arange(k.shape[2], device=q.device)
    mask = ((col[None, None, :] <= pos[:, :, None])
            & (col[None, None, :] < lengths[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def kernel_errors(name, got, want, valid, limits) -> dict:
    """Kernel vs plain on the valid rows: every element within atol +
    rtol * |plain| and the error's RMS within rel_rms of the plain
    output's RMS; raises otherwise."""
    import torch
    atol, rtol, rel_lim = limits
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (got.float() - want.float()).abs()[valid]
    ref_abs = want.float().abs()[valid]
    err = float(diff.max())
    rel_rms = float(diff.square().mean().sqrt()
                    / ref_abs.square().mean().sqrt())
    if not (bool((diff <= atol + rtol * ref_abs).all())
            and rel_rms <= rel_lim):
        raise RuntimeError(f"{name}: kernel differs from the plain version "
                           f"beyond atol {atol} + rtol {rtol} or relative "
                           f"RMS {rel_lim}: max abs error {err}, relative "
                           f"RMS error {rel_rms}")
    return {"max_abs_err": err, "ref_max_abs": float(ref_abs.max()),
            "rel_rms_err": rel_rms, "atol": atol, "rtol": rtol,
            "rel_rms_limit": rel_lim}


def graph_ms(calls, reps: int = 5) -> float:
    """Device time per call of `calls` (functions that each launch one
    kernel): captured once into a CUDA graph, replayed `reps` times
    between CUDA events, so the host's time per launch is not timed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(calls))
    del graph
    return ms


# Kernel-phase cases: (lengths, widths, W[, head dim[, tp]]). decode and
# verify run the narrow kernel (B 8; W 1 and the narrow class's widest
# window, 32), prefill and ragged the wide one; verify_w5 is
# speculation's verify window (4 drafts), decode_d64 and prefill_d64 a
# Llama-3.2-1B draft model's head shape (H 32, KH 8, Dh 64); the _kh4 and
# _kh2 cases one tensor-parallel rank's share of Llama-3.1-8B's heads at
# tp 2 (H 16 on KH 4) and tp 4 (H 8 on KH 2). Cases draw their data in
# this order from one generator, so a case added at the end leaves the
# others' data as it was.
SPEC_LENGTHS = [1537, 2048, 977, 1800, 64, 1200, 1501, 333]
PAGED_CASES = {
    "decode": (SPEC_LENGTHS, [1] * 8, 1),
    "prefill": ([2048, 1400], [256, 256], 256),
    "ragged": ([1700, 900, 1024, 77, 0], [1, 1, 256, 77, 0], 256),
    "verify": (SPEC_LENGTHS, [32] * 8, 32),
    "verify_w5": (SPEC_LENGTHS, [5] * 8, 5),
    "decode_d64": (SPEC_LENGTHS, [1] * 8, 1, 64),
    "prefill_d64": ([2048, 1400], [256, 256], 256, 64),
    "decode_kh4": (SPEC_LENGTHS, [1] * 8, 1, DH, 2),
    "prefill_kh4": ([2048, 1400], [256, 256], 256, DH, 2),
    "decode_kh2": (SPEC_LENGTHS, [1] * 8, 1, DH, 4),
    "prefill_kh2": ([2048, 1400], [256, 256], 256, DH, 4),
}
# Cases also timed cold: each call reads another layer of a pool whose
# K/V bytes for the case exceed COLD_L2_MULT x the 50 MB L2, as the
# serving path reads layer after layer.
COLD_CASES = ("decode", "prefill")
L2_BYTES = 50e6
COLD_L2_MULT = 4
KERNEL_ITERS = 20  # calls in each timing graph (warm)


def kv_bytes(lengths, kv_elem: int, scale_bytes: int = 0,
             dh: int = DH, kh: int = KH) -> int:
    """K and V bytes of every slot's visible keys, one layer."""
    return 2 * sum(int(n) for n in lengths) * kh * (dh * kv_elem
                                                    + scale_bytes)


def phase_kernel() -> dict:
    """Each case in bf16, then on the int8 cache (the same bf16 pools
    quantized by the port's quantize_pool): the wrapper against its plain
    version, the kernel's time warm (one layer, in turns with SDPA over
    the gathered cache) and, for COLD_CASES, cold (rotating over layers)."""
    import statistics
    import torch
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    from cloud_server_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    # the cold pools (timed, not checked) from their own generator
    cold_gen = torch.Generator(device=DEVICE)
    cold_gen.manual_seed(SEED + 1)
    layer = 1
    results = {}

    def timed_in_turns(kernel_calls, library):
        """Warm kernel time (graph) and SDPA (events) in TURNS rounds."""
        ks, ls = [], []
        for _ in range(TURNS):
            ks.append(graph_ms(kernel_calls))
            ls.append(time_ms(library, iters=10, warmup=1))
        return (statistics.median(ks), min(ks), max(ks),
                statistics.median(ls))

    def cold_ms(lens, wids, w, int8):
        """The kernel reading a different layer at every call of a pool
        of enough layers that a rotation's K/V bytes exceed
        COLD_L2_MULT x L2 (the cold cases are at the whole model's
        heads)."""
        ws = kv_bytes(lens, 1 if int8 else 2, 4 if int8 else 0)
        n_layers = math.ceil(COLD_L2_MULT * L2_BYTES / ws) + 1
        q, kp, vp, lengths, tables, widths = make_case(
            cold_gen, lens, wids, w, layers=n_layers)
        kw = {}
        if int8:
            kp, ks = quantize_pool(kp)
            vp, vs = quantize_pool(vp)
            kw = dict(k_scale_pool=ks, v_scale_pool=vs)
        calls = [(lambda i=i: pa.paged_attention(
            q, kp, vp, lengths, tables, i, widths=widths, **kw))
            for i in list(range(n_layers)) * 2]
        ms = graph_ms(calls, reps=3)
        del q, kp, vp, kw
        torch.cuda.empty_cache()
        return ms, n_layers

    for name, (lens, wids, w, *rest) in PAGED_CASES.items():
        dh = rest[0] if rest else DH
        tp = rest[1] if len(rest) > 1 else 1
        q, kp, vp, lengths, tables, widths = make_case(gen, lens, wids, w,
                                                       dh=dh, tp=tp)
        b = q.shape[0]
        valid = torch.arange(w, device=DEVICE)[None, :] < widths[:, None]
        valid &= (lengths > 0)[:, None]
        cls = ("narrow" if pa.uses_narrow_kernel(b, w, H // KH)
               else "wide")

        pa.reset_counters()
        got = pa.paged_attention(q, kp, vp, lengths, tables, layer,
                                 widths=widths)
        torch.cuda.synchronize()
        if pa.counters()[f"launches_{cls}"] != 1:
            raise RuntimeError(f"{name}: the {cls} kernel was not launched: "
                               f"{pa.counters()}")
        want = pa.paged_attention_ref(q, kp, vp, lengths, tables, layer,
                                      widths=widths)
        errs = kernel_errors(name, got, want, valid, (ATOL, RTOL, REL_RMS))
        calls = [lambda: pa.paged_attention(q, kp, vp, lengths, tables,
                                            layer, widths=widths)
                 ] * KERNEL_ITERS
        ms, ms_lo, ms_hi, library_ms = timed_in_turns(
            calls, library_call(q, kp, vp, lengths, tables, widths, layer))
        plain_ms = time_ms(lambda: pa.paged_attention_ref(
            q, kp, vp, lengths, tables, layer, widths=widths), iters=10)
        bms, by = bound_ms(q, lengths, widths)
        splits = {}
        if cls == "narrow":
            splits = {"splits": [pa.narrow_splits(
                b, w, KH // tp, H // KH, dh, int8, tables.shape[1], PS)
                for int8 in (False, True)]}
        res = {"phase": "kernel", "case": name, "B": b, "W": w, "Dh": dh,
               "H": H // tp, "KH": KH // tp,
               "class": cls, **splits, "lengths": lens, "widths": wids,
               **errs,
               "ms": ms, "ms_range": [ms_lo, ms_hi], "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bms, "bound_by": by}
        if name in COLD_CASES:
            res["ms_cold"], res["cold_layers"] = cold_ms(lens, wids, w,
                                                         False)
        emit(res)
        results[name] = res
        del got, want

        # the int8 cache: int8 pools + (L, P, KH, ps) f32 scale pools
        kq, ks = quantize_pool(kp)
        vq, vs = quantize_pool(vp)
        scales = dict(k_scale_pool=ks, v_scale_pool=vs)
        pa.reset_counters()
        got = pa.paged_attention(q, kq, vq, lengths, tables, layer,
                                 widths=widths, **scales)
        torch.cuda.synchronize()
        c = pa.counters()
        if (c[f"launches_{cls}_int8"] != 1
                or c["launches_narrow"] + c["launches_wide"] != 0):
            raise RuntimeError(f"{name} int8: launches {c}")
        want = pa.paged_attention_ref(q, kq, vq, lengths, tables, layer,
                                      widths=widths, **scales)
        errs = kernel_errors(f"{name} int8", got, want, valid, INT8_TOL)
        calls8 = [lambda: pa.paged_attention(q, kq, vq, lengths, tables,
                                             layer, widths=widths, **scales)
                  ] * KERNEL_ITERS
        # library yardstick: SDPA over the DEQUANTIZED bf16 cache (the
        # dequantization, and the gather, are not timed)
        kd = (kq.float() * ks[:, :, :, None, :]).to(torch.bfloat16)
        vd = (vq.float() * vs[:, :, :, None, :]).to(torch.bfloat16)
        ms8, lo8, hi8, library8 = timed_in_turns(
            calls8, library_call(q, kd, vd, lengths, tables, widths, layer))
        plain8 = time_ms(lambda: pa.paged_attention_ref(
            q, kq, vq, lengths, tables, layer, widths=widths, **scales),
            iters=10)
        # bf16 again in the same turn, beside the int8 time
        bf16_again = graph_ms(calls)
        bms8, by8 = bound_ms(q, lengths, widths, kv_elem=1, scale_bytes=4)
        res8 = {"phase": "kernel_int8", "case": name, "B": b, "W": w,
                "Dh": dh, "H": H // tp, "KH": KH // tp,
                "class": cls, **errs, "ms": ms8, "ms_range": [lo8, hi8],
                "bf16_ms": [ms, bf16_again], "plain_ms": plain8,
                "library_ms": library8,
                "library": "SDPA over the gathered dequantized bf16 cache",
                "bound_ms": bms8, "bound_by": by8}
        if name in COLD_CASES:
            res8["ms_cold"], res8["cold_layers"] = cold_ms(lens, wids, w,
                                                           True)
        emit(res8)
        results[f"{name}_int8"] = res8
        del q, kp, vp, kq, vq, ks, vs, kd, vd, got, want, calls, calls8
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serving at Llama-3.1-8B width
# ---------------------------------------------------------------------------

PROMPT_LENS = [64, 200, 350, 500, 700, 900, 1200, 1500]
MAX_NEW = 32
# Decode budget of the profile and the seeded-step runs, long enough for
# several steady decode steps after the admissions.
LONG_NEW = 96
# Pipelined steps profiled together (a steady step commits iteration N
# and launches N+1, so one step alone is not a whole iteration).
PROFILE_STEPS = 3
# The steady seeded decode steps timed.
SEEDED_STEPS = 4
# The depth of the seeded-sampling and grammar checks (the serve phase's
# seeded runs, the spec phase's A12 and grammar runs): the first 8 of the
# 32 layers at full width, to keep the script within its time (PERF.md,
# PR 12).
SEEDED_LAYERS = 8


def first_layers(params, cfg, n: int) -> tuple:
    """The model's first `n` layers at full width (views of `params`):
    (params, cfg)."""
    import dataclasses
    return (dict(params, layers={k: v[:n]
                                 for k, v in params["layers"].items()}),
            dataclasses.replace(cfg, num_layers=n))
# Host API calls that launch work on the card, as torch.profiler lists
# them among its CPU events (CUPTI's runtime and low-level CUDA APIs).
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")
# Host API calls that copy, set or wait on the card (name prefixes): a
# host sync added to a step (.item(), .cpu(), synchronize) shows here.
HOST_COPY_APIS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset",
                  "cudaStreamSynchronize", "cudaEventSynchronize",
                  "cudaDeviceSynchronize", "cudaStreamWaitEvent")


def make_server(params, cfg, icfg, **kw):
    """The serving path a user gets: the mixed scheduler with the overlap
    pipeline and captured CUDA graphs (`cuda_graphs=False`, a check only,
    launches every program eagerly)."""
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    return PagedInferenceServer(params, cfg, icfg, max_slots=8,
                                max_context=MAX_CTX, page_size=PS,
                                prefill_chunk=256, seed=SEED, device=DEVICE,
                                **kw)


def make_prompts(rng, vocab):
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def serve_once(params, cfg, icfg, prompts, srv=None, max_new=MAX_NEW,
               sampling=None, **kw):
    """The requests on `srv` (a fresh server by default), request i with
    `sampling[i]` when given: (requests, start, end, bytes of the
    server's page pools)."""
    import torch
    srv = srv if srv is not None else make_server(params, cfg, icfg, **kw)
    pool_bytes = srv.kv_cache_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=max_new,
                       sampling=sampling[i] if sampling else None)
            for i, p in enumerate(prompts)]
    srv.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return reqs, t0, t_end, pool_bytes


def check_served(reqs, vocab, max_new=MAX_NEW) -> None:
    for r in reqs:
        if r.finish_reason != "length" or len(r.tokens) != max_new:
            raise RuntimeError(f"request ended {r.finish_reason!r} with "
                               f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise RuntimeError("token id out of the vocabulary")


def same_tokens(what, reqs, want) -> None:
    got = [r.tokens for r in reqs]
    if got != want:
        n = sum(a != b for x, y in zip(got, want) for a, b in zip(x, y))
        raise RuntimeError(f"{what}: {n} tokens differ")


def dense_logits(params, cfg, prompt, tokens):
    """The plain dense forward's f32 logits (of the model's family: an
    MoE model routes the whole sequence at once) at every position that
    predicts one of `tokens` after `prompt`: (len(tokens), V)."""
    import torch
    from cloud_server_tpu_torch.models import moe, transformer
    seq = torch.tensor([prompt + tokens[:-1]], device=DEVICE)
    with torch.no_grad():
        h = moe.module_for(cfg).forward_hidden(params, seq, cfg)
        h = h[0] if isinstance(h, tuple) else h
        return transformer.unembed(h[:, len(prompt) - 1:], params,
                                   cfg)[0].float()


def near_tie_divergence(what, reqs, want, prompts, params, cfg) -> dict:
    """Two schedules of the same greedy requests in bf16: their programs
    differ in shape, so a near tie between two tokens may break the
    other way (`schedulers_in_f32` shows the schedules equal where
    rounding cannot break a tie). Each request's tokens must be equal up
    to its first divergence, and there both runs' tokens must lie near
    the top of the plain dense forward's logits over the same context:
    both within the 25th percentile of that forward's top-2 gaps over
    every position `want` decoded, measured in this run. A divergence
    that is no tie lands at an ordinary gap and fails three times in
    four."""
    import numpy as np
    top2, at_div = [], []
    equal = total = 0
    for r, w, prompt in zip(reqs, want, prompts):
        total += len(w.tokens)
        i = next((j for j, (a, b) in enumerate(zip(r.tokens, w.tokens))
                  if a != b), len(w.tokens))
        equal += i
        logits = dense_logits(params, cfg, prompt, w.tokens)
        best = logits.topk(2, dim=-1).values
        top2 += (best[:, 0] - best[:, 1]).tolist()
        if i < len(w.tokens):
            top = float(best[i, 0])
            at_div.append(max(top - float(logits[i, w.tokens[i]]),
                              top - float(logits[i, r.tokens[i]])))
    limit = float(np.percentile(top2, 25))
    if any(g > limit for g in at_div):
        raise RuntimeError(f"{what}: requests diverged {at_div} below the "
                           f"dense forward's top logit, past the limit "
                           f"{limit} (top-2 gaps p25)")
    return {"equal_share_before_divergence": equal / total,
            "diverged_requests": len(at_div),
            "divergence_gaps_below_top_logit": at_div,
            "divergence_gap_limit_p25_top2": limit,
            "top2_gap_p5_p50": [float(np.percentile(top2, 5)),
                                float(np.percentile(top2, 50))]}


def f32_slice(params, cfg) -> tuple:
    """A 2-layer slice of the model at full width in float32 (TF32 off;
    the plain attention path, the kernels taking bf16 and int8 pools
    only), where rounding cannot break a tie: (params, cfg)."""
    import dataclasses

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                param_dtype="float32",
                                decode_attention_impl="xla")
    return f32(dict(params, layers={k: v[:2] for k, v in
                                    params["layers"].items()})), cfg32


def schedulers_in_f32(params, cfg, prompts) -> dict:
    """The alternating scheduler against the default one on the float32
    slice (`f32_slice`), greedy, both graphed: the same tokens."""
    import torch
    from cloud_server_tpu_torch.config import InferConfig
    p32, cfg32 = f32_slice(params, cfg)
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    runs = {}
    for sched in ("mixed", "alternating"):
        srv = make_server(p32, cfg32, icfg, scheduler=sched)
        reqs, _, _, _ = serve_once(p32, cfg32, icfg, prompts, srv=srv)
        check_served(reqs, cfg.vocab_size)
        runs[sched] = ([r.tokens for r in reqs], len(srv._programs))
        srv.stop()
    del p32
    same_tokens("alternating vs mixed in float32",
                [types.SimpleNamespace(tokens=t)
                 for t in runs["alternating"][0]], runs["mixed"][0])
    return {"f32_alternating_equals_mixed": True,
            "f32_programs": {k: v[1] for k, v in runs.items()}}


def serving_rates(reqs, t_start, t_end) -> dict:
    """Prefill and decode tokens/s and TTFT of one in-process run."""
    first = [r.emit_times[0] for r in reqs]
    ttft = sorted(f - r.submit_time for f, r in zip(first, reqs))
    t_all_first = max(first)
    after = sum(sum(1 for t in r.emit_times if t > t_all_first)
                for r in reqs)
    return {"wall_s": t_end - t_start,
            "prefill_tok_per_s": sum(PROMPT_LENS) / (t_all_first - t_start),
            "decode_tok_per_s_after_last_first_token":
                after / max(t_end - t_all_first, 1e-9),
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1]}


# Device kernels summed by what they do, matched on lower-cased kernel
# names in this order; the rest is "other" (casts, norms, the loss).
PROFILE_GROUPS = (
    ("optimizer", ("multi_tensor_apply", "adam", "foreach")),
    ("flash_attention", ("flash_fwd", "flash_bwd", "flash_delta")),
    ("fused_ce", ("ce_gemm", "ce_fwd")),
    ("paged_attention", ("paged_attention", "paged_narrow", "paged_wide")),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("copy", ("memcpy", "memset")),
)


def profile_step(step, n: int = 1) -> dict:
    """`n` calls of `step` (scheduler or train steps) under torch.profiler,
    per call: the wall time, the host's launch API calls (kernel launches
    and graph launches), its copy and sync API calls, the device kernels
    and copies (the copy records by name), their time and the device's
    idle share; the busiest kernels and the device time by
    group over the window. The profiler's own records are read, not the
    FunctionEvent tree it builds from them on request (seconds of host
    time for the 15,000 kernels of a serving step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name: dict[str, float] = {}
    per_count: dict[str, int] = {}
    n_kernels = 0
    launches: dict[str, int] = {}
    host_copies: dict[str, int] = {}
    copies: dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (getattr(e, "is_hidden_event", lambda: False)()
                or name.startswith("[memory]")):
            continue
        if e.device_type() == DeviceType.CUDA:
            n_kernels += 1
            per_name[name] = per_name.get(name, 0.0) + e.duration_ns() / 1e6
            per_count[name] = per_count.get(name, 0) + 1
            if "memcpy" in name.lower() or "memset" in name.lower():
                copies[name] = copies.get(name, 0) + 1
        elif name in LAUNCH_APIS:
            launches[name] = launches.get(name, 0) + 1
        elif name.startswith(HOST_COPY_APIS):
            host_copies[name] = host_copies.get(name, 0) + 1
    busy = sum(per_name.values())
    # kernel names are long templates: sum the names that share their
    # first 100 characters, so one entry never hides another
    short: dict[str, float] = {}
    for name, ms in per_name.items():
        short[name[:100]] = short.get(name[:100], 0.0) + ms
    top = sorted(short.items(), key=lambda kv: -kv[1])[:10]
    groups: dict[str, float] = {}
    group_counts: dict[str, float] = {}
    for name, ms in per_name.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms / n
        group_counts[group] = (group_counts.get(group, 0)
                               + per_count[name] / n)
    return {"steps": n, "wall_ms": wall_ms / n,
            "host_launch_calls": sum(launches.values()) / n,
            "host_launch_calls_by_api": {k: v / n
                                         for k, v in launches.items()},
            "host_copy_sync_calls_by_api": {k: v / n
                                            for k, v in host_copies.items()},
            "device_kernels": n_kernels / n,
            "device_copies_by_name": {k: v / n for k, v in copies.items()},
            "device_busy_ms": busy / n if per_name else None,
            "device_idle_share": (1 - busy / wall_ms) if per_name else None,
            "device_ms_by_group": groups,
            "device_kernels_by_group": group_counts,
            "top_device_ms": dict(top)}


def mean_profile(profs: list) -> dict:
    """The mean of profile_step readings (numbers, and dicts of them
    key by key)."""
    def mean(vals):
        if isinstance(vals[0], dict):
            return {k: mean([v.get(k, 0.0) for v in vals])
                    for k in set().union(*vals)}
        return None if None in vals else sum(vals) / len(vals)
    return {k: mean([p[k] for p in profs]) for k in profs[0]}


def phase_profile(srv, cfg, rng) -> dict:
    """Where pipelined mixed steps (admissions landing) and steady decode
    steps (8 live slots) spend their time, on a server that has served
    before. A run of 8 fresh prompts of the usual lengths captures any
    program the longer budget needs; a second run of other fresh prompts
    (the same lengths, so the same schedule and programs, and no prefix
    hits) is profiled: PROFILE_STEPS mixed steps after the fill step, then
    PROFILE_STEPS steady decode steps."""

    def run(prompts, profiled: bool):
        for p in prompts:
            srv.submit(p, max_new_tokens=LONG_NEW)
        srv.step()  # the pipeline's fill step
        mixed = profile_step(srv.step, PROFILE_STEPS) if profiled else None
        while srv._jobs or srv.num_pending:
            srv.step()
        for _ in range(2):
            srv.step()
        decode = (profile_step(srv.step, PROFILE_STEPS) if profiled
                  else None)
        live = srv.num_active
        srv.run_until_idle()
        return mixed, decode, live

    run(make_prompts(rng, cfg.vocab_size), False)
    captured = len(srv._programs)
    mixed, decode, live = run(make_prompts(rng, cfg.vocab_size), True)
    if len(srv._programs) != captured:
        raise RuntimeError("the profiled steps captured "
                           f"{len(srv._programs) - captured} programs")
    if live != 8:
        raise RuntimeError(f"{live} slots live in the profiled decode "
                           "steps, not 8")
    out = {"phase": "profile", "kv_cache_dtype": cfg.kv_cache_dtype,
           "mixed_step": mixed, "decode_step": decode,
           "decode_rounds_per_step": srv.decode_chunk, "live_slots": live,
           "programs_captured": captured}
    emit(out)
    return out


def seeded_run(params, cfg, icfg, rng, prompts, what,
               sampling=None) -> tuple:
    """The 8 requests, sampled, through captured graphs and through
    eager launches: the same tokens. Then, on the graphed server, 8
    fresh prompts with a longer budget, and SEEDED_STEPS steady decode
    steps timed (host clock, each step synchronised): (their ms, decode
    rounds a step)."""
    import torch
    fresh = make_prompts(rng, cfg.vocab_size)
    eager, _, _, _ = serve_once(params, cfg, icfg, prompts,
                                sampling=sampling, cuda_graphs=False)
    srv = make_server(params, cfg, icfg)
    graphed, _, _, _ = serve_once(params, cfg, icfg, prompts, srv=srv,
                                  sampling=sampling)
    check_served(graphed, cfg.vocab_size)
    same_tokens(f"{what} graphed vs graphs off", graphed,
                [r.tokens for r in eager])
    per_row = any(dict(key[2]).get(f) for key in srv._programs.keys()
                  for f in ("rows", "rows_p", "rows_d"))
    if per_row != bool(sampling):
        raise RuntimeError(f"{what}: per-row sampling programs {per_row}")
    for i, p in enumerate(fresh):
        srv.submit(p, max_new_tokens=LONG_NEW,
                   sampling=sampling[i] if sampling else None)
    while srv._jobs or srv.num_pending:
        srv.step()
    for _ in range(2):
        srv.step()
    times = []
    for _ in range(SEEDED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if srv.num_active != 8:
        raise RuntimeError(f"{what}: the decode steps did not keep 8 slots")
    srv.stop()
    return times, srv.decode_chunk


def seeded_runs(params, cfg, rng, prompts) -> dict:
    """`seeded_run` twice, on the model's first SEEDED_LAYERS layers:
    server-global seeded sampling (InferConfig
    temperature 0.8, top-k 50: every row draws from the server's key,
    split once per dispatch), then per request (a greedy server, each
    request with its own seed, temperature 0.8 and top-p 0.9: the
    programs that sample per row)."""
    from cloud_server_tpu_torch.config import InferConfig
    from cloud_server_tpu_torch.inference.sampling import SamplingParams
    params, cfg = first_layers(params, cfg, SEEDED_LAYERS)
    base = dict(max_decode_len=MAX_NEW, eos_token_id=-1, pad_token_id=0)
    glob, rounds = seeded_run(params, cfg, InferConfig(temperature=0.8, top_k=50,
                                               **base),
                      rng, prompts, "server-global seeded")
    rows, _ = seeded_run(params, cfg, InferConfig(temperature=0.0, **base),
                      rng, prompts, "per-request seeded",
                      [SamplingParams(seed=1000 + i, temperature=0.8,
                                      top_p=0.9)
                       for i in range(len(prompts))])
    return {"seeded_layers": SEEDED_LAYERS,
            "seeded_graphed_equals_graphs_off": True,
            "per_request_seeded_graphed_equals_graphs_off": True,
            "seeded_decode_step_ms": glob,
            "per_request_seeded_decode_step_ms": rows,
            "seeded_decode_rounds_per_step": rounds}


def check_dense_agreement(params, cfg, prompt) -> dict:
    """A 2-layer slice of the model: last-position logits of the plain
    dense forward against the paged path through the kernel (the prompt
    prefilled in 256-wide chunks). bf16 on the card: within
    DENSE_LOGIT_RTOL of the largest logit."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.inference import paged_engine
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import paged_attention as pa
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    toks = torch.tensor([prompt], device=DEVICE)
    with torch.no_grad():
        want = transformer.forward(p2, toks, cfg2)[0, -1]
    mp = MAX_CTX // PS
    cache = paged_engine.init_paged_cache(
        cfg2, num_pages=mp, page_size=PS, batch=1, max_pages_per_slot=mp,
        device=DEVICE)
    cache = cache._replace(tables=torch.arange(mp, dtype=torch.int32)[None])
    n0 = pa.launches_narrow + pa.launches_wide
    done = 0
    logits = None
    while done < len(prompt):
        take = min(256, len(prompt) - done)
        cache = cache._replace(lengths=torch.tensor([done],
                                                    dtype=torch.int32))
        logits, cache = paged_engine.window_forward(
            p2, toks[:, done:done + take], cfg2, cache,
            logits_at=torch.tensor([take - 1]))
        done += take
    if pa.launches_narrow + pa.launches_wide == n0:
        raise RuntimeError("the dense-agreement check did not use the "
                           "kernel")
    got = logits[0]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not err <= DENSE_LOGIT_RTOL * scale:
        raise RuntimeError(f"paged kernel path logits differ from the "
                           f"dense forward: {err} vs scale {scale}")
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "logits_err_limit": DENSE_LOGIT_RTOL * scale,
            "top1_equal": bool(int(got.argmax()) == int(want.argmax()))}


# The int8 KV cache at full width: pool bytes at max_slots 8, max_context
# 2048, page size 128, all 32 layers (values + f32 scales; bf16 values).
INT8_POOL_BYTES, BF16_POOL_BYTES = 1_107_296_256, 2_147_483_648
HTTP_TIMEOUT = 300


def check_int8_agreement(params, cfg, prompt) -> dict:
    """A 2-layer slice on the int8 cache: the prompt prefilled in
    256-wide chunks, then one decode step, through the int8 kernel and
    through the int8 plain version; last logits within DENSE_LOGIT_RTOL
    of the largest logit."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.inference import paged_engine
    from cloud_server_tpu_torch.ops import paged_attention as pa
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    toks = torch.tensor([prompt], device=DEVICE)
    mp = MAX_CTX // PS
    logits = {}
    for impl in ("pallas", "xla"):
        cfg2 = dataclasses.replace(cfg, num_layers=2, kv_cache_dtype="int8",
                                   decode_attention_impl=impl)
        cache = paged_engine.init_paged_cache(
            cfg2, num_pages=mp, page_size=PS, batch=1,
            max_pages_per_slot=mp, device=DEVICE)
        cache = cache._replace(tables=torch.arange(mp,
                                                   dtype=torch.int32)[None])
        pa.reset_counters()
        done = 0
        while done < toks.shape[1]:
            take = min(256, toks.shape[1] - done)
            cache = cache._replace(lengths=torch.tensor([done],
                                                        dtype=torch.int32))
            out, cache = paged_engine.window_forward(
                p2, toks[:, done:done + take], cfg2, cache,
                logits_at=torch.tensor([take - 1]))
            done += take
        nxt = out.argmax(-1)[:, None]
        cache = cache._replace(lengths=torch.tensor([done],
                                                    dtype=torch.int32))
        out, _ = paged_engine.window_forward(p2, nxt, cfg2, cache,
                                             logits_at=torch.tensor([0]))
        c = pa.counters()
        if impl == "pallas" and (c["launches_narrow_int8"] == 0
                                 or c["launches_wide_int8"] == 0
                                 or c["plain_calls"]):
            raise RuntimeError(f"int8 check: kernel launches {c}")
        if impl == "xla" and c["plain_calls"] == 0:
            raise RuntimeError(f"int8 check: plain calls {c}")
        logits[impl] = out[0]
    scale = float(logits["xla"].abs().max())
    err = float((logits["pallas"] - logits["xla"]).abs().max())
    if not err <= DENSE_LOGIT_RTOL * scale:
        raise RuntimeError(f"int8 kernel path logits differ from the int8 "
                           f"plain path: {err} vs scale {scale}")
    return {"int8_logits_max_abs_err": err, "int8_logits_max_abs": scale,
            "int8_logits_err_limit": DENSE_LOGIT_RTOL * scale,
            "int8_top1_equal": bool(int(logits["pallas"].argmax())
                                    == int(logits["xla"].argmax()))}


class IdTokenizer:
    """Renders token id i as "<i>": every token adds text, so the SSE
    stream carries one chunk per token and the client reads the ids back
    (the byte tokenizer drops the ids of a 128256-entry vocabulary)."""

    def encode(self, text: str) -> list[int]:
        return [int(t) for t in re.findall(r"<(\d+)>", text)]

    def decode(self, ids) -> str:
        return "".join(f"<{int(i)}>" for i in ids)


def stream_completion(addr, prompt, max_tokens) -> dict:
    """One streaming /v1/completions request: the ids of its text chunks,
    their client-side arrival times, the final chunk and [DONE]."""
    import urllib.request
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "temperature": 0.0, "stream": True}).encode()
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://{addr}/v1/completions", data=body)
    ids, times, events, done = [], [], [], False
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line:
                continue
            if line == "data: [DONE]":
                done = True
                continue
            ev = json.loads(line[len("data: "):])
            events.append(ev)
            new = IdTokenizer().encode(ev["choices"][0]["text"])
            if new:
                ids += new
                times += [time.perf_counter()] * len(new)
    return {"t0": t0, "ids": ids, "times": times, "done": done,
            "finish_reason": events[-1]["choices"][0]["finish_reason"]}


def http_clients(addr: str, max_tokens: int) -> int:
    """`--http-clients ADDR MAX_TOKENS`: stream one /v1/completions per
    prompt (a JSON list on stdin) concurrently, one thread each; print
    the results as one JSON line."""
    import threading
    prompts = json.loads(sys.stdin.read())
    results: list = [None] * len(prompts)
    errors: list = []

    def client(i):
        try:
            results[i] = stream_completion(addr, prompts[i], max_tokens)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {exc!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    if errors or any(t.is_alive() for t in threads):
        print(f"HTTP clients failed: {errors}", file=sys.stderr)
        return 1
    print(json.dumps(results), flush=True)
    return 0


def http_call(addr: str, path: str, body=None,
              timeout: float = 60) -> tuple:
    """GET `path`, or POST `body` as JSON: (status, response bytes; None
    for an error status)."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}{path}", data=data), timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, None


def metric_values(addr: str) -> dict:
    """The /metrics sample lines as {name: value text}."""
    return dict(ln.rsplit(" ", 1)
                for ln in http_call(addr, "/metrics")[1].decode().splitlines()
                if ln and not ln.startswith("#"))


def access_log_errors(path: str) -> list:
    """The records of an HttpFrontend access log that tell of a fault:
    the stdlib handler's own messages (`log_message`) other than its
    line for a request answered 200 (bad requests, timeouts, errors
    while handling), and requests that did not end in 200."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    ok_line = re.compile(r'^".*" 200 ')
    return [r for r in recs
            if (r.get("event") == "http_log"
                and not ok_line.match(r.get("message", "")))
            or r.get("status") not in (None, 200)]


def http_run(srv, prompts) -> dict:
    """HttpFrontend on 127.0.0.1:0 over a started server: 8 concurrent
    streaming /v1/completions, the /metrics counts they added, and
    /v1/embeddings answering the in-process vectors. The frontend keeps
    an access log in a temporary file; its fault records are printed on
    a line of their own (`{"http_log_errors": [...]}`) before the
    phase's line, and a failed run raises with them."""
    import tempfile
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    log_dir = tempfile.mkdtemp(prefix="smoke_http_")
    log_path = os.path.join(log_dir, "access.jsonl")
    front = HttpFrontend(srv, tokenizer=IdTokenizer(),
                         access_log=log_path).start()
    try:
        host, port = front.address
        addr = f"{host}:{port}"
        before = metric_values(addr)
        # the clients run in a process of their own, so their threads do
        # not share the server's interpreter lock
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--http-clients",
             addr, str(MAX_NEW)], input=json.dumps(prompts),
            capture_output=True,
            text=True, timeout=HTTP_TIMEOUT + 60)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"HTTP clients failed:\n{proc.stderr[-4000:]}"
                               f"\naccess log: {access_log_errors(log_path)}")
        results = json.loads(proc.stdout.strip().splitlines()[-1])
        for i, r in enumerate(results):
            if not (r["done"] and len(r["ids"]) == MAX_NEW
                    and r["finish_reason"] == "length"):
                raise RuntimeError(f"HTTP request {i}: {len(r['ids'])} "
                                   f"tokens, finish {r['finish_reason']}, "
                                   f"[DONE] {r['done']}")
        prom = metric_values(addr)
        want = {"cloud_server_requests_submitted_total": len(prompts),
                "cloud_server_ttft_seconds_count": len(prompts),
                "cloud_server_itl_seconds_count": len(prompts)
                * (MAX_NEW - 1),
                "cloud_server_tokens_emitted_total": len(prompts) * MAX_NEW}
        seen = {k: float(prom[k]) - float(before.get(k, 0)) for k in want}
        if seen != {k: float(v) for k, v in want.items()}:
            raise RuntimeError(f"/metrics counts {seen}, expected {want}")
        emb_in = [prompts[0][:64], prompts[1][:16]]
        emb, body = http_call(addr, "/v1/embeddings", {"input": emb_in})
        if emb != 200:
            raise RuntimeError(f"/v1/embeddings answered {emb}, not 200")
        wire = [d["embedding"] for d in json.loads(body)["data"]]
        emb_err = float(abs(srv.embed(emb_in) - wire).max())
        if emb_err > 1e-6:
            raise RuntimeError(f"/v1/embeddings vectors off by {emb_err} "
                               "from the in-process ones")
    finally:
        front.stop()
        errors = access_log_errors(log_path)
        emit({"http_log_errors": errors})
        shutil.rmtree(log_dir, ignore_errors=True)
    ttft = sorted(r["times"][0] - r["t0"] for r in results)
    itl = sorted(b - a for r in results
                 for a, b in zip(r["times"], r["times"][1:]))
    return {"http_requests": len(prompts), "http_wall_s": wall,
            "http_ttft_p50_s": ttft[len(ttft) // 2],
            "http_ttft_max_s": ttft[-1],
            "http_itl_p50_s": itl[len(itl) // 2],
            "http_itl_p99_s": itl[min(len(itl) - 1, int(0.99 * len(itl)))],
            "http_metrics": seen, "embeddings_status": emb,
            "embeddings_max_abs_err": emb_err,
            "http_log_errors": len(errors),
            "http_ids": [r["ids"] for r in results]}


def http_probe(rounds: int, card: str) -> dict:
    """`--http-rounds N`: the int8 serve's HTTP part alone, N times over
    one started server at Llama-3.1-8B width (8 fresh prompts a round,
    streamed concurrently). A failed round is counted and its error kept,
    not raised, so one call reads how often the part fails; the access
    log's fault records are printed each round (`http_run`)."""
    import dataclasses
    import numpy as np
    import torch
    from cloud_server_tpu_torch.config import (InferConfig, ModelConfig,
                                               from_json)
    from cloud_server_tpu_torch.models import transformer
    with open(CONFIG) as f:
        cfg = from_json(ModelConfig, json.load(f)["model"])
    params = transformer.init_params(cfg, SEED, device=DEVICE)
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    rng = np.random.default_rng(SEED)
    srv = make_server(params, dataclasses.replace(cfg, kv_cache_dtype="int8"),
                      icfg)
    srv.start()
    failures, walls = [], []
    try:
        for i in range(rounds):
            try:
                walls.append(http_run(srv, make_prompts(rng, cfg.vocab_size))
                             ["http_wall_s"])
            except RuntimeError as exc:
                failures.append({"round": i, "error": str(exc)[-2000:]})
    finally:
        srv.stop()
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "http_probe", "card": card, "rounds": rounds,
           "streams_per_round": len(PROMPT_LENS),
           "failed_rounds": len(failures), "failures": failures,
           "wall_s_min": min(walls, default=None),
           "wall_s_max": max(walls, default=None)}
    emit(out)
    return out


def serve_int8(params, cfg, icfg, prompts, bf16_tokens, bf16_bytes,
               rng) -> dict:
    """The serving phase's 8 requests on the int8 cache: in process (the
    pool's bytes, the kernels' launches, the same tokens with graphs off,
    agreement with the bf16 run), the int8 kernel path against the int8
    plain path on one request, the profile, then 8 fresh prompts over
    HTTP, streamed concurrently, and in process with graphs off."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.ops import paged_attention as pa
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    srv = make_server(params, cfg8, icfg)
    pa.reset_counters()
    reqs, t_start, t_end, pool_bytes = serve_once(params, cfg8, icfg,
                                                  prompts, srv=srv)
    counts = pa.counters()
    peak = torch.cuda.max_memory_allocated()
    check_served(reqs, cfg.vocab_size)
    if (counts["launches_narrow_int8"] <= 0
            or counts["launches_wide_int8"] <= 0 or counts["plain_calls"]
            or counts["launches_narrow"] or counts["launches_wide"]):
        raise RuntimeError(f"int8 serve: launches {counts}")
    if (pool_bytes, bf16_bytes) != (INT8_POOL_BYTES, BF16_POOL_BYTES):
        raise RuntimeError(f"pool bytes int8 {pool_bytes}, bf16 "
                           f"{bf16_bytes}; expected {INT8_POOL_BYTES}, "
                           f"{BF16_POOL_BYTES}")
    toks = [r.tokens for r in reqs]
    eager, _, _, _ = serve_once(params, cfg8, icfg, prompts,
                                cuda_graphs=False)
    same_tokens("int8 graphed vs graphs off", eager, toks)
    same = sum(a == b for x, y in zip(toks, bf16_tokens)
               for a, b in zip(x, y))
    agree = check_int8_agreement(params, cfg, prompts[2])
    out = {"phase": "serve_int8", "kv_cache_dtype": "int8",
           **serving_rates(reqs, t_start, t_end), "peak_mem_gb": peak / 1e9,
           "kv_pool_bytes": pool_bytes, "bf16_kv_pool_bytes": bf16_bytes,
           "kv_pool_ratio": pool_bytes / bf16_bytes, "counts": counts,
           "graphed_equals_graphs_off": True,
           "tokens_equal_to_bf16_share": same / (len(toks) * MAX_NEW),
           **agree}

    del reqs, eager
    phase_profile(srv, cfg8, rng)
    # HTTP on the same server, its programs captured: 8 fresh prompts of
    # the usual lengths (no prefix hits), streamed concurrently
    http_prompts = make_prompts(rng, cfg.vocab_size)
    srv.start()
    try:
        pa.reset_counters()
        http = http_run(srv, http_prompts)
        torch.cuda.synchronize()
        http_counts = pa.counters()
        captures = len(srv._programs)
        capture_s = srv._programs.capture_seconds()
    finally:
        srv.stop()
    if (http_counts["launches_narrow_int8"] <= 0
            or http_counts["launches_wide_int8"] <= 0
            or http_counts["plain_calls"]):
        raise RuntimeError(f"int8 HTTP serve: launches {http_counts}")
    # the same prompts in process, on a fresh server with graphs off:
    # requests that arrived together there and one by one over HTTP are
    # batched otherwise, so a near tie may break the other way
    del srv
    local, _, _, _ = serve_once(params, cfg8, icfg, http_prompts,
                                cuda_graphs=False)
    got = http.pop("http_ids")
    same = sum(a == b for r, ids in zip(local, got)
               for a, b in zip(r.tokens, ids))
    out.update(http, http_counts=http_counts,
               programs_after_http=captures, capture_s=capture_s,
               http_tokens_equal_to_in_process_share=same / (len(got)
                                                             * MAX_NEW),
               http_requests_equal_to_in_process=sum(
                   r.tokens == ids for r, ids in zip(local, got)))
    emit(out)
    out["tokens"] = toks  # the fleet phase's int8 round trip reads them
    print(f"int8 HTTP: TTFT p50 {out['http_ttft_p50_s']:.4f} s, max "
          f"{out['http_ttft_max_s']:.4f} s; ITL p50 "
          f"{out['http_itl_p50_s']:.4f} s, p99 {out['http_itl_p99_s']:.4f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 3b: speculation, grammar and the A12 options at full width
# ---------------------------------------------------------------------------

DRAFT_CONFIG = "cloud_server_tpu_torch/configs/llama3_2_1b_draft.json"
SPEC_DRAFTS = 4
# Self-drafting (the target as its own draft) runs the target G+1 times
# a round as the draft: one round a program keeps its captures short.
SELF_DRAFT_ROUNDS = 1
# Steady speculative steps read in each window.
SPEC_WINDOW_STEPS = 1
# A random draft proposes what the target would pick almost never; the
# target drafting for itself accepts every draft up to rounding: read
# over steady steps (no request's budget truncates a window) on the
# float32 slice, where rounding cannot break a tie, it must accept at
# least SELF_DRAFT_MIN_ACCEPT. In bf16 at full depth the draft's W 1
# and the verify's W 5 logits come from other GEMM tilings and differ
# by rounding, so a random model's near ties turn some drafts down:
# every rejected draft must lie at a near tie (`rejections_at_ties`),
# and over the whole run (no budget truncates a window) it must accept
# at least SELF_DRAFT_BF16_FLOOR (the card read 0.859, PERF.md).
SELF_DRAFT_MIN_ACCEPT = 0.9
SELF_DRAFT_BF16_FLOOR = 0.8
BYTE_EOS = 257  # the byte tokenizer's EOS, inside the 128256 vocabulary
GRAMMAR_REGEX = r"-?[0-9]{1,8}(\.[0-9]{1,4})?"
GRAMMAR_WORD = r"[a-z]{4,12}"
# Decode budget of the steady speculative windows: a step commits up to
# 8 rounds x 5 tokens a row, so the window's 8 slots must outlast it;
# they are cancelled after it.
SPEC_LONG_NEW = 256
GRAMMAR_NEW = 24


class Latin1Tokenizer:
    """The frontend's byte tokenizer with text as Latin-1, one character
    a byte, so the HTTP client reads back exactly the bytes the grammar
    saw."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode("latin-1"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("latin-1")


def spec_run(srv, prompts, vocab, profiled: bool = True) -> tuple:
    """The 8 requests on a fixed-length speculating server with a long
    budget: their admissions, two steps, then SPEC_WINDOW_STEPS steady
    steps (8 live slots; under the profiler when `profiled`) with the
    tokens each step commits and the drafts it drafts and accepts; then
    the requests are cancelled. Returns (requests, window)."""
    reqs = [srv.submit(p, max_new_tokens=SPEC_LONG_NEW) for p in prompts]
    while srv._jobs or srv.num_pending:
        srv.step()
    for _ in range(2):
        srv.step()
    c0 = (srv.decode_tokens_committed, srv.decode_rounds,
          srv.spec_tokens_drafted, srv.spec_tokens_accepted)
    if profiled:
        window = profile_step(srv.step, SPEC_WINDOW_STEPS)
    else:
        window = {"steps": SPEC_WINDOW_STEPS}
        for _ in range(SPEC_WINDOW_STEPS):
            srv.step()
    live = srv.num_active
    c1 = (srv.decode_tokens_committed, srv.decode_rounds,
          srv.spec_tokens_drafted, srv.spec_tokens_accepted)
    while min(len(r.tokens) for r in reqs) < MAX_NEW:
        srv.step()  # every request's first MAX_NEW tokens are checked
    for r in reqs:
        r.cancel()
    srv.run_until_idle()
    if live != 8:
        raise RuntimeError(f"{live} slots live in the steady spec steps")
    d = [b - a for a, b in zip(c0, c1)]
    window.update(tokens_committed_per_step=d[0] / SPEC_WINDOW_STEPS,
                  tokens_committed_per_round=d[0] / max(d[1], 1),
                  drafted_per_step=d[2] / SPEC_WINDOW_STEPS,
                  accepted_per_step=d[3] / SPEC_WINDOW_STEPS)
    return reqs, window


def spec_summary(srv, what, reqs, want, prompts, params, cfg) -> dict:
    """One speculating run's first MAX_NEW tokens a request held against
    the plain greedy run (the near-tie rule), with its acceptance and
    its programs' capture cost."""
    for r in reqs:
        if len(r.tokens) < MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in r.tokens):
            raise RuntimeError(f"{what}: {len(r.tokens)} tokens before "
                               "the cancel, or ids out of the vocabulary")
    reqs = [types.SimpleNamespace(tokens=r.tokens[:MAX_NEW]) for r in reqs]
    stats = srv.speculation_stats()
    return {"near_tie": near_tie_divergence(what, reqs, want, prompts,
                                            params, cfg),
            "tokens_drafted": stats["tokens_drafted"],
            "tokens_accepted": stats["tokens_accepted"],
            "accept_rate": stats["accept_rate"],
            "tokens_per_round": (srv.decode_tokens_committed
                                 / max(srv.decode_rounds, 1)),
            "programs_captured": len(srv._programs),
            "capture_s": srv._programs.capture_seconds()}


def record_rejections(srv) -> list:
    """Log, through `srv`'s commit of decode rounds, every speculative
    round of a row that turned a draft down: (request, index in its
    tokens of the target's own token at the first rejected draft). A
    round the request's budget cut short is no rejection."""
    log = []
    commit = srv._commit_decode_rows

    def logged(live_ids, toks, lps, counts, lens, last, drafted=None,
               owners=None):
        for i, sid in enumerate(live_ids if drafted is not None else ()):
            slot = srv._slots[sid]
            if (slot is None or not srv.active[sid]
                    or (owners is not None and slot is not owners[i])):
                continue
            pos = len(slot.req.tokens)
            for r in range(counts.shape[0]):
                c = int(counts[r, i])
                if 0 < c <= int(drafted[i]) \
                        and pos + c < slot.req.max_new_tokens:
                    log.append((slot.req, pos + c - 1))
                pos += c
        commit(live_ids, toks, lps, counts, lens, last, drafted, owners)

    srv._commit_decode_rows = logged
    return log


def rejections_at_ties(what, log, reqs, prompts, params, cfg) -> dict:
    """Where the target drafting for itself turned a draft down, among
    each request's first MAX_NEW tokens: the draft's W 1 and the
    verify's W 5 logits differ only by rounding, so each rejected
    position must be a near tie, its top-2 gap under the plain dense
    forward (over the run's own tokens) within the 25th percentile of
    that forward's top-2 gaps over every position. A fault that turns
    drafts down (a stale page, a shifted window) lands at ordinary gaps
    and fails three times in four per rejection."""
    import numpy as np
    gaps = {}
    for r, prompt in zip(reqs, prompts):
        best = dense_logits(params, cfg, prompt,
                            r.tokens[:MAX_NEW]).topk(2, dim=-1).values
        gaps[id(r)] = (best[:, 0] - best[:, 1]).tolist()
    every = [g for gs in gaps.values() for g in gs]
    at = [gaps[id(req)][p] for req, p in log if p < MAX_NEW]
    limit = float(np.percentile(every, 25))
    if any(g > limit for g in at):
        raise RuntimeError(f"{what}: drafts rejected at top-2 gaps {at}, "
                           f"past the limit {limit} (top-2 gaps p25)")
    return {"rejections": len(at), "rejection_top2_gaps": at,
            "rejection_gap_limit_p25_top2": limit,
            "top2_gap_p5_p50": [float(np.percentile(every, 5)),
                                float(np.percentile(every, 50))]}


def grammar_check(dfa, ids, finish_reason: str) -> dict:
    """Every emitted prefix is live in the byte DFA; a generation that
    ended on EOS ends in an accepting state."""
    from cloud_server_tpu_torch.inference.grammar import DEAD
    body = [t for t in ids if t != BYTE_EOS]
    st = 0
    for t in body:
        if not 0 <= t < 256:
            raise RuntimeError(f"grammar: token {t} is not a byte")
        st = dfa.run(st, bytes([t]))
        if st == DEAD:
            raise RuntimeError(f"grammar: dead prefix {bytes(body)!r}")
    if finish_reason not in ("eos", "stop", "length"):
        raise RuntimeError(f"grammar: the request ended {finish_reason!r}")
    ended = finish_reason in ("eos", "stop")
    if ended and not dfa.accept[st]:
        raise RuntimeError(f"grammar: ended outside the language: "
                           f"{bytes(body)!r}")
    return {"tokens": len(body), "ended_on_eos": ended,
            "text": bytes(body).decode("latin-1")}


def grammar_runs(srv) -> dict:
    """On a speculating server with the overlap pipeline: a regex request
    in process, and while its first decode dispatch is in flight a
    second request with another pattern, which rebuilds the grammar
    stack under that dispatch (it must still commit: its program is
    released only after); then, the server started, response_format
    json_object over HTTP. Every output holds against its DFA."""
    from cloud_server_tpu_torch.inference import grammar
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    from cloud_server_tpu_torch.inference.sampling import SamplingParams
    req = srv.submit(list(b"value: "), max_new_tokens=GRAMMAR_NEW,
                     sampling=SamplingParams(regex=GRAMMAR_REGEX))
    while not req.tokens:
        srv.step()
    if srv._inflight is None or req._done.is_set():
        raise RuntimeError("grammar: no decode dispatch in flight")
    stack_one = srv.grammar_stack_bytes()
    dropped = srv._programs.dropped
    word = srv.submit(list(b"word: "), max_new_tokens=GRAMMAR_NEW,
                      sampling=SamplingParams(regex=GRAMMAR_WORD))
    srv.run_until_idle()
    out = {"in_process": grammar_check(
        grammar.compile_byte_dfa(GRAMMAR_REGEX), req.tokens,
        req.finish_reason),
        "second_pattern_mid_decode": grammar_check(
            grammar.compile_byte_dfa(GRAMMAR_WORD), word.tokens,
            word.finish_reason),
        "stack_bytes_one_pattern": stack_one,
        "programs_released_by_new_pattern": (srv._programs.dropped
                                             - dropped),
        "released_after_their_commit": srv._programs.dropped_in_flight}
    if srv._programs.dropped_in_flight < 1:
        raise RuntimeError("grammar: the new pattern released no program "
                           "in flight")
    front = HttpFrontend(srv.start(), tokenizer=Latin1Tokenizer()).start()
    try:
        host, port = front.address
        status, raw = http_call(
            f"{host}:{port}", "/v1/completions",
            {"prompt": "{", "max_tokens": GRAMMAR_NEW,
             "response_format": {"type": "json_object"}},
            timeout=HTTP_TIMEOUT)
    finally:
        front.stop()
    if status != 200:
        raise RuntimeError(f"json_object over HTTP answered {status}")
    choice = json.loads(raw)["choices"][0]
    out["http_json_object"] = grammar_check(
        grammar.compile_byte_dfa(grammar.json_object_regex()),
        list(choice["text"].encode("latin-1")), choice["finish_reason"])
    out["stack_bytes_three_patterns"] = srv.grammar_stack_bytes()
    out["stack_shape"] = list(srv._model.grammar[0].shape)
    return out


def serve_spec(params, cfg, prompts, plain_tokens, rng) -> dict:
    """In-server speculation at Llama-3.1-8B width (random weights), the
    mixed scheduler with the overlap pipeline and captured graphs, 8
    greedy requests at the fixed draft length: n-gram drafts, then a
    Llama-3.2-1B-width draft model (the counts read over both: verify
    windows on the narrow kernel, the draft's head dim 64 on both
    kernels), each held against the plain greedy tokens by the near-tie
    rule; the target drafting for itself (its own pools), which must
    accept nearly everything; per-request seeded sampling with
    penalties, logit_bias and min_tokens through n-gram speculation
    under the default adaptive controller, graphed against graphs off;
    a grammar request in process and json_object over HTTP; steady
    steps of each speculation source profiled."""
    import torch
    from cloud_server_tpu_torch.config import (InferConfig, ModelConfig,
                                               from_json)
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.inference.sampling import SamplingParams
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    with open(DRAFT_CONFIG) as f:
        dcfg = from_json(ModelConfig, json.load(f)["model"])
    dparams = transformer.init_params(dcfg, SEED + 1, device=DEVICE)
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    want = [types.SimpleNamespace(tokens=t) for t in plain_tokens]
    seconds = {}

    # the main path of this slice: n-gram, then draft-model speculation,
    # at the fixed draft length (`--spec-control off`: on random weights
    # the adaptive controller, which the seeded run below keeps on,
    # turns drafting off); each run's steady steps are profiled
    t0 = time.perf_counter()
    pa.reset_counters()
    ngram = make_server(params, cfg, icfg, spec_drafts=SPEC_DRAFTS,
                        spec_control=False)
    ng_reqs, ng_prof = spec_run(ngram, prompts, cfg.vocab_size)
    draft = make_server(params, cfg, icfg, spec_drafts=SPEC_DRAFTS,
                        spec_control=False, draft_params=dparams,
                        draft_cfg=dcfg)
    dm_reqs, dm_prof = spec_run(draft, prompts, cfg.vocab_size)
    torch.cuda.synchronize()
    counts = pa.counters()
    seconds["main"] = time.perf_counter() - t0
    if (counts["launches_narrow_verify"] <= 0
            or counts["launches_narrow_d64"] <= 0
            or counts["launches_wide_d64"] <= 0
            or counts["launches_wide"] <= 0 or counts["plain_calls"]):
        raise RuntimeError(f"spec serve: launches {counts}")
    out = {"phase": "spec", "model": "Llama-3.1-8B target, Llama-3.2-1B "
           "width draft (random bf16 weights)", "spec_drafts": SPEC_DRAFTS,
           "counts": counts,
           "ngram": spec_summary(ngram, "n-gram speculation", ng_reqs,
                                 want, prompts, params, cfg),
           "draft_model": spec_summary(draft, "draft-model speculation",
                                       dm_reqs, want, prompts, params,
                                       cfg)}
    out["ngram"]["profile"] = ng_prof
    out["draft_model"]["profile"] = dm_prof
    ngram.stop()
    draft.stop()
    del ngram, draft, dparams, ng_reqs, dm_reqs
    gc.collect()
    torch.cuda.empty_cache()

    # the target as its own draft: the same tensors, its own pools
    t0 = time.perf_counter()
    selfd = make_server(params, cfg, icfg, spec_drafts=SPEC_DRAFTS,
                        spec_control=False, draft_params=params,
                        draft_cfg=cfg, decode_chunk=SELF_DRAFT_ROUNDS)
    rejected = record_rejections(selfd)
    sd_reqs, sd_steady = spec_run(selfd, prompts, cfg.vocab_size,
                                  profiled=False)
    ties = rejections_at_ties("self-draft speculation", rejected, sd_reqs,
                              prompts, params, cfg)
    sd = out["self_draft"] = spec_summary(
        selfd, "self-draft speculation", sd_reqs, want, prompts, params,
        cfg)
    sd["rejections_at_ties"] = ties
    sd["steady"] = sd_steady
    sd["steady_accept_rate"] = (sd_steady["accepted_per_step"]
                                / max(sd_steady["drafted_per_step"], 1e-9))
    selfd.stop()
    del selfd, sd_reqs
    p32, cfg32 = f32_slice(params, cfg)
    selfd = make_server(p32, cfg32, icfg, spec_drafts=SPEC_DRAFTS,
                        spec_control=False, draft_params=p32,
                        draft_cfg=cfg32, decode_chunk=SELF_DRAFT_ROUNDS)
    _, f32_steady = spec_run(selfd, prompts, cfg.vocab_size,
                             profiled=False)
    selfd.stop()
    del selfd, p32
    sd["f32_slice_steady_accept_rate"] = (
        f32_steady["accepted_per_step"]
        / max(f32_steady["drafted_per_step"], 1e-9))
    seconds["self_draft"] = time.perf_counter() - t0
    if (sd["f32_slice_steady_accept_rate"] < SELF_DRAFT_MIN_ACCEPT
            or sd["accept_rate"] < SELF_DRAFT_BF16_FLOOR):
        raise RuntimeError(
            f"self-draft accepted {sd['f32_slice_steady_accept_rate']} of "
            f"its steady drafts in float32 (at least "
            f"{SELF_DRAFT_MIN_ACCEPT}), {sd['accept_rate']} of its drafts "
            f"in bf16 (at least {SELF_DRAFT_BF16_FLOOR})")

    # per-request seeded sampling with the A12 options through n-gram
    # speculation, on the first SEEDED_LAYERS layers: graphed == graphs
    # off, token for token
    t0 = time.perf_counter()
    p_cut, cfg_cut = first_layers(params, cfg, SEEDED_LAYERS)
    icfg_s = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                         eos_token_id=BYTE_EOS, pad_token_id=0)
    sampling = [SamplingParams(
        seed=2000 + i, temperature=0.8, top_p=0.9, repetition_penalty=1.2,
        frequency_penalty=0.5, logit_bias=((BYTE_EOS, 3.0), (17 + i, 2.0)),
        min_tokens=8) for i in range(len(prompts))]
    runs = {}
    for graphed in (False, True):
        srv = make_server(p_cut, cfg_cut, icfg_s, spec_drafts=SPEC_DRAFTS,
                          cuda_graphs=graphed, tokenizer=ByteTokenizer())
        reqs, _, _, _ = serve_once(p_cut, cfg_cut, icfg_s, prompts, srv=srv,
                                   sampling=sampling)
        runs[graphed] = ([r.tokens for r in reqs],
                         srv.speculation_stats(), srv)
        if not graphed:
            srv.stop()
    same_tokens("seeded A12 speculation graphed vs graphs off",
                [types.SimpleNamespace(tokens=t) for t in runs[True][0]],
                runs[False][0])
    lens = [len(t) for t in runs[True][0]]
    if min(lens) < 8:
        raise RuntimeError(f"min_tokens 8 not held: lengths {lens}")
    seconds["seeded"] = time.perf_counter() - t0
    out["seeded_a12"] = {"graphed_equals_graphs_off": True,
                         "lengths": lens,
                         "tokens_drafted": runs[True][1]["tokens_drafted"],
                         "tokens_accepted": runs[True][1]["tokens_accepted"]}

    # grammar on the graphed seeded server (the same depth), in process
    # then over HTTP
    t0 = time.perf_counter()
    srv = runs[True][2]
    try:
        out["grammar"] = grammar_runs(srv)
    finally:
        srv.stop()
    seconds["grammar"] = time.perf_counter() - t0
    del srv, runs, p_cut
    gc.collect()
    torch.cuda.empty_cache()
    seconds["total"] = time.perf_counter() - t_phase
    out["seconds"] = seconds
    emit(out)
    return out


def phase_serve() -> dict:
    import numpy as np
    import torch
    from cloud_server_tpu_torch.config import (InferConfig, ModelConfig,
                                               from_json)
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(CONFIG) as f:
        cfg = from_json(ModelConfig, json.load(f)["model"])
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    rng = np.random.default_rng(SEED)
    prompts = make_prompts(rng, cfg.vocab_size)

    # the main path: the default server (mixed scheduler, overlap,
    # captured graphs); the counts are read right after it
    torch.cuda.reset_peak_memory_stats()
    srv = make_server(params, cfg, icfg)
    pa.reset_counters()
    reqs, t_start, t_end, pool_bytes = serve_once(params, cfg, icfg,
                                                  prompts, srv=srv)
    counts = pa.counters()
    peak = torch.cuda.max_memory_allocated()
    programs = len(srv._programs)
    capture_s = srv._programs.capture_seconds()
    check_served(reqs, cfg.vocab_size)
    if counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0:
        raise RuntimeError(f"kernel classes not both launched: {counts}")
    if counts["plain_calls"] != 0:
        raise RuntimeError(f"plain attention ran on the path: {counts}")
    tokens = [r.tokens for r in reqs]
    seconds = {"main": t_end - t_start}
    t0 = time.perf_counter()
    eager, _, _, _ = serve_once(params, cfg, icfg, prompts,
                                cuda_graphs=False)
    same_tokens("graphed vs graphs off", eager, tokens)
    seconds["graphs_off"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again, _, _, _ = serve_once(params, cfg, icfg, prompts)
    same_tokens("a second run of the same requests", again, tokens)
    seconds["second_run"] = time.perf_counter() - t0
    dense = check_dense_agreement(params, cfg, prompts[2])
    t0 = time.perf_counter()
    alt, _, _, _ = serve_once(params, cfg, icfg, prompts,
                              scheduler="alternating")
    alternating = near_tie_divergence("the alternating scheduler", alt,
                                      reqs, prompts, params, cfg)
    alternating.update(schedulers_in_f32(params, cfg, prompts))
    seconds["alternating"] = time.perf_counter() - t0
    del eager, again, alt
    gc.collect()
    t0 = time.perf_counter()
    seeded = seeded_runs(params, cfg, rng, prompts)
    seconds["seeded"] = time.perf_counter() - t0
    out = {"phase": "serve", "model": "Llama-3.1-8B (random bf16 weights)",
           "layers": cfg.num_layers, "requests": len(reqs),
           "prompt_tokens": sum(PROMPT_LENS), "max_new_tokens": MAX_NEW,
           "init_s": init_s, **serving_rates(reqs, t_start, t_end),
           "peak_mem_gb": peak / 1e9, "kv_pool_bytes": pool_bytes,
           "counts": counts, "programs_captured": programs,
           "capture_s": capture_s, "graphed_equals_graphs_off": True,
           "second_run_identical": True,
           "alternating_vs_mixed": alternating, **dense, **seeded}
    del reqs
    t0 = time.perf_counter()
    phase_profile(srv, cfg, rng)
    seconds["profile"] = time.perf_counter() - t0
    out["seconds"] = seconds
    emit(out)
    out["tokens"] = tokens  # the tp phase holds its tokens against them
    # the plain server stays up: its steady steps are timed and
    # profiled in turns with the policy server's
    out["policy"] = phase_policy(params, cfg, icfg, prompts, tokens, srv)
    srv.stop()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = serve_int8(params, cfg, icfg, prompts, tokens, pool_bytes,
                             rng)
    gc.collect()
    torch.cuda.empty_cache()
    out["spec"] = serve_spec(params, cfg, prompts, tokens, rng)
    gc.collect()
    torch.cuda.empty_cache()
    out["fleet"] = phase_fleet(params, cfg, icfg, prompts, tokens,
                               out["int8"]["tokens"])
    gc.collect()
    torch.cuda.empty_cache()
    out["elastic"] = phase_elastic(params, cfg, icfg, prompts, tokens)
    gc.collect()
    torch.cuda.empty_cache()
    out["contiguous"] = phase_contiguous(params, cfg, icfg, prompts, tokens,
                                         pool_bytes)
    return out


# ---------------------------------------------------------------------------
# Phase 3h: the contiguous engine and server, beam search, the speculative
# batch API and int8 weight-only params
# ---------------------------------------------------------------------------

CONTIG_PREFIX = 512   # the shared prefix of the --prefix check, in tokens
BEAM_K, BEAM_NEW, BEAM_PROMPTS = 4, 16, 2
CONTIG_DRAFTS = 4
# the order of the quantized/bf16 steady steps profiled in turns
QUANT_PROFILE_TURNS = ("bf16", "int8w", "int8w", "bf16")
# the int8 weight-only part's depth (its checks are against its own
# dequantized weights, at any depth)
QUANT_LAYERS = 16


def contiguous_cfg(cfg):
    """The contiguous path's config: prefill on the flash route (B3),
    decode on the plain cached attention (the reference's contiguous
    server refuses the paged kernel)."""
    import dataclasses
    return dataclasses.replace(cfg, attention_impl="flash",
                               decode_attention_impl="xla")


def make_contiguous(params, cfg, icfg, **kw):
    """The contiguous server a user gets: 8 slots of MAX_CTX positions,
    the overlap pipeline and captured programs."""
    from cloud_server_tpu_torch.inference.server import InferenceServer
    return InferenceServer(params, cfg, icfg, max_slots=8, max_len=MAX_CTX,
                           seed=SEED, device=DEVICE, **kw)


def count_admissions(srv) -> list:
    """Count `srv`'s admission launches (one per group) into the
    returned one-element list."""
    n = [0]
    real = srv._admit_group

    def counted(*a, **kw):
        n[0] += 1
        return real(*a, **kw)
    srv._admit_group = counted
    return n


def release(srv) -> None:
    """Stop `srv` and hand its memory back to the card (its graph pool
    and the warm-ups' blocks), so the next server's captures find it."""
    import torch
    srv.stop()
    gc.collect()
    torch.cuda.empty_cache()


def run_contiguous(srv, prompts, max_new=MAX_NEW) -> tuple:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    srv.run_until_idle()
    torch.cuda.synchronize()
    return reqs, t0, time.perf_counter()


def steady_profiles(servers: dict, prompts, turns) -> dict:
    """Fill every server of `servers` ({name: server}) with the prompts
    (LONG_NEW new tokens each), step each until every request has two
    tokens, then profile one steady step of each in the order `turns`;
    {name: mean profile}. The requests are cancelled after."""
    runs = {}
    for name, srv in servers.items():
        reqs = [srv.submit(p, max_new_tokens=LONG_NEW) for p in prompts]
        while not all(len(r.tokens) >= 2 for r in reqs):
            srv.step()
        srv.step()
        runs[name] = reqs
    profs = {name: [] for name in servers}
    for name in turns:
        profs[name].append(profile_step(servers[name].step))
    for name, srv in servers.items():
        cancel_all(srv, runs[name])
    return {name: mean_profile(p) for name, p in profs.items()}


def padded(prompts, device):
    """Right-padded (B, P) prompts and their lengths on the card."""
    import torch
    p = max(len(x) for x in prompts)
    rows = torch.zeros((len(prompts), p), dtype=torch.int64)
    for i, x in enumerate(prompts):
        rows[i, :len(x)] = torch.tensor(x)
    return (rows.to(device),
            torch.tensor([len(x) for x in prompts], device=device))


def rows_as_requests(rows) -> list:
    return [types.SimpleNamespace(tokens=list(r)) for r in rows]


def dequantized_bf16(qparams):
    """`dequantize_params` of a quantized tree, cast to bf16 a layer at a
    time (the f32 tree of 32 layers would not fit beside the others)."""
    import torch
    from cloud_server_tpu_torch.models.quantization import QTensor

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if not isinstance(x, QTensor):
            return x
        if x.q.dim() == 2:  # lm_head
            return x.to(torch.bfloat16)
        out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.q.device)
        for i in range(x.shape[0]):
            out[i] = x[i].to(torch.bfloat16)
        return out
    return conv(qparams)


def contiguous_server_part(params, cfg, icfg, prompts, plain_tokens,
                           pool_bytes) -> dict:
    """The contiguous server at all 32 layers, greedy, graphed: B3 on
    every admission, the tokens against the paged server's by the
    near-tie rule, graphs off the same, a steady step profiled."""
    import torch
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import paged_attention as pa
    ccfg = contiguous_cfg(cfg)
    want = rows_as_requests(plain_tokens)
    torch.cuda.reset_peak_memory_stats()
    srv = make_contiguous(params, ccfg, icfg)
    admitted = count_admissions(srv)
    fl.reset_counters()
    pa.reset_counters()
    reqs, t0, t1 = run_contiguous(srv, prompts)
    n_admit = admitted[0]
    b3 = fl.counters()
    paged = pa.counters()
    peak = torch.cuda.max_memory_allocated()
    check_served(reqs, cfg.vocab_size)
    # a captured program's first launch also runs it once, eagerly, as
    # its warm-up: B3 launches there too
    admits = [k for k in srv._programs.keys() if k[0].startswith("_admit")]
    captured = sum(srv._programs._programs[k].graph is not None
                   for k in admits)
    expect = cfg.num_layers * (n_admit + captured)
    if (b3["launches_fwd"] != expect or b3["plain_calls"]
            or sum(paged.values())):
        raise RuntimeError(f"contiguous B3 {b3} (expected {expect} "
                           f"launches: {n_admit} admissions, "
                           f"{captured} captured), paged {paged}")
    tokens = [r.tokens for r in reqs]
    rates = serving_rates(reqs, t0, t1)
    vs_paged = near_tie_divergence("the contiguous server vs the paged one",
                                   reqs, want, prompts, params, cfg)
    off = make_contiguous(params, ccfg, icfg, cuda_graphs=False)
    fl.reset_counters()
    off_reqs, _, _ = run_contiguous(off, prompts)
    same_tokens("contiguous graphed vs graphs off", off_reqs, tokens)
    if fl.counters()["launches_fwd"] != cfg.num_layers or fl.counters()[
            "plain_calls"]:
        raise RuntimeError(f"graphs off B3 {fl.counters()}")
    release(off)
    prof = steady_profiles({"contiguous": srv}, prompts,
                           ("contiguous",) * PROFILE_STEPS)["contiguous"]
    out = {"layers": cfg.num_layers, "b3_counts": b3,
           "admissions": n_admit, "admission_programs": len(admits),
           "admission_captures": captured,
           "programs": len(srv._programs),
           "capture_s": srv._programs.capture_seconds(),
           **rates, "peak_mem_gb": peak / 1e9,
           "cache_bytes": srv.kv_cache_bytes(),
           "paged_pool_bytes": pool_bytes,
           "vs_paged": vs_paged, "graphed_equals_graphs_off": True,
           "steady_step": prof}
    release(srv)
    return out


def contiguous_prefix_part(params, cfg, icfg, prompts, rng) -> dict:
    """--prefix on the first SEEDED_LAYERS layers: the prompts behind a
    shared CONTIG_PREFIX-token prefix against the same prompts without
    it (near ties); on the 2-layer float32 slice the two give equal
    tokens. The server's default remainder cap (1024) sends the two
    longest prompts through the plain prefill, as the reference's rule
    does (a verify-step remainder attends densely: its scores grow with
    remainder x context)."""
    p8, c8 = first_layers(params, cfg, SEEDED_LAYERS)
    prefix = rng.integers(0, cfg.vocab_size, CONTIG_PREFIX).tolist()
    long_prompts = [prefix + p for p in prompts]
    hits = sum(len(p) <= 1024 for p in prompts)
    runs = {}
    for what, pc, cf in (("bf16", p8, contiguous_cfg(c8)),
                         ("f32", *f32_slice(params, cfg))):
        got = {}
        for use in (True, False):
            srv = make_contiguous(pc, cf, icfg,
                                  prefix_tokens=prefix if use else None)
            reqs, t0, t1 = run_contiguous(srv, long_prompts)
            check_served(reqs, cfg.vocab_size)
            if use and (srv.prefix_hits, srv.prefix_misses) != (
                    hits, len(prompts) - hits):
                raise RuntimeError(f"prefix hits {srv.prefix_hits}, "
                                   f"misses {srv.prefix_misses}")
            got[use] = (reqs, t1 - t0)
            release(srv)
        runs[what] = got
    same_tokens("--prefix vs none, float32 2 layers", runs["f32"][True][0],
                [r.tokens for r in runs["f32"][False][0]])
    return {"prefix_tokens": CONTIG_PREFIX, "layers": SEEDED_LAYERS,
            "prefix_hits": hits, "prefix_misses": len(prompts) - hits,
            "vs_no_prefix": near_tie_divergence(
                "--prefix vs no prefix", runs["bf16"][True][0],
                runs["bf16"][False][0], long_prompts, p8, c8),
            "f32_slice_exact": True,
            "wall_s": {"prefix": runs["bf16"][True][1],
                       "no_prefix": runs["bf16"][False][1]}}


def contiguous_beam_part(params, cfg, icfg, prompts) -> dict:
    """beam_search (k 4, 2 prompts, 16 new) on the first SEEDED_LAYERS
    layers, timed; k 1 against the engine's greedy tokens."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.inference import beam_search, engine
    from cloud_server_tpu_torch.utils import prng
    p8, c8 = first_layers(params, contiguous_cfg(cfg), SEEDED_LAYERS)
    rows, lens = padded(prompts[:BEAM_PROMPTS], DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, scores = beam_search(p8, rows, cfg=c8, k=BEAM_K, max_new=BEAM_NEW,
                               prompt_lengths=lens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if (tuple(toks.shape) != (BEAM_PROMPTS, BEAM_K, BEAM_NEW)
            or not bool(torch.isfinite(scores).all())
            or not bool((scores[:, :-1] >= scores[:, 1:]).all())):
        raise RuntimeError(f"beam: {tuple(toks.shape)}, scores {scores}")
    one, _ = beam_search(p8, rows, cfg=c8, k=1, max_new=BEAM_NEW,
                         prompt_lengths=lens)
    greedy = engine.generate(
        p8, rows, prng.key(SEED), cfg=c8,
        infer_cfg=dataclasses.replace(icfg, max_decode_len=BEAM_NEW),
        prompt_lengths=lens)
    k1 = near_tie_divergence(
        "beam k 1 vs greedy", rows_as_requests(one[:, 0].tolist()),
        rows_as_requests(greedy.tolist()), prompts[:BEAM_PROMPTS],
        *first_layers(params, cfg, SEEDED_LAYERS))
    return {"k": BEAM_K, "prompts": BEAM_PROMPTS, "max_new": BEAM_NEW,
            "layers": SEEDED_LAYERS, "ms": ms,
            "scores": scores.tolist(), "k1_vs_greedy": k1}


def contiguous_spec_part(params, cfg, icfg, prompts) -> dict:
    """speculative_generate with CONTIG_DRAFTS drafts on the first
    SEEDED_LAYERS layers, n-gram and the Llama-3.2-1B-width draft (its
    first SEEDED_LAYERS layers; B3 at Dh 64 in its prefill), against
    engine.generate by the near-tie rule; its rounds (verify passes)
    and time."""
    import torch
    from cloud_server_tpu_torch.config import ModelConfig, from_json
    from cloud_server_tpu_torch.inference import engine
    from cloud_server_tpu_torch.inference.speculative import (
        speculative_generate)
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.utils import prng
    p8, c8 = first_layers(params, contiguous_cfg(cfg), SEEDED_LAYERS)
    oracle = first_layers(params, cfg, SEEDED_LAYERS)
    rows, lens = padded(prompts, DEVICE)
    greedy = engine.generate(p8, rows, prng.key(SEED), cfg=c8,
                             infer_cfg=icfg, prompt_lengths=lens)
    with open(DRAFT_CONFIG) as f:
        dcfg = contiguous_cfg(from_json(ModelConfig, json.load(f)["model"]))
    dparams, dcfg = first_layers(
        transformer.init_params(dcfg, SEED + 1, device=DEVICE), dcfg,
        SEEDED_LAYERS)
    rounds = [0]
    real = engine.verify_step

    def counted(*a, **kw):
        rounds[0] += 1
        return real(*a, **kw)
    out = {"drafts": CONTIG_DRAFTS, "layers": SEEDED_LAYERS}
    engine.verify_step = counted
    try:
        for what, dp, dc in (("ngram", None, None),
                             ("draft_model", dparams, dcfg)):
            rounds[0] = 0
            fl.reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = speculative_generate(
                p8, dp, rows, prng.key(SEED), cfg=c8, draft_cfg=dc,
                infer_cfg=icfg, num_draft=CONTIG_DRAFTS, prompt_lengths=lens)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            b3 = fl.counters()
            want_b3 = c8.num_layers + (0 if dc is None else dc.num_layers)
            if b3["launches_fwd"] != want_b3 or b3["plain_calls"]:
                raise RuntimeError(f"spec {what} B3 {b3}")
            out[what] = {
                "ms": ms, "rounds": rounds[0],
                "tokens_a_round": MAX_NEW / max(rounds[0], 1),
                "b3_launches": b3["launches_fwd"],
                "vs_generate": near_tie_divergence(
                    f"speculative_generate ({what}) vs generate",
                    rows_as_requests(toks.tolist()),
                    rows_as_requests(greedy.tolist()), prompts, *oracle)}
    finally:
        engine.verify_step = real
    return out


def contiguous_quant_part(params, cfg, icfg, prompts) -> dict:
    """Int8 weight-only params at QUANT_LAYERS layers: the stored bytes;
    the default paged server's tokens against a server on the
    dequantized weights cast to bf16 (the same products: identical), B1
    and B2
    counted, the graph pool's peak; a steady decode step profiled in
    turns with that bf16 server's (its programs already captured); then
    one batch on the contiguous server the same way."""
    import torch
    from cloud_server_tpu_torch.models.quantization import (
        quantize_params, quantized_bytes)
    from cloud_server_tpu_torch.ops import paged_attention as pa
    qparams = quantize_params(params)
    stored, bf16_bytes = quantized_bytes(qparams)
    deq = dequantized_bf16(qparams)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qsrv = make_server(qparams, cfg, icfg)
    pa.reset_counters()
    qreqs, t0, t1, _ = serve_once(qparams, cfg, icfg, prompts, srv=qsrv)
    counts = pa.counters()
    pool_peak = torch.cuda.max_memory_allocated() - base
    check_served(qreqs, cfg.vocab_size)
    if (counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0
            or counts["plain_calls"]):
        raise RuntimeError(f"quantized paged server: {counts}")
    dsrv = make_server(deq, cfg, icfg)
    dreqs, _, _, _ = serve_once(deq, cfg, icfg, prompts, srv=dsrv)
    same_tokens("quantized vs dequantized bf16 (paged)", dreqs,
                [r.tokens for r in qreqs])
    profs = steady_profiles({"bf16": dsrv, "int8w": qsrv}, prompts,
                            QUANT_PROFILE_TURNS)
    release(dsrv)
    release(qsrv)
    ccfg = contiguous_cfg(cfg)
    ctoks = {}
    for what, tree in (("int8w", qparams), ("dequantized", deq)):
        srv = make_contiguous(tree, ccfg, icfg)
        reqs, c0, c1 = run_contiguous(srv, prompts)
        check_served(reqs, cfg.vocab_size)
        ctoks[what] = (reqs, c1 - c0)
        release(srv)
    same_tokens("quantized vs dequantized bf16 (contiguous)",
                ctoks["int8w"][0], [r.tokens for r in ctoks["dequantized"][0]])
    busy = {k: v["device_busy_ms"] for k, v in profs.items()}
    return {"stored_bytes": stored, "bf16_bytes": bf16_bytes,
            "stored_share": stored / bf16_bytes, "paged_counts": counts,
            "paged_wall_s": t1 - t0,
            "paged_equals_dequantized": True,
            "contiguous_equals_dequantized": True,
            "contiguous_wall_s": {k: v[1] for k, v in ctoks.items()},
            "graph_pool_peak_gb": pool_peak / 1e9,
            "steady_step": profs,
            "busy_ratio_int8w_over_bf16": busy["int8w"] / busy["bf16"]}


def phase_contiguous(params, cfg, icfg, prompts, plain_tokens,
                     pool_bytes) -> dict:
    """This slice's paths at Llama-3.1-8B widths, the serve phase's
    weights and prompts: the contiguous server (all 32 layers), --prefix,
    beam search and speculative_generate (the first SEEDED_LAYERS
    layers), int8 weight-only params (the first QUANT_LAYERS). Each
    part's line is printed as soon as it has run."""
    import gc
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    seconds, out = {}, {"phase": "contiguous"}
    for name, fn in (
            ("server", lambda: contiguous_server_part(
                params, cfg, icfg, prompts, plain_tokens, pool_bytes)),
            ("prefix", lambda: contiguous_prefix_part(params, cfg, icfg,
                                                      prompts, rng)),
            ("beam", lambda: contiguous_beam_part(params, cfg, icfg,
                                                  prompts)),
            ("spec", lambda: contiguous_spec_part(params, cfg, icfg,
                                                  prompts)),
            ("quant", lambda: contiguous_quant_part(
                *first_layers(params, cfg, QUANT_LAYERS), icfg,
                prompts))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        emit({"phase": "contiguous", "part": name, **out[name],
              "seconds": seconds[name]})
        gc.collect()
        torch.cuda.empty_cache()
    seconds["total"] = time.perf_counter() - t_phase
    out["seconds"] = seconds
    out["b3_layer"] = b3_embed_layer([(MAX_CTX, 8)])
    emit({"phase": "contiguous", "seconds": seconds,
          "b3_layer": out["b3_layer"]})
    srv_, q = out["server"], out["quant"]
    print(f"contiguous: {srv_['vs_paged']['diverged_requests']} diverged "
          f"from paged; step busy {srv_['steady_step']['device_busy_ms']} "
          f"ms; TTFT p50 {srv_['ttft_p50_s']:.3f} s; int8 weights "
          f"{q['stored_share']:.3f} of bf16, step busy x"
          f"{q['busy_ratio_int8w_over_bf16']:.2f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 3b: the host policy layer on the serving path
# ---------------------------------------------------------------------------

POLICY_QOS = {"tenants": {
    "chat": {"weight": 4.0, "priority": "interactive"},
    "batch": {"weight": 2.0, "priority": "batch"},
    "bulk": {"weight": 1.0, "priority": "best_effort", "max_pending": 2}}}
POLICY_TENANTS = ["chat", "batch", "bulk"]
# the three classes of inference/slo.py's documented config
POLICY_SLO = {"windows_s": [60, 300, 3600], "classes": {
    "interactive": {"objective": 0.99, "ttft_s": 0.5, "itl_s": 0.1,
                    "queue_wait_s": 0.25, "e2e_s": 30.0},
    "batch": {"objective": 0.95, "ttft_s": 5.0, "e2e_s": 120.0},
    "default": {"objective": 0.99, "e2e_s": 60.0}}}
# graded every busy iteration; it would shed only a queue head older
# than 5 s (utilization and host gap are bounded by 1, so their
# thresholds never cross: a fresh server's captures are host time)
POLICY_BROWNOUT = {"pending_age_s": 5.0, "budget_utilization": 1.01,
                   "host_gap_frac": 1.01, "hold_s": 1.0}
# the rules this run's counts decide; the wall-clock EWMA rules are off
# so that one deadline_spike is the only activation edge
POLICY_RULES_OFF = ["slo_burn", "latency_shift", "cache_collapse",
                    "breaker_flap", "preempt_spike", "host_gap", "wedged"]
# the reference's debug_bundle keys
BUNDLE_KEYS = {"schema", "trigger", "ts", "anomaly", "metrics", "profile",
               "flight", "traces", "tail_traces", "tail_retention", "slo",
               "cache", "brownout", "migration", "faults", "overlap"}
# decode budget of the policy phase's steady requests: its timed and
# profiled steps, deadline, capture, stall and route windows all fall inside it
POLICY_NEW = 256
# the order of the policy phase's profiled steps: two ABBA rounds, the
# second reversed, so a drift of the card's clocks weighs on both alike
POLICY_PROFILE_TURNS = ("plain", "policy", "policy", "plain",
                        "policy", "plain", "plain", "policy")


def trace_kernels(logdir) -> dict:
    """The device kernels of the torch.profiler trace(s) in `logdir`:
    the trace files, kernel events, and paged_narrow_kernel events."""
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(logdir)
                   for f in fs if f.endswith(".pt.trace.json"))
    kernels = narrow = 0
    for path in files:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel":
                kernels += 1
                narrow += "paged_narrow_kernel" in e.get("name", "")
    return {"files": len(files), "kernel_events": kernels,
            "paged_narrow_kernel_events": narrow}


def drr_replay(qos_cfg, events) -> list:
    """The admission order the port's qos.py gives for the same submits:
    a fresh TenantRegistry fed the run's submits (refused ones too) and,
    at each admission burst, asked as many times as the server admitted
    then (pages and slots decide how many, DRR which), and once more,
    uncharged, where an injected page famine cut a burst short."""
    from cloud_server_tpu_torch.inference.qos import TenantRegistry
    reg = TenantRegistry(qos_cfg)
    pending, order = [], []
    for ev in events:
        if ev[0] == "submit":
            _, i, tenant, n, ok = ev
            try:
                reg.gate_submit(tenant, n)
            except Exception:  # noqa: BLE001 — a refusal the server saw
                if ok:
                    raise
            if ok:
                pending.append(types.SimpleNamespace(
                    i=i, tenant=tenant, prompt=[0] * n, tokens=[]))
        elif ev[0] == "famine":
            reg.next_admission_index(pending)
        else:
            for _ in ev[1]:
                r = pending.pop(reg.next_admission_index(pending))
                reg.charge_admission(r.tenant, len(r.prompt))
                reg.on_pending_removed(r.tenant)
                order.append(r.i)
    return order


def policy_run(srv, jobs, max_new) -> tuple:
    """Serve `jobs` [(index, prompt, tenant)] on `srv` by hand-driven
    steps, retrying refused submits (an injected rejection, a tenant at
    its pending bound) after each step; the admissions of each step are
    read in slot order (a burst fills free slots in ascending order).
    Returns (requests by index, events for drr_replay, refusals)."""
    queue, reqs, events, refused = list(jobs), {}, [], []
    famines = srv.fault_stats()["fired"]["alloc_famine"]

    def try_submit():
        left = []
        for i, prompt, tenant in queue:
            try:
                reqs[i] = srv.submit(prompt, max_new_tokens=max_new,
                                     tenant=tenant)
                events.append(("submit", i, tenant, len(prompt), True))
            except Exception as exc:  # noqa: BLE001 — retried, recorded
                refused.append((i, type(exc).__name__))
                if type(exc).__name__ == "TenantQueueFullError":
                    events.append(("submit", i, tenant, len(prompt), False))
                left.append((i, prompt, tenant))
        queue[:] = left

    try_submit()
    admitted: set = set()
    while queue or srv.num_pending or srv.num_active or srv._jobs:
        srv.step()
        slot_of = {id(s.req): sid for sid, s in enumerate(srv._slots)
                   if s is not None}
        new = [i for i, r in reqs.items()
               if r.admit_time is not None and i not in admitted]
        if new:
            admitted.update(new)
            events.append(("admit", sorted(
                new, key=lambda i: slot_of.get(id(reqs[i]), 1 << 30))))
        fired = srv.fault_stats()["fired"]["alloc_famine"]
        if fired > famines:  # the burst's last pick, never charged
            events.append(("famine",))
            famines = fired
        try_submit()
    return reqs, events, refused


def policy_steady(srv, prompts, max_new=POLICY_NEW, **per_request) -> list:
    """8 requests decoding in 8 slots with a dispatch in flight,
    admissions done; `per_request` maps a submit argument to a list of
    its values, one a prompt."""
    reqs = [srv.submit(p, max_new_tokens=max_new,
                       **{k: v[i] for k, v in per_request.items()})
            for i, p in enumerate(prompts)]
    while srv._jobs or srv.num_pending:
        srv.step()
    for _ in range(2):
        srv.step()
    if srv.num_active != 8 or srv._inflight is None:
        raise RuntimeError(f"{srv.num_active} slots live, not 8 with a "
                           "dispatch in flight")
    return reqs


def phase_policy(params, cfg, icfg, prompts, plain_tokens,
                 plain_srv) -> dict:
    """The serving path with every policy of the host layer configured:
    QoS over three tenants, SLO tracking, tracing at 100% with a tail
    ring, brownout, the anomaly watchdog (deadline_spike arming a
    profiler window and a debug bundle) and a seeded fault plan. The
    layer adds no device work: its steady decode step is the plain
    server's program (one graph launch, the same kernels by group, the
    same host copy and sync calls, busy within 3%). Then deadlines, the routes, POST /debug/trace and a
    dispatch fault with a dispatch in flight. `plain_srv` (the serve
    phase's server) decodes the same steady batch beside it: their
    steady steps are timed, then profiled, in turns
    (POLICY_PROFILE_TURNS), so both readings cover the same step
    indices of the same batch."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from cloud_server_tpu_torch.inference.faults import FaultPlan
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-policy-")
    front = None
    try:
        capture_dir = os.path.join(tmp, "anomaly")
        plan = FaultPlan({"seed": SEED, "faults": [
            {"site": "submit_reject", "after": 4, "count": 1},
            {"site": "alloc_famine", "after": 1, "count": 1}]})
        srv = make_server(
            params, cfg,
            dataclasses.replace(icfg, trace_tail_capacity=16,
                                bundle_on_anomaly=True),
            qos=POLICY_QOS, slo=POLICY_SLO, tracing=1.0, faults=plan,
            brownout=POLICY_BROWNOUT,
            anomaly={"warmup": 2, "check_every": 1, "hold_s": 60.0,
                     "capture_iters": 2, "capture_dir": capture_dir,
                     "disable": POLICY_RULES_OFF,
                     "rules": {"deadline_spike": {"count": 3,
                                                  "window_s": 60.0}}})
        # a profiler window over the first step: the programs captured
        # there are captured under an active profiler
        first_dir = os.path.join(tmp, "first")
        srv.request_trace(1, first_dir)
        pa.reset_counters()
        # 1-2. twelve greedy requests, four a tenant (the serve phase's
        # four shortest prompts, three times): the plain tokens up to
        # near ties, and the DRR admission order
        jobs = [(i, prompts[i % 4], POLICY_TENANTS[i % 3])
                for i in range(12)]
        t0 = time.perf_counter()
        reqs, events, refused = policy_run(srv, jobs, MAX_NEW)
        parts = {"served": time.perf_counter() - t0}
        programs = len(srv._programs)
        capture_s = srv._programs.capture_seconds()
        t0 = time.perf_counter()
        reqs = [reqs[i] for i in range(12)]
        check_served(reqs, cfg.vocab_size, MAX_NEW)
        want = [types.SimpleNamespace(tokens=plain_tokens[i % 4])
                for i in range(12)]
        ties = near_tie_divergence("the policy server", reqs, want,
                                   [j[1] for j in jobs], params, cfg)
        order = [i for ev in events if ev[0] == "admit" for i in ev[1]]
        drr = drr_replay(POLICY_QOS, events)
        if order != drr:
            raise RuntimeError(f"admission order {order}, the DRR order "
                               f"{drr}")
        # an injected rejection and bulk's pending bound refuse submits;
        # brownout sheds bulk while the queue head is older than 5 s
        kinds = {k for _, k in refused}
        if not ({"InjectedFault", "TenantQueueFullError"} <= kinds
                <= {"InjectedFault", "TenantQueueFullError",
                    "BrownoutShedError"}):
            raise RuntimeError(f"refused submits {refused}")
        first = trace_kernels(first_dir)
        if first["files"] != 1 or first["kernel_events"] <= 0:
            raise RuntimeError(f"the first window's trace: {first}")
        parts["checks"] = time.perf_counter() - t0
        # 3. a steady batch on both servers (the four prompts twice, 8
        # slots x 8 rounds a step): host wall per step timed in turns,
        # then steps under torch.profiler in turns
        t0 = time.perf_counter()
        # the plain server's launches are not the policy path's: they
        # are taken out of the phase's counts
        c_plain = pa.counters()
        plain_steady = policy_steady(plain_srv, prompts[:4] * 2)
        c_plain = {k: v - c_plain[k] for k, v in pa.counters().items()}
        steady = policy_steady(srv, prompts[:4] * 2,
                               tenant=["chat", "batch"] * 4)
        walls = {"plain": [], "policy": []}
        phases = {"plain": {}, "policy": {}}
        profs = {"plain": [], "policy": []}

        def turn(who, run):
            server = plain_srv if who == "plain" else srv
            c1 = pa.counters()
            out = run(server)
            if who == "plain":
                for k, v in pa.counters().items():
                    c_plain[k] += v - c1[k]
            return server, out

        def timed(server):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                server.step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) * 1e3 / PROFILE_STEPS

        for who in ("plain", "policy", "policy", "plain"):
            server, wall = turn(who, timed)
            walls[who].append(wall)
            # the flight records' host phases of the timed steps
            for rec in server.flight_window(PROFILE_STEPS):
                for ph, ms in rec["phases_ms"].items():
                    phases[who][ph] = phases[who].get(ph, 0.0) + ms / (
                        2 * PROFILE_STEPS)
        # single steps under torch.profiler, four a server in balanced
        # turns; a window opens after a sync, so it holds one launch
        # (its copies and its graph) and nothing before it
        for who in POLICY_PROFILE_TURNS:
            profs[who].append(
                turn(who, lambda server: profile_step(server.step))[1])
        plain_srv.stop()  # its requests end "error: ... stopped"
        del plain_steady
        step, plain_step = (mean_profile(profs["policy"]),
                            mean_profile(profs["plain"]))

        def kernels(prof):
            return {g: n for g, n in prof["device_kernels_by_group"].items()
                    if g != "copy"}

        def copies_within_calls(prof):
            # every HtoD/DtoH record has its host call; the records are
            # only reported beside them, because the card's trace drops
            # some: the same 11 cudaMemcpyAsync calls a step read 5 or 6
            # HtoD records by window. A sync added to a step (.item(),
            # .cpu(), synchronize) adds host calls, compared exactly.
            recs = sum(v for k, v in prof["device_copies_by_name"].items()
                       if "HtoD" in k or "DtoH" in k)
            return recs <= prof["host_copy_sync_calls_by_api"].get(
                "cudaMemcpyAsync", 0.0)

        busy_rel = (step["device_busy_ms"] / plain_step["device_busy_ms"]
                    - 1)
        if (any(p["host_launch_calls_by_api"] != {"cudaGraphLaunch": 1}
                or not copies_within_calls(p)
                for p in profs["policy"] + profs["plain"])
                or kernels(step) != kernels(plain_step)
                or (step["host_copy_sync_calls_by_api"]
                    != plain_step["host_copy_sync_calls_by_api"])
                or abs(busy_rel) > 0.03):
            raise RuntimeError(
                f"the policy server's steady steps {profs['policy']} "
                f"against the plain ones {profs['plain']}")
        parts["steady"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # 4. three best-effort requests with 1 ms deadlines while the
        # slots are full (two, then one: `bulk` holds 2 pending): the
        # third expiry activates deadline_spike, which snapshots a
        # bundle and arms a 2-step profiler window
        late = [srv.submit(prompts[0], max_new_tokens=4, tenant="bulk",
                           deadline_s=0.001) for _ in range(2)]
        while not all(r.done for r in late):
            srv.step()
        late.append(srv.submit(prompts[0], max_new_tokens=4,
                               tenant="bulk", deadline_s=0.001))
        while not late[-1].done:
            srv.step()
        for _ in range(2):  # the armed window: the next 2 steps
            srv.step()
        if srv.tracer.active:
            raise RuntimeError("the anomaly's profiler window is open")
        if [r.finish_reason for r in late] != ["deadline"] * 3:
            raise RuntimeError(f"deadline requests ended "
                               f"{[r.finish_reason for r in late]}")
        astats = srv.anomaly_stats()
        bundles = srv.debug_bundles(1)
        if (astats["fired_total"]["deadline_spike"] != 1
                or sum(astats["fired_total"].values()) != 1
                or len(bundles) != 1
                or set(bundles[0]) != BUNDLE_KEYS
                or bundles[0]["trigger"] != "anomaly:deadline_spike"):
            raise RuntimeError(f"watchdog {astats['fired_total']}, "
                               f"{len(bundles)} bundles")
        anomaly_trace = trace_kernels(capture_dir)
        if anomaly_trace["paged_narrow_kernel_events"] < cfg.num_layers * 8:
            raise RuntimeError(f"the anomaly window's trace: "
                               f"{anomaly_trace}")
        parts["deadlines"] = time.perf_counter() - t0
        # two 100 ms host stalls, late in the run
        plan.arm("iteration_stall", count=2, stall_ms=100.0)
        t0 = time.perf_counter()
        for _ in range(2):
            srv.step()
        stalled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # 5. the routes, over HttpFrontend
        front = HttpFrontend(srv, tokenizer=IdTokenizer()).start()
        host, port = front.address
        addr = f"{host}:{port}"
        routes = {}
        for path in ("/slo", "/traces", f"/debug/requests/"
                     f"{reqs[0].request_id}", "/debug/cache",
                     "/debug/bundle", "/debug/bundle?ring=1"):
            routes[path.split("?")[0] if "requests" not in path
                   else "/debug/requests/<id>"] = http_call(addr, path)[0]
        route_dir = os.path.join(tmp, "route")
        routes["POST /debug/trace"] = http_call(
            addr, "/debug/trace", {"steps": 2, "logdir": route_dir})[0]
        for _ in range(2):
            srv.step()
        if set(routes.values()) != {200} or srv.tracer.active:
            raise RuntimeError(f"routes answered {routes}")
        route_trace = trace_kernels(route_dir)
        if route_trace["paged_narrow_kernel_events"] < cfg.num_layers * 8:
            raise RuntimeError(f"the /debug/trace window's trace: "
                               f"{route_trace}")
        front.stop()
        front = None
        parts["routes"] = time.perf_counter() - t0
        # 6. a dispatch fault with a dispatch in flight, on the serving
        # thread: every request fails, nobody hangs, stop() returns
        if srv._inflight is None:
            raise RuntimeError("no dispatch in flight")
        srv.start()
        plan.arm("dispatch", count=1)
        t0 = time.perf_counter()
        for r in steady:
            if not r._done.wait(10.0):
                raise RuntimeError("a request outlived the dispatch fault")
        failed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.stop()
        stop_s = time.perf_counter() - t0
        reasons = {r.finish_reason.split("(")[0] for r in steady}
        if reasons != {"error: InjectedFault"} \
                or srv.unserialized_teardowns != 0:
            raise RuntimeError(f"after the dispatch fault: {reasons}, "
                               f"{srv.unserialized_teardowns} "
                               "unserialized teardowns")
        counts = {k: v - c_plain[k] for k, v in pa.counters().items()}
        # 7. readings
        slo = {cls: {m: v["lifetime"] for m, v in rep["metrics"].items()}
               for cls, rep in srv.slo_report()["classes"].items()}
        keys = ("wall_ms", "device_kernels", "device_busy_ms",
                "device_idle_share", "host_launch_calls_by_api",
                "device_kernels_by_group", "device_ms_by_group")
        out = {"phase": "policy", "requests": len(reqs),
               "tenants": POLICY_TENANTS, "admission_order": order,
               "admission_tenants": [POLICY_TENANTS[i % 3] for i in order],
               "refused_submits": refused,
               "tokens_vs_plain": ties, "first_window": first,
               "steady_step": {k: step[k] for k in keys},
               "plain_steady_step": {k: plain_step[k] for k in keys},
               "copies_per_step": {
                   "policy": step["device_copies_by_name"],
                   "plain": plain_step["device_copies_by_name"]},
               "host_copy_sync_calls_per_step": {
                   "policy": step["host_copy_sync_calls_by_api"],
                   "plain": plain_step["host_copy_sync_calls_by_api"]},
               "busy_ms_by_turn": {who: [p["device_busy_ms"] for p in ps]
                                   for who, ps in profs.items()},
               "busy_vs_plain": busy_rel,
               "steady_wall_ms_in_turns": walls,
               "host_phases_ms": phases,
               "anomaly_fired": astats["fired_total"],
               "bundle_trigger": bundles[0]["trigger"],
               "anomaly_window": anomaly_trace,
               "stall_steps_s": stalled_s, "routes": routes,
               "route_window": route_trace,
               "dispatch_fault_failed_all_s": failed_s, "stop_s": stop_s,
               "unserialized_teardowns": srv.unserialized_teardowns,
               "counts": counts, "slo_lifetime": slo,
               "brownout": srv.brownout_stats(),
               "faults": srv.fault_stats(),
               "tail_retention": srv.tail_trace_stats(),
               "qos": srv.qos.stats(),
               "programs_captured": programs, "capture_s": capture_s,
               "seconds_by_part": parts}
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)
        return out
    finally:
        if front is not None:
            front.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 3c: the fleet (a router over two replicas on one card)
# ---------------------------------------------------------------------------

# The fleet runs' decode budget: every request is still decoding when
# the drain starts, its handoff lands (the router's handoff thread moves
# about one request a round of the two replicas' steps) or replica 0's
# dispatch fails. The tokens are held against the serve phase's first
# MAX_NEW.
FLEET_NEW = 128
FLEET_BREAKER = 3
# Wall seconds a fleet scenario may take to finish its requests.
FLEET_TIMEOUT_S = 120


def drop_prefix_cache(srv) -> None:
    """Evict every cached page of an idle server, so the next scenario's
    imports write their pages instead of finding them cached."""
    with srv._step_lock:
        while srv.allocator.stats().pages_cached:
            srv.allocator._evict_one()


def record_migrations(srv, exports: list, imports: list,
                      check: bool = False) -> None:
    """Record `srv`'s exports (the export's own sync included) and
    imports, one {ms, request_id, tokens, pages, bytes} a request; the
    snapshots themselves are not kept (their pinned buffers go back to
    the host allocator). With `check`, an import is timed until its
    copies have run (an event after them is waited on, which the serving
    path never does) and its pages are read back from the pools
    (`check_imported_pages`). `unrecord` takes the wrappers off."""
    import torch
    export, migrate_import = srv._export_request_locked, srv.migrate_import

    def record(snap, t0) -> dict:
        t1 = time.perf_counter()
        return {"ms": (t1 - t0) * 1e3, "t0": t0, "t1": t1,
                "request_id": snap.request_id, "tokens": len(snap.tokens),
                "pages": snap.n_kv_pages(), "bytes": snap_bytes(snap)}

    def timed_export(req, reason):
        t0 = time.perf_counter()
        out = export(req, reason)
        exports.append(record(out[0], t0))
        return out

    def timed_import(snap, **kw):
        t0 = time.perf_counter()
        req = migrate_import(snap, **kw)
        if check:
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        rec = record(snap, t0)
        if check:
            rec["pages_bit_equal"] = check_imported_pages(srv, [snap])
        imports.append(rec)
        return req

    srv._export_request_locked = timed_export
    srv.migrate_import = timed_import


def unrecord(*servers) -> None:
    for srv in servers:
        for name in ("_export_request_locked", "migrate_import"):
            srv.__dict__.pop(name, None)


def captures(*servers) -> list:
    """(programs, capture seconds) of each server."""
    return [(len(s._programs), s._programs.capture_seconds())
            for s in servers]


def captures_since(before: list, *servers) -> dict:
    now = captures(*servers)
    return {"programs": [n - b[0] for (n, _), b in zip(now, before)],
            "seconds": [t - b[1] for (_, t), b in zip(now, before)]}


def snap_bytes(snap) -> int:
    return sum(t.numel() * t.element_size()
               for t in (snap.kv_pages or {}).values())


def check_imported_pages(srv, snaps) -> int:
    """Each snapshot's pages read back from `srv`'s pools (under its
    chain keys) are bit-equal to the exported arrays; returns the pages
    compared."""
    import torch
    n = 0
    with srv._step_lock:
        for snap in snaps:
            if not snap.n_kv_pages():
                continue
            chain = list(snap.chain_tokens)
            ids, _ = srv.allocator.lookup_prefix(chain + [0])
            try:
                if len(ids) != snap.n_kv_pages():
                    raise RuntimeError(f"{len(ids)} of {snap.n_kv_pages()} "
                                       "imported pages found")
                for name, pool in srv._pool_items():
                    if not torch.equal(pool[:, ids].cpu(),
                                       snap.kv_pages[name]):
                        raise RuntimeError(f"imported pages {name!r} "
                                           "differ from the exported ones")
            finally:
                srv.allocator.release(ids, chain[:len(ids) * PS])
            n += len(ids)
    return n


def pinned_copy_ms(nbytes: int) -> dict:
    """The bound of a migration's copies: one pinned device-to-host and
    one host-to-device copy of `nbytes`, CUDA events, median of 5."""
    import torch
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[f"{name}_ms"] = sorted(times)[2]
        out[f"{name}_gb_per_s"] = nbytes / out[f"{name}_ms"] / 1e6
    return out


def wait_for(cond, what: str, timeout: float = FLEET_TIMEOUT_S) -> float:
    """Poll `cond` every millisecond; the perf_counter time it held."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise RuntimeError(f"fleet: timed out waiting for {what}")
        time.sleep(0.001)
    return time.perf_counter()


def drive(router, reqs, what: str) -> None:
    deadline = time.perf_counter() + FLEET_TIMEOUT_S
    while not all(r.done for r in reqs):
        if time.perf_counter() > deadline:
            raise RuntimeError(f"fleet {what}: requests unfinished")
        router.step()
        time.sleep(0.001)  # the router's handoff thread takes the locks


def disagg_run(r0, r1, prompts, vocab: int) -> tuple:
    """The prompts through a router with roles prefill (r0) and decode
    (r1), stepped from this thread (the router's handoff thread exports
    and imports), both prefix caches emptied first: every request must
    hand off. Returns (summary, requests, router): the handoff's exposed
    ms a request (the seam in its stream against its median gap between
    steps) and the seam split, the export and import ms, the captures
    made, and the share of exported pages the prefetch copied."""
    import numpy as np
    from cloud_server_tpu_torch.inference.router import ReplicatedRouter
    for srv in (r0, r1):
        drop_prefix_cache(srv)
    exports, imports = [], []
    cap0 = captures(r0, r1)
    record_migrations(r0, exports, [])
    record_migrations(r1, [], imports)
    pre0 = r0.handoff_prefetched_pages
    moved0 = r0.migration_stats()["pages_moved"]
    router = ReplicatedRouter([r0, r1], roles=["prefill", "decode"])
    reqs = [router.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    drive(router, reqs, "disagg")
    unrecord(r0, r1)
    check_served(reqs, vocab, FLEET_NEW)
    snap_m = router.metrics_snapshot()
    handoffs = snap_m["cloud_server_router_handoff_success_total"]["value"]
    if handoffs != len(prompts) or len(imports) != len(prompts):
        raise RuntimeError(f"fleet disagg: {handoffs} handoffs, "
                           f"{len(imports)} imports of {len(prompts)}")
    # The seam split, ms: the last token on 0 to the export's start, the
    # export, its end to the import's start, the import (its wait for
    # replica 1's step lock included), its end to the first token on 1.
    exposed, seams = [], []
    by_id = {i["request_id"]: i for i in imports}
    ex_id = {e["request_id"]: e for e in exports}
    for r in reqs:
        i, e = by_id[r.request_id], ex_id[r.request_id]
        k = i["tokens"]
        gaps = np.diff(r.emit_times)
        steps = np.delete(gaps, k - 1)
        exposed.append((gaps[k - 1] - float(np.median(
            steps[steps >= 1e-3]))) * 1e3)
        seams.append([(b - a) * 1e3 for a, b in (
            (r.emit_times[k - 1], e["t0"]), (e["t0"], e["t1"]),
            (e["t1"], i["t0"]), (i["t0"], i["t1"]),
            (i["t1"], r.emit_times[k]))])
    moved = r0.migration_stats()["pages_moved"] - moved0
    prefetched = r0.handoff_prefetched_pages - pre0
    hist = snap_m["cloud_server_router_handoff_ms"]
    return ({"handoffs": handoffs, "exposed_ms_per_request": exposed,
             "exposed_ms_mean": float(np.mean(exposed)),
             "seam_split_ms": seams,
             "seam_split_ms_mean": np.mean(seams, axis=0).tolist(),
             "handoff_ms_mean": hist["sum"] / hist["count"],
             "export_ms_mean": float(np.mean([e["ms"] for e in exports])),
             "import_ms_mean": float(np.mean([i["ms"] for i in imports])),
             "captures": captures_since(cap0, r0, r1),
             "pages_moved": moved, "prefetch_pages": prefetched,
             "prefetch_share": prefetched / max(moved, 1)}, reqs, router)


def phase_fleet(params, cfg, icfg, prompts, plain_tokens,
                int8_tokens) -> dict:
    """Two replicas of the serve phase's server on the card, one copy of
    the weights: `a` (with a fault plan) and `b`, behind
    `ReplicatedRouter`s (replica 0 is the first server each is given):

      drain      router [a, b], stepped from this thread: the 8 serve
                 prompts on a, `drain(0, migrate=True)` mid-decode: every
                 request moves with its pages (read back bit-equal from b's
                 pools), export and import ms and GB/s a request beside a
                 pinned copy of the same bytes (and what fresh pinned
                 memory costs), the tokens held against the serve phase's
                 by the near-tie rule;
      disagg     `disagg_run` with b prefilling and a decoding (router
                 [b, a]): every request prefills on 0 and decodes on 1;
                 the near-tie rule;
      failover   router [a, b], each server on its own scheduler thread:
                 8 fresh prompts placed on a, a's dispatch failing
                 mid-decode, every request completes on b (salvaged,
                 re-prefilled), the time until a's breaker opens. a and b
                 prefilled whole prompts in the drain and as the prefill
                 replica, so the programs the threads run were captured
                 on this thread;
      int8       the round trip on two int8-cache replicas, the scale pools
                 bit-equal too.

    B1's and B2's launches are read over the phase (no plain call)."""
    import dataclasses
    import numpy as np
    import torch
    from cloud_server_tpu_torch.inference.faults import FaultPlan
    from cloud_server_tpu_torch.inference.router import ReplicatedRouter
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    seconds = {}
    want = [types.SimpleNamespace(tokens=t) for t in plain_tokens]
    fp = FaultPlan()
    a = make_server(params, cfg, icfg, faults=fp)
    b = make_server(params, cfg, icfg)
    exports, imports = [], []
    record_migrations(a, exports, [])
    record_migrations(b, [], imports, check=True)
    pa.reset_counters()

    # 1. a migrating drain of the 8 serve requests, all on a
    t0 = time.perf_counter()
    cap0 = captures(a, b)
    router = ReplicatedRouter([a, b])
    reqs = [a.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    while min(len(r.tokens) for r in reqs) < 1:
        router.step()
    torch.cuda.synchronize()
    if not router.drain(0, migrate=True):
        raise RuntimeError("fleet drain: a did not quiesce")
    if a.num_active or a.num_pending:
        raise RuntimeError("fleet drain: requests left on a")
    unrecord(a, b)
    if len(exports) != len(prompts) or len(imports) != len(prompts):
        raise RuntimeError(f"fleet drain: {len(exports)} exports, "
                           f"{len(imports)} imports of {len(prompts)}")
    if [i["pages_bit_equal"] for i in imports] != [i["pages"]
                                                   for i in imports]:
        raise RuntimeError(f"fleet drain: pages read back {imports}")
    drive(router, reqs, "drain")
    check_served(reqs, cfg.vocab_size, FLEET_NEW)
    drain_rows = []
    for e, i in zip(exports, imports):
        nb = e["bytes"]
        drain_rows.append({
            "tokens": e["tokens"], "pages": e["pages"], "bytes": nb,
            "export_ms": e["ms"], "import_ms": i["ms"],
            "export_gb_per_s": nb / e["ms"] / 1e6 if nb else None,
            "import_gb_per_s": nb / i["ms"] / 1e6 if nb else None})
    total = sum(r["bytes"] for r in drain_rows)
    # what an export pays besides its copy: fresh pinned host memory (the
    # whole drain's bytes in one block, larger than any the host
    # allocator has cached), and beside it a synchronous copy into fresh
    # pageable memory
    t1 = time.perf_counter()
    fresh = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    alloc_ms = (time.perf_counter() - t1) * 1e3
    del fresh
    bound = pinned_copy_ms(total)
    bound["pinned_alloc_ms"] = alloc_ms
    bound["pinned_alloc_gb_per_s"] = total / alloc_ms / 1e6
    dev = torch.empty(total, dtype=torch.uint8, device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dev.to("cpu")
    bound["pageable_d2h_ms"] = (time.perf_counter() - t1) * 1e3
    bound["pageable_d2h_gb_per_s"] = total / bound["pageable_d2h_ms"] / 1e6
    del dev
    export_ms = sum(e["ms"] for e in exports if e["pages"])
    import_ms = sum(i["ms"] for i in imports if i["pages"])
    drain = {"requests": len(reqs), "pages": sum(r["pages"]
                                                  for r in drain_rows),
             "bytes": total,
             "pages_checked_bit_equal": sum(i["pages_bit_equal"]
                                            for i in imports),
             "export_ms": export_ms, "import_ms": import_ms,
             "export_gb_per_s": total / export_ms / 1e6,
             "import_gb_per_s": total / import_ms / 1e6,
             "pinned_copy_bound": bound, "per_request": drain_rows,
             "migration": router.migration_stats(),
             "captures": captures_since(cap0, a, b)}
    drain_reqs = reqs
    a.resume()
    seconds["drain"] = time.perf_counter() - t0

    # 2. disaggregated: prefill on 0, decode on 1
    t0 = time.perf_counter()
    disagg, disagg_reqs, disagg_router = disagg_run(b, a, prompts,
                                                    cfg.vocab_size)
    seconds["disagg"] = time.perf_counter() - t0

    # 3. failover, each replica on its own scheduler thread
    t0 = time.perf_counter()
    cap0 = captures(a, b)
    fresh = make_prompts(np.random.default_rng(SEED + 3), cfg.vocab_size)
    fail_router = ReplicatedRouter([a, b],
                                   breaker_threshold=FLEET_BREAKER,
                                   breaker_reset_s=600.0)
    led = fail_router.migration_stats()
    it1 = b.flight.iterations
    # every request on a: b is quiesced, so not ready, while they are
    # placed
    if not b.drain(timeout=0):
        raise RuntimeError("fleet failover: b is not idle")
    reqs = [fail_router.submit(p, max_new_tokens=FLEET_NEW)
            for p in fresh]
    b.resume()
    if a.num_pending != len(reqs):
        raise RuntimeError("fleet failover: requests placed on b")
    fail_router.start()
    wait_for(lambda: min(len(r.tokens) for r in reqs) >= 1,
             "every request's first token")
    t_arm = time.perf_counter()
    fp.arm("dispatch", count=1)
    t_open = wait_for(
        lambda: fail_router.breaker_states()[0]["state"] == "open",
        "a's breaker")
    t_done = wait_for(lambda: all(r.done for r in reqs),
                      "the failover's requests")
    completed = sum(r.finish_reason == "length"
                    and len(r.tokens) == FLEET_NEW for r in reqs)
    if completed != len(reqs):
        raise RuntimeError(f"fleet failover: {completed} of {len(reqs)} "
                           f"completed: {[r.finish_reason for r in reqs]}")
    after = fail_router.migration_stats()
    recs = b.flight_window(b.flight.iterations - it1)
    failover = {"requests": len(reqs), "completed_frac": completed / len(reqs),
                "migrated": after["in_completed"] - led["in_completed"],
                "tokens_salvaged": (after["tokens_salvaged"]
                                    - led["tokens_salvaged"]),
                "tokens_reprefilled": sum(rec.get("prefill_tokens", 0)
                                          for rec in recs),
                "breaker_open_ms": (t_open - t_arm) * 1e3,
                "first_tokens_s": t_arm - t0, "arm_to_done_s": t_done - t_arm,
                "unserialized_teardowns": a.unserialized_teardowns,
                "captures": captures_since(cap0, a, b)}
    programs = {"a": len(a._programs), "b": len(b._programs),
                "capture_s": [a._programs.capture_seconds(),
                              b._programs.capture_seconds()]}
    for router in (fail_router, disagg_router):
        router.stop()
    seconds["failover"] = time.perf_counter() - t0

    # 4. the int8 cache's round trip (its scale pools with the pages)
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    a8, b8 = make_server(params, cfg8, icfg), make_server(params, cfg8, icfg)
    picks = [len(prompts) - 1]  # the longest: 11 full pages
    src = [a8.submit(prompts[i], max_new_tokens=FLEET_NEW) for i in picks]
    while min(len(r.tokens) for r in src) < 1:
        a8.step()
    snaps = [a8.migrate_export(r) for r in src]
    conts = [b8.migrate_import(snap) for snap in snaps]
    pages8 = check_imported_pages(b8, snaps)
    b8.run_until_idle()
    check_served(conts, cfg.vocab_size, FLEET_NEW)
    equal8 = sum(x == y for i, c in zip(picks, conts)
                 for x, y in zip(c.tokens, int8_tokens[i]))
    int8 = {"requests": len(conts), "pages_checked_bit_equal": pages8,
            "pools": sorted(snaps[0].kv_pages),
            "bytes": sum(snap_bytes(s) for s in snaps),
            "tokens_equal_to_serve_int8_share": equal8 / (len(conts)
                                                          * MAX_NEW)}
    a8.stop()
    b8.stop()
    torch.cuda.synchronize()
    counts = pa.counters()
    seconds["int8"] = time.perf_counter() - t0
    for name in ("launches_narrow", "launches_wide", "launches_narrow_int8",
                 "launches_wide_int8"):
        if counts[name] <= 0:
            raise RuntimeError(f"fleet: {name} never launched: {counts}")
    if counts["plain_calls"]:
        raise RuntimeError(f"fleet: plain attention ran: {counts}")

    t0 = time.perf_counter()
    drain["tokens"] = near_tie_divergence("the fleet's migrating drain",
                                          drain_reqs, want, prompts, params,
                                          cfg)
    disagg["tokens"] = near_tie_divergence("the disaggregated fleet",
                                           disagg_reqs, want, prompts,
                                           params, cfg)

    seconds["near_tie_checks"] = time.perf_counter() - t0
    seconds["total"] = time.perf_counter() - t_phase
    out = {"phase": "fleet", "replicas": 2, "counts": counts,
           "programs": programs, "drain": drain, "disagg": disagg,
           "failover": failover, "int8": int8, "seconds": seconds}
    emit(out)
    print(f"fleet: drain {drain['bytes']} B, export "
          f"{drain['export_gb_per_s']:.2f} GB/s, import "
          f"{drain['import_gb_per_s']:.2f} GB/s (pinned copies "
          f"{bound['d2h_gb_per_s']:.2f} / {bound['h2d_gb_per_s']:.2f}); "
          f"handoff exposed {disagg['exposed_ms_mean']:.2f} ms, prefetch "
          f"share {disagg['prefetch_share']:.3f}; breaker open in "
          f"{failover['breaker_open_ms']:.1f} ms", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 3c: the elastic slice — full reservation, embeddings, per-request
# adapters, and a fleet the SLO-burn autoscaler grows and shrinks under a
# replayed scenario
# ---------------------------------------------------------------------------

# Two random adapters with a non-zero B, for the serve requests of
# ELASTIC_ROWS (the rest stay on the base model). B's scale makes each
# delta about ADAPTER_DELTA of its base projection: with A's std
# 1/sqrt(fan_in), a rank-r delta at scale alpha / r has a std of about
# alpha * std(B) / sqrt(r) against the base's 1.
ELASTIC_ADAPTERS = {
    "r16": (dict(rank=16, alpha=32.0,
                 targets=("w_down", "w_gate", "w_up", "wk", "wo", "wq",
                          "wv")), SEED + 11),
    "r8": (dict(rank=8, alpha=16.0, targets=("wk", "wo", "wq", "wv")),
           SEED + 12)}
ADAPTER_DELTA = 0.5
ELASTIC_ROWS = {1: "r16", 5: "r16", 3: "r8", 7: "r8"}
# the adapter registered under a dispatch in flight: its rank outgrows
# the stacks' (16), so they are restacked into new tensors
GROW_ADAPTER = ("r32", dict(rank=32, alpha=32.0, targets=("wq", "wv")),
                SEED + 13)
# embed: the two attention routes agree to this cosine per prompt, and
# every vector has unit norm within this
EMBED_COS_MIN = 0.999
EMBED_NORM_TOL = 1e-3
EMBED_REPS = 5
# the adapted and plain servers' steady steps, profiled one a window in
# balanced turns
ADAPTER_PROFILE_TURNS = ("plain", "adapted", "adapted", "plain",
                         "adapted", "plain", "plain", "adapted")
# The reference bench's SLO-autoscale arm (bench.py:736-800): its QoS and
# SLO configs and autoscaler knobs, one replica and one spare; the
# scenario at this phase's rates (quiet, burst, quiet: 10 s each).
ELASTIC_QOS = {"quantum": 64, "tenants": {
    "inter": {"weight": 4.0, "priority": "interactive"},
    "bulk": {"weight": 1.0, "priority": "batch"}}}
ELASTIC_SLO = {"windows_s": [5, 15], "classes": {
    "interactive": {"objective": 0.9, "ttft_s": 6.0, "queue_wait_s": 5.0,
                    "itl_s": 3.0, "e2e_s": 60.0},
    "batch": {"objective": 0.5, "ttft_s": 20.0, "e2e_s": 120.0}}}
ELASTIC_AUTOSCALER = dict(
    min_replicas=1, max_replicas=2,
    classes=("interactive", "batch", "default"), up_fast_burn=1.5,
    up_slow_burn=1.0, down_fast_burn=0.5, down_slow_burn=0.5,
    pending_high=4.0, pending_low=1.0, hold_s=4.0, poll_s=0.5,
    drain_timeout_s=60.0)
ELASTIC_SCENARIO = dict(seed=SEED, duration_s=30.0, phase_s=10.0,
                        low_rps=0.3)
ELASTIC_TENANTS = {"inter": 3.0, "bulk": 1.0}
# The burst's rate is set from the card, not fixed: before the replay a
# server like the primary (the spare, which joins only at the scale-up)
# completes ELASTIC_RATE_REQUESTS of the scenario's requests, all
# submitted at once (after as many to warm its programs), and the burst
# arrives at ELASTIC_BURST_X times that rate R. Over its 10 s the queue
# then grows by about (X - 1) R a second, well past pending_high a
# replica on any host that completes a request in under a second; a
# fixed 6 rps left the queue below 4 on a slower host.
ELASTIC_RATE_REQUESTS = 12
ELASTIC_BURST_X = 3.0
# after the replay: pumping until the quiet tail's scale-down lands (the
# burn windows need wall time to age the burst out), as the bench does
ELASTIC_SETTLE_S = 45.0
ELASTIC_TIMEOUT_S = 300.0


def random_adapter(cfg, lcfg, seed: int) -> dict:
    """`init_lora_params` from `seed`, then B drawn non-zero (see
    ELASTIC_ADAPTERS)."""
    import torch
    from cloud_server_tpu_torch.models.lora import init_lora_params
    lp = init_lora_params(cfg, lcfg, seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 100)
    std = ADAPTER_DELTA * math.sqrt(lcfg.rank) / lcfg.alpha
    for name in sorted(lp["layers"]):
        b = lp["layers"][name]["b"]
        lp["layers"][name]["b"] = (torch.randn(
            b.shape, generator=gen, device=DEVICE) * std).to(b.dtype)
    return lp


def cancel_all(srv, reqs) -> None:
    for r in reqs:
        r.cancel()
    srv.run_until_idle()


def embed_groups(srv, prompts) -> list:
    """The (bucket, padded rows) groups `srv.embed(prompts)` runs."""
    from cloud_server_tpu_torch.inference.server import _bucket
    by = {}
    for p in prompts:
        b = _bucket(len(p), srv.prompt_buckets)
        by[b] = by.get(b, 0) + 1
    return sorted((b, 1 << (n - 1).bit_length()) for b, n in by.items())


def time_embed(srv, prompts) -> float:
    """Median ms of `srv.embed(prompts)` over EMBED_REPS calls."""
    import statistics
    import torch
    ms = []
    for _ in range(EMBED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.embed(prompts)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def b3_embed_layer(groups) -> dict:
    """B3 at the embed's shapes: one layer's forward over every (bucket,
    rows) group, random bf16 q, k, v at the head shapes, timed in turns
    with the plain version and SDPA (causal, GQA); summed over the
    groups, with the bound of the work (every padded row's causal
    pairs)."""
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.ops import flash_attention as fl
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 5)
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "groups": []}
    t_bytes = t_ops = 0.0
    with torch.no_grad():
        for s, b in groups:
            def rnd(heads):
                return torch.randn((b, s, heads, DH), generator=gen,
                                   device=DEVICE, dtype=torch.bfloat16)
            q, k, v = rnd(H), rnd(KH), rnd(KH)
            got = fl.flash_attention(q, k, v)
            want = fl.flash_attention_ref(q, k, v)[0]
            err = compare("out", got, want)
            if not err["within"]:
                raise RuntimeError(f"B3 at the embed shape {b} x {s}: {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            t = time_turns({
                "kernel": lambda: fl.flash_attention(q, k, v),
                "plain": lambda: fl.flash_attention_ref(q, k, v),
                "library": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)},
                rounds=3, iters=5)
            pairs = visible_pairs(None, b, s)
            nbytes = 2 * (2 * b * s * H * DH + 2 * b * s * KH * DH) \
                + 4 * b * H * s
            bound, by = flash_bound(pairs, nbytes, 4, DH)
            t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
            t_ops += 4 * DH * pairs * H / BF16_FLOP_PER_S * 1e3
            out["groups"].append({"S": s, "B": b, "ms": t["kernel"][0],
                                  "plain_ms": t["plain"][0],
                                  "library_ms": t["library"][0],
                                  "bound_ms": bound, "bound_by": by,
                                  "max_abs_err": err["max_abs_err"]})
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                out[key] += out["groups"][-1][key]
            out["max_abs_err"] = max(out["max_abs_err"], err["max_abs_err"])
            del q, k, v, got, want
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def elastic_embed(params, cfg, icfg, prompts) -> dict:
    """`embed` of the 8 prompts on the serve phase's config (plain causal
    attention) and with attention_impl "flash" (B3) on the same weights;
    /v1/embeddings over HttpFrontend."""
    import dataclasses
    import numpy as np
    import torch
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    from cloud_server_tpu_torch.ops import flash_attention as fl
    srv = make_server(params, cfg, icfg)
    fl.reset_counters()
    plain = srv.embed(prompts)
    if fl.counters()["launches_fwd"] or fl.counters()["plain_calls"]:
        raise RuntimeError(f"embed with attention_impl {cfg.attention_impl}"
                           f" ran flash: {fl.counters()}")
    fsrv = make_server(params, dataclasses.replace(cfg,
                                                   attention_impl="flash"),
                       icfg)
    groups = embed_groups(fsrv, prompts)
    fl.reset_counters()
    flash = fsrv.embed(prompts)
    torch.cuda.synchronize()
    b3 = fl.counters()
    if (b3["launches_fwd"] != cfg.num_layers * len(groups)
            or b3["plain_calls"]):
        raise RuntimeError(f"embed on the flash route: {b3}, groups "
                           f"{groups}")
    for what, vecs in (("plain", plain), ("flash", flash)):
        if vecs.shape != (len(prompts), cfg.embed_dim) or not np.isfinite(
                vecs).all():
            raise RuntimeError(f"embed ({what}): {vecs.shape}")
        norm_err = float(np.abs(np.linalg.norm(vecs, axis=-1) - 1).max())
        if norm_err > EMBED_NORM_TOL:
            raise RuntimeError(f"embed ({what}): norms off by {norm_err}")
    cos = (plain * flash).sum(-1) / (np.linalg.norm(plain, axis=-1)
                                     * np.linalg.norm(flash, axis=-1))
    if float(cos.min()) < EMBED_COS_MIN:
        raise RuntimeError(f"embed routes disagree: cosines {cos}")
    ms = {"plain": time_embed(srv, prompts),
          "flash": time_embed(fsrv, prompts)}
    srv.start()
    front = HttpFrontend(srv).start()
    try:
        host, port = front.address
        status, body = http_call(f"{host}:{port}", "/v1/embeddings",
                                 {"input": prompts})
    finally:
        front.stop()
        srv.stop()
        fsrv.stop()
    if status != 200:
        raise RuntimeError(f"/v1/embeddings answered {status}")
    wire = np.asarray([d["embedding"] for d in json.loads(body)["data"]],
                      np.float32)
    http_err = float(np.abs(wire - plain).max())
    if http_err > 1e-6:
        raise RuntimeError(f"/v1/embeddings vectors off by {http_err}")
    return {"groups": groups, "b3_counts": b3,
            "cosine_min": float(cos.min()), "cosines": cos.tolist(),
            "norm_max_err": float(max(
                np.abs(np.linalg.norm(v, axis=-1) - 1).max()
                for v in (plain, flash))),
            "ms_per_call_8": ms, "http_status": status,
            "http_max_abs_err": http_err,
            "b3_layer": b3_embed_layer(groups)}


def elastic_adapters(params, cfg, icfg, prompts, plain_tokens,
                     plain_srv) -> dict:
    """Two adapters on a fresh server; the 8 serve requests in one batch,
    ELASTIC_ROWS adapted: base rows the serve phase's tokens exactly,
    adapted rows held against merged weights by the near-tie rule; a
    steady step with all 8 rows adapted profiled in turns with the plain
    server's; an adapter that outgrows the stacks registered while a
    dispatch is in flight."""
    import gc
    import numpy as np
    import torch
    from cloud_server_tpu_torch.models.lora import LoRAConfig, merge_lora
    from cloud_server_tpu_torch.ops import paged_attention as pa
    srv = make_server(params, cfg, icfg)
    lora = {}
    for name, (kw, seed) in ELASTIC_ADAPTERS.items():
        lcfg = LoRAConfig(**kw)
        lora[name] = (random_adapter(cfg, lcfg, seed), lcfg)
        srv.add_adapter(name, *lora[name])
    rows = [ELASTIC_ROWS.get(i) for i in range(len(prompts))]
    pa.reset_counters()
    reqs = [srv.submit(p, max_new_tokens=MAX_NEW, adapter=a)
            for p, a in zip(prompts, rows)]
    srv.run_until_idle()
    counts = pa.counters()
    check_served(reqs, cfg.vocab_size)
    base = [i for i, a in enumerate(rows) if a is None]
    same_tokens("base rows beside adapted ones", [reqs[i] for i in base],
                [plain_tokens[i] for i in base])
    moved = sum(reqs[i].tokens != plain_tokens[i] for i in ELASTIC_ROWS)
    if 2 * moved <= len(ELASTIC_ROWS):
        raise RuntimeError(f"only {moved} adapted requests left the base "
                           "tokens")
    merged_checks = {}
    for name, (lp, lcfg) in lora.items():
        idx = [i for i, a in enumerate(rows) if a == name]
        merged = merge_lora(params, lp, lcfg)
        msrv = make_server(merged, cfg, icfg, cuda_graphs=False)
        mreqs, _, _, _ = serve_once(merged, cfg, icfg,
                                    [prompts[i] for i in idx], srv=msrv)
        check_served(mreqs, cfg.vocab_size)
        merged_checks[name] = near_tie_divergence(
            f"adapter {name} against merged weights",
            [reqs[i] for i in idx], mreqs, [prompts[i] for i in idx],
            merged, cfg)
        msrv.stop()
        del merged, msrv, mreqs
        gc.collect()
        torch.cuda.empty_cache()
    first = [r.tokens for r in reqs]

    # a steady step with all 8 rows adapted, in turns with the plain one
    all_rows = [("r16", "r8")[i % 2] for i in range(len(prompts))]
    servers = {"plain": plain_srv, "adapted": srv}
    batches = {"plain": policy_steady(plain_srv, prompts),
               "adapted": policy_steady(srv, prompts, adapter=all_rows)}
    profs = {"plain": [], "adapted": []}
    for who in ADAPTER_PROFILE_TURNS:
        profs[who].append(profile_step(servers[who].step))
    for who, b in batches.items():
        cancel_all(servers[who], b)
    step, plain_step = (mean_profile(profs["adapted"]),
                        mean_profile(profs["plain"]))
    if any(p["host_launch_calls_by_api"] != {"cudaGraphLaunch": 1}
           for p in profs["adapted"] + profs["plain"]):
        raise RuntimeError(f"steady steps not one graph launch: {profs}")
    stack_bytes = srv.adapters.nbytes()

    # an adapter that outgrows the stacks, under a dispatch in flight
    drop_prefix_cache(srv)
    pa.reset_counters()
    reqs2 = [srv.submit(p, max_new_tokens=MAX_NEW, adapter=a)
             for p, a in zip(prompts, rows)]
    for _ in range(2):
        srv.step()
    if srv._inflight is None:
        raise RuntimeError("grow: no dispatch in flight")
    pc = srv._programs
    n0, dropped0, kept0 = len(pc), pc.dropped, pc.dropped_in_flight
    keys0 = set(pc.keys())
    rebuilds0 = srv.adapters.rebuilds
    name, kw, seed = GROW_ADAPTER
    t0 = time.perf_counter()
    lcfg = LoRAConfig(**kw)
    srv.add_adapter(name, random_adapter(cfg, lcfg, seed), lcfg)
    add_ms = (time.perf_counter() - t0) * 1e3
    released = pc.dropped - dropped0
    kept = pc.dropped_in_flight - kept0
    if (srv.adapters.rebuilds != rebuilds0 + 1 or kept != 1
            or not srv._retired):
        raise RuntimeError(f"grow: rebuilds {srv.adapters.rebuilds}, "
                           f"kept in flight {kept}")
    srv.step()  # commits the dispatch in flight, then releases it
    if srv._retired:
        raise RuntimeError("grow: retired program not released at commit")
    srv.run_until_idle()
    counts2 = pa.counters()
    check_served(reqs2, cfg.vocab_size)
    same_tokens("base rows across the restack", [reqs2[i] for i in base],
                [plain_tokens[i] for i in base])
    adapted_equal = sum(reqs2[i].tokens == first[i] for i in ELASTIC_ROWS)
    grow_ties = near_tie_divergence(
        "adapted rows across the restack",
        [reqs2[i] for i in ELASTIC_ROWS],
        [types.SimpleNamespace(tokens=first[i]) for i in ELASTIC_ROWS],
        [prompts[i] for i in ELASTIC_ROWS], params, cfg)
    fresh = [p for k, p in pc._programs.items() if k not in keys0]
    recaptured = (len(fresh), sum(p.capture_s for p in fresh))
    srv.stop()
    for c in (counts, counts2):
        if (c["launches_narrow"] <= 0 or c["launches_wide"] <= 0
                or c["plain_calls"]):
            raise RuntimeError(f"adapters: kernel counts {c}")
    return {"adapters": {n: dict(ELASTIC_ADAPTERS[n][0]) for n in lora},
            "rows": {str(i): a for i, a in ELASTIC_ROWS.items()},
            "counts": counts, "base_rows_equal": True,
            "adapted_rows_moved_from_base": moved,
            "against_merged": merged_checks,
            "steady_step": {
                "adapted": step, "plain": plain_step,
                "device_ms_added": (step["device_busy_ms"]
                                    - plain_step["device_busy_ms"]),
                "device_share_added": (step["device_busy_ms"]
                                       / plain_step["device_busy_ms"] - 1),
                "kernels_added": (step["device_kernels"]
                                  - plain_step["device_kernels"]),
                "stack_bytes": stack_bytes},
            "grow": {"adapter": dict(kw), "add_ms": add_ms,
                     "programs_before": n0,
                     "programs_released": released,
                     "released_after_commit": kept,
                     "recaptured": recaptured[0],
                     "recapture_s": recaptured[1],
                     "rebuilds": srv.adapters.rebuilds,
                     "stack_bytes": srv.adapters.nbytes(),
                     "counts": counts2,
                     "adapted_rows_equal_exactly": adapted_equal,
                     "adapted_rows": grow_ties}}


def completion_rate(srv) -> dict:
    """The rate R (requests/s) at which `srv` completes the elastic
    scenario's requests, at their own prompt and output lengths and
    tenant mix: ELASTIC_RATE_REQUESTS of them submitted at once after as
    many more to warm the server's programs (events of the scenario's
    generator at another seed)."""
    from cloud_server_tpu_torch.scenarios import TenantMix, diurnal_burst
    events = diurnal_burst(tenants=TenantMix(ELASTIC_TENANTS),
                           high_rps=10.0, **{**ELASTIC_SCENARIO,
                                             "seed": SEED + 1}).generate()
    first = [e for e in events if e.turn == 0]
    n = ELASTIC_RATE_REQUESTS
    if len(first) < 2 * n:
        raise RuntimeError(f"elastic rate: {len(first)} requests drawn, "
                           f"{2 * n} needed")
    out = {}
    for what, batch in (("warm", first[:n]), ("timed", first[n:2 * n])):
        t0 = time.perf_counter()
        reqs = [srv.submit(list(e.prompt), max_new_tokens=e.max_new_tokens,
                           tenant=e.tenant) for e in batch]
        srv.run_until_idle()
        out[f"{what}_s"] = time.perf_counter() - t0
        if not all(r.done for r in reqs):
            raise RuntimeError(f"elastic rate: the {what} requests did "
                               "not finish")
    out["rps"] = n / out["timed_s"]
    out["requests"] = n
    return out


def elastic_fleet(params, cfg, icfg) -> dict:
    """The reference bench's autoscaled arm on the port: a router starting
    with one replica, one spare handed out by `spawn`, the
    SLOBurnAutoscaler polled from the pump, the diurnal burst replayed by
    ReplayDriver; then the cost model fitted from the replicas' flight
    records and FleetSim run on the same events."""
    import numpy as np
    import torch
    from cloud_server_tpu_torch.inference.router import ReplicatedRouter
    from cloud_server_tpu_torch.inference.slo import merge_reports
    from cloud_server_tpu_torch.ops import paged_attention as pa
    from cloud_server_tpu_torch.scenarios import (
        AutoscalerConfig, CostModel, FleetSim, ReplayDriver, SimReplica,
        SLOBurnAutoscaler, TenantMix, diurnal_burst)
    from cloud_server_tpu_torch.utils.serving_metrics import (
        histogram_percentile)

    def mk():
        return make_server(params, cfg, icfg, qos=ELASTIC_QOS,
                           slo=ELASTIC_SLO, flight_recorder_size=1 << 14)

    primary, spare = mk(), mk()
    rate = completion_rate(spare)
    high_rps = ELASTIC_BURST_X * rate["rps"]
    scenario = diurnal_burst(tenants=TenantMix(ELASTIC_TENANTS),
                             high_rps=high_rps, **ELASTIC_SCENARIO)
    events = scenario.generate()
    servers = {"primary": primary, "spare": spare}
    per_counts = {k: {} for k in servers}
    for key, s in servers.items():
        def counted(step=s.step, key=key):
            c0 = pa.counters()
            try:
                return step()
            finally:
                for k, v in pa.counters().items():
                    per_counts[key][k] = per_counts[key].get(k, 0) + v - c0[k]
        s.step = counted
    joined = {}
    on_spare = []

    def spawn(role):
        if "t" in joined:
            return None
        joined["t"] = time.perf_counter()
        submit = spare.submit

        @functools.wraps(submit)
        def tracked(*a, **kw):
            req = submit(*a, **kw)
            on_spare.append(req)
            return req
        spare.submit = tracked
        return spare

    released = []
    router = ReplicatedRouter([primary])
    asc = SLOBurnAutoscaler(router, spawn=spawn, release=released.append,
                            config=AutoscalerConfig(**ELASTIC_AUTOSCALER))
    drv = ReplayDriver(router, events)
    pa.reset_counters()
    state = {"poll": 0.0, "chips": 0.0, "t": time.monotonic(),
             "peak_pending": 0.0}

    def pump():
        router.step()
        state["peak_pending"] = max(
            state["peak_pending"],
            router.num_pending / max(1, len(router.attached_indices())))
        now = time.monotonic()
        state["chips"] += len(router.attached_indices()) * (now - state["t"])
        state["t"] = now
        if now - state["poll"] >= asc.cfg.poll_s:
            state["poll"] = now
            asc.step(now)

    t0 = time.perf_counter()
    res = drv.run(step=pump, timeout_s=ELASTIC_TIMEOUT_S)
    router.run_until_idle()
    replay_s = time.perf_counter() - t0
    t_settle = time.monotonic()
    while (len(router.attached_indices()) > 1
           and time.monotonic() - t_settle < ELASTIC_SETTLE_S):
        pump()
        time.sleep(0.05)
    torch.cuda.synchronize()
    counts = pa.counters()
    ups = [e.to_json() for e in asc.events if e.action == "up"]
    downs = [e.to_json() for e in asc.events if e.action == "down"]
    load = {"completion_rps": rate["rps"], "burst_rps": high_rps,
            "peak_pending_per_replica": state["peak_pending"],
            "pending_high": ELASTIC_AUTOSCALER["pending_high"]}
    print(f"elastic fleet: R {rate['rps']:.3f} requests/s, burst "
          f"{high_rps:.3f} rps, highest queue a replica saw "
          f"{state['peak_pending']:.2f}", flush=True)
    if res["fired"] != len(events) or res["failed"] or res["rejected"] \
            or res["outstanding"]:
        raise RuntimeError(f"elastic fleet replay: {res}")
    if not ups and state["peak_pending"] < load["pending_high"]:
        raise RuntimeError(f"the load never reached the trigger (the "
                           f"harness's fault): {load}")
    if not ups:
        raise RuntimeError(f"the trigger was crossed and no scale-up "
                           f"followed: {load}, "
                           f"{[e.to_json() for e in asc.events]}")
    if not downs:
        raise RuntimeError(f"the autoscaler did not scale down: "
                           f"{[e.to_json() for e in asc.events]}")
    migration = {k: primary.migration_stats()[k] + spare.migration_stats()[k]
                 for k in ("out_started", "out_completed", "out_failed",
                           "in_completed", "in_failed", "pages_moved")}
    if migration["out_failed"] or migration["in_failed"]:
        raise RuntimeError(f"the scale-down lost a migration: {migration}")
    for key, c in per_counts.items():
        if c.get("launches_narrow", 0) <= 0 or c.get("launches_wide", 0) <= 0:
            raise RuntimeError(f"{key} replica's kernels: {c}")
    if counts["plain_calls"]:
        raise RuntimeError(f"elastic fleet: plain attention ran: {counts}")
    live = merge_reports([s.slo_report() for s in servers.values()])
    lag = drv.metrics_snapshot()["cloud_server_scenario_replay_lag_ms"]
    spare_first = min((r.emit_times[0] for r in on_spare if r.emit_times),
                      default=None)
    records = primary.flight_window() + spare.flight_window()
    cost = CostModel.fit(records)
    sims = {}
    for n in (1, 2):
        sim = FleetSim(
            [SimReplica(max_slots=primary.max_slots,
                        budget=primary.mixed_token_budget,
                        chunk=primary.prefill_chunk,
                        page_size=primary.page_size,
                        pages=primary.allocator.num_pages,
                        class_weights={"interactive": 4.0, "batch": 1.0})
             for _ in range(n)],
            cost=cost, slo=ELASTIC_SLO,
            tenant_class={"inter": "interactive", "bulk": "batch"})
        sims[n] = sim.run(events)

    def attainment(rep):
        return {f"{c}/{m}": v["lifetime"]["attainment"]
                for c, ce in (rep or {}).get("classes", {}).items()
                for m, v in ce["metrics"].items()
                if v["lifetime"]["total"]}

    live_att = attainment(live)
    sim_att = {n: attainment(r["slo"]) for n, r in sims.items()}
    programs = {k: {"programs": len(s._programs),
                    "capture_s": s._programs.capture_seconds()}
                for k, s in servers.items()}
    asc.stop()
    for s in servers.values():
        s.stop()
    router.stop()
    return {"events": len(events), "load": load, "rate": rate,
            "replay": res, "replay_s": replay_s,
            "replay_lag_ms_p99": histogram_percentile(lag, 0.99),
            "scale_ups": ups, "scale_downs": downs,
            "autoscaler": asc.stats(), "chip_s": state["chips"],
            "migration": migration, "counts": counts,
            "counts_by_replica": per_counts,
            "attainment": live_att,
            "spare": {**programs["spare"],
                      "first_token_after_join_s": (
                          None if spare_first is None
                          else spare_first - joined["t"]),
                      "requests": len(on_spare)},
            "primary": programs["primary"],
            "cost_model": {"fixed_ms": cost.fixed_ms,
                           "per_token_ms": cost.per_token_ms,
                           "records": len(records)},
            "sim": {str(n): {"attainment": sim_att[n],
                             "gap": {k: sim_att[n].get(k, 1.0) - v
                                     for k, v in live_att.items()},
                             "finished": r["finished"],
                             "sim_duration_s": r["sim_duration_s"]}
                    for n, r in sims.items()}}


def phase_elastic(params, cfg, icfg, prompts, plain_tokens) -> dict:
    """This slice's paths at the full width (all 32 layers, the serve
    phase's weights and requests):

      reserve    allocation="reserve": each request's chain reserved at
                 admission (prompt + 32 + the window's slack), no
                 preemption, the tokens held against the serve phase's by
                 the near-tie rule;
      embed      `embed` on both attention routes (B3 on the flash one),
                 /v1/embeddings over HttpFrontend, B3 timed at the
                 embed's shapes;
      adapters   `elastic_adapters`;
      fleet      `elastic_fleet`.

    B1 and B2 are counted in each part, B3 in the embed; no plain call."""
    import gc
    import torch
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t_phase = time.perf_counter()
    seconds = {}
    want = [types.SimpleNamespace(tokens=t) for t in plain_tokens]

    def part(name, reading):
        # each part's line as soon as it has run
        emit({"phase": "elastic", "part": name, **reading,
              "seconds": seconds[name]})

    t0 = time.perf_counter()
    rsrv = make_server(params, cfg, icfg, allocation="reserve")
    pa.reset_counters()
    reqs = [rsrv.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    rsrv.step()  # admits all 8: 8 slots
    got = {id(s.req): len(s.pages) for s in rsrv._slots if s is not None}
    reserved = [got[id(r)] for r in reqs]
    expect = [-(-(len(p) + MAX_NEW + rsrv.window) // PS) for p in prompts]
    rsrv.run_until_idle()
    rcounts = pa.counters()
    check_served(reqs, cfg.vocab_size)
    if reserved != expect or rsrv.preemptions:
        raise RuntimeError(f"reserve: pages {reserved} against {expect}, "
                           f"{rsrv.preemptions} preemptions")
    if (rcounts["launches_narrow"] <= 0 or rcounts["launches_wide"] <= 0
            or rcounts["plain_calls"]):
        raise RuntimeError(f"reserve: kernel counts {rcounts}")
    reserve = {"pages_reserved": reserved, "pages_expected": expect,
               "preemptions": rsrv.preemptions, "counts": rcounts,
               "programs": len(rsrv._programs),
               "tokens": near_tie_divergence(
                   "allocation='reserve'", reqs, want, prompts, params,
                   cfg)}
    seconds["reserve"] = time.perf_counter() - t0
    part("reserve", reserve)

    t0 = time.perf_counter()
    embed = elastic_embed(params, cfg, icfg, prompts)
    seconds["embed"] = time.perf_counter() - t0
    part("embed", embed)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    # the reserve server is the plain server of the profile's turns: no
    # chain grows in a steady step under either policy, so its steady
    # step is the default server's program
    adapters = elastic_adapters(params, cfg, icfg, prompts, plain_tokens,
                                rsrv)
    rsrv.stop()
    del rsrv
    seconds["adapters"] = time.perf_counter() - t0
    part("adapters", adapters)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fleet = elastic_fleet(params, cfg, icfg)
    seconds["fleet"] = time.perf_counter() - t0
    part("fleet", fleet)
    seconds["total"] = time.perf_counter() - t_phase
    out = {"phase": "elastic", "layers": cfg.num_layers, "reserve": reserve,
           "embed": embed, "adapters": adapters, "fleet": fleet,
           "seconds": seconds}
    emit({"phase": "elastic", "seconds": seconds})
    steady = adapters["steady_step"]
    print(f"elastic: reserve {reserve['tokens']['diverged_requests']} "
          f"diverged; embed cos min {embed['cosine_min']:.5f}, "
          f"{embed['ms_per_call_8']}; adapters +"
          f"{steady['device_ms_added']:.2f} ms device a steady step, grow "
          f"released {adapters['grow']['programs_released']}; fleet "
          f"{len(fleet['scale_ups'])} up / {len(fleet['scale_downs'])} "
          f"down, attainment {fleet['attainment']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 2b: the flash-attention kernels against their plain version
# ---------------------------------------------------------------------------

# Kernel vs plain, bf16, per output: |err| <= atol + rtol * |plain| for
# every element, and the error's RMS within rel_rms of the plain output's
# RMS. From the errors measured on the card (PERF.md, PR 2: relative RMS
# 2.8-2.9e-3 for out, 3.3-3.4e-3 for dQ/dK, 1.7-2.8e-4 for dV, 4e-8 for
# the LSE; largest element errors one bf16 ulp of the largest entries):
# atol is one bf16 ulp at the size of the largest entries of the
# operands each output sums (|v| up to 4: 2^-6 for out; dK/dQ/dV up to
# 8: 2^-5), because bf16 rounding of each probability (and of dS) errs
# in proportion to those terms, not to their often cancelling sum. The
# largest out error read 0.015625, one ulp at 2-4, and the packed case
# failed the first atol of 8e-3; dK/dV read 0.031. The RMS limits are
# 3-4x the largest RMS reading of each output; the LSE is f32 in both,
# its sums taken in another order (limits about 10x and 25x the
# readings).
FLASH_TOL = {
    "out": (1.6e-2, 1e-2, 1e-2),
    "lse": (1e-5, 1e-6, 1e-6),
    "dq": (3.2e-2, 2e-2, 1e-2),
    "dk": (3.2e-2, 2e-2, 1e-2),
    "dv": (3.2e-2, 2e-2, 1e-3),
}
FLASH_CASES = {
    # name: (B, S, segments per row or 0, Dh); blocks 1024 as in the config
    "blocked": (4, 2048, 0, 128),   # the train path at S 2048: B3, B4, B5
    "fused": (4, 1024, 0, 128),     # the train path at S 1024: B3, B6
    "segments": (2, 2048, 4, 128),  # packed rows, blocked backward
    "dh64": (2, 2048, 0, 64),       # head dim 64, blocked backward
    "s1984": (1, 1984, 0, 128),     # S not a multiple of the 128-row tiles
    "s1000": (2, 1000, 0, 128),     # padded to 1024, fused (block 1000)
    "s2000": (1, 2000, 0, 128),     # padded to 2048, blocked (block 16)
    "fused_segments": (2, 1024, 4, 128),  # packed rows, fused backward
    "fused_dh64": (2, 1024, 0, 64),       # head dim 64, fused backward
}
# Kernels and their yardsticks are timed in alternating rounds on one
# card (each round one time_ms of each); the median and range stand.
TURNS = 7


def time_turns(fns: dict, rounds: int = TURNS, iters: int = 10) -> dict:
    """{name: fn} -> {name: (median ms, min, max)} over `rounds` rounds
    that time every function in turn."""
    import statistics
    ms: dict = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            ms[name].append(time_ms(fn, iters=iters, warmup=1))
    return {name: (statistics.median(v), min(v), max(v))
            for name, v in ms.items()}


def segment_ids(gen, b, s, docs):
    """(B, S) int32 ids of `docs` documents of random lengths per row."""
    import torch
    rows = []
    for _ in range(b):
        cuts = torch.randperm(s - 1, generator=gen, device=DEVICE)[:docs - 1]
        start = torch.zeros(s, dtype=torch.int32, device=DEVICE)
        start[cuts.sort().values + 1] = 1
        rows.append(torch.cumsum(start, 0).to(torch.int32))
    return torch.stack(rows)


def visible_pairs(seg, b, s) -> int:
    """Causally visible (query, key) pairs over the batch, per head."""
    if seg is None:
        return b * s * (s + 1) // 2
    n = 0
    for row in seg.tolist():
        counts: dict = {}
        for x in row:
            counts[x] = counts.get(x, 0) + 1
        n += sum(c * (c + 1) // 2 for c in counts.values())
    return n


def flash_bound(pairs_h, nbytes, ops_per_pair_per_dh, dh, h=H) -> tuple:
    ops = ops_per_pair_per_dh * dh * pairs_h * h
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want) -> dict:
    import torch
    atol, rtol, rel_lim = FLASH_TOL[name]
    g, w = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(g).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff = (g - w).abs()
    rel_rms = float(diff.square().mean().sqrt()
                    / w.square().mean().sqrt().clamp_min(1e-30))
    return {"max_abs_err": float(diff.max()),
            "ref_max_abs": float(w.abs().max()), "rel_rms_err": rel_rms,
            "atol": atol, "rtol": rtol, "rel_rms_limit": rel_lim,
            "within": bool((diff <= atol + rtol * w.abs()).all())
            and rel_rms <= rel_lim}


def phase_train_kernel(cases=None) -> dict:
    """The flash kernels against the plain version and timed, per case
    of `cases` (FLASH_CASES by default; an entry's optional fifth and
    sixth values are H and KH, Llama-3.1-8B's 32 and 8 otherwise)."""
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.ops import flash_attention as fl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    results = {}
    failures = []
    for name, (b, s, docs, dh, *hk) in (cases or FLASH_CASES).items():
        h, kh = hk or (H, KH)
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE).to(
                torch.bfloat16)
        q, k, v = rnd(b, s, h, dh), rnd(b, s, kh, dh), rnd(b, s, kh, dh)
        dout = rnd(b, s, h, dh)
        seg = segment_ids(gen, b, s, docs) if docs else None
        scale = dh ** -0.5
        fused = fl.uses_fused_backward(s, s, 1024, 1024)

        # the wrapper, forward and backward, with its launch counts
        fl.reset_counters()
        qk, kk, vk = (t.clone().requires_grad_(True) for t in (q, k, v))
        out_k = fl.flash_attention(qk, kk, vk, segment_ids=seg)
        out_k.backward(dout)
        torch.cuda.synchronize()
        c = fl.counters()
        want_c = {"launches_fwd": 1, "plain_calls": 0,
                  "launches_bwd_fused": int(fused),
                  "launches_bwd_dkdv": int(not fused),
                  "launches_bwd_dq": int(not fused)}
        if c != want_c:
            raise RuntimeError(f"{name}: launches {c}, expected {want_c}")

        # the plain version on the same inputs
        qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
        out_p, lse_p = fl.flash_attention_ref(qp, kp, vp, seg, scale)
        out_p.backward(dout)

        # raw C entries on preallocated kernel-layout buffers, S padded
        # as the wrapper pads it
        s_pad = fl.padded_len(s)
        qt, kt, vt, dot = (fl.to_kernel_layout(x, s_pad)
                           for x in (q, k, v, dout))
        segt = None if seg is None else fl.pad_segments(seg, s_pad)
        out_t = torch.empty_like(qt)
        lse_t = torch.empty((b, h, s_pad), dtype=torch.float32,
                            device=DEVICE)
        delta = torch.empty_like(lse_t)
        dq_t, dk_t, dv_t = (torch.empty_like(x) for x in (qt, kt, vt))
        dq32 = torch.empty(qt.shape, dtype=torch.float32, device=DEVICE)
        segp = None if segt is None else segt.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        f_fwd = fl._kernel("flash_attention_fwd_bf16")
        f_dkdv = fl._kernel("flash_attention_bwd_dkdv_bf16")
        f_dq = fl._kernel("flash_attention_bwd_dq_bf16")
        f_fused = fl._kernel("flash_attention_bwd_fused_bf16")
        dims = (b, h, kh, s_pad, dh)

        def check(err):
            if err:
                raise RuntimeError(f"{name}: kernel launch failed: {err}")

        def fwd():
            check(f_fwd(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), segp,
                        out_t.data_ptr(), lse_t.data_ptr(), *dims, scale,
                        stream))

        def dkdv():
            check(f_dkdv(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                         out_t.data_ptr(), dot.data_ptr(), lse_t.data_ptr(),
                         segp, delta.data_ptr(), dk_t.data_ptr(),
                         dv_t.data_ptr(), *dims, scale, stream))

        def dq():
            check(f_dq(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                       dot.data_ptr(), lse_t.data_ptr(), delta.data_ptr(),
                       segp, dq_t.data_ptr(), *dims, scale, stream))

        def pair():  # the blocked backward as the wrapper runs it
            dkdv()
            dq()

        def fused_bwd():  # zeroing, the kernel and dQ's conversion
            check(f_fused(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                          out_t.data_ptr(), dot.data_ptr(), lse_t.data_ptr(),
                          segp, delta.data_ptr(), dq32.data_ptr(),
                          dq_t.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(),
                          *dims, scale, stream))

        fwd()
        torch.cuda.synchronize()
        errs = {"out": compare("out", out_k, out_p),
                "lse": compare("lse", lse_t[..., :s], lse_p),
                "dq": compare("dq", qk.grad, qp.grad),
                "dk": compare("dk", kk.grad, kp.grad),
                "dv": compare("dv", vk.grad, vp.grad)}
        for key, e in errs.items():
            if not e["within"]:
                failures.append(f"{name}/{key}: {e}")

        pairs = visible_pairs(seg, b, s)
        e2 = 2  # bf16 bytes
        qb = b * s * h * dh * e2
        kvb = b * s * kh * dh * e2
        lb = b * h * s * 4
        bounds = {"fwd": flash_bound(pairs, 2 * qb + 2 * kvb + lb, 4, dh, h)}
        if fused:
            bounds["bwd_fused"] = flash_bound(
                pairs, 4 * qb + 4 * kvb + lb, 10, dh, h)
        else:
            bounds["bwd_dkdv"] = flash_bound(
                pairs, 3 * qb + 4 * kvb + lb, 8, dh, h)
            bounds["bwd_dq"] = flash_bound(
                pairs, 3 * qb + 2 * kvb + 2 * lb, 6, dh, h)
            # the pair as one function: q, k, v, o, dO and the LSE read
            # once, dQ, dK, dV written once; 10 * Dh per visible pair
            bounds["bwd_pair"] = flash_bound(
                pairs, 4 * qb + 4 * kvb + lb, 10, dh, h)

        # the plain version: forward, and backward alone
        times = {"plain_fwd_ms": time_ms(
            lambda: fl.flash_attention_ref(q, k, v, seg, scale), iters=3,
            warmup=1)}
        qp2, kp2, vp2 = (t.clone().requires_grad_(True) for t in (q, k, v))
        o2, _ = fl.flash_attention_ref(qp2, kp2, vp2, seg, scale)
        times["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            o2, (qp2, kp2, vp2), dout, retain_graph=True), iters=3,
            warmup=1)
        del o2, qp2, kp2, vp2

        # library yardstick: SDPA on repeated-KV heads at the unpadded S
        # (never used by the port); the packed cases pass their
        # block-diagonal causal mask
        ql, kl, vl, dol = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, dout))
        ql.requires_grad_(True)
        kl = kl.repeat_interleave(h // kh, dim=1).requires_grad_(True)
        vl = vl.repeat_interleave(h // kh, dim=1).requires_grad_(True)
        if seg is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                ql, kl, vl, is_causal=True)
        else:
            pos = torch.arange(s, device=DEVICE)
            mask = ((pos[:, None] >= pos[None, :])[None]
                    & (seg[:, :, None] == seg[:, None, :]))[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                ql, kl, vl, attn_mask=mask)
        ol = lib()
        turns = {"fwd": fwd, "library_fwd": lib}
        if fused:
            turns["bwd_fused"] = fused_bwd
        else:
            turns.update(bwd_dkdv=dkdv, bwd_dq=dq, bwd_pair=pair)
        turns["library_bwd"] = lambda: torch.autograd.grad(
            ol, (ql, kl, vl), dol, retain_graph=True)
        for key, (med, lo, hi) in time_turns(turns).items():
            times[f"{key}_ms"] = med
            times[f"{key}_range_ms"] = [lo, hi]
        del ol, ql, kl, vl, dol

        res = {"phase": "train_kernel", "case": name, "B": b, "S": s,
               "H": h, "KH": kh, "Dh": dh, "segments_per_row": docs,
               "backward": "fused" if fused else "blocked",
               "visible_pairs_per_head": pairs, "errors": errs, **times,
               "bound_ms": {k: v[0] for k, v in bounds.items()},
               "bound_by": {k: v[1] for k, v in bounds.items()}}
        emit(res)
        results[name] = res
        del q, k, v, dout, qk, kk, vk, qp, kp, vp, out_k, out_p
        del qt, kt, vt, dot, out_t, dq_t, dk_t, dv_t, dq32, segt
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("flash kernels differ from the plain version "
                           "beyond the stated bounds: " + "; ".join(failures))
    return results


# ---------------------------------------------------------------------------
# Phase 2c: the unembed's f32 logits on the card
# ---------------------------------------------------------------------------

# The port's unembed (bf16 operands, f32 logits through
# `ops.matmul_f32`) against the widened float32 product of the same bf16
# values, at the train path's shapes: logits, and the gradients of the
# mean cross-entropy w.r.t. the hidden states and the f32 master head.
# Relative RMS error and largest error over the largest reference entry.
# The logits differ only in summation order (both sum exact products in
# f32); the backward rounds the f32 dlogits to bf16 before two bf16
# products and writes dx in bf16, two roundings of up to 2^-9 each.
# Measured on the card (PERF.md, PR 2): logits 4.4e-6 and 7.4e-6, dx
# 1.7e-3 and 3.2e-3, dW 1.1e-3 and 2.3e-3; the limits are 3-4x these.
UNEMBED_TOL = {"logits": (1.5e-5, 2.5e-5), "dx": (5e-3, 1e-2),
               "dw": (4e-3, 8e-3)}


def unembed_errors(n, d, vocab, gen) -> dict:
    """Errors of the card's unembed, forward and backward, against the
    widened float32 product on (n, d) hidden states and a (d, vocab)
    f32 master head with the reference's init scale."""
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.config import ModelConfig
    from cloud_server_tpu_torch.models import transformer
    cfg = ModelConfig(vocab_size=vocab, embed_dim=d, dtype="bfloat16",
                      param_dtype="float32")
    x = torch.randn((n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    head = torch.randn((d, vocab), generator=gen, device=DEVICE) * d ** -0.5
    targets = torch.randint(0, vocab, (n,), generator=gen, device=DEVICE)

    def run(xx, hh, fn):
        xx.requires_grad_(True)
        hh.requires_grad_(True)
        logits = fn(xx, hh)
        F.cross_entropy(logits, targets).backward()
        return logits.detach(), xx.grad, hh.grad

    got = run(x.clone(), head.clone(), lambda xx, hh: transformer.unembed(
        xx, {"lm_head": {"kernel": hh}}, cfg))
    if got[0].dtype != torch.float32:
        raise RuntimeError(f"unembed gave {got[0].dtype} logits")
    want = run(x.float(), head.to(torch.bfloat16).float(),
               lambda xx, hh: xx @ hh)
    out = {}
    for key, g, w in zip(("logits", "dx", "dw"), got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        rel_rms = float(diff.square().mean().sqrt()
                        / w.square().mean().sqrt())
        rel_max = float(diff.max() / w.abs().max())
        rms_lim, max_lim = UNEMBED_TOL[key]
        out[key] = {"rel_rms_err": rel_rms, "max_err_over_max": rel_max,
                    "rel_rms_limit": rms_lim, "max_limit": max_lim,
                    "within": rel_rms <= rms_lim and rel_max <= max_lim}
    return out


def phase_unembed() -> dict:
    import torch
    from cloud_server_tpu_torch.config import ModelConfig, TrainConfig, \
        from_json
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(TRAIN_CONFIG) as f:
        raw = json.load(f)
    cfg = from_json(ModelConfig, raw["model"])
    tcfg = from_json(TrainConfig, raw["train"])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 2)
    n = tcfg.batch_size * tcfg.seq_len
    errs = unembed_errors(n, cfg.embed_dim, cfg.vocab_size, gen)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "unembed", "N": n, "D": cfg.embed_dim,
           "V": cfg.vocab_size, "errors": errs}
    emit(out)
    bad = [k for k, e in errs.items() if not e["within"]]
    if bad:
        raise RuntimeError(f"unembed on the card differs from the widened "
                           f"f32 product beyond the stated bounds: {bad}")
    return out


# ---------------------------------------------------------------------------
# Phase 2d: the fused-CE kernels against their plain version
# ---------------------------------------------------------------------------

# B7 and B8 against the plain version on the same bf16 inputs at the
# train path's shapes (N = B x S = 8192 rows, D 4096, V 128256, random
# targets, the cotangents of a mean loss). logz and the target logit are
# f32 sums of the same bf16 products in another order: absolute limits.
# An argmax may differ only where the two logits lie within the logz limit
# of each other. dx and dW are bf16 and carry the bf16 rounding of d,
# which the two versions may round to neighbouring values: relative RMS
# error and largest error over the largest entry. Measured on the card
# (PERF.md): logz 1.9e-6, target logit 0, no argmax differs; dx
# 7.8e-6 and 2.8e-3 (one bf16 ulp of a large entry), dW 2.5e-6 and
# 5.3e-4. The limits are about 4x these (the target logit shares logz's).
CE_TOL = {"logz": 8e-6, "tl": 8e-6, "dx": (3e-5, 1e-2), "dw": (1e-5, 2e-3)}
CE_SHAPE = (8192, 4096, 128256)


def ce_bound(n, d, v, dlogits: bool) -> tuple:
    """Least time for B7 (2 N D V operations; x, head and the targets
    read once, three f32/int32 values per row written) or B8 (4 N D V:
    the logits' recompute and dx; x, head, targets, logz and both
    cotangents read once, d and dx written once)."""
    ops = (4 if dlogits else 2) * n * d * v
    nbytes = (n * d + d * v) * 2 + 4 * n
    nbytes += (3 * 4 * n + n * v * 2 + n * d * 2) if dlogits else 3 * 4 * n
    t_ops = ops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_ce_kernel(shape=CE_SHAPE, case: str = "full") -> dict:
    """B7 and B8 against the plain version and timed at `shape` (N, D,
    V). A vocabulary shard of a tp rank (case "tp2_shard", "tp4_shard")
    runs through `fused_ce_shard_stats`: a V that is not a multiple of
    128 is padded with zero columns masked out of the statistics and d."""
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.ops import fused_ce as fc
    from cloud_server_tpu_torch.ops import matmul_f32
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, v = shape
    shard = case != "full"
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 3)
    x = torch.randn((n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    head = (torch.randn((d, v), generator=gen, device=DEVICE)
            * d ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    gz = torch.full((n,), 1.0 / n, device=DEVICE)
    gt = -gz
    head_k = F.pad(head, (0, -v % fc.TILE))  # the kernels' padded head
    wrapper, plain = ((fc.fused_ce_shard_stats, fc.fused_ce_shard_stats_ref)
                      if shard else (fc.fused_ce_stats, fc.fused_ce_stats_ref))

    def run(fn):
        xx = x.clone().requires_grad_(True)
        hh = head.clone().requires_grad_(True)
        logz, tl, am = fn(xx, hh, t)[:3]
        ((logz * gz).sum() + (tl * gt).sum()).backward()
        return logz.detach(), tl.detach(), am, xx.grad, hh.grad

    # the wrapper, forward and backward, with its launch counts
    fc.reset_counters()
    got = run(wrapper)
    torch.cuda.synchronize()
    if fc.counters() != {"launches_fwd": 1, "launches_dx": 1,
                         "plain_calls": 0}:
        raise RuntimeError(f"fused CE launches {fc.counters()}")
    want = run(plain)
    errs = {}
    for key, g, w in zip(("logz", "tl"), got[:2], want[:2]):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{key}: non-finite kernel output")
        err = float((g - w).abs().max())
        errs[key] = {"max_abs_err": err, "limit": CE_TOL[key],
                     "within": err <= CE_TOL[key]}
    logits = torch.mm(x, head, out_dtype=torch.float32)
    rows = torch.arange(n, device=DEVICE)
    gap = logits[rows, want[2]] - logits[rows, got[2]]
    del logits
    errs["argmax"] = {"differ": int((got[2] != want[2]).sum()),
                      "differ_beyond_limit": int((gap > CE_TOL["logz"]).sum()),
                      "largest_gap": float(gap.max())}
    errs["argmax"]["within"] = errs["argmax"]["differ_beyond_limit"] == 0
    for key, g, w in zip(("dx", "dw"), got[3:], want[3:]):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        rms_lim, max_lim = CE_TOL[key]
        rel_rms = float(diff.square().mean().sqrt()
                        / w.square().mean().sqrt())
        rel_max = float(diff.max() / w.abs().max())
        errs[key] = {"max_abs_err": float(diff.max()),
                     "rel_rms_err": rel_rms, "max_err_over_max": rel_max,
                     "rel_rms_limit": rms_lim, "max_limit": max_lim,
                     "within": rel_rms <= rms_lim and rel_max <= max_lim}
    logz = got[0]
    del got, want
    gc.collect()
    torch.cuda.empty_cache()

    # B7 and B8 (the wrapper's own launch functions) in turns with their
    # cuBLAS yardsticks, the products alone without the epilogues: with
    # f32 output (library_*, the kernels line's library_ms; x @ head then
    # writes 4.2 GB of logits that B7 never writes) and with bf16 output
    # (library_*_bf16: 2.1 GB, as B8's d launch writes); and B8's two
    # launches alone
    t32 = t.to(torch.int32)
    dbuf, dx = fc.backward_dx(x, head_k, t32, logz, gz, gt, v)
    turns = time_turns({
        "b7": lambda: fc.forward_stats(x, head_k, t32, v, with_max=shard),
        "library_b7": lambda: torch.mm(x, head, out_dtype=torch.float32),
        "library_b7_bf16": lambda: torch.mm(x, head),
        "b8": lambda: fc.backward_dx(x, head_k, t32, logz, gz, gt, v),
        "library_b8": lambda: (
            torch.mm(x, head, out_dtype=torch.float32),
            torch.mm(dbuf[:, :v], head.t(), out_dtype=torch.float32)),
        "library_b8_bf16": lambda: (torch.mm(x, head),
                                    torch.mm(dbuf[:, :v], head.t())),
        "b8_d": lambda: fc._launch_dlogits(x, head_k, t32, logz, gz, gt,
                                           dbuf, v),
        "b8_dx": lambda: fc._launch_dx(dbuf, head_k, dx),
        "library_b8_dx": lambda: torch.mm(dbuf[:, :v], head.t(),
                                          out_dtype=torch.float32)},
        iters=3)
    times = {f"{k}_ms": m for k, (m, _, _) in turns.items()}
    times["range_ms"] = {k: [lo, hi] for k, (_, lo, hi) in turns.items()}
    with torch.no_grad():
        times["plain_b7_ms"] = time_ms(
            lambda: plain(x, head, t), iters=3, warmup=1)
        times["plain_b8_ms"] = time_ms(
            lambda: matmul_f32(fc._dlogits_ref(x, head_k, t, logz, gz, gt,
                                               v), head_k.t()).to(x.dtype),
            iters=3, warmup=1)
    b7b, b8b = ce_bound(n, d, v, False), ce_bound(n, d, v, True)
    out = {"phase": "ce_kernel", "case": case, "N": n, "D": d, "V": v,
           "V_padded": head_k.shape[1],
           "vocab_splits": fc.device_splits(n, v, x.device),
           "errors": errs, **times,
           "bound_ms": {"b7": b7b[0], "b8": b8b[0]},
           "bound_by": {"b7": b7b[1], "b8": b8b[1]},
           "share_of_bound": {"b7": b7b[0] / times["b7_ms"],
                              "b8": b8b[0] / times["b8_ms"]}}
    emit(out)
    del x, head, head_k, dbuf, dx
    gc.collect()
    torch.cuda.empty_cache()
    bad = [k for k, e in errs.items() if not e["within"]]
    if bad:
        raise RuntimeError(f"fused CE kernels differ from the plain version "
                           f"beyond the stated bounds: {bad}")
    return out


# ---------------------------------------------------------------------------
# Phase 3i: tensor-parallel serving (tp 2 at Llama-3.1-8B width)
# ---------------------------------------------------------------------------

TP = 2
TP_BUDGET_S = 150.0
# The tp phase's depth with both ranks on one card, where each of a
# step's all-reduces goes through host copies over gloo between two
# processes time-sliced on the card: at all 32 layers a steady step took
# 1.4-5.8 s over runs on H100 machines (700 W), and the phase up to
# 167 s, past TP_BUDGET_S. With one rank a card (NCCL) it runs every
# layer.
TP_LAYERS_ONE_CARD = 8
# Ranks are joined within this long, and a collective no rank joins
# raises after TP_TIMEOUT_S (parallel.spawn_ranks).
TP_DEADLINE_S = 600.0
TP_TIMEOUT_S = 300.0
TP_STEADY_STEPS = 3
TP_NGRAM_DRAFTS = 4


def tp_backend() -> tuple:
    """The tp phase's collectives, chosen here in the open (the server
    takes the mesh's): NCCL with one rank a card and graphs on where
    there are two cards or more; on one card both ranks share card 0
    over gloo (NCCL refuses two ranks on one device) with graphs off,
    since gloo collectives cannot be captured. (backend, cards,
    graphs)."""
    import torch
    cards = torch.cuda.device_count()
    return ("nccl", cards, True) if cards >= TP else ("gloo", cards, False)


def tp_launch_spans(srv) -> list:
    """Wrap the server's launcher so every program launch on this rank
    is bracketed by two CUDA events (the device span from its input
    copies to its result copies); returns the list they land in."""
    import torch
    spans: list = []
    run = srv._run

    def timed(body, flags, staged):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        prog = run(body, flags, staged)
        end.record()
        spans.append((body.__name__, start, end))
        return prog

    srv._run = timed
    return spans


def tp_rank(rank: int, world: int, params, cfg, p32, cfg32, icfg, prompts,
            graphs: bool) -> dict:
    """One rank of the tp phase: every rank builds each server with the
    same arguments on its card (card 0 for both on one card); rank 0
    serves the requests, the other ranks follow. Per run: rank 0's
    tokens and stats, each rank's B1/B2 counts, weight and pool bytes,
    peak memory and per-launch device spans."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.config import MeshConfig
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    from cloud_server_tpu_torch.ops import paged_attention as pa
    from cloud_server_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)  # the card is this process's before the mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig(tp=world), device_type="cuda")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    runs = [("bf16", params, cfg, {}), ("f32", p32, cfg32, {}),
            ("int8", params, cfg8, {}),
            ("ngram", params, cfg, {"spec_drafts": TP_NGRAM_DRAFTS})]
    if graphs:
        runs.insert(1, ("bf16_graphs_off", params, cfg,
                        {"cuda_graphs": False}))
    out = {}
    for name, p, c, kw in runs:
        kw.setdefault("cuda_graphs", graphs)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        srv = PagedInferenceServer(
            p, c, icfg, max_slots=8, max_context=MAX_CTX, page_size=PS,
            prefill_chunk=256, seed=SEED, mesh=mesh, device=dev, **kw)
        res = {"weight_bytes": sum(
            t.numel() * t.element_size() for g in srv.params.values()
            for t in g.values()), "pool_bytes": srv.kv_cache_bytes()}
        spans = tp_launch_spans(srv)
        pa.reset_counters()
        if rank > 0:
            srv.follow()
        else:
            reqs = [srv.submit(q, max_new_tokens=MAX_NEW) for q in prompts]
            srv.run_until_idle()
            res["tokens"] = [r.tokens for r in reqs]
            res["finish"] = [r.finish_reason for r in reqs]
            res["decode_rounds"] = srv.decode_rounds
            res["tokens_committed"] = srv.decode_tokens_committed
            if name == "bf16":
                # steady decode steps: 8 live slots, every program made
                live = [srv.submit(q, max_new_tokens=LONG_NEW)
                        for q in prompts]
                while srv._jobs or srv.num_pending:
                    srv.step()
                for _ in range(2):
                    srv.step()
                i0, t_s = len(spans), time.perf_counter()
                for _ in range(TP_STEADY_STEPS):
                    srv.step()
                res["steady_wall_ms"] = ((time.perf_counter() - t_s) * 1e3
                                         / TP_STEADY_STEPS)
                res["steady_launches"] = [i0, len(spans)]
                res["steady_live"] = srv.num_active
                cancel_all(srv, live)
            res["tp"] = srv.tp_stats()
            srv.stop()
        torch.cuda.synchronize(dev)
        res["counts"] = pa.counters()
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["launch_ms"] = [(n, a.elapsed_time(b)) for n, a, b in spans]
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
        del srv, spans
        gc.collect()
        torch.cuda.empty_cache()
    # drop this rank's views of the parent's shared CUDA memory before it
    # exits (a spawned process ends without running their deleters, and
    # the parent could not free that memory until it exits itself)
    params.clear()
    p32.clear()
    gc.collect()
    return out


def one_card_tokens(params, cfg, icfg, prompts) -> dict:
    """The prompts' greedy tokens on the default one-card server, on the
    bf16 and on the int8 cache, in the serve phase's shape: {"tokens":
    [...], "int8": {"tokens": [...]}}."""
    import dataclasses
    import torch
    tokens = {}
    for name, c in (("bf16", cfg),
                    ("int8", dataclasses.replace(cfg,
                                                 kv_cache_dtype="int8"))):
        srv = make_server(params, c, icfg)
        reqs, _, _, _ = serve_once(params, c, icfg, prompts, srv=srv)
        srv.stop()
        check_served(reqs, cfg.vocab_size)
        tokens[name] = [r.tokens for r in reqs]
        del srv, reqs
        gc.collect()
        torch.cuda.empty_cache()
    return {"tokens": tokens["bf16"], "int8": {"tokens": tokens["int8"]}}


def phase_tp(serve=None) -> dict:
    """Tensor-parallel serving at tp 2 (`PagedInferenceServer(mesh=...)`,
    one process per rank, `parallel.spawn_ranks`) on the serve phase's
    seeded weights (on one card their first TP_LAYERS_ONE_CARD layers),
    shared with the ranks as CUDA memory: the 8 greedy requests against
    the one-card server's tokens at the same depth (the serve phase's,
    when given and of the same depth) by the near-tie rule, graphed ==
    graphs off where the backend captures, a 2-layer float32 slice token
    for token, the int8 cache against the one-card int8 tokens, a short
    n-gram run; each rank's B1/B2 launches, weight and
    pool bytes, peak memory, a steady decode step's device span, and
    rank 0's wall time per step and per-dispatch broadcast."""
    import numpy as np
    import torch
    from cloud_server_tpu_torch.config import (InferConfig, ModelConfig,
                                               from_json)
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.parallel import spawn_ranks
    t_phase = time.perf_counter()
    backend, cards, graphs = tp_backend()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(CONFIG) as f:
        cfg = from_json(ModelConfig, json.load(f)["model"])
    params = transformer.init_params(cfg, SEED, device=DEVICE)
    p32, cfg32 = f32_slice(params, cfg)
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    prompts = make_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    if backend == "gloo":
        params, cfg = first_layers(params, cfg, TP_LAYERS_ONE_CARD)
        serve = None  # the serve phase's tokens are the whole model's
    if serve is None:
        serve = one_card_tokens(params, cfg, icfg, prompts)
    # the float32 slice on one card (the tp run must equal it exactly)
    srv = make_server(p32, cfg32, icfg)
    want32, _, _, _ = serve_once(p32, cfg32, icfg, prompts, srv=srv)
    srv.stop()
    del srv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, TP, backend, params, cfg, p32, cfg32, icfg,
                        prompts, graphs, deadline_s=TP_DEADLINE_S,
                        timeout_s=TP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    r0 = ranks[0]
    vocab = cfg.vocab_size

    def as_reqs(tokens, finish=None):
        return [types.SimpleNamespace(tokens=t, finish_reason=f)
                for t, f in zip(tokens, finish or [None] * len(tokens))]

    for name in r0:
        check_served(as_reqs(r0[name]["tokens"], r0[name]["finish"]), vocab)
        for r, res in enumerate(ranks):
            c = res[name]["counts"]
            if name == "f32":
                continue  # the plain attention path (f32_slice)
            narrow, wide = (("launches_narrow_int8", "launches_wide_int8")
                            if name == "int8" else
                            ("launches_narrow", "launches_wide"))
            if c[narrow] <= 0 or c[wide] <= 0 or c["plain_calls"]:
                raise RuntimeError(f"tp {name}, rank {r}: launches {c}")
    same_tokens("tp float32 slice vs one card",
                as_reqs(r0["f32"]["tokens"]), [r.tokens for r in want32])
    if graphs:
        same_tokens("tp graphed vs graphs off",
                    as_reqs(r0["bf16_graphs_off"]["tokens"]),
                    r0["bf16"]["tokens"])
    want = as_reqs(serve["tokens"])
    bf16 = near_tie_divergence("tp bf16 vs one card",
                               as_reqs(r0["bf16"]["tokens"]), want, prompts,
                               params, cfg)
    int8 = near_tie_divergence("tp int8 vs one card's int8",
                               as_reqs(r0["int8"]["tokens"]),
                               as_reqs(serve["int8"]["tokens"]), prompts,
                               params, cfg)
    ngram = near_tie_divergence("tp n-gram vs one card",
                                as_reqs(r0["ngram"]["tokens"]), want,
                                prompts, params, cfg)
    del params, p32
    gc.collect()
    torch.cuda.empty_cache()
    i0, i1 = r0["bf16"]["steady_launches"]
    per_rank = []
    for r, res in enumerate(ranks):
        b = res["bf16"]
        steady = [ms for _, ms in b["launch_ms"][i0:i1]]
        per_rank.append({
            "rank": r, "counts": b["counts"],
            "counts_int8": res["int8"]["counts"],
            "counts_ngram": res["ngram"]["counts"],
            "weight_bytes": b["weight_bytes"], "pool_bytes": b["pool_bytes"],
            "int8_pool_bytes": res["int8"]["pool_bytes"],
            "peak_gb": {n: v["peak_bytes"] / 1e9 for n, v in res.items()},
            "steady_device_span_ms_per_step": sum(steady) / TP_STEADY_STEPS,
            "steady_launches": len(steady)})
    ng = r0["ngram"]
    out = {"phase": "tp", "tp": TP, "backend": backend, "cards": cards,
           "graphs": graphs, "layers": cfg.num_layers,
           "model": "Llama-3.1-8B (random bf16 weights)",
           "requests": len(prompts), "max_new_tokens": MAX_NEW,
           "bf16_vs_one_card": bf16, "int8_vs_one_card_int8": int8,
           "ngram_vs_one_card": ngram,
           "f32_slice_token_for_token": True,
           "graphed_equals_graphs_off": True if graphs else None,
           "ngram_committed_per_round": (ng["tokens_committed"]
                                         / max(1, ng["decode_rounds"])),
           "steady_wall_ms_per_step": r0["bf16"]["steady_wall_ms"],
           "steady_live_slots": r0["bf16"]["steady_live"],
           "broadcast": r0["bf16"]["tp"],
           "broadcast_int8": r0["int8"]["tp"],
           "ranks": per_rank,
           "run_seconds": {n: v["seconds"] for n, v in r0.items()},
           "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase}
    emit(out)
    if out["seconds"] > TP_BUDGET_S:
        print(f"tp phase: {out['seconds']:.1f} s, over its "
              f"{TP_BUDGET_S} s budget at {cfg.num_layers} layers",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4: training at Llama-3.1-8B's widths (8 layers)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6        # at S 2048: B3 (x2 with remat), B4, B5
FUSED_STEPS = 2        # at S 1024: B3 (x2), B6
LOSS_TOL = 0.5         # first loss vs ln V
# The 2-layer slice, kernels vs plain attention on the card, bf16: the
# loss within this absolute difference, every gradient leaf's error norm
# within this share of the plain gradient's norm. The two attentions
# round to bf16 at other points (the kernel its unnormalised
# probabilities and dS, the plain version its normalised probabilities),
# and that difference runs through two layers into the f32 loss;
# measured 2.6e-4 and 1.2e-2 (PERF.md, PR 2), limits about 8x and 2.5x.
SLICE_LOSS_ATOL = 2e-3
SLICE_GRAD_REL = 3e-2
# The 2-layer slice, fused CE (B7/B8) vs the dense CE, same weights and
# batch: both take f32 logits of the same bf16 operands and round the
# logits' gradient to bf16 before the two backward products, so the loss
# differs in summation order only and the gradients by bf16 roundings.
# Measured (PERF.md): loss equal, worst leaf 6.1e-3; the loss limit
# is the f32 resolution of a logsumexp of 128256 terms at 12, the
# gradient limit about 3x its reading.
CE_SLICE_LOSS_ATOL = 1e-4
CE_SLICE_GRAD_REL = 2e-2
CE_EVAL_EVERY, CE_EVAL_BATCHES = 3, 2   # the fused config's loop section
LOG_DIR = "cloud_server_tpu_torch/_build/smoke_train"


def train_run(tag, extra, config=TRAIN_CONFIG, synthetic: int = 64) -> tuple:
    """One run of the training CLI; returns (final state, JSONL records,
    launch counts of the flash and the fused-CE kernels, peak memory,
    wall seconds)."""
    import shutil
    import torch
    from cloud_server_tpu_torch import train
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import fused_ce as fc
    from cloud_server_tpu_torch.utils.logging import read_jsonl
    logdir = os.path.join(LOG_DIR, tag)
    shutil.rmtree(logdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fl.reset_counters()
    fc.reset_counters()
    t0 = time.perf_counter()
    state = train.main(["--config", config, "--synthetic", str(synthetic),
                        "--logdir", logdir, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fl.counters()
    ce_counts = fc.counters()
    peak = torch.cuda.max_memory_allocated()
    return state, read_jsonl(os.path.join(logdir, "train.jsonl")), \
        (counts, ce_counts), peak, wall


def check_run(tag, cfg, recs, counts, steps, fused, vocab,
              eval_fwd: int = 0) -> None:
    """Losses and the flash launches against layers x steps; `eval_fwd`
    forward launches of evaluation (no remat without autograd)."""
    losses = [r["loss"] for r in recs if "loss" in r]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{tag}: losses {losses}")
    if abs(losses[0] - math.log(vocab)) > LOSS_TOL:
        raise RuntimeError(f"{tag}: first loss {losses[0]} is not within "
                           f"{LOSS_TOL} of ln V = {math.log(vocab)}")
    per = cfg.num_layers * steps
    want = {"launches_fwd": (2 * per if cfg.remat == "full" else per)
            + eval_fwd,
            "launches_bwd_dkdv": 0 if fused else per,
            "launches_bwd_dq": 0 if fused else per,
            "launches_bwd_fused": per if fused else 0, "plain_calls": 0}
    if counts != want:
        raise RuntimeError(f"{tag}: launches {counts}, expected {want} "
                           f"({cfg.num_layers} layers x {steps} steps)")


def _leaf_grads(params, cfg, toks, loss_fn=None):
    """(loss, {path: grad}) of one loss call on fresh autograd leaves."""
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.training.optim import flatten
    p = {g: {n: t.detach().clone().requires_grad_(True)
             for n, t in leaves.items()} for g, leaves in params.items()}
    loss, _ = (loss_fn or transformer.next_token_loss)(p, {"tokens": toks},
                                                       cfg)
    loss.backward()
    return float(loss.detach()), {k: t.grad for k, t in flatten(p)}


def _worst_rel(got: dict, want: dict) -> float:
    return max(float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm().clamp_min(1e-30))
               for k in want)


def _slice_batch(cfg, tcfg):
    import numpy as np
    import torch
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    ds = SyntheticLMDataset(2, tcfg.seq_len, cfg.vocab_size, seed=SEED)
    toks = torch.from_numpy(np.stack([ds[i]["tokens"] for i in range(2)]))
    return toks.long().to(DEVICE)


def slice_agreement(cfg, tcfg) -> dict:
    """A 2-layer slice at the same widths: one step's loss and gradients
    through the flash kernels against the same step through the plain
    attention ("xla"), same f32 master weights and batch."""
    import dataclasses
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import flash_attention as fl
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params = transformer.init_params(cfg2, SEED, device=DEVICE)
    toks = _slice_batch(cfg, tcfg)
    n0 = fl.launches_fwd
    lk, gk = _leaf_grads(params, cfg2, toks)
    if fl.launches_fwd == n0:
        raise RuntimeError("the 2-layer check did not use the kernels")
    lp, gp = _leaf_grads(params, dataclasses.replace(
        cfg2, attention_impl="xla"), toks)
    worst = _worst_rel(gk, gp)
    res = {"slice_layers": 2, "slice_loss_kernel": lk, "slice_loss_plain": lp,
           "slice_loss_abs_err": abs(lk - lp),
           "slice_loss_limit": SLICE_LOSS_ATOL,
           "slice_grad_worst_rel_err": worst,
           "slice_grad_rel_limit": SLICE_GRAD_REL}
    if abs(lk - lp) > SLICE_LOSS_ATOL or worst > SLICE_GRAD_REL:
        raise RuntimeError(f"2-layer slice: kernels differ from the plain "
                           f"attention: {res}")
    return res


def ce_agreement(cfg, tcfg) -> dict:
    """A 2-layer slice at full width: one step's loss and gradients with
    ce_impl="pallas" (B7/B8) against ce_impl="dense", same f32 master
    weights and batch."""
    import dataclasses
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import fused_ce as fc
    cfg2 = dataclasses.replace(cfg, num_layers=2, ce_impl="pallas")
    params = transformer.init_params(cfg2, SEED, device=DEVICE)
    toks = _slice_batch(cfg, tcfg)
    n0 = (fc.launches_fwd, fc.launches_dx)
    lk, gk = _leaf_grads(params, cfg2, toks)
    if (fc.launches_fwd, fc.launches_dx) == n0:
        raise RuntimeError("the 2-layer CE check did not use the kernels")
    ld, gd = _leaf_grads(params, dataclasses.replace(cfg2, ce_impl="dense"),
                         toks)
    worst = _worst_rel(gk, gd)
    res = {"ce_slice_layers": 2, "ce_slice_loss_fused": lk,
           "ce_slice_loss_dense": ld, "ce_slice_loss_abs_err": abs(lk - ld),
           "ce_slice_loss_limit": CE_SLICE_LOSS_ATOL,
           "ce_slice_grad_worst_rel_err": worst,
           "ce_slice_grad_rel_limit": CE_SLICE_GRAD_REL}
    if abs(lk - ld) > CE_SLICE_LOSS_ATOL or worst > CE_SLICE_GRAD_REL:
        raise RuntimeError(f"2-layer slice: the fused CE differs from the "
                           f"dense CE: {res}")
    return res


def write_eval_tokens(tcfg, vocab) -> str:
    """A token file of CE_EVAL_BATCHES batches of random tokens, uint32
    with its .meta.json sidecar (the vocabulary exceeds uint16)."""
    import numpy as np
    from cloud_server_tpu_torch.data.dataset import write_token_file
    os.makedirs(LOG_DIR, exist_ok=True)
    path = os.path.join(LOG_DIR, "eval.bin")
    n = CE_EVAL_BATCHES * tcfg.batch_size * tcfg.seq_len
    write_token_file(path, np.random.default_rng(SEED + 4).integers(
        0, vocab, n), dtype=np.uint32)
    with open(path + ".meta.json", "w") as f:
        json.dump({"dtype": "uint32"}, f)
    return path


def plain_batch(cfg, tcfg) -> dict:
    """The train phase's batch: B rows of SyntheticLMDataset on the
    card."""
    import torch
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.data.loader import _collate, to_device
    ds = SyntheticLMDataset(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size,
                            seed=SEED)
    return to_device(_collate(ds, range(tcfg.batch_size)),
                     torch.device(DEVICE))


def profile_train_step(cfg, tcfg, state) -> dict:
    """One more step of a run's final state under the profiler."""
    from cloud_server_tpu_torch.training.train_step import make_train_step
    step_fn = make_train_step(cfg, tcfg)
    batch = plain_batch(cfg, tcfg)
    box = [state]

    def one_step():
        box[0], _ = step_fn(box[0], batch)

    return profile_step(one_step)


def run_summary(recs, tcfg, flops, peak, wall, counts, skip=()) -> dict:
    """Losses, times and rates of one run's JSONL records; the steady step
    time leaves out the first step and the steps in `skip`."""
    steps = [r for r in recs if "loss" in r]
    steady = [r for r in steps[1:] if r["step"] not in skip]
    step_s = sum(r["step_time_s"] for r in steady) / len(steady)
    tokens = tcfg.batch_size * tcfg.seq_len
    return {"steps": len(steps), "seq_len": tcfg.seq_len,
            "batch": tcfg.batch_size, "losses": [r["loss"] for r in steps],
            "grad_norms": [r["grad_norm"] for r in steps],
            "step_time_s_steady": step_s,
            "step_times_s": [r["step_time_s"] for r in steps],
            "tokens_per_s": tokens / step_s,
            "mfu": tokens / step_s * flops / BF16_FLOP_PER_S,
            "peak_mem_gb": peak / 1e9, "wall_s": wall, "counts": counts}


def phase_train() -> dict:
    import torch
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    from cloud_server_tpu_torch.utils.metrics import (
        param_count, transformer_flops_per_token)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(TRAIN_CONFIG) as f:
        raw = json.load(f)
    cfg = from_json(ModelConfig, raw["model"])
    tcfg = from_json(TrainConfig, raw["train"])
    flops = transformer_flops_per_token(cfg, tcfg.seq_len)

    state, recs, (counts, _), peak, wall = train_run(
        "s2048", ["--steps", str(TRAIN_STEPS)])
    check_run("S 2048", cfg, recs, counts, TRAIN_STEPS, False,
              cfg.vocab_size)
    n_params = param_count(state.params)
    run1 = run_summary(recs, tcfg, flops, peak, wall, counts)
    run1["profile_step"] = profile_train_step(cfg, tcfg, state)
    del state

    state, recs2, (counts2, _), peak2, wall2 = train_run(
        "s1024", ["--steps", str(FUSED_STEPS), "--seq-len", "1024"])
    check_run("S 1024", cfg, recs2, counts2, FUSED_STEPS, True,
              cfg.vocab_size)
    del state
    run2 = {"steps": FUSED_STEPS, "seq_len": 1024,
            "losses": [r["loss"] for r in recs2],
            "step_times_s": [r["step_time_s"] for r in recs2],
            "peak_mem_gb": peak2 / 1e9, "wall_s": wall2, "counts": counts2}

    # the fused CE (B7/B8) with evaluation: the config's loop section
    # evaluates every CE_EVAL_EVERY steps over CE_EVAL_BATCHES batches
    with open(FUSED_CE_CONFIG) as f:
        fcfg = from_json(ModelConfig, json.load(f)["model"])
    eval_path = write_eval_tokens(tcfg, cfg.vocab_size)
    state, recs3, (counts3, ce3), peak3, wall3 = train_run(
        "fused_ce", ["--steps", str(TRAIN_STEPS), "--eval-data", eval_path],
        config=FUSED_CE_CONFIG)
    evals = TRAIN_STEPS // CE_EVAL_EVERY
    check_run("fused CE", fcfg, recs3, counts3, TRAIN_STEPS, False,
              cfg.vocab_size,
              eval_fwd=fcfg.num_layers * evals * CE_EVAL_BATCHES)
    want_ce = {"launches_fwd": TRAIN_STEPS + evals * CE_EVAL_BATCHES,
               "launches_dx": TRAIN_STEPS, "plain_calls": 0}
    if ce3 != want_ce:
        raise RuntimeError(f"fused CE: launches {ce3}, expected {want_ce}")
    eval_recs = [r for r in recs3 if "eval_loss" in r]
    if ([r["step"] for r in eval_recs]
            != list(range(CE_EVAL_EVERY, TRAIN_STEPS + 1, CE_EVAL_EVERY))
            or not all(math.isfinite(r["eval_loss"])
                       and abs(r["eval_ppl"] - math.exp(r["eval_loss"]))
                       <= 1e-6 * r["eval_ppl"] for r in eval_recs)):
        raise RuntimeError(f"fused CE: eval records {eval_recs}")
    # a step after an evaluation carries the evaluation's time
    run3 = run_summary(recs3, tcfg, flops, peak3, wall3, counts3,
                       skip={r["step"] + 1 for r in eval_recs})
    run3.update(ce_counts=ce3, evals=[
        {k: r[k] for k in ("step", "eval_loss", "eval_ppl", "eval_accuracy",
                           "eval_tokens")} for r in eval_recs],
        profile_step=profile_train_step(fcfg, tcfg, state))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    agree = slice_agreement(cfg, tcfg)
    gc.collect()
    torch.cuda.empty_cache()
    ce_agree = ce_agreement(cfg, tcfg)
    total = {k: counts[k] + counts2[k] + counts3[k] for k in counts}
    out = {"phase": "train", "model": "Llama-3.1-8B widths, 8 layers "
           "(random f32 master weights, bf16 compute)",
           "layers": cfg.num_layers, "params": n_params,
           "flops_per_token": flops, "run_s2048": run1, "run_s1024": run2,
           "run_fused_ce": run3, "counts": total, "ce_counts": ce3,
           **agree, **ce_agree}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 4a: data-, tensor- and sequence-parallel training
# ---------------------------------------------------------------------------

# One card: two ranks share card 0 over gloo (NCCL refuses two ranks on
# one device), each collective moved through the ranks' mailboxes on the
# card (`collectives._CardMailbox`), at PTRAIN_LAYERS_ONE_CARD layers.
# The cases: (name, mesh axes, attention_impl, sequence length, steps,
# kind). fsdp, tp, pp and the adapters run the flash kernels' blocked
# backward at S 2048 (B3, B4, B5), Ulysses over the whole sequence of
# 1024 their fused one (B3, B6); every case runs B7 and B8 (on each tp
# rank's 64128 vocabulary rows at tp 2, on every pipeline stage at
# pp 2). The kinds: "dense" (the fused-CE Llama-3.1-8B train config),
# "pipeline" (the same model with its layers split over pp, one a
# stage, the 4 rows in PTRAIN_MICROBATCHES microbatches:
# `make_pipelined_loss`), "lora" (PTRAIN_LORA adapters over the same
# base) and "moe" (mixtral_8x7b_train.json's widths, E 8, k 2, the fused
# CE, 4 rows, at PTRAIN_MOE_LAYERS layers: two ranks' states beside the
# one-rank runs' kept parameters and moments do not fit the card at 2).
# The dense and pipeline cases run 3 steps: with the learning rate 0 at
# the first step (warmup), 2 steps make one update, and at sp 2 with
# the ring its parameters read 0.1097 of their update against the
# limit's 0.1 (tp 2: 0.1162; an H100 80GB HBM3 at 700 W). The adapters and
# the experts run 2 (the second step's moments still depend on the
# first). The parent keeps each one-rank run's parameters and moments on
# the card beside the ranks.
PTRAIN_LAYERS_ONE_CARD = 2
PTRAIN_MOE_LAYERS = 1
PTRAIN_CASES = (("pp2", {"pp": 2}, "flash", 2048, 3, "pipeline"),
                ("fsdp2", {"fsdp": 2}, "flash", 2048, 3, "dense"),
                ("tp2", {"tp": 2}, "flash", 2048, 3, "dense"),
                ("sp2_ulysses", {"sp": 2}, "ulysses", 1024, 3, "dense"),
                ("sp2_ring", {"sp": 2}, "ring", 1024, 3, "dense"),
                ("ep2", {"ep": 2}, "flash", 2048, 2, "moe"),
                ("lora_fsdp2", {"fsdp": 2}, "flash", 2048, 2, "lora"))
PTRAIN_MICROBATCHES = 2
PTRAIN_LORA = dict(rank=16, alpha=32.0)
# the adapters' B drawn non-zero (it starts at zero), so A has a
# gradient from the first step
PTRAIN_LORA_B_STD = 0.02
# Four cards (`--ptrain-only`, NCCL, one rank a card): fsdp 2 x tp 2 and
# pp 2 x fsdp 2 at PTRAIN_LAYERS_NCCL layers against the one-card step of
# the same depth; fsdp 2 x ep 2 at PTRAIN_MOE_LAYERS_NCCL Mixtral layers,
# whose state does not fit one card: no one-card run to hold it against
# beyond its float32 first step at the cut width.
PTRAIN_LAYERS_NCCL = 8
PTRAIN_MOE_LAYERS_NCCL = 4
PTRAIN_NCCL_CASES = (
    ("fsdp2_tp2", {"fsdp": 2, "tp": 2}, "flash", 2048, 3, "dense"),
    ("pp2_fsdp2", {"pp": 2, "fsdp": 2}, "flash", 2048, 3, "pipeline"),
    ("fsdp2_ep2", {"fsdp": 2, "ep": 2}, "flash", 2048, 2, "moe"))
# bf16 compute, the mesh step against the one-rank step on the same
# state and batch: each loss within PTRAIN_LOSS_RTOL; each step's global
# gradient norm within PTRAIN_GNORM_RTOL; each leaf's first moment after
# the steps (0.1, 0.09, 0.081 x the steps' clipped gradients), in
# norm, within PTRAIN_MU_REL of the one-rank run's; each leaf's
# difference after the steps, in norm, within PTRAIN_PARAM_REL of the
# norm of the one-rank run's update to that leaf (the sums over ranks
# reorder bf16-rounded reductions, and AdamW's first steps move each
# element by about the learning rate whatever its gradient's size, so
# this one alone would not see a gradient off by a factor). A control
# holds the checks to a fault they must see: the one-rank run again with
# one tp-split leaf's gradient doubled (PTRAIN_CONTROL_LEAF, a missing
# identity/sum pair's fault), read by the same checks, must fail them.
# On H100s the sound cases read at most 2.2e-5 (loss), 2.6e-4 (grad
# norm), 0.018 (moments) and 0.081 (parameters); the control 1.1e-5 to
# 2.9e-5, 0.21 to 0.35, 0.56 to 0.68 and 0.030 to 0.047: the loss and
# the parameters do not tell it from a sound run, the gradient norm and
# the moments do.
PTRAIN_LOSS_RTOL = 2e-4
PTRAIN_GNORM_RTOL = 2e-3
PTRAIN_MU_REL = 0.05
PTRAIN_PARAM_REL = 0.1
PTRAIN_CONTROL_LEAF = "layers/wo"
# float32 at a cut width, a first step with the learning rate at its
# peak (no warmup): the loss within rtol 1e-5, each leaf's first moment
# (0.1 x the synced, clipped gradient) within PTRAIN_F32_REL of its norm,
# and each parameter within PTRAIN_F32_PARAM_REL of its update's norm
# (AdamW's first update is lr * sign(g) per element, so an element whose
# gradient sums to float32 noise may flip; the norm bounds their share).
PTRAIN_F32 = dict(vocab_size=1000, embed_dim=256, num_heads=4,
                  num_kv_heads=2, head_dim=64, mlp_dim=512,
                  dtype="float32", param_dtype="float32", ce_impl="dense",
                  remat="full")
PTRAIN_F32_RTOL = 1e-5
PTRAIN_F32_REL = 1e-5
PTRAIN_F32_PARAM_REL = 1e-2
# The kernels at the shapes a rank gives them on this path: one tp 2
# rank's heads of Llama-3.1-8B (the blocked backward at S 2048) and
# Ulysses' H/sp heads over the whole sequence of 1024 at sp 2 (fused);
# the fused CE on one tp 2 rank's 64128 vocabulary rows, and on a tp 4
# rank's 32064 (not a multiple of 128: padded and masked).
PTRAIN_FLASH_CASES = {"tp2_heads": (4, 2048, 0, 128, 16, 4),
                      "ulysses_sp2": (4, 1024, 0, 128, 16, 4),
                      # one microbatch of a pipeline stage at pp 2 (B 2
                      # of 4), the full heads
                      "b2_s2048": (2, 2048, 0, 128, 32, 8),
                      # Mixtral's attention beside the experts over ep 2
                      "b4_s2048": (4, 2048, 0, 128, 32, 8)}
PTRAIN_CE_SHARDS = {"tp2_shard": (8192, 4096, 64128),
                    "tp4_shard": (8192, 4096, 32064),
                    # Mixtral's vocabulary beside the experts over ep 2
                    # (every pipeline stage's loss is CE_SHAPE's)
                    "ep2_moe": (8192, 4096, 32000)}
PTRAIN_DEADLINE_S = 900.0
# a collective that a rank never joins raises after this long (a step's
# collectives take seconds, over gloo on one card up to about 20 s)
PTRAIN_TIMEOUT_S = 120.0
PTRAIN_BUDGET_S = 150.0


def ptrain_configs(layers: int) -> tuple:
    """(ModelConfig, TrainConfig) of the fused-CE train config at
    `layers` layers (flash attention, the fused CE kernels)."""
    import dataclasses
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    with open(FUSED_CE_CONFIG) as f:
        raw = json.load(f)
    cfg = dataclasses.replace(from_json(ModelConfig, raw["model"]),
                              num_layers=layers)
    return cfg, from_json(TrainConfig, raw["train"])


def ptrain_moe_configs(layers: int) -> tuple:
    """(ModelConfig, TrainConfig) of mixtral_8x7b_train.json at `layers`
    layers with the fused CE kernels (ce_impl "pallas"), on the Llama
    cases' 4 rows (B7/B8 then take N 8192, as the limits were set at)."""
    import dataclasses
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    with open(MOE_TRAIN_CONFIG) as f:
        raw = json.load(f)
    cfg = dataclasses.replace(from_json(ModelConfig, raw["model"]),
                              num_layers=layers, ce_impl="pallas")
    return cfg, dataclasses.replace(from_json(TrainConfig, raw["train"]),
                                    batch_size=4)


def ptrain_family(kind: str) -> str:
    """The model a case's kind trains: "moe" or "llama"."""
    return "moe" if kind == "moe" else "llama"


def ptrain_ref_kind(kind: str) -> str:
    """The one-rank step a case is held against: a pipeline's is the
    dense model's (the same function)."""
    return "dense" if kind == "pipeline" else kind


def ptrain_batch(cfg, tcfg, seq_len: int):
    """The train phase's seeded batch (SyntheticLMDataset rows) at
    `seq_len`, on the card."""
    import dataclasses
    return plain_batch(cfg, dataclasses.replace(tcfg, seq_len=seq_len))


def ptrain_case_cfg(cfg, impl: str):
    """`cfg` with the case's attention; in float32 the "flash" cases run
    the plain attention ("xla": the kernels take bfloat16)."""
    import dataclasses
    if impl == "flash" and cfg.dtype == "float32":
        impl = "xla"
    return dataclasses.replace(cfg, attention_impl=impl)


def ptrain_module(kind: str, cfg, mesh=None) -> tuple:
    """(loss_fn_module, rules, loss_fn) of a case's kind; the pipeline's
    rules and pipelined loss only on a mesh (its one-rank step is the
    dense one)."""
    from cloud_server_tpu_torch.models import lora, moe, transformer
    from cloud_server_tpu_torch.parallel.pipeline import (
        make_pipelined_loss, pipeline_rules)
    if kind == "moe":
        return moe, None, None
    if kind == "lora":
        return (lora.make_lora_module(lora.LoRAConfig(**PTRAIN_LORA)), None,
                None)
    if kind == "pipeline" and mesh is not None:
        return (transformer, pipeline_rules(),
                make_pipelined_loss(cfg, mesh, PTRAIN_MICROBATCHES))
    return transformer, None, None


def ptrain_state(kind: str, cfg, tcfg, module, mesh=None, rules=None):
    """The seeded TrainState of a case (on a mesh the rank's shards): the
    weights drawn from SEED a leaf at a time; for "lora" the base and
    adapters drawn whole, B then redrawn non-zero (PTRAIN_LORA_B_STD,
    from SEED + 7), and each rank keeping its slices."""
    import torch
    from cloud_server_tpu_torch.training import train_step as ts
    if kind != "lora":
        return ts.init_train_state(cfg, tcfg, SEED, DEVICE, module,
                                   mesh=mesh, rules=rules)
    params = module.init_params(cfg, SEED, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    for name in sorted(params["lora"]["layers"]):
        params["lora"]["layers"][name]["b"].normal_(
            0.0, PTRAIN_LORA_B_STD, generator=gen)
    return ts.train_state_from_params(params, tcfg, cfg, module, mesh=mesh,
                                      rules=rules)


def ptrain_reference(kind: str, cfg, tcfg, batch, steps: int,
                     double_leaf: str | None = None) -> dict:
    """The one-rank train step of a case's kind on the seeded state: its
    losses and global gradient norms, the final trainable parameters and
    their first moments (in cfg.dtype, on the card), each leaf's update
    norm, and the step times (each step ends with a host read of its
    loss). `double_leaf`: that leaf's gradient doubled (the control of
    the checks)."""
    import torch
    from cloud_server_tpu_torch.training import train_step as ts
    from cloud_server_tpu_torch.training.optim import (flatten,
                                                       optimizer_for_module)
    module, _, _ = ptrain_module(kind, cfg)
    state = ptrain_state(kind, cfg, tcfg, module)
    opt = optimizer_for_module(tcfg, cfg, module)
    init = {k: v.detach().to(torch_dtype(cfg), copy=True)
            for k, v in flatten(opt.trainable(state.params))}
    if double_leaf is not None:
        dict(flatten(state.params))[double_leaf].register_hook(
            lambda g: g * 2)
    step = ts.make_train_step(cfg, tcfg, loss_fn_module=module)
    losses, gnorms, step_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
    params = dict(flatten(opt.trainable(state.params)))
    update = {k: float((v.detach().float() - init[k].float()).norm())
              for k, v in params.items()}
    del init
    # the kept parameters and moments go into one buffer of their own
    # (the run's cached blocks released first), so that releasing the
    # run's segments afterwards strands nothing beside them on the card
    mus = dict(flatten(state.opt_state.mu))
    gc.collect()
    torch.cuda.empty_cache()
    keep = torch.empty(sum(2 * v.numel() for v in params.values()),
                       dtype=torch_dtype(cfg), device=DEVICE)
    final, mu, at = {}, {}, 0
    for k, v in params.items():
        for dst, src in ((final, v), (mu, mus[k])):
            dst[k] = keep[at:at + src.numel()].view(src.shape)
            dst[k].copy_(src.detach())
            at += src.numel()
    del state, params, mus
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms, "params": final,
            "mu": mu, "update_norm": update, "step_s": step_s}


def ptrain_readings(ref: dict, got: list[dict]) -> dict:
    """The bf16 checks' readings of runs against the one-rank run
    `ref`: each of `got` (one dict a rank, or the control's one) holds
    its losses and gradient norms, and per leaf its squared differences
    to `ref`'s parameters and first moments with the number of ranks
    that hold each (`ptrain_compare`)."""
    def rel(key, norm):
        return max(math.sqrt(sum(r[key][k][0] / r[key][k][1] for r in got))
                   / max(norm(k), 1e-30) for k in ref["params"])
    return {
        "loss_rel_err": max(abs(a - b) / abs(b) for r in got
                            for a, b in zip(r["losses"], ref["losses"])),
        "grad_norm_rel_err": max(
            abs(a - b) / abs(b) for r in got
            for a, b in zip(r["grad_norms"], ref["grad_norms"])),
        "mu_worst_rel": rel("mu_diff",
                            lambda k: float(ref["mu"][k].float().norm())),
        "param_worst_rel_of_update": rel(
            "diff", lambda k: ref["update_norm"][k])}


def ptrain_failed(readings: dict) -> list[str]:
    """The bf16 checks that `readings` (`ptrain_readings`) fail."""
    limits = {"loss_rel_err": PTRAIN_LOSS_RTOL,
              "grad_norm_rel_err": PTRAIN_GNORM_RTOL,
              "mu_worst_rel": PTRAIN_MU_REL,
              "param_worst_rel_of_update": PTRAIN_PARAM_REL}
    return [f"{k} {readings[k]} > {v}" for k, v in limits.items()
            if readings[k] > v]


def ptrain_control(cfg, tcfg, batch, steps: int, ref: dict) -> dict:
    """The control: the one-rank run with PTRAIN_CONTROL_LEAF's
    gradient doubled, read by the bf16 checks against `ref`."""
    ctl = ptrain_reference("dense", cfg, tcfg, batch, steps,
                           double_leaf=PTRAIN_CONTROL_LEAF)

    def sq(tree, want):
        return {k: (float((tree[k].float() - w.float()).square().sum()), 1)
                for k, w in want.items()}

    got = {"losses": ctl["losses"], "grad_norms": ctl["grad_norms"],
           "diff": sq(ctl["params"], ref["params"]),
           "mu_diff": sq(ctl["mu"], ref["mu"])}
    del ctl
    return ptrain_readings(ref, [got])


def torch_dtype(cfg):
    from cloud_server_tpu_torch.models import transformer
    return transformer.torch_dtype(cfg.dtype)


def ptrain_compare(tree, cfg, mesh, ref: dict, rules=None,
                   module=None) -> dict:
    """Per leaf of `ref` in a params-shaped tree (the parameters, or a
    moment): this rank's squared difference to the one-rank run's over
    its shard, and the number of ranks that hold that shard (so the sums
    over ranks count each element once)."""
    from cloud_server_tpu_torch.parallel.mesh import axis_size
    from cloud_server_tpu_torch.parallel.sharding import shard_tensor
    from cloud_server_tpu_torch.training import train_step as ts
    from cloud_server_tpu_torch.training.optim import flatten
    splits = dict(flatten(ts.state_shardings(cfg, mesh, rules, module)))
    world = mesh.size()
    out = {}
    for k, v in flatten(tree):
        if k not in ref:
            continue
        want = shard_tensor(ref[k], splits[k], mesh).to(v.device)
        held = 1
        for _, axis in splits[k]:
            held *= axis_size(mesh, axis)
        diff = v.detach().to(want.dtype).float() - want.float()
        out[k] = (float(diff.square().sum()), world // held)
    return out


def ptrain_rank(rank: int, world: int, cases, cfgs, batches, refs,
                f32_refs, cards: int) -> dict:
    """One rank of the ptrain phase: per case the mesh, the sharded state
    from the seeded weights, the case's steps on its block of the batch,
    and its numbers (losses, launch counts, bytes, peak, step times); a
    first float32 step at a cut width beside each."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.config import MeshConfig
    from cloud_server_tpu_torch.data.loader import batch_layout
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import fused_ce as fc
    from cloud_server_tpu_torch.parallel import make_mesh
    from cloud_server_tpu_torch.training import train_step as ts
    from cloud_server_tpu_torch.training.optim import flatten
    torch.cuda.set_device(rank % cards)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def block(t, layout):
        i, n = layout["process_index"], layout["process_count"]
        j, m = layout["seq_shard"]
        b, s = t.shape[0] // n, t.shape[1] // m
        return t[i * b:(i + 1) * b, j * s:(j + 1) * s].to(
            torch.device("cuda", rank % cards)).contiguous()

    for name, axes, impl, seq, steps, kind in cases:
        t_case = time.perf_counter()
        mesh = make_mesh(MeshConfig(**axes), "cuda")
        layout = batch_layout(mesh)
        cfg, tcfg = cfgs[ptrain_family(kind)]
        tokens = batches[(ptrain_family(kind), seq)]
        ref = refs.get((ptrain_ref_kind(kind), ptrain_family(kind), seq,
                        steps))
        res = {}
        # the float32 cut width, one step at the peak learning rate
        c32 = ptrain_case_cfg(dataclasses.replace(cfg, **PTRAIN_F32), impl)
        t32 = dataclasses.replace(tcfg, warmup_steps=0)
        module, rules, loss_fn = ptrain_module(kind, c32, mesh)
        st = ptrain_state(kind, c32, t32, module, mesh, rules)
        _, m32 = ts.make_train_step(c32, t32, mesh=mesh, rules=rules,
                                    loss_fn=loss_fn,
                                    loss_fn_module=module)(
            st, {"tokens": block(tokens, layout) % c32.vocab_size})
        res["f32_loss"] = float(m32["loss"])
        res["f32_diff"] = ptrain_compare(st.params, c32, mesh,
                                         f32_refs[name]["params"], rules,
                                         module)
        res["f32_mu_diff"] = ptrain_compare(st.opt_state.mu, c32, mesh,
                                            f32_refs[name]["mu"], rules,
                                            module)
        del st
        res["f32_s"] = time.perf_counter() - t_case
        # full width
        c = ptrain_case_cfg(cfg, impl)
        module, rules, loss_fn = ptrain_module(kind, c, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free, total_b = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated() / 1e9
        print(f"ptrain rank {rank} {name}: {held:.2f} GB allocated here, "
              f"{free / 1e9:.2f} of {total_b / 1e9:.2f} GB free on the card",
              flush=True)
        # the seeded weights, each rank drawing a leaf at a time and
        # keeping its slice
        state = ptrain_state(kind, c, tcfg, module, mesh, rules)
        gc.collect()
        torch.cuda.empty_cache()
        res["weight_bytes"] = sum(v.numel() * v.element_size()
                                  for _, v in flatten(state.params))
        res["state_bytes"] = res["weight_bytes"] + sum(
            v.numel() * v.element_size()
            for t in (state.opt_state.mu, state.opt_state.nu)
            for _, v in flatten(t))
        step = ts.make_train_step(c, tcfg, mesh=mesh, rules=rules,
                                  loss_fn=loss_fn, loss_fn_module=module)
        batch = {"tokens": block(tokens, layout)}
        res["init_s"] = time.perf_counter() - t_case - res["f32_s"]
        fl.reset_counters()
        fc.reset_counters()
        losses, gnorms, step_s = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # a host read: the step's end
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        res.update(losses=losses, grad_norms=gnorms, step_s=step_s,
                   counts=fl.counters(), ce_counts=fc.counters(),
                   peak_bytes=torch.cuda.max_memory_allocated())
        if ref is not None:
            res.update(diff=ptrain_compare(state.params, c, mesh,
                                           ref["params"], rules, module),
                       mu_diff=ptrain_compare(state.opt_state.mu, c, mesh,
                                              ref["mu"], rules, module))
        if world >= 4:
            # one more step on every rank (their collectives pair up),
            # rank 0's under the profiler
            if rank == 0:
                res["profile"] = ptrain_profile(step, state, batch)
            else:
                step(state, batch)
                torch.cuda.synchronize()
        del state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
        res["case_s"] = time.perf_counter() - t_case
        out[name] = res
    # Release the parent's tensors here before returning: a rank exits
    # without running its objects' finalizers, and the parent frees a
    # tensor it shared (CUDA IPC) only once every process that received
    # it has released it.
    for shared in (batches, refs, f32_refs):
        shared.clear()
    return out


def ptrain_profile(step, state, batch) -> dict:
    """One more step under torch.profiler: the device time of the
    collectives (NCCL kernels) against the step's whole device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    total = comm = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        if "nccl" in e.key.lower():
            comm += us
    return {"device_ms": total / 1e3, "collective_ms": comm / 1e3,
            "collective_share": comm / total if total else None}


def phase_ptrain_kernel() -> dict:
    """The flash and fused-CE kernels against their plain versions and
    timed at this path's per-rank shapes (PTRAIN_FLASH_CASES,
    PTRAIN_CE_SHARDS)."""
    out = {"flash": phase_train_kernel(PTRAIN_FLASH_CASES)}
    for case, shape in PTRAIN_CE_SHARDS.items():
        out[case] = phase_ce_kernel(shape, case)
    return out


def phase_ptrain(nccl: bool = False) -> dict:
    """Parallel training (`make_train_step(mesh=)`, one process a rank,
    `parallel.spawn_ranks`) at Llama-3.1-8B's and Mixtral-8x7B's widths
    from the seeded weights and batch, against the one-rank step on the
    same state: on one card (the default) two ranks over gloo,
    PTRAIN_CASES in turn in one spawn (fsdp 2, tp 2, sp 2 with Ulysses
    and with the ring, the pipeline at pp 2, the experts over ep 2 and
    adapters at fsdp 2); with `nccl` (four cards) PTRAIN_NCCL_CASES over
    NCCL. Per case a first float32 step at a cut width against its
    one-rank step, the bf16 losses, gradient norms, first moments and
    parameters (with the control that these checks must catch), each
    rank's B3-B8 launches, weight and state bytes and peak, and the step
    times."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.parallel import spawn_ranks
    from cloud_server_tpu_torch.utils.metrics import (
        transformer_flops_per_token)
    t_phase = time.perf_counter()
    free, _ = torch.cuda.mem_get_info()
    print(f"ptrain: the parent holds {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB ({torch.cuda.memory_reserved() / 1e9:.2f} reserved), "
          f"{free / 1e9:.2f} GB free at the start", flush=True)
    # the ranks' allocators grow their segments in place rather than
    # stranding freed blocks between cases (the card holds the parent's
    # one-rank runs beside two ranks' states)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = torch.cuda.device_count()
    if nccl:
        cases, world, backend = PTRAIN_NCCL_CASES, 4, "nccl"
        layers, moe_layers = PTRAIN_LAYERS_NCCL, PTRAIN_MOE_LAYERS_NCCL
        if cards < world:
            raise RuntimeError(f"--ptrain-only over NCCL needs {world} "
                               f"cards, found {cards}")
    else:
        cases, world, backend = PTRAIN_CASES, 2, "gloo"
        layers, moe_layers = PTRAIN_LAYERS_ONE_CARD, PTRAIN_MOE_LAYERS
    cfgs = {"llama": ptrain_configs(layers),
            "moe": ptrain_moe_configs(moe_layers)}
    batches = {}
    for _, _, _, seq, _, kind in cases:
        fam = ptrain_family(kind)
        if (fam, seq) not in batches:
            batches[(fam, seq)] = ptrain_batch(*cfgs[fam], seq)["tokens"]
    t0 = time.perf_counter()
    f32_refs = {}
    for name, _, impl, s, _, kind in cases:
        cfg, tcfg = cfgs[ptrain_family(kind)]
        c32 = ptrain_case_cfg(dataclasses.replace(cfg, **PTRAIN_F32), impl)
        f32_refs[name] = ptrain_reference(
            ptrain_ref_kind(kind), c32,
            dataclasses.replace(tcfg, warmup_steps=0),
            {"tokens": batches[(ptrain_family(kind), s)] % c32.vocab_size},
            1)
    ref_s = time.perf_counter() - t0
    # the one-rank runs of every case, kept on the card for the ranks to
    # read (each in a buffer of its own), then one spawn for every case
    t0 = time.perf_counter()
    refs = {}
    for _, _, impl, seq, steps, kind in cases:
        fam = ptrain_family(kind)
        key = (ptrain_ref_kind(kind), fam, seq, steps)
        # the 4-card Mixtral state does not fit one card: no one-rank run
        if key in refs or (nccl and kind == "moe"):
            continue
        cfg, tcfg = cfgs[fam]
        refs[key] = ptrain_reference(
            key[0], ptrain_case_cfg(cfg, impl),
            dataclasses.replace(tcfg, seq_len=seq),
            {"tokens": batches[(fam, seq)]}, steps)
    control = None
    dense = [c for c in cases if c[5] == "dense"]
    if dense:
        _, _, ctl_impl, s_ctl, ctl_steps, _ = max(
            dense, key=lambda c: (c[4], c[3]))
        cfg, tcfg = cfgs["llama"]
        control = ptrain_control(
            ptrain_case_cfg(cfg, ctl_impl),
            dataclasses.replace(tcfg, seq_len=s_ctl),
            {"tokens": batches[("llama", s_ctl)]}, ctl_steps,
            refs[("dense", "llama", s_ctl, ctl_steps)])
        if not ptrain_failed(control):
            raise RuntimeError(
                f"ptrain: the control ({PTRAIN_CONTROL_LEAF}'s gradient "
                f"doubled) passes every check: {control}")
    gc.collect()
    torch.cuda.empty_cache()
    ref_s += time.perf_counter() - t0
    free, _ = torch.cuda.mem_get_info()
    print(f"ptrain: the parent holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved), "
          f"{free / 1e9:.2f} GB free before the ranks", flush=True)
    t0 = time.perf_counter()
    ranks = spawn_ranks(ptrain_rank, world, backend, cases, cfgs, batches,
                        refs, f32_refs, cards, deadline_s=PTRAIN_DEADLINE_S,
                        timeout_s=PTRAIN_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    case_readings, ref_info = {}, {}
    for name, _, _, seq, steps, kind in cases:
        ref = refs.get((ptrain_ref_kind(kind), ptrain_family(kind), seq,
                        steps))
        if ref is not None:
            case_readings[name] = ptrain_readings(ref,
                                                  [r[name] for r in ranks])
            ref_info[name] = {k: ref[k] for k in
                              ("losses", "grad_norms", "step_s")}
    del refs, ref
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    print(f"ptrain: the parent holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved) after the "
          "ranks", flush=True)
    failures = []
    out_cases = {}
    total = {"flash": {}, "fused_ce": {}}
    for name, axes, impl, s, steps, kind in cases:
        cfg, tcfg = cfgs[ptrain_family(kind)]
        ref = ref_info.get(name)
        r32 = f32_refs[name]
        per_rank = [r[name] for r in ranks]
        f32_loss_err = max(abs(r["f32_loss"] - r32["losses"][0])
                           / abs(r32["losses"][0]) for r in per_rank)
        f32_rel = max(
            math.sqrt(sum(r["f32_mu_diff"][k][0] / r["f32_mu_diff"][k][1]
                          for r in per_rank))
            / max(float(r32["mu"][k].norm()), 1e-30) for k in r32["mu"])
        f32_param_rel = max(
            math.sqrt(sum(r["f32_diff"][k][0] / r["f32_diff"][k][1]
                          for r in per_rank))
            / max(r32["update_norm"][k], 1e-30) for k in r32["params"])
        readings = case_readings.get(name, {})
        for r, res in enumerate(per_rank):
            c, ce = res["counts"], res["ce_counts"]
            for key, n in c.items():
                total["flash"][key] = total["flash"].get(key, 0) + n
            for key, n in ce.items():
                total["fused_ce"][key] = total["fused_ce"].get(key, 0) + n
            flash_ok = (impl == "ring" or (
                c["launches_fwd"] > 0 and c["plain_calls"] == 0 and (
                    c["launches_bwd_fused"] > 0 if s <= 1024 else
                    c["launches_bwd_dkdv"] > 0 and c["launches_bwd_dq"] > 0)))
            if not flash_ok or ce["launches_fwd"] <= 0 or (
                    ce["launches_dx"] <= 0 or ce["plain_calls"]):
                failures.append(f"{name} rank {r}: launches {c}, {ce}")
            if not all(math.isfinite(x) for x in res["losses"]):
                failures.append(f"{name} rank {r}: losses {res['losses']}")
        if (f32_loss_err > PTRAIN_F32_RTOL or f32_rel > PTRAIN_F32_REL
                or f32_param_rel > PTRAIN_F32_PARAM_REL):
            failures.append(f"{name}: float32 first step loss rel err "
                            f"{f32_loss_err}, worst moment {f32_rel}, "
                            f"worst leaf {f32_param_rel} of its update")
        if ref is not None and ptrain_failed(readings):
            failures.append(f"{name}: bf16 " + ", ".join(
                ptrain_failed(readings)))
        tokens = tcfg.batch_size * s
        steady = [min(r["step_s"][1:]) for r in per_rank]
        flops = transformer_flops_per_token(cfg, s)
        step_s = max(steady)
        out_cases[name] = {
            "mesh": axes, "kind": kind, "attention_impl": impl,
            "seq_len": s, "steps": steps,
            "layers": cfg.num_layers, "batch": tcfg.batch_size,
            "losses": per_rank[0]["losses"],
            "ref_losses": None if ref is None else ref["losses"],
            "grad_norms": per_rank[0]["grad_norms"],
            "ref_grad_norms": None if ref is None else ref["grad_norms"],
            **readings,
            "f32_loss_rel_err": f32_loss_err,
            "f32_worst_moment_rel": f32_rel,
            "f32_param_worst_rel_of_update": f32_param_rel,
            "steady_step_s": step_s,
            "one_rank_step_s": (None if ref is None
                                else min(ref["step_s"][1:])),
            "tokens_per_s": tokens / step_s,
            "mfu": tokens / step_s * flops / (BF16_FLOP_PER_S
                                              * (world if nccl else 1)),
            "ranks": [{"rank": r, "counts": x["counts"],
                       "ce_counts": x["ce_counts"],
                       "weight_bytes": x["weight_bytes"],
                       "state_bytes": x["state_bytes"],
                       "peak_gb": x["peak_bytes"] / 1e9,
                       "step_s": x["step_s"], "case_s": x["case_s"],
                       "f32_s": x["f32_s"], "init_s": x["init_s"]}
                      for r, x in enumerate(per_rank)]}
        if "profile" in per_rank[0]:
            out_cases[name]["profile_rank0"] = per_rank[0]["profile"]
    out = {"phase": "ptrain", "backend": backend, "world": world,
           "cards": cards, "layers": layers, "moe_layers": moe_layers,
           "model": "Llama-3.1-8B and Mixtral-8x7B widths (random f32 "
                    "master weights, bf16 compute, fused CE)",
           "cases": out_cases, "control": control,
           "control_leaf": PTRAIN_CONTROL_LEAF,
           "counts": total, "reference_s": ref_s,
           "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase}
    emit(out)
    del f32_refs, batches
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("ptrain: " + "; ".join(failures))
    if not nccl and out["seconds"] > PTRAIN_BUDGET_S:
        print(f"ptrain phase: {out['seconds']:.1f} s, over its "
              f"{PTRAIN_BUDGET_S} s budget", flush=True)
    return out


# The reference's `dryrun_multichip` on the port (`graft_entry.py`): its
# eight families, one step each on a tiny model, over DRYRUN_RANKS ranks
# (on one card both over gloo; with four cards or more over NCCL, one a
# card). The one-card form must take at most DRYRUN_BUDGET_S.
DRYRUN_RANKS = 2
DRYRUN_BUDGET_S = 30.0
DRYRUN_FAMILIES = ("dense", "ring-sp", "ulysses-sp", "moe-ep", "hybrid-dcn",
                   "pipeline-pp", "paged-serving-tp", "replicated-serving-dp")


def phase_dryrun(n: int = DRYRUN_RANKS) -> dict:
    """`graft_entry.dryrun_multichip(n)`: every family must run; on
    fewer cards than n the ranks share them over gloo. The paged kernels'
    launches of family 6 on each rank."""
    import torch
    from cloud_server_tpu_torch.graft_entry import dryrun_multichip
    t0 = time.perf_counter()
    share = torch.cuda.device_count() < n
    res = dryrun_multichip(n, share_card=share, deadline_s=300.0)
    seconds = time.perf_counter() - t0
    out = {"phase": "dryrun", "ranks": n, "shared_card": share,
           "backend": "gloo" if share else "nccl", "ran": res["ran"],
           "skipped": res["skipped"], "lines": res["lines"],
           "paged_counts": res["paged_counts"], "seconds": seconds}
    emit(out)
    missing = [f for f in DRYRUN_FAMILIES if f not in res["ran"]]
    if missing:
        raise RuntimeError(f"dryrun_multichip({n}) skipped {missing}")
    for r, c in enumerate(res["paged_counts"]):
        if c.get("launches_narrow", 0) <= 0 or c.get("plain_calls", 0):
            raise RuntimeError(f"dryrun rank {r}: family 6's paged "
                               f"kernels did not run: {c}")
    if share and seconds > DRYRUN_BUDGET_S:
        print(f"dryrun phase: {seconds:.1f} s, over its {DRYRUN_BUDGET_S} "
              "s budget", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4b: packed rows, the remat policies, evaluation and the native
# reader, at Llama-3.1-8B's widths (8 layers)
# ---------------------------------------------------------------------------

PACK_DIR = "cloud_server_tpu_torch/_build/smoke_pack"
PACK_DOC_LENS = (64, 2048)    # seeded document lengths, tokens (inclusive)
PACK_ROUNDS = 2               # rounds of packed/unpacked steps, in turns
# The f32 slice: documents of one 2048-token row, the packed loss and
# every gradient leaf against the same documents run one by one. Each
# document's math is the same; only the sums' order differs (other GEMM
# shapes), so the f32 rounding bounds the difference.
PACK_SLICE_DOCS = (300, 700, 1048)
PACK_SLICE_REL = 1e-5
REMAT_POLICIES = ("full", "dots", "attn")
REMAT_STEPS = 3               # from one seed and batch, each policy
REMAT_ROUNDS = 2              # then timed in turns: ABC CBA, twice
# Losses of the same steps across the policies, bf16 compute: the forward
# is one program under every policy, and the backward recomputes or reads
# the same values, so only the f32 atomics of the embedding's gradient
# can move the second and third steps' losses.
REMAT_LOSS_ATOL = 1e-3
EVAL_BATCHES = 2              # perplexity windows: 2 batches of 4 x 2048
EVAL_CONTEXTS = (100, 300, 1000, 2000)   # loglikelihood pairs, bytes
EVAL_CONT = 24
# loglikelihoods against each pair's own forward (bf16: other GEMM shapes
# round other bits): the mean absolute difference a token, in nats
EVAL_LL_ATOL = 0.05
EVAL_PPL_REL = 1e-4
NATIVE_WINDOWS = 4096         # the reader's file: 4096 windows of 2048
NATIVE_BATCH = 32


def counted(fn):
    """fn()'s result and the flash and fused-CE launches it made."""
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import fused_ce as fc
    f0, c0 = fl.counters(), fc.counters()
    out = fn()
    f1, c1 = fl.counters(), fc.counters()
    return out, ({k: f1[k] - f0[k] for k in f0},
                 {k: c1[k] - c0[k] for k in c0})


def _add_counts(total: dict, delta: dict) -> None:
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def packed_batch(cfg, tcfg, seed: int) -> tuple:
    """B rows of S packed from seeded documents of PACK_DOC_LENS tokens
    (random ids); (batch on the card, packing efficiency, documents)."""
    import numpy as np
    import torch
    from cloud_server_tpu_torch.data.packing import (pack_documents,
                                                     packing_efficiency)
    rng = np.random.default_rng(seed)
    lo, hi = PACK_DOC_LENS
    docs = []
    while sum(map(len, docs)) < 2 * tcfg.batch_size * tcfg.seq_len:
        docs.append(rng.integers(1, cfg.vocab_size,
                                 int(rng.integers(lo, hi + 1))).tolist())
    toks, segs = pack_documents(docs, tcfg.seq_len)
    toks, segs = toks[:tcfg.batch_size], segs[:tcfg.batch_size]
    n_docs = int(sum(len(set(r[r > 0].tolist())) for r in segs))
    batch = {"tokens": torch.from_numpy(toks).long().to(DEVICE),
             "segment_ids": torch.from_numpy(segs).long().to(DEVICE)}
    return batch, packing_efficiency(segs), n_docs


def pack_train_part(config: str, tag: str, total: dict,
                    ce_total: dict) -> tuple:
    """A few training steps on packed rows against unpacked steps of the
    same state, in turns: launches a packed step, step times, peak
    memory, one profiled step of each. Returns (summary, the final
    state, its model and train configs)."""
    import torch
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    from cloud_server_tpu_torch.training.train_step import (
        init_train_state, make_train_step)
    with open(config) as f:
        raw = json.load(f)
    cfg = from_json(ModelConfig, raw["model"])
    tcfg = from_json(TrainConfig, raw["train"])
    state = init_train_state(cfg, tcfg, SEED, device=DEVICE)
    step_fn = make_train_step(cfg, tcfg)
    packed, eff, n_docs = packed_batch(cfg, tcfg, SEED + 11)
    batches = {"packed": packed, "plain": plain_batch(cfg, tcfg)}
    box = [state]
    times: dict = {"packed": [], "plain": []}
    peaks: dict = {"packed": 0, "plain": 0}
    losses: dict = {"packed": [], "plain": []}
    per_step = None

    def one(kind):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (box[0], m), (fd, cd) = counted(
            lambda: step_fn(box[0], batches[kind]))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss, fd, cd

    order = ["packed", "plain"] + ["packed", "plain", "plain",
                                   "packed"] * PACK_ROUNDS
    for i, kind in enumerate(order):
        dt, loss, fd, cd = one(kind)
        losses[kind].append(loss)
        peaks[kind] = max(peaks[kind], torch.cuda.max_memory_allocated())
        if kind == "packed":
            _add_counts(total, fd)
            _add_counts(ce_total, cd)
            per_step = per_step or (fd, cd)
        if i >= 2:  # the first of each kind warms up
            times[kind].append(dt)
    first = losses["packed"][0]
    if not all(math.isfinite(x) for v in losses.values() for x in v) \
            or abs(first - math.log(cfg.vocab_size)) > LOSS_TOL:
        raise RuntimeError(f"pack {tag}: losses {losses}")
    L = cfg.num_layers
    fused_ce = cfg.ce_impl == "pallas"
    want = ({"launches_fwd": 2 * L, "launches_bwd_dkdv": L,
             "launches_bwd_dq": L, "launches_bwd_fused": 0,
             "plain_calls": 0},
            {"launches_fwd": int(fused_ce), "launches_dx": int(fused_ce),
             "plain_calls": 0})
    if per_step != want:
        raise RuntimeError(f"pack {tag}: a packed step launched "
                           f"{per_step}, expected {want}")
    profs = {}
    for kind in ("packed", "plain"):
        def step(kind=kind):
            box[0], _ = step_fn(box[0], batches[kind])
        (profs[kind], (fd, cd)) = counted(lambda: profile_step(step))
        if kind == "packed":
            _add_counts(total, fd)
            _add_counts(ce_total, cd)
    tokens = tcfg.batch_size * tcfg.seq_len
    out = {"config": config, "batch": tcfg.batch_size,
           "seq_len": tcfg.seq_len, "documents": n_docs,
           "packing_efficiency": eff,
           "launches_per_packed_step": {"flash": per_step[0],
                                        "fused_ce": per_step[1]},
           "losses": losses}
    for kind in ("packed", "plain"):
        mean_s = sum(times[kind]) / len(times[kind])
        p = profs[kind]
        out[kind] = {"step_s": mean_s, "step_s_each": times[kind],
                     "tokens_per_s": tokens / mean_s,
                     "real_tokens_per_s": (tokens * eff if kind == "packed"
                                           else tokens) / mean_s,
                     "peak_mem_gb": peaks[kind] / 1e9,
                     "profile_wall_ms": p["wall_ms"],
                     "device_busy_ms": p["device_busy_ms"],
                     "device_busy_share": 1 - p["device_idle_share"],
                     "device_ms_by_group": p["device_ms_by_group"]}
    out["packed_over_plain"] = out["packed"]["step_s"] / out["plain"][
        "step_s"]
    return out, box[0], cfg, tcfg


def pack_slice(cfg) -> dict:
    """(c): a 2-layer float32 slice at full width, plain attention: the
    loss and gradients of one packed row against the token-weighted
    losses of its documents run one by one."""
    import dataclasses
    import numpy as np
    import torch
    from cloud_server_tpu_torch.data.packing import pack_documents
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.training.optim import flatten
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                attention_impl="xla", remat="none")
    params = transformer.init_params(cfg32, SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 12)
    docs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in PACK_SLICE_DOCS]
    toks, segs = pack_documents(docs, sum(PACK_SLICE_DOCS))

    def leaves():
        return {g: {n: t.detach().clone().requires_grad_(True)
                    for n, t in lv.items()} for g, lv in params.items()}

    packed = leaves()
    loss_p, _ = transformer.next_token_loss(
        packed, {"tokens": torch.from_numpy(toks).to(DEVICE),
                 "segment_ids": torch.from_numpy(segs).to(DEVICE)}, cfg32)
    loss_p.backward()
    alone = leaves()
    n_targets = sum(n - 1 for n in PACK_SLICE_DOCS)
    loss_a = 0.0
    for doc in docs:
        lo, _ = transformer.next_token_loss(
            alone, {"tokens": torch.tensor([doc], device=DEVICE)}, cfg32)
        (lo * ((len(doc) - 1) / n_targets)).backward()
        loss_a += float(lo.detach()) * (len(doc) - 1) / n_targets
    gp = dict(flatten({g: {n: t.grad for n, t in lv.items()}
                       for g, lv in packed.items()}))
    ga = dict(flatten({g: {n: t.grad for n, t in lv.items()}
                       for g, lv in alone.items()}))
    worst = _worst_rel(gp, ga)
    worst_leaf = max(ga, key=lambda k: _worst_rel({k: gp[k]}, {k: ga[k]}))
    lp = float(loss_p.detach())
    res = {"layers": 2, "dtype": "float32", "documents": list(
        PACK_SLICE_DOCS), "loss_packed": lp, "loss_standalone": loss_a,
        "loss_rel_err": abs(lp - loss_a) / abs(loss_a),
        "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
        "limit": PACK_SLICE_REL}
    if res["loss_rel_err"] > PACK_SLICE_REL or worst > PACK_SLICE_REL:
        raise RuntimeError(f"pack slice: the packed row differs from its "
                           f"documents run alone: {res}")
    return res


def pack_remat(cfg, tcfg, total: dict) -> dict:
    """(d): each remat policy from one seed on one unpacked batch: its
    peak memory, B3 launches a step and the losses of REMAT_STEPS steps;
    then the three policies' step times in turns on the last state (a
    policy decides what the backward recomputes, not the state)."""
    import dataclasses
    import statistics
    import torch
    from cloud_server_tpu_torch.training.train_step import (
        init_train_state, make_train_step)
    out: dict = {}
    step_fns = {}
    batch = plain_batch(cfg, tcfg)
    for policy in REMAT_POLICIES:
        pcfg = dataclasses.replace(cfg, remat=policy)
        state = init_train_state(pcfg, tcfg, SEED, device=DEVICE)
        step_fns[policy] = make_train_step(pcfg, tcfg)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, counts = [], {}
        for _ in range(REMAT_STEPS):
            (state, m), (fd, _) = counted(
                lambda: step_fns[policy](state, batch))
            losses.append(float(m["loss"]))
            _add_counts(counts, fd)
        _add_counts(total, counts)
        out[policy] = {
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_over_state_gb": (torch.cuda.max_memory_allocated()
                                   - base) / 1e9,
            "b3_per_step": counts["launches_fwd"] / REMAT_STEPS,
            "b4_per_step": counts["launches_bwd_dkdv"] / REMAT_STEPS,
            "losses": losses}
        if policy != REMAT_POLICIES[-1]:
            del state
            gc.collect()
            torch.cuda.empty_cache()
    times: dict = {p: [] for p in REMAT_POLICIES}
    for policy in (list(REMAT_POLICIES)
                   + list(reversed(REMAT_POLICIES))) * REMAT_ROUNDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), (fd, _) = counted(
            lambda: step_fns[policy](state, batch))
        float(m["loss"])
        torch.cuda.synchronize()
        times[policy].append(time.perf_counter() - t0)
        _add_counts(total, fd)
    del state
    for policy in REMAT_POLICIES:
        out[policy].update(step_s=statistics.median(times[policy]),
                           step_s_each=times[policy])
    L = cfg.num_layers
    want_b3 = {"full": 2 * L, "dots": L, "attn": L}
    ref = out["full"]["losses"]
    worst = max(abs(a - b) for p in REMAT_POLICIES
                for a, b in zip(out[p]["losses"], ref))
    out["loss_max_abs_diff"] = worst
    out["loss_limit"] = REMAT_LOSS_ATOL
    bad = [p for p in REMAT_POLICIES if out[p]["b3_per_step"] != want_b3[p]]
    if bad or worst > REMAT_LOSS_ATOL:
        raise RuntimeError(f"remat policies: B3 a step {want_b3} expected; "
                           f"losses within {REMAT_LOSS_ATOL}: {out}")
    return out


def pack_eval(params, cfg, total: dict) -> dict:
    """(e): `evaluate.perplexity` over a token file that
    `prepare_corpus` made from the port's own sources (byte tokenizer),
    against the mean NLL of the same windows from the plain forward;
    `loglikelihoods` on a few (context, continuation) pairs of that text
    against each pair's own forward."""
    import glob
    import numpy as np
    import torch
    from cloud_server_tpu_torch import evaluate
    from cloud_server_tpu_torch.data.dataset import MemmapTokenDataset
    from cloud_server_tpu_torch.data.tokenizer import (ByteTokenizer,
                                                       prepare_corpus)
    from cloud_server_tpu_torch.models import transformer
    os.makedirs(PACK_DIR, exist_ok=True)
    text_path = os.path.join(PACK_DIR, "corpus.txt")
    with open(text_path, "w", encoding="utf-8") as out_f:
        for path in sorted(glob.glob("cloud_server_tpu_torch/**/*.py",
                                     recursive=True)):
            with open(path, encoding="utf-8") as f:
                out_f.write(f.read())
    tok = ByteTokenizer()
    bin_path = os.path.join(PACK_DIR, "corpus.bin")
    n_tokens = prepare_corpus(text_path, bin_path, tok)
    bs, s = 4, 2048
    t0 = time.perf_counter()
    ppl, (fd, _) = counted(lambda: evaluate.perplexity(
        params, cfg, bin_path, batch_size=bs, seq_len=s,
        max_batches=EVAL_BATCHES))
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    _add_counts(total, fd)
    ds = MemmapTokenDataset(bin_path, s)
    nll = 0.0
    with torch.no_grad():
        for bi in range(EVAL_BATCHES):
            rows = torch.from_numpy(np.stack(
                [ds[bi * bs + i]["tokens"] for i in range(bs)]).astype(
                np.int64)).to(DEVICE)
            (logits, (fd, _)) = counted(
                lambda: transformer.forward(params, rows, cfg))
            _add_counts(total, fd)
            lp = torch.log_softmax(logits[:, :-1], -1)
            nll -= float(torch.gather(lp, -1, rows[:, 1:, None]).sum())
            del logits, lp
    direct = nll / ppl["tokens"]
    text = open(text_path, encoding="utf-8").read()
    ids = tok.encode(text)
    pairs = [(ids[:n], ids[n:n + EVAL_CONT]) for n in EVAL_CONTEXTS]
    t0 = time.perf_counter()
    scores, (fd, _) = counted(lambda: evaluate.loglikelihoods(
        params, cfg, pairs, batch_size=4))
    ll_s = time.perf_counter() - t0
    _add_counts(total, fd)
    diffs = []
    with torch.no_grad():
        for (ctx, cont), sc in zip(pairs, scores):
            toks = torch.tensor([ctx + cont], device=DEVICE)
            (logits, (fd, _)) = counted(
                lambda: transformer.forward(params, toks, cfg))
            _add_counts(total, fd)
            lp = torch.log_softmax(logits[0, :-1], -1)
            tgt = toks[0, 1:]
            tok_lp = lp[torch.arange(len(tgt), device=DEVICE), tgt]
            want = float(tok_lp[len(ctx) - 1:].sum())
            diffs.append(abs(sc["sum_logprob"] - want) / len(cont))
    res = {"corpus_tokens": n_tokens, "perplexity": ppl,
           "perplexity_s": ppl_s, "direct_loss": direct,
           "loss_rel_err": abs(ppl["loss"] - direct) / direct,
           "loss_rel_limit": EVAL_PPL_REL,
           "loglikelihoods": scores, "loglikelihood_s": ll_s,
           "loglikelihood_mean_abs_diff_per_token": diffs,
           "loglikelihood_limit": EVAL_LL_ATOL}
    if (not math.isfinite(ppl["loss"])
            or ppl["tokens"] != EVAL_BATCHES * bs * (s - 1)
            or res["loss_rel_err"] > EVAL_PPL_REL
            or max(diffs) > EVAL_LL_ATOL
            or abs(ppl["ppl"] - math.exp(ppl["loss"])) > 1e-6 * ppl["ppl"]):
        raise RuntimeError(f"evaluation: {res}")
    return res


def pack_native_reader() -> dict:
    """(f): the native gathered reader's batches against the numpy
    path's, bit for bit, and rows/s of each over the same shuffled
    index stream (in turns; the file is in the page cache: warm reads)."""
    import numpy as np
    from cloud_server_tpu_torch.data.dataset import (MemmapTokenDataset,
                                                     write_token_file)
    from cloud_server_tpu_torch.data.loader import ShardedSampler, _collate
    from cloud_server_tpu_torch.runtime import native
    if native.load_library() is None:
        raise RuntimeError("the native reader did not build (g++)")
    s = 2048
    path = os.path.join(PACK_DIR, "native.bin")
    write_token_file(path, np.random.default_rng(SEED + 13).integers(
        0, 65535, NATIVE_WINDOWS * s, dtype=np.uint16), dtype=np.uint16)
    nat = native.NativeTokenDataset(path, s)
    ref = MemmapTokenDataset(path, s)
    sampler = ShardedSampler(len(ref), NATIVE_BATCH, seed=SEED)
    it = iter(sampler)
    stream = [next(it) for _ in range(len(ref) // NATIVE_BATCH)]
    for idx in stream:
        a, b = _collate(nat, idx), _collate(ref, idx)
        if not np.array_equal(a["tokens"], b["tokens"]):
            raise RuntimeError(f"native reader: batch {idx[:4]}... differs "
                               "from the numpy path's")
    secs: dict = {"native": [], "numpy": []}
    for kind in ("numpy", "native", "native", "numpy"):
        ds = nat if kind == "native" else ref
        t0 = time.perf_counter()
        for idx in stream:
            _collate(ds, idx)
        secs[kind].append(time.perf_counter() - t0)
    rows = len(stream) * NATIVE_BATCH
    nat.close()
    return {"windows": len(ref), "seq_len": s, "batch": NATIVE_BATCH,
            "batches_bit_equal": len(stream), "reads": "warm (page cache)",
            **{f"{k}_rows_per_s": rows / (sum(v) / len(v))
               for k, v in secs.items()},
            "seconds": secs}


def phase_pack(train: dict) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total: dict = {}
    ce_total: dict = {}
    seconds: dict = {}
    t0 = time.perf_counter()
    dense, state, cfg, tcfg = pack_train_part(TRAIN_CONFIG, "dense", total,
                                              ce_total)
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = pack_eval(state.params, cfg, total)
    seconds["e"] = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fused, state, _, _ = pack_train_part(FUSED_CE_CONFIG, "fused_ce", total,
                                         ce_total)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sl = pack_slice(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat = pack_remat(cfg, tcfg, total)
    seconds["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader = pack_native_reader()
    seconds["f"] = time.perf_counter() - t0
    unpacked = train["run_s2048"]
    out = {"phase": "pack", "model": "Llama-3.1-8B widths, 8 layers "
           "(random f32 master weights, bf16 compute, flash)",
           "packed_dense": dense, "packed_fused_ce": fused,
           "train_phase_unpacked": {
               "step_s": unpacked["step_time_s_steady"],
               "peak_mem_gb": unpacked["peak_mem_gb"],
               "device_busy_share": 1 - unpacked["profile_step"][
                   "device_idle_share"]},
           "slice": sl, "remat": remat, "eval": ev, "native_reader": reader,
           "counts": total, "ce_counts": ce_total, "seconds": seconds}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 5: checkpoint, resume and serving the checkpoint (1 layer)
# ---------------------------------------------------------------------------

CKPT_DIR = "cloud_server_tpu_torch/_build/smoke_ckpt"
CKPT_STEPS = 4
# The resumed run's losses at steps 3-4 against the straight run's:
# restored state is bit-exact, but the embedding backward's atomics may
# make the card's steps non-bitwise, so the losses agree within this
# absolute difference (measured equal, PERF.md; the limit is about
# a hundred f32 ulps of a loss of 12).
CKPT_LOSS_ATOL = 1e-4
CKPT_PROMPTS = ["The checkpoint", "serves"]
CKPT_GEN = ["--max-new", "8", "--temperature", "0", "--max-len", "256",
            "--page-size", "128", "--prefill-chunk", "128", "--max-slots",
            "8", "--seed", "0"]


def serve_greedy(params, cfg) -> list:
    """The tokens `generate.main` with CKPT_GEN serves for CKPT_PROMPTS:
    the same server, built as the CLI builds it."""
    from cloud_server_tpu_torch.config import InferConfig
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    tok = ByteTokenizer()
    icfg = InferConfig(max_decode_len=8, temperature=0.0,
                       eos_token_id=tok.eos_id, pad_token_id=tok.pad_id)
    srv = PagedInferenceServer(
        params, cfg, icfg, max_slots=len(CKPT_PROMPTS), max_context=256,
        page_size=128, decode_chunk=1, prefill_chunk=128, seed=0,
        device=DEVICE)
    return srv.generate([tok.encode(p) for p in CKPT_PROMPTS],
                        max_new_tokens=8)


def _states_equal(a, b) -> bool:
    import torch
    from cloud_server_tpu_torch.training.checkpoint import _items
    ia, ma = _items(a)
    ib, mb = _items(b)
    return ma == mb and all(
        sorted(ia[k]) == sorted(ib[k]) and all(
            torch.equal(ia[k][p].detach(), ib[k][p].detach())
            for p in ia[k]) for k in ia)


def phase_ckpt() -> dict:
    import contextlib
    import dataclasses
    import io
    import shutil
    import torch
    from cloud_server_tpu_torch import generate
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.models.transformer import param_shapes
    from cloud_server_tpu_torch.training.checkpoint import (
        Checkpointer, abstract_train_state)
    from cloud_server_tpu_torch.training.loop import LoopConfig, train_loop
    from cloud_server_tpu_torch.utils.logging import read_jsonl
    from cloud_server_tpu_torch.utils.metrics import param_count
    with open(FUSED_CE_CONFIG) as f:
        raw = json.load(f)
    cfg = dataclasses.replace(from_json(ModelConfig, raw["model"]),
                              num_layers=1)
    tcfg = dataclasses.replace(from_json(TrainConfig, raw["train"]),
                               total_steps=CKPT_STEPS)
    ds = SyntheticLMDataset(64, tcfg.seq_len, cfg.vocab_size, seed=SEED)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ckpt_dir = os.path.join(CKPT_DIR, "run")
    # params, mu and nu in f32: 12 bytes a parameter per save, and at most
    # two saves on disk at once (step 4 beside step 2 until retention
    # removes it), with a margin
    save_bytes = 12 * sum(math.prod(s) for leaves in
                          param_shapes(cfg).values() for s in leaves.values())
    free = shutil.disk_usage(os.path.dirname(CKPT_DIR)).free
    if free < 2.5 * save_bytes:
        raise RuntimeError(f"{free / 1e9:.1f} GB free on disk; the ckpt "
                           f"phase needs {2.5 * save_bytes / 1e9:.1f} GB")

    def losses(tag):
        recs = read_jsonl(os.path.join(CKPT_DIR, tag, "train.jsonl"))
        return {r["step"]: r["loss"] for r in recs if "loss" in r}

    def loop_cfg(tag, **kw):
        return LoopConfig(log_interval=1, logdir=os.path.join(CKPT_DIR, tag),
                          **kw)

    ck = dict(checkpoint_dir=ckpt_dir, checkpoint_interval=2,
              max_checkpoints=1, async_checkpoint=True)
    straight = train_loop(cfg, tcfg, ds, loop_cfg=loop_cfg("straight"),
                          device=DEVICE)
    n_params = param_count(straight.params)
    del straight
    gc.collect()
    torch.cuda.empty_cache()
    first = train_loop(cfg, tcfg, ds, loop_cfg=loop_cfg("first", **ck),
                       max_steps=2, device=DEVICE)
    step_dir = os.path.join(ckpt_dir, "2")
    nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                 for f in os.listdir(step_dir))
    # the async save's own write of its item files (meta.json's write_s)
    with open(os.path.join(step_dir, "meta.json")) as f:
        write_s = json.load(f)["write_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = Checkpointer(ckpt_dir).restore(
        abstract_train_state(cfg, tcfg), device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if not _states_equal(first, restored):
        raise RuntimeError("the restored state differs from the saved one")
    del restored, first
    gc.collect()
    torch.cuda.empty_cache()
    resumed = train_loop(cfg, tcfg, ds, loop_cfg=loop_cfg("resumed", **ck),
                         device=DEVICE)
    want, got = losses("straight"), losses("resumed")
    if sorted(got) != [3, 4] or resumed.step != CKPT_STEPS:
        raise RuntimeError(f"resume: steps {sorted(got)}")
    loss_err = max(abs(got[s] - want[s]) for s in got)
    if not loss_err <= CKPT_LOSS_ATOL:
        raise RuntimeError(f"resumed losses {got} differ from the straight "
                           f"run's {want} by {loss_err}")

    # serve the checkpoint: the in-memory params, then the CLI, which
    # restores the params from the checkpoint and serves them
    mem = {g: {n: t.detach() for n, t in leaves.items()}
           for g, leaves in resumed.params.items()}
    toks_mem = serve_greedy(mem, cfg)
    del resumed, mem
    gc.collect()
    torch.cuda.empty_cache()
    cfg_path = os.path.join(CKPT_DIR, "model.json")
    with open(cfg_path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg)}, f)
    tok = ByteTokenizer()
    want_out = "".join(f"=== {p!r}\n{tok.decode(o)}\n"
                       for p, o in zip(CKPT_PROMPTS, toks_mem))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate.main(["--config", cfg_path, "--checkpoint-dir", ckpt_dir,
                       *[a for p in CKPT_PROMPTS for a in ("--prompt", p)],
                       *CKPT_GEN])
    if buf.getvalue() != want_out:
        raise RuntimeError(f"generate --checkpoint-dir printed "
                           f"{buf.getvalue()!r}, expected {want_out!r}")
    # the checkpoint stays for the hf phase and the moe phase's LoRA run,
    # which removes it
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "ckpt", "model": "Llama-3.1-8B widths, cut to 1 of 32 "
           "layers (params, mu and nu in f32 per save; random weights)",
           "disk_free_gb": free / 1e9,
           "layers": 1, "params": n_params, "ce_impl": cfg.ce_impl,
           "steps_straight": CKPT_STEPS, "steps_first": 2,
           "losses_straight": want, "losses_resumed": got,
           "resumed_loss_max_abs_err": loss_err,
           "resumed_loss_limit": CKPT_LOSS_ATOL,
           "restore_bit_exact": True, "bytes_per_save": nbytes,
           "write_s": write_s, "write_gb_per_s": nbytes / write_s / 1e9,
           "read_s": read_s, "read_gb_per_s": nbytes / read_s / 1e9,
           "served_tokens": toks_mem,
           "generate_checkpoint_dir_identical": True}
    emit(out)
    return {**out, "ckpt_dir": ckpt_dir, "cfg_path": cfg_path,
            "cfg": cfg, "tcfg": tcfg, "generate_text": want_out}


# ---------------------------------------------------------------------------
# Phase 5b: the ckpt phase's checkpoint through HuggingFace's layout
# ---------------------------------------------------------------------------

HF_BUILD = "cloud_server_tpu_torch/_build"
# the kernel serve's prompts: the ckpt prompts are narrow-class windows
# (W <= 32), so a longer one makes its prefill take the wide kernel (B2)
HF_KERNEL_PROMPTS = CKPT_PROMPTS + [
    "a HuggingFace directory, written and read back by the port, served "
    "on the paged kernels"]
# the entry's forward is timed warm over this many calls
ENTRY_ITERS = 5


def _generate_text(argv) -> str:
    import contextlib
    import io
    from cloud_server_tpu_torch import generate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate.main(argv)
    return buf.getvalue()


def phase_hf(ckpt) -> dict:
    """convert -> load_hf_checkpoint -> generate --hf-checkpoint on the
    ckpt phase's checkpoint (Llama-3.1-8B widths, 1 layer, float32), then
    the graft entry's forward on the card."""
    import tempfile
    import torch
    from cloud_server_tpu_torch import convert
    from cloud_server_tpu_torch.graft_entry import entry
    from cloud_server_tpu_torch.models.hf_convert import (
        _STRUCTURAL_FIELDS, load_hf_checkpoint)
    from cloud_server_tpu_torch.ops import paged_attention as pa
    from cloud_server_tpu_torch.training.checkpoint import restore_params
    ckpt_dir, cfg_path, cfg = ckpt["ckpt_dir"], ckpt["cfg_path"], ckpt["cfg"]
    os.makedirs(HF_BUILD, exist_ok=True)
    # float32 weights beside the checkpoint, with a margin
    need = 4 * ckpt["params"] * 1.25
    free = shutil.disk_usage(HF_BUILD).free
    if free < need:
        raise RuntimeError(f"{free / 1e9:.1f} GB free on disk; the hf phase "
                           f"needs {need / 1e9:.1f} GB")
    out_dir = tempfile.mkdtemp(prefix="smoke_hf_", dir=HF_BUILD)
    try:
        # 1. export: restore on the card, write config.json + safetensors
        t0 = time.perf_counter()
        stats = convert.main(["--config", cfg_path, "--checkpoint-dir",
                              ckpt_dir, "--out", out_dir])
        convert_s = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
        if files != ["config.json", "model.safetensors"]:
            raise RuntimeError(f"convert wrote {files}")
        nbytes = sum(os.path.getsize(os.path.join(out_dir, f))
                     for f in files)
        t0 = time.perf_counter()
        for f in files:  # the write above may still sit in the page cache
            fd = os.open(os.path.join(out_dir, f), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fsync_s = time.perf_counter() - t0
        # 2. read back (warm: the file was just written) onto the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hf_cfg, params = load_hf_checkpoint(out_dir, device=DEVICE)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        bad = [k for k in sorted(_STRUCTURAL_FIELDS)
               if getattr(hf_cfg, k) != getattr(cfg, k)]
        if bad:
            raise RuntimeError(f"loaded config differs on {bad}")
        want = restore_params(ckpt_dir, cfg, device=DEVICE)
        leaves = 0
        for g, group in want.items():
            for n, w in group.items():
                got = params[g][n]
                if not (got.dtype == w.dtype == torch.float32
                        and torch.equal(got, w)):
                    raise RuntimeError(f"{g}/{n}: the HF round trip is not "
                                       "bit-equal")
                leaves += 1
        if set(params) != set(want) or sum(map(len, params.values())) \
                != leaves:
            raise RuntimeError("the HF round trip's tree differs")
        del params, want
        gc.collect()
        torch.cuda.empty_cache()
        # 3. serve it: the ckpt phase's text, character for character
        prompts = [a for p in CKPT_PROMPTS for a in ("--prompt", p)]
        t0 = time.perf_counter()
        text = _generate_text(["--config", cfg_path, "--hf-checkpoint",
                               out_dir, *prompts, *CKPT_GEN])
        serve_s = time.perf_counter() - t0
        if text != ckpt["generate_text"]:
            raise RuntimeError(f"generate --hf-checkpoint printed {text!r}, "
                               f"--checkpoint-dir {ckpt['generate_text']!r}")
        # 4. the same on the paged kernels: B1 and B2 launch, and the text
        # is --checkpoint-dir's on the same kernels
        kernel = ["--decode-impl", "pallas",
                  *[a for p in HF_KERNEL_PROMPTS for a in ("--prompt", p)]]
        pa.reset_counters()
        text_k = _generate_text(["--config", cfg_path, "--hf-checkpoint",
                                 out_dir, *CKPT_GEN, *kernel])
        counts = pa.counters()
        if (counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0
                or counts["plain_calls"]):
            raise RuntimeError(f"hf serve on the kernels: launches {counts}")
        want_k = _generate_text(["--config", cfg_path, "--checkpoint-dir",
                                 ckpt_dir, *CKPT_GEN, *kernel])
        if text_k != want_k:
            raise RuntimeError(f"generate --hf-checkpoint --decode-impl "
                               f"pallas printed {text_k!r}, "
                               f"--checkpoint-dir {want_k!r}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # 5. the graft entry on the card
    fn, args = entry()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = fn(*args)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ENTRY_ITERS):
            logits = fn(*args)
        end.record()
        end.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("the graft entry's logits are not finite")
    shape = list(logits.shape)
    del fn, args, logits
    out = {"phase": "hf", "model": "the ckpt phase's checkpoint: "
           "Llama-3.1-8B widths, 1 of 32 layers, float32",
           "hf_files": files, "hf_bytes": nbytes,
           "convert_s": convert_s, "write_s": stats["write_s"],
           "write_gb_per_s": stats["bytes"] / stats["write_s"] / 1e9,
           "fsync_s": fsync_s,
           "write_fsync_gb_per_s": stats["bytes"]
           / (stats["write_s"] + fsync_s) / 1e9,
           "read_s": read_s, "read_gb_per_s": nbytes / read_s / 1e9,
           "read_warm": True, "leaves_bit_equal": leaves,
           "structural_fields_equal": len(_STRUCTURAL_FIELDS),
           "serve_s": serve_s, "text_equals_checkpoint_dir": True,
           "kernel_text_equals_checkpoint_dir": True,
           "counts": counts, "entry_logits_shape": shape,
           "entry_first_ms": first_ms,
           "entry_forward_ms": start.elapsed_time(end) / ENTRY_ITERS}
    emit(out)
    print(f"graft entry: logits {shape}, forward "
          f"{out['entry_forward_ms']:.3f} ms warm", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6: Mixtral-style MoE through both servers, speculation, int8
# weights and training; LoRA training on the ckpt phase's checkpoint
# ---------------------------------------------------------------------------

MOE_CONFIG = "cloud_server_tpu_torch/configs/mixtral_8x7b.json"
MOE_TRAIN_CONFIG = "cloud_server_tpu_torch/configs/mixtral_8x7b_train.json"
MOE_LAYERS = 8         # bf16 at full width (16 layers: 46.96 GB)
MOE_INT8_CHECK_LAYERS = 4
# int8 weights drawn and quantized a layer at a time and served at this
# depth (all 32 fit one card in 46.87 GB: PERF.md)
MOE_INT8_FULL_LAYERS = 16
MOE_TRAIN_STEPS = 4    # each run repeats one batch: the loss must fall
# The narrow MoE slice in float32 on the card (plain attention, TF32 off)
# against the same step on the CPU: the same products in another order,
# so the loss and every gradient leaf within float32 rounding of a few
# thousand terms (limits about 100x float32's resolution).
MOE_SLICE_LOSS_ATOL = 1e-4
MOE_SLICE_GRAD_REL = 1e-4
MOE_FUSED_SEQ = 1024  # the fused-CE run's S: flash's fused backward (B6)
# rank 16 on the default attention targets; the learning rate high
# enough that 3 steps move the served tokens off the base's
LORA_RANK, LORA_STEPS, LORA_LR = 16, 3, "1e-2"
LORA_DIR = "cloud_server_tpu_torch/_build/smoke_lora"


def moe_cfg(layers: int):
    import dataclasses
    from cloud_server_tpu_torch.config import ModelConfig, from_json
    with open(MOE_CONFIG) as f:
        cfg = from_json(ModelConfig, json.load(f)["model"])
    return dataclasses.replace(cfg, num_layers=layers)


def weight_read_bound(params) -> tuple:
    """(bytes, ms): every weight a decode round reads once (the
    embedding table only by its rows, so it is left out), over the
    card's memory rate."""
    from cloud_server_tpu_torch.models.quantization import QTensor
    n = 0
    for group, leaves in params.items():
        for name, t in leaves.items():
            if group == "embed":
                continue
            if isinstance(t, QTensor):
                n += t.q.numel() + 4 * t.scale.numel()
            else:
                n += t.numel() * t.element_size()
    return n, n / HBM_BYTES_PER_S * 1e3


# The bf16 MoE paths against the plain forward: a routing decision at a
# near tie between two experts flips under bf16 rounding, and the flip
# moves that token's MLP output by a whole expert's contribution, so
# unlike a dense model's (C8) the served tokens leave the plain forward's
# argmax past its near-tie limit (PERF.md, PR 15). Exactness is held on
# the float32 slice; in bf16 a path must keep this share of its tokens
# on the plain forward's argmax (a broken dispatch keeps about 1/V).
MOE_BF16_ARGMAX_FLOOR = 0.5


def plain_forward_check(what, reqs, prompts, params, cfg,
                        floor: float | None = None) -> dict:
    """The served greedy tokens against the plain forward of the model's
    family (`moe.forward_hidden` routes each whole sequence at once),
    teacher-forced over each request's own tokens. `floor` None: every
    served token must be that forward's argmax (the float32 slice's
    rule); else at least `floor` of them, and the rest are reported
    beside C8's near-tie limit (the run's 25th percentile of top-2
    gaps). The forward's routing is counted as it runs: each expert's
    share of the filled slots over all layers and requests, and the
    largest dropped_frac (the dropless config must drop nothing)."""
    import numpy as np
    from cloud_server_tpu_torch.models import moe
    load = np.zeros(cfg.num_experts)
    dropped = []
    real = moe.route

    def counted(logits, k, capacity):
        r = real(logits, k, capacity)
        load[:] += (r.token < logits.shape[0]).sum(-1).cpu().numpy()
        dropped.append(float(r.aux["dropped_frac"]))
        return r

    moe.route = counted
    try:
        top2, gaps, first = [], [], []
        argmax = total = 0
        for r, prompt in zip(reqs, prompts):
            logits = dense_logits(params, cfg, prompt, r.tokens)
            best = logits.topk(2, dim=-1).values
            top2 += (best[:, 0] - best[:, 1]).tolist()
            served = logits.gather(1, logits.new_tensor(
                r.tokens).long()[:, None])[:, 0]
            gap = (best[:, 0] - served).tolist()
            total += len(gap)
            argmax += sum(g == 0 for g in gap)
            gaps += [g for g in gap if g > 0]
            first.append(next((i for i, g in enumerate(gap) if g > 0),
                              None))
    finally:
        moe.route = real
    limit = float(np.percentile(top2, 25))
    share = argmax / total
    if share < (1.0 if floor is None else floor):
        raise RuntimeError(f"{what}: {share} of the served tokens are the "
                           f"plain forward's argmax (gaps {gaps})")
    if max(dropped) != 0.0:
        raise RuntimeError(f"{what}: the dropless config dropped "
                           f"{max(dropped)} of the tokens")
    return {"argmax_share": share,
            "first_non_argmax_position": first,
            "non_argmax_gaps_below_top_logit": gaps,
            "gaps_past_near_tie_limit": sum(g > limit for g in gaps),
            "near_tie_limit_p25_top2": limit,
            "top2_gap_p5_p50": [float(np.percentile(top2, 5)),
                                float(np.percentile(top2, 50))],
            "dropped_frac_max": max(dropped),
            "expert_load_share": (load / load.sum()).tolist()}


def moe_f32_slice(p32, cfg32, icfg, prompts) -> dict:
    """The first 2 layers at full width in float32 (`f32_slice`: TF32
    off; the plain attention, the kernels taking bf16 and int8 pools
    only), where rounding cannot flip a routing decision: the paged
    server, the contiguous server and n-gram speculation each serve the
    plain forward's greedy tokens, token for token. Launched eagerly
    (graphed == graphs off is held in bf16): a float32 contiguous
    admission of 8 x 2048 rows holds about 30 GB of expert activations,
    which a capture would hold twice."""
    import dataclasses
    out = {}
    for what, make in (
            ("paged", lambda: make_server(p32, cfg32, icfg,
                                          cuda_graphs=False)),
            ("contiguous", lambda: make_contiguous(
                p32, dataclasses.replace(cfg32, attention_impl="xla"),
                icfg, cuda_graphs=False)),
            ("ngram", lambda: make_server(p32, cfg32, icfg,
                                          spec_drafts=SPEC_DRAFTS,
                                          spec_control=False,
                                          cuda_graphs=False))):
        srv = make()
        reqs, _, _, _ = serve_once(p32, cfg32, icfg, prompts, srv=srv)
        release(srv)
        check_served(reqs, cfg32.vocab_size)
        res = plain_forward_check(f"MoE f32 slice, {what}", reqs, prompts,
                                  p32, cfg32)
        out[what] = {"argmax_share": res["argmax_share"],
                     "dropped_frac_max": res["dropped_frac_max"]}
    return out


def steady_decode(srv, prompts, steps: int = PROFILE_STEPS) -> dict:
    """`steps` steady decode steps (8 live slots, every program already
    captured) under torch.profiler; the requests are cancelled after."""
    reqs = [srv.submit(p, max_new_tokens=LONG_NEW) for p in prompts]
    while srv._jobs or srv.num_pending:
        srv.step()
    for _ in range(2):
        srv.step()
    captured = len(srv._programs)
    live = srv.num_active
    prof = profile_step(srv.step, steps)
    cancel_all(srv, reqs)
    if len(srv._programs) != captured or live != len(prompts):
        raise RuntimeError(f"steady decode: {live} live slots, "
                           f"{len(srv._programs) - captured} new programs")
    return {**prof, "rounds_per_step": srv.decode_chunk,
            "device_busy_ms_per_round": prof["device_busy_ms"]
            / srv.decode_chunk}


def quantize_layerwise(params):
    """`quantize_params` one layer of a stacked leaf at a time (the same
    values: the scales never reduce over the layer axis), so no float32
    copy of a whole expert stack is made."""
    import torch
    from cloud_server_tpu_torch.models.quantization import (
        _REDUCE_AXES, QTensor, quantize, quantize_params)
    out = {}
    for group, leaves in params.items():
        if group != "layers":
            out[group] = quantize_params({group: leaves})[group]
            continue
        out[group] = {}
        for name, w in leaves.items():
            axes = _REDUCE_AXES.get((name, w.dim()))
            if axes is None:
                out[group][name] = w
                continue
            parts = [quantize(w[i], tuple(a - 1 for a in axes))
                     for i in range(w.shape[0])]
            out[group][name] = QTensor(torch.stack([p.q for p in parts]),
                                       torch.stack([p.scale for p in parts]))
            del parts
    return out


def init_int8_moe(cfg, seed: int):
    """The MoE model's random initialisation drawn and quantized one layer
    of a stacked leaf at a time (`transformer.init_params`' distribution),
    so the bf16 tree of all 32 layers (93.4 GB) never exists: the weight
    leaves int8 with per-channel scales, the norms, router and embedding
    table as cfg.param_dtype."""
    import math
    import torch
    from cloud_server_tpu_torch.models import moe, transformer
    from cloud_server_tpu_torch.models.quantization import (
        _REDUCE_AXES, QTensor, quantize)
    dtype = transformer.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    out: dict = {}
    for group, leaves in moe.param_shapes(cfg).items():
        out[group] = {}
        for name, shape in leaves.items():
            if "norm" in group or "norm" in name:
                out[group][name] = torch.ones(shape, dtype=dtype,
                                              device=DEVICE)
                continue
            std = 1.0 / math.sqrt(transformer._fan_in(name, cfg))
            axes = _REDUCE_AXES.get((name, len(shape)))
            if name == "kernel" and group != "lm_head":
                axes = None
            stacked = group == "layers"
            slices = shape[0] if stacked else 1
            q = scale = full = None
            for i in range(slices):
                part = shape[1:] if stacked else shape
                w = transformer._trunc_normal_(torch.empty(
                    part, dtype=torch.float32, device=DEVICE), gen).mul_(std)
                w = w.to(dtype)
                if axes is None:
                    if full is None:
                        full = torch.empty(shape, dtype=dtype, device=DEVICE)
                    (full[i] if stacked else full).copy_(w)
                    continue
                qt = quantize(w, tuple(a - 1 for a in axes) if stacked
                              else axes)
                if q is None:
                    q = torch.empty(shape, dtype=torch.int8, device=DEVICE)
                    scale = torch.empty(
                        (shape[0], *qt.scale.shape) if stacked
                        else qt.scale.shape, dtype=torch.float32,
                        device=DEVICE)
                (q[i] if stacked else q).copy_(qt.q)
                (scale[i] if stacked else scale).copy_(qt.scale)
                del w, qt
            out[group][name] = full if axes is None else QTensor(q, scale)
    return out


def moe_serve_part(params, cfg, icfg, prompts) -> dict:
    """(a): the default paged server (mixed scheduler, overlap, captured
    graphs) at MOE_LAYERS layers: B1/B2 counted over the main run; the
    same tokens with graphs off; the tokens against the plain forward
    (and every server exact on the float32 slice); a steady decode step
    profiled against the weights' read bound."""
    import numpy as np
    import torch
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = make_server(params, cfg, icfg)
    pa.reset_counters()
    reqs, t_start, t_end, pool_bytes = serve_once(params, cfg, icfg,
                                                  prompts, srv=srv)
    counts = pa.counters()
    peak = torch.cuda.max_memory_allocated() - base
    check_served(reqs, cfg.vocab_size)
    if (counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0
            or counts["plain_calls"]):
        raise RuntimeError(f"MoE paged server: launches {counts}")
    tokens = [r.tokens for r in reqs]
    out = {"counts": counts, "programs_captured": len(srv._programs),
           "capture_s": srv._programs.capture_seconds(),
           "kv_pool_bytes": pool_bytes, "peak_over_weights_gb": peak / 1e9,
           **serving_rates(reqs, t_start, t_end)}
    out["steady_decode"] = steady_decode(srv, make_prompts(
        np.random.default_rng(SEED + 7), cfg.vocab_size))
    release(srv)
    eager, _, _, _ = serve_once(params, cfg, icfg, prompts,
                                cuda_graphs=False)
    same_tokens("MoE graphed vs graphs off", eager, tokens)
    out["graphed_equals_graphs_off"] = True
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    out["plain_forward"] = plain_forward_check(
        "MoE paged server", reqs, prompts, params, cfg,
        floor=MOE_BF16_ARGMAX_FLOOR)
    nbytes, bound = weight_read_bound(params)
    out["weight_read_bytes"] = nbytes
    out["round_bound_ms"] = bound
    out["busy_per_round_over_bound"] = (
        out["steady_decode"]["device_busy_ms_per_round"] / bound)
    out["seconds"] = time.perf_counter() - t0
    return out, reqs


def same_share(reqs, want) -> float:
    """The share of `want`'s tokens that `reqs` repeat before each
    request's first divergence."""
    equal = total = 0
    for r, w in zip(reqs, want):
        total += len(w.tokens)
        equal += next((j for j, (a, b) in enumerate(zip(r.tokens, w.tokens))
                       if a != b), len(w.tokens))
    return equal / total


def moe_other_servers_part(params, cfg, icfg, prompts, plain) -> dict:
    """(b): the contiguous server (B3 on every admission) and n-gram
    speculation on the same weights: the share of (a)'s tokens each
    repeats, and each against the plain forward as (a) is."""
    import torch
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    csrv = make_contiguous(params, contiguous_cfg(cfg), icfg)
    fl.reset_counters()
    creqs, c0, c1 = run_contiguous(csrv, prompts)
    torch.cuda.synchronize()
    ccounts = fl.counters()
    release(csrv)
    check_served(creqs, cfg.vocab_size)
    if ccounts["launches_fwd"] <= 0 or ccounts["plain_calls"]:
        raise RuntimeError(f"MoE contiguous server: launches {ccounts}")
    out = {"contiguous": {
        "b3_counts": ccounts, "wall_s": c1 - c0,
        "equal_to_paged": same_share(creqs, plain),
        "plain_forward": plain_forward_check(
            "MoE contiguous", creqs, prompts, params, cfg,
            floor=MOE_BF16_ARGMAX_FLOOR)}}
    del creqs
    ssrv = make_server(params, cfg, icfg, spec_drafts=SPEC_DRAFTS,
                       spec_control=False)
    pa.reset_counters()
    sreqs, s0, s1, _ = serve_once(params, cfg, icfg, prompts, srv=ssrv)
    scounts = pa.counters()
    stats = ssrv.speculation_stats()
    release(ssrv)
    check_served(sreqs, cfg.vocab_size)
    if scounts["launches_narrow_verify"] <= 0 or scounts["plain_calls"]:
        raise RuntimeError(f"MoE n-gram speculation: launches {scounts}")
    out["ngram"] = {
        "counts": scounts, "wall_s": s1 - s0, "spec_stats": stats,
        "equal_to_paged": same_share(sreqs, plain),
        "plain_forward": plain_forward_check(
            "MoE n-gram speculation", sreqs, prompts, params, cfg,
            floor=MOE_BF16_ARGMAX_FLOOR)}
    out["seconds"] = time.perf_counter() - t0
    return out


def moe_int8_part(q8, cfg, icfg, prompts) -> dict:
    """(c), first half: on the first MOE_INT8_CHECK_LAYERS layers, the
    int8 server against a server on the dequantized weights cast to bf16
    (the same products: identical tokens)."""
    import dataclasses
    import torch
    t0 = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, num_layers=MOE_INT8_CHECK_LAYERS)
    deq = dequantized_bf16(q8)
    qsrv = make_server(q8, cfg8, icfg)
    qreqs, _, _, _ = serve_once(q8, cfg8, icfg, prompts, srv=qsrv)
    release(qsrv)
    dsrv = make_server(deq, cfg8, icfg)
    dreqs, _, _, _ = serve_once(deq, cfg8, icfg, prompts, srv=dsrv)
    release(dsrv)
    check_served(qreqs, cfg.vocab_size)
    same_tokens("MoE int8 vs dequantized bf16 (8 layers)", dreqs,
                [r.tokens for r in qreqs])
    del deq, dreqs, qreqs
    gc.collect()
    torch.cuda.empty_cache()
    out = {"check_layers": MOE_INT8_CHECK_LAYERS,
           "int8_equals_dequantized": True,
           "check_s": time.perf_counter() - t0}
    return out


def moe_int8_full(cfg32, icfg, prompts) -> dict:
    """(c), second half: MOE_INT8_FULL_LAYERS layers on int8 weights,
    drawn and quantized a layer at a time: stored bytes, peak memory, 8
    requests served, a steady decode step profiled."""
    import numpy as np
    import torch
    from cloud_server_tpu_torch.models.quantization import quantized_bytes
    from cloud_server_tpu_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    q32 = init_int8_moe(cfg32, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stored, bf16_bytes = quantized_bytes(q32)
    weights_alloc = torch.cuda.memory_allocated()
    srv = make_server(q32, cfg32, icfg)
    pa.reset_counters()
    reqs, r0, r1, pool_bytes = serve_once(q32, cfg32, icfg, prompts,
                                          srv=srv)
    counts = pa.counters()
    check_served(reqs, cfg32.vocab_size)
    if (counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0
            or counts["plain_calls"]):
        raise RuntimeError(f"int8 MoE server ({cfg32.num_layers} layers): "
                           f"launches {counts}")
    prof = steady_decode(srv, make_prompts(np.random.default_rng(SEED + 8),
                                           cfg32.vocab_size), steps=1)
    peak = torch.cuda.max_memory_allocated()
    nbytes, bound = weight_read_bound(q32)
    release(srv)
    del q32, srv
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg32.num_layers, "init_quantize_s": init_s,
            "stored_bytes": stored, "bf16_bytes": bf16_bytes,
            "stored_share": stored / bf16_bytes,
            "weights_allocated_gb": weights_alloc / 1e9,
            "peak_mem_gb": peak / 1e9, "kv_pool_bytes": pool_bytes,
            "counts": counts, "served_requests": len(reqs),
            "wall_s": r1 - r0, "steady_decode": prof,
            "weight_read_bytes": nbytes, "round_bound_ms": bound,
            "seconds": time.perf_counter() - t0}


def moe_flops_per_token(cfg, seq_len: int) -> tuple:
    """(active, computed) training FLOPs per token (6 per weight per
    token, plus causal attention, as utils.metrics counts them): the
    active experts are k of E per token; the dense dispatch computes
    every expert's C = factor * T * k / E slots, factor * k expert
    MLPs a token."""
    D, F, L = cfg.embed_dim, cfg.mlp_dim, cfg.num_layers
    attn_w = (D * cfg.num_heads * cfg.head_dim * 2
              + D * cfg.num_kv_heads * cfg.head_dim * 2)
    expert = 3 * D * F
    head = D * cfg.vocab_size
    attn = 2.0 * 3 * 2 * seq_len * cfg.num_heads * cfg.head_dim * L * 0.5

    def per_token(experts_per_token):
        n = L * (attn_w + D * cfg.num_experts
                 + experts_per_token * expert) + head
        return 6.0 * n + attn
    return (per_token(cfg.num_experts_per_token),
            per_token(cfg.expert_capacity_factor
                      * cfg.num_experts_per_token))


def moe_slice_agreement(cfg) -> dict:
    """A narrow 2-layer MoE slice (Mixtral's structure: 8 experts, top-2,
    GQA, head dim 128) in float32, one loss and backward on the card
    (plain attention, TF32 off) against the same on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from cloud_server_tpu_torch.models import moe
    narrow = dataclasses.replace(
        cfg, num_layers=2, embed_dim=512, mlp_dim=1024, num_heads=4,
        num_kv_heads=1, head_dim=128, vocab_size=2048, dtype="float32",
        param_dtype="float32", attention_impl="xla", ce_impl="dense",
        remat="none")
    params = moe.init_params(narrow, SEED, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, narrow.vocab_size, (2, 512)))
    lc, gc_ = _leaf_grads(params, narrow, toks, moe.next_token_loss)
    lg, gg = _leaf_grads({g: {n: t.to(DEVICE) for n, t in leaves.items()}
                          for g, leaves in params.items()}, narrow,
                         toks.to(DEVICE), moe.next_token_loss)
    worst = _worst_rel({k: v.cpu() for k, v in gg.items()}, gc_)
    res = {"moe_slice": "2 layers, D 512, F 1024, 8 experts, f32",
           "loss_card": lg, "loss_cpu": lc, "loss_abs_err": abs(lg - lc),
           "loss_limit": MOE_SLICE_LOSS_ATOL,
           "grad_worst_rel_err": worst,
           "grad_rel_limit": MOE_SLICE_GRAD_REL}
    if abs(lg - lc) > MOE_SLICE_LOSS_ATOL or worst > MOE_SLICE_GRAD_REL:
        raise RuntimeError(f"MoE slice: the card differs from the CPU: "
                           f"{res}")
    return res


def moe_train_part() -> dict:
    """(d): the training CLI on mixtral_8x7b_train.json (2 layers at full
    width, f32 masters, flash attention, full remat), MOE_TRAIN_STEPS
    steps on one repeated batch with the dense CE at S 2048 (B3, B4, B5),
    then with the fused CE at S 1024 (B3, B6, B7, B8); the loss falling,
    the launches against layers x steps, tokens/s and MFU over the
    active and the computed FLOPs; a narrow slice against the CPU."""
    import dataclasses
    import shutil
    import torch
    from cloud_server_tpu_torch.config import (ModelConfig, TrainConfig,
                                               from_json)
    t0 = time.perf_counter()
    with open(MOE_TRAIN_CONFIG) as f:
        raw = json.load(f)
    cfg = from_json(ModelConfig, raw["model"])
    tcfg = from_json(TrainConfig, raw["train"])
    fused_raw = json.loads(json.dumps(raw))
    fused_raw["model"]["ce_impl"] = "pallas"
    fused_raw["train"]["seq_len"] = MOE_FUSED_SEQ
    os.makedirs(LOG_DIR, exist_ok=True)
    fused_path = os.path.join(LOG_DIR, "mixtral_train_fused_ce.json")
    with open(fused_path, "w") as f:
        json.dump(fused_raw, f)
    runs = {}
    for tag, path, seq, fused in (
            ("moe_dense", MOE_TRAIN_CONFIG, tcfg.seq_len, False),
            ("moe_fused_ce", fused_path, MOE_FUSED_SEQ, True)):
        state, recs, (counts, ce_counts), peak, wall = train_run(
            tag, ["--steps", str(MOE_TRAIN_STEPS)], config=path,
            synthetic=tcfg.batch_size)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        rcfg = dataclasses.replace(cfg, ce_impl="pallas" if fused
                                   else "dense")
        check_run(tag, rcfg, recs, counts, MOE_TRAIN_STEPS, fused,
                  cfg.vocab_size)
        if fused and (ce_counts["launches_fwd"] != MOE_TRAIN_STEPS
                      or ce_counts["launches_dx"] != MOE_TRAIN_STEPS):
            raise RuntimeError(f"{tag}: fused CE launches {ce_counts}")
        losses = [r["loss"] for r in recs if "loss" in r]
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{tag}: the loss did not fall: {losses}")
        stats = {k: [r[k] for r in recs if k in r]
                 for k in ("load_balance", "router_z", "dropped_frac")}
        if any(x != 0.0 for x in stats["dropped_frac"]):
            raise RuntimeError(f"{tag}: dropped {stats['dropped_frac']}")
        active, computed = moe_flops_per_token(cfg, seq)
        rtcfg = dataclasses.replace(tcfg, seq_len=seq)
        summary = run_summary(recs, rtcfg, active, peak, wall,
                              {"flash": counts, "fused_ce": ce_counts})
        summary["mfu_computed"] = (summary["tokens_per_s"] * computed
                                   / BF16_FLOP_PER_S)
        summary["flops_per_token_active"] = active
        summary["flops_per_token_computed"] = computed
        runs[tag] = {**summary, **stats}
    shutil.rmtree(LOG_DIR, ignore_errors=True)
    return {"config": MOE_TRAIN_CONFIG, "layers": cfg.num_layers,
            "runs": runs, "slice": moe_slice_agreement(cfg),
            "seconds": time.perf_counter() - t0}


def moe_lora_part(ckpt) -> dict:
    """(e): `train --lora-rank 16 --init-from` the ckpt phase's
    checkpoint (Llama-3.1-8B widths, 1 layer, fused CE): the base
    restored and left bit for bit, the adapters moved, AdamW moments for
    the adapters only, B3-B5 and B7/B8 launched; then `generate
    --checkpoint-dir` on the LoRA run serves the merged weights' tokens,
    which differ from the base's."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import torch
    from cloud_server_tpu_torch import generate, train
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.models.lora import (LoRAConfig,
                                                    export_merged,
                                                    load_lora_config)
    from cloud_server_tpu_torch.ops import flash_attention as fl
    from cloud_server_tpu_torch.ops import fused_ce as fc
    from cloud_server_tpu_torch.training.checkpoint import restore_params
    from cloud_server_tpu_torch.training.optim import flatten
    t0 = time.perf_counter()
    cfg, tcfg = ckpt["cfg"], ckpt["tcfg"]
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    os.makedirs(LORA_DIR)
    path = os.path.join(LORA_DIR, "lora_train.json")
    with open(path, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg),
                   "train": dataclasses.asdict(dataclasses.replace(
                       tcfg, total_steps=LORA_STEPS)),
                   "loop": {"log_interval": 1}}, f)
    run_dir = os.path.join(LORA_DIR, "run")
    fl.reset_counters()
    fc.reset_counters()
    t1 = time.perf_counter()
    state = train.main(["--config", path, "--synthetic", "64",
                        "--lora-rank", str(LORA_RANK), "--init-from",
                        ckpt["ckpt_dir"], "--checkpoint-dir", run_dir,
                        "--learning-rate", LORA_LR,
                        "--logdir", os.path.join(LORA_DIR, "log")])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    counts, ce_counts = fl.counters(), fc.counters()
    per = cfg.num_layers * LORA_STEPS
    want = {"launches_fwd": 2 * per, "launches_bwd_dkdv": per,
            "launches_bwd_dq": per, "launches_bwd_fused": 0,
            "plain_calls": 0}
    if counts != want or ce_counts["launches_fwd"] != LORA_STEPS \
            or ce_counts["launches_dx"] != LORA_STEPS:
        raise RuntimeError(f"LoRA run: launches {counts} {ce_counts}, "
                           f"expected {want} and {LORA_STEPS} of B7/B8")
    base = restore_params(ckpt["ckpt_dir"], cfg, device=DEVICE)
    for k, t in flatten(state.params["base"]):
        if not torch.equal(t, dict(flatten(base))[k]):
            raise RuntimeError(f"LoRA run: base leaf {k} changed")
    del base
    if not all(float(ab["b"].detach().abs().max()) > 0
               for ab in state.params["lora"]["layers"].values()):
        raise RuntimeError("LoRA run: an adapter's B stayed at zero")
    moments = [k for k, _ in flatten(state.opt_state.mu)]
    if not moments or not all(k.startswith("lora/") for k in moments):
        raise RuntimeError(f"LoRA run: moments for {moments}")
    lcfg = load_lora_config(run_dir)
    if lcfg != LoRAConfig(rank=LORA_RANK, alpha=16.0):
        raise RuntimeError(f"LoRA sidecar: {lcfg}")
    adapter_bytes = sum(t.numel() * t.element_size()
                        for _, t in flatten(state.params["lora"]))
    moment_bytes = 2 * sum(t.numel() * t.element_size()
                           for _, t in flatten(state.opt_state.mu))
    merged = {g: {n: t.detach() for n, t in leaves.items()} for g, leaves
              in export_merged(state.params, lcfg).items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    toks = serve_greedy(merged, cfg)
    if toks == ckpt["served_tokens"]:
        raise RuntimeError("LoRA run: the merged weights serve the base's "
                           "tokens (the adapters do not bite)")
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    tok = ByteTokenizer()
    want_out = "".join(f"=== {p!r}\n{tok.decode(o)}\n"
                       for p, o in zip(CKPT_PROMPTS, toks))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate.main(["--config", ckpt["cfg_path"], "--checkpoint-dir",
                       run_dir, *[a for p in CKPT_PROMPTS
                                  for a in ("--prompt", p)], *CKPT_GEN])
    if buf.getvalue() != want_out:
        raise RuntimeError(f"generate --checkpoint-dir on the LoRA run "
                           f"printed {buf.getvalue()!r}, expected "
                           f"{want_out!r}")
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {"rank": LORA_RANK, "targets": list(lcfg.targets),
            "steps": LORA_STEPS, "train_s": train_s,
            "flash_counts": counts, "ce_counts": ce_counts,
            "base_bit_unchanged": True, "adapters_moved": True,
            "moment_leaves": len(moments), "adapter_bytes": adapter_bytes,
            "adam_moment_bytes": moment_bytes,
            "generate_serves_merged": True, "served_tokens": toks,
            "seconds": time.perf_counter() - t0}


def phase_moe(ckpt) -> dict:
    import numpy as np
    import torch
    from cloud_server_tpu_torch.config import InferConfig
    from cloud_server_tpu_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    cfg = moe_cfg(MOE_LAYERS)
    t0 = time.perf_counter()
    params = moe.init_params(cfg, SEED, device=DEVICE)
    torch.cuda.synchronize()
    seconds["init"] = time.perf_counter() - t0
    icfg = InferConfig(max_decode_len=MAX_NEW, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    prompts = make_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    serve, reqs = moe_serve_part(params, cfg, icfg, prompts)
    seconds["serve"] = serve["seconds"]
    others = moe_other_servers_part(params, cfg, icfg, prompts, reqs)
    seconds["other_servers"] = others["seconds"]
    t1 = time.perf_counter()
    p32, cfg32 = f32_slice(params, cfg)
    q8 = quantize_layerwise(first_layers(params, cfg,
                                         MOE_INT8_CHECK_LAYERS)[0])
    del params, reqs
    gc.collect()
    torch.cuda.empty_cache()
    serve["f32_slice"] = moe_f32_slice(p32, cfg32, icfg, prompts)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    seconds["f32_slice"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    int8 = moe_int8_part(q8, cfg, icfg, prompts)
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    int8["full"] = moe_int8_full(moe_cfg(MOE_INT8_FULL_LAYERS), icfg,
                                 prompts)
    seconds["int8"] = time.perf_counter() - t1
    train = moe_train_part()
    seconds["train"] = train["seconds"]
    lora = moe_lora_part(ckpt)
    seconds["lora"] = lora["seconds"]
    out = {"phase": "moe", "model": "Mixtral-8x7B (random weights)",
           "serve": {"layers": MOE_LAYERS, **serve}, **others,
           "int8": int8, "train": train, "lora": lora,
           "seconds": seconds}
    emit(out)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--http-clients"]:
        return http_clients(sys.argv[2], int(sys.argv[3]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cloud_server_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.chdir(here)
    sys.path.insert(0, here)
    seconds: dict = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()  # each phase frees its model and buffers
        return out

    dev = timed(phase_device)
    if sys.argv[1:2] == ["--http-rounds"]:
        probe = http_probe(int(sys.argv[2]), dev["nvidia_smi"])
        return 0 if not probe["failed_rounds"] else 1
    if "--tp-only" in sys.argv[1:]:
        timed(phase_tp)
        return 0  # the tp phase alone (on several cards: NCCL); no result
    if "--ptrain-only" in sys.argv[1:]:
        # four cards or more: fsdp 2 x tp 2 over NCCL; else the one-card
        # form (gloo); prints no result
        timed(phase_ptrain_kernel)
        cards = torch.cuda.device_count()
        timed(phase_ptrain, cards >= 4)
        timed(phase_dryrun, 4 if cards >= 4 else DRYRUN_RANKS)
        emit({"phase_seconds": seconds})
        return 0
    kern = timed(phase_kernel)
    fkern = timed(phase_train_kernel)
    timed(phase_unembed)
    ce = timed(phase_ce_kernel)
    pkern = timed(phase_ptrain_kernel)
    if "--kernel-only" in sys.argv[1:]:
        return 0  # a quick check of a kernel change; prints no result
    serve = timed(phase_serve)
    tp = timed(phase_tp, serve)
    train = timed(phase_train)
    ptrain = timed(phase_ptrain)
    timed(phase_dryrun)
    pack = timed(phase_pack, train)
    ckpt = timed(phase_ckpt)
    hf = timed(phase_hf, ckpt)
    moe = timed(phase_moe, ckpt)
    seconds["serve.contiguous"] = serve["contiguous"]["seconds"]["total"]
    emit({"phase_seconds": seconds})
    counts = serve["counts"]
    rows = []
    # the int8 rows: launches from the int8 cache served over HTTP
    counts8 = serve["int8"]["http_counts"]

    def worst(*cases):
        return max(kern[c]["max_abs_err"] for c in cases)

    for kernel, case, line, launches, err, branch in (
            ("paged_narrow_kernel", "decode", 96, counts["launches_narrow"],
             worst("decode", "verify"), ""),
            ("paged_wide_kernel", "prefill", 434, counts["launches_wide"],
             worst("prefill", "ragged"), ""),
            ("paged_narrow_kernel", "decode_int8", 96,
             counts8["launches_narrow_int8"],
             worst("decode_int8", "verify_int8"), " (int8 branch)"),
            ("paged_wide_kernel", "prefill_int8", 434,
             counts8["launches_wide_int8"],
             worst("prefill_int8", "ragged_int8"), " (int8 branch)")):
        k = kern[case]
        rows.append({
            "name": f"paged_attention: {kernel}, {k['class']} class "
                    f"({case} case)",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"cloud_server_tpu/ops/paged_attention.py:{line}"
                        f"{branch}",
            "launches": launches, "max_abs_err": err, "ms": k["ms"],
            "ms_cold": k["ms_cold"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    # this slice's shapes, with launches from the speculating servers
    spec_counts = serve["spec"]["counts"]
    for kernel, case, line, launches in (
            ("paged_narrow_kernel", "verify_w5", 96,
             spec_counts["launches_narrow_verify"]),
            ("paged_narrow_kernel", "decode_d64", 96,
             spec_counts["launches_narrow_d64"]),
            ("paged_wide_kernel", "prefill_d64", 434,
             spec_counts["launches_wide_d64"])):
        k = kern[case]
        rows.append({
            "name": f"paged_attention: {kernel}, {k['class']} class "
                    f"({case} case: B {k['B']}, W {k['W']}, Dh {k['Dh']})",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"cloud_server_tpu/ops/paged_attention.py:{line}",
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    # one tensor-parallel rank's share of the heads (tp 2: 16 q heads on
    # KH 4), with the tp phase's launches summed over its ranks; the tp 4
    # share (KH 2) timed beside it
    for kernel, case, line, key, branch in (
            ("paged_narrow_kernel", "decode_kh4", 96, "launches_narrow", ""),
            ("paged_wide_kernel", "prefill_kh4", 434, "launches_wide", ""),
            ("paged_narrow_kernel", "decode_kh4_int8", 96,
             "launches_narrow_int8", " (int8 branch)"),
            ("paged_wide_kernel", "prefill_kh4_int8", 434,
             "launches_wide_int8", " (int8 branch)")):
        k = kern[case]
        k2 = kern[case.replace("kh4", "kh2")]
        per_rank = [r["counts_int8" if "int8" in case else "counts"][key]
                    for r in tp["ranks"]]
        rows.append({
            "name": f"paged_attention: {kernel}, {k['class']} class "
                    f"({case} case: one tp {TP} rank, B {k['B']}, W "
                    f"{k['W']}, H {k['H']}, KH {k['KH']})",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"cloud_server_tpu/ops/paged_attention.py:{line}"
                        f"{branch}",
            "launches": sum(per_rank), "launches_per_rank": per_rank,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "kh2_case": {f: k2[f] for f in (
                "H", "KH", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}})
    tc = train["counts"]
    blocked, fused = fkern["blocked"], fkern["fused"]
    blocked_cases = [c for c, r in fkern.items() if r["backward"] == "blocked"]
    fused_cases = [c for c, r in fkern.items() if r["backward"] == "fused"]

    def err_of(case, *keys):
        return max(fkern[c]["errors"][k]["max_abs_err"]
                   for c in case for k in keys)

    for name, line, launches, case, key, err, plain in (
            ("flash_attention forward", 70, tc["launches_fwd"], blocked,
             "fwd", err_of(FLASH_CASES, "out"), "plain_fwd_ms"),
            ("flash_attention dK/dV backward", 205,
             tc["launches_bwd_dkdv"], blocked, "bwd_dkdv",
             err_of(blocked_cases, "dk", "dv"), "plain_bwd_ms"),
            ("flash_attention dQ backward", 295, tc["launches_bwd_dq"],
             blocked, "bwd_dq", err_of(blocked_cases, "dq"),
             "plain_bwd_ms"),
            ("flash_attention fused backward", 261,
             tc["launches_bwd_fused"], fused, "bwd_fused",
             err_of(fused_cases, "dq", "dk", "dv"), "plain_bwd_ms")):
        rows.append({
            "name": f"{name} (B {case['B']}, S {case['S']})",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"cloud_server_tpu/ops/flash_attention.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": case[f"{key}_ms"], "plain_ms": case[plain],
            "bound_ms": case["bound_ms"][key],
            "bound_by": case["bound_by"][key],
            "library_ms": case["library_fwd_ms" if key == "fwd"
                               else "library_bwd_ms"]})
    # B3 on this slice's path: embed on the flash route, one layer over
    # the (bucket, rows) groups of the 8 serve prompts
    emb = serve["elastic"]["embed"]
    b3e = emb["b3_layer"]
    rows.append({
        "name": "flash_attention forward (embed: "
                + ", ".join(f"B {b} x S {s_}" for s_, b in emb["groups"])
                + ", one layer)",
        "route": "cuda",
        "source": "cloud_server_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cloud_server_tpu/ops/flash_attention.py:70",
        "launches": emb["b3_counts"]["launches_fwd"],
        "max_abs_err": b3e["max_abs_err"], "ms": b3e["ms"],
        "plain_ms": b3e["plain_ms"], "bound_ms": b3e["bound_ms"],
        "bound_by": b3e["bound_by"], "library_ms": b3e["library_ms"]})
    # B3 on the contiguous path: every admission's prefill (the 8 serve
    # prompts in one 8 x 2048 group), timed a layer at that shape
    con = serve["contiguous"]
    b3c = con["b3_layer"]
    rows.append({
        "name": f"flash_attention forward (contiguous admission: B 8 x S "
                f"{MAX_CTX}, one layer)",
        "route": "cuda",
        "source": "cloud_server_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cloud_server_tpu/ops/flash_attention.py:70",
        "launches": con["server"]["b3_counts"]["launches_fwd"],
        "max_abs_err": b3c["max_abs_err"], "ms": b3c["ms"],
        "plain_ms": b3c["plain_ms"], "bound_ms": b3c["bound_ms"],
        "bound_by": b3c["bound_by"], "library_ms": b3c["library_ms"]})
    n, d, v = CE_SHAPE
    for name, line, key, launches, err in (
            ("fused_ce forward (TMA + wgmma)", 81, "b7",
             train["ce_counts"]["launches_fwd"],
             max(ce["errors"]["logz"]["max_abs_err"],
                 ce["errors"]["tl"]["max_abs_err"])),
            ("fused_ce dx backward (TMA + wgmma: d, then d @ head^T)", 131,
             "b8",
             train["ce_counts"]["launches_dx"],
             ce["errors"]["dx"]["max_abs_err"])):
        rows.append({
            "name": f"{name} (N {n}, D {d}, V {v})", "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"cloud_server_tpu/ops/fused_ce.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": ce[f"{key}_ms"], "plain_ms": ce[f"plain_{key}_ms"],
            "bound_ms": ce["bound_ms"][key], "bound_by": ce["bound_by"][key],
            "library_ms": ce[f"library_{key}_ms"]})
    # the MoE path's launches (the moe phase's runs) beside each row's
    mc = moe["serve"]["counts"]
    md, mf = (moe["train"]["runs"][k]["counts"]
              for k in ("moe_dense", "moe_fused_ce"))
    moe_launches = {
        "(decode case)": mc["launches_narrow"],
        "(prefill case)": mc["launches_wide"],
        "flash_attention forward (contiguous":
            moe["contiguous"]["b3_counts"]["launches_fwd"],
        "flash_attention forward (B": md["flash"]["launches_fwd"]
            + mf["flash"]["launches_fwd"],
        "flash_attention dK/dV": md["flash"]["launches_bwd_dkdv"],
        "flash_attention dQ": md["flash"]["launches_bwd_dq"],
        "flash_attention fused backward": mf["flash"]["launches_bwd_fused"],
        "fused_ce forward": mf["fused_ce"]["launches_fwd"],
        "fused_ce dx": mf["fused_ce"]["launches_dx"]}
    for row in rows:
        row["launches_moe"] = next(
            (n for key, n in moe_launches.items() if key in row["name"]), 0)
    # the pack phase's launches: packed steps, remat policies, evaluation
    pc, pce = pack["counts"], pack["ce_counts"]
    pack_launches = {
        "flash_attention forward (B": pc["launches_fwd"],
        "flash_attention dK/dV": pc["launches_bwd_dkdv"],
        "flash_attention dQ": pc["launches_bwd_dq"],
        "flash_attention fused backward": pc["launches_bwd_fused"],
        "fused_ce forward": pce["launches_fwd"],
        "fused_ce dx": pce["launches_dx"]}
    for row in rows:
        row["launches_pack"] = next(
            (n for key, n in pack_launches.items() if key in row["name"]), 0)
    # the hf phase's serve on the kernels
    hf_launches = {"(decode case)": hf["counts"]["launches_narrow"],
                   "(prefill case)": hf["counts"]["launches_wide"]}
    for row in rows:
        row["launches_hf"] = next(
            (n for key, n in hf_launches.items() if key in row["name"]), 0)
    # this slice's per-rank shapes, with the ptrain phase's launches
    # summed over its ranks (tp 2: one rank's heads and vocabulary rows;
    # Ulysses at sp 2: H/sp heads over the whole sequence)
    pcases = ptrain["cases"]

    def rank_sum(case, group, key):
        return sum(r[group][key] for r in pcases[case]["ranks"])

    for name, line, case, key, launches, errs in (
            ("flash_attention forward", 70, "tp2_heads", "fwd",
             rank_sum("tp2", "counts", "launches_fwd"), ("out",)),
            ("flash_attention dK/dV backward", 205, "tp2_heads", "bwd_dkdv",
             rank_sum("tp2", "counts", "launches_bwd_dkdv"), ("dk", "dv")),
            ("flash_attention dQ backward", 295, "tp2_heads", "bwd_dq",
             rank_sum("tp2", "counts", "launches_bwd_dq"), ("dq",)),
            ("flash_attention forward", 70, "ulysses_sp2", "fwd",
             rank_sum("sp2_ulysses", "counts", "launches_fwd"), ("out",)),
            ("flash_attention fused backward", 261, "ulysses_sp2",
             "bwd_fused",
             rank_sum("sp2_ulysses", "counts", "launches_bwd_fused"),
             ("dq", "dk", "dv"))):
        k = pkern["flash"][case]
        where = ("one tp 2 rank's heads" if case == "tp2_heads"
                 else "Ulysses at sp 2, whole sequence")
        rows.append({
            "name": f"{name} ({where}: B {k['B']}, S {k['S']}, H {k['H']},"
                    f" KH {k['KH']})",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"cloud_server_tpu/ops/flash_attention.py:{line}",
            "launches": launches,
            "max_abs_err": max(k["errors"][e]["max_abs_err"] for e in errs),
            "ms": k[f"{key}_ms"],
            "plain_ms": k["plain_fwd_ms" if key == "fwd"
                          else "plain_bwd_ms"],
            "bound_ms": k["bound_ms"][key], "bound_by": k["bound_by"][key],
            "library_ms": k["library_fwd_ms" if key == "fwd"
                            else "library_bwd_ms"]})
    shard = pkern["tp2_shard"]
    for name, line, key, launches, err in (
            ("fused_ce forward", 81, "b7",
             rank_sum("tp2", "ce_counts", "launches_fwd"),
             max(shard["errors"]["logz"]["max_abs_err"],
                 shard["errors"]["tl"]["max_abs_err"])),
            ("fused_ce dx backward", 131, "b8",
             rank_sum("tp2", "ce_counts", "launches_dx"),
             shard["errors"]["dx"]["max_abs_err"])):
        rows.append({
            "name": f"{name} (one tp 2 rank's vocabulary rows: N "
                    f"{shard['N']}, D {shard['D']}, V {shard['V']})",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"cloud_server_tpu/ops/fused_ce.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": shard[f"{key}_ms"], "plain_ms": shard[f"plain_{key}_ms"],
            "bound_ms": shard["bound_ms"][key],
            "bound_by": shard["bound_by"][key],
            "library_ms": shard[f"library_{key}_ms"]})
    # the pipeline's and the experts' cases: B3-B5 on one stage's
    # microbatch (B 2 of 4 at pp 2) and beside the ep-sharded experts
    # (Mixtral, B 2), B7/B8 on every stage's whole vocabulary and on
    # Mixtral's, with the ptrain phase's launches per rank
    for case, kcase, fcase, where in (
            ("pp2", None, "b2_s2048", "one pipeline stage at pp 2, a "
                                      "microbatch"),
            ("ep2", "ep2_moe", "b4_s2048", "beside experts over ep 2")):
        k = pkern["flash"][fcase]
        for name, line, key, ckey, errs in (
                ("flash_attention forward", 70, "fwd", "launches_fwd",
                 ("out",)),
                ("flash_attention dK/dV backward", 205, "bwd_dkdv",
                 "launches_bwd_dkdv", ("dk", "dv")),
                ("flash_attention dQ backward", 295, "bwd_dq",
                 "launches_bwd_dq", ("dq",))):
            per_rank = [r["counts"][ckey] for r in pcases[case]["ranks"]]
            rows.append({
                "name": f"{name} ({where}: B {k['B']}, S {k['S']}, H "
                        f"{k['H']}, KH {k['KH']})",
                "route": "cuda",
                "source": "cloud_server_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"cloud_server_tpu/ops/flash_attention.py:{line}",
                "launches": sum(per_rank), "launches_per_rank": per_rank,
                "max_abs_err": max(k["errors"][e]["max_abs_err"]
                                   for e in errs),
                "ms": k[f"{key}_ms"],
                "plain_ms": k["plain_fwd_ms" if key == "fwd"
                              else "plain_bwd_ms"],
                "bound_ms": k["bound_ms"][key],
                "bound_by": k["bound_by"][key],
                "library_ms": k["library_fwd_ms" if key == "fwd"
                                else "library_bwd_ms"]})
        shard = ce if kcase is None else pkern[kcase]
        for name, line, key, ckey, err in (
                ("fused_ce forward", 81, "b7", "launches_fwd",
                 max(shard["errors"]["logz"]["max_abs_err"],
                     shard["errors"]["tl"]["max_abs_err"])),
                ("fused_ce dx backward", 131, "b8", "launches_dx",
                 shard["errors"]["dx"]["max_abs_err"])):
            per_rank = [r["ce_counts"][ckey] for r in pcases[case]["ranks"]]
            rows.append({
                "name": f"{name} ({where}: N {shard['N']}, D "
                        f"{shard['D']}, V {shard['V']})",
                "route": "cuda",
                "source": "cloud_server_tpu_torch/csrc/fused_ce.cu",
                "replaces": f"cloud_server_tpu/ops/fused_ce.py:{line}",
                "launches": sum(per_rank), "launches_per_rank": per_rank,
                "max_abs_err": err, "ms": shard[f"{key}_ms"],
                "plain_ms": shard[f"plain_{key}_ms"],
                "bound_ms": shard["bound_ms"][key],
                "bound_by": shard["bound_by"][key],
                "library_ms": shard[f"library_{key}_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
