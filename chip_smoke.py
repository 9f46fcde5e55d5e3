#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together), then runs these phases and prints one JSON line for
each:

  1. device   — the card, its power limit (nvidia-smi), the build time
                and every kernel's registers, spills and shared memory;
  2. kernel   — the paged-attention kernel against its plain PyTorch
                version on the card at Llama-3.1-8B's head shapes (decode,
                prefill and a ragged mixed batch with a length-0 slot),
                with the kernel's, the plain version's and one PyTorch
                library call's times beside the card's lower bound; then
                each case again on the int8 cache (kernel_int8 lines: the
                int8 branch against the int8 plain version, its time
                beside the bf16 kernel's, SDPA over the dequantized cache
                as the library yardstick);
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
                their plain version at N 8192 x D 4096 x V 128256, with
                the cuBLAS products alone as the library yardstick;
  3. serve    — PagedInferenceServer at the full Llama-3.1-8B width (all
                32 layers, random bf16 weights from a seed) serving 8
                greedy requests; a second run on a fresh server must give
                the same tokens, and a 2-layer slice of the model must
                give the plain dense forward's logits through the paged
                kernel path; one steady decode step of 8 seeded requests
                timed with the threefry draw and with the earlier hash
                draw;
     profile  — one mixed (prefill + decode) step and one steady decode
                step under torch.profiler: wall time, device busy time
                and idle share, the busiest kernels;
     serve_int8 — the same 8 requests on the int8 KV cache (same params):
                the pool's bytes against the bf16 pool's, the int8
                kernels' launches and no plain call, the share of tokens
                equal to the bf16 run; a 2-layer slice through the int8
                kernel against the int8 plain path; then HttpFrontend on
                127.0.0.1 over an int8 server with the 8 requests streamed
                concurrently through /v1/completions (32 tokens and
                [DONE] each, /metrics counting them, /v1/embeddings a
                501) and the client's TTFT and ITL;
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
  5. ckpt     — 1 layer at full width with the fused CE: 4 steps
                straight; 2 steps with an async checkpoint, restored bit
                for bit; a resumed run to 4 against the straight run;
                the checkpoint served (restored params and
                `generate --checkpoint-dir`) with the in-memory params'
                tokens; bytes and write/read rates;
  6. kernels  — each ported kernel with the TPU kernel it replaces, its
                launches on phases 3 and 4 (the int8 rows: the HTTP run)
                and its numbers from phase 2.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is non-zero. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
`--kernel-only` stops after phase 2 (a quick check of a kernel change)
and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time

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


def make_case(gen, lengths, widths, w):
    """Random bf16 pools (2 layers) and a distinct random paging of every
    slot's context at Llama-3.1-8B's head shapes."""
    import torch
    b = len(lengths)
    mp = MAX_CTX // PS
    num_pages = b * mp + 3
    dev = DEVICE
    k_pool = torch.randn((2, num_pages, KH, DH, PS), generator=gen,
                         device=dev).to(torch.bfloat16)
    v_pool = torch.randn((2, num_pages, KH, DH, PS), generator=gen,
                         device=dev).to(torch.bfloat16)
    q = torch.randn((b, w, H, DH), generator=gen, device=dev).to(
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
    lens = [int(x) for x in lengths.tolist()]
    wids = [int(x) for x in widths.tolist()]
    nbytes = 2 * q.numel() * 2 + 16 * b
    ops = 0
    for n, wd in zip(lens, wids):
        nbytes += 2 * n * KH * (DH * kv_elem + scale_bytes)
        # row j of the window sees keys [0, n - wd + j]
        ops += 4 * DH * h * sum(n - wd + j + 1 for j in range(wd))
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
    k = k.repeat_interleave(H // KH, dim=1).contiguous()
    v = v.repeat_interleave(H // KH, dim=1).contiguous()
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


def phase_kernel() -> dict:
    """Each case in bf16, then on the int8 cache: the same bf16 pools
    quantized by the port's quantize_pool."""
    import torch
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    from cloud_server_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    cases = {
        "decode": ([1537, 2048, 977, 1800, 64, 1200, 1501, 333],
                   [1] * 8, 1),
        "prefill": ([2048, 1400], [256, 256], 256),
        "ragged": ([1700, 900, 1024, 77, 0], [1, 1, 256, 77, 0], 256),
    }
    layer = 1
    results = {}
    for name, (lens, wids, w) in cases.items():
        q, kp, vp, lengths, tables, widths = make_case(gen, lens, wids, w)
        b, _, h, d = q.shape
        g = h // KH
        valid = torch.arange(w, device=DEVICE)[None, :] < widths[:, None]
        valid &= (lengths > 0)[:, None]
        # the raw C entries the wrapper calls, on preallocated buffers
        qg = q.reshape(b, w, KH, g, d).permute(0, 2, 1, 3, 4).reshape(
            b, KH, w * g, d).contiguous()
        out = torch.empty_like(qg)
        stream = torch.cuda.current_stream().cuda_stream
        tail = (lengths.data_ptr(), tables.data_ptr(), widths.data_ptr(),
                out.data_ptr(), b, KH, w * g, g, d, kp.shape[1], PS,
                tables.shape[1], layer, d ** -0.5, 1, stream)

        def launcher(fn, *pools):
            def launch():
                err_code = fn(qg.data_ptr(), *pools, *tail)
                if err_code:
                    raise RuntimeError(f"kernel launch failed: {err_code}")
            return launch

        pa.reset_counters()
        got = pa.paged_attention(q, kp, vp, lengths, tables, layer,
                                 widths=widths)
        torch.cuda.synchronize()
        if pa.launches_narrow + pa.launches_wide != 1:
            raise RuntimeError(f"{name}: the kernel was not launched")
        want = pa.paged_attention_ref(q, kp, vp, lengths, tables, layer,
                                      widths=widths)
        errs = kernel_errors(name, got, want, valid, (ATOL, RTOL, REL_RMS))
        ms = time_ms(launcher(pa._kernel(), kp.data_ptr(), vp.data_ptr()),
                     iters=50)
        plain_ms = time_ms(lambda: pa.paged_attention_ref(
            q, kp, vp, lengths, tables, layer, widths=widths), iters=10)
        library_ms = time_ms(library_call(q, kp, vp, lengths, tables,
                                          widths, layer), iters=20)
        bms, by = bound_ms(q, lengths, widths)
        res = {"phase": "kernel", "case": name, "B": b, "W": w,
               "class": "narrow" if pa.is_narrow(b, w) else "wide",
               "lengths": lens, "widths": wids, **errs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bms, "bound_by": by}
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
        if (c["launches_narrow_int8"] + c["launches_wide_int8"] != 1
                or c["launches_narrow"] + c["launches_wide"] != 0):
            raise RuntimeError(f"{name} int8: launches {c}")
        want = pa.paged_attention_ref(q, kq, vq, lengths, tables, layer,
                                      widths=widths, **scales)
        errs = kernel_errors(f"{name} int8", got, want, valid, INT8_TOL)
        launch8 = launcher(pa._kernel(int8=True), kq.data_ptr(),
                           vq.data_ptr(), ks.data_ptr(), vs.data_ptr())
        ms8 = time_ms(launch8, iters=50)
        plain8 = time_ms(lambda: pa.paged_attention_ref(
            q, kq, vq, lengths, tables, layer, widths=widths, **scales),
            iters=10)
        # library yardstick: SDPA over the DEQUANTIZED bf16 cache (the
        # dequantization, and the gather, are not timed)
        kd = (kq.float() * ks[:, :, :, None, :]).to(torch.bfloat16)
        vd = (vq.float() * vs[:, :, :, None, :]).to(torch.bfloat16)
        library8 = time_ms(library_call(q, kd, vd, lengths, tables, widths,
                                        layer), iters=20)
        # bf16 again in the same turn, beside the int8 time
        bf16_again = time_ms(launcher(pa._kernel(), kp.data_ptr(),
                                      vp.data_ptr()), iters=50)
        bms8, by8 = bound_ms(q, lengths, widths, kv_elem=1, scale_bytes=4)
        res8 = {"phase": "kernel_int8", "case": name, "B": b, "W": w,
                "class": "narrow" if pa.is_narrow(b, w) else "wide",
                **errs, "ms": ms8, "bf16_ms": [ms, bf16_again],
                "plain_ms": plain8,
                "library_ms": library8,
                "library": "SDPA over the gathered dequantized bf16 cache",
                "bound_ms": bms8, "bound_by": by8}
        emit(res8)
        results[f"{name}_int8"] = res8
        del q, kp, vp, kq, vq, ks, vs, kd, vd, got, want, qg, out
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serving at Llama-3.1-8B width
# ---------------------------------------------------------------------------

PROMPT_LENS = [64, 200, 350, 500, 700, 900, 1200, 1500]
MAX_NEW = 32


def make_server(params, cfg, icfg):
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    return PagedInferenceServer(params, cfg, icfg, max_slots=8,
                                max_context=MAX_CTX, page_size=PS,
                                prefill_chunk=256, seed=SEED, device=DEVICE)


def serve_once(params, cfg, icfg, prompts):
    """The 8 requests on a fresh server: (requests, start, end, bytes of
    the server's page pools)."""
    import torch
    srv = make_server(params, cfg, icfg)
    pool_bytes = srv.kv_cache_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    srv.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    del srv
    return reqs, t0, t_end, pool_bytes


def check_served(reqs, vocab) -> None:
    for r in reqs:
        if r.finish_reason != "length" or len(r.tokens) != MAX_NEW:
            raise RuntimeError(f"request ended {r.finish_reason!r} with "
                               f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise RuntimeError("token id out of the vocabulary")


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
    ("fused_ce", ("ce_fwd", "ce_dlogits", "ce_dx")),
    ("paged_attention", ("paged_attention",)),
    ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("copy", ("memcpy", "memset")),
)


def profile_step(step) -> dict:
    """One call of `step` (a scheduler or train step) under
    torch.profiler: its wall time, the device time of every kernel and
    copy it ran, and the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    busy = sum(per_name.values())
    # kernel names are long templates: sum the names that share their
    # first 100 characters, so one entry never hides another
    short: dict[str, float] = {}
    for name, ms in per_name.items():
        short[name[:100]] = short.get(name[:100], 0.0) + ms
    top = sorted(short.items(), key=lambda kv: -kv[1])[:10]
    groups: dict[str, float] = {}
    for name, ms in per_name.items():
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_ms": wall_ms, "device_kernels": n_kernels,
            "device_busy_ms": busy if per_name else None,
            "device_idle_share": (1 - busy / wall_ms) if per_name else None,
            "device_ms_by_group": groups,
            "top_device_ms": dict(top)}


def phase_profile(params, cfg, icfg, prompts) -> dict:
    """Where one mixed (prefill) step and one steady decode step spend
    their time, on a fresh server with a longer decode budget so the
    decode step runs its full decode_chunk rounds."""
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    srv = PagedInferenceServer(params, cfg, icfg, max_slots=8,
                               max_context=MAX_CTX, page_size=PS,
                               prefill_chunk=256, seed=SEED, device=DEVICE)
    for p in prompts:
        srv.submit(p, max_new_tokens=96)
    srv.step()  # warm-up: the first iteration pays one-time set-up
    mixed = profile_step(srv.step)
    while srv._jobs or srv.num_pending:
        srv.step()
    decode = profile_step(srv.step)
    srv.stop()
    out = {"phase": "profile", "kv_cache_dtype": cfg.kv_cache_dtype,
           "mixed_step": mixed, "decode_step": decode,
           "decode_rounds_per_step": srv.decode_chunk, "live_slots": 8}
    emit(out)
    return out


_MIX = (0x9E3779B97F4A7C15 - (1 << 64), 0xBF58476D1CE4E5B9 - (1 << 64),
        0x94D049BB133111EB - (1 << 64))


def _hash_row_draw(logits, rows, positions, **kw):
    """The per-row draw the port made before it drew from threefry (a
    splitmix64 hash of (seed, position, token id) into uniforms, then a
    Gumbel argmax): the "before" side of the seeded decode step's time."""
    import torch
    from cloud_server_tpu_torch.inference import sampling

    def srl(x, k):
        return (x >> k) & ((1 << (64 - k)) - 1)

    def mix(x):
        x = (x ^ srl(x, 30)) * _MIX[1]
        x = (x ^ srl(x, 27)) * _MIX[2]
        return x ^ srl(x, 31)

    positions = torch.as_tensor(positions, device=logits.device)
    filt, raw = sampling.filtered_logits_rows(logits, rows,
                                              positions=positions, **kw)
    key = mix(rows.seed.long() * _MIX[0] + positions.long())
    idx = torch.arange(1, logits.shape[-1] + 1, device=logits.device)
    top = srl(mix(key[:, None] ^ (idx[None, :] * _MIX[0])), 11).double()
    u = ((top + 0.5) * 2.0 ** -53).float().clamp_(1e-20, 1 - 1e-7)
    sampled = torch.argmax(filt - torch.log(-torch.log(u)), dim=-1)
    return torch.where(rows.temperature <= 0.0, raw.argmax(-1), sampled)


def seeded_decode_steps(params, cfg, icfg, prompts) -> dict:
    """One steady decode step of 8 seeded requests (temperature 0.8, each
    its own seed), timed with the threefry draw and with the earlier hash
    draw swapped in, in turns (hash, threefry, threefry, hash)."""
    import torch
    from cloud_server_tpu_torch.inference import paged_server
    from cloud_server_tpu_torch.inference.sampling import SamplingParams
    srv = paged_server.PagedInferenceServer(
        params, cfg, icfg, max_slots=8, max_context=MAX_CTX, page_size=PS,
        prefill_chunk=256, seed=SEED, device=DEVICE)
    for i, p in enumerate(prompts):
        srv.submit(p, max_new_tokens=512,
                   sampling=SamplingParams(seed=1000 + i, temperature=0.8))
    while srv._jobs or srv.num_pending:
        srv.step()
    srv.step()  # the first decode-only step
    threefry = paged_server.sample_logits_rows
    times: dict = {"hash": [], "threefry": []}
    try:
        for name in ("hash", "threefry", "threefry", "hash"):
            paged_server.sample_logits_rows = (
                _hash_row_draw if name == "hash" else threefry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        paged_server.sample_logits_rows = threefry
    if srv.num_active != 8:
        raise RuntimeError("the seeded decode steps did not keep 8 slots")
    srv.stop()
    return {"seeded_decode_step_ms_hash_draw": times["hash"],
            "seeded_decode_step_ms_threefry_draw": times["threefry"],
            "seeded_decode_rounds_per_step": srv.decode_chunk}


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


def http_run(srv, prompts) -> dict:
    """HttpFrontend on 127.0.0.1:0 over a started server: 8 concurrent
    streaming /v1/completions, then /metrics and a 501 for
    /v1/embeddings."""
    import urllib.error
    import urllib.request
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    front = HttpFrontend(srv, tokenizer=IdTokenizer()).start()
    try:
        host, port = front.address
        addr = f"{host}:{port}"
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
            raise RuntimeError(f"HTTP clients failed:\n{proc.stderr[-4000:]}")
        results = json.loads(proc.stdout.strip().splitlines()[-1])
        for i, r in enumerate(results):
            if not (r["done"] and len(r["ids"]) == MAX_NEW
                    and r["finish_reason"] == "length"):
                raise RuntimeError(f"HTTP request {i}: {len(r['ids'])} "
                                   f"tokens, finish {r['finish_reason']}, "
                                   f"[DONE] {r['done']}")
        with urllib.request.urlopen(f"http://{addr}/metrics",
                                    timeout=60) as resp:
            prom = dict(ln.rsplit(" ", 1)
                        for ln in resp.read().decode().splitlines()
                        if ln and not ln.startswith("#"))
        want = {"cloud_server_requests_submitted_total": len(prompts),
                "cloud_server_ttft_seconds_count": len(prompts),
                "cloud_server_itl_seconds_count": len(prompts)
                * (MAX_NEW - 1),
                "cloud_server_tokens_emitted_total": len(prompts) * MAX_NEW}
        seen = {k: float(prom[k]) for k in want}
        if seen != {k: float(v) for k, v in want.items()}:
            raise RuntimeError(f"/metrics counts {seen}, expected {want}")
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/v1/embeddings",
                data=json.dumps({"input": [1, 2, 3]}).encode()), timeout=60)
            emb = 200
        except urllib.error.HTTPError as err:
            emb = err.code
        if emb != 501:
            raise RuntimeError(f"/v1/embeddings answered {emb}, not 501")
    finally:
        front.stop()
    ttft = sorted(r["times"][0] - r["t0"] for r in results)
    itl = sorted(b - a for r in results
                 for a, b in zip(r["times"], r["times"][1:]))
    return {"http_requests": len(prompts), "http_wall_s": wall,
            "http_ttft_p50_s": ttft[len(ttft) // 2],
            "http_ttft_max_s": ttft[-1],
            "http_itl_p50_s": itl[len(itl) // 2],
            "http_itl_p99_s": itl[min(len(itl) - 1, int(0.99 * len(itl)))],
            "http_metrics": seen, "embeddings_status": emb,
            "http_ids": [r["ids"] for r in results]}


def serve_int8(params, cfg, icfg, prompts, bf16_tokens, bf16_bytes) -> dict:
    """The serving phase's 8 requests on the int8 cache: in process (the
    pool's bytes, the kernels' launches, agreement with the bf16 run),
    the int8 kernel path against the int8 plain path on one request,
    then the same requests over HTTP, streamed concurrently."""
    import dataclasses
    import torch
    from cloud_server_tpu_torch.ops import paged_attention as pa
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    pa.reset_counters()
    reqs, t_start, t_end, pool_bytes = serve_once(params, cfg8, icfg,
                                                  prompts)
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
    same = sum(a == b for x, y in zip(toks, bf16_tokens)
               for a, b in zip(x, y))
    agree = check_int8_agreement(params, cfg, prompts[2])
    out = {"phase": "serve_int8", "kv_cache_dtype": "int8",
           **serving_rates(reqs, t_start, t_end), "peak_mem_gb": peak / 1e9,
           "kv_pool_bytes": pool_bytes, "bf16_kv_pool_bytes": bf16_bytes,
           "kv_pool_ratio": pool_bytes / bf16_bytes, "counts": counts,
           "tokens_equal_to_bf16_share": same / (len(toks) * MAX_NEW),
           **agree}

    del reqs
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(params, cfg8, icfg, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    srv = make_server(params, cfg8, icfg).start()
    try:
        pa.reset_counters()
        http = http_run(srv, prompts)
        torch.cuda.synchronize()
        http_counts = pa.counters()
    finally:
        srv.stop()
    if (http_counts["launches_narrow_int8"] <= 0
            or http_counts["launches_wide_int8"] <= 0
            or http_counts["plain_calls"]):
        raise RuntimeError(f"int8 HTTP serve: launches {http_counts}")
    ids = http.pop("http_ids")
    out.update(http, http_counts=http_counts,
               http_tokens_equal_to_in_process_share=sum(
                   a == b for x, y in zip(ids, toks)
                   for a, b in zip(x, y)) / (len(toks) * MAX_NEW))
    emit(out)
    print(f"int8 HTTP: TTFT p50 {out['http_ttft_p50_s']:.4f} s, max "
          f"{out['http_ttft_max_s']:.4f} s; ITL p50 "
          f"{out['http_itl_p50_s']:.4f} s, p99 {out['http_itl_p99_s']:.4f} s",
          flush=True)
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
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENS]

    torch.cuda.reset_peak_memory_stats()
    pa.reset_counters()
    reqs, t_start, t_end, pool_bytes = serve_once(params, cfg, icfg,
                                                  prompts)
    counts = pa.counters()
    peak = torch.cuda.max_memory_allocated()
    check_served(reqs, cfg.vocab_size)
    if counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0:
        raise RuntimeError(f"kernel classes not both launched: {counts}")
    if counts["plain_calls"] != 0:
        raise RuntimeError(f"plain attention ran on the path: {counts}")

    reqs2, _, _, _ = serve_once(params, cfg, icfg, prompts)
    same = [r.tokens for r in reqs] == [r.tokens for r in reqs2]
    del reqs2
    if not same:
        raise RuntimeError("a second run of the same requests gave other "
                           "tokens")
    dense = check_dense_agreement(params, cfg, prompts[2])
    out = {"phase": "serve", "model": "Llama-3.1-8B (random bf16 weights)",
           "layers": cfg.num_layers, "requests": len(reqs),
           "prompt_tokens": sum(PROMPT_LENS), "max_new_tokens": MAX_NEW,
           "init_s": init_s, **serving_rates(reqs, t_start, t_end),
           "peak_mem_gb": peak / 1e9, "kv_pool_bytes": pool_bytes,
           "counts": counts, "second_run_identical": same, **dense,
           **seeded_decode_steps(params, cfg, icfg, prompts)}
    emit(out)
    phase_profile(params, cfg, icfg, prompts)
    tokens = [r.tokens for r in reqs]
    del reqs
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = serve_int8(params, cfg, icfg, prompts, tokens, pool_bytes)
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


def flash_bound(pairs_h, nbytes, ops_per_pair_per_dh, dh) -> tuple:
    ops = ops_per_pair_per_dh * dh * pairs_h * H
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


def phase_train_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from cloud_server_tpu_torch.ops import flash_attention as fl
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    results = {}
    failures = []
    for name, (b, s, docs, dh) in FLASH_CASES.items():
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE).to(
                torch.bfloat16)
        q, k, v = rnd(b, s, H, dh), rnd(b, s, KH, dh), rnd(b, s, KH, dh)
        dout = rnd(b, s, H, dh)
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
        lse_t = torch.empty((b, H, s_pad), dtype=torch.float32,
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
        dims = (b, H, KH, s_pad, dh)

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
        qb = b * s * H * dh * e2
        kvb = b * s * KH * dh * e2
        lb = b * H * s * 4
        bounds = {"fwd": flash_bound(pairs, 2 * qb + 2 * kvb + lb, 4, dh)}
        if fused:
            bounds["bwd_fused"] = flash_bound(
                pairs, 4 * qb + 4 * kvb + lb, 10, dh)
        else:
            bounds["bwd_dkdv"] = flash_bound(
                pairs, 3 * qb + 4 * kvb + lb, 8, dh)
            bounds["bwd_dq"] = flash_bound(
                pairs, 3 * qb + 2 * kvb + 2 * lb, 6, dh)
            # the pair as one function: q, k, v, o, dO and the LSE read
            # once, dQ, dK, dV written once; 10 * Dh per visible pair
            bounds["bwd_pair"] = flash_bound(
                pairs, 4 * qb + 4 * kvb + lb, 10, dh)

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
        kl = kl.repeat_interleave(H // KH, dim=1).requires_grad_(True)
        vl = vl.repeat_interleave(H // KH, dim=1).requires_grad_(True)
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
               "H": H, "KH": KH, "Dh": dh, "segments_per_row": docs,
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


def phase_ce_kernel() -> dict:
    import torch
    from cloud_server_tpu_torch.ops import fused_ce as fc
    from cloud_server_tpu_torch.ops import matmul_f32
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, v = CE_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 3)
    x = torch.randn((n, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    head = (torch.randn((d, v), generator=gen, device=DEVICE)
            * d ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, v, (n,), generator=gen, device=DEVICE)
    gz = torch.full((n,), 1.0 / n, device=DEVICE)
    gt = -gz

    def run(fn):
        xx = x.clone().requires_grad_(True)
        hh = head.clone().requires_grad_(True)
        logz, tl, am = fn(xx, hh, t)
        ((logz * gz).sum() + (tl * gt).sum()).backward()
        return logz.detach(), tl.detach(), am, xx.grad, hh.grad

    # the wrapper, forward and backward, with its launch counts
    fc.reset_counters()
    got = run(fc.fused_ce_stats)
    torch.cuda.synchronize()
    if fc.counters() != {"launches_fwd": 1, "launches_dx": 1,
                         "plain_calls": 0}:
        raise RuntimeError(f"fused CE launches {fc.counters()}")
    want = run(fc.fused_ce_stats_ref)
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

    # one B7 call and one B8 call of the wrapper's own launch functions
    t32 = t.to(torch.int32)
    times = {"b7_ms": time_ms(lambda: fc.forward_stats(x, head, t32),
                              iters=5, warmup=1),
             "b8_ms": time_ms(lambda: fc.backward_dx(x, head, t32, logz, gz,
                                                     gt), iters=3, warmup=1)}
    dbuf, _ = fc.backward_dx(x, head, t32, logz, gz, gt)
    with torch.no_grad():
        times["plain_b7_ms"] = time_ms(
            lambda: fc.fused_ce_stats_ref(x, head, t), iters=3, warmup=1)
        times["plain_b8_ms"] = time_ms(
            lambda: matmul_f32(fc._dlogits_ref(x, head, t, logz, gz, gt),
                               head.t()).to(x.dtype), iters=3, warmup=1)
    # library yardstick: the cuBLAS products alone, without the epilogues
    times["library_b7_ms"] = time_ms(
        lambda: torch.mm(x, head, out_dtype=torch.float32), iters=5,
        warmup=1)
    times["library_b8_ms"] = time_ms(
        lambda: (torch.mm(x, head, out_dtype=torch.float32),
                 torch.mm(dbuf, head.t(), out_dtype=torch.float32)),
        iters=3, warmup=1)
    b7b, b8b = ce_bound(n, d, v, False), ce_bound(n, d, v, True)
    out = {"phase": "ce_kernel", "N": n, "D": d, "V": v,
           "vocab_splits": fc.vocab_splits(n, v, x.device), "errors": errs,
           **times,
           "bound_ms": {"b7": b7b[0], "b8": b8b[0]},
           "bound_by": {"b7": b7b[1], "b8": b8b[1]}}
    emit(out)
    del x, head, dbuf
    gc.collect()
    torch.cuda.empty_cache()
    bad = [k for k, e in errs.items() if not e["within"]]
    if bad:
        raise RuntimeError(f"fused CE kernels differ from the plain version "
                           f"beyond the stated bounds: {bad}")
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


def train_run(tag, extra, config=TRAIN_CONFIG) -> tuple:
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
    state = train.main(["--config", config, "--synthetic", "64",
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
    loss, _ = transformer.next_token_loss(p, {"tokens": toks}, cfg)
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


def profile_train_step(cfg, tcfg, state) -> dict:
    """One more step of a run's final state under the profiler."""
    import torch
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.data.loader import _collate, to_device
    from cloud_server_tpu_torch.training.train_step import make_train_step
    step_fn = make_train_step(cfg, tcfg)
    ds = SyntheticLMDataset(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size,
                            seed=SEED)
    batch = to_device(_collate(ds, range(tcfg.batch_size)),
                      torch.device(DEVICE))
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
        Checkpointer, abstract_train_state, restore_params)
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

    # serve the checkpoint: in-memory params, restored params, the CLI
    mem = {g: {n: t.detach() for n, t in leaves.items()}
           for g, leaves in resumed.params.items()}
    toks_mem = serve_greedy(mem, cfg)
    del resumed, mem
    gc.collect()
    torch.cuda.empty_cache()
    toks_ck = serve_greedy(restore_params(ckpt_dir, cfg, device=DEVICE), cfg)
    if toks_ck != toks_mem:
        raise RuntimeError(f"restored params serve {toks_ck}, in-memory "
                           f"params {toks_mem}")
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
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
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
           "served_tokens": toks_mem, "restored_serve_identical": True,
           "generate_checkpoint_dir_identical": True}
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

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()  # each phase frees its model and buffers
        return out

    dev = timed(phase_device)
    kern = timed(phase_kernel)
    fkern = timed(phase_train_kernel)
    timed(phase_unembed)
    ce = timed(phase_ce_kernel)
    if "--kernel-only" in sys.argv[1:]:
        return 0  # a quick check of a kernel change; prints no result
    serve = timed(phase_serve)
    train = timed(phase_train)
    timed(phase_ckpt)
    emit({"phase_seconds": seconds})
    counts = serve["counts"]
    wide_err = max(kern["prefill"]["max_abs_err"],
                   kern["ragged"]["max_abs_err"])
    rows = []
    # the int8 rows: launches from the int8 cache served over HTTP
    counts8 = serve["int8"]["http_counts"]
    wide_err8 = max(kern["prefill_int8"]["max_abs_err"],
                    kern["ragged_int8"]["max_abs_err"])
    for cls, case, line, launches, err, branch in (
            ("narrow", "decode", 96, counts["launches_narrow"],
             kern["decode"]["max_abs_err"], ""),
            ("wide", "prefill", 434, counts["launches_wide"], wide_err, ""),
            ("narrow", "decode_int8", 96, counts8["launches_narrow_int8"],
             kern["decode_int8"]["max_abs_err"], " (int8 branch)"),
            ("wide", "prefill_int8", 434, counts8["launches_wide_int8"],
             wide_err8, " (int8 branch)")):
        k = kern[case]
        rows.append({
            "name": f"paged_attention ({cls} class, {case} case)",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"cloud_server_tpu/ops/paged_attention.py:{line}"
                        f"{branch}",
            "launches": launches, "max_abs_err": err, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
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
    n, d, v = CE_SHAPE
    for name, line, key, launches, err in (
            ("fused_ce forward", 81, "b7", train["ce_counts"]["launches_fwd"],
             max(ce["errors"]["logz"]["max_abs_err"],
                 ce["errors"]["tl"]["max_abs_err"])),
            ("fused_ce dx backward (d, then d @ head^T)", 131, "b8",
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
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
