#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, then runs four phases and
prints one JSON line for each:

  1. device   — the card, its power limit (nvidia-smi), the build time;
  2. kernel   — the paged-attention kernel against its plain PyTorch
                version on the card at Llama-3.1-8B's head shapes (decode,
                prefill and a ragged mixed batch with a length-0 slot),
                with the kernel's, the plain version's and one PyTorch
                library call's times beside the card's lower bound;
  3. serve    — PagedInferenceServer at the full Llama-3.1-8B width (all
                32 layers, random bf16 weights from a seed) serving 8
                greedy requests; a second run on a fresh server must give
                the same tokens, and a 2-layer slice of the model must
                give the plain dense forward's logits through the paged
                kernel path;
     profile  — one mixed (prefill + decode) step and one steady decode
                step under torch.profiler: wall time, device busy time
                and idle share, the busiest kernels;
  4. kernels  — each ported kernel with the TPU kernel it replaces, its
                launches on phase 3's run and its numbers from phase 2.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is non-zero. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
# The 2-layer paged path against the plain dense forward: the largest
# logit error within this share of the largest logit.
DENSE_LOGIT_RTOL = 2.5e-2
SEED = 0
CONFIG = "cloud_server_tpu_torch/configs/llama3_1_8b.json"
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
    cuda_build.build_all(["paged_attention"])
    build_s = time.perf_counter() - t0
    out = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": round(build_s, 3)}
    emit(out)
    print(smi, flush=True)
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


def bound_ms(q, lengths, widths) -> tuple[float, str]:
    """Least time on the card for this call's work: bytes (q and the
    output once, every slot's K and V up to its length once) over the
    memory rate, or the causally visible operations (4 * Dh per
    query-row-key pair: the two products) over the bf16 tensor rate."""
    b, w, h, d = q.shape
    lens = [int(x) for x in lengths.tolist()]
    wids = [int(x) for x in widths.tolist()]
    nbytes = 2 * q.numel() * 2 + 16 * b
    ops = 0
    for n, wd in zip(lens, wids):
        nbytes += 2 * n * KH * DH * 2
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


def phase_kernel() -> dict:
    import torch
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
        pa.reset_counters()
        got = pa.paged_attention(q, kp, vp, lengths, tables, layer,
                                 widths=widths)
        torch.cuda.synchronize()
        if pa.launches_narrow + pa.launches_wide != 1:
            raise RuntimeError(f"{name}: the kernel was not launched")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name}: non-finite kernel output")
        want = pa.paged_attention_ref(q, kp, vp, lengths, tables, layer,
                                      widths=widths)
        valid = torch.arange(w, device=DEVICE)[None, :] < widths[:, None]
        valid &= (lengths > 0)[:, None]
        diff = (got.float() - want.float()).abs()[valid]
        ref_abs = want.float().abs()[valid]
        err = float(diff.max())
        ref_scale = float(ref_abs.max())
        rel_rms = float(diff.square().mean().sqrt()
                        / ref_abs.square().mean().sqrt())
        if not (bool((diff <= ATOL + RTOL * ref_abs).all())
                and rel_rms <= REL_RMS):
            raise RuntimeError(f"{name}: kernel differs from the plain "
                               f"version beyond atol {ATOL} + rtol {RTOL} "
                               f"or relative RMS {REL_RMS}: max abs error "
                               f"{err}, relative RMS error {rel_rms}")
        # the raw C entry the wrapper calls, on preallocated buffers
        kern = pa._kernel()
        b, _, h, d = q.shape
        g = h // KH
        qg = q.reshape(b, w, KH, g, d).permute(0, 2, 1, 3, 4).reshape(
            b, KH, w * g, d).contiguous()
        out = torch.empty_like(qg)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err_code = kern(qg.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            lengths.data_ptr(), tables.data_ptr(),
                            widths.data_ptr(), out.data_ptr(), b, KH, w * g,
                            g, d, kp.shape[1], PS, tables.shape[1], layer,
                            d ** -0.5, 1, stream)
            if err_code:
                raise RuntimeError(f"kernel launch failed: {err_code}")

        ms = time_ms(launch, iters=50)
        plain_ms = time_ms(lambda: pa.paged_attention_ref(
            q, kp, vp, lengths, tables, layer, widths=widths), iters=10)
        library_ms = time_ms(library_call(q, kp, vp, lengths, tables,
                                          widths, layer), iters=20)
        bms, by = bound_ms(q, lengths, widths)
        res = {"phase": "kernel", "case": name, "B": b, "W": w,
               "class": "narrow" if pa.is_narrow(b, w) else "wide",
               "lengths": lens, "widths": wids, "max_abs_err": err,
               "ref_max_abs": ref_scale, "rel_rms_err": rel_rms,
               "atol": ATOL, "rtol": RTOL, "rel_rms_limit": REL_RMS, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bms, "bound_by": by}
        emit(res)
        results[name] = res
        del q, kp, vp, got, want, qg, out
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 3: serving at Llama-3.1-8B width
# ---------------------------------------------------------------------------

PROMPT_LENS = [64, 200, 350, 500, 700, 900, 1200, 1500]
MAX_NEW = 32


def serve_once(params, cfg, icfg, prompts):
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    import torch
    srv = PagedInferenceServer(params, cfg, icfg, max_slots=8,
                               max_context=MAX_CTX, page_size=PS,
                               prefill_chunk=256, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    srv.run_until_idle()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    del srv
    return reqs, t0, t_end


def profile_step(srv) -> dict:
    """One scheduler step under torch.profiler: its wall time, the device
    time of every kernel and copy it ran, and the busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if per_name else None,
            "device_idle_share": (1 - busy / wall_ms) if per_name else None,
            "top_device_ms": {k[:80]: v for k, v in top}}


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
    mixed = profile_step(srv)
    while srv._jobs or srv.num_pending:
        srv.step()
    decode = profile_step(srv)
    srv.stop()
    out = {"phase": "profile", "mixed_step": mixed, "decode_step": decode,
           "decode_rounds_per_step": srv.decode_chunk, "live_slots": 8}
    emit(out)
    return out


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
    reqs, t_start, t_end = serve_once(params, cfg, icfg, prompts)
    counts = pa.counters()
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        if r.finish_reason != "length" or len(r.tokens) != MAX_NEW:
            raise RuntimeError(f"request ended {r.finish_reason!r} with "
                               f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise RuntimeError("token id out of the vocabulary")
    if counts["launches_narrow"] <= 0 or counts["launches_wide"] <= 0:
        raise RuntimeError(f"kernel classes not both launched: {counts}")
    if counts["plain_calls"] != 0:
        raise RuntimeError(f"plain attention ran on the path: {counts}")
    first = [r.emit_times[0] for r in reqs]
    ttft = sorted(f - r.submit_time for f, r in zip(first, reqs))
    t_all_first = max(first)
    prefill_tps = sum(PROMPT_LENS) / (t_all_first - t_start)
    after = sum(sum(1 for t in r.emit_times if t > t_all_first)
                for r in reqs)
    decode_tps = after / max(t_end - t_all_first, 1e-9)

    reqs2, _, _ = serve_once(params, cfg, icfg, prompts)
    same = [r.tokens for r in reqs] == [r.tokens for r in reqs2]
    if not same:
        raise RuntimeError("a second run of the same requests gave other "
                           "tokens")
    dense = check_dense_agreement(params, cfg, prompts[2])
    out = {"phase": "serve", "model": "Llama-3.1-8B (random bf16 weights)",
           "layers": cfg.num_layers, "requests": len(reqs),
           "prompt_tokens": sum(PROMPT_LENS), "max_new_tokens": MAX_NEW,
           "init_s": init_s, "wall_s": t_end - t_start,
           "prefill_tok_per_s": prefill_tps,
           "decode_tok_per_s_after_last_first_token": decode_tps,
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "peak_mem_gb": peak / 1e9, "counts": counts,
           "second_run_identical": same, **dense}
    emit(out)
    phase_profile(params, cfg, icfg, prompts)
    return out


def main() -> int:
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
    dev = phase_device()
    kern = phase_kernel()
    if "--kernel-only" in sys.argv[1:]:
        return 0  # a quick check of a kernel change; prints no result
    serve = phase_serve()
    counts = serve["counts"]
    wide_err = max(kern["prefill"]["max_abs_err"],
                   kern["ragged"]["max_abs_err"])
    rows = []
    for cls, case, line, launches, err in (
            ("narrow", "decode", 96, counts["launches_narrow"],
             kern["decode"]["max_abs_err"]),
            ("wide", "prefill", 434, counts["launches_wide"], wide_err)):
        k = kern[case]
        rows.append({
            "name": f"paged_attention ({cls} class, {case} case)",
            "route": "cuda",
            "source": "cloud_server_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"cloud_server_tpu/ops/paged_attention.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
