"""The port's contiguous InferenceServer against the reference's, on the
same float32 weights on the CPU. Tokens are exact and logprobs within
1e-4: greedy and seeded (server-global and per-request rows), under the
sequential and the overlapped loop, with decode chunks, prefix caching
(the float and the int8 cache), penalties, logit_bias and
min_tokens, and captured programs made per shape key. Then the
lifecycle (interleaving, EOS, streaming, the background thread,
refusals, cancel, backpressure, drain / resume / stop) and the
contiguous cases of the host policy layer (QoS admission order, SLO
counts, span trees, the anomaly watchdog's bundle, the iteration
profile, fault sites) held against the reference server running the
same script."""

import dataclasses
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.inference.server import InferenceServer as RefServer
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import engine, graphs
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.inference.server import (InferenceServer,
                                                     QueueFullError)
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=128, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], [60], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
KW = dict(max_slots=2, max_len=64, prompt_buckets=[16])


def _tc(cfg=CFG):
    return TModelConfig(**dataclasses.asdict(cfg))


def _ti(icfg=GREEDY):
    return TInferConfig(**dataclasses.asdict(icfg))


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), _tc(),
                                  device="cpu")


def _port(weights, cfg=CFG, icfg=GREEDY, **kw):
    return InferenceServer(weights[1], _tc(cfg), _ti(icfg), device="cpu",
                           **kw)


def _ref(weights, cfg=CFG, icfg=GREEDY, **kw):
    return RefServer(weights[0], cfg, icfg, **kw)


def _engine_reference(weights, prompt, n_new):
    """Greedy per-prompt tokens from the port's engine (held equal to the
    reference's by test_torch_engine.py)."""
    icfg = _ti(dataclasses.replace(GREEDY, max_decode_len=n_new))
    return engine.generate(weights[1], torch.tensor([prompt]), prng.key(1),
                           cfg=_tc(), infer_cfg=icfg)[0].tolist()


def _staggered(srv, prompts=PROMPTS, max_new=10, sampling=None):
    reqs = [srv.submit(p, max_new_tokens=max_new, sampling=sampling)
            for p in prompts[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new, sampling=sampling)
             for p in prompts[2:]]
    srv.run_until_idle()
    return reqs


def _assert_same(got, want):
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# tokens against the reference server
# ---------------------------------------------------------------------------


def test_server_matches_engine_greedy(weights):
    srv = _port(weights, max_slots=4, max_len=64, prompt_buckets=[16])
    outs = srv.generate(PROMPTS, max_new_tokens=8)
    for prompt, out in zip(PROMPTS, outs):
        assert out == _engine_reference(weights, prompt, 8), prompt


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlap"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "seeded"])
def test_staggered_matches_reference(weights, overlap, chunk, temperature):
    """Admissions joining running decodes, with the server-global key
    split per dispatch and per chunk step as the reference splits it:
    the same tokens and logprobs under both loops."""
    icfg = dataclasses.replace(GREEDY, temperature=temperature)
    kw = dict(max_slots=4, max_len=64, decode_chunk=chunk, overlap=overlap,
              seed=5)
    _assert_same(_staggered(_port(weights, icfg=icfg, **kw)),
                 _staggered(_ref(weights, icfg=icfg, **kw)))


@pytest.mark.parametrize("samp", [
    dict(seed=11), dict(seed=3, temperature=0.9, top_k=8),
    dict(seed=3, repetition_penalty=1.3, presence_penalty=0.5,
         frequency_penalty=0.2),
    dict(logit_bias=((3, 5.0), (9, -2.0)), temperature=0.0, min_tokens=3)],
    ids=["seed", "top_k", "penalties", "bias_min_tokens"])
@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlap"])
def test_per_request_rows_match_reference(weights, samp, overlap):
    """Per-request sampling rows (seeds, penalties, logit_bias,
    min_tokens) draw on fold_in(key(seed), position) and rebuild the
    penalty state at admission: the reference's tokens."""
    icfg = dataclasses.replace(GREEDY, temperature=0.7, eos_token_id=7)
    kw = dict(max_slots=4, max_len=64, decode_chunk=2, overlap=overlap,
              seed=5)
    _assert_same(
        _staggered(_port(weights, icfg=icfg, **kw),
                   sampling=SamplingParams(**samp)),
        _staggered(_ref(weights, icfg=icfg, **kw),
                   sampling=RefSamplingParams(**samp)))


def test_continuous_batching_interleaves(weights):
    """Requests submitted mid-flight join running decodes (one queues
    behind the two slots) and still match."""
    srv = _port(weights, **KW)
    r0 = srv.submit(PROMPTS[0], max_new_tokens=12)
    for _ in range(3):
        srv.step()
    r1 = srv.submit(PROMPTS[1], max_new_tokens=6)
    r2 = srv.submit(PROMPTS[2], max_new_tokens=6)
    assert srv.num_pending >= 1
    srv.run_until_idle()
    assert r0.result() == _engine_reference(weights, PROMPTS[0], 12)
    assert r1.result() == _engine_reference(weights, PROMPTS[1], 6)
    assert r2.result() == _engine_reference(weights, PROMPTS[2], 6)
    assert r0.finish_reason == r1.finish_reason == "length"


@pytest.mark.parametrize("chunk", [1, 8])
def test_eos_stops_early_and_frees_slot(weights, chunk):
    """EOS mid-stream (mid-chunk with decode_chunk 8) stops the request
    there, EOS excluded, and the slot serves the queued request."""
    ref = _engine_reference(weights, PROMPTS[0], 12)
    cut = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    icfg = dataclasses.replace(GREEDY, eos_token_id=ref[cut])
    srv = _port(weights, icfg=icfg, max_slots=1, max_len=64,
                prompt_buckets=[16], decode_chunk=chunk)
    req = srv.submit(PROMPTS[0], max_new_tokens=12)
    r1 = srv.submit(PROMPTS[2], max_new_tokens=4)
    srv.run_until_idle()
    assert req.finish_reason == "eos" and req.tokens == ref[:cut]
    assert r1.done and srv.num_active == 0


def test_streaming_callback_sees_tokens_in_order(weights):
    seen = []
    srv = _port(weights, max_slots=1, max_len=64, prompt_buckets=[16])
    req = srv.submit(PROMPTS[0], max_new_tokens=8, stream=seen.append)
    srv.run_until_idle()
    assert seen == req.tokens == _engine_reference(weights, PROMPTS[0], 8)


def test_background_thread_serving(weights):
    srv = _port(weights, **KW).start()
    try:
        reqs = [srv.submit(p, max_new_tokens=6) for p in PROMPTS]
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        srv.stop()
    for prompt, out in zip(PROMPTS, outs):
        assert out == _engine_reference(weights, prompt, 6), prompt


def test_submit_validation_matches_reference(weights):
    """The reference's refusals, word for word: empty prompt, a prompt
    past the largest bucket, no room to decode, a regex request (the
    paged server's), a bad deadline, buckets past max_len, a prefix
    that fills max_len, and the pallas decode impl."""
    kw = dict(max_slots=1, max_len=16, prompt_buckets=[8])
    cases = [(lambda s, sp: s.submit([]), {}),
             (lambda s, sp: s.submit(list(range(9))), {}),
             (lambda s, sp: s.submit(list(range(8)), max_new_tokens=0), {}),
             (lambda s, sp: s.submit([1], sampling=sp(regex="a+")), {}),
             (lambda s, sp: s.submit([1], deadline_s=float("nan")), {})]
    for call, _ in cases:
        with pytest.raises(ValueError) as want:
            call(_ref(weights, **kw), RefSamplingParams)
        with pytest.raises(ValueError) as got:
            call(_port(weights, **kw), SamplingParams)
        assert str(got.value) == str(want.value)
    for extra, cfg in [(dict(max_slots=1, max_len=32, prompt_buckets=[64]),
                        CFG),
                       (dict(max_slots=1, max_len=16,
                             prefix_tokens=list(range(16))), CFG),
                       (dict(max_slots=1, max_len=16),
                        dataclasses.replace(
                            CFG, decode_attention_impl="pallas"))]:
        with pytest.raises(ValueError) as want:
            _ref(weights, cfg=cfg, **extra)
        with pytest.raises(ValueError) as got:
            _port(weights, cfg=cfg, **extra)
        assert str(got.value) == str(want.value)


def test_scheduler_error_unblocks_clients(weights):
    """A fatal step() error fails waiting requests instead of hanging
    them, and a stopped server refuses new work."""
    srv = _port(weights, max_slots=1, max_len=64, prompt_buckets=[16])
    srv.step = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    req = srv.submit(PROMPTS[0], max_new_tokens=4)
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            req.result(timeout=60)
    finally:
        srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(PROMPTS[0])


def test_slot_reuse_no_leakage(weights):
    srv = _port(weights, max_slots=1, max_len=64, prompt_buckets=[16])
    first = srv.generate([PROMPTS[1]], max_new_tokens=10)[0]
    second = srv.generate([PROMPTS[2]], max_new_tokens=10)[0]
    assert first == _engine_reference(weights, PROMPTS[1], 10)
    assert second == _engine_reference(weights, PROMPTS[2], 10)


def test_burst_admission_is_one_batched_prefill(weights):
    """A burst of pending requests admits in ONE admission program of
    padded rows, keyed by (bucket, rows), and the active slot still
    decodes that step (under the overlap pipeline: the first step
    launches the admission, a decode it commits, and the primed next
    chunk; a steady step one admission and one chunk)."""
    srv = _port(weights, max_slots=4, max_len=64, prompt_buckets=[16])
    r0 = srv.submit(PROMPTS[0], max_new_tokens=10)
    n0 = graphs.launches
    srv.step()
    assert graphs.launches - n0 == 3
    got_tokens = len(r0.tokens)
    reqs = [srv.submit(p, max_new_tokens=6) for p in PROMPTS[1:]]
    n0 = graphs.launches
    srv.step()
    assert graphs.launches - n0 == 2, "a burst is one batched prefill"
    admits = [k for k in srv._programs.keys() if k[0] == "_admit_core"]
    assert len(admits) == 2
    assert dict(admits[1][2])["prompts"] == (4, 16)  # 3 rows padded to 4
    assert len(r0.tokens) == got_tokens + 1
    srv.run_until_idle()
    assert r0.result() == _engine_reference(weights, PROMPTS[0], 10)
    for p, r in zip(PROMPTS[1:], reqs):
        assert r.result() == _engine_reference(weights, p, 6)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefix_caching_matches_reference(weights, kv):
    """Prefix caching: matching prompts admit through the cached prefix
    (hits and misses counted), the reference's tokens and logprobs, with
    the float and the int8 cache; with the float cache the tokens equal
    a server without the prefix."""
    cfg = dataclasses.replace(CFG, kv_cache_dtype=kv)
    prefix = [9, 4, 7, 7, 2, 5]
    prompts = [prefix + [3, 1], prefix + [8], [1, 2, 3], list(prefix)]
    kw = dict(max_slots=4, max_len=64, prefix_tokens=prefix)
    srv = _port(weights, cfg=cfg, **kw)
    want = _ref(weights, cfg=cfg, **kw)
    got_r = [srv.submit(p, max_new_tokens=8) for p in prompts]
    srv.run_until_idle()
    want_r = [want.submit(p, max_new_tokens=8) for p in prompts]
    want.run_until_idle()
    _assert_same(got_r, want_r)
    assert (srv.prefix_hits, srv.prefix_misses) == (2, 2)
    if kv == "model":
        plain = _port(weights, max_slots=4, max_len=64)
        assert [r.tokens for r in got_r] == plain.generate(
            prompts, max_new_tokens=8)


def test_logprobs_recorded(weights):
    """Every emitted token carries the model's log-probability; the first
    one equals a hand prefill's."""
    srv = _port(weights, icfg=dataclasses.replace(GREEDY, max_decode_len=6),
                max_slots=2, max_len=32)
    req = srv.submit([3, 7, 11], max_new_tokens=6)
    srv.run_until_idle()
    assert len(req.logprobs) == len(req.tokens) == 6
    assert all(lp <= 0.0 for lp in req.logprobs)
    cache = engine.init_cache(_tc(), 1, 32)
    logits, _ = engine.prefill(weights[1], torch.tensor([[3, 7, 11]]),
                               _tc(), cache)
    want = float(torch.log_softmax(logits[0], -1)[req.tokens[0]])
    np.testing.assert_allclose(req.logprobs[0], want, rtol=1e-4)


def test_cuda_graphs_off_is_the_same_on_the_cpu(weights):
    """`cuda_graphs=False` launches the same program functions eagerly;
    on the CPU both run them on the same buffers: equal tokens, and one
    decode program per (chunk, rows, bias) key."""
    outs = []
    for graphs_on in (True, False):
        srv = _port(weights, max_slots=4, max_len=64, decode_chunk=2,
                    cuda_graphs=graphs_on)
        outs.append([r.tokens for r in _staggered(srv)])
        decodes = {k[1] for k in srv._programs.keys()
                   if k[0] == "_decode_core"}
        assert all(dict(f)["rows"] is False for f in decodes)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def test_cancel_pending_and_active(weights):
    srv = _port(weights, **KW)
    pending = srv.submit(PROMPTS[0], max_new_tokens=8)
    pending.cancel()
    assert pending.done and pending.finish_reason == "cancelled"
    active = srv.submit(PROMPTS[0], max_new_tokens=30)
    srv.step()
    assert not active.done
    active.cancel()
    srv.step()
    assert active.done and active.finish_reason == "cancelled"
    assert srv.num_active == 0
    ok = srv.submit(PROMPTS[0], max_new_tokens=4)
    srv.run_until_idle()
    assert len(ok.result()) == 4


def test_overlap_cancel_inflight(weights):
    """A slot cancelled while its chunk is in flight is reaped, and the
    stale rows are identity-masked at the commit."""
    srv = _port(weights, max_slots=2, max_len=64, prompt_buckets=[16],
                decode_chunk=2, overlap=True)
    victim = srv.submit([5, 9, 3], max_new_tokens=30)
    srv.step()
    assert srv._inflight is not None
    assert srv.overlap_stats() == {"enabled": True, "active": True,
                                   "inflight_depth": 1}
    victim.cancel()
    srv.step()
    assert victim.done and victim.finish_reason == "cancelled"
    fresh = srv.submit([1, 2, 3], max_new_tokens=4)
    srv.run_until_idle()
    assert fresh.tokens == _engine_reference(weights, [1, 2, 3], 4)


def test_backpressure_drain_resume_and_stop(weights):
    """max_pending, drain (quiesced until resume), a timed-out drain's
    latch, and stop(drain=True): the reference's contract."""
    srv = _port(weights, max_pending=1, **KW)
    srv.submit(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(QueueFullError):
        srv.submit(PROMPTS[0], max_new_tokens=4)
    srv.run_until_idle()
    r1 = srv.submit(PROMPTS[0], max_new_tokens=4)
    assert srv.drain(timeout=120) is True and len(r1.tokens) == 4
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(PROMPTS[0], max_new_tokens=2)
    assert not srv.ready
    srv.resume()
    r2 = srv.submit(PROMPTS[0], max_new_tokens=4)
    srv.run_until_idle()
    assert r2.tokens == r1.tokens
    r = srv.submit(PROMPTS[0], max_new_tokens=8)
    assert srv.drain(timeout=0.0, _resume_on_timeout=False) is False
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(PROMPTS[0], max_new_tokens=2)
    srv.stop()
    assert r.done and r.finish_reason.startswith("error")
    srv2 = _port(weights, **KW)
    srv2.submit(PROMPTS[0], max_new_tokens=8)
    assert srv2.drain(timeout=0.0) is False
    req = srv2.submit(PROMPTS[0], max_new_tokens=6)  # accepted again
    srv2.stop(drain=True)
    assert req.finish_reason == "length" and len(req.tokens) == 6
    with pytest.raises(RuntimeError, match="stopped"):
        srv2.submit(PROMPTS[0], max_new_tokens=2)


def test_idle_iterations_stay_bounded(weights):
    """An idle started server parks on the bounded condition wait, and a
    submit wakes it."""
    srv = _port(weights, **KW).start()
    try:
        time.sleep(0.2)
        base = srv.idle_iterations
        time.sleep(0.6)
        assert srv.idle_iterations - base < 60
        t0 = time.perf_counter()
        srv.submit([5, 9, 3], max_new_tokens=2).result(timeout=60)
        assert time.perf_counter() - t0 < 30
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the host policy layer on the contiguous server
# ---------------------------------------------------------------------------


def test_fair_admission_order_matches_reference(weights):
    """DRR admission over tenants (one slot): the admission order, the
    tenants' counters and the tokens are the reference's."""
    qos = {"quantum": 1, "tenants": {"a": {"weight": 3.0},
                                     "b": {"weight": 1.0}}}
    out = []
    for make in (_ref, _port):
        srv = make(weights, max_slots=1, max_len=64, prompt_buckets=[16],
                   qos=qos)
        reqs = []
        for i in range(6):
            reqs.append(srv.submit([5, 9, i], max_new_tokens=2, tenant="a"))
            reqs.append(srv.submit([7, 2, i], max_new_tokens=2, tenant="b"))
        srv.run_until_idle()
        order = [r.tenant for r in sorted(reqs, key=lambda r: r.admit_time)]
        stats = {t: {k: v for k, v in s.items() if not isinstance(v, float)}
                 for t, s in srv.qos.stats().items()}
        out.append((order, stats, [r.tokens for r in reqs]))
    assert out[1] == out[0]
    assert out[1][0][-1] == "b"


def test_slo_report_matches_hand_count(weights):
    easy = {"classes": {"default": {"ttft_s": 60.0, "itl_s": 60.0,
                                    "queue_wait_s": 60.0, "e2e_s": 60.0}}}
    srv = _port(weights, slo=easy, **KW)
    for i in range(2):
        srv.submit([5 + i, 9, 3], max_new_tokens=4)
    srv.run_until_idle()
    m = srv.slo_report()["classes"]["default"]["metrics"]
    assert m["ttft"]["lifetime"] == {"good": 2, "total": 2,
                                     "attainment": 1.0, "burn_rate": 0.0}
    assert m["queue_wait"]["lifetime"]["total"] == 2
    assert m["e2e"]["lifetime"]["total"] == 2
    assert m["itl"]["lifetime"]["total"] == 6


def _phase_names(tree):
    out = []

    def walk(node):
        for c in node.get("children", []):
            out.append(c["name"])
            walk(c)
    walk(tree["root"])
    return out


def test_span_tree_matches_reference_shape(weights):
    """A traced request's span tree has the reference's phases (queue,
    prefill, decode, emit) in the same order."""
    names = []
    for make in (_ref, _port):
        srv = make(weights, tracing=1.0, **KW)
        req = srv.submit([5, 9, 3], max_new_tokens=4)
        srv.run_until_idle()
        tree = srv.lookup_trace(req.request_id)
        assert tree is not None and srv.lookup_trace("nope") is None
        names.append(_phase_names(tree))
    assert names[1] == names[0]
    for want in ("queue", "prefill", "decode", "emit"):
        assert want in names[1]


def test_watchdog_fires_and_bundle_autocaptures(weights):
    """A deadline expiry fires the deadline_spike rule, the doomed
    request's tree is tail-retained at zero head sampling, and one
    bundle is captured on the activation edge, as in the reference."""
    icfg = dataclasses.replace(GREEDY, trace_tail_capacity=8,
                               bundle_on_anomaly=True)
    trigger = {"warmup": 0, "check_every": 1, "hold_s": 30.0,
               "rules": {"deadline_spike": {"count": 1,
                                            "window_s": 3600.0}}}
    srv = _port(weights, icfg=icfg, max_slots=2, max_len=64,
                prompt_buckets=[16, 48], tracing=0.0, anomaly=trigger)
    ok = srv.submit([5, 9, 3], max_new_tokens=6)
    dead = srv.submit([7, 7, 2], max_new_tokens=64, deadline_s=1e-4)
    srv.run_until_idle()
    assert ok.done and dead.finish_reason == "deadline"
    astats = srv.anomaly_stats()
    assert astats["fired_total"]["deadline_spike"] == 1
    assert srv.trace_trees() == []
    trees = {t["request_id"]: t for t in srv.tail_trace_trees()}
    assert trees[dead.request_id]["root"]["tags"][
        "tail_retained"] == "deadline"
    (bundle,) = srv.debug_bundles()
    assert bundle["trigger"] == "anomaly:deadline_spike"
    assert set(bundle) == set(_ref(weights, icfg=icfg, **KW).debug_bundle())
    snap = srv.metrics_snapshot()
    assert snap["cloud_server_anomaly_bundles_total"]["value"] == 1
    assert snap['cloud_server_anomaly_active{rule="deadline_spike"}'][
        "value"] == 1.0


def test_phase_histograms_and_idle_visibility(weights):
    srv = _port(weights, **KW)
    srv.step()
    snap = srv.metrics_snapshot()
    assert snap["cloud_server_idle_iterations_total"]["value"] == 1
    assert snap["cloud_server_last_busy_ts"]["value"] == 0.0
    srv.generate([[5, 9, 3], [7, 2]], max_new_tokens=4)
    snap = srv.metrics_snapshot()
    for phase in ("sweep", "admission", "device", "commit", "epilogue"):
        assert snap[f'cloud_server_iter_phase_ms{{phase="{phase}"}}'][
            "count"] > 0, phase
    assert snap['cloud_server_iter_phase_ms{phase="overlap"}']["count"] > 0
    summary = srv.iteration_profile_stats()
    assert summary is not None and 0.0 <= summary["host_gap_frac"] <= 1.0
    assert snap["cloud_server_last_busy_ts"]["value"] > 0.0
    off = _port(weights, iteration_profile=False, **KW)
    off.generate([[5, 9, 3]], max_new_tokens=2)
    assert off.iteration_profile_stats() is None


def test_metric_families_match_reference(weights):
    """The scrape path registers the reference's metric families."""
    keys = []
    for make in (_ref, _port):
        srv = make(weights, **KW)
        srv.generate([[5, 9, 3]], max_new_tokens=3)
        keys.append(set(srv.metrics_snapshot()))
    assert keys[1] == keys[0]


@pytest.mark.parametrize("site", ["submit_reject", "dispatch"])
def test_fault_sites_fire_like_the_reference(weights, site):
    """submit_reject refuses the next submit, dispatch fails the step
    (and serve_forever's _fail_all every waiter): the same errors and
    fired counts as the reference."""
    plan = {"faults": [{"site": site, "after": 1, "count": 1}]}
    seen = []
    for make in (_ref, _port):
        srv = make(weights, faults=plan, **KW)
        first = srv.submit([5, 9, 3], max_new_tokens=4)
        if site == "submit_reject":
            with pytest.raises(Exception) as err:
                srv.submit([5, 9, 3], max_new_tokens=4)
            srv.run_until_idle()
            seen.append((type(err.value).__name__, str(err.value),
                         first.tokens))
        else:
            srv.step()
            with pytest.raises(Exception) as err:
                srv.step()
            srv._fail_all(err.value)
            seen.append((type(err.value).__name__, str(err.value),
                         first.finish_reason.startswith("error")))
        seen.append(srv.fault_stats()["fired"][site])
    assert seen[2:] == seen[:2]
