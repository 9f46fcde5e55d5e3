"""Request lifecycle hardening on the port's servers, case for case with
tests/test_lifecycle.py: client-side cancellation (pending /
mid-admission / mid-decode), the bounded pending queue (QueueFullError
-> HTTP 429), a streaming client's disconnect aborting its request, and
graceful drain on stop — on the paged server and the contiguous one, on
the CPU; and a grammar-stack upload that fails leaving the old stack
and its programs as they were (C19, found by the port's static gate).
The static half of the lifecycle contract (LC1..LC4) is
tests/test_torch_analysis.py's."""

import dataclasses
import json
import socket
import time

import pytest

from net_compat import requires_loopback_disconnect

from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference import paged_server as ps
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.inference.server import (InferenceServer,
                                                     QueueFullError)
from cloud_server_tpu_torch.models import transformer

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
CONTIG_KW = dict(max_slots=2, max_len=64, prompt_buckets=[16])

PROMPT = [5, 9, 3]


@pytest.fixture(scope="module")
def params():
    return transformer.init_params(CFG, 0, device="cpu")


def _paged(params, icfg=GREEDY, **kw):
    return PagedInferenceServer(params, CFG, icfg, device="cpu",
                                **{**SRV_KW, **kw})


def _contig(params, **kw):
    return InferenceServer(params, CFG, GREEDY, device="cpu",
                           **{**CONTIG_KW, **kw})


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------


def test_cancel_pending_finishes_immediately(params):
    srv = _paged(params)
    r = srv.submit(PROMPT, max_new_tokens=8)
    r.cancel()
    assert r.done and r.finish_reason == "cancelled"
    assert srv.num_pending == 0
    r.cancel()  # idempotent
    ok = srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    assert len(ok.result()) == 4


def test_cancel_mid_decode_releases_pages(params):
    srv = _paged(params)
    total = srv.allocator.available
    r = srv.submit(list(range(1, 13)), max_new_tokens=30)
    while not srv.active.any():  # admit fully, start decoding
        srv.step()
    srv.step()
    assert not r.done
    r.cancel()
    srv.run_until_idle()  # the sweep reaps it (after the commit in flight)
    assert r.done and r.finish_reason == "cancelled"
    assert srv.num_active == 0
    assert srv.allocator.available == total
    assert 0 < len(r.tokens) < 30  # partial output is preserved


def test_cancel_mid_admission(params):
    srv = _paged(params)
    r = srv.submit(list(range(1, 29)), max_new_tokens=8)
    srv.step()  # admission job started (prefill_chunk=16 < 28 tokens)
    assert srv._jobs and not srv.active.any()
    r.cancel()
    srv.run_until_idle()
    assert r.done and r.finish_reason == "cancelled"
    assert r.tokens == []
    assert srv.num_active == 0


def test_cancel_done_request_is_noop(params):
    srv = _paged(params)
    r = srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    assert r.finish_reason == "length"
    r.cancel()
    assert r.finish_reason == "length"


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_bounded_queue_raises(params):
    srv = _paged(params, max_pending=2)
    srv.submit(PROMPT, max_new_tokens=4)
    srv.submit(PROMPT, max_new_tokens=4)
    with pytest.raises(QueueFullError):
        srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    r = srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    assert len(r.result()) == 4


def test_queue_full_maps_to_429(params):
    from urllib import error as uerr
    from urllib import request as urq
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    srv = _paged(params, max_pending=1)  # NOT started: the queue stays full
    front = HttpFrontend(srv).start()
    try:
        srv.submit(PROMPT, max_new_tokens=4)
        host, port = front.address
        body = json.dumps({"prompt": PROMPT, "max_tokens": 4}).encode()
        with pytest.raises(uerr.HTTPError) as ei:
            urq.urlopen(urq.Request(
                f"http://{host}:{port}/v1/completions", data=body),
                timeout=30)
        assert ei.value.code == 429
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# streaming client disconnect
# ---------------------------------------------------------------------------


@requires_loopback_disconnect
def test_disconnect_aborts_streaming_request(params):
    """A streaming client that vanishes mid-generation frees its slot
    long before max_tokens, through the native /generate endpoint (one
    ndjson line a token); the server keeps serving others."""
    from cloud_server_tpu_torch.inference.http_server import HttpFrontend
    icfg = InferConfig(max_decode_len=200, temperature=0.0,
                       eos_token_id=-1, pad_token_id=0)
    srv = PagedInferenceServer(params, CFG, icfg, device="cpu", max_slots=4,
                               max_context=256, page_size=8,
                               decode_chunk=2, prefill_chunk=16,
                               prompt_buckets=[16]).start()
    front = HttpFrontend(srv).start()
    try:
        host, port = front.address
        body = json.dumps({"tokens": PROMPT,
                           "max_new_tokens": 200}).encode()
        raw = (f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
               f"Content-Length: {len(body)}\r\n\r\n").encode() + body
        s = socket.create_connection((host, port), timeout=30)
        s.sendall(raw)
        s.recv(1024)  # first streamed bytes: generation is running
        s.close()     # client walks away
        deadline = time.time() + 60
        while time.time() < deadline and srv.tokens_emitted == 0 \
                and srv.num_active == 0 and not srv._jobs:
            time.sleep(0.01)
        assert srv.num_active or srv._jobs or srv.tokens_emitted, \
            "request never started"
        while time.time() < deadline:
            if srv.num_active == 0 and not srv._jobs:
                break
            time.sleep(0.05)
        assert srv.num_active == 0
        assert srv.tokens_emitted < 150
        r = srv.submit(PROMPT, max_new_tokens=4)
        assert len(r.result(timeout=120)) == 4
    finally:
        front.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------


def test_stop_drain_completes_inflight(params):
    srv = _paged(params)
    reqs = [srv.submit(PROMPT, max_new_tokens=6) for _ in range(3)]
    srv.stop(drain=True)
    for r in reqs:
        assert r.finish_reason == "length"
        assert len(r.tokens) == 6
    with pytest.raises(RuntimeError):
        srv.submit(PROMPT, max_new_tokens=2)


def test_drain_timeout_resumes_then_stop_unblocks(params):
    srv = _paged(params)
    r = srv.submit(PROMPT, max_new_tokens=8)
    assert srv.drain(timeout=0.0) is False  # nothing stepped yet
    r2 = srv.submit(PROMPT, max_new_tokens=2)  # a timed-out drain resumes
    srv.stop()
    assert r.done and r.finish_reason.startswith("error")
    assert r2.done and r2.finish_reason.startswith("error")
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(PROMPT, max_new_tokens=2)


def test_drain_with_background_thread(params):
    srv = _paged(params).start()
    reqs = [srv.submit(PROMPT, max_new_tokens=6) for _ in range(2)]
    assert srv.drain(timeout=120) is True
    srv.stop()
    for r in reqs:
        assert len(r.tokens) == 6


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_drain_then_resume_accepts_again(params, kind):
    srv = _paged(params) if kind == "paged" else _contig(params)
    r1 = srv.submit(PROMPT, max_new_tokens=4)
    assert srv.drain(timeout=120) is True
    assert len(r1.tokens) == 4
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(PROMPT, max_new_tokens=2)
    srv.resume()
    r2 = srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    assert r2.tokens == r1.tokens
    srv.stop()


@pytest.mark.parametrize("kind", ["paged", "contiguous"])
def test_stop_drain_timeout_latches_draining(params, kind):
    def make():
        return _paged(params) if kind == "paged" else _contig(params)

    srv = make()
    r = srv.submit(PROMPT, max_new_tokens=8)
    assert srv.drain(timeout=0.0, _resume_on_timeout=False) is False
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(PROMPT, max_new_tokens=2)  # the race window
    srv.stop()
    assert r.done and r.finish_reason.startswith("error")
    srv2 = make()
    srv2.submit(PROMPT, max_new_tokens=8)
    assert srv2.drain(timeout=0.0) is False
    srv2.submit(PROMPT, max_new_tokens=2)  # accepted again
    srv2.stop()


def test_contiguous_server_cancel(params):
    srv = _contig(params)
    pending = srv.submit(PROMPT, max_new_tokens=8)
    pending.cancel()
    assert pending.done and pending.finish_reason == "cancelled"
    active = srv.submit(PROMPT, max_new_tokens=30)
    srv.step()
    assert not active.done
    active.cancel()
    srv.run_until_idle()
    assert active.done and active.finish_reason == "cancelled"
    assert srv.num_active == 0
    ok = srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    assert len(ok.result()) == 4


def test_contiguous_server_backpressure_and_drain(params):
    srv = _contig(params, max_pending=1)
    srv.submit(PROMPT, max_new_tokens=4)
    with pytest.raises(QueueFullError):
        srv.submit(PROMPT, max_new_tokens=4)
    srv.run_until_idle()
    reqs = [srv.submit(PROMPT, max_new_tokens=6)]
    srv.stop(drain=True)
    assert reqs[0].finish_reason == "length"
    assert len(reqs[0].tokens) == 6
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit(PROMPT, max_new_tokens=2)


# ---------------------------------------------------------------------------
# a failed grammar-stack upload (C19)
# ---------------------------------------------------------------------------


def test_failed_stack_upload_keeps_the_old_programs(monkeypatch):
    """A grammar-stack upload that fails (the card out of memory) leaves
    the old stack, its programs, its generation and the retired list as
    they were, and the next sync builds the new stack: the upload comes
    before the old generation's programs are dropped."""
    tok = ByteTokenizer()
    cfg = dataclasses.replace(CFG, vocab_size=300)
    icfg = InferConfig(max_decode_len=4, temperature=0.0,
                       eos_token_id=tok.eos_id, pad_token_id=0)
    srv = PagedInferenceServer(transformer.init_params(cfg, 2, device="cpu"),
                               cfg, icfg, device="cpu", tokenizer=tok,
                               overlap=False, **SRV_KW)
    a = srv.submit(tok.encode("a:"), max_new_tokens=4,
                   sampling=SamplingParams(regex="[0-9]+"))
    srv.run_until_idle()
    assert a.finish_reason in ("eos", "length")
    keys, stack = set(srv._programs.keys()), srv._model.grammar
    assert any(k[1] == 1 for k in keys)  # a program reads stack 1
    srv._grammar_gid("[a-z]+")  # registered; built at the next sync

    def oom(*a, **k):
        raise RuntimeError("CUDA out of memory")

    with monkeypatch.context() as m:
        m.setattr(ps.torch, "as_tensor", oom)
        with pytest.raises(RuntimeError, match="out of memory"):
            srv._sync_grammar_stack()
    assert set(srv._programs.keys()) == keys
    assert srv._programs.dropped == 0 and srv._retired == []
    assert srv._model.grammar is stack and srv._grammar_gen == 1
    b = srv.submit(tok.encode("b:"), max_new_tokens=4,
                   sampling=SamplingParams(regex="[a-z]+"))
    srv.run_until_idle()
    assert b.finish_reason in ("eos", "length")
    assert srv._grammar_gen == 2 and srv._model.grammar[0].shape[0] == 3
