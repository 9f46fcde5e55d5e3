"""The port's HTTP frontend against the reference's, on loopback.

The reference's `HttpFrontend` over the reference's `PagedInferenceServer`
and the port's over the port's, greedy, with the same weights (crossed as
numpy arrays) and the byte tokenizer: the same requests give the same
answers (/generate NDJSON, /v1/completions with n, logprobs, stop and SSE
streaming, /v1/chat/completions plain and streamed, /v1/models), the
same errors (400, 404, 429) and the same serving-metric counts; every
read-only route answers with the reference's status and keys, and POST
/debug/trace writes a profiler trace; /v1/embeddings answers the
reference's vectors. A backend that raises NotImplementedError (as a
port server still does for tensor parallelism and MoE) answers 501
naming the feature; penalties, logit_bias,
min_tokens, regex and response_format answer as the reference's, through
n-gram speculation. The int8 KV cache serves over HTTP, and `generate
--serve-http` runs it.
Every fixture stops its servers and frontends in a `finally`, and every
request has a timeout, so a hang fails a test instead of stalling the
suite."""

import dataclasses
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.data.tokenizer import get_tokenizer
from cloud_server_tpu.inference.http_server import (
    HttpFrontend as RefFrontend)
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from net_compat import loopback_disconnect_detectable

ROOT = Path(__file__).resolve().parent.parent
CFG = ModelConfig(
    vocab_size=300, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=128, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=2, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 48])
CONTIGUOUS_KW = dict(max_slots=2, max_len=64, prompt_buckets=[16, 48])
TIMEOUT = 120


def _tcfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and this module's leave about 18
    thousand; a test worker that runs it and other reference-heavy
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), _tcfg(CFG),
                                  device="cpu")


class _Pair:
    """A reference and a port server, each behind its frontend; `close`
    stops everything that was started."""

    def __init__(self, weights, cfg=CFG, icfg=GREEDY, start=True,
                 front_kw=None, ref_kw=None, port_kw=None,
                 contiguous=False, **kw):
        self.started = []
        ref_cls, port_cls, base = RefServer, PagedInferenceServer, SRV_KW
        if contiguous:
            from cloud_server_tpu.inference.server import (
                InferenceServer as ref_cls)
            from cloud_server_tpu_torch.inference.server import (
                InferenceServer as port_cls)
            base = CONTIGUOUS_KW
        try:
            kw = {**base, **kw}
            self.ref_srv = ref_cls(weights[0], cfg, icfg, overlap=False,
                                   **kw, **(ref_kw or {}))
            self.started.append(self.ref_srv)
            self.port_srv = port_cls(
                weights[1], _tcfg(cfg),
                TInferConfig(**dataclasses.asdict(icfg)), device="cpu", **kw,
                **(port_kw or {}))
            self.started.append(self.port_srv)
            if start:
                self.ref_srv.start()
                self.port_srv.start()
            self.ref = RefFrontend(self.ref_srv,
                                   tokenizer=get_tokenizer("byte")).start()
            self.started.append(self.ref)
            self.port = HttpFrontend(self.port_srv, tokenizer=ByteTokenizer(),
                                     **(front_kw or {})).start()
            self.started.append(self.port)
        except BaseException:
            self.close()
            raise

    def close(self):
        for obj in reversed(self.started):
            obj.stop()
        self.started = []


@pytest.fixture(scope="module")
def pair(weights):
    p = _Pair(weights)
    try:
        yield p
    finally:
        p.close()


def _url(front, path):
    host, port = front.address
    return f"http://{host}:{port}{path}"


def _request(front, path, payload=None, data=None):
    """(status, headers, body lines); an HTTP error's body is returned,
    not raised. A POST when `payload` or `data` is given."""
    if payload is not None:
        data = json.dumps(payload).encode()
    req = urllib.request.Request(_url(front, path), data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return (resp.status, dict(resp.headers),
                    [ln.decode().rstrip("\n") for ln in resp if ln.strip()])
    except urllib.error.HTTPError as err:
        return (err.code, dict(err.headers),
                [ln.decode().rstrip("\n") for ln in err if ln.strip()])


def _json(front, path, payload=None):
    """The JSON answer of a 200 (the final line of an NDJSON stream)."""
    status, _, lines = _request(front, path, payload)
    assert status == 200, (status, lines)
    return json.loads(lines[-1])


def _sse(lines):
    assert lines[-1] == "data: [DONE]"
    return [json.loads(ln[len("data: "):]) for ln in lines[:-1]]


def _both(pair, path, payload=None):
    return (_request(pair.ref, path, payload),
            _request(pair.port, path, payload))


# --------------------------------------------------------------------------
# the same answers
# --------------------------------------------------------------------------


def test_generate_ndjson_same_tokens(pair):
    (rs, rh, rl), (ps, ph, pl) = _both(
        pair, "/generate", {"tokens": [5, 9, 3], "max_new_tokens": 6})
    assert rs == ps == 200
    assert ph["Content-Type"] == rh["Content-Type"] == "application/x-ndjson"
    want, got = [json.loads(x) for x in rl], [json.loads(x) for x in pl]
    assert got[-1]["done"] is True and got[-1]["finish_reason"] == "length"
    assert got[-1]["tokens"] == want[-1]["tokens"]
    assert len(got[-1]["tokens"]) == 6
    np.testing.assert_allclose(got[-1]["logprobs"], want[-1]["logprobs"],
                               atol=1e-5)
    # the streamed lines carry the same tokens, logprobs and text
    assert [x["token"] for x in got[:-1]] == got[-1]["tokens"]
    assert [x["text"] for x in got[:-1]] == [x["text"] for x in want[:-1]]
    np.testing.assert_allclose([x["logprob"] for x in got[:-1]],
                               got[-1]["logprobs"])


def _same_completion(want, got):
    assert got["object"] == want["object"]
    assert got["usage"] == want["usage"]
    assert len(got["choices"]) == len(want["choices"])
    for w, g in zip(want["choices"], got["choices"]):
        lw, lg = w.pop("logprobs"), g.pop("logprobs")
        assert g == w
        if lw is None:
            assert lg is None
        else:
            assert lg["tokens"] == lw["tokens"]
            np.testing.assert_allclose(lg["token_logprobs"],
                                       lw["token_logprobs"], atol=1e-5)


@pytest.mark.parametrize("body", [
    {"prompt": "ab", "max_tokens": 6},
    {"prompt": [5, 9, 3], "max_tokens": 4, "n": 2, "logprobs": 1},
    {"prompt": [[5, 9, 3], "xy"], "max_tokens": 3},
    {"prompt": "ab", "max_tokens": 3, "best_of": 2},
    {"prompt": "ab", "max_tokens": 3, "response_format": {"type": "text"}},
], ids=["text", "n_logprobs", "two_prompts", "best_of", "format_text"])
def test_completions_same_choices(pair, body):
    (rs, _, rl), (ps, _, pl) = _both(pair, "/v1/completions", body)
    assert rs == ps == 200
    _same_completion(json.loads(rl[0]), json.loads(pl[0]))


def test_completions_stop_tokens(pair):
    """A token-id stop sequence taken from the greedy output ends both
    completions before it, with finish_reason "stop"."""
    toks = _json(pair.port, "/generate", {"tokens": [5, 9, 3],
                                          "max_new_tokens": 8})["tokens"]
    body = {"prompt": [5, 9, 3], "max_tokens": 8, "stop": [toks[2:4]]}
    (rs, _, rl), (ps, _, pl) = _both(pair, "/v1/completions", body)
    want, got = json.loads(rl[0]), json.loads(pl[0])
    assert got["choices"][0]["finish_reason"] == "stop"
    assert got["usage"]["completion_tokens"] < 8
    _same_completion(want, got)


def test_completions_sse_stream(pair):
    body = {"prompt": "ab", "max_tokens": 6, "stream": True}
    (rs, rh, rl), (ps, ph, pl) = _both(pair, "/v1/completions", body)
    assert rs == ps == 200
    assert ph["Content-Type"] == rh["Content-Type"] == "text/event-stream"
    want, got = _sse(rl), _sse(pl)
    text = "".join(e["choices"][0]["text"] for e in got)
    assert text == "".join(e["choices"][0]["text"] for e in want)
    assert got[-1]["choices"][0]["finish_reason"] == "length"
    assert want[-1]["choices"][0]["finish_reason"] == "length"
    plain = _json(pair.port, "/v1/completions",
                  {"prompt": "ab", "max_tokens": 6})
    assert text == plain["choices"][0]["text"]


def test_chat_plain_and_stream(pair):
    body = {"messages": [{"role": "system", "content": "s"},
                         {"role": "user", "content": "hi"}],
            "max_tokens": 6}
    (_, _, rl), (_, _, pl) = _both(pair, "/v1/chat/completions", body)
    want, got = json.loads(rl[0]), json.loads(pl[0])
    assert got["object"] == "chat.completion"
    assert got["choices"] == want["choices"]
    assert got["usage"] == want["usage"]
    (_, _, rl), (_, _, pl) = _both(pair, "/v1/chat/completions",
                                   {**body, "stream": True})
    want_ev, got_ev = _sse(rl), _sse(pl)
    assert got_ev[0]["choices"][0]["delta"] == {"role": "assistant"}

    def content(events):
        return "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events)

    assert content(got_ev) == content(want_ev) == \
        got["choices"][0]["message"]["content"]
    assert got_ev[-1]["choices"][0]["finish_reason"] == \
        want_ev[-1]["choices"][0]["finish_reason"]


def test_models_and_healthz(pair):
    assert _json(pair.port, "/v1/models") == _json(pair.ref, "/v1/models")
    want, got = _json(pair.ref, "/healthz"), _json(pair.port, "/healthz")
    assert got == want == {"ok": True, "ready": True, "active": 0,
                           "pending": 0}


def test_healthz_readiness_tracks_drain(weights):
    """`ready` flips false while the backend drains and back on resume,
    and stays false once it stops; `ok` stays true throughout."""
    srv = PagedInferenceServer(weights[1], _tcfg(CFG),
                               TInferConfig(**dataclasses.asdict(GREEDY)),
                               device="cpu", **SRV_KW).start()
    front = None
    try:
        front = HttpFrontend(srv).start()
        assert _json(front, "/healthz") == {"ok": True, "ready": True,
                                            "active": 0, "pending": 0}
        assert srv.drain() is True  # idle: quiesces at once
        h = _json(front, "/healthz")
        assert h["ok"] is True and h["ready"] is False
        with pytest.raises(RuntimeError, match="draining"):
            srv.submit([1, 2], max_new_tokens=2)
        srv.resume()
        assert _json(front, "/healthz")["ready"] is True
        srv.stop()
        assert _json(front, "/healthz")["ready"] is False
    finally:
        if front is not None:
            front.stop()
        srv.stop()


# --------------------------------------------------------------------------
# the same errors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method,path,data", [
    ("POST", "/generate", b"{not json"),
    ("POST", "/generate", b'{"nonsense": 1}'),
    ("POST", "/generate", b'[1, 2]'),
    ("POST", "/v1/completions", b'{"prompt": "ab", "temperature": -2.0}'),
    ("POST", "/v1/completions", b'{"prompt": "ab", "n": 0}'),
    ("POST", "/v1/chat/completions", b'{"messages": []}'),
    ("POST", "/bogus", b'{"tokens": [1]}'),
    ("GET", "/bogus", None),
    ("GET", "/stats?n=x", None),
], ids=["bad_json", "no_prompt", "not_object", "temperature", "n",
        "messages", "post_404", "get_404", "bad_query"])
def test_same_error_answers(pair, method, path, data):
    """400 for malformed requests and 404 for unknown paths, with the
    reference's bodies."""
    got = _request(pair.port, path, data=data)
    want = _request(pair.ref, path, data=data)
    assert got[0] == want[0] and got[0] in (400, 404)
    assert got[2] == want[2]


def test_queue_full_answers_429(weights):
    """Neither scheduler runs, so the one pending seat stays taken: both
    frontends answer 429 with a Retry-After header and the same body."""
    p = _Pair(weights, start=False, max_pending=1)
    try:
        held = [p.ref_srv.submit([5, 9, 3], max_new_tokens=2),
                p.port_srv.submit([5, 9, 3], max_new_tokens=2)]
        body = {"prompt": [5, 9, 3], "max_tokens": 4}
        want = _request(p.ref, "/v1/completions", body)
        got = _request(p.port, "/v1/completions", body)
        assert got[0] == want[0] == 429
        assert got[1]["Retry-After"] == want[1]["Retry-After"] == "1"
        assert json.loads(got[2][0]) == json.loads(want[2][0])
        stream = _request(p.port, "/generate", {"tokens": [1, 2]})
        assert stream[0] == 429
        held[1].cancel()
        assert held[1].finish_reason == "cancelled"
    finally:
        p.close()


# --------------------------------------------------------------------------
# the same metrics
# --------------------------------------------------------------------------


def _prom(front):
    status, headers, lines = _request(front, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith(
        "text/plain")
    values = dict(ln.rsplit(" ", 1) for ln in lines
                  if not ln.startswith("#"))
    families = {ln.split()[2] for ln in lines if ln.startswith("# TYPE")}
    return values, families


def test_metrics_counts_match_reference(weights):
    """The same request sequence on fresh servers: TTFT, ITL, queue-wait
    and e2e histogram counts and the lifecycle counters equal the
    reference's; ITL counts tokens - 1 per request; the port's metric
    families are a subset of the reference's; /stats agrees."""
    p = _Pair(weights)
    try:
        news = [6, 3, 1]
        for i, n in enumerate(news):
            _json(p.port, "/generate", {"tokens": [5 + i, 9, 3],
                                        "max_new_tokens": n})
            _json(p.ref, "/generate", {"tokens": [5 + i, 9, 3],
                                       "max_new_tokens": n})
        for front in (p.port, p.ref):
            _sse(_request(front, "/v1/completions",
                          {"prompt": "ab", "max_tokens": 4,
                           "stream": True})[2])
        news.append(4)
        got, got_fam = _prom(p.port)
        want, want_fam = _prom(p.ref)
        assert got_fam <= want_fam
        for name in ("ttft_seconds_count", "itl_seconds_count",
                     "queue_wait_seconds_count", "e2e_seconds_count",
                     "requests_submitted_total", "requests_finished_total",
                     "tokens_emitted_total", "preemptions_total",
                     "pages_total", "pages_active"):
            key = f"cloud_server_{name}"
            assert float(got[key]) == float(want[key]), name
        assert float(got["cloud_server_ttft_seconds_count"]) == len(news)
        assert float(got["cloud_server_itl_seconds_count"]) == sum(
            n - 1 for n in news)
        assert float(got["cloud_server_tokens_emitted_total"]) == sum(news)
        assert 'cloud_server_itl_seconds_bucket{le="+Inf"}' in got
        stats = _json(p.port, "/stats?n=4")
        ref_stats = _json(p.ref, "/stats?n=4")
        for name in ("cloud_server_ttft_seconds", "cloud_server_itl_seconds",
                     "cloud_server_queue_wait_seconds"):
            assert stats["latency"][name]["count"] == \
                ref_stats["latency"][name]["count"]
        # the flight recorder, the overlap block, the iteration profile,
        # the speculation summary, the cache and the migration ledger
        # answer as the reference's do; the policy blocks (brownout,
        # faults, anomaly, tail retention) appear only when configured
        assert {"active", "pending", "latency", "counters", "gauges",
                "flight_recorder", "overlap", "iteration_profile",
                "speculation", "cache", "migration"} == set(stats)
        assert stats["speculation"] == ref_stats["speculation"]
        assert set(stats) <= set(ref_stats)
        assert stats["overlap"] == {"enabled": True, "active": True,
                                    "inflight_depth": 0}
        # the reference pair runs sequentially: its records carry every
        # field but the pipelined iterations' own
        ref_keys = set().union(*ref_stats["flight_recorder"]) | {
            "overlap", "inflight_depth", "overlap_launch_lead_ms",
            "overlap_ms", "t_launch"}
        assert stats["flight_recorder"]
        for rec in stats["flight_recorder"]:
            assert set(rec) <= ref_keys
        assert stats["counters"]["cloud_server_requests_finished_total"] == 4
    finally:
        p.close()


# --------------------------------------------------------------------------
# 501 for what a backend does not have
# --------------------------------------------------------------------------

UNPORTED = [
    ("/v1/embeddings", {"input": "ab"}, "embed"),
]


class _Unserved:
    """A port server whose `embed` is refused as an unported feature is
    (a NotImplementedError naming it); everything else is the server's."""

    def __init__(self, srv):
        self._srv = srv

    def __getattr__(self, name):
        return getattr(self._srv, name)

    def embed(self, prompts):
        raise NotImplementedError("embed is not ported to this backend")


@pytest.mark.parametrize("path,body,feature", UNPORTED,
                         ids=[f"{p}-{f}" for p, _, f in UNPORTED])
def test_unported_options_answer_501(pair, path, body, feature):
    """A backend that raises NotImplementedError for a route's feature:
    the frontend answers 501 with a JSON error naming the feature, before
    any header of a streaming response; the server keeps serving."""
    front = HttpFrontend(_Unserved(pair.port_srv),
                         tokenizer=ByteTokenizer()).start()
    try:
        status, headers, lines = _request(front, path, body)
        assert status == 501
        assert headers["Content-Type"] == "application/json"
        err = json.loads(lines[0])["error"]
        assert feature in err and "not ported" in err
        assert pair.port_srv.num_pending == 0
        ok = _json(front, "/generate", {"tokens": [1, 2],
                                        "max_new_tokens": 2})
        assert len(ok["tokens"]) == 2
    finally:
        front.stop()


def test_embeddings_match_reference(pair):
    """/v1/embeddings over a string, a token list and a list of both:
    200 with the reference frontend's body — the same keys, model and
    usage, and vectors within 1e-5 — and the in-process vectors."""
    for body in ({"input": "hello"}, {"input": [5, 9, 3]},
                 {"input": ["ab", [7] * 20, "a longer input text"],
                  "model": "m"}):
        got = _json(pair.port, "/v1/embeddings", body)
        want = _json(pair.ref, "/v1/embeddings", body)
        assert {k: v for k, v in got.items() if k != "data"} == \
            {k: v for k, v in want.items() if k != "data"}
        assert [sorted(d) for d in got["data"]] == \
            [sorted(d) for d in want["data"]]
        vecs = np.asarray([d["embedding"] for d in got["data"]])
        np.testing.assert_allclose(
            vecs, [d["embedding"] for d in want["data"]], rtol=0,
            atol=1e-5)
    np.testing.assert_allclose(
        vecs, pair.port_srv.embed([ByteTokenizer().encode("ab"), [7] * 20,
                                   ByteTokenizer().encode(
                                       "a longer input text")]),
        rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the read-only routes and the profiler window
# --------------------------------------------------------------------------


def _served(weights, contiguous):
    p = _Pair(weights, port_kw=dict(overlap=False), contiguous=contiguous)
    try:
        for front in (p.ref, p.port):
            _json(front, "/generate", {"tokens": [5, 9, 3],
                                       "max_new_tokens": 4})
            _json(front, "/generate", {"tokens": [5, 9, 3, 7],
                                       "max_new_tokens": 3})
        return p
    except BaseException:
        p.close()
        raise


@pytest.fixture(scope="module")
def served_pair(weights):
    """A fresh pair, both sequential (so the page flows are the same),
    that has served the same two requests."""
    p = _served(weights, False)
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(scope="module")
def served_contiguous(weights):
    """The same, over the two contiguous servers."""
    p = _served(weights, True)
    try:
        yield p
    finally:
        p.close()


READ_ROUTES = ["/healthz", "/v1/models", "/metrics", "/stats", "/stats?n=2",
               "/slo", "/autoscaler", "/traces", "/traces?n=2",
               "/debug/cache", "/debug/bundle", "/debug/bundle?n=2",
               "/debug/bundle?ring=2", "/debug/scheduler_trace?n=4",
               "/debug/requests/nonexistent"]
# values that depend on neither time nor the pipeline's configuration
SAME_VALUES = {"/debug/cache": None, "/slo": None, "/autoscaler": None,
               "/debug/bundle?ring=2": None, "/traces": None,
               "/traces?n=2": None,
               "/debug/bundle": ("schema", "trigger", "anomaly", "slo",
                                 "brownout", "faults", "tail_retention",
                                 "migration", "cache", "traces",
                                 "tail_traces"),
               "/stats": ("active", "pending", "cache", "migration",
                          "speculation")}


def _keys(obj, depth=2):
    """The key structure of a JSON answer, `depth` levels of dicts."""
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


@pytest.mark.parametrize("path", READ_ROUTES)
def test_read_only_routes_answer_like_the_reference(served_pair, path):
    """Every GET route: the reference's status code, content type and
    key set (two levels deep); the reference's values where they depend
    on neither time nor the overlap switch. /debug/cache,
    /debug/bundle and /traces, and the /stats cache block, were 404s
    and absent before the port's server had cache_stats, debug_bundle
    and trace_trees."""
    _check_read_route(served_pair, path)


@pytest.mark.parametrize("path", READ_ROUTES)
def test_read_only_routes_answer_like_the_reference_contiguous(
        served_contiguous, path):
    """The same routes over the contiguous servers: the reference's
    statuses, keys and values (its 404s for the paged server's routes
    included)."""
    _check_read_route(served_contiguous, path)


def _check_read_route(served_pair, path):
    want = _request(served_pair.ref, path)
    got = _request(served_pair.port, path)
    assert got[0] == want[0], (path, got[0], got[2][:1])
    assert (got[1]["Content-Type"].split(";")[0]
            == want[1]["Content-Type"].split(";")[0])
    if path == "/metrics":
        fam = {ln.split()[2] for ln in got[2] if ln.startswith("# TYPE")}
        ref_fam = {ln.split()[2] for ln in want[2]
                   if ln.startswith("# TYPE")}
        assert fam <= ref_fam
        return
    g, w = json.loads(got[2][0]), json.loads(want[2][0])
    if path.startswith("/debug/scheduler_trace"):
        assert set(g) == set(w)
        return
    assert _keys(g) == _keys(w) if path != "/v1/models" else g == w
    same = SAME_VALUES.get(path.split("?")[0] if path.startswith("/stats")
                           else path, ())
    if same is None:
        assert g == w
    else:
        for key in same:
            if key in w:
                assert g[key] == w[key], key


def test_debug_trace_writes_a_profiler_trace(served_pair, tmp_path):
    """POST /debug/trace answers as the reference's, and the next two
    scheduler iterations land in a torch.profiler trace in `logdir`
    (Chrome-trace JSON that TensorBoard and Perfetto open); a second
    window while one is armed is a 400, as in the reference."""
    body = {"steps": 2, "logdir": str(tmp_path)}
    status, _, lines = _request(served_pair.port, "/debug/trace", body)
    assert status == 200
    assert json.loads(lines[0]) == {"ok": True, "steps": 2,
                                    "logdir": str(tmp_path)}
    busy = _request(served_pair.port, "/debug/trace", body)
    assert busy[0] == 400 and "already in progress" in busy[2][0]
    out = _json(served_pair.port, "/generate", {"tokens": [5, 9, 3],
                                                "max_new_tokens": 4})
    assert len(out["tokens"]) == 4
    deadline = time.time() + 30
    while served_pair.port_srv.tracer.active and time.time() < deadline:
        time.sleep(0.01)
    assert not served_pair.port_srv.tracer.active
    files = sorted(tmp_path.rglob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


# --------------------------------------------------------------------------
# penalties, logit_bias, min_tokens, regex and response_format
# --------------------------------------------------------------------------

CHAT = [{"role": "user", "content": "hi"}]
DECODING = [
    ("/generate", {"tokens": [5, 9, 3], "presence_penalty": 0.5}),
    ("/generate", {"tokens": [5, 9, 3], "logit_bias": {"42": 3.0}}),
    ("/generate", {"tokens": [5, 9, 3], "min_tokens": 4}),
    ("/generate", {"tokens": [5, 9, 3], "regex": "[ab]+"}),
    ("/v1/completions", {"prompt": "ab", "frequency_penalty": 0.3}),
    ("/v1/completions", {"prompt": "ab", "repetition_penalty": 1.2,
                         "stream": True}),
    ("/v1/completions", {"prompt": "ab", "logit_bias": {"7": 1.0},
                         "n": 2}),
    ("/v1/completions", {"prompt": "ab",
                         "response_format": {"type": "json_object"}}),
    ("/v1/chat/completions", {"messages": CHAT, "response_format": {
        "type": "json_schema", "json_schema": {"schema": {
            "type": "object", "properties": {"a": {"type": "integer"}},
            "required": ["a"]}}}}),
    ("/v1/chat/completions", {"messages": CHAT, "min_tokens": 1,
                              "stream": True}),
]
DECODING_IDS = ["generate-penalties", "generate-logit_bias",
                "generate-min_tokens", "generate-regex",
                "completions-penalties", "completions-penalties_stream",
                "completions-logit_bias_n", "completions-json_object",
                "chat-json_schema", "chat-min_tokens_stream"]


@pytest.fixture(scope="module")
def decoding_pair(weights):
    """Both servers with the byte tokenizer (regex compiles against it)
    and its EOS (a grammar ends on EOS at an accepting state), n-gram
    speculation on."""
    tok = ByteTokenizer()
    icfg = dataclasses.replace(GREEDY, eos_token_id=tok.eos_id,
                               max_decode_len=12)
    p = _Pair(weights, icfg=icfg, spec_drafts=2, max_slots=4,
              max_context=128, ref_kw={"tokenizer": get_tokenizer("byte")},
              port_kw={"tokenizer": tok})
    try:
        yield p
    finally:
        p.close()


def _text_of(path, lines):
    if path == "/generate":
        return json.loads(lines[-1])["tokens"]
    if lines[-1] == "data: [DONE]":
        return [e["choices"][0].get("text", e["choices"][0].get(
            "delta", {}).get("content", "")) for e in _sse(lines)]
    out = json.loads(lines[0])
    return [c.get("text", c.get("message")) for c in out["choices"]]


@pytest.mark.parametrize("path,body", DECODING, ids=DECODING_IDS)
def test_decoding_options_answer_like_the_reference(decoding_pair, path,
                                                    body):
    """What answered 501 before (penalties, logit_bias, min_tokens,
    regex, response_format json_object and json_schema) now answers 200
    with the reference server's tokens and text, through n-gram
    speculation."""
    (rs, _, rl), (ps, _, pl) = _both(decoding_pair, path,
                                     {**body, "max_tokens": 12,
                                      "max_new_tokens": 12})
    assert rs == ps == 200, (rl, pl)
    assert _text_of(path, pl) == _text_of(path, rl)


def test_json_object_output_is_json(decoding_pair):
    """A finished json_object completion parses as a JSON object."""
    out = _json(decoding_pair.port, "/v1/completions", {
        "prompt": "{", "max_tokens": 64,
        "response_format": {"type": "json_object"}})
    choice = out["choices"][0]
    if choice["finish_reason"] == "stop":
        assert isinstance(json.loads(choice["text"]), dict)
    else:
        assert choice["text"].startswith("{")


def test_stats_carry_speculation(decoding_pair):
    _json(decoding_pair.port, "/generate", {"tokens": [3, 4, 5, 3, 4, 5,
                                                       3, 4],
                                            "max_new_tokens": 8})
    _json(decoding_pair.ref, "/generate", {"tokens": [3, 4, 5, 3, 4, 5,
                                                      3, 4],
                                           "max_new_tokens": 8})
    spec = _json(decoding_pair.port, "/stats")["speculation"]
    want = _json(decoding_pair.ref, "/stats")["speculation"]
    assert spec["source"] == "ngram" and spec["max_drafts"] == 2
    assert spec["tokens_drafted"] > 0
    assert set(spec) == set(want)
    metrics = _request(decoding_pair.port, "/metrics")[2]
    assert any(ln.startswith("cloud_server_spec_tokens_drafted_total")
               for ln in metrics)


# --------------------------------------------------------------------------
# the int8 KV cache over HTTP, the access log, the CLI, disconnects
# --------------------------------------------------------------------------


def test_int8_round_trip(weights, tmp_path):
    """Both servers on an int8 cache: a streamed completion and a
    /generate give the same tokens; the access log records each request
    as one JSON line."""
    log = tmp_path / "access.jsonl"
    p = _Pair(weights, cfg=dataclasses.replace(CFG, kv_cache_dtype="int8"),
              front_kw={"access_log": str(log)})
    try:
        assert str(p.port_srv.k_pool.dtype) == "torch.int8"
        body = {"prompt": [5, 9, 3], "max_tokens": 7, "stream": True}
        want = _sse(_request(p.ref, "/v1/completions", body)[2])
        got = _sse(_request(p.port, "/v1/completions", body)[2])
        assert [e["choices"][0]["text"] for e in got] == \
            [e["choices"][0]["text"] for e in want]
        gen = {"tokens": [17, 2, 40, 8], "max_new_tokens": 6}
        assert _json(p.port, "/generate", gen)["tokens"] == \
            _json(p.ref, "/generate", gen)["tokens"]
    finally:
        p.close()
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    access = [r for r in recs if r.get("event") == "access"]
    assert [(r["method"], r["path"], r["status"]) for r in access] == [
        ("POST", "/v1/completions", 200), ("POST", "/generate", 200)]
    assert all(r["duration_ms"] >= 0 and r["request_id"] for r in access)


def test_disconnect_cancels_streaming_request(weights):
    """A /generate client that walks away mid-stream: its request is
    cancelled long before its budget and the server keeps serving."""
    if not loopback_disconnect_detectable():
        pytest.skip("a loopback peer's close never surfaces as a send "
                    "error here (tests/net_compat.py)")
    icfg = dataclasses.replace(GREEDY, max_decode_len=200)
    srv = PagedInferenceServer(
        weights[1], _tcfg(CFG), TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", max_slots=2, max_context=256, page_size=8,
        prefill_chunk=16, prompt_buckets=[16]).start()
    front = None
    try:
        front = HttpFrontend(srv).start()
        host, port = front.address
        body = json.dumps({"tokens": [5, 9, 3],
                           "max_new_tokens": 200}).encode()
        s = socket.create_connection((host, port), timeout=30)
        s.sendall((f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        s.recv(1024)  # generation is running
        s.close()
        deadline = time.time() + 60

        def cancelled():
            return srv.metrics_snapshot()[
                "cloud_server_requests_cancelled_total"]["value"]

        # the response's first bytes can arrive before the request is
        # admitted, when it is in neither num_active nor _jobs: wait for
        # the cancellation to be counted, then for the server to drain
        while time.time() < deadline and (
                cancelled() == 0 or srv.num_active or srv._jobs):
            time.sleep(0.05)
        assert srv.num_active == 0 and srv.tokens_emitted < 150
        snap = srv.metrics_snapshot()
        assert snap["cloud_server_requests_cancelled_total"]["value"] == 1
        r = srv.submit([5, 9, 3], max_new_tokens=4)
        assert len(r.result(timeout=TIMEOUT)) == 4
    finally:
        if front is not None:
            front.stop()
        srv.stop()


def test_generate_cli_serves_int8_over_http(tmp_path):
    """`generate --device cpu --kv-cache-int8 --serve-http 0` binds a free
    port, serves a completion on the int8 cache and stops on SIGINT."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"model": {
        "vocab_size": 300, "embed_dim": 32, "num_layers": 2,
        "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "mlp_dim": 64,
        "max_seq_len": 64, "dtype": "float32", "param_dtype": "float32"}}))
    log = tmp_path / "access.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cloud_server_tpu_torch.generate",
         "--config", str(cfg), "--device", "cpu", "--kv-cache-int8",
         "--serve-http", "0", "--page-size", "8", "--prefill-chunk", "16",
         "--max-slots", "2", "--temperature", "0", "--access-log", str(log)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
    try:
        addr = None
        deadline = time.time() + TIMEOUT
        while addr is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            if "serving on http://" in line:
                addr = line.split("http://")[1].split()[0]
        assert addr is not None, "the server never reported its address"
        req = urllib.request.Request(
            f"http://{addr}/v1/completions",
            data=json.dumps({"prompt": "hi", "max_tokens": 5}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            comp = json.loads(resp.read())
        assert comp["usage"]["completion_tokens"] == 5
        assert comp["choices"][0]["finish_reason"] == "length"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    access = [r for r in map(json.loads, log.read_text().splitlines())
              if r.get("event") == "access"]
    assert [(r["path"], r["status"]) for r in access] == [
        ("/v1/completions", 200)]
