"""HTTP front-end for the port's paged continuous-batching server.

A port of the reference's `HttpFrontend` (inference/http_server.py
there): a thin stdlib (`http.server`) layer over the server's `submit`
API that does only sockets and JSON. The endpoints and their payloads
are the reference's:

  POST /generate    {"prompt": "text"} or {"tokens": [...]}, optional
                    "max_new_tokens" and per-request sampling fields;
                    `application/x-ndjson`: one {"token", "logprob",
                    "text"} line per token, then {"done": true,
                    "finish_reason", "tokens", "logprobs"}.
  POST /v1/completions        OpenAI-compatible completion: prompt
                    (string, token list, or list of either), max_tokens,
                    temperature, top_p, stop, seed, n, best_of, logprobs,
                    penalties, logit_bias, min_tokens, response_format,
                    stream (SSE chunks, final `data: [DONE]`).
  POST /v1/chat/completions   OpenAI-compatible chat through a minimal
                    role-tagged template (or the tokenizer's own); stream
                    sends `chat.completion.chunk` deltas.
  POST /debug/trace {"steps": N, "logdir": optional}: the next N
                    scheduler iterations in a torch.profiler window
                    (utils.tracing.capture_trace); answers the logdir.
  POST /v1/embeddings   input a string, a token list, or a list of
                    either: the backend's mean-pooled, L2-normalised
                    embeddings.
  GET  /v1/models, /healthz ({"ok", "ready", "active", "pending"};
                    "ready" is false while the backend drains or after
                    stop()), /metrics (Prometheus text of the backend's
                    registry), /stats (histogram summaries, counters,
                    gauges, the flight window, the cache and migration
                    blocks, and the policy blocks a configured server
                    has).
  GET  /slo, /autoscaler, /traces, /debug/requests/<id>, /debug/cache,
                    /debug/scheduler_trace, /debug/bundle (?ring=k)   the
                    reference's duck-typed probes, answered from the
                    backend method each needs ({"enabled": false} for
                    /slo without an SLO config, /autoscaler without a
                    router).

Tenants come from `X-Tenant` or an API key the backend's QoS registry
maps, `X-Deadline-S` sets a request's deadline, and a W3C `traceparent`
joins a caller's trace, as in the reference; brownout and per-tenant
refusals are 429s with `Retry-After`.

Status codes: 400 for malformed requests (the reference's rule: a
ValueError, TypeError, KeyError or AttributeError raised while parsing or
submitting), 404 for unknown paths, 429 with a `Retry-After` header when
the backend's `max_pending` bound refuses a submit, 503 when the
scheduler has stopped. New in the port: a request for something the
backend does not have yet answers **501** with a JSON `{"error": ...}`
naming the feature. The server raises `NotImplementedError` for those
(tensor parallelism is still refused at construction),
also when `submit` raises inside a
streaming request before any header is sent; the frontend never turns
it into a 500, a dropped connection or a stream that hangs. Penalties,
`logit_bias`, `min_tokens`, `regex` and `response_format` (json_object,
json_schema) are served as the reference serves them.

Lifecycle: a streaming client that disconnects mid-generation cancels
its request (the scheduler frees the slot and pages within one step).
Streaming text is the suffix each token adds to the decoded string,
with a trailing partial UTF-8 sequence held back until complete.
Access logging is opt-in (`access_log=`): one JSON line per request
through utils.logging.JsonLogger.

    python -m cloud_server_tpu_torch.generate --serve-http 8000 ...
    curl -N -s localhost:8000/v1/completions \
      -d '{"prompt": "hi", "max_tokens": 8, "stream": true}'
"""

from __future__ import annotations

import json
import math
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from cloud_server_tpu_torch.inference.grammar import (json_object_regex,
                                                     json_schema_regex)
from cloud_server_tpu_torch.inference.iteration_profile import (
    profile_summary, scheduler_chrome_trace)
from cloud_server_tpu_torch.inference.request_trace import (
    TRACEPARENT_HEADER, chrome_trace, format_traceparent,
    parse_traceparent)
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.inference.server import QueueFullError
from cloud_server_tpu_torch.utils.logging import JsonLogger
from cloud_server_tpu_torch.utils.serving_metrics import (
    histogram_summary, render_prometheus)

_STREAM_END = object()

# JSON body field -> SamplingParams field (shared by all POST endpoints;
# OpenAI aliases are folded in by the endpoint parsers)
_SAMPLING_FIELDS = ("temperature", "top_k", "top_p", "min_p",
                    "repetition_penalty", "presence_penalty",
                    "frequency_penalty", "seed", "ignore_eos",
                    "min_tokens", "regex")


def _parse_stop(stop, tokenizer) -> tuple[tuple[int, ...], ...]:
    """OpenAI `stop`: string | [strings] | [[token ids]] -> id tuples."""
    if stop is None:
        return ()
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list):
        raise ValueError('"stop" must be a string or a list')
    out = []
    for s in stop:
        if isinstance(s, str):
            if tokenizer is None:
                raise ValueError(
                    "string stop sequences need a tokenizer; send token-id "
                    "lists instead")
            ids = tokenizer.encode(s)
            if ids:
                out.append(tuple(ids))
        elif (isinstance(s, list)
              and all(isinstance(t, int) for t in s) and s):
            out.append(tuple(s))
        else:
            raise ValueError('"stop" entries must be non-empty strings or '
                             "token-id lists")
    return tuple(out)


def _parse_sampling(body: dict, tokenizer) -> SamplingParams | None:
    """SamplingParams from a JSON body; None when every field is absent
    (keeps the server's zero-overhead default path)."""
    kw = {}
    for f in _SAMPLING_FIELDS:
        if body.get(f) is not None:
            kw[f] = body[f]
    stop = _parse_stop(body.get("stop"), tokenizer)
    if stop:
        kw["stop"] = stop
    bias = body.get("logit_bias")
    if bias:
        if not isinstance(bias, dict):
            raise ValueError('"logit_bias" must be an object mapping '
                             "token ids to biases")
        try:
            kw["logit_bias"] = tuple(
                (int(t), float(b)) for t, b in bias.items())
        except (TypeError, ValueError) as exc:
            raise ValueError(f'bad "logit_bias": {exc}') from exc
    if not kw:
        return None
    try:
        return SamplingParams(**kw)
    except TypeError as exc:  # wrong field types surface as 400s
        raise ValueError(str(exc)) from exc


class _TextStream:
    """Incremental decode: feed token ids, get the newly-stable text
    suffix (holds back a trailing partial UTF-8 sequence)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.sent = 0

    def feed(self, ids) -> str:
        if self.tokenizer is None:
            return ""
        self.ids.extend(ids)
        text = self.tokenizer.decode(self.ids)
        # hold back trailing replacement chars (partial multi-byte seq)
        stable = len(text)
        while stable > 0 and text[stable - 1] == "�":
            stable -= 1
        delta = text[self.sent:stable]
        self.sent = stable
        return delta

    def flush(self) -> str:
        if self.tokenizer is None:
            return ""
        text = self.tokenizer.decode(self.ids)
        delta = text[self.sent:]
        self.sent = len(text)
        return delta


def _render_chat(messages, tokenizer) -> str:
    """Messages -> prompt text. Uses the tokenizer's own chat template
    when it has one (HF fast tokenizers may); otherwise a minimal
    role-tagged format that is stable across requests (so the radix
    prefix cache hits on shared conversation heads)."""
    tpl = getattr(tokenizer, "apply_chat_template", None)
    if tpl is not None:
        # transformers' apply_chat_template defaults to tokenize=True
        # (returning ids); this function's contract is TEXT
        return tpl(messages, add_generation_prompt=True, tokenize=False)
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if not isinstance(content, str):
            raise ValueError("message content must be a string")
        parts.append(f"<|{role}|>\n{content}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


def _finish(reason: str | None) -> str:
    # OpenAI reports "stop" for natural ends (eos or a stop sequence)
    return "length" if reason == "length" else "stop"


def _query_int(url, name: str, default: int | None) -> int | None:
    """Integer query parameter (?n=K), `default` when absent; raises
    ValueError on junk (callers map it to a 400). THE one parser for
    the windowed GET endpoints (/stats, /traces)."""
    raw = parse_qs(url.query).get(name)
    return default if not raw else int(raw[0])


class HttpFrontend:
    """Bind a serving backend (+ optional tokenizer) to an HTTP port.

    `srv` is a `PagedInferenceServer` or `InferenceServer` (any object
    with submit/num_active/num_pending). Its scheduler must be running
    (srv.start()) or be driven externally; this class never steps it.
    """

    def __init__(self, srv, tokenizer=None,
                 host: str = "127.0.0.1", port: int = 0,
                 model_id: str = "cloud-server-tpu",
                 access_log: bool | str | os.PathLike | JsonLogger
                 | None = None):
        self.srv = srv
        self.tokenizer = tokenizer
        self.model_id = model_id
        # opt-in structured access log: True -> JSON lines on stderr,
        # a path -> JSONL file, or a ready JsonLogger-like object
        self._owns_log = access_log is True or isinstance(
            access_log, (str, os.PathLike))
        if access_log is True:
            self.access_log = JsonLogger()
        elif isinstance(access_log, (str, os.PathLike)):
            self.access_log = JsonLogger(path=access_log)
        else:
            self.access_log = access_log or None
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                # stdlib plumbing (errors, odd requests): routed into
                # the structured log when enabled, silent otherwise
                if front.access_log is not None:
                    front.access_log.log({"event": "http_log",
                                          "message": fmt % args})

            def send_response(self, code, message=None):
                self._status = code  # remembered for the access record
                super().send_response(code, message)

            def _access(self, method: str, t0: float) -> None:
                if front.access_log is None:
                    return
                record = {
                    "event": "access", "method": method,
                    "path": self.path,
                    "status": getattr(self, "_status", None),
                    "duration_ms": round(
                        (time.perf_counter() - t0) * 1e3, 3),
                    "request_id": getattr(self, "_rid", None)}
                # trace/tenant correlation: present only when resolved
                # for this request, so untraced deployments' log shape
                # is unchanged
                tenant = getattr(self, "_tenant", None)
                if tenant:
                    record["tenant"] = tenant
                trace_id = getattr(self, "_trace_id", None)
                if trace_id:
                    record["trace_id"] = trace_id
                front.access_log.log(record)

            def _begin(self) -> float:
                self._rid = (self.headers.get("X-Request-Id")
                             or uuid.uuid4().hex[:12])
                self._status = None
                self._tenant = None
                self._trace_ctx = None
                self._trace_id = None
                self._deadline_s = None
                return time.perf_counter()

            def _json(self, code: int, payload: dict,
                      headers: dict | None = None) -> None:
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                t0 = self._begin()
                try:
                    self._do_get()
                finally:
                    self._access("GET", t0)

            def _do_get(self):
                url = urlparse(self.path)
                if url.path == "/healthz":
                    # ok = liveness; ready = routability (false while
                    # the backend drains or after stop(), so load
                    # balancers shed this replica without killing its
                    # in-flight work). Behind a ReplicatedRouter the
                    # payload gains per-replica circuit-breaker state.
                    payload = {"ok": True,
                               "ready": bool(getattr(
                                   front.srv, "ready", True)),
                               "active": front.srv.num_active,
                               "pending": front.srv.num_pending}
                    bfn = getattr(front.srv, "breaker_states", None)
                    if bfn is not None:
                        payload["replicas"] = bfn()
                    self._json(200, payload)
                elif url.path == "/slo":
                    fn = getattr(front.srv, "slo_report", None)
                    rep = fn() if fn is not None else None
                    self._json(200, rep if rep is not None
                               else {"enabled": False})
                elif url.path == "/autoscaler":
                    # scenario-harness hook: the SLO-burn autoscaler's
                    # live view (scenarios/autoscaler.py attaches it
                    # to the router it scales)
                    asc = getattr(front.srv, "autoscaler", None)
                    self._json(200, asc.stats() if asc is not None
                               else {"enabled": False})
                elif url.path == "/traces":
                    fn = getattr(front.srv, "trace_trees", None)
                    if fn is None:
                        self._json(404, {"error": "this serving backend "
                                         "does not support tracing"})
                        return
                    try:
                        n = _query_int(url, "n", None)
                    except ValueError:
                        self._json(400, {"error": '"n" must be an int'})
                        return
                    trees = fn(n)
                    # tail-retained trees join the export (disjoint
                    # from head-sampled by construction); anomaly
                    # windows become a Perfetto marker track
                    tfn = getattr(front.srv, "tail_trace_trees", None)
                    if tfn is not None:
                        trees = trees + tfn(n)
                    afn = getattr(front.srv, "anomaly_events", None)
                    self._json(200, chrome_trace(
                        trees,
                        anomalies=afn(n) if afn is not None else None))
                elif url.path.startswith("/debug/requests/"):
                    rid = url.path[len("/debug/requests/"):]
                    fn = getattr(front.srv, "lookup_trace", None)
                    tree = fn(rid) if fn is not None and rid else None
                    if tree is None:
                        self._json(404, {
                            "error": "unknown, unsampled, or evicted "
                            "request id (tracing must be enabled and "
                            "the request sampled)"})
                    else:
                        self._json(200, tree)
                elif url.path == "/debug/cache":
                    fn = getattr(front.srv, "cache_stats", None)
                    if fn is None:
                        self._json(404, {"error": "this serving "
                                         "backend has no paged KV "
                                         "cache"})
                        return
                    self._json(200, fn())
                elif url.path == "/debug/scheduler_trace":
                    fn = getattr(front.srv, "flight_window", None)
                    if fn is None:
                        self._json(404, {"error": "this serving backend "
                                         "has no flight recorder"})
                        return
                    try:
                        n = _query_int(url, "n", 64)
                    except ValueError:
                        self._json(400, {"error": '"n" must be an int'})
                        return
                    self._json(200, scheduler_chrome_trace(
                        fn(n) if n > 0 else []))
                elif url.path == "/debug/bundle":
                    fn = getattr(front.srv, "debug_bundle", None)
                    if fn is None:
                        self._json(404, {"error": "this serving "
                                         "backend has no debug "
                                         "bundles"})
                        return
                    try:
                        n = _query_int(url, "n", 64)
                        ring = _query_int(url, "ring", 0)
                    except ValueError:
                        self._json(400, {"error": '"n" and "ring" '
                                         'must be ints'})
                        return
                    if ring:
                        # ?ring=k: the last k AUTO-captured bundles
                        # (anomaly snapshots) instead of a fresh one
                        self._json(200, {"bundles":
                                         front.srv.debug_bundles(ring)})
                    else:
                        self._json(200, fn(n))
                elif url.path == "/metrics":
                    body = front._metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stats":
                    try:
                        n = _query_int(url, "n", 64)
                    except ValueError:
                        self._json(400, {"error": '"n" must be an int'})
                        return
                    self._json(200, front._stats_json(n))
                elif url.path == "/v1/models":
                    models = [{"id": front.model_id, "object": "model",
                               "owned_by": "cloud-server-tpu"}]
                    adapters = getattr(front.srv, "adapters", None)
                    if adapters is not None:
                        models += [{"id": n, "object": "model",
                                    "owned_by": "cloud-server-tpu",
                                    "parent": front.model_id}
                                   for n in adapters.names]
                    self._json(200, {"object": "list", "data": models})
                else:
                    self._json(404, {"error": "unknown path"})

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                return body

            def do_POST(self):
                t0 = self._begin()
                try:
                    self._do_post()
                finally:
                    self._access("POST", t0)

            def _do_post(self):
                routes = {"/generate": front._handle_generate,
                          "/v1/completions": front._handle_completions,
                          "/v1/chat/completions": front._handle_chat,
                          "/v1/embeddings": front._handle_embeddings,
                          "/debug/trace": front._handle_debug_trace}
                handler = routes.get(self.path)
                if handler is None:
                    self._json(404, {"error": "unknown path"})
                    return
                # multi-tenant QoS: tenant identity rides on headers
                # (X-Tenant, or an API key the registry maps), resolved
                # once per request and threaded into every submit
                self._tenant = front._resolve_tenant(self.headers)
                # distributed tracing: a W3C traceparent joins the
                # caller's trace (parsed once; malformed headers
                # degrade to a fresh trace, never an error)
                self._trace_ctx = parse_traceparent(
                    self.headers.get(TRACEPARENT_HEADER))
                if self._trace_ctx is not None:
                    self._trace_id = self._trace_ctx[0]
                try:
                    body = self._body()
                except (ValueError, json.JSONDecodeError) as exc:
                    self._json(400, {"error": str(exc)})
                    return
                # request deadline: X-Deadline-S seconds from now; the
                # scheduler sweep cancels the request once it passes
                # and the router stops failover retries past it.
                # Validated AFTER the body read: this handler speaks
                # HTTP/1.1 keep-alive, and a 400 sent with the body
                # unconsumed would desync the next request on the
                # connection. `not (x > 0)` so NaN (False both ways)
                # cannot slip through as a never-expiring deadline.
                raw_dl = self.headers.get("X-Deadline-S")
                if raw_dl is not None:
                    try:
                        dl = float(raw_dl)
                        if not (math.isfinite(dl) and dl > 0):
                            raise ValueError
                        self._deadline_s = dl
                    except ValueError:
                        self._json(400, {
                            "error": "X-Deadline-S must be a finite "
                            "positive number of seconds"})
                        return
                try:
                    handler(self, body)
                except NotImplementedError as exc:
                    # a feature the port does not have yet (before the
                    # RuntimeError clause: NotImplementedError is one)
                    self._json(501, {"error": str(exc)})
                except (ValueError, TypeError, KeyError,
                        AttributeError) as exc:
                    # type-confused bodies (e.g. {"prompt": 123},
                    # non-object messages) surface wherever they break —
                    # all are client errors, never handler-thread crashes
                    self._json(400, {"error": str(exc)})
                except QueueFullError as exc:  # backpressure, retryable
                    # structured 429: clients get machine-readable retry
                    # guidance instead of a bare string. Per-tenant
                    # rejections (TenantQueueFullError) carry the
                    # tenant's token-bucket refill estimate; the global
                    # bound falls back to a 1 s hint.
                    retry = float(getattr(exc, "retry_after_s", 1.0))
                    self._json(
                        429,
                        {"error": str(exc),
                         "retry_after_s": round(retry, 3),
                         "tenant": getattr(exc, "tenant", self._tenant)},
                        headers={"Retry-After":
                                 str(max(1, math.ceil(retry)))})
                except RuntimeError as exc:  # scheduler stopped/crashed
                    # retriable: true — nothing was delivered to this
                    # client (streaming failures surface in-stream with
                    # their own retriable flag), so resubmission is
                    # safe once a replica recovers
                    self._json(503, {"error": str(exc),
                                     "retriable": True})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    # -- shared plumbing ----------------------------------------------------

    def _snapshot(self) -> dict:
        """The backend's registry snapshot ({} for a backend without
        one). The names are the reference's `cloud_server_` families."""
        fn = getattr(self.srv, "metrics_snapshot", None)
        return fn() if fn is not None else {}

    def _metrics_text(self) -> str:
        """Full Prometheus text exposition (HELP/TYPE per series,
        histogram buckets with `le` labels plus _sum/_count)."""
        return render_prometheus(self._snapshot())

    def _stats_json(self, n: int) -> dict:
        """The /stats payload: histogram summaries (count / mean /
        interpolated p50/p95/p99), raw counters and gauges, and — when
        the backend has a flight recorder — its last `n` per-iteration
        records (token-budget utilization, prefill/decode split,
        occupancy, compaction, preemptions)."""
        snap = self._snapshot()
        payload = {
            "active": self.srv.num_active,
            "pending": self.srv.num_pending,
            "latency": {name: histogram_summary(entry)
                        for name, entry in snap.items()
                        if entry["type"] == "histogram"},
            "counters": {name: entry["value"]
                         for name, entry in snap.items()
                         if entry["type"] == "counter"},
            "gauges": {name: entry["value"]
                       for name, entry in snap.items()
                       if entry["type"] == "gauge"},
        }
        fn = getattr(self.srv, "flight_window", None)
        if fn is not None:
            # n bounds the window; n <= 0 means "no records", never
            # "everything" (256+ per-iteration dicts)
            payload["flight_recorder"] = fn(n) if n > 0 else []
        # iteration-phase profile: per-phase p50/p99 + host_gap_frac,
        # computed from the snapshot already in hand — behind the
        # router that snapshot is the fleet merge, so the percentiles
        # are fleet-wide for free. Absent when profiling is disabled.
        profile = profile_summary(snap)
        if profile is not None:
            payload["iteration_profile"] = profile
        # KV-cache & memory: pool occupancy, prefix hit rate,
        # per-tenant attribution, the hot-prefix sketch, and eviction
        # forensics (cache_telemetry.py). Behind the router the counts
        # are fleet-merged with ratios recomputed post-merge.
        cfn = getattr(self.srv, "cache_stats", None)
        if cfn is not None:
            payload["cache"] = cfn()
        # async double-buffered scheduler: the knob's resolved state
        # and the live pipeline depth (single-server debug view; the
        # per-iteration overlap fields ride in flight_recorder records
        # and the folded `overlap` phase in iteration_profile)
        ofn = getattr(self.srv, "overlap_stats", None)
        if ofn is not None:
            payload["overlap"] = ofn()
        # speculative decoding: drafted/accepted totals, the accept
        # rate, and (adaptive) the live per-slot draft lengths.
        # ReplicatedRouter's speculation_stats() merges counts across
        # replicas and recomputes the rate from the merged totals.
        sfn = getattr(self.srv, "speculation_stats", None)
        if sfn is not None:
            payload["speculation"] = sfn()
        # failure-domain blocks: brownout level/signals and injected-
        # fault counts, present only when configured (single-server
        # debug views; the COUNTERS merge fleet-wide via /metrics)
        bofn = getattr(self.srv, "brownout_stats", None)
        if bofn is not None:
            bstats = bofn()
            if bstats is not None:
                payload["brownout"] = bstats
        ffn = getattr(self.srv, "fault_stats", None)
        if ffn is not None:
            fstats = ffn()
            if fstats is not None:
                payload["faults"] = fstats
        # anomaly watchdog (active windows, per-rule fire counts, the
        # bounded event ring) + tail-retention accounting, present
        # only when configured. Behind the router the anomaly block
        # is the fleet merge (merge_anomaly_stats).
        afn = getattr(self.srv, "anomaly_stats", None)
        if afn is not None:
            astats = afn()
            if astats is not None:
                payload["anomaly"] = astats
        ttfn = getattr(self.srv, "tail_trace_stats", None)
        if ttfn is not None:
            ttstats = ttfn()
            if ttstats is not None:
                payload["tail_retention"] = ttstats
        # live-migration counters (inference/migration.py): behind the
        # router this is the fleet merge with success_rate recomputed
        # from the merged totals; a single server reports its ledger
        mfn = getattr(self.srv, "migration_stats", None)
        if mfn is not None:
            mstats = mfn()
            if mstats is not None:
                payload["migration"] = mstats
        # router breaker view (behind a ReplicatedRouter)
        brfn = getattr(self.srv, "breaker_states", None)
        if brfn is not None:
            payload["breakers"] = brfn()
        # SLO-burn autoscaler (scenarios/autoscaler.py attaches itself
        # to the router): fleet size, burn signal, scale-event tail
        asc = getattr(self.srv, "autoscaler", None)
        if asc is not None:
            payload["autoscaler"] = asc.stats()
        # replica role map (disaggregated prefill/decode fleets; all
        # "colocated" when no roles are configured)
        rfn = getattr(self.srv, "replica_roles", None)
        if rfn is not None:
            payload["roles"] = rfn()
        # multi-tenant QoS: per-tenant counters + fair-share view.
        # ReplicatedRouter merges these across replicas
        # (tenant_stats()); a single server reports its registry's.
        tfn = getattr(self.srv, "tenant_stats", None)
        if tfn is not None:
            tstats = tfn()
            if tstats:
                payload["tenants"] = tstats
        else:
            reg = getattr(self.srv, "qos", None)
            if reg is not None:
                payload["tenants"] = reg.stats()
        return payload

    def _handle_debug_trace(self, handler, body: dict) -> None:
        """POST /debug/trace: wrap the next N scheduler iterations in a
        torch.profiler trace. Body: {"steps": N (default 1), "logdir":
        path (default a fresh tempdir)}; the response echoes the logdir
        to open in TensorBoard or Perfetto."""
        fn = getattr(self.srv, "request_trace", None)
        if fn is None:
            raise ValueError(
                "this serving backend does not support trace capture")
        steps = body.get("steps", 1)
        if not isinstance(steps, int) or steps <= 0:
            raise ValueError('"steps" must be a positive int')
        logdir = body.get("logdir")
        if logdir is None:
            logdir = tempfile.mkdtemp(prefix="cloud-server-trace-")
        elif not isinstance(logdir, str):
            raise ValueError('"logdir" must be a string path')
        fn(steps, logdir)
        handler._json(200, {"ok": True, "steps": steps,
                            "logdir": logdir})

    def _encode(self, req: dict) -> list[int]:
        if "tokens" in req:
            tokens = req["tokens"]
            if (not isinstance(tokens, list)
                    or not all(isinstance(t, int) for t in tokens)):
                raise ValueError('"tokens" must be a list of ints')
            return tokens
        if "prompt" in req:
            if self.tokenizer is None:
                raise ValueError(
                    'no tokenizer attached; send {"tokens": [...]} instead')
            return self.tokenizer.encode(req["prompt"]) or [0]
        raise ValueError('body needs "prompt" or "tokens"')

    def _resolve_tenant(self, headers) -> str | None:
        """Tenant identity for one request. An API key
        (`Authorization: Bearer <key>` or `X-Api-Key`) the backend's
        TenantRegistry maps is AUTHORITATIVE; the spoofable `X-Tenant`
        header is honored only for tenants that configured no api_keys
        (`TenantRegistry.header_trusted`) — claiming a key-protected
        tenant without its key falls through to anonymous/default
        instead of riding the protected tenant's weight and budget.
        With QoS disabled (no registry) every request is anonymous:
        an attacker-chosen header value must never become a metric
        label (unbounded per-tenant histogram cardinality) — only a
        registry's frozen tenant set bounds that. None resolves to the
        implicit default tenant server-side."""
        reg = getattr(self.srv, "qos", None)
        if reg is None:
            return None
        auth = headers.get("Authorization", "")
        # RFC 7235: the auth scheme is case-insensitive
        key = (auth[7:].strip() if auth[:7].lower() == "bearer "
               else headers.get("X-Api-Key"))
        if key:
            mapped = reg.tenant_for_api_key(key)
            if mapped:
                return mapped
        t = (headers.get("X-Tenant") or "").strip()
        if t and reg.header_trusted(t):
            return t
        return None

    @staticmethod
    def _tenant_kw(handler) -> dict:
        """submit() kwargs carrying the handler's resolved tenant —
        empty when anonymous, so backends without a `tenant` parameter
        (third-party submit surfaces) keep working untouched."""
        t = getattr(handler, "_tenant", None)
        return {"tenant": t} if t else {}

    @staticmethod
    def _trace_kw(handler) -> dict:
        """submit() kwargs carrying the parsed incoming traceparent —
        empty when the client sent none (same third-party-backend rule
        as _tenant_kw; local head sampling still applies either way)."""
        ctx = getattr(handler, "_trace_ctx", None)
        return {"trace_ctx": ctx} if ctx is not None else {}

    @staticmethod
    def _deadline_kw(handler) -> dict:
        """submit() kwargs carrying the parsed X-Deadline-S header —
        empty when the client sent none (same third-party-backend
        rule as _tenant_kw)."""
        dl = getattr(handler, "_deadline_s", None)
        return {"deadline_s": dl} if dl is not None else {}

    @staticmethod
    def _error_line(request) -> dict | None:
        """Structured terminal error for a STREAMING response whose
        request failed: `{"error", "retriable"}`. retriable is False
        once any token was streamed — the client must not resubmit or
        it may receive duplicated output. Behind a ReplicatedRouter
        this surfaces only for NON-MIGRATABLE failures: the router
        first exhausts every zero-token retry AND every live-migration
        path (inference/migration.py — a migrated request continues on
        the same stream and never reaches here). None when the request
        did not fail."""
        reason = request.finish_reason or ""
        if not reason.startswith("error"):
            return None
        return {"error": reason, "retriable": not request.tokens}

    @staticmethod
    def _trace_headers(handler, request) -> dict:
        """Response headers for a submitted request: a W3C
        `traceparent` naming its trace (so the caller can stitch
        downstream spans or fetch /debug/requests/<id>), empty when
        the request was not sampled. Also notes the trace id for the
        access log."""
        tr = getattr(request, "trace", None)
        if tr is None:
            return {}
        handler._trace_id = tr.trace_id
        return {TRACEPARENT_HEADER: format_traceparent(
            tr.trace_id, tr.root_span_id)}

    def _adapter_kw(self, body: dict) -> dict:
        """OpenAI routing: a `model` naming a registered LoRA adapter
        selects it (vLLM convention); the base model id or an unknown
        name selects the base model."""
        name = body.get("model")
        adapters = getattr(self.srv, "adapters", None)
        if (isinstance(name, str) and adapters is not None
                and adapters.adapter_id(name) is not None):
            return {"adapter": name}
        return {}

    def _submit_streaming(self, tokens, max_new, sampling, **kw):
        """Submit with a queue-backed stream; returns (request, queue).
        The queue yields token ids then _STREAM_END."""
        q: queue.Queue = queue.Queue()
        request = self.srv.submit(tokens, max_new_tokens=max_new,
                                  stream=q.put, sampling=sampling, **kw)
        threading.Thread(  # unblock q.get when generation ends
            target=lambda: (request._done.wait(), q.put(_STREAM_END)),
            daemon=True).start()
        return request, q

    @staticmethod
    def _drain(q):
        while True:
            tok = q.get()
            if tok is _STREAM_END:
                return
            yield int(tok)

    # -- native endpoint ----------------------------------------------------

    def _handle_generate(self, handler, body: dict) -> None:
        max_new = body.get("max_new_tokens")
        if max_new is not None and not isinstance(max_new, int):
            raise ValueError('"max_new_tokens" must be an int')
        tokens = self._encode(body)
        sampling = _parse_sampling(body, self.tokenizer)
        kw = {}
        if body.get("adapter") is not None:
            if getattr(self.srv, "adapters", None) is None:
                raise ValueError(
                    "this serving backend does not support adapters")
            kw["adapter"] = body["adapter"]
        kw.update(self._tenant_kw(handler))
        kw.update(self._trace_kw(handler))
        kw.update(self._deadline_kw(handler))
        request, q = self._submit_streaming(tokens, max_new, sampling,
                                            **kw)

        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Connection", "close")
        for k, v in self._trace_headers(handler, request).items():
            handler.send_header(k, v)
        handler.end_headers()
        emitted = 0
        try:
            for tok in self._drain(q):
                line = {"token": tok}
                # _emit appends the logprob before invoking the stream
                # callback, so it is present by the time we get here
                if emitted < len(request.logprobs):
                    line["logprob"] = request.logprobs[emitted]
                emitted += 1
                if self.tokenizer is not None:
                    line["text"] = self.tokenizer.decode([tok])
                handler.wfile.write((json.dumps(line) + "\n").encode())
                handler.wfile.flush()
            err = self._error_line(request)
            if err is not None:
                # structured terminal error: a partially-streamed
                # request that could NOT be live-migrated ends with
                # retriable: false (resending would duplicate the
                # streamed tokens); zero-token failures are safe to
                # resubmit
                handler.wfile.write((json.dumps(err) + "\n").encode())
            else:
                handler.wfile.write((json.dumps(
                    {"done": True,
                     "finish_reason": request.finish_reason,
                     "tokens": request.tokens,
                     "logprobs": request.logprobs}) + "\n").encode())
        except (BrokenPipeError, ConnectionResetError):
            # the client went away: stop generating on its behalf — the
            # scheduler frees the slot and pages within one step
            request.cancel()

    # -- OpenAI-compatible endpoints ----------------------------------------

    def _openai_sampling(self, body: dict):
        """(max_tokens, SamplingParams) with OpenAI aliases folded in:
        max_tokens; response_format {"type": "json_object"} -> the
        bounded-depth JSON grammar; response_format {"type":
        "json_schema", "json_schema": {"schema": {...}}} -> the schema
        compiled through json_schema_regex (closed objects, declared key
        order). Other types change nothing, as in the reference."""
        max_new = body.get("max_tokens", body.get("max_new_tokens"))
        if max_new is not None and not isinstance(max_new, int):
            raise ValueError('"max_tokens" must be an int')
        rf = body.get("response_format")
        if isinstance(rf, dict) and rf.get("type") == "json_object":
            body = dict(body)
            body.setdefault("regex", json_object_regex())
        elif isinstance(rf, dict) and rf.get("type") == "json_schema":
            wrapper = rf.get("json_schema")
            if not isinstance(wrapper, dict):
                raise ValueError('response_format json_schema needs a '
                                 '"json_schema" object')
            schema = wrapper.get("schema")
            if schema is None:  # a bare schema in place of the wrapper
                looks = ("type", "properties", "enum", "const", "anyOf",
                         "oneOf")
                if not any(k in wrapper for k in looks):
                    raise ValueError(
                        'response_format json_schema needs a "schema"')
                schema = wrapper
            body = dict(body)
            body.setdefault("regex", json_schema_regex(schema))
        return max_new, _parse_sampling(body, self.tokenizer)

    def _prompt_variants(self, body: dict) -> list[list[int]]:
        """OpenAI `prompt`: string | token list | list of either."""
        prompt = body.get("prompt")
        if prompt is None:
            raise ValueError('body needs "prompt"')
        if isinstance(prompt, str):
            prompts = [prompt]
        elif isinstance(prompt, list) and prompt and all(
                isinstance(t, int) for t in prompt):
            prompts = [prompt]
        elif isinstance(prompt, list) and prompt:
            prompts = prompt
        else:
            raise ValueError('"prompt" must be a string, a token list, or '
                             "a non-empty list of those")
        out = []
        for p in prompts:
            if isinstance(p, str):
                if self.tokenizer is None:
                    raise ValueError("no tokenizer attached; send token "
                                     "lists instead")
                out.append(self.tokenizer.encode(p) or [0])
            elif isinstance(p, list) and all(
                    isinstance(t, int) for t in p):
                out.append(p)
            else:
                raise ValueError('"prompt" entries must be strings or '
                                 "token-id lists")
        return out

    def _sse_head(self, handler, headers: dict | None = None) -> None:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()

    @staticmethod
    def _sse(handler, payload) -> None:
        handler.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
        handler.wfile.flush()

    def _handle_completions(self, handler, body: dict) -> None:
        max_new, sampling = self._openai_sampling(body)
        prompts = self._prompt_variants(body)
        n = body.get("n", 1)
        if not isinstance(n, int) or n < 1:
            raise ValueError('"n" must be a positive int')
        best_of = body.get("best_of", n)
        if not isinstance(best_of, int) or best_of < n:
            raise ValueError('"best_of" must be an int >= n')
        if best_of > 20:  # OpenAI's own cap; bounds the fan-out
            raise ValueError('"best_of" must be <= 20')
        if best_of > n and body.get("stream"):
            raise ValueError('"best_of" cannot be used with streaming')
        want_logprobs = body.get("logprobs") is not None
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        base = {"id": rid, "object": "text_completion", "created": created,
                "model": body.get("model", self.model_id)}

        if body.get("stream"):
            if len(prompts) > 1 or n > 1:
                raise ValueError("streaming supports a single prompt with "
                                 "n=1")
            request, q = self._submit_streaming(
                prompts[0], max_new, sampling,
                **self._adapter_kw(body), **self._tenant_kw(handler),
                **self._trace_kw(handler), **self._deadline_kw(handler))
            self._sse_head(handler,
                           self._trace_headers(handler, request))
            stream = _TextStream(self.tokenizer)
            try:
                for tok in self._drain(q):
                    delta = stream.feed([tok])
                    if delta:
                        self._sse(handler, {
                            **base,
                            "choices": [{"text": delta, "index": 0,
                                         "logprobs": None,
                                         "finish_reason": None}]})
                err = self._error_line(request)
                if err is not None:
                    self._sse(handler, {**base, **err})
                else:
                    tail = stream.flush()
                    choice = {"text": tail, "index": 0,
                              "logprobs": None,
                              "finish_reason":
                                  _finish(request.finish_reason)}
                    self._sse(handler, {**base, "choices": [choice]})
                handler.wfile.write(b"data: [DONE]\n\n")
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                request.cancel()  # client disconnected mid-stream
            return

        def choice_sampling(k: int):
            # multiple candidates with an explicit seed must still be
            # DISTINCT samples: derive per-candidate seeds
            if (best_of > 1 and sampling is not None
                    and sampling.seed is not None):
                import dataclasses as _dc
                return _dc.replace(
                    sampling, seed=(sampling.seed + k) % (2 ** 32))
            return sampling

        akw = {**self._adapter_kw(body), **self._tenant_kw(handler),
               **self._trace_kw(handler), **self._deadline_kw(handler)}
        cands, submitted = [], []
        try:
            for p in prompts:
                cands.append([])
                for k in range(best_of):
                    r = self.srv.submit(p, max_new_tokens=max_new,
                                        sampling=choice_sampling(k),
                                        **akw)
                    cands[-1].append(r)
                    submitted.append(r)
        except Exception:
            # a mid-fan-out failure (e.g. QueueFullError) must not
            # leave the earlier candidates decoding for no one
            for r in submitted:
                r.cancel()
            raise
        try:
            for group in cands:
                for r in group:
                    r.result()
        except Exception:
            for r in submitted:  # same rule for mid-GENERATION failure
                r.cancel()
            raise
        if best_of > n:
            # OpenAI best_of: rank the candidates by mean token logprob
            # (the model's own raw distribution) and return the best n
            def mean_lp(r):
                return (sum(r.logprobs) / len(r.logprobs)
                        if r.logprobs else float("-inf"))

            cands = [sorted(group, key=mean_lp, reverse=True)[:n]
                     for group in cands]
        reqs = [r for group in cands for r in group]
        choices = []
        # OpenAI usage semantics: EVERY best_of candidate's completion
        # tokens count (they were all generated); the prompt counts
        # ONCE per prompt, not per candidate
        usage_p = sum(len(p) for p in prompts)
        usage_c = sum(len(r.tokens) for r in submitted)
        for i, r in enumerate(reqs):
            toks = r.result()
            choice = {
                "text": (self.tokenizer.decode(toks)
                         if self.tokenizer is not None else ""),
                "index": i, "logprobs": None,
                "finish_reason": _finish(r.finish_reason)}
            if want_logprobs:
                choice["logprobs"] = {
                    "tokens": [self.tokenizer.decode([t])
                               if self.tokenizer is not None else str(t)
                               for t in toks],
                    "token_logprobs": r.logprobs,
                    "top_logprobs": None, "text_offset": None}
            if self.tokenizer is None:
                choice["tokens"] = toks  # still useful without text
            choices.append(choice)
        handler._json(200, {
            **base, "choices": choices,
            "usage": {"prompt_tokens": usage_p,
                      "completion_tokens": usage_c,
                      "total_tokens": usage_p + usage_c}},
            headers=self._trace_headers(handler, submitted[0]))

    def _handle_embeddings(self, handler, body: dict) -> None:
        """OpenAI /v1/embeddings: input is a string, a token list, or a
        list of either; vectors are the backend's mean-pooled
        L2-normalised final hidden states."""
        embed_fn = getattr(self.srv, "embed", None)
        if embed_fn is None:
            raise ValueError(
                "this serving backend does not support embeddings")
        raw = body.get("input")
        if raw is None:
            raise ValueError('body needs "input"')
        if isinstance(raw, str) or (
                isinstance(raw, list) and raw
                and all(isinstance(t, int) for t in raw)):
            raw = [raw]
        if not isinstance(raw, list) or not raw:
            raise ValueError('"input" must be a string, a token list, '
                             "or a non-empty list of those")
        token_lists = []
        for item in raw:
            if isinstance(item, str):
                if self.tokenizer is None:
                    raise ValueError("no tokenizer attached; send token "
                                     "lists instead")
                token_lists.append(self.tokenizer.encode(item) or [0])
            elif (isinstance(item, list) and item
                  and all(isinstance(t, int) for t in item)):
                token_lists.append(item)
            else:
                raise ValueError('"input" entries must be non-empty '
                                 "strings or token-id lists")
        vecs = embed_fn(token_lists)
        handler._json(200, {
            "object": "list",
            "model": body.get("model", self.model_id),
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": sum(map(len, token_lists)),
                      "total_tokens": sum(map(len, token_lists))}})

    def _handle_chat(self, handler, body: dict) -> None:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError('"messages" must be a non-empty list')
        if self.tokenizer is None:
            raise ValueError("chat completions need a tokenizer")
        max_new, sampling = self._openai_sampling(body)
        prompt = self.tokenizer.encode(
            _render_chat(messages, self.tokenizer)) or [0]
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        base = {"id": rid, "created": created,
                "model": body.get("model", self.model_id)}

        if body.get("stream"):
            request, q = self._submit_streaming(
                prompt, max_new, sampling,
                **self._adapter_kw(body), **self._tenant_kw(handler),
                **self._trace_kw(handler), **self._deadline_kw(handler))
            self._sse_head(handler,
                           self._trace_headers(handler, request))
            stream = _TextStream(self.tokenizer)
            try:
                self._sse(handler, {
                    **base, "object": "chat.completion.chunk",
                    "choices": [{"index": 0,
                                 "delta": {"role": "assistant"},
                                 "finish_reason": None}]})
                for tok in self._drain(q):
                    delta = stream.feed([tok])
                    if delta:
                        self._sse(handler, {
                            **base, "object": "chat.completion.chunk",
                            "choices": [{"index": 0,
                                         "delta": {"content": delta},
                                         "finish_reason": None}]})
                err = self._error_line(request)
                if err is not None:
                    self._sse(handler, {**base, **err})
                else:
                    tail = stream.flush()
                    delta = {"content": tail} if tail else {}
                    self._sse(handler, {
                        **base, "object": "chat.completion.chunk",
                        "choices": [{
                            "index": 0, "delta": delta,
                            "finish_reason":
                                _finish(request.finish_reason)}]})
                handler.wfile.write(b"data: [DONE]\n\n")
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                request.cancel()  # client disconnected mid-stream
            return

        req = self.srv.submit(prompt, max_new_tokens=max_new,
                              sampling=sampling,
                              **self._adapter_kw(body),
                              **self._tenant_kw(handler),
                              **self._trace_kw(handler),
                              **self._deadline_kw(handler))
        toks = req.result()
        handler._json(200, {
            **base, "object": "chat.completion",
            "choices": [{
                "index": 0,
                "message": {"role": "assistant",
                            "content": self.tokenizer.decode(toks)},
                "finish_reason": _finish(req.finish_reason)}],
            "usage": {"prompt_tokens": len(prompt),
                      "completion_tokens": len(toks),
                      "total_tokens": len(prompt) + len(toks)}},
            headers=self._trace_headers(handler, req))

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="http-frontend")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._owns_log and self.access_log is not None:
            self.access_log.close()
            self.access_log = None
