"""Hot-path sync/allocation lint (checker id: ``hot-path``).

The port's copy of the reference's pass. The serving schedulers pay
ONE host<->device sync per iteration (the captured program's
``wait()``, which brings the sampled tokens home); everything else in
the iteration is plain host arithmetic on state the scheduler already
owns. The QoS layer (``inference/qos.py``) runs inside that iteration
— admission picks, deficit/virtual-time accounting, token-bucket
charges — so its hot functions must never reintroduce per-iteration
stalls.

``HOT_PATHS`` registers (file, qualname) pairs; inside each listed
function the lint flags:

  * any use of ``torch`` — device work (launches, allocations, or
    implicit transfers) has no business in host-side policy code;
  * any use of ``np`` / ``numpy`` — a numpy buffer materialized per
    call is the allocation class this lint means by "allocation-free"
    (Python's own objects — small dicts/lists — are unavoidable and
    cheap; array buffers are not);
  * blocking transfers and syncs: ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``.synchronize()``, a program's
    ``settle()`` or ``wait()``;
  * host I/O that stalls the scheduler thread: ``print``, ``open``,
    ``input``, ``logging`` calls, ``time.sleep``;
  * ``time.time()`` — the schedulers time with the monotonic clocks
    (``time.monotonic`` / ``time.perf_counter``), which are allowed;
    wall-clock reads are not (NTP steps would corrupt token-bucket
    refill math).

Registered functions are checked for EXISTENCE too: renaming a hot
function without updating the registry fails the gate, so the lint
cannot silently rot.
"""

from __future__ import annotations

import ast

from cloud_server_tpu_torch.analysis.framework import (
    DEVICE_ROOTS, Finding, Pass, collect_functions, default_root,
    dotted_name, enclosing_class_line, read_rostered, register_pass,
    sync_call_name)

CHECKER = "hot-path"

# (repo-relative file) -> qualnames whose bodies are per-iteration /
# per-submit hot path. Keep this in sync with the scheduler: anything
# called from step()/submit() on every request or iteration belongs
# here.
HOT_PATHS: dict[str, tuple[str, ...]] = {
    # per-request tracing: the span-RECORD path runs at submit, at
    # request completion, and once per traced iteration — tree
    # building and exports are read-path only and deliberately absent
    "cloud_server_tpu_torch/inference/request_trace.py": (
        "RequestTrace.add_span",
        "RequestTrace.annotate",
        "TraceRecorder.should_sample",
        "TraceRecorder.begin",
        "TraceRecorder.finish",
        # tail-retention verdict: runs inside finish() at every
        # completion that carries a (head or provisional) trace
        "TraceRecorder._tail_reason",
    ),
    # iteration-phase profiler: begin/mark run at every phase
    # boundary of every scheduler iteration (the tightest loop this
    # roster covers — a stray allocation or sync here would taint the
    # very attribution it produces); phases_ms feeds the per-busy-
    # iteration flight record. The summary/export functions
    # (profile_summary, scheduler_chrome_trace) are read-path only
    # and deliberately absent.
    "cloud_server_tpu_torch/inference/iteration_profile.py": (
        "IterationProfiler.begin",
        "IterationProfiler.mark",
        "IterationProfiler.phases_ms",
        "derive_gap_fields",
    ),
    # cache telemetry: the record hooks run inside the allocator's
    # lookup/alloc/release/evict — i.e. inside _start_admissions /
    # _extend_chains / _release_slot on every scheduler iteration that
    # moves pages. The read paths (tenant_stats / top_prefixes /
    # merge_*) are scrape-path only and deliberately absent; sketch
    # compaction (_compact) IS on the roster — it runs amortized
    # inside record_walk and must stay plain dict work.
    "cloud_server_tpu_torch/inference/cache_telemetry.py": (
        "CacheTelemetry.record_walk",
        "CacheTelemetry.record_alloc",
        "CacheTelemetry.record_release",
        "CacheTelemetry.record_saved",
        "CacheTelemetry.record_evict",
        "CacheTelemetry._compact",
        "CacheTelemetry._tenant",
    ),
    # failure-domain layer: FaultPlan.fire/check run per guarded site
    # hit on the scheduler iteration and submit paths (a plan that
    # stalls the scheduler by ACCIDENT would corrupt the very recovery
    # measurements it exists for — maybe_stall/maybe_wedge, whose JOB
    # is blocking, are deliberately absent); the OverloadDetector's
    # observe runs once per busy iteration and level/shed/retry_hint
    # gate every submit
    "cloud_server_tpu_torch/inference/faults.py": (
        "FaultPlan.fire",
        "FaultPlan.check",
        "OverloadDetector.observe",
        "OverloadDetector._effective_locked",
        "OverloadDetector.level",
        "OverloadDetector.shed",
        "OverloadDetector.retry_hint",
    ),
    # SLO tracking: observe() runs at admit / first-token / emit /
    # finish host moments; report/mirror are scrape-path only.
    # exceeds_target feeds the tail-retention verdict at every
    # completion.
    "cloud_server_tpu_torch/inference/slo.py": (
        "ClassSLO.target",
        "_RollingCounts.observe",
        "SLOTracker.resolve_class",
        "SLOTracker.observe",
        "SLOTracker.exceeds_target",
    ),
    # anomaly watchdog: observe_iteration runs once per busy
    # scheduler iteration and observe_request at every completion —
    # both on caller-passed clocks (zero clock reads of their own);
    # active_count gates the tail-retention verdict at completion.
    # The read paths (stats / events / merge_anomaly_stats) are
    # scrape-path only and deliberately absent.
    "cloud_server_tpu_torch/inference/anomaly.py": (
        "AnomalyWatchdog.observe_iteration",
        "AnomalyWatchdog.observe_request",
        "AnomalyWatchdog.active_count",
        "AnomalyWatchdog._update_rule",
        "AnomalyWatchdog._shift",
    ),
    # adaptive speculation control: planning (draft_len) and feedback
    # (observe / on_plain_dispatch) run once per dispatch / committed
    # round inside the scheduler iteration; draft_lengths feeds the
    # per-busy-iteration flight record. resolve_controller (construction,
    # may open a config file) is deliberately absent.
    "cloud_server_tpu_torch/inference/spec_control.py": (
        "SpecController.on_admit",
        "SpecController.on_release",
        "SpecController.draft_len",
        "SpecController.observe",
        "SpecController.on_plain_dispatch",
        "SpecController.accept_rate",
        "SpecController.draft_lengths",
    ),
    # replica router: _pick/submit run once per request on the client
    # thread while holding the router lock (a stall here blocks every
    # concurrent submitter), and the post-merge ratio recomputes
    # (fair-share / accept-rate / SLO gauges) run on the scrape path
    # but iterate the whole fleet per call
    "cloud_server_tpu_torch/inference/router.py": (
        "ReplicatedRouter._pick",
        "ReplicatedRouter.submit",
        "ReplicatedRouter.num_active",
        "ReplicatedRouter.num_pending",
        "ReplicatedRouter.metrics_snapshot",
        "ReplicatedRouter.tenant_stats",
        "ReplicatedRouter.speculation_stats",
        "ReplicatedRouter.cache_stats",
        # disaggregation role planner: runs inside every _pick/submit
        # under the router lock, same stall blast radius
        "ReplicatedRouter._role_candidates",
        "ReplicatedRouter._prefill_load",
        "ReplicatedRouter._plan_roles",
    ),
    # live migration: the ledger's record hooks run on the export /
    # import paths while the SOURCE or DESTINATION server's step lock
    # is held (a stall there freezes that replica's scheduler), and
    # drain_flight_deltas runs once per busy iteration inside
    # _record_iteration to feed the flight recorder's migrated_in/out
    # counts. The snapshot helpers run under the same locks. The
    # device-touching export/import bodies live in paged_server (and
    # are covered by the dispatch-discipline pass), NOT here — this
    # module must stay pure host bookkeeping.
    "cloud_server_tpu_torch/inference/migration.py": (
        "MigrationLedger.record_export_start",
        "MigrationLedger.record_export_done",
        "MigrationLedger.record_export_failed",
        "MigrationLedger.record_import_start",
        "MigrationLedger.record_import_done",
        "MigrationLedger.record_import_failed",
        "MigrationLedger.drain_flight_deltas",
        "MigrationSnapshot.remaining_new_tokens",
        "MigrationSnapshot.n_kv_pages",
    ),
    "cloud_server_tpu_torch/inference/qos.py": (
        "TokenBucket._refill",
        "TokenBucket.level",
        "TokenBucket.try_consume",
        "TokenBucket.charge",
        "TokenBucket.retry_after",
        "TenantRegistry.resolve",
        "TenantRegistry.priority_rank",
        "TenantRegistry.priority_class",
        "TenantRegistry.weight",
        "TenantRegistry.default_deadline",
        "TenantRegistry.victim_rank",
        "TenantRegistry._decay_recent",
        "TenantRegistry.gate_submit",
        "TenantRegistry.on_pending_removed",
        "TenantRegistry.on_requeue",
        "TenantRegistry.next_admission_index",
        "TenantRegistry._in_budget",
        "TenantRegistry.charge_admission",
        "TenantRegistry.order_jobs",
        "TenantRegistry.charge_prefill",
        "TenantRegistry.charge_generated",
        "TenantRegistry.charge_speculation",
        # per-busy-iteration flight-recorder gauge
        "TenantRegistry.fair_shares",
        "TenantRegistry._fair_shares_locked",
    ),
    # scenario replay: tick()/_fire() interleave with scheduler step()
    # pumping on the serving thread — the caller owns time (tick takes
    # `now`), so a clock read, sleep, or log line here would skew the
    # very replay timings the harness measures. run()/result() are the
    # wall-clock convenience/read paths and deliberately absent.
    "cloud_server_tpu_torch/scenarios/replay.py": (
        "ReplayDriver.tick",
        "ReplayDriver._fire",
    ),
    # autoscaler decision path: evaluate()/_burn_signal() run per poll
    # under the autoscaler lock while submit threads contend for the
    # router — pure decision on a caller-passed clock. The actuation
    # paths (_scale_up/_scale_down, which legitimately log and drain)
    # are deliberately absent.
    "cloud_server_tpu_torch/scenarios/autoscaler.py": (
        "SLOBurnAutoscaler.evaluate",
        "SLOBurnAutoscaler._burn_signal",
    ),
    "cloud_server_tpu_torch/utils/serving_metrics.py": (
        "Counter.inc",
        "Gauge.set",
        "Histogram.observe",
        "FlightRecorder.record",
        "ServingMetrics.observe_submit",
        "ServingMetrics.observe_admit",
        "ServingMetrics.observe_emit",
        "ServingMetrics.observe_requeue",
        "ServingMetrics.observe_finish",
    ),
}

_DEVICE_ROOTS = DEVICE_ROOTS
_NUMPY_ROOTS = {"np", "numpy"}
_IO_CALLS = {"print", "open", "input"}
_LOG_ROOTS = {"logging", "logger", "log"}


_dotted = dotted_name


def _check_function(path: str, qual: str,
                    fn: ast.FunctionDef) -> list[Finding]:
    out: list[Finding] = []

    def flag(node: ast.AST, msg: str) -> None:
        out.append(Finding(path, getattr(node, "lineno", fn.lineno),
                           CHECKER, qual, msg))

    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if node.id in _DEVICE_ROOTS:
                flag(node, f"device-framework use ({node.id}.*) on the "
                           "host hot path")
            elif node.id in _NUMPY_ROOTS:
                flag(node, f"numpy buffer work ({node.id}.*) on the "
                           "host hot path (allocation per call)")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = getattr(node, "module", None) or ""
            names = {a.name.split(".")[0] for a in node.names}
            roots = _DEVICE_ROOTS | _NUMPY_ROOTS
            if mod.split(".")[0] in roots or names & roots:
                flag(node, "device/numpy import inside a hot-path "
                           "function")
        elif isinstance(node, ast.Call):
            sync = sync_call_name(node)
            if sync is not None:
                flag(node, f"blocking sync/transfer call {sync}()")
                continue
            name = _dotted(node.func)
            if name is None:
                continue
            leaf = name.rsplit(".", 1)[-1]
            root = name.split(".", 1)[0]
            if name in _IO_CALLS:
                flag(node, f"host I/O call {name}() stalls the "
                           "scheduler thread")
            elif name == "time.time":
                flag(node, "wall-clock time.time() — use the monotonic "
                           "clocks (time.monotonic / perf_counter)")
            elif name == "time.sleep" or leaf == "sleep":
                flag(node, f"sleep call {name}() on the hot path")
            elif root in _LOG_ROOTS or (
                    "." in name and name.rsplit(".", 2)[-2] in _LOG_ROOTS):
                flag(node, f"logging call {name}() on the hot path")
    return out


def check_source(path: str, source: str,
                 qualnames: tuple[str, ...]) -> list[Finding]:
    """Lint `qualnames` inside `source`; missing qualnames are findings
    too (the registry must not rot when functions are renamed)."""
    tree = ast.parse(source, filename=path)
    found, classes = collect_functions(tree)
    out: list[Finding] = []
    for qual in qualnames:
        fn = found.get(qual)
        if fn is None:
            # anchored at the enclosing class when it exists, so the
            # finding lands where the rename happened — not at line 1
            line = enclosing_class_line(classes, qual)
            out.append(Finding(path, line, CHECKER, qual,
                               "registered hot-path function not found "
                               "(renamed? update HOT_PATHS)"))
            continue
        out.extend(_check_function(path, qual, fn))
    return out


def check_hot_paths(root: str | None = None) -> list[Finding]:
    """Run the lint over every registered file. `root` defaults to
    the repository root."""
    if root is None:
        root = default_root()
    out: list[Finding] = []
    for rel, quals in HOT_PATHS.items():
        source, missing = read_rostered(root, rel, CHECKER)
        if missing is not None:
            out.append(missing)
            continue
        out.extend(check_source(rel, source, quals))
    return out


register_pass(Pass(
    id=CHECKER,
    title="per-iteration scheduler code must stay free of device work, "
          "blocking syncs, numpy allocation, wall-clock reads, and "
          "host I/O",
    run=check_hot_paths,
    roster=lambda root: tuple(HOT_PATHS),
))
