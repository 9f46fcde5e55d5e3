"""The port's static-analysis gate (`cloud_server_tpu_torch/analysis/`):
the multi-pass framework (registry, suppression pragmas, reporters)
plus every checker's fixture round-trip in the port's idiom — hot-path
sync/allocation rules, lock discipline (LD1..LD4), dispatch discipline
(DD1..DD5), and lifecycle discipline (LC1..LC4). The whole suite must
run clean over the port's serving stack (suppressions honored), every
roster must name port files only, and each checker must catch each
violation class. Stdlib-only: this file imports neither torch nor jax
(the fixtures under torch_analysis_fixtures/ are PARSED, never
imported)."""

import ast
import json
import pathlib
import re
import subprocess
import sys
import time

import pytest

from cloud_server_tpu_torch.analysis import (HOT_PATHS, Finding,
                                             apply_pragmas, check_hot_paths,
                                             check_source, collect_pragmas,
                                             dispatch, lifecycle, locks,
                                             registered_passes, report_json,
                                             run_analysis)
from cloud_server_tpu_torch.analysis.framework import (
    collect_functions, pragma_lines, report_sarif)

_HERE = pathlib.Path(__file__).resolve().parent
_ROOT = _HERE.parent
_FIXTURES = _HERE / "torch_analysis_fixtures"
_PKG = "cloud_server_tpu_torch/"
_INF = _PKG + "inference/"


@pytest.fixture(scope="module")
def report():
    """One run of every pass over the repository, shared by the tests
    that only read it."""
    return run_analysis(str(_ROOT))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cloud_server_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=str(_ROOT))


# -- hot-path ---------------------------------------------------------------

def test_registered_hot_paths_are_clean():
    findings = check_hot_paths(str(_ROOT))
    assert not findings, "\n".join(str(f) for f in findings)


@pytest.mark.parametrize("rel,needed", [
    ("qos.py", ("TenantRegistry.next_admission_index",
                "TenantRegistry.order_jobs", "TenantRegistry.charge_prefill",
                "TenantRegistry.charge_generated",
                "TenantRegistry.victim_rank", "TokenBucket.try_consume",
                "TenantRegistry.charge_speculation",
                "TenantRegistry.default_deadline")),
    ("request_trace.py", ("RequestTrace.add_span", "TraceRecorder.begin",
                          "TraceRecorder.finish",
                          "TraceRecorder._tail_reason")),
    ("slo.py", ("SLOTracker.observe", "_RollingCounts.observe",
                "SLOTracker.exceeds_target")),
    ("spec_control.py", ("SpecController.draft_len",
                         "SpecController.observe",
                         "SpecController.on_plain_dispatch",
                         "SpecController.draft_lengths")),
    ("iteration_profile.py", ("IterationProfiler.begin",
                              "IterationProfiler.mark",
                              "IterationProfiler.phases_ms",
                              "derive_gap_fields")),
    ("cache_telemetry.py", ("CacheTelemetry.record_walk",
                            "CacheTelemetry.record_evict",
                            "CacheTelemetry.record_saved",
                            "CacheTelemetry._compact")),
    ("faults.py", ("FaultPlan.fire", "FaultPlan.check",
                   "OverloadDetector.observe", "OverloadDetector.shed",
                   "OverloadDetector.retry_hint")),
    ("anomaly.py", ("AnomalyWatchdog.observe_iteration",
                    "AnomalyWatchdog.observe_request",
                    "AnomalyWatchdog.active_count",
                    "AnomalyWatchdog._update_rule",
                    "AnomalyWatchdog._shift")),
    ("migration.py", ("MigrationLedger.record_export_done",
                      "MigrationLedger.record_import_done",
                      "MigrationLedger.drain_flight_deltas",
                      "MigrationSnapshot.remaining_new_tokens")),
    ("router.py", ("ReplicatedRouter.cache_stats",
                   "ReplicatedRouter._role_candidates",
                   "ReplicatedRouter._prefill_load",
                   "ReplicatedRouter._plan_roles")),
])
def test_registry_covers_the_hot_modules(rel, needed):
    """Each per-iteration policy/telemetry module's hot surface stays on
    the scan roster (the reference's registry-coverage tests, one case
    a module)."""
    quals = set(HOT_PATHS[_INF + rel])
    for q in needed:
        assert q in quals, f"{q} dropped from HOT_PATHS"


@pytest.mark.parametrize("rel", [
    "inference/iteration_profile.py", "inference/cache_telemetry.py",
    "inference/faults.py", "inference/anomaly.py",
    "inference/migration.py", "inference/qos.py", "inference/slo.py",
    "inference/request_trace.py", "inference/spec_control.py",
    "utils/serving_metrics.py", "scenarios/workload.py",
    "scenarios/replay.py", "scenarios/simulator.py",
    "scenarios/autoscaler.py"])
def test_host_policy_roster_covers(rel):
    assert _PKG + rel in dispatch.HOST_POLICY_MODULES, \
        f"{rel} dropped from the DD3 host-policy roster"


@pytest.mark.parametrize("rel", ["faults.py", "anomaly.py", "migration.py",
                                 "paged_server.py", "router.py", "qos.py"])
def test_lock_roster_covers(rel):
    assert _INF + rel in locks.LOCK_ROSTER, \
        f"{rel} dropped from the lock-discipline roster"


def test_registry_covers_migration_sync_and_loop():
    paged = _INF + "paged_server.py"
    assert ("PagedInferenceServer._export_request_locked"
            in dispatch.SANCTIONED_SYNCS[paged]), \
        "the migration export's sync lost its DD2 sanction"
    loop = set(dispatch.SCHEDULER_LOOPS[paged])
    for needed in ("PagedInferenceServer.migrate_export",
                   "PagedInferenceServer.migrate_import",
                   "PagedInferenceServer._import_pages",
                   "PagedInferenceServer._evacuate"):
        assert needed in loop, f"{needed} dropped from the DD2 roster"


def test_registry_covers_scenarios():
    replay = _PKG + "scenarios/replay.py"
    asc = _PKG + "scenarios/autoscaler.py"
    for needed in ("ReplayDriver.tick", "ReplayDriver._fire"):
        assert needed in HOT_PATHS[replay]
    for needed in ("SLOBurnAutoscaler.evaluate",
                   "SLOBurnAutoscaler._burn_signal"):
        assert needed in HOT_PATHS[asc]


_HOT_CASES = [
    ("hot_path_bad.py", "BadPolicy.device_work", "device"),
    ("hot_path_bad.py", "BadPolicy.numpy_alloc", "numpy"),
    ("hot_path_bad.py", "BadPolicy.blocking_sync", "sync"),
    ("hot_path_bad.py", "BadPolicy.blocking_cpu", "cpu()"),
    ("hot_path_bad.py", "BadPolicy.blocking_tolist", "tolist()"),
    ("hot_path_bad.py", "BadPolicy.blocking_numpy", "numpy()"),
    ("hot_path_bad.py", "BadPolicy.blocking_event", "synchronize()"),
    ("hot_path_bad.py", "BadPolicy.blocking_program", "prog.wait()"),
    ("hot_path_bad.py", "BadPolicy.blocking_settle", "settle()"),
    ("hot_path_bad.py", "BadPolicy.host_io", "I/O"),
    ("hot_path_bad.py", "BadPolicy.wall_clock", "time.time"),
    ("hot_path_bad.py", "BadPolicy.sleeper", "sleep"),
    ("hot_path_trace_bad.py", "BadRecorder.add_span_wall_clock",
     "time.time"),
    ("hot_path_trace_bad.py", "BadRecorder.add_span_numpy", "numpy"),
    ("hot_path_trace_bad.py", "BadRecorder.add_span_logged", "logging"),
    ("hot_path_trace_bad.py", "BadSLO.observe_io", "I/O"),
    ("hot_path_trace_bad.py", "BadSLO.observe_sleepy", "sleep"),
    ("hot_path_spec_bad.py", "BadSpecController.draft_len_device",
     "device"),
    ("hot_path_spec_bad.py", "BadSpecController.observe_numpy", "numpy"),
    ("hot_path_spec_bad.py", "BadSpecController.accept_rate_wall_clock",
     "time.time"),
    ("hot_path_spec_bad.py", "BadSpecController.observe_logged",
     "logging"),
    ("hot_path_spec_bad.py", "BadSpecController.on_plain_dispatch_io",
     "I/O"),
    ("hot_path_profile_bad.py", "BadProfiler.mark_wall_clock", "time.time"),
    ("hot_path_profile_bad.py", "BadProfiler.mark_numpy", "numpy"),
    ("hot_path_profile_bad.py", "BadProfiler.mark_synced", "sync"),
    ("hot_path_profile_bad.py", "BadProfiler.finish_logged", "logging"),
    ("hot_path_profile_bad.py", "BadProfiler.finish_io", "I/O"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_evict_wall_clock",
     "time.time"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_walk_numpy",
     "numpy"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_walk_synced",
     "sync"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_evict_logged",
     "logging"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_evict_io", "I/O"),
    ("hot_path_faults_bad.py", "BadFaultPlan.fire_sleeps", "sleep"),
    ("hot_path_faults_bad.py", "BadFaultPlan.fire_logged", "logging"),
    ("hot_path_faults_bad.py", "BadFaultPlan.check_io", "I/O"),
    ("hot_path_faults_bad.py", "BadOverloadDetector.observe_wall_clock",
     "time.time"),
    ("hot_path_faults_bad.py", "BadOverloadDetector.observe_numpy",
     "numpy"),
    ("hot_path_faults_bad.py", "BadOverloadDetector.level_synced", "sync"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.observe_wall_clock",
     "time.time"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.observe_numpy", "numpy"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.fire_logged", "logging"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.bundle_io", "I/O"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.shift_synced", "sync"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.hold_sleeps", "sleep"),
    ("hot_path_migration_bad.py",
     "BadMigrationLedger.record_export_done_logged", "logging"),
    ("hot_path_migration_bad.py",
     "BadMigrationLedger.record_import_done_io", "I/O"),
    ("hot_path_migration_bad.py",
     "BadMigrationLedger.drain_flight_wall_clock", "time.time"),
    ("hot_path_migration_bad.py", "BadMigrationLedger.stats_numpy",
     "numpy"),
    ("hot_path_migration_bad.py", "BadMigrationLedger.record_export_synced",
     "sync"),
    ("hot_path_migration_bad.py", "BadMigrationLedger.record_import_sleepy",
     "sleep"),
    ("hot_path_scenarios_bad.py", "BadDriver.tick_reads_clock",
     "time.time"),
    ("hot_path_scenarios_bad.py", "BadDriver.tick_sleeps", "sleep"),
    ("hot_path_scenarios_bad.py", "BadDriver.fire_numpy_lag", "numpy"),
    ("hot_path_scenarios_bad.py", "BadDriver.fire_logged", "logging"),
    ("hot_path_scenarios_bad.py", "BadDriver.evaluate_prints", "I/O"),
]


@pytest.mark.parametrize("fixture,qual,needle", _HOT_CASES,
                         ids=[q for _, q, _ in _HOT_CASES])
def test_checker_flags_each_violation_class(fixture, qual, needle):
    """Every violation class of every hot module's fixture fires, in
    the port's vocabulary (torch, a tensor's .item()/.cpu()/.tolist()/
    .numpy(), .synchronize(), a program's wait()/settle())."""
    src = (_FIXTURES / fixture).read_text()
    findings = check_source(fixture, src, (qual,))
    assert findings, f"{qual}: expected a finding"
    assert any(needle in f.message for f in findings), \
        f"{qual}: {[str(f) for f in findings]}"


@pytest.mark.parametrize("fixture,qual", [
    ("hot_path_bad.py", "BadPolicy.fine_actually"),
    ("hot_path_trace_bad.py", "BadSLO.observe_fine"),
    ("hot_path_profile_bad.py", "BadProfiler.mark_fine"),
    ("hot_path_cache_bad.py", "BadCacheTelemetry.record_walk_fine"),
    ("hot_path_faults_bad.py", "BadOverloadDetector.shed_fine"),
    ("hot_path_anomaly_bad.py", "BadWatchdog.update_fine"),
    ("hot_path_migration_bad.py",
     "BadMigrationLedger.record_export_done_fine"),
    ("hot_path_scenarios_bad.py", "BadDriver.tick_fine"),
    ("hot_path_good.py", "GoodBucket.refill"),
    ("hot_path_good.py", "GoodBucket.pick"),
])
def test_checker_accepts_clean_shapes(fixture, qual):
    """The pure passed-timestamp / dict-arithmetic shapes the real
    modules use (and a Condition's host-only wait) must not fire."""
    src = (_FIXTURES / fixture).read_text()
    findings = check_source(fixture, src, (qual,))
    assert not findings, "\n".join(str(f) for f in findings)


def test_checker_flags_missing_registration():
    findings = check_source("x.py", "def f():\n    pass\n",
                            ("DoesNotExist.method",))
    assert findings and "not found" in findings[0].message


def test_missing_registration_anchors_at_enclosing_class():
    src = ("import os\n\n\n"
           "class Keeper:\n"
           "    def other(self):\n"
           "        pass\n")
    findings = check_source("x.py", src, ("Keeper.gone",))
    assert len(findings) == 1 and findings[0].line == 4
    findings = check_source("x.py", src, ("Vanished.gone",))
    assert len(findings) == 1 and findings[0].line == 1


# -- framework --------------------------------------------------------------

def test_pass_registry_has_all_four_checkers():
    assert set(registered_passes()) == {
        "hot-path", "lock-discipline", "dispatch-discipline",
        "lifecycle-discipline"}


def test_finding_renders_path_line_checker_symbol():
    f = Finding("a/b.py", 7, "lock-discipline", "C.m", "boom")
    assert str(f) == "a/b.py:7: [lock-discipline] [C.m] boom"


def test_run_analysis_over_repo_is_clean(report):
    """THE gate: every checker over the port's serving stack, zero
    unsuppressed findings — and the deliberate exceptions really are
    carried as reasoned pragmas."""
    assert report.ok, "\n".join(str(f) for f in report.findings)
    assert set(report.checkers) == set(registered_passes())
    assert report.suppressed
    for f, reason in report.suppressed:
        assert reason.strip()
        assert f.path.startswith(_PKG), f


def test_run_analysis_checker_filter():
    rep = run_analysis(str(_ROOT), checkers=["hot-path"])
    assert rep.checkers == ("hot-path",)
    assert rep.ok
    with pytest.raises(KeyError, match="nope"):
        run_analysis(str(_ROOT), checkers=["nope"])


def _all_roster_files():
    files = set(HOT_PATHS) | set(locks.LOCK_ROSTER) | set(
        lifecycle.LIFECYCLE_ROSTER) | set(dispatch.SCHEDULER_LOOPS) | set(
        dispatch.HOST_POLICY_MODULES) | set(dispatch.SANCTIONED_SYNCS) | set(
        dispatch.OVERLAP_PLAN_FUNCS)
    for roster in (lifecycle.COMPLETION_OWNER_FUNCS,
                   lifecycle.TERMINAL_MARKER_FUNCS,
                   lifecycle.COMPLETE_FUNCS,
                   lifecycle.OWNERSHIP_TRANSFER_FUNCS):
        files |= set(roster)
    return sorted(files)


def test_rosters_name_port_files_only():
    """Every roster of the port's gate names `cloud_server_tpu_torch/`
    files, each of which exists; none names the reference."""
    for rel in _all_roster_files():
        assert rel.startswith(_PKG), rel
        assert (_ROOT / rel).is_file(), rel


def test_analysis_imports_no_torch():
    """The gate is stdlib-only: importing it (and its parent package)
    loads neither torch nor numpy nor the serving stack."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, cloud_server_tpu_torch.analysis as a; "
         "a.run_analysis(); "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'numpy', 'jax') or m.startswith("
         "'cloud_server_tpu_torch.inference')))"],
        capture_output=True, text=True, cwd=str(_ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# -- suppression pragmas ----------------------------------------------------

def test_pragma_silences_exactly_one_finding():
    src = (_FIXTURES / "suppression.py").read_text()
    raw = locks.check_source("suppression.py", src)
    sleeps = [f for f in raw if "sleep" in f.message]
    assert len(sleeps) == 4, [str(f) for f in raw]
    pragmas, bad = collect_pragmas("suppression.py", src)
    kept, suppressed = apply_pragmas(pragma_lines(pragmas), raw)
    assert len(suppressed) == 3
    assert all("sleep" in f.message for f, _ in suppressed)
    assert any("test fixture" in reason for _, reason in suppressed)
    assert sum("sleep" in f.message for f in kept) == 1
    assert len(bad) == 1 and bad[0].checker == "pragma"
    assert any(f.checker == "lock-discipline" and "_state" in f.message
               for f in kept)


def test_pragma_covers_multiline_statement_extent():
    src = (_FIXTURES / "suppression.py").read_text()
    raw = locks.check_source("suppression.py", src)
    multiline = [f for f in raw
                 if f.symbol == "Suppressed.allowed_multiline"]
    assert len(multiline) == 2, [str(f) for f in raw]
    pragmas, _bad = collect_pragmas("suppression.py", src)
    by_line = pragma_lines(pragmas)
    pragma_of = [p for p in pragmas
                 if "statement-extent" in p.reason][0]
    for f in multiline:
        assert f.line > pragma_of.line, (f.line, pragma_of.line)
        assert f.line in by_line and f.checker in by_line[f.line]
    kept, suppressed = apply_pragmas(by_line, multiline)
    assert not kept and len(suppressed) == 2


def test_pragma_inside_multiline_call_covers_the_call_line():
    src = ("def f(self):\n"
           "    self.launch(\n"
           "        self.a,\n"
           "        # analysis: allow[hot-path] staged under _lock\n"
           "        self.b,\n"
           "    )\n")
    pragmas, bad = collect_pragmas("x.py", src)
    assert not bad
    by_line = pragma_lines(pragmas)
    for line in (2, 3, 4, 5, 6):
        assert "hot-path" in by_line.get(line, {}), (line, by_line)


def test_pragma_extent_survives_unparsable_source():
    src = ("def broken(:\n"
           "    x = 1  # analysis: allow[hot-path] still collected\n")
    pragmas, bad = collect_pragmas("x.py", src)
    assert not bad
    assert len(pragmas) == 1 and pragmas[0].covers == (2,)


def test_pragma_on_comment_line_covers_next_statement():
    pragmas, bad = collect_pragmas("x.py", (
        "# analysis: allow[hot-path] spans a\n"
        "# second comment line\n"
        "do_thing()\n"))
    assert not bad
    by_line = pragma_lines(pragmas)
    assert "hot-path" in by_line.get(1, {})
    assert "hot-path" in by_line.get(3, {})


def _lock_tree(tmp_path, special: str, body: str):
    for rel in locks.LOCK_ROSTER:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body if rel.endswith(special) else "X = 1\n",
                     encoding="utf-8")


@pytest.mark.parametrize("special,body,needle", [
    ("qos.py",
     "import threading\n"
     "class C:\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "    def fine(self):\n"
     "        # analysis: allow[lock-discipline] nothing here\n"
     "        return 1\n", "stale"),
    ("slo.py", "# analysis: allow[lockdiscipline] typo'd id\nX = 1\n",
     "unknown checker"),
])
def test_rotten_pragma_is_a_finding(tmp_path, special, body, needle):
    """A suppression that matched nothing (stale) or names no
    registered checker (typo) is itself a `pragma` finding."""
    _lock_tree(tmp_path, special, body)
    rep = run_analysis(str(tmp_path), checkers=["lock-discipline"])
    assert any(f.checker == "pragma" and needle in f.message
               for f in rep.findings), [str(f) for f in rep.findings]


def test_port_pragmas_all_carry_reasons():
    """Every pragma in the port names a registered checker and carries a
    reason (the inventory CHANGES.md lists)."""
    n = 0
    for path in sorted((_ROOT / "cloud_server_tpu_torch").rglob("*.py")):
        if "analysis" in path.parts:
            continue
        pragmas, bad = collect_pragmas(str(path), path.read_text())
        assert not bad, bad
        for p in pragmas:
            assert p.checker in registered_passes(), p
            assert p.reason.strip(), p
        n += len(pragmas)
    assert n > 0


# -- lock-discipline --------------------------------------------------------

_LOCK_CASES = {
    "BadServer.peek_unlocked": ("read of _pending", "LD1"),
    "BadServer.reset_unlocked": ("write to _draining", "LD1"),
    "BadServer._split": ("split guard", "LD2"),
    "BadServer.sleepy_hold": ("sleep", "LD3"),
    "BadServer.sync_hold": ("self._prog.wait()", "LD3"),
    "BadServer.event_hold": ("synchronize()", "LD3"),
    "BadServer.copy_hold": ("cpu()", "LD3"),
    "BadServer.io_hold": ("print", "LD3"),
    "BadServer.queue_hold": ("queue get with no timeout", "LD3"),
    "BadServer.backwards": ("_step_lock -> _lock order", "LD4"),
    "BadServer.backwards_oneliner": ("_step_lock -> _lock order", "LD4"),
    "BadServer._relock": ("self-deadlock", "LD4"),
}


@pytest.fixture(scope="module")
def lock_findings():
    src = (_FIXTURES / "locks_bad.py").read_text()
    by_symbol: dict = {}
    for f in locks.check_source("locks_bad.py", src):
        by_symbol.setdefault(f.symbol, []).append(f.message)
    return by_symbol


@pytest.mark.parametrize("symbol", sorted(_LOCK_CASES))
def test_locks_flags_each_violation_class(lock_findings, symbol):
    needle, rule = _LOCK_CASES[symbol]
    msgs = lock_findings.get(symbol, [])
    assert any(needle in m and rule in m for m in msgs), (
        f"{symbol}: expected {needle!r} ({rule}); got {msgs}")


def test_locks_accepts_disciplined_fixture():
    src = (_FIXTURES / "locks_good.py").read_text()
    findings = locks.check_source("locks_good.py", src)
    assert not findings, "\n".join(str(f) for f in findings)


def test_locks_roster_order_is_the_references():
    assert locks.LOCK_ORDER == ("_step_lock", "_lock")


def test_locks_guard_inference_uses_must_held_call_sites():
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._x = 0\n"
        "    def set(self):\n"
        "        with self._lock:\n"
        "            self._x = 0\n"
        "    def _bump_locked(self):\n"
        "        self._x += 1\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self._bump_locked()\n")
    assert not locks.check_source("c.py", src)
    leaky = src + ("    def leak(self):\n"
                   "        self._bump_locked()\n")
    findings = locks.check_source("c.py", leaky)
    assert any("write to _x" in f.message for f in findings), \
        [str(f) for f in findings]


def test_locks_bounded_acquire_idiom_counts_as_held():
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._x = 0\n"
        "    def set(self):\n"
        "        with self._lock:\n"
        "            self._x = 1\n"
        "    def teardown(self):\n"
        "        got = self._lock.acquire(timeout=5.0)\n"
        "        if not got:\n"
        "            return\n"
        "        try:\n"
        "            self._x = 0\n"
        "        finally:\n"
        "            self._lock.release()\n")
    assert not locks.check_source("c.py", src), \
        [str(f) for f in locks.check_source("c.py", src)]
    nested = src + ("    def outer(self):\n"
                    "        with self._lock:\n"
                    "            self.teardown()\n")
    findings = locks.check_source("c.py", nested)
    assert any("self-deadlock" in f.message for f in findings), \
        [str(f) for f in findings]


def test_locks_oneliner_double_acquire_is_self_deadlock():
    src = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def twice(self):\n"
        "        with self._lock, self._lock:\n"
        "            return 1\n")
    findings = locks.check_source("c.py", src)
    assert any("self-deadlock" in f.message for f in findings), \
        [str(f) for f in findings]


# -- dispatch-discipline ----------------------------------------------------

_DISPATCH_LOOP = tuple(
    f"BadScheduler.{m}" for m in
    ("dispatch", "rogue_sync", "waiter", "scalarize", "copy_home",
     "settler", "hollow_commit", "bad_rounds", "bad_width", "opaque_flags",
     "splat_flag_fn", "uses_jobs_flags", "good_rounds", "good_width",
     "feed"))
_DISPATCH_SANCTIONED = ("BadScheduler.dispatch",
                        "BadScheduler.hollow_commit")
_DISPATCH_CASES = {
    "BadScheduler.rogue_sync": ("outside the sanctioned", "DD2"),
    "BadScheduler.waiter": ("synchronize()", "DD2"),
    "BadScheduler.scalarize": ("item()", "DD2"),
    "BadScheduler.copy_home": ("cpu()", "DD2"),
    "BadScheduler.settler": ("settle()", "DD2"),
    "BadScheduler.hollow_commit": ("sanction list has rotted", ""),
    "BadScheduler.bad_rounds": ("static switch 'n_rounds'", "DD4"),
    "BadScheduler.bad_width": ("static switch 'width'", "DD4"),
    "BadScheduler.opaque_flags": ("cannot be verified", "DD4"),
    "BadScheduler.splat_flag_fn": ("**-splat", "DD4"),
    "BadScheduler._jobs_flags": ("static switch 'n_rounds' built", "DD4"),
}


@pytest.fixture(scope="module")
def dispatch_findings():
    src = (_FIXTURES / "dispatch_bad.py").read_text()
    by_symbol: dict = {}
    for f in dispatch.check_scheduler_source(
            "dispatch_bad.py", src, _DISPATCH_LOOP, _DISPATCH_SANCTIONED):
        by_symbol.setdefault(f.symbol, []).append(f.message)
    return by_symbol


@pytest.mark.parametrize("symbol", sorted(_DISPATCH_CASES))
def test_dispatch_flags_each_violation_class(dispatch_findings, symbol):
    needle, rule = _DISPATCH_CASES[symbol]
    msgs = dispatch_findings.get(symbol, [])
    assert any(needle in m and rule in m for m in msgs), (
        f"{symbol}: expected {needle!r}; got {msgs}")


@pytest.mark.parametrize("symbol", ["dispatch", "good_rounds", "good_width",
                                    "feed", "uses_jobs_flags"])
def test_dispatch_clean_shapes_stay_silent(dispatch_findings, symbol):
    """The sanctioned wait, bounded literal and flag function switches, and
    the host->device feed path are clean (the flag function's own unbounded
    switch fires at the flag function, not at its caller)."""
    assert f"BadScheduler.{symbol}" not in dispatch_findings


def test_dispatch_program_inventory():
    """DD1: launches name their program bodies; flag functions are found
    through a direct call, a local name and a `flags=` keyword."""
    src = (_FIXTURES / "dispatch_bad.py").read_text()
    bodies, flag_fns = dispatch.inventory_programs(ast.parse(src))
    assert set(bodies) == {"_decode_body", "_width_body"}
    assert set(flag_fns) == {"_width_flags", "_jobs_flags"}
    assert flag_fns["_width_flags"].statics == {"width", "use_rows"}
    assert flag_fns["_width_flags"].bool_statics == {"use_rows"}
    plan_src = ("class S:\n"
                "    def _f(self, n):\n"
                "        return {'n': n}\n"
                "    def _plan(self, n):\n"
                "        return Plan(flags=self._f(n))\n")
    _, b = dispatch.inventory_programs(ast.parse(plan_src))
    assert set(b) == {"_f"} and b["_f"].statics == {"n"}


def test_dispatch_inventory_of_the_port_servers():
    """The port's programs and flag_fns are what the audited servers
    launch: the three paged bodies through two flag_fns and a literal,
    the contiguous ones through literals."""
    paged = (_ROOT / _INF / "paged_server.py").read_text()
    bodies, flag_fns = dispatch.inventory_programs(ast.parse(paged))
    assert set(bodies) == {"_prefill_chunk", "_decode_rounds",
                           "_mixed_step"}
    assert set(flag_fns) == {"_decode_flags", "_mixed_flags"}
    assert flag_fns["_mixed_flags"].statics == {"n_rounds", "g_iter"}
    contiguous = (_ROOT / _INF / "server.py").read_text()
    bodies, flag_fns = dispatch.inventory_programs(ast.parse(contiguous))
    assert bodies and not flag_fns


def test_dispatch_missing_roster_function_is_a_finding():
    src = (_FIXTURES / "dispatch_bad.py").read_text()
    findings = [f for f in dispatch.check_scheduler_source(
        "dispatch_bad.py", src, ("BadScheduler.vanished",), ())
        if f.symbol == "BadScheduler.vanished"]
    assert len(findings) == 1 and "not found" in findings[0].message
    assert findings[0].line > 1  # anchored at the class, not line 1


def test_dispatch_accepts_disciplined_fixture():
    src = (_FIXTURES / "dispatch_good.py").read_text()
    findings = dispatch.check_scheduler_source(
        "dispatch_good.py", src,
        ("GoodScheduler.step", "GoodScheduler._chunk_rounds",
         "GoodScheduler._launch_plan"),
        ("GoodScheduler.step",))
    assert not findings, "\n".join(str(f) for f in findings)


def test_dispatch_host_policy_purity():
    src = (_FIXTURES / "dispatch_bad.py").read_text()
    findings = dispatch.check_host_policy_source("dispatch_bad.py", src)
    assert any("imports" in f.message for f in findings)
    clean = ("import threading\nimport time\n\n"
             "def policy(x):\n    return x + 1\n")
    assert not dispatch.check_host_policy_source("policy.py", clean)
    touch = "def f(t):\n    return torch.zeros(3)\n"
    assert any("touches torch" in f.message
               for f in dispatch.check_host_policy_source("p.py", touch))


def test_dispatch_rosters_cover_both_servers():
    for rel in ("paged_server.py", "server.py", "graphs.py"):
        assert _INF + rel in dispatch.SCHEDULER_LOOPS
        assert dispatch.SANCTIONED_SYNCS[_INF + rel]
    # the port's own commit points, each checked in the code
    paged = set(dispatch.SANCTIONED_SYNCS[_INF + "paged_server.py"])
    assert paged == {f"PagedInferenceServer.{m}" for m in (
        "_run_one_chunk", "_decode_dispatch", "_mixed_dispatch",
        "_commit_inflight", "_export_request_locked")}
    assert set(dispatch.SANCTIONED_SYNCS[_INF + "server.py"]) == {
        "InferenceServer._admit_group",
        "InferenceServer._commit_decode_chunk"}
    loop = set(dispatch.SCHEDULER_LOOPS[_INF + "paged_server.py"])
    assert "PagedInferenceServer._pad_limits" not in loop


def test_dispatch_overlap_plan_release_free():
    src = (
        "class S:\n"
        "    def _release_slot(self, sid):\n"
        "        pass\n"
        "    def _helper(self):\n"
        "        self._release_slot(0)\n"
        "    def _plan_iteration(self):\n"
        "        self._helper()\n"
        "    def _launch_plan(self, plan):\n"
        "        self.allocator.release([1])\n"
        "    def _overlap_sweep(self):\n"
        "        self.allocator.alloc(2)\n"
    )
    findings = dispatch.check_overlap_source(
        "s.py", src, ("S._plan_iteration", "S._launch_plan",
                      "S._overlap_sweep"))
    msgs = [f.message for f in findings]
    assert any("_release_slot" in m for m in msgs), msgs
    assert any("allocator.release" in m for m in msgs), msgs
    assert all("DD5" in m for m in msgs)
    assert not [f for f in findings if f.symbol == "S._overlap_sweep"]


def test_dispatch_overlap_missing_plan_function_is_a_finding():
    findings = dispatch.check_overlap_source(
        "s.py", "class S:\n    pass\n", ("S._plan_iteration",))
    assert findings and "not found" in findings[0].message


def test_dispatch_overlap_roster_covers_the_async_scheduler():
    rel = _INF + "paged_server.py"
    quals = dispatch.OVERLAP_PLAN_FUNCS[rel]
    for want in ("_plan_iteration", "_launch_plan", "_overlap_sweep",
                 "_extend_chains_planned", "_handoff_prefetch"):
        assert f"PagedInferenceServer.{want}" in quals
    assert ("PagedInferenceServer._commit_inflight"
            in dispatch.SANCTIONED_SYNCS[rel])
    loops = set(dispatch.SCHEDULER_LOOPS[rel])
    for needed in ("_handoff_prefetch", "_drain_handoff_ready",
                   "pending_prefill_tokens", "_step_sequential"):
        assert f"PagedInferenceServer.{needed}" in loops


def test_dispatch_overlap_export_stays_out_of_plan_reach():
    src = (
        "class S:\n"
        "    def _release_slot(self, sid):\n"
        "        pass\n"
        "    def _evacuate_request_locked(self, req):\n"
        "        self._release_slot(0)\n"
        "    def migrate_export(self, req):\n"
        "        self._evacuate_request_locked(req)\n"
        "    def _handoff_prefetch(self, sel):\n"
        "        self.migrate_export(None)\n"
        "    def _handoff_prefetch_fine(self, sel):\n"
        "        buf = self._gather_pages(sel)\n"
        "        host.copy_(buf, non_blocking=True)\n"
    )
    findings = dispatch.check_overlap_source(
        "s.py", src, ("S._handoff_prefetch", "S._handoff_prefetch_fine"))
    msgs = [f.message for f in findings]
    assert any("_release_slot" in m for m in msgs), msgs
    assert all("DD5" in m for m in msgs)
    assert not [f for f in findings
                if f.symbol == "S._handoff_prefetch_fine"], msgs


_STATIC_SRC = (
    "def _body(m, bufs, *, n_rounds: int, rows: bool):\n"
    "    return bufs\n"
    "class S:\n"
    "    def _flags(self, n_rounds, rows):\n"
    "        return {'n_rounds': n_rounds, 'rows': rows}\n"
    "    def loop_pos(self, prompt, st):\n"
    "        return self._launch(_body, self._flags(len(prompt), True),"
    " st)\n"
    "    def loop_kw(self, prompt, st):\n"
    "        f = self._flags(rows=True, n_rounds=len(prompt))\n"
    "        return self._launch(_body, f, st)\n"
    "    def loop_walrus(self, prompt, st):\n"
    "        if (n := len(prompt)) > 0:\n"
    "            return self._launch(_body, {'n_rounds': n, 'rows': 1},"
    " st)\n"
    "        return None\n"
    "    def loop_ok(self, prompt, st):\n"
    "        return self._launch(_body, self._flags(4, bool(prompt)), st)\n")


@pytest.mark.parametrize("qual,flagged", [
    ("S.loop_pos", True), ("S.loop_kw", True), ("S.loop_walrus", True),
    ("S.loop_ok", False)])
def test_dispatch_checks_positional_keyword_and_walrus_statics(
        qual, flagged):
    """A flag function's statics ride positionally or by keyword; a walrus
    binds like an assignment — each unbounded feed flags."""
    findings = dispatch.check_scheduler_source("s.py", _STATIC_SRC,
                                               (qual,), ())
    hit = any("'n_rounds'" in f.message for f in findings)
    assert hit == flagged, [str(f) for f in findings]


def test_dispatch_plan_flags_are_a_reviewed_field():
    """`plan.flags` (the flag function's result stored by the planner) is
    trusted like the reference's plan statics; another plan field is
    not."""
    src = ("def _body(m, bufs, **statics):\n"
           "    return bufs\n"
           "class S:\n"
           "    def ok(self, plan, st):\n"
           "        return self._launch(_body, plan.flags, st)\n"
           "    def bad(self, plan, st):\n"
           "        return self._launch(_body, plan.extra, st)\n")
    findings = dispatch.check_scheduler_source("s.py", src,
                                               ("S.ok", "S.bad"), ())
    assert {f.symbol for f in findings} == {"S.bad"}


# -- lifecycle-discipline ---------------------------------------------------

_LC_GOOD_KW = dict(owner_funcs=("GoodOwner.retry",),
                   marker_funcs=("GoodLifecycle.emit",),
                   complete_funcs=("GoodLifecycle._complete",),
                   transfer_funcs=("SlotRecord",))
_LC_BAD_KW = dict(owner_funcs=(), marker_funcs=(),
                  complete_funcs=("BadFinish._complete",),
                  transfer_funcs=())
_LC_CASES = {
    "BadFinish.drop_on_floor": ("never reaches _complete", "LC1"),
    "BadFinish.early_exit_leaks": ("return", "LC1"),
    "BadFinish.double_complete": ("completed again", "LC1"),
    "BadFinish.rogue_done_set": ("_done.set() outside", "LC1"),
    "BadFinish.rogue_callback": ("_on_done is read", "LC1"),
    "BadOrder._complete": ("runs before", "LC2"),
    "BadMissing._complete": ("missing the _fail_handler", "LC2"),
    "BadPages.leak_on_return": ("never releases", "LC3"),
    "BadPages.leak_on_raise": ("raise", "LC3"),
    "BadPages.drops_result": ("discarded", "LC3"),
    "BadPages.rebinds_while_live": ("rebound", "LC3"),
    "BadTear.risky_between": ("may-raise call open()", "LC4"),
    "BadTear.staging_between": ("may-raise call torch.as_tensor()",
                                "LC4"),
    "BadTear.wait_between": ("may-raise call prog.wait()", "LC4"),
    "BadTear.raise_between": ("an explicit raise", "LC4"),
}


@pytest.fixture(scope="module")
def lifecycle_findings():
    src = (_FIXTURES / "lifecycle_bad.py").read_text()
    by_symbol: dict = {}
    for f in lifecycle.check_source("lifecycle_bad.py", src, **_LC_BAD_KW):
        by_symbol.setdefault(f.symbol, []).append(f.message)
    return by_symbol


@pytest.mark.parametrize("symbol", sorted(_LC_CASES))
def test_lifecycle_flags_each_violation_class(lifecycle_findings, symbol):
    needle, rule = _LC_CASES[symbol]
    msgs = lifecycle_findings.get(symbol, [])
    assert any(needle in m and rule in m for m in msgs), (
        symbol, msgs or "NO FINDINGS")
    assert len(msgs) == 1, (symbol, msgs)  # no noise


def test_lifecycle_fires_nowhere_else(lifecycle_findings):
    assert set(lifecycle_findings) == set(_LC_CASES), \
        sorted(lifecycle_findings)


def test_lifecycle_accepts_disciplined_fixture():
    src = (_FIXTURES / "lifecycle_good.py").read_text()
    findings = lifecycle.check_source("lifecycle_good.py", src,
                                      **_LC_GOOD_KW)
    assert not findings, "\n".join(str(f) for f in findings)


def test_lifecycle_completion_via_call_graph():
    good = (
        "class S:\n"
        "    def _complete(self, req):\n"
        "        self.metrics.observe_finish(req)\n"
        "        h = self._fail_handler\n"
        "        req._done.set()\n"
        "        cb = req._on_done\n"
        "    def _finish(self, req):\n"
        "        self._deactivate(req)\n"
        "        self._complete(req)\n"
        "    def expire(self, req):\n"
        "        req.finish_reason = 'deadline'\n"
        "        self._finish(req)\n")
    kw = dict(owner_funcs=(), marker_funcs=(), complete_funcs=(),
              transfer_funcs=())
    assert not lifecycle.check_source("s.py", good, **kw)
    bad = good.replace("self._complete(req)", "self._deactivate(req)")
    findings = lifecycle.check_source("s.py", bad, **kw)
    assert any("never reaches _complete" in f.message
               for f in findings), [str(f) for f in findings]


def test_lifecycle_roster_rot_is_a_finding():
    src = ("class R:\n"
           "    def retry(self, orig):\n"
           "        orig.cancel()\n"
           "    def emit(self, req):\n"
           "        return False\n")
    findings = lifecycle.check_source(
        "r.py", src, owner_funcs=("R.retry", "R.gone"),
        marker_funcs=("R.emit",), complete_funcs=("R._complete",),
        transfer_funcs=("RSlot",))
    msgs = [f.message for f in findings]
    assert any("R.gone" in m and "does not exist" in m for m in msgs), msgs
    assert any("no longer contains a _done.set()" in m for m in msgs), msgs
    assert any("no longer assigns finish_reason" in m for m in msgs), msgs
    assert any("COMPLETE_FUNCS" in m or "R._complete" in m
               for m in msgs), msgs
    assert any("RSlot" in m for m in msgs), msgs


def test_lifecycle_rosters_cover_the_serving_stack():
    assert lifecycle.LIFECYCLE_ROSTER == tuple(
        _INF + f for f in ("paged_server.py", "server.py",
                           "block_allocator.py", "migration.py",
                           "router.py"))
    owners = lifecycle.COMPLETION_OWNER_FUNCS[_INF + "router.py"]
    assert "ReplicatedRouter._retry_submit" in owners
    assert "ReplicatedRouter._mirror_retry" in owners
    assert lifecycle.TERMINAL_MARKER_FUNCS[_INF + "server.py"] == (
        "emit_token",)
    assert lifecycle.OWNERSHIP_TRANSFER_FUNCS[
        _INF + "paged_server.py"] == ("_Slot",)
    rep = run_analysis(str(_ROOT), checkers=["lifecycle-discipline"])
    assert rep.ok, "\n".join(str(f) for f in rep.findings)


# -- every roster entry names something in the port -------------------------

def _roster_entries():
    out = []
    for name, roster in (("HOT_PATHS", HOT_PATHS),
                         ("SCHEDULER_LOOPS", dispatch.SCHEDULER_LOOPS),
                         ("SANCTIONED_SYNCS", dispatch.SANCTIONED_SYNCS),
                         ("OVERLAP_PLAN_FUNCS",
                          dispatch.OVERLAP_PLAN_FUNCS),
                         ("COMPLETION_OWNER_FUNCS",
                          lifecycle.COMPLETION_OWNER_FUNCS),
                         ("COMPLETE_FUNCS", lifecycle.COMPLETE_FUNCS),
                         ("OWNERSHIP_TRANSFER_FUNCS",
                          lifecycle.OWNERSHIP_TRANSFER_FUNCS)):
        for rel, quals in roster.items():
            out.append((name, rel, quals))
    return out


@pytest.mark.parametrize("name,rel,quals", _roster_entries(),
                         ids=[f"{n}:{r.rsplit('/', 1)[-1]}"
                              for n, r, _ in _roster_entries()])
def test_roster_entries_exist_in_the_port(name, rel, quals):
    funcs, classes = collect_functions(
        ast.parse((_ROOT / rel).read_text()))
    missing = [q for q in quals if q not in funcs and q not in classes]
    assert not missing, f"{name} names {missing} absent from {rel}"


# -- repairs the gate found (ROADMAP Queue C) -------------------------------

def test_grammar_stack_upload_precedes_the_program_drop():
    """C19: `_sync_grammar_stack` uploads the new stack before it drops
    the old generation's programs, so a failed upload tears nothing
    (the LC4 finding the gate raised there)."""
    src = (_ROOT / _INF / "paged_server.py").read_text()
    funcs, _ = collect_functions(ast.parse(src))
    fn = funcs["PagedInferenceServer._sync_grammar_stack"]
    lines = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            name = ast.unparse(n.func)
            lines.setdefault(name, n.lineno)
    assert lines["torch.as_tensor"] < lines["self._programs.drop"]


# -- reporters / CLI --------------------------------------------------------

def test_analysis_latency_budget():
    t0 = time.perf_counter()
    rep = run_analysis(str(_ROOT))
    elapsed = time.perf_counter() - t0
    assert rep.ok
    assert elapsed < 10.0, f"analysis suite took {elapsed:.1f}s"


def test_json_report_shape_is_stable(report):
    doc = report_json(report)
    assert set(doc) == {"version", "root", "checkers", "counts",
                        "findings", "suppressed"}
    assert doc["version"] == 1
    assert set(doc["counts"]) == {"findings", "suppressed"}
    assert doc["counts"]["findings"] == 0
    assert doc["counts"]["suppressed"] == len(doc["suppressed"])
    for entry in doc["suppressed"]:
        assert set(entry) == {"path", "line", "checker", "symbol",
                              "message", "reason"}
    assert json.loads(json.dumps(doc)) == doc


@pytest.mark.parametrize("args,rc,checkers", [
    (("--json",), 0, None),
    (("--json", "--checker", "lifecycle-discipline"), 0,
     ["lifecycle-discipline"]),
    (("--json", "--checker", "hot-path", "--checker", "lock-discipline"),
     0, ["hot-path", "lock-discipline"]),
])
def test_cli_runs_clean_and_emits_json(args, rc, checkers):
    out = _cli(*args, str(_ROOT))
    assert out.returncode == rc, out.stderr
    doc = json.loads(out.stdout)
    assert doc["counts"]["findings"] == 0
    want = checkers if checkers is not None else list(registered_passes())
    assert sorted(doc["checkers"]) == sorted(want)


@pytest.mark.parametrize("args,needle", [
    (("--checker", "bogus"), "bogus"),
    (("--json", "--sarif"), "not allowed with"),
])
def test_cli_usage_errors_exit_2(args, needle):
    out = _cli(*args, str(_ROOT))
    assert out.returncode == 2
    assert needle in out.stderr


def test_cli_exits_1_on_a_finding(tmp_path):
    """A tree with an unsuppressed finding (here: every rostered file
    missing) exits 1 and reports on stderr."""
    out = _cli(str(tmp_path))
    assert out.returncode == 1
    assert "cannot be read" in out.stderr


def test_cli_emits_sarif():
    out = _cli("--sarif", str(_ROOT))
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["version"] == "2.1.0"
    assert "sarif-2.1.0" in doc["$schema"]
    (run,) = doc["runs"]
    assert run["tool"]["driver"]["name"] == "cloud_server_tpu_torch.analysis"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == set(registered_passes())
    assert run["results"] == []


def test_sarif_results_carry_location_and_level(report):
    rep = type(report)(root=report.root, checkers=report.checkers,
                       findings=list(report.findings),
                       suppressed=report.suppressed)
    rep.findings.append(Finding("pkg/mod.py", 41, "lifecycle-discipline",
                                "C.m", "boom (LC1)"))
    doc = report_sarif(rep)
    (res,) = doc["runs"][0]["results"]
    assert res["ruleId"] == "lifecycle-discipline"
    assert res["level"] == "error"
    assert "[C.m] boom (LC1)" == res["message"]["text"]
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "pkg/mod.py"
    assert loc["region"]["startLine"] == 41
    assert json.loads(json.dumps(doc)) == doc


def test_missing_rostered_file_is_a_finding_not_a_traceback(tmp_path):
    rep = run_analysis(str(tmp_path))
    assert not rep.ok
    assert all("cannot be read" in f.message for f in rep.findings)
    assert {f.checker for f in rep.findings} == set(registered_passes())


# -- catalog drift ----------------------------------------------------------

_CATALOG = _ROOT / _PKG / "analysis" / "CATALOG.md"


def test_checker_catalog_matches_docs():
    """Every registered checker id appears in the port's catalog, and
    vice versa; the pragma syntax and every rule id are documented."""
    doc = _CATALOG.read_text()
    catalog = set(re.findall(r"^\|\s*`([a-z0-9-]+)`", doc, re.M))
    runtime = set(registered_passes()) | {"pragma"}
    assert not runtime - catalog, sorted(runtime - catalog)
    assert not catalog - runtime, sorted(catalog - runtime)
    assert "analysis: allow[" in doc
    for rule in ("HP", "LD1", "LD2", "LD3", "LD4", "DD1", "DD2", "DD3",
                 "DD4", "DD5", "LC1", "LC2", "LC3", "LC4"):
        assert f"**{rule}" in doc, rule


def test_catalog_lists_the_pytorch_vocabulary():
    """The catalog's vocabulary names every sync leaf and device root
    the passes use."""
    from cloud_server_tpu_torch.analysis import framework
    doc = _CATALOG.read_text()
    for leaf in sorted(framework.HOST_SYNC_LEAVES):
        assert f"`.{leaf}()`" in doc or f"`{leaf}()`" in doc, leaf
    for root in sorted(framework.DEVICE_ROOTS):
        assert f"`{root}`" in doc, root
    assert "`wait()`" in doc
