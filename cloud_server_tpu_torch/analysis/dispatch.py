"""Dispatch-discipline pass (checker id: ``dispatch-discipline``).

The port's copy of the reference's pass. The load-bearing invariant:
each scheduler iteration launches ONE captured program
(``inference/graphs.py``: a CUDA graph per shape key, replayed) and
pays ONE host<->device sync — the program's ``wait()``, which brings
the sampled tokens home. The runtime regression tests count launches
and syncs on one driven path (``graphs.launches`` / ``graphs.syncs``);
this pass pins the invariant statically across the whole scheduler
loop of both servers.

Rules:

  * ``DD1 program inventory`` — captured programs are auto-discovered
    in each audited server file: every launcher call
    (``self._launch(body, flags, staged)``) names its program body (a
    module-level function) and its static switches ``flags``, the
    reference's ``static_argnames``: each distinct value keys a new
    program (a new CUDA graph captured). The flag functions — methods
    whose dict result reaches a launcher's ``flags``, directly,
    through a local name, or through a ``flags=`` keyword (the async
    scheduler's plan field) — are discovered with them.
  * ``DD2 sanctioned sync`` — a program's ``wait()`` and an event's or
    the card's ``.synchronize()`` may appear ONLY in the functions
    listed in ``SANCTIONED_SYNCS`` (the per-iteration commit points).
    Any other on the scheduler loop, and ANY ``.item()`` /
    ``.cpu()`` / ``.tolist()`` / ``.numpy()`` / ``settle()``, flags.
    Each sanctioned function must exist and actually contain a
    program ``wait()`` or a ``synchronize()`` (sanction rot is a
    finding too). Host->device feeds (``torch.as_tensor``, ``.to``,
    ``copy_(..., non_blocking=True)``) are deliberately NOT flagged:
    they are the dispatch input path, and the port's device->host
    copy STARTS (``copy_(..., non_blocking=True)`` into pinned
    buffers, the reference's ``copy_to_host_async``) have the same
    shape, so they are not flagged either.
  * ``DD3 host-policy purity`` — modules in ``HOST_POLICY_MODULES``
    (admission policy, SLO math, tracing, speculation control,
    metrics) must never import or touch ``torch``; device work
    belongs to the servers, which ARE the allowlist.
  * ``DD4 static-switch boundedness`` — every value flowing into a
    program's static switches from a scheduler-loop function must
    come from a STATICALLY BOUNDED set, because each distinct value
    captures a new program. Bounded means: constants, ``self.*``
    configuration, boolean expressions, callee parameters declared
    ``bool``, the audited bucketing helpers in ``BOUNDED_HELPERS``
    (power-of-two rounding / bucket tables / round planners) —
    composed through arithmetic, min/max, and conditionals — and the
    reviewed ``plan.*`` fields in ``PLAN_BOUNDED_FIELDS``. A launcher's
    ``flags`` must be a dict literal of bounded values, a flag
    flag function's result, ``plan.flags``, ``dict(<flags>, k=<bounded>)``
    or a local name bound only to those; anything else (a ``**``
    splat, an opaque expression) cannot be verified and flags. A flag
    flag function's dict values must be bounded, or come from its
    parameters; those parameters are its statics, checked at every
    call of the flag function from the loop like a jitted callable's.
  * ``DD5 overlap write-safety`` — the async double-buffered
    scheduler plans iteration N+1 WHILE iteration N's program is in
    flight. A page released during that window can be re-allocated to
    a new admission while the device still writes it, so the
    functions in ``OVERLAP_PLAN_FUNCS`` (the plan/launch path and the
    deferred sweep) must never reach — directly or transitively
    through same-class helpers — any of the page-releasing /
    slot-teardown functions in ``PAGE_RELEASING_FUNCS``. Releases
    belong to the commit (``_commit_inflight`` / ``_apply_reaps``)
    and to the sequential paths, which only run with nothing in
    flight.

Stdlib-only (ast); never imports torch or the serving stack.
"""

from __future__ import annotations

import ast

from cloud_server_tpu_torch.analysis.framework import (
    DEVICE_ROOTS, HOST_SYNC_LEAVES, PROGRAM_LAUNCHERS, Finding, Pass,
    collect_functions, default_root, dotted_name, enclosing_class_line,
    is_program_wait, read_rostered, register_pass)

CHECKER = "dispatch-discipline"

# Scheduler-loop functions per server file: everything reachable from
# step() on every iteration. The launch sites and sync sites this pass
# polices all live here. The reference's `_pad_limits` has no
# counterpart (the port pads the draft limits inline in
# `_decode_staged`), its `_stage_decode_spans` is the port's generic
# `_stage_spans`, and its contiguous `_admit_group_plain` /
# `_admit_group_prefixed` are one `_admit_group` taking the program
# body; the port's own staging, flag-building and launch helpers join
# the roster.
SCHEDULER_LOOPS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/paged_server.py": (
        "PagedInferenceServer.step",
        "PagedInferenceServer._step_sequential",
        "PagedInferenceServer.serve_forever",
        "PagedInferenceServer._step_overlap",
        "PagedInferenceServer._plan_iteration",
        "PagedInferenceServer._launch_plan",
        "PagedInferenceServer._commit_inflight",
        "PagedInferenceServer._release_retired",
        "PagedInferenceServer._overlap_sweep",
        "PagedInferenceServer._apply_reaps",
        "PagedInferenceServer._extend_chains_planned",
        "PagedInferenceServer._build_prefill_group",
        "PagedInferenceServer._select_prefill",
        "PagedInferenceServer._expire_pending",
        "PagedInferenceServer._sweep_cancelled",
        "PagedInferenceServer._start_admissions",
        "PagedInferenceServer._sync_grammar_stack",
        "PagedInferenceServer._run_one_chunk",
        "PagedInferenceServer._decode_dispatch",
        "PagedInferenceServer._mixed_dispatch",
        "PagedInferenceServer._launch",
        "PagedInferenceServer._decode_flags",
        "PagedInferenceServer._mixed_flags",
        "PagedInferenceServer._decode_staged",
        "PagedInferenceServer._prefill_staged",
        "PagedInferenceServer._mixed_staged",
        "PagedInferenceServer._scatters_prompts",
        "PagedInferenceServer._commit_decode_out",
        "PagedInferenceServer._commit_decode_rows",
        "PagedInferenceServer._record_iteration",
        "PagedInferenceServer._stage_spans",
        "PagedInferenceServer._prefill_span_tags",
        "PagedInferenceServer._decode_span_tags",
        "PagedInferenceServer._stage_spec_stats",
        "PagedInferenceServer._gather_decode_rows",
        "PagedInferenceServer._spec_plan",
        "PagedInferenceServer._drafted_rows",
        "PagedInferenceServer._chunk_rounds",
        "PagedInferenceServer._mixed_rounds",
        "PagedInferenceServer._extend_chains",
        "PagedInferenceServer._preempt_youngest",
        "PagedInferenceServer._rem_bucket",
        "PagedInferenceServer._ensure_penalty_state",
        "PagedInferenceServer._emit",
        "PagedInferenceServer._finish",
        "PagedInferenceServer._release_slot",
        "PagedInferenceServer._committed",
        "PagedInferenceServer._next_rng",
        # live-migration path: off the step loop (it runs on router /
        # drain threads), but policed by the same sync discipline — the
        # export owns its sanctioned event synchronize (below), and the
        # import must stay async (its scatter is a launch; host->device
        # feeds are the input path DD2 deliberately allows)
        "PagedInferenceServer.migrate_export",
        "PagedInferenceServer.migrate_salvage",
        "PagedInferenceServer._export_request_locked",
        "PagedInferenceServer._build_snapshot",
        "PagedInferenceServer._evacuate_request_locked",
        "PagedInferenceServer._evacuate",
        "PagedInferenceServer.migrate_import",
        "PagedInferenceServer._import_pages",
        "PagedInferenceServer._pool_items",
        "PagedInferenceServer._index_on_device",
        "PagedInferenceServer._host_pages",
        "PagedInferenceServer._gather_pages",
        "PagedInferenceServer._pages_out",
        "PagedInferenceServer._pages_to_device",
        # disaggregation handoff: the prefetch runs on the iteration
        # path right before the mixed launch (its gathers and D2H copy
        # starts are not host syncs), the copy-out right after it, the
        # drain at the end of every step outside the step lock, and
        # pending_prefill_tokens is the router's prefill-load read
        "PagedInferenceServer._handoff_prefetch",
        "PagedInferenceServer._handoff_copy_out",
        "PagedInferenceServer._drain_handoff_ready",
        "PagedInferenceServer.pending_prefill_tokens",
    ),
    "cloud_server_tpu_torch/inference/server.py": (
        "InferenceServer.step",
        "InferenceServer._step_locked",
        "InferenceServer._step_locked_overlap",
        "InferenceServer._commit_decode_chunk",
        "InferenceServer._launch_decode",
        "InferenceServer._launch",
        "InferenceServer._observe_phases",
        "InferenceServer.serve_forever",
        "InferenceServer._sweep_cancelled",
        "InferenceServer._admit_pending",
        "InferenceServer._use_prefix",
        "InferenceServer._pad_group",
        "InferenceServer._ensure_penalty_state",
        "InferenceServer._group_rows",
        "InferenceServer._rows_mode",
        "InferenceServer._admit_group",
        "InferenceServer._chunk_len",
        "InferenceServer._emit",
        "InferenceServer._finish",
        "InferenceServer._next_rng",
    ),
    # the captured program itself: its launch must stay sync-free (the
    # one sync is its wait), so the launch path is on the roster too
    "cloud_server_tpu_torch/inference/graphs.py": (
        "Program.launch",
        "Program.wait",
        "ProgramCache.get",
    ),
}

# The ONE sanctioned per-iteration host sync per dispatch path: these
# are the commit points where the sampled tokens come home (a program's
# wait()). Everything else on the loop must stay async.
SANCTIONED_SYNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/paged_server.py": (
        "PagedInferenceServer._run_one_chunk",
        "PagedInferenceServer._decode_dispatch",
        "PagedInferenceServer._mixed_dispatch",
        # async scheduler: the launch-ahead dispatch's commit point —
        # still ONE wait per committed iteration; _launch_plan itself
        # must stay sync-free (DD2 covers it like every other loop
        # function)
        "PagedInferenceServer._commit_inflight",
        # live migration: the request export's KV gather — one event
        # synchronize per migration (the handoff prefetch's event is
        # waited on there too when the export finds it), at the commit
        # point (inflight work committed first), under the step lock
        # and off the plan path, so DD5's overlap window never sees it
        "PagedInferenceServer._export_request_locked",
    ),
    # the reference's `_step_locked` syncs inline; the port's commits
    # its chunk through `_commit_decode_chunk`, so it has left the list
    "cloud_server_tpu_torch/inference/server.py": (
        "InferenceServer._admit_group",
        "InferenceServer._commit_decode_chunk",
    ),
    # the program's wait() is the sync every commit point above calls
    "cloud_server_tpu_torch/inference/graphs.py": ("Program.wait",),
}

# DD5: the async scheduler's plan/launch path — everything that runs
# while a dispatch may be in flight — and the page-releasing functions
# it must never reach. Transitive through same-class helper calls.
OVERLAP_PLAN_FUNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/paged_server.py": (
        "PagedInferenceServer._plan_iteration",
        "PagedInferenceServer._extend_chains_planned",
        "PagedInferenceServer._overlap_sweep",
        "PagedInferenceServer._launch_plan",
        "PagedInferenceServer._build_prefill_group",
        "PagedInferenceServer._select_prefill",
        # the handoff KV prefetch runs inside _launch_plan while the
        # PREVIOUS dispatch may still be in flight: it reads committed
        # pages and starts D2H copies but must never release a page —
        # and must never reach the export path (whose synchronize is
        # sanctioned only OFF the plan path)
        "PagedInferenceServer._handoff_prefetch",
        "PagedInferenceServer._handoff_copy_out",
    ),
}
PAGE_RELEASING_FUNCS = frozenset({
    "_release_slot", "_preempt_youngest", "_finish", "_extend_chains",
    "_fail_all", "_sweep_cancelled",
    # allocator page release (self.allocator.release / the lock-free
    # variants); plan-path code may alloc, never release
    "release",
})

# DD4: reviewed fields of the async scheduler's _Plan snapshot that
# are bounded BY CONSTRUCTION — _plan_iteration computes them through
# the same audited helpers this pass already trusts (n_rounds via the
# _mixed_rounds/_chunk_rounds pow2 planners, g_iter via _spec_plan's
# {0, spec_drafts} quantization, flags via the flag functions whose
# statics this pass checks at that call) — so _launch_plan replaying
# them into a launch cannot mint new programs. Adding a field here is
# a reviewed decision, exactly like BOUNDED_HELPERS. `flags` is the
# port's: the reference's plan replays the statics one by one.
PLAN_BOUNDED_FIELDS = frozenset({"n_rounds", "g_iter", "flags"})

# Pure host-side policy modules: scheduling decisions, accounting,
# telemetry. The servers are the only modules allowed to touch torch.
HOST_POLICY_MODULES: tuple[str, ...] = (
    "cloud_server_tpu_torch/inference/qos.py",
    "cloud_server_tpu_torch/inference/faults.py",
    "cloud_server_tpu_torch/inference/migration.py",
    "cloud_server_tpu_torch/inference/slo.py",
    "cloud_server_tpu_torch/inference/request_trace.py",
    "cloud_server_tpu_torch/inference/spec_control.py",
    "cloud_server_tpu_torch/inference/iteration_profile.py",
    "cloud_server_tpu_torch/inference/cache_telemetry.py",
    "cloud_server_tpu_torch/inference/anomaly.py",
    "cloud_server_tpu_torch/utils/serving_metrics.py",
    # scenario harness: workload generation, replay, the discrete-event
    # simulator, and the autoscaler are all pure host policy — the
    # simulator MODELS device iterations from fitted flight-record
    # costs, it must never run one
    "cloud_server_tpu_torch/scenarios/workload.py",
    "cloud_server_tpu_torch/scenarios/replay.py",
    "cloud_server_tpu_torch/scenarios/simulator.py",
    "cloud_server_tpu_torch/scenarios/autoscaler.py",
)

# Call leaves whose results are statically bounded REGARDLESS of their
# arguments — the audited bucketing/planning helpers. Adding a name
# here is a reviewed decision: the helper must quantize its output to
# a fixed set (powers of two, a bucket table, {0, spec_drafts}).
BOUNDED_HELPERS = {
    "_pad_pow2",       # next power of two, log2-many values
    "_bucket",         # fixed bucket table lookup
    "_rem_bucket",     # bucket table / prefill_chunk multiples
    "_chunk_rounds",   # power-of-two round planner (paged)
    "_chunk_len",      # power-of-two round planner (contiguous)
    "_mixed_rounds",   # power-of-two round planner (mixed budget)
    "_spec_plan",      # draft width quantized to {0, spec_drafts}
    "_rows_mode",      # (bool, bool)
    "_group_rows",     # (..., bool, bool)
    "bool",
}
# bounded only when every argument is bounded (len is NOT here: a
# data-dependent length is exactly the unbounded source this rule
# exists to catch — route it through a bucketing helper instead)
_ARG_BOUNDED_CALLS = {"min", "max", "int", "abs", "round"}

# DD2: syncs that are never sanctioned (a program's wait() and
# `.synchronize()` are the sanctioned kind, allowed at commit points)
_SYNC_LEAVES = HOST_SYNC_LEAVES - {"synchronize"}
_DEVICE_ROOTS = DEVICE_ROOTS


_dotted = dotted_name


def _self_rooted(node: ast.AST) -> bool:
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _is_commit_sync(node: ast.AST) -> bool:
    """A program's wait() or an event's / the card's synchronize()."""
    return is_program_wait(node) or (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "synchronize")


def _bool_params(fn: ast.AST | None) -> set[str]:
    """Params annotated/defaulted bool: at most two values each —
    intrinsically bounded."""
    out: set[str] = set()
    if fn is None:
        return out
    args = fn.args
    pairs = list(zip(args.kwonlyargs, args.kw_defaults))
    n_def = len(args.defaults)
    pos = args.posonlyargs + args.args
    pairs += list(zip(pos[len(pos) - n_def:], args.defaults))
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = a.annotation
        if isinstance(ann, ast.Name) and ann.id == "bool":
            out.add(a.arg)
    for a, default in pairs:
        if isinstance(getattr(default, "value", None), bool):
            out.add(a.arg)
    return out


def _positional_params(fn: ast.AST | None) -> tuple[str, ...]:
    if fn is None:
        return ()
    return tuple(a.arg for a in fn.args.posonlyargs + fn.args.args)


# -- DD4: static-switch boundedness -----------------------------------------

class _Boundedness:
    """Optimistic per-function classifier: local names start bounded
    and are demoted whenever any assignment feeds them an unbounded
    expression, to fixpoint. Function parameters are unbounded (unless
    `trusted_params` names them)."""

    def __init__(self, fn: ast.AST, trusted_params=frozenset()):
        self.fn = fn
        params = {a.arg for a in fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs}
        params.discard("self")
        self.params = params
        self.unbounded: set[str] = set(params) - set(trusted_params)
        self.assigns: list[tuple[list, ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                self.assigns.append((node.targets, node.value))
            elif isinstance(node, ast.AugAssign):
                synth = ast.BinOp(left=node.target, op=node.op,
                                  right=node.value)
                self.assigns.append(([node.target], synth))
            elif isinstance(node, ast.AnnAssign) and node.value:
                self.assigns.append(([node.target], node.value))
            elif isinstance(node, ast.NamedExpr):
                # walrus: `(n := expr)` binds like an assignment
                self.assigns.append(([node.target], node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                self._demote_target(node.target)
            elif isinstance(node, ast.comprehension):
                self._demote_target(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        self._demote_target(item.optional_vars)
        changed = True
        while changed:
            changed = False
            for targets, value in self.assigns:
                for tgt, expr in self._pair(targets, value):
                    name = tgt.id if isinstance(tgt, ast.Name) else None
                    if name and name not in self.unbounded \
                            and not self.bounded(expr):
                        self.unbounded.add(name)
                        changed = True

    def _demote_target(self, tgt: ast.AST) -> None:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name):
                self.unbounded.add(n.id)

    def _pair(self, targets, value):
        """(target, value-expr) pairs; tuple targets fed by a bounded
        helper call (e.g. `a, b = self._spec_plan(...)`) bind every
        name to that call."""
        for tgt in targets:
            if isinstance(tgt, (ast.Tuple, ast.List)):
                if isinstance(value, (ast.Tuple, ast.List)) \
                        and len(value.elts) == len(tgt.elts):
                    yield from zip(tgt.elts, value.elts)
                else:
                    for e in tgt.elts:
                        yield e, value
            else:
                yield tgt, value

    def bounded(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return node.id not in self.unbounded
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "plan"
                    and node.attr in PLAN_BOUNDED_FIELDS):
                return True  # reviewed _Plan statics (see the constant)
            return _self_rooted(node)  # init-time configuration
        if isinstance(node, (ast.Compare, ast.BoolOp)):
            return True  # boolean-valued: at most two variants
        if isinstance(node, ast.UnaryOp):
            return isinstance(node.op, ast.Not) \
                or self.bounded(node.operand)
        if isinstance(node, ast.BinOp):
            return self.bounded(node.left) and self.bounded(node.right)
        if isinstance(node, ast.IfExp):
            return self.bounded(node.body) and self.bounded(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.bounded(e) for e in node.elts)
        if isinstance(node, ast.Call):
            leaf = (_dotted(node.func) or "?").rsplit(".", 1)[-1]
            if leaf in BOUNDED_HELPERS:
                return True
            if leaf in _ARG_BOUNDED_CALLS:
                return all(self.bounded(a) for a in node.args)
            return False
        return False


# -- DD1: program inventory -------------------------------------------------

def _launcher_call(node: ast.AST) -> ast.Call | None:
    """The call when `node` is `self._launch(body, flags, staged)`."""
    if (isinstance(node, ast.Call)
            and (_dotted(node.func) or "").rsplit(".", 1)[-1]
            in PROGRAM_LAUNCHERS
            and (_dotted(node.func) or "").startswith("self.")):
        return node
    return None


def _flags_arg(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "flags":
            return kw.value
    return call.args[1] if len(call.args) > 1 else None


def _flag_fn_leaf(node: ast.AST, methods: set) -> str | None:
    """'X' when `node` is a `self.X(...)` call of a class method."""
    if isinstance(node, ast.Call):
        name = _dotted(node.func) or ""
        if name.startswith("self.") and name.count(".") == 1:
            leaf = name[len("self."):]
            if leaf in methods:
                return leaf
    return None


class _FlagFn:
    """A flag function: a method whose dict result becomes a program's
    static switches. `statics` are the parameters its dict values come
    from (checked at its call sites, like a jitted callable's
    static_argnames); `unbounded` are dict values it computes from
    data of its own (findings at the flag function)."""

    __slots__ = ("name", "qual", "fn", "statics", "bool_statics",
                 "params", "unbounded")

    def __init__(self, name: str, qual: str, fn: ast.AST):
        self.name, self.qual, self.fn = name, qual, fn
        self.params = _positional_params(fn)
        self.bool_statics = _bool_params(fn)
        inner = _Boundedness(fn)
        trusted = _Boundedness(fn, trusted_params=inner.params)
        self.statics: set[str] = set()
        self.unbounded: list[tuple[str, ast.AST]] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Dict)):
                continue
            for k, v in zip(node.value.keys, node.value.values):
                key = k.value if isinstance(k, ast.Constant) else "?"
                if k is None:
                    self.unbounded.append(("**", v))
                elif inner.bounded(v):
                    continue
                elif trusted.bounded(v):
                    self.statics |= {n.id for n in ast.walk(v)
                                     if isinstance(n, ast.Name)
                                     and n.id in inner.params}
                else:
                    self.unbounded.append((key, v))


def inventory_programs(tree: ast.Module) -> tuple[dict, dict]:
    """({program body: [launch call]}, {flag function name: _FlagFn}) for
    every class of the module: DD1's auto-discovery."""
    bodies: dict[str, list] = {}
    flag_fns: dict[str, _FlagFn] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {c.name: c for c in cls.body
                   if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))}
        found: set[str] = set()
        for fn in methods.values():
            local: dict[str, list] = {}
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            local.setdefault(t.id, []).append(n.value)
            for n in ast.walk(fn):
                call = _launcher_call(n)
                if call is not None:
                    if call.args and isinstance(call.args[0], ast.Name):
                        bodies.setdefault(call.args[0].id, []).append(call)
                    flags = _flags_arg(call)
                    cands = [flags] + (local.get(flags.id, [])
                                       if isinstance(flags, ast.Name)
                                       else [])
                    for c in cands:
                        leaf = _flag_fn_leaf(c, set(methods))
                        if leaf is not None:
                            found.add(leaf)
                if isinstance(n, ast.Call):
                    for kw in n.keywords:
                        if kw.arg == "flags":
                            leaf = _flag_fn_leaf(kw.value, set(methods))
                            if leaf is not None:
                                found.add(leaf)
        for leaf in found:
            flag_fns[leaf] = _FlagFn(leaf, f"{cls.name}.{leaf}",
                                      methods[leaf])
    return bodies, flag_fns


def _flags_ok(expr: ast.AST, fn: ast.AST, bound: _Boundedness,
              flag_fns: dict, depth: int = 0) -> tuple[bool, list]:
    """(analysable, [(switch, unbounded value)]) for a launcher's
    flags expression inside `fn`."""
    if isinstance(expr, ast.Dict):
        bad = []
        for k, v in zip(expr.keys, expr.values):
            if k is None:
                return False, []
            if not bound.bounded(v):
                bad.append((k.value if isinstance(k, ast.Constant)
                            else "?", v))
        return True, bad
    if isinstance(expr, ast.Attribute):
        return (isinstance(expr.value, ast.Name)
                and expr.value.id == "plan"
                and expr.attr in PLAN_BOUNDED_FIELDS), []
    if isinstance(expr, ast.Call):
        name = _dotted(expr.func) or ""
        if name.startswith("self.") and name[len("self."):] in flag_fns:
            return True, []  # its statics are checked at this call
        if name == "dict" and len(expr.args) <= 1 and depth < 4:
            ok, bad = (True, []) if not expr.args else _flags_ok(
                expr.args[0], fn, bound, flag_fns, depth + 1)
            for kw in expr.keywords:
                if kw.arg is None:
                    return False, []
                if not bound.bounded(kw.value):
                    bad.append((kw.arg, kw.value))
            return ok, bad
        return False, []
    if isinstance(expr, ast.Name) and depth < 4:
        values = [n.value for n in ast.walk(fn)
                  if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == expr.id
                          for t in n.targets)]
        if not values:
            return False, []
        bad = []
        for v in values:
            ok, sub = _flags_ok(v, fn, bound, flag_fns, depth + 1)
            if not ok:
                return False, []
            bad += sub
        return True, bad
    return False, []


# -- the pass ---------------------------------------------------------------

def check_scheduler_source(path: str, source: str,
                           loop_quals: tuple[str, ...],
                           sanctioned: tuple[str, ...]) -> list[Finding]:
    """DD1/DD2/DD4 over one server module."""
    tree = ast.parse(source, filename=path)
    _bodies, flag_fns = inventory_programs(tree)
    found, classes = collect_functions(tree)
    out: list[Finding] = []

    def missing(qual: str, what: str) -> None:
        out.append(Finding(path, enclosing_class_line(classes, qual),
                           CHECKER, qual,
                           f"{what} (renamed? update the "
                           "dispatch-discipline roster)"))

    for qual in sanctioned:
        fn = found.get(qual)
        if fn is None:
            missing(qual, "sanctioned-sync function not found")
        elif not any(_is_commit_sync(n) for n in ast.walk(fn)):
            out.append(Finding(
                path, fn.lineno, CHECKER, qual,
                "sanctioned-sync function no longer contains a "
                "program wait() or synchronize() — the sanction list "
                "has rotted"))

    for b in flag_fns.values():
        for key, expr in b.unbounded:
            out.append(Finding(
                path, expr.lineno, CHECKER, b.qual,
                f"static switch {key!r} built from a statically "
                "UNBOUNDED expression — every distinct value captures "
                "a new program (DD4)"))

    for qual in loop_quals:
        fn = found.get(qual)
        if fn is None:
            missing(qual, "scheduler-loop function not found")
            continue
        bound = None  # built lazily: most loop functions launch nothing
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else name or "?")
            if _is_commit_sync(node):
                if qual not in sanctioned:
                    out.append(Finding(
                        path, node.lineno, CHECKER, qual,
                        f"device sync {name or leaf}() outside the "
                        "sanctioned per-iteration commit points (DD2)"))
            elif leaf in _SYNC_LEAVES:
                out.append(Finding(
                    path, node.lineno, CHECKER, qual,
                    f"device sync {name or leaf}() on the scheduler "
                    "loop (DD2)"))
            launch = _launcher_call(node)
            b = None
            if name is not None and name.startswith("self."):
                b = flag_fns.get(name[len("self."):])
            if launch is None and b is None:
                continue
            if bound is None:
                bound = _Boundedness(fn)

            def unbounded(argname, expr, what):
                out.append(Finding(
                    path, expr.lineno, CHECKER, qual,
                    f"static switch {argname!r} of {what} fed from a "
                    "statically UNBOUNDED expression — every distinct "
                    "value captures a new program (DD4)"))

            if launch is not None:
                flags = _flags_arg(launch)
                body = (launch.args[0].id if launch.args
                        and isinstance(launch.args[0], ast.Name)
                        else "?")
                ok, bad = (False, []) if flags is None else _flags_ok(
                    flags, fn, bound, flag_fns)
                if not ok:
                    out.append(Finding(
                        path, node.lineno, CHECKER, qual,
                        f"static switches of program {body} are not "
                        "a literal, a flag function's result or a plan "
                        "field — their boundedness cannot be verified "
                        "(DD4)"))
                for key, expr in bad:
                    unbounded(key, expr, f"program {body}")
                continue
            # a flag function's statics can ride POSITIONALLY too: map
            # call positions onto its parameter names (a *splat makes
            # later positions unknowable — stop mapping there)
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Starred):
                    break
                if i + 1 < len(b.params) \
                        and b.params[i + 1] in b.statics \
                        and b.params[i + 1] not in b.bool_statics \
                        and not bound.bounded(arg):
                    unbounded(b.params[i + 1], arg, f"flag function {b.name}")
            for kw in node.keywords:
                if kw.arg is None:
                    # **splat: statics may hide inside — opaque to
                    # this analysis, so it is a finding by itself
                    out.append(Finding(
                        path, kw.value.lineno, CHECKER, qual,
                        f"**-splat into flag function {b.name} — static "
                        "switches cannot be verified through it (DD4)"))
                    continue
                if kw.arg not in b.statics \
                        or kw.arg in b.bool_statics:
                    continue
                if not bound.bounded(kw.value):
                    unbounded(kw.arg, kw.value, f"flag function {b.name}")
    return out


def check_overlap_source(path: str, source: str,
                         plan_quals: tuple[str, ...]) -> list[Finding]:
    """DD5 over one server module: no page-releasing function is
    reachable from the overlap plan path — directly, or transitively
    through same-class ``self.*`` helper calls."""
    tree = ast.parse(source, filename=path)
    found, classes = collect_functions(tree)
    out: list[Finding] = []

    def self_calls(fn: ast.AST):
        """(leaf name, node) for every self.X(...) / X(...) call."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name is None:
                continue
            yield name.rsplit(".", 1)[-1], name, node

    for qual in plan_quals:
        fn = found.get(qual)
        if fn is None:
            out.append(Finding(
                path, enclosing_class_line(classes, qual), CHECKER,
                qual, "overlap-plan function not found (renamed? "
                      "update OVERLAP_PLAN_FUNCS)"))
            continue
        cls = qual.rsplit(".", 1)[0]
        seen: set[str] = set()
        stack: list[tuple[str, ast.AST]] = [(qual, fn)]
        while stack:
            cur_qual, cur_fn = stack.pop()
            if cur_qual in seen:
                continue
            seen.add(cur_qual)
            for leaf, name, node in self_calls(cur_fn):
                if leaf in PAGE_RELEASING_FUNCS:
                    out.append(Finding(
                        path, node.lineno, CHECKER, qual,
                        f"overlap-plan path reaches page-releasing "
                        f"{name}() (via {cur_qual}) while a dispatch "
                        "may be in flight — releases belong to the "
                        "commit (DD5)"))
                    continue
                callee_qual = f"{cls}.{leaf}"
                callee = found.get(callee_qual)
                if callee is not None and name.startswith("self."):
                    stack.append((callee_qual, callee))
    return out


def check_host_policy_source(path: str, source: str) -> list[Finding]:
    """DD3: no torch anywhere in a host-policy module."""
    tree = ast.parse(source, filename=path)
    out: list[Finding] = []
    seen: set[int] = set()

    def flag(node: ast.AST, msg: str) -> None:
        if node.lineno not in seen:
            seen.add(node.lineno)
            out.append(Finding(path, node.lineno, CHECKER, "", msg))

    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mod = (getattr(node, "module", None) or "").split(".")[0]
            names = {a.name.split(".")[0] for a in node.names}
            hit = ({mod} | names) & _DEVICE_ROOTS
            if hit:
                flag(node, f"host-policy module imports {sorted(hit)} "
                           "— device work belongs to the servers (DD3)")
        elif isinstance(node, ast.Name) and node.id in _DEVICE_ROOTS:
            flag(node, f"host-policy module touches {node.id}.* — "
                       "device work belongs to the servers (DD3)")
    return out


def check_dispatch(root: str | None = None) -> list[Finding]:
    if root is None:
        root = default_root()
    out: list[Finding] = []
    for rel, quals in SCHEDULER_LOOPS.items():
        source, missing = read_rostered(root, rel, CHECKER)
        if missing is not None:
            out.append(missing)
            continue
        out.extend(check_scheduler_source(
            rel, source, quals, SANCTIONED_SYNCS.get(rel, ())))
        plan_quals = OVERLAP_PLAN_FUNCS.get(rel)
        if plan_quals:
            out.extend(check_overlap_source(rel, source, plan_quals))
    for rel in HOST_POLICY_MODULES:
        source, missing = read_rostered(root, rel, CHECKER)
        if missing is not None:
            out.append(missing)
            continue
        out.extend(check_host_policy_source(rel, source))
    return out


register_pass(Pass(
    id=CHECKER,
    title="one sanctioned program wait per scheduler iteration, "
          "torch-free host-policy modules, statically bounded program "
          "switches, and a release-free overlap plan path",
    run=check_dispatch,
    roster=lambda root: tuple(SCHEDULER_LOOPS) + HOST_POLICY_MODULES,
))
