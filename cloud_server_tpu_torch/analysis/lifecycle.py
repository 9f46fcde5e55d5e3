"""Lifecycle-discipline pass (checker id: ``lifecycle-discipline``).

The port's copy of the reference's pass. A request can terminate in
many ways — failover retry, live migration, prefill/decode handoff,
drain evacuation, deadline expiry, anomaly-window cancellation — and
every one of those paths must honor the same three contracts, which
prose comments and the tests that happen to drive them do not pin:

  * a request that turns terminal is COMPLETED exactly once (waiters
    unblock, telemetry observes the finish, the fail handler gets its
    one offer);
  * the terminal steps inside ``_complete`` run in the documented
    order (telemetry -> fail-handler offer -> ``_done`` -> callback);
  * every KV page the scheduler allocates is released, registered
    into a slot's table, or explicitly ownership-transferred — on
    every outgoing edge, including the exception edges.

This pass proves those statically, with a path-sensitive
intraprocedural walk (returns, raises, try/except/finally, early
exits, loops to fixpoint) plus the same class-local call-graph
propagation the lock pass uses (a call to ``_finish`` is a call to
``_complete``, transitively).

Rules:

  * ``LC1 finish-exactly-once`` — every path from a terminal
    ``<req>.finish_reason = ...`` assignment to function exit must
    reach ``_complete`` (or a method that transitively calls it, or —
    inside a ``COMPLETION_OWNER_FUNCS`` function — the direct
    ``_done.set()`` it is sanctioned to perform) EXACTLY once for
    that request. Completing twice without an intervening rebind
    flags too. ``_done.set()`` calls and ``_on_done`` reads anywhere
    OUTSIDE ``_complete`` / the owner roster are findings: the
    fail-handler contract ("_done stays unset when the fail handler
    takes over") only holds if ``_complete`` is the single place that
    fires them.
  * ``LC2 terminal ordering`` — within each rostered ``_complete``
    body: the ``observe_finish`` telemetry call precedes the
    ``_fail_handler`` offer precedes ``_done.set()`` precedes the
    ``_on_done`` callback read, verified structurally (first
    occurrence of each marker, strictly increasing lines).
  * ``LC3 page-ownership balance`` — a name bound to a
    ``BlockAllocator.alloc`` / ``import_chain`` result must, on every
    path to exit, be discharged: released (an argument to
    ``.release``), registered (extended into a ``.pages`` chain,
    stored into object state, passed as a ``pages=`` keyword), handed
    to an audited ``OWNERSHIP_TRANSFER_FUNCS`` callable, or returned
    to the caller. A ``return``/``raise``/fall-through while the name
    still owns pages is a leak; so is rebinding the name while live,
    or discarding the result expression outright. ``if x is None`` /
    truthiness tests refine the path (the None branch owns nothing).
  * ``LC4 torn-write exception-safety`` — inside a lock-held region
    (lexical ``with self._lock:`` plus the must-held propagation),
    two writes to guarded attributes (guard sets imported from the
    lock pass — ``locks.guarded_attributes``) must not bracket a
    may-raise call (device syncs — a program's ``wait()`` /
    ``settle()``, ``.synchronize()``, ``.item()`` / ``.cpu()`` /
    ``.tolist()`` / ``.numpy()`` — host->device staging —
    ``torch.as_tensor`` / ``torch.tensor`` / ``torch.from_numpy``,
    ``.to(...)`` — fault-injection ``check`` sites, ``open``, or an
    explicit ``raise``)
    unless the region is protected by ``try/finally``: an exception
    between the writes leaves the guarded state torn for the next
    lock holder.

Audited rosters (the ``SANCTIONED_SYNCS`` idiom — each entry is
checked for existence and for still doing the thing it is sanctioned
to do, so the roster can never rot into silently waving through new
code):

  * ``COMPLETION_OWNER_FUNCS`` — the router's failover/migration/
    handoff/mirror paths complete the ORIGINAL handle directly with
    ``_done.set()``: ownership of that handle transferred to the
    router when the replica's ``_complete`` offered it to the fail
    handler (True return = the router owns completion) or when
    ``migrate_export`` evacuated it. Each rostered function must
    still contain a ``_done.set()``.
  * ``TERMINAL_MARKER_FUNCS`` — ``emit_token`` assigns the terminal
    reason but its CALLER owns completion (the commit path calls
    ``_finish`` the moment the emit returns done). Each rostered
    function must still assign ``finish_reason``.
  * ``COMPLETE_FUNCS`` — the ``_complete`` bodies whose LC2
    structure is pinned; a rename breaks the roster loudly.
  * ``OWNERSHIP_TRANSFER_FUNCS`` — callables that accept ownership
    of a page list (today: the ``_Slot`` record, whose pages are
    released later through ``_release_slot``).

Known limits (deliberate, documented): the walk is intraprocedural
and name-based — appending a terminal request to a container (the
deferred-completion idiom: ``doomed.append(req)`` completed after the
lock drops) or rebinding the name discharges the per-name obligation;
the drain site is audited on its own. Exception edges are modeled at
explicit ``raise`` statements (LC4 covers the may-raise-call case);
``except`` handlers conservatively join the state from every point of
their ``try`` body. Everything here is stdlib-only (ast) and never
imports torch or the serving stack.
"""

from __future__ import annotations

import ast

from cloud_server_tpu_torch.analysis.framework import (
    DEVICE_ROOTS, HOST_SYNC_LEAVES, Finding, Pass, collect_functions,
    default_root, dotted_name, enclosing_class_line, is_program_wait,
    read_rostered, register_pass)
from cloud_server_tpu_torch.analysis.locks import guarded_attributes

CHECKER = "lifecycle-discipline"

# The request-lifecycle modules this pass audits: both servers (the
# terminal paths), the allocator (the page side of the ledger), the
# migration snapshot layer, and the router (the completion-ownership
# transfer paths).
LIFECYCLE_ROSTER: tuple[str, ...] = (
    "cloud_server_tpu_torch/inference/paged_server.py",
    "cloud_server_tpu_torch/inference/server.py",
    "cloud_server_tpu_torch/inference/block_allocator.py",
    "cloud_server_tpu_torch/inference/migration.py",
    "cloud_server_tpu_torch/inference/router.py",
)

# Functions sanctioned to call `_done.set()` (and complete a handle)
# OUTSIDE `_complete`: the router's failover paths own the ORIGINAL
# handle — its replica `_complete` already ran its telemetry and
# offered the fail handler (True = the router owns completion), or a
# migrate_export evacuated it without completing. Rot rule: each must
# still contain a `_done.set()` call.
COMPLETION_OWNER_FUNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/router.py": (
        "ReplicatedRouter._retry_submit",
        "ReplicatedRouter._migrate_submit",
        "ReplicatedRouter._handoff_one",
        "ReplicatedRouter._mirror_retry",
    ),
}

# Functions sanctioned to ASSIGN a terminal finish_reason without
# completing: their caller owns completion (the commit path calls
# `_finish` the moment the emit returns done). Rot rule: each must
# still assign `finish_reason`.
TERMINAL_MARKER_FUNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/server.py": ("emit_token",),
}

# The `_complete` implementations whose LC2 terminal ordering is
# pinned structurally. Rot rule: each must exist.
COMPLETE_FUNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/paged_server.py": (
        "PagedInferenceServer._complete",),
    "cloud_server_tpu_torch/inference/server.py": (
        "InferenceServer._complete",),
}

# Callables that take OWNERSHIP of a page list passed to them (LC3
# "transferred"): today the `_Slot` record — its pages are released
# later through `_release_slot`, the one teardown path. Rot rule:
# each must exist (function or class) in its file.
OWNERSHIP_TRANSFER_FUNCS: dict[str, tuple[str, ...]] = {
    "cloud_server_tpu_torch/inference/paged_server.py": ("_Slot",),
}

# allocator entry points whose results carry page ownership
_ALLOC_LEAVES = {"alloc", "import_chain"}
# container ops that register pages into an owned chain (receiver
# must be a `.pages` chain: `slot.pages.extend(fresh)`)
_REGISTER_OPS = {"extend", "append", "appendleft", "insert", "add",
                 "update"}
# container ops that stash a request for deferred completion
_ESCAPE_OPS = {"append", "appendleft", "add", "insert", "put"}
# LC4 may-raise call leaves: device syncs and host->device staging
# (the historical torn-state causes), plus the fault-injection raise
# points and host I/O handles. The staging leaves count only on a torch
# receiver — `np.asarray` is pure host work and cannot OOM the device —
# except a tensor's `.to(...)`, the port's device_put.
_RISKY_LEAVES = set(HOST_SYNC_LEAVES)
_RISKY_TORCH_LEAVES = {"as_tensor", "tensor", "from_numpy"}
_TORCH_RECEIVERS = set(DEVICE_ROOTS)
_RISKY_METHODS = {"to"}
_RISKY_NAMES = {"open"}

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# -- small AST helpers ------------------------------------------------------

def _chains_in(node: ast.AST) -> set[str]:
    """Every maximal dotted attribute chain in a subtree ('slot.req',
    'self.allocator', ...). Chains broken by calls/subscripts yield
    their inner pure chains."""
    out: set[str] = set()

    def visit(n: ast.AST) -> None:
        if isinstance(n, (ast.Attribute, ast.Name)):
            c = dotted_name(n)
            if c is not None:
                out.add(c)
                return
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return out


def _match(var: str, chain: str) -> bool:
    """Does an occurrence of `chain` refer to (part of) `var`?
    Passing `slot` escapes `slot.req`; passing `slot.req` matches it
    exactly; touching `slot.req.tokens` touches `slot.req`."""
    return (chain == var or chain.startswith(var + ".")
            or var.startswith(chain + "."))


def _kill(env: dict, name: str) -> dict:
    """Rebinding `name` drops every tracked var rooted at it."""
    return {v: s for v, s in env.items()
            if not (v == name or v.startswith(name + "."))}


def _target_names(target: ast.AST) -> list[str]:
    """Plain names bound by an assignment/for/with target."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for elt in target.elts:
            out.extend(_target_names(elt))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _merge(*envs):
    """Union-per-var merge of abstract environments; None (an
    unreachable path) is the identity."""
    live = [e for e in envs if e is not None]
    if not live:
        return None
    out: dict[str, frozenset] = {}
    for e in live:
        for v, states in e.items():
            out[v] = out.get(v, frozenset()) | states
    return out


def _is_alloc_call(node: ast.AST) -> str | None:
    """'alloc' / 'import_chain' when `node` is a page-owning
    allocator call (`self.allocator.alloc(...)`), else None."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _ALLOC_LEAVES):
        return None
    recv = dotted_name(node.func.value) or ""
    leaf = recv.split(".")[-1].lower()
    return node.func.attr if "alloc" in leaf else None


def _done_set_base(node: ast.AST) -> str | None:
    """'req' for a `req._done.set()` call node, else None."""
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "set"):
        chain = dotted_name(node.func.value)
        if chain is not None and chain.endswith("._done"):
            return chain[:-len("._done")]
    return None


# -- the path-sensitive walker ----------------------------------------------

class _Flow:
    """Abstract interpretation over one function body: statements in
    order, both branches of every `if` (with optional refinement),
    loops to fixpoint, try/except joining the handler from every
    body point, `finally` applied to early exits. Subclasses define
    the per-statement transfer and the exit obligation."""

    MAX_LOOP_PASSES = 8

    def __init__(self, path: str, qual: str):
        self.path = path
        self.qual = qual
        self.findings: dict[tuple, Finding] = {}
        self._finally_stack: list[list] = []
        self._loops: list[dict] = []

    # subclass hooks ---------------------------------------------------------

    def stmt(self, node: ast.stmt, env: dict) -> dict:
        return env

    def expr(self, node: ast.AST | None, env: dict) -> dict:
        return env

    def refine(self, test: ast.AST, branch: bool,
               env: dict) -> dict | None:
        if isinstance(test, ast.Constant):
            return env if bool(test.value) == branch else None
        return env

    def on_return(self, node: ast.Return, env: dict) -> dict:
        return env

    def on_exit(self, env: dict, line: int, kind: str) -> None:
        pass

    # driver -----------------------------------------------------------------

    def run(self, fn: ast.AST) -> list[Finding]:
        env = self.walk(fn.body, {})
        if env is not None:
            last = fn.body[-1]
            self.on_exit(env, getattr(last, "end_lineno", None)
                         or last.lineno, "falls off the end")
        return list(self.findings.values())

    def _apply_finallys(self, env: dict) -> dict:
        saved = self._finally_stack
        try:
            for i in range(len(saved) - 1, -1, -1):
                self._finally_stack = saved[:i]
                out = self.walk(list(saved[i]), env)
                if out is not None:
                    env = out
        finally:
            self._finally_stack = saved
        return env

    def walk(self, stmts: list, env: dict | None) -> dict | None:
        for s in stmts:
            if env is None:
                return None
            env = self._walk_stmt(s, env)
        return env

    def _walk_stmt(self, s: ast.stmt, env: dict) -> dict | None:
        if isinstance(s, ast.If):
            env = self.expr(s.test, env)
            t = self.walk(s.body, self.refine(s.test, True, env))
            f = self.walk(s.orelse, self.refine(s.test, False, env)) \
                if s.orelse else self.refine(s.test, False, env)
            return _merge(t, f)
        if isinstance(s, (ast.While, ast.For, ast.AsyncFor)):
            return self._walk_loop(s, env)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                env = self.expr(item.context_expr, env)
                if item.optional_vars is not None:
                    for n in _target_names(item.optional_vars):
                        env = _kill(env, n)
            return self.walk(s.body, env)
        if isinstance(s, ast.Try):
            return self._walk_try(s, env)
        if isinstance(s, ast.Return):
            env = self.expr(s.value, env)
            env = self.on_return(s, env)
            self.on_exit(self._apply_finallys(env), s.lineno, "return")
            return None
        if isinstance(s, ast.Raise):
            env = self.expr(s.exc, env)
            self.on_exit(self._apply_finallys(env), s.lineno, "raise")
            return None
        if isinstance(s, ast.Break):
            if self._loops:
                self._loops[-1]["breaks"].append(env)
            return None
        if isinstance(s, ast.Continue):
            if self._loops:
                self._loops[-1]["continues"].append(env)
            return None
        if isinstance(s, _FUNC_NODES + (ast.ClassDef,)):
            return _kill(env, s.name)  # nested defs: not walked
        return self.stmt(s, env)

    def _walk_loop(self, s, env: dict) -> dict | None:
        ctx = {"breaks": [], "continues": []}
        self._loops.append(ctx)
        try:
            seed = env
            for _ in range(self.MAX_LOOP_PASSES):
                ctx["continues"] = []
                body_env = seed
                if isinstance(s, ast.While):
                    body_env = self.refine(
                        s.test, True, self.expr(s.test, body_env))
                else:
                    body_env = self.expr(s.iter, body_env)
                    if body_env is not None:
                        for n in _target_names(s.target):
                            body_env = _kill(body_env, n)
                after = self.walk(s.body, body_env) \
                    if body_env is not None else None
                back = _merge(after, *ctx["continues"])
                new_seed = _merge(seed, back)
                if new_seed == seed:
                    break
                seed = new_seed
            if isinstance(s, ast.While):
                out = self.refine(s.test, False,
                                  self.expr(s.test, seed))
            else:
                out = seed
            out = _merge(out, *ctx["breaks"])
        finally:
            self._loops.pop()
        if s.orelse:
            out = self.walk(s.orelse, out)
        return out

    def _walk_try(self, s: ast.Try, env: dict) -> dict | None:
        has_finally = bool(s.finalbody)
        if has_finally:
            self._finally_stack.append(s.finalbody)
        try:
            running = env  # join of every in-body point: what a
            #                handler may observe
            body = env
            for sub in s.body:
                if body is None:
                    break
                body = self._walk_stmt(sub, body)
                running = _merge(running, body)
            if s.orelse and body is not None:
                body = self.walk(s.orelse, body)
            handler_outs = []
            for h in s.handlers:
                henv = running
                if henv is not None and h.name:
                    henv = _kill(henv, h.name)
                handler_outs.append(self.walk(list(h.body), henv)
                                    if henv is not None else None)
            out = _merge(body, *handler_outs)
        finally:
            if has_finally:
                self._finally_stack.pop()
        if s.finalbody and out is not None:
            out = self.walk(s.finalbody, out)
        return out

    def report(self, key: tuple, finding: Finding) -> None:
        self.findings.setdefault(key, finding)


# -- LC1: finish-exactly-once -----------------------------------------------

_ASSIGNED, _DONE, _LIVE = "assigned", "done", "live"


class _FinishFlow(_Flow):
    """LC1 per-function walk: after `<base>.finish_reason = <terminal>`
    every path must complete `<base>` exactly once."""

    def __init__(self, path: str, qual: str, completing: set,
                 is_owner: bool):
        super().__init__(path, qual)
        self.completing = completing  # self-methods reaching _complete
        self.is_owner = is_owner      # _done.set() counts as complete

    # -- events --------------------------------------------------------------

    def _complete_event(self, env: dict, var: str, line: int) -> dict:
        states = env.get(var)
        if not states:
            return env
        new: set = set()
        for tag, aline in states:
            if tag == _ASSIGNED:
                new.add((_DONE, aline))
            elif tag == _DONE:
                self.report(
                    ("LC1-double", var, line), Finding(
                        self.path, line, CHECKER, self.qual,
                        f"{var} is completed again here — it already "
                        f"completed after its terminal finish_reason "
                        f"assignment at line {aline}; finish-exactly-"
                        "once (LC1)"))
                new.add((tag, aline))
            else:
                new.add((tag, aline))
        return {**env, var: frozenset(new)}

    def expr(self, node: ast.AST | None, env: dict) -> dict:
        if node is None:
            return env
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            args_chains: set[str] = set()
            for a in list(call.args) + [kw.value for kw in
                                        call.keywords]:
                args_chains |= _chains_in(a)
            fchain = dotted_name(call.func)
            leaf = (call.func.attr
                    if isinstance(call.func, ast.Attribute) else None)
            # a call to a completing method with the tracked handle
            # among its arguments completes the handle
            if (fchain is not None and fchain.startswith("self.")
                    and fchain[len("self."):] in self.completing):
                for var in list(env):
                    if any(chain == var for chain in args_chains):
                        env = self._complete_event(env, var,
                                                   call.lineno)
            # sanctioned owner: direct `<base>._done.set()`
            base = _done_set_base(call)
            if base is not None and self.is_owner and base in env:
                env = self._complete_event(env, base, call.lineno)
            # deferred completion: the handle escapes into a
            # container (`doomed.append(req)`) — the drain site owns
            # the obligation from here
            if leaf in _ESCAPE_OPS:
                for var in list(env):
                    if any(_match(var, c) for c in args_chains):
                        env = _kill(env, var.split(".")[0])
        return env

    def stmt(self, node: ast.stmt, env: dict) -> dict:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = node.value
            env = self.expr(value, env)
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            rhs_chains = _chains_in(value) if value is not None \
                else set()
            for tgt in targets:
                if (isinstance(tgt, ast.Attribute)
                        and tgt.attr == "finish_reason"):
                    base = dotted_name(tgt.value)
                    if (base is not None and base != "self"
                            and not (isinstance(value, ast.Constant)
                                     and value.value is None)):
                        env = {**env,
                               base: frozenset({(_ASSIGNED,
                                                 node.lineno)})}
                    continue
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    # storing the handle into object state: deferred
                    # completion, tracked at the drain site
                    for var in list(env):
                        if any(_match(var, c) for c in rhs_chains):
                            env = _kill(env, var.split(".")[0])
                    continue
                for n in _target_names(tgt):
                    env = _kill(env, n)
            return env
        if isinstance(node, ast.Expr):
            return self.expr(node.value, env)
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                for n in _target_names(tgt):
                    env = _kill(env, n)
            return env
        if isinstance(node, ast.Assert):
            return self.expr(node.test, env)
        return env

    def on_exit(self, env: dict, line: int, kind: str) -> None:
        for var, states in env.items():
            for tag, aline in states:
                if tag == _ASSIGNED:
                    self.report(("LC1-leak", var, aline), Finding(
                        self.path, aline, CHECKER, self.qual,
                        f"terminal finish_reason assigned to {var} "
                        f"here, but the path that exits ({kind}, "
                        f"line {line}) never reaches _complete — "
                        "finish-exactly-once (LC1)"))


# -- LC3: page-ownership balance --------------------------------------------

class _PagesFlow(_Flow):
    """LC3 per-function walk: a name bound to an alloc/import_chain
    result must be discharged on every path to exit."""

    def __init__(self, path: str, qual: str,
                 transfer_leaves: set[str]):
        super().__init__(path, qual)
        self.transfer_leaves = transfer_leaves

    def _discharge(self, env: dict, chains: set[str]) -> dict:
        for var in list(env):
            if any(_match(var, c) for c in chains):
                env = _kill(env, var)
        return env

    def expr(self, node: ast.AST | None, env: dict) -> dict:
        if node is None or not env:
            return self._scan_drops(node, env)
        for call in ast.walk(node) if node is not None else ():
            if not isinstance(call, ast.Call):
                continue
            leaf = (call.func.attr
                    if isinstance(call.func, ast.Attribute)
                    else call.func.id
                    if isinstance(call.func, ast.Name) else None)
            arg_chains: set[str] = set()
            for a in call.args:
                arg_chains |= _chains_in(a)
            kw_chains: set[str] = set()
            pages_kw_chains: set[str] = set()
            for kw in call.keywords:
                c = _chains_in(kw.value)
                kw_chains |= c
                if kw.arg == "pages":
                    pages_kw_chains |= c
            recv = (dotted_name(call.func.value)
                    if isinstance(call.func, ast.Attribute) else None)
            if leaf == "release":
                env = self._discharge(env, arg_chains | kw_chains)
            elif (leaf in _REGISTER_OPS and recv is not None
                    and (recv == "pages"
                         or recv.endswith(".pages"))):
                env = self._discharge(env, arg_chains)
            elif leaf in self.transfer_leaves:
                env = self._discharge(env, arg_chains | kw_chains)
            if pages_kw_chains:
                env = self._discharge(env, pages_kw_chains)
        return env

    def _scan_drops(self, node: ast.AST | None, env: dict) -> dict:
        return env

    @staticmethod
    def _alias_chains(value: ast.AST) -> set[str] | None:
        """Chains in an alias-shaped RHS (`y`, `a.b`, `a + b`,
        `[*a, *b]`) — the shapes through which page OWNERSHIP moves
        into the assignment target. A call that merely reads the
        name (`np.asarray([i for i in fill])`) is not a move; the
        source keeps its obligation."""
        if isinstance(value, (ast.Name, ast.Attribute)):
            c = dotted_name(value)
            return {c} if c is not None else None
        if isinstance(value, ast.BinOp) and isinstance(value.op,
                                                       ast.Add):
            left = _PagesFlow._alias_chains(value.left)
            right = _PagesFlow._alias_chains(value.right)
            if left is not None or right is not None:
                return (left or set()) | (right or set())
            return None
        if isinstance(value, (ast.List, ast.Tuple)):
            out: set[str] = set()
            for elt in value.elts:
                sub = _PagesFlow._alias_chains(
                    elt.value if isinstance(elt, ast.Starred)
                    else elt)
                if sub:
                    out |= sub
            return out or None
        return None

    def stmt(self, node: ast.stmt, env: dict) -> dict:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if value is None:
                return env
            env = self.expr(value, env)
            kind = next((k for k in (_is_alloc_call(c)
                                     for c in ast.walk(value))
                         if k is not None), None)
            rhs_chains = _chains_in(value)
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in targets):
                # registered into object state (tables row, slot
                # field): discharged
                env = self._discharge(env, rhs_chains)
            moved: frozenset | None = None
            alias = self._alias_chains(value)
            if alias:
                for var in list(env):
                    if any(_match(var, c) for c in alias):
                        # ownership moves into the target
                        moved = (moved or frozenset()) | env[var]
                        env = _kill(env, var)
            for tgt in targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    moved = None
                    continue
                for n in _target_names(tgt):
                    states = env.get(n)
                    if states:
                        for tag, aline, akind in states:
                            self.report(
                                ("LC3-rebind", n, aline), Finding(
                                    self.path, node.lineno, CHECKER,
                                    self.qual,
                                    f"{n} is rebound here while still "
                                    f"owning the pages {akind}'d at "
                                    f"line {aline} — release, "
                                    "register, or transfer them "
                                    "first (LC3)"))
                    env = _kill(env, n)
            names = [n for tgt in targets
                     for n in _target_names(tgt)]
            if kind is not None and len(names) == 1:
                env = {**env, names[0]:
                       frozenset({(_LIVE, node.lineno, kind)})}
            elif moved and len(names) == 1:
                env = {**env, names[0]: moved}
            return env
        if isinstance(node, ast.AugAssign):
            env = self.expr(node.value, env)
            if isinstance(node.target, ast.Attribute):
                # `slot.pages += fresh`: registered
                env = self._discharge(env, _chains_in(node.value))
            return env
        if isinstance(node, ast.Expr):
            env = self.expr(node.value, env)
            for c in ast.walk(node.value):
                kind = _is_alloc_call(c)
                if kind is not None:
                    self.report(("LC3-drop", node.lineno), Finding(
                        self.path, node.lineno, CHECKER, self.qual,
                        f"result of {kind}() is discarded — the "
                        "pages it allocated can never be released "
                        "(LC3)"))
            return env
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                for n in _target_names(tgt):
                    env = _kill(env, n)
            return env
        return env

    def refine(self, test: ast.AST, branch: bool,
               env: dict) -> dict | None:
        base = super().refine(test, branch, env)
        if base is None:
            return None
        # `if fresh:` / `if fresh is None:` — the empty branch owns
        # nothing, so the obligation drops there
        name, empty_when = None, None
        if isinstance(test, ast.Name):
            name, empty_when = test.id, False
        elif (isinstance(test, ast.UnaryOp)
                and isinstance(test.op, ast.Not)
                and isinstance(test.operand, ast.Name)):
            name, empty_when = test.operand.id, True
        elif (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and len(test.ops) == 1
                and len(test.comparators) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            if isinstance(test.ops[0], ast.Is):
                name, empty_when = test.left.id, True
            elif isinstance(test.ops[0], ast.IsNot):
                name, empty_when = test.left.id, False
        if name is not None and name in base \
                and branch == empty_when:
            return _kill(base, name)
        return base

    def on_return(self, node: ast.Return, env: dict) -> dict:
        if node.value is not None:
            # returning the pages hands ownership to the caller
            env = self._discharge(env, _chains_in(node.value))
        return env

    def on_exit(self, env: dict, line: int, kind: str) -> None:
        for var, states in env.items():
            for tag, aline, akind in states:
                if tag == _LIVE:
                    self.report(("LC3-leak", var, aline), Finding(
                        self.path, aline, CHECKER, self.qual,
                        f"{var} owns the pages {akind}'d here, but "
                        f"the path that exits ({kind}, line {line}) "
                        "never releases, registers, or transfers "
                        "them (LC3)"))


# -- LC2: terminal ordering inside _complete --------------------------------

_LC2_ORDER = (
    ("telemetry", "the observe_finish telemetry call"),
    ("fail_handler", "the _fail_handler offer"),
    ("done_set", "_done.set()"),
    ("on_done", "the _on_done callback read"),
)


def _check_complete_body(path: str, qual: str,
                         fn: ast.AST) -> list[Finding]:
    first: dict[str, int] = {}

    def note(key: str, line: int) -> None:
        if key not in first or line < first[key]:
            first[key] = line

    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            name = dotted_name(n.func) or ""
            if name.split(".")[-1] == "observe_finish":
                note("telemetry", n.lineno)
            if _done_set_base(n) is not None:
                note("done_set", n.lineno)
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            if n.attr == "_fail_handler":
                note("fail_handler", n.lineno)
            if n.attr == "_on_done":
                note("on_done", n.lineno)
    out: list[Finding] = []
    prev_key, prev_line = None, -1
    for key, desc in _LC2_ORDER:
        line = first.get(key)
        if line is None:
            out.append(Finding(
                path, fn.lineno, CHECKER, qual,
                f"_complete is missing {desc} — the terminal order "
                "is telemetry -> fail-handler offer -> _done.set() "
                "-> _on_done (LC2)"))
            continue
        if line < prev_line:
            out.append(Finding(
                path, line, CHECKER, qual,
                f"{desc} (line {line}) runs before "
                f"{dict(_LC2_ORDER)[prev_key]} (line {prev_line}) — "
                "the terminal order is telemetry -> fail-handler "
                "offer -> _done.set() -> _on_done (LC2)"))
        prev_key, prev_line = key, max(prev_line, line)
    return out


# -- LC4: torn writes under a lock ------------------------------------------

class _TornWriteScan:
    """Ordered walk of one method: inside a lock-held region, two
    guarded-attribute writes must not bracket a may-raise call unless
    a try/finally protects the region."""

    def __init__(self, path: str, qual: str, guards: dict,
                 base_held: frozenset, locks: set):
        self.path = path
        self.qual = qual
        self.guards = guards
        self.base_held = base_held
        self.locks = locks
        self.findings: list[Finding] = []
        # (attr, line) of the last guarded write in the current
        # held region; risky call pending since that write
        self._last_write: tuple | None = None
        self._risky: tuple | None = None

    def run(self, fn: ast.AST) -> list[Finding]:
        self._visit_body(fn.body, bool(self.base_held), 0)
        return self.findings

    def _reset(self) -> None:
        self._last_write = None
        self._risky = None

    def _write(self, attr: str, line: int, held: bool,
               protected: int) -> None:
        if not held or attr not in self.guards:
            return
        if (self._last_write is not None and self._risky is not None
                and not protected):
            w1a, w1l = self._last_write
            desc, rline = self._risky
            self.findings.append(Finding(
                self.path, rline, CHECKER, self.qual,
                f"lock-held region writes {w1a} (line {w1l}) and "
                f"{attr} (line {line}) with {desc} between them — "
                "an exception there leaves the guarded state torn; "
                "protect with try/finally (LC4)"))
        self._last_write = (attr, line)
        self._risky = None

    def _risk(self, desc: str, line: int, held: bool) -> None:
        if held and self._last_write is not None \
                and self._risky is None:
            self._risky = (desc, line)

    def _visit_body(self, stmts, held: bool, protected: int) -> None:
        for s in stmts:
            self._visit(s, held, protected)

    def _visit(self, node: ast.AST, held: bool,
               protected: int) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = held
            for item in node.items:
                attr = self._self_attr(item.context_expr)
                if attr in self.locks:
                    acquired = True
                else:
                    self._visit(item.context_expr, held, protected)
            if acquired and not held:
                self._reset()  # fresh region
            self._visit_body(node.body, acquired, protected)
            if acquired and not held:
                self._reset()  # region closed
            return
        if isinstance(node, ast.Try):
            prot = protected + (1 if node.finalbody else 0)
            self._visit_body(node.body, held, prot)
            for h in node.handlers:
                self._visit_body(h.body, held, prot)
            self._visit_body(node.orelse, held, prot)
            self._visit_body(node.finalbody, held, protected)
            return
        if isinstance(node, ast.Raise):
            self._risk("an explicit raise", node.lineno, held)
            return
        if isinstance(node, _FUNC_NODES + (ast.ClassDef,)):
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held, protected)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign,
                             ast.AnnAssign, ast.Delete)):
            # value first (its calls precede the store), then targets
            for field in ("value",):
                v = getattr(node, field, None)
                if v is not None:
                    self._visit(v, held, protected)
            targets = (node.targets if isinstance(
                node, (ast.Assign, ast.Delete))
                else [node.target])
            for tgt in targets:
                attr = self._store_attr(tgt)
                if attr is not None:
                    self._write(attr, node.lineno, held, protected)
                else:
                    self._visit(tgt, held, protected)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._visit(child, held, protected)
            elif isinstance(child, ast.AST):
                self._visit(child, held, protected)

    def _visit_call(self, node: ast.Call, held: bool,
                    protected: int) -> None:
        func = node.func
        leaf = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        recv = (dotted_name(func.value)
                if isinstance(func, ast.Attribute) else "")
        if (leaf in _RISKY_LEAVES or leaf in _RISKY_NAMES
                or is_program_wait(node)
                or (leaf in _RISKY_METHODS and node.args
                    and isinstance(func, ast.Attribute))
                or (leaf in _RISKY_TORCH_LEAVES
                    and recv in _TORCH_RECEIVERS)):
            self._risk(f"may-raise call {dotted_name(func) or leaf}()",
                       node.lineno, held)
        elif leaf == "check" and recv and "fault" in recv.lower():
            self._risk("the fault-injection check() raise point",
                       node.lineno, held)
        # a mutator call on a guarded attribute is a write to it
        if (isinstance(func, ast.Attribute)
                and leaf in _REGISTER_OPS | {"remove", "pop",
                                             "popleft", "clear",
                                             "discard", "setdefault"}):
            attr = self._self_attr(func.value)
            if attr is not None:
                self._write(attr, node.lineno, held, protected)
        for a in node.args:
            self._visit(a, held, protected)
        for kw in node.keywords:
            self._visit(kw.value, held, protected)

    @staticmethod
    def _self_attr(node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _store_attr(self, tgt: ast.AST) -> str | None:
        if isinstance(tgt, ast.Subscript):
            return self._self_attr(tgt.value)
        return self._self_attr(tgt)


# -- per-file orchestration -------------------------------------------------

def _completing_methods(cls: ast.ClassDef) -> set[str]:
    """Self-methods that reach `_complete` transitively — the
    class-local call-graph propagation the lock pass also uses."""
    methods = {c.name: c for c in cls.body
               if isinstance(c, _FUNC_NODES)}
    if "_complete" not in methods:
        return set()
    calls: dict[str, set[str]] = {}
    for name, fn in methods.items():
        out: set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                chain = dotted_name(n.func)
                if chain is not None and chain.startswith("self."):
                    leaf = chain[len("self."):]
                    if leaf in methods:
                        out.add(leaf)
        calls[name] = out
    comp = {"_complete"}
    changed = True
    while changed:
        changed = False
        for name, callees in calls.items():
            if name not in comp and callees & comp:
                comp.add(name)
                changed = True
    return comp


def _iter_functions(tree: ast.Module):
    """(qualname, class node | None, completing set, fn node) for
    every function; nested defs are visited at their own qualname."""
    def visit(node, prefix, cls, comp):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                yield prefix + child.name, cls, comp, child
                yield from visit(child, prefix + child.name + ".",
                                 cls, comp)
            elif isinstance(child, ast.ClassDef):
                sub = _completing_methods(child)
                yield from visit(child, prefix + child.name + ".",
                                 child, sub)

    yield from visit(tree, "", None, set())


def check_source(path: str, source: str, *,
                 owner_funcs: tuple[str, ...] | None = None,
                 marker_funcs: tuple[str, ...] | None = None,
                 complete_funcs: tuple[str, ...] | None = None,
                 transfer_funcs: tuple[str, ...] | None = None
                 ) -> list[Finding]:
    """Run LC1–LC4 over one file. Rosters default to the audited
    module constants keyed by `path`; fixtures inject their own."""
    if owner_funcs is None:
        owner_funcs = COMPLETION_OWNER_FUNCS.get(path, ())
    if marker_funcs is None:
        marker_funcs = TERMINAL_MARKER_FUNCS.get(path, ())
    if complete_funcs is None:
        complete_funcs = COMPLETE_FUNCS.get(path, ())
    if transfer_funcs is None:
        transfer_funcs = OWNERSHIP_TRANSFER_FUNCS.get(path, ())
    tree = ast.parse(source, filename=path)
    functions, classes = collect_functions(tree)
    out: list[Finding] = []

    # roster rot: every sanctioned symbol must exist and still do the
    # thing it is sanctioned to do (the SANCTIONED_SYNCS idiom)
    def missing(qual: str, what: str) -> Finding:
        return Finding(
            path, enclosing_class_line(classes, qual), CHECKER, qual,
            f"{what} roster names {qual} but it does not exist — "
            "renamed? update the roster")

    for qual in owner_funcs:
        fn = functions.get(qual)
        if fn is None:
            out.append(missing(qual, "COMPLETION_OWNER_FUNCS"))
        elif not any(_done_set_base(n) is not None
                     for n in ast.walk(fn)):
            out.append(Finding(
                path, fn.lineno, CHECKER, qual,
                "sanction rot: COMPLETION_OWNER_FUNCS names this "
                "function but it no longer contains a _done.set() "
                "call — remove it from the roster"))
    for qual in marker_funcs:
        fn = functions.get(qual)
        if fn is None:
            out.append(missing(qual, "TERMINAL_MARKER_FUNCS"))
        elif not any(isinstance(n, ast.Attribute)
                     and n.attr == "finish_reason"
                     and isinstance(n.ctx, ast.Store)
                     for n in ast.walk(fn)):
            out.append(Finding(
                path, fn.lineno, CHECKER, qual,
                "sanction rot: TERMINAL_MARKER_FUNCS names this "
                "function but it no longer assigns finish_reason — "
                "remove it from the roster"))
    for qual in complete_funcs:
        if qual not in functions:
            out.append(missing(qual, "COMPLETE_FUNCS"))
    for qual in transfer_funcs:
        if qual not in functions and qual not in classes:
            out.append(missing(qual, "OWNERSHIP_TRANSFER_FUNCS"))

    transfer_leaves = {q.split(".")[-1] for q in transfer_funcs}
    owner_set = set(owner_funcs)
    marker_set = set(marker_funcs)

    for qual, cls, completing, fn in _iter_functions(tree):
        is_owner = qual in owner_set
        # LC1a: terminal assignment -> complete exactly once
        if qual not in marker_set \
                and fn.name not in ("_complete",):
            out.extend(_FinishFlow(path, qual, completing,
                                   is_owner).run(fn))
        # LC1b: completion primitives live only in _complete and the
        # sanctioned owner functions
        if fn.name != "_complete" and not is_owner:
            for n in ast.walk(fn):
                if isinstance(n, _FUNC_NODES) and n is not fn:
                    pass  # nested defs get their own pass
                base = _done_set_base(n) if isinstance(n, ast.Call) \
                    else None
                if base is not None:
                    out.append(Finding(
                        path, n.lineno, CHECKER, qual,
                        f"{base}._done.set() outside _complete — "
                        "only _complete (and the audited "
                        "COMPLETION_OWNER_FUNCS) may fire the done "
                        "event (LC1)"))
                if (isinstance(n, ast.Attribute)
                        and n.attr == "_on_done"
                        and isinstance(n.ctx, ast.Load)):
                    out.append(Finding(
                        path, n.lineno, CHECKER, qual,
                        "_on_done is read (to invoke) outside "
                        "_complete — only _complete (and the "
                        "audited COMPLETION_OWNER_FUNCS) may run "
                        "the completion callback (LC1)"))
        # LC2: terminal ordering, structurally
        if fn.name == "_complete":
            out.extend(_check_complete_body(path, qual, fn))
        # LC3: page-ownership balance
        out.extend(_PagesFlow(path, qual, transfer_leaves).run(fn))

    # LC4: torn guarded writes, guard sets imported from the lock pass
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        guards, must = guarded_attributes(path, node)
        if not guards:
            continue
        locks = {g for gs in guards.values() for g in gs}
        for child in node.body:
            if not isinstance(child, _FUNC_NODES):
                continue
            if child.name in ("__init__", "__post_init__", "__new__"):
                continue
            held = must.get(child.name, frozenset())
            out.extend(_TornWriteScan(
                path, f"{node.name}.{child.name}", guards,
                held, locks).run(child))
    return out


def check_lifecycle(root: str | None = None) -> list[Finding]:
    if root is None:
        root = default_root()
    out: list[Finding] = []
    for rel in LIFECYCLE_ROSTER:
        source, missing = read_rostered(root, rel, CHECKER)
        if missing is not None:
            out.append(missing)
            continue
        out.extend(check_source(rel, source))
    return out


register_pass(Pass(
    id=CHECKER,
    title="requests finish exactly once through _complete (in the "
          "documented terminal order) and every allocated page is "
          "released, registered, or ownership-transferred on every "
          "path",
    run=check_lifecycle,
    roster=lambda root: LIFECYCLE_ROSTER,
))
