"""Lock-discipline pass (checker id: ``lock-discipline``).

The port's copy of the reference's pass. The serving stack shares
state between client threads (submit / cancel / scrape) and the
scheduler thread through two mutexes:
``self._lock`` guards the pending queue, the draining latch, and the
small registries, while ``self._step_lock`` serializes the whole
scheduler iteration. This pass infers that discipline per class and
flags code that steps outside it.

Model (per class that assigns ``self.<name> = threading.Lock()``):

  1. Lexical lock regions: statements inside ``with self.<lock>:``,
     plus the bounded-acquire teardown idiom — after
     ``got = self.<lock>.acquire(timeout=...)`` the remainder of the
     enclosing block counts as holding the lock (for paths that must
     not hang behind a wedged holder; release is assumed at block
     end via try/finally).
  2. A class-local call graph (``self.m(...)`` calls, plus reads of
     ``@property`` attributes) propagates held locks:
     ``must_held(m)`` = locks held at EVERY internal call site
     (public methods are entry points: must_held is empty — an
     external caller holds nothing); ``may_held(m)`` = locks held at
     ANY internal call site.
  3. GUARDED-ATTRIBUTE inference: every ``self._*`` attribute written
     (assign / augassign / del / subscript-store / mutating method
     call: append, remove, update, ...) while at least one lock is
     must-held, anywhere in the class, is shared state. Its guard is
     the INTERSECTION of the lock sets across those writes — the
     locks every writer agrees on. ``__init__`` is construction-time
     and excluded entirely.

Rules:

  * ``LD1 unlocked access`` — a read or write of a guarded attribute
    at a point whose must-held set shares no lock with the guard.
  * ``LD2 split guard`` — an attribute whose locked writes share NO
    common lock (two writers that can race each other).
  * ``LD3 blocking under lock`` — a blocking call while any lock may
    be held: a captured program's ``wait()`` / ``settle()``, an
    event's or the card's ``.synchronize()``, a tensor's ``.cpu()``
    (the reference's ``device_get`` / ``block_until_ready``),
    ``time.sleep`` (any ``.sleep``), host I/O (``print`` / ``open`` /
    ``input``),
    socket ops (``recv`` / ``send`` / ``sendall`` / ``accept`` /
    ``connect``), and ``<queue>.get()`` with no timeout.
  * ``LD4 lock order`` — ``LOCK_ORDER`` declares ``_step_lock`` is
    taken BEFORE ``_lock`` (the order ``PagedInferenceServer.step``
    -> ``_record_iteration`` -> ``num_pending`` established);
    acquiring against that order, or acquiring a lock that may
    already be held (self-deadlock — these are not RLocks), flags.

Known limits (deliberate, documented): the analysis is class-local
(a qos registry's lock taken under the server's step lock is a
different object — cross-object ordering is out of scope); nested
functions are scanned at their definition site's lock state; and
must-held is conservative, so a teardown-only caller (e.g. a
post-mortem ``_fail_all``) weakens the guard inference of everything
it calls — which is exactly why ``_fail_all`` serializes on the step
lock too.
"""

from __future__ import annotations

import ast

from cloud_server_tpu_torch.analysis.framework import (
    Finding, Pass, default_root, dotted_name, is_program_wait,
    read_rostered, register_pass)

CHECKER = "lock-discipline"

# The serving modules whose cross-thread state this pass audits (the
# two servers' shared-state mutexes plus every policy/telemetry module
# the scheduler iteration consults).
LOCK_ROSTER: tuple[str, ...] = (
    "cloud_server_tpu_torch/inference/paged_server.py",
    "cloud_server_tpu_torch/inference/qos.py",
    "cloud_server_tpu_torch/inference/faults.py",
    "cloud_server_tpu_torch/inference/migration.py",
    "cloud_server_tpu_torch/inference/router.py",
    "cloud_server_tpu_torch/inference/request_trace.py",
    "cloud_server_tpu_torch/inference/slo.py",
    "cloud_server_tpu_torch/inference/cache_telemetry.py",
    "cloud_server_tpu_torch/inference/anomaly.py",
    # the watchdog's monitor thread beside the training loop's beats
    "cloud_server_tpu_torch/utils/failure.py",
    # the pipeline's schedule (no thread of its own: held to the rules
    # should one come)
    "cloud_server_tpu_torch/parallel/pipeline.py",
)

# Declared acquisition order, outermost first: the scheduler iteration
# (_step_lock) may take the state mutex (_lock) inside it, never the
# reverse — a client thread holding _lock while waiting on a running
# iteration would stall submit/cancel behind a whole dispatch.
LOCK_ORDER: tuple[str, ...] = ("_step_lock", "_lock")

_LOCK_CTORS = {"Lock", "RLock"}
# attribute method calls treated as WRITES to the attribute
_MUTATORS = {"append", "appendleft", "extend", "insert", "remove",
             "pop", "popleft", "clear", "update", "setdefault",
             "discard", "add"}
# call leaves that block the holding thread: the port's device waits
# (an event's or the card's synchronize, a program's settle, a tensor's
# explicit copy home) and sleeps; a program's wait() is matched by
# is_program_wait. `.item()` / `.tolist()` / `.numpy()` stay out, as
# `.item()` does in the reference: on the scheduler they act on numpy
# host arrays, which no static rule can tell from tensors.
_BLOCKING_LEAVES = {"synchronize", "settle", "cpu", "sleep"}
_BLOCKING_NAMES = {"print", "open", "input"}
_SOCKET_LEAVES = {"recv", "recvfrom", "send", "sendall", "accept",
                  "connect"}
_SKIP_METHODS = {"__init__", "__post_init__", "__new__"}


_dotted = dotted_name


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a `self.x` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    return name is not None and name.split(".")[-1] in _LOCK_CTORS


class _Access:
    __slots__ = ("attr", "write", "node", "held")

    def __init__(self, attr, write, node, held):
        self.attr, self.write = attr, write
        self.node, self.held = node, held


class _MethodScan:
    """Lexical facts about one method: self-attribute accesses, lock
    acquisitions, internal call sites, and blocking calls — each with
    the set of locks lexically held at that point."""

    def __init__(self):
        self.accesses: list[_Access] = []
        self.acquires: list[tuple[str, ast.AST, frozenset]] = []
        self.calls: list[tuple[str, frozenset]] = []
        self.blocking: list[tuple[str, ast.AST, frozenset]] = []


class _ClassAnalysis:
    def __init__(self, path: str, node: ast.ClassDef):
        self.path = path
        self.node = node
        self.methods: dict[str, ast.AST] = {}
        self.properties: set[str] = set()
        for child in node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[child.name] = child
                for dec in child.decorator_list:
                    if (isinstance(dec, ast.Name)
                            and dec.id == "property"):
                        self.properties.add(child.name)
        # lock attributes: assigned a Lock()/RLock() anywhere
        self.locks: set[str] = set()
        for fn in self.methods.values():
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and _is_lock_ctor(n.value):
                    for tgt in n.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            self.locks.add(attr)
        # condition variables constructed OVER a class lock alias it:
        # `self._work = threading.Condition(self._lock)` means `with
        # self._work:` holds _lock (that IS the Condition's mutex), so
        # guarded-attribute checks must credit it
        self.lock_aliases: dict[str, str] = {}
        for fn in self.methods.values():
            for n in ast.walk(fn):
                if (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)):
                    name = _dotted(n.value.func)
                    if (name is not None
                            and name.split(".")[-1] == "Condition"
                            and n.value.args):
                        src = _self_attr(n.value.args[0])
                        if src in self.locks:
                            for tgt in n.targets:
                                attr = _self_attr(tgt)
                                if attr is not None:
                                    self.lock_aliases[attr] = src
        self.scans: dict[str, _MethodScan] = {}

    # -- lexical scan -------------------------------------------------------

    def scan(self) -> None:
        for name, fn in self.methods.items():
            if name in _SKIP_METHODS:
                continue
            ms = _MethodScan()
            self._visit_body(fn.body, frozenset(), ms)
            self.scans[name] = ms

    def _bounded_acquire(self, stmt: ast.AST) -> str | None:
        """Lock name for the bounded-acquire teardown idiom
        ``got = self.<lock>.acquire(timeout=...)`` — a path that must
        not hang takes the lock with a timeout and proceeds either
        way; the rest of the block is treated as holding it."""
        if not (isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "acquire"):
            return None
        attr = _self_attr(stmt.value.func.value)
        return attr if attr in self.locks else None

    def _visit_body(self, stmts, held: frozenset,
                    ms: _MethodScan) -> None:
        for stmt in stmts:
            self._visit(stmt, held, ms)
            lock = self._bounded_acquire(stmt)
            if lock is not None:
                ms.acquires.append((lock, stmt, held))
                held = held | {lock}

    def _visit(self, node: ast.AST, held: frozenset,
               ms: _MethodScan) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                attr = _self_attr(item.context_expr)
                attr = self.lock_aliases.get(attr, attr)
                if attr in self.locks:
                    # items acquire LEFT TO RIGHT: each sees the locks
                    # the earlier items already took, so a one-liner
                    # `with self._lock, self._step_lock:` trips the
                    # same LD4 rules as the nested form
                    ms.acquires.append((attr, item.context_expr,
                                        held | acquired))
                    acquired.add(attr)
                else:
                    self._visit(item.context_expr, held | acquired, ms)
                if item.optional_vars is not None:
                    self._visit(item.optional_vars, held | acquired, ms)
            self._visit_body(node.body, held | acquired, ms)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held, ms)
            return
        if isinstance(node, ast.Subscript):
            # `self._x[k] = v` / `del self._x[k]`: the Store/Del ctx
            # sits on the Subscript — the inner Attribute reads as
            # Load — but semantically this WRITES the container
            attr = _self_attr(node.value)
            if (attr is not None
                    and isinstance(node.ctx, (ast.Store, ast.Del))):
                self._record_attr(node.value, attr, held, ms,
                                  write=True)
                self._visit(node.slice, held, ms)
                return
        if isinstance(node, ast.Attribute):
            attr = _self_attr(node)
            if attr is not None:
                self._record_attr(node, attr, held, ms)
                return  # the Name('self') child is not an access
        for field, value in ast.iter_fields(node):
            if isinstance(value, list) and value \
                    and isinstance(value[0], ast.stmt):
                self._visit_body(value, held, ms)
            elif isinstance(value, list):
                for child in value:
                    if isinstance(child, ast.AST):
                        self._visit(child, held, ms)
            elif isinstance(value, ast.AST):
                self._visit(value, held, ms)

    def _record_attr(self, node: ast.Attribute, attr: str,
                     held: frozenset, ms: _MethodScan,
                     write: bool | None = None) -> None:
        if attr in self.locks or attr in self.lock_aliases:
            return
        if attr in self.properties:
            # a property read runs the getter: a call-graph edge
            ms.calls.append((attr, held))
            return
        if attr in self.methods:
            return  # bare method reference (callback assignment)
        if write is None:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
        ms.accesses.append(_Access(attr, write, node, held))

    def _visit_call(self, node: ast.Call, held: frozenset,
                    ms: _MethodScan) -> None:
        func = node.func
        handled_func = False
        recv_attr = None
        if isinstance(func, ast.Attribute):
            leaf = func.attr
            recv_attr = _self_attr(func.value)
            if recv_attr is not None and leaf in _MUTATORS \
                    and recv_attr not in self.locks \
                    and recv_attr not in self.methods:
                # self._x.append(...) — a write to _x
                ms.accesses.append(_Access(recv_attr, True, func.value,
                                           held))
                handled_func = True
            name = _dotted(func) or leaf
            if (leaf in _BLOCKING_LEAVES or leaf in _SOCKET_LEAVES
                    or is_program_wait(node)):
                ms.blocking.append((f"blocking call {name}()", node,
                                    held))
            elif leaf == "get" and not node.args:
                recv = _dotted(func.value) or ""
                if ("queue" in recv.lower()
                        and not any(kw.arg == "timeout"
                                    for kw in node.keywords)):
                    ms.blocking.append(
                        (f"unbounded {name}() — a queue get with no "
                         "timeout", node, held))
            mname = _self_attr(func)
            if mname is not None and mname in self.methods:
                ms.calls.append((mname, held))
                handled_func = True
        elif isinstance(func, ast.Name):
            if func.id in _BLOCKING_NAMES:
                ms.blocking.append((f"host I/O call {func.id}()", node,
                                    held))
            handled_func = True  # a bare name is not a self access
        if not handled_func:
            self._visit(func, held, ms)
        for arg in node.args:
            self._visit(arg, held, ms)
        for kw in node.keywords:
            self._visit(kw.value, held, ms)

    # -- inter-procedural held-lock propagation -----------------------------

    def propagate(self) -> tuple[dict[str, frozenset],
                                 dict[str, frozenset]]:
        """(must_held, may_held) per method, to fixpoint over the
        class-local call graph. Public methods (and methods never
        called internally) are entry points: must_held = {} — some
        caller out there holds nothing."""
        sites: dict[str, list[tuple[str, frozenset]]] = {
            m: [] for m in self.scans}
        for caller, ms in self.scans.items():
            for callee, held in ms.calls:
                if callee in sites:
                    sites[callee].append((caller, held))
        all_locks = frozenset(self.locks)
        must = {}
        may = {m: frozenset() for m in self.scans}
        for m in self.scans:
            entry = not m.startswith("_") or m.startswith("__") \
                or not sites[m]
            must[m] = frozenset() if entry else all_locks
        changed = True
        while changed:
            changed = False
            for m in self.scans:
                if not sites[m]:
                    continue
                new_may = frozenset().union(
                    *[held | may[c] for c, held in sites[m]])
                if new_may != may[m]:
                    may[m] = new_may
                    changed = True
                if must[m]:  # entry points stay pinned at {}
                    new_must = all_locks
                    for c, held in sites[m]:
                        new_must &= held | must[c]
                    if new_must != must[m]:
                        must[m] = new_must
                        changed = True
        return must, may

    # -- rules --------------------------------------------------------------

    def infer_guards(self, must: dict[str, frozenset]
                     ) -> tuple[dict[str, frozenset], list[Finding]]:
        """Guarded-attribute inference from locked writes: every
        ``self._*`` attribute written while a lock is must-held is
        shared state, guarded by the INTERSECTION of the lock sets
        across its locked writes. Returns ({attr: guard}, LD2
        split-guard findings). Shared with the lifecycle pass, whose
        LC4 torn-write rule consumes the same guard sets."""
        out: list[Finding] = []
        cls = self.node.name
        locked_writes: dict[str, list[frozenset]] = {}
        for m, ms in self.scans.items():
            for a in ms.accesses:
                if a.write and a.attr.startswith("_"):
                    locks_at = a.held | must[m]
                    if locks_at:
                        locked_writes.setdefault(a.attr, []).append(
                            locks_at)
        guard: dict[str, frozenset] = {}
        for attr, sets in locked_writes.items():
            g = frozenset.intersection(*sets)
            if g:
                guard[attr] = g
            else:
                some = sorted(frozenset.union(*sets))
                out.append(Finding(
                    self.path, self.node.lineno, CHECKER,
                    f"{cls}.{attr}",
                    f"split guard: {attr} is written under "
                    f"{some} with no common lock — two writers can "
                    "race (LD2)"))
        return guard, out

    def check(self) -> list[Finding]:
        if not self.locks:
            return []
        self.scan()
        must, may = self.propagate()
        cls = self.node.name
        guard, out = self.infer_guards(must)

        rank = {name: i for i, name in enumerate(LOCK_ORDER)}
        for m, ms in self.scans.items():
            qual = f"{cls}.{m}"
            for a in ms.accesses:
                g = guard.get(a.attr)
                if g and not ((a.held | must[m]) & g):
                    kind = "write to" if a.write else "read of"
                    out.append(Finding(
                        self.path, a.node.lineno, CHECKER, qual,
                        f"{kind} {a.attr} (guarded by "
                        f"{sorted(g)}) without holding it (LD1)"))
            for desc, node, held in ms.blocking:
                locks_at = held | may[m]
                if locks_at:
                    out.append(Finding(
                        self.path, node.lineno, CHECKER, qual,
                        f"{desc} while holding {sorted(locks_at)} "
                        "(LD3)"))
            for lock, node, held in ms.acquires:
                locks_at = held | may[m]
                if lock in locks_at:
                    out.append(Finding(
                        self.path, node.lineno, CHECKER, qual,
                        f"possible self-deadlock: acquiring {lock} "
                        "while it may already be held on a caller "
                        "path (LD4)"))
                elif lock in rank and any(
                        rank.get(h, -1) > rank[lock]
                        for h in locks_at):
                    inner = sorted(h for h in locks_at if h in rank
                                   and rank[h] > rank[lock])
                    out.append(Finding(
                        self.path, node.lineno, CHECKER, qual,
                        f"acquiring {lock} while holding {inner} "
                        f"violates the declared "
                        f"{' -> '.join(LOCK_ORDER)} order (LD4)"))
        return out


def guarded_attributes(path: str, node: "ast.ClassDef"
                       ) -> tuple[dict[str, frozenset],
                                  dict[str, frozenset]]:
    """({attr: guard-lock set}, {method: must-held set}) for one
    class, or ({}, {}) when it owns no locks. The lifecycle pass's
    LC4 torn-write rule imports THIS — both passes must agree on
    which attributes are guarded shared state, or a rename would
    silently drop an attribute from one audit but not the other."""
    ca = _ClassAnalysis(path, node)
    if not ca.locks:
        return {}, {}
    ca.scan()
    must, _may = ca.propagate()
    guard, _ld2 = ca.infer_guards(must)
    return guard, must


def check_source(path: str, source: str) -> list[Finding]:
    """Run the lock-discipline rules over every lock-owning class in
    `source` (fixtures and the real roster share this entry point)."""
    tree = ast.parse(source, filename=path)
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_ClassAnalysis(path, node).check())
    return out


def check_locks(root: str | None = None) -> list[Finding]:
    if root is None:
        root = default_root()
    out: list[Finding] = []
    for rel in LOCK_ROSTER:
        source, missing = read_rostered(root, rel, CHECKER)
        if missing is not None:
            out.append(missing)
            continue
        out.extend(check_source(rel, source))
    return out


register_pass(Pass(
    id=CHECKER,
    title="cross-thread state must be touched under its inferred "
          "guard, never block while locked, and respect the "
          "_step_lock -> _lock order",
    run=check_locks,
    roster=lambda root: LOCK_ROSTER,
))
