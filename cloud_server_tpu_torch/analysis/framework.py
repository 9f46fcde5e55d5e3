"""Multi-pass static-analysis framework for the port's serving stack.

The port's copy of the reference's framework (same checker ids, pragma
syntax, finding model and reporters), over the files of
``cloud_server_tpu_torch/``. The serving stack's load-bearing
invariants — ONE captured-program launch + ONE host sync (the program's
``wait()``) per scheduler iteration, and the ``_lock`` / ``_step_lock``
discipline that keeps client threads and the scheduler thread off each
other's state — are enforced at runtime only on the paths the
regression tests happen to drive. The passes registered here enforce
them statically, over every registered file, on every test run.

Pieces:

  * ``Finding`` — the one result model every pass emits:
    ``path:line``, the checker id, the symbol it fired in, and a
    message. Paths are repo-relative so findings are stable across
    checkouts.
  * ``Pass`` / ``register_pass`` — the registry. A pass is a stable
    checker id, a ``run(root) -> [Finding]`` callable, and a
    ``roster(root)`` callable naming the repo-relative files it
    audits (the suppression scanner walks the union of all rosters).
  * Inline suppressions — ``# analysis: allow[<checker>] <reason>``.
    The reason is MANDATORY: a reason-less pragma is itself a finding
    (checker id ``pragma``), so an exception can never be waved
    through silently. A pragma suppresses findings of that checker on
    its own line; a pragma on a comment-only line also covers the
    next line (for statements too long to carry a trailing comment).
  * The PyTorch vocabulary every pass shares (``DEVICE_ROOTS``,
    ``HOST_SYNC_LEAVES``, ``is_program_wait``): what counts as device
    work and as a host<->device sync in the port's code.
  * ``run_analysis`` — run selected passes, apply suppressions, and
    return a ``Report``; ``render_text`` / ``report_json`` /
    ``report_sarif`` are the reporters the CLI (``__main__``) exposes.

Everything here is stdlib-only (ast + re) and never imports torch,
numpy, or the serving stack: the gate runs inside every test process,
so it must be fast and must not load a device runtime it never uses.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable

# The implicit checker id carried by reason-less-pragma findings. Not
# a registered pass — it exists only as a finding namespace (and a
# documented id in analysis/CATALOG.md) and cannot be suppressed.
PRAGMA_CHECKER = "pragma"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis result, shared by every pass."""

    path: str       # repo-relative file
    line: int
    checker: str    # stable checker id ("hot-path", "lock-discipline", ...)
    symbol: str     # qualname / attribute the finding is about ("" if n/a)
    message: str

    def __str__(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: [{self.checker}]{sym} " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pass:
    """A registered checker: id must be stable (docs, pragmas, and the
    ``--checker`` CLI flag all key on it)."""

    id: str
    title: str                                  # one-line, for docs/CLI
    run: Callable[[str], list]                  # root -> [Finding]
    roster: Callable[[str], tuple]              # root -> repo-rel files


_REGISTRY: dict[str, Pass] = {}


def register_pass(p: Pass) -> Pass:
    if p.id in _REGISTRY:
        raise ValueError(f"checker id {p.id!r} registered twice")
    if p.id == PRAGMA_CHECKER:
        raise ValueError(f"checker id {PRAGMA_CHECKER!r} is reserved "
                         "for reason-less-pragma findings")
    _REGISTRY[p.id] = p
    return p


def registered_passes() -> dict[str, Pass]:
    """{checker id: Pass}, insertion-ordered (registration order)."""
    return dict(_REGISTRY)


def default_root() -> str:
    """Repository root (three levels above this file's package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def dotted_name(node: ast.AST) -> str | None:
    """Dotted name of an expression ('time.time', 'torch.as_tensor'), or
    None for anything that is not a plain attribute chain. The one
    AST helper every pass leans on."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- the PyTorch vocabulary --------------------------------------------------

# Names whose use is device-framework work (the reference's jax / jnp /
# lax): the port imports torch under no other name.
DEVICE_ROOTS = frozenset({"torch"})
# Call leaves that make the host wait on the card, whatever their
# receiver: a tensor's `.item()` / `.cpu()` / `.tolist()` / `.numpy()`
# (the reference's `device_get` / `.item()`), an event's or the card's
# `.synchronize()` (`block_until_ready`), and a captured program's
# `settle()`. A program's `wait()` is one too (`is_program_wait`): the
# leaf alone is not, since a Condition or threading.Event `wait()` is
# host-only.
HOST_SYNC_LEAVES = frozenset({"item", "cpu", "tolist", "numpy",
                              "synchronize", "settle"})
# Receivers whose `wait()` is a captured program's sync: the
# `graphs.Program` a launch returned, held as `prog` / `program` /
# `<x>.program`, or the `_launch(...)` call itself.
_PROGRAM_NAMES = ("prog", "program")
PROGRAM_LAUNCHERS = frozenset({"_launch"})


def is_program_wait(node: ast.AST) -> bool:
    """True for `prog.wait()`, `infl.program.wait()`,
    `self._launch(...).wait()` — the port's `jax.device_get` of a
    dispatch's results."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "wait"):
        return False
    recv = node.func.value
    if isinstance(recv, ast.Call):
        leaf = (dotted_name(recv.func) or "").rsplit(".", 1)[-1]
        return leaf in PROGRAM_LAUNCHERS
    chain = dotted_name(recv)
    return chain is not None and \
        chain.rsplit(".", 1)[-1].lstrip("_") in _PROGRAM_NAMES


def sync_call_name(node: ast.AST) -> str | None:
    """The dotted name of a host<->device sync call (any
    ``HOST_SYNC_LEAVES`` leaf, or a program's ``wait()``), else None."""
    if not isinstance(node, ast.Call):
        return None
    if is_program_wait(node):
        return (dotted_name(node.func) or "<program>.wait")
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in HOST_SYNC_LEAVES:
        return dotted_name(node.func) or node.func.attr
    return None


def collect_functions(tree: ast.AST
                      ) -> tuple[dict[str, ast.AST], dict[str, int]]:
    """({qualname: FunctionDef}, {class qualname: lineno}) for a
    module — the shared collector behind every roster lookup."""
    found: dict[str, ast.AST] = {}
    classes: dict[str, int] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found[prefix + child.name] = child
                visit(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                classes[prefix + child.name] = child.lineno
                visit(child, prefix + child.name + ".")

    visit(tree, "")
    return found, classes


def read_rostered(root: str, rel: str, checker: str
                  ) -> tuple[str | None, Finding | None]:
    """Read one rostered file; a missing/unreadable file is a FINDING
    (the roster rotted or the root is wrong), never a traceback out
    of the gating step."""
    try:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            return f.read(), None
    except OSError as exc:
        return None, Finding(
            rel, 1, checker, "",
            f"rostered file cannot be read ({exc.strerror or exc}) — "
            "moved/renamed? update the roster")


def enclosing_class_line(classes: dict[str, int], qual: str) -> int:
    """Line of the deepest class prefix of `qual` that exists in
    `classes` ({"A.B": lineno}); 1 when even the class is gone. The
    shared anchor rule for "registered function not found" findings —
    the report lands where the rename happened, not at line 1."""
    parts = qual.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        prefix = ".".join(parts[:cut])
        if prefix in classes:
            return classes[prefix]
    return 1


# -- inline suppressions ----------------------------------------------------

# `# analysis: allow[<checker>] <mandatory reason>`; several pragmas
# may share a line (finditer). The id charset matches registered ids.
_PRAGMA_RE = re.compile(
    r"#\s*analysis:\s*allow\[([A-Za-z0-9_-]+)\]([^#\n]*)")


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One suppression-pragma occurrence."""

    path: str
    line: int                 # where the pragma itself sits
    checker: str
    reason: str
    covers: tuple             # finding lines it suppresses


def _statement_extents(source: str) -> list[tuple[int, int]]:
    """``[(lineno, end_lineno)]`` for every multi-line SIMPLE
    statement (no nested block) — the lexical extents pragma coverage
    expands over. A multi-line call or assignment reports findings at
    sub-expression lines, so a pragma anchored on (or inside) the
    statement must cover every line of it. ``[]`` when the file does
    not parse: coverage then stays line-anchored."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    out: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.stmt)
                and "body" not in node._fields
                and "cases" not in node._fields
                and (node.end_lineno or node.lineno) > node.lineno):
            out.append((node.lineno, node.end_lineno))
    return out


def collect_pragmas(path: str, source: str
                    ) -> tuple[list, list]:
    """Scan one file for suppression pragmas.

    Returns ``([Pragma, ...], reasonless_findings)``. A pragma covers
    the FULL lexical extent of the statement it sits on (or inside —
    a comment line between the continuation lines of a multi-line
    call counts), because findings anchor at sub-expression lines,
    not at the statement's first line. A pragma on a comment-only
    line also covers the statement it annotates (the next non-blank,
    non-comment line, again to its full extent); a pragma with no
    reason text is a ``pragma`` finding and suppresses nothing."""
    pragmas: list[Pragma] = []
    bad: list[Finding] = []
    lines = source.splitlines()
    extents: list[tuple[int, int]] | None = None  # computed lazily
    for lineno, text in enumerate(lines, start=1):
        for m in _PRAGMA_RE.finditer(text):
            checker, reason = m.group(1), m.group(2).strip()
            if not reason:
                bad.append(Finding(
                    path, lineno, PRAGMA_CHECKER, checker,
                    f"suppression pragma allow[{checker}] without a "
                    "reason — every exception must say why"))
                continue
            covers = {lineno}
            if text.lstrip().startswith("#"):
                # comment-only pragma: also covers the statement it
                # annotates — the next non-blank, non-comment line
                for j in range(lineno, len(lines)):
                    nxt = lines[j].strip()
                    if nxt and not nxt.startswith("#"):
                        covers.add(j + 1)
                        break
            if extents is None:
                extents = _statement_extents(source)
            for anchor in sorted(covers):
                # innermost simple statement containing the anchor:
                # cover its whole lexical extent
                span: tuple[int, int] | None = None
                for s, e in extents:
                    if s <= anchor <= e and (
                            span is None
                            or e - s < span[1] - span[0]):
                        span = (s, e)
                if span is not None:
                    covers.update(range(span[0], span[1] + 1))
            pragmas.append(Pragma(path, lineno, checker, reason,
                                  tuple(sorted(covers))))
    return pragmas, bad


def pragma_lines(pragmas: Iterable) -> dict[int, dict[str, str]]:
    """{covered line: {checker id: reason}} from Pragma occurrences —
    the lookup shape ``apply_pragmas`` consumes."""
    by_line: dict[int, dict[str, str]] = {}
    for p in pragmas:
        for ln in p.covers:
            by_line.setdefault(ln, {})[p.checker] = p.reason
    return by_line


def apply_pragmas(pragmas: dict[int, dict[str, str]],
                  findings: Iterable[Finding]
                  ) -> tuple[list[Finding], list[tuple[Finding, str]]]:
    """Split one file's findings into (kept, [(suppressed, reason)])."""
    kept: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for f in findings:
        reason = pragmas.get(f.line, {}).get(f.checker)
        if reason is None:
            kept.append(f)
        else:
            suppressed.append((f, reason))
    return kept, suppressed


# -- the driver -------------------------------------------------------------

@dataclasses.dataclass
class Report:
    """Outcome of one ``run_analysis`` invocation."""

    root: str
    checkers: tuple[str, ...]
    findings: list            # unsuppressed Findings (the gate fails on any)
    suppressed: list          # [(Finding, reason)]

    @property
    def ok(self) -> bool:
        return not self.findings


def run_analysis(root: str | None = None,
                 checkers: Iterable[str] | None = None) -> Report:
    """Run the selected passes (default: all registered), apply inline
    suppressions over every rostered file, and fold reason-less
    pragmas in as findings of the ``pragma`` checker."""
    root = root if root is not None else default_root()
    registry = registered_passes()
    if checkers is None:
        selected = list(registry.values())
    else:
        selected = []
        for cid in checkers:
            if cid not in registry:
                raise KeyError(
                    f"unknown checker {cid!r}; registered: "
                    f"{sorted(registry)}")
            selected.append(registry[cid])

    raw: list[Finding] = []
    files: set[str] = set()
    for p in selected:
        raw.extend(p.run(root))
        files.update(p.roster(root))

    ran = {p.id for p in selected}
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    by_file: dict[str, list[Finding]] = {}
    for f in raw:
        by_file.setdefault(f.path, []).append(f)
    for rel in sorted(files | set(by_file)):
        full = os.path.join(root, rel)
        try:
            with open(full, encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            # a finding about a missing file still surfaces; there is
            # just nothing to scan for pragmas
            findings.extend(by_file.get(rel, []))
            continue
        pragmas, bad = collect_pragmas(rel, source)
        kept, supp = apply_pragmas(pragma_lines(pragmas),
                                   by_file.get(rel, []))
        findings.extend(kept)
        findings.extend(bad)     # reason-less pragmas: unsuppressable
        suppressed.extend(supp)
        # stale-suppression rot: a pragma whose checker RAN but that
        # matched no finding is dead weight that would silently
        # swallow the next genuine finding landing on its line
        hit = {(f.line, f.checker) for f, _ in supp}
        for p in pragmas:
            if p.checker in ran and not any(
                    (ln, p.checker) in hit for ln in p.covers):
                findings.append(Finding(
                    rel, p.line, PRAGMA_CHECKER, p.checker,
                    f"suppression pragma allow[{p.checker}] matched "
                    "no finding — stale; remove it"))
            elif p.checker not in registry:
                findings.append(Finding(
                    rel, p.line, PRAGMA_CHECKER, p.checker,
                    f"suppression pragma names unknown checker "
                    f"{p.checker!r}; registered: {sorted(registry)}"))

    findings.sort(key=lambda f: (f.path, f.line, f.checker, f.message))
    suppressed.sort(key=lambda fr: (fr[0].path, fr[0].line))
    return Report(root=root, checkers=tuple(p.id for p in selected),
                  findings=findings, suppressed=suppressed)


# -- reporters --------------------------------------------------------------

def render_text(report: Report) -> str:
    """Human reporter: one finding per line plus a summary tail."""
    lines = [str(f) for f in report.findings]
    lines.append(
        f"[analysis] checkers: {', '.join(report.checkers)} — "
        f"{len(report.findings)} finding(s), "
        f"{len(report.suppressed)} suppressed")
    return "\n".join(lines)


def report_json(report: Report) -> dict:
    """Machine reporter (the ``--json`` CLI shape). STABLE: external
    tooling consumes this — tests/test_analysis.py pins the keys."""
    return {
        "version": 1,
        "root": report.root,
        "checkers": list(report.checkers),
        "counts": {"findings": len(report.findings),
                   "suppressed": len(report.suppressed)},
        "findings": [f.to_dict() for f in report.findings],
        "suppressed": [{**f.to_dict(), "reason": reason}
                       for f, reason in report.suppressed],
    }


def report_sarif(report: Report) -> dict:
    """SARIF 2.1.0 reporter (the ``--sarif`` CLI shape) — the format
    CI renders as inline code annotations. One run, one rule per
    checker that RAN (so annotation UIs can group by rule even on a
    clean report), one result per unsuppressed finding; suppressed
    findings are omitted (they are the accepted exceptions, not
    annotations to re-litigate on every PR)."""
    rules = [{"id": cid} for cid in report.checkers]
    rule_ids = {cid for cid in report.checkers}
    for f in report.findings:
        if f.checker not in rule_ids:      # e.g. the implicit `pragma`
            rule_ids.add(f.checker)
            rules.append({"id": f.checker})
    results = []
    for f in report.findings:
        message = (f"[{f.symbol}] {f.message}" if f.symbol
                   else f.message)
        results.append({
            "ruleId": f.checker,
            "level": "error",
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                },
            }],
        })
    return {
        "$schema": ("https://json.schemastore.org/sarif-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cloud_server_tpu_torch.analysis",
                "rules": rules,
            }},
            "results": results,
        }],
    }
