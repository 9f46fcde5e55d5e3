"""Static invariant checks for the port's serving stack — a
multi-pass, stdlib-only analysis framework, the port's own copy of the
reference's (same checker ids, rules and pragma syntax; PyTorch's
vocabulary; rosters naming ``cloud_server_tpu_torch/`` files).

``python -m cloud_server_tpu_torch.analysis [--json | --sarif]
[--checker <id>]... [root]`` runs every registered pass over the port's
serving stack and exits non-zero on any unsuppressed finding; the same
gate runs as a tier-1 test (``tests/test_torch_analysis.py``). Checker
ids, rules, the PyTorch vocabulary and the suppression-pragma syntax
are cataloged in ``CATALOG.md`` beside this file (drift-checked both
ways).

The four passes:

  * ``hot-path`` (``hot_path.py``) — the per-iteration scheduler code
    registered in ``HOT_PATHS`` must stay free of device work,
    blocking transfers, numpy-buffer materialization, wall-clock
    reads, and host I/O.
  * ``lock-discipline`` (``locks.py``) — infers each class's
    guarded-attribute sets from its ``with self._lock:`` /
    ``with self._step_lock:`` regions and flags unlocked access to
    shared state, blocking calls while a lock is held, and
    acquisitions against the declared ``_step_lock -> _lock`` order.
  * ``dispatch-discipline`` (``dispatch.py``) — ONE sanctioned program
    ``wait()`` per scheduler iteration, torch-free host-policy
    modules, and statically bounded values into a captured program's
    static switches (the program-variant invariant).
  * ``lifecycle-discipline`` (``lifecycle.py``) — every terminal
    request path reaches ``_complete`` exactly once in the documented
    telemetry -> fail-handler -> ``_done`` -> callback order, every
    allocated KV page is released/registered/transferred on every
    edge, and lock-held regions cannot tear guarded state across a
    may-raise call.

Deliberate exceptions are carried in the code as
``# analysis: allow[<checker>] <reason>`` pragmas; the reason is
mandatory (a reason-less pragma is itself a finding).

Everything here is stdlib-only (ast) and never imports torch, numpy,
or the serving stack: the gate runs inside every test process, so it
must be fast and load no device runtime.
"""

from cloud_server_tpu_torch.analysis.framework import (  # noqa: F401
    Finding, Pass, Report, apply_pragmas, collect_pragmas,
    register_pass, registered_passes, render_text, report_json,
    run_analysis)
# importing the pass modules registers them
from cloud_server_tpu_torch.analysis.hot_path import (  # noqa: F401
    HOT_PATHS, check_hot_paths, check_source)
from cloud_server_tpu_torch.analysis import (  # noqa: F401
    dispatch, lifecycle, locks)
