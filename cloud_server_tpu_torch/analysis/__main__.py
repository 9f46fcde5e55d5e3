"""CLI: ``python -m cloud_server_tpu_torch.analysis [--json | --sarif]
[--checker <id>]... [repo_root]``.

Exit status 0 = every pass is clean (suppressions honored); 1 = at
least one unsuppressed finding; 2 = bad usage (unknown checker id, or
``--json`` combined with ``--sarif``). Text findings go to stderr
(``path:line: [checker] [symbol] message``); ``--json`` writes the
stable machine shape to stdout instead, ``--sarif`` the SARIF 2.1.0
shape CI renders as code annotations.
"""

import argparse
import json
import sys

from cloud_server_tpu_torch.analysis import (registered_passes, render_text,
                                       report_json, run_analysis)
from cloud_server_tpu_torch.analysis.framework import report_sarif


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.analysis",
        description="The port's serving-stack static analysis suite.")
    parser.add_argument("root", nargs="?", default=None,
                        help="repository root (default: autodetected)")
    fmt = parser.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true",
                     help="emit the stable JSON report on stdout")
    fmt.add_argument("--sarif", action="store_true",
                     help="emit a SARIF 2.1.0 report on stdout "
                          "(for CI code annotations)")
    parser.add_argument("--checker", action="append", default=None,
                        metavar="ID",
                        help="run only this checker (repeatable); "
                             f"ids: {sorted(registered_passes())}")
    args = parser.parse_args(argv[1:])
    try:
        report = run_analysis(args.root, checkers=args.checker)
    except KeyError as exc:
        print(f"[analysis] {exc.args[0]}", file=sys.stderr)
        return 2
    if args.json:
        json.dump(report_json(report), sys.stdout, indent=2)
        print()
    elif args.sarif:
        json.dump(report_sarif(report), sys.stdout, indent=2)
        print()
    else:
        print(render_text(report), file=sys.stderr)
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
