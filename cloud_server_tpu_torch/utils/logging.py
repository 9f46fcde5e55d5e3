"""Structured metric logging: JSONL on disk + human lines on stdout.

JSONL because every downstream consumer (plotting, regression gates,
benches) wants machine-readable step records; stdout stays terse. Only
process 0 writes by default, so multi-process runs don't write N copies.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, TextIO


class MetricLogger:
    def __init__(self, logdir: str | os.PathLike | None = None, *,
                 name: str = "train", stream: TextIO | None = None,
                 only_process_zero: bool = True, process_index: int = 0):
        self._enabled = (not only_process_zero) or process_index == 0
        self._stream = stream if stream is not None else sys.stdout
        self._file = None
        if self._enabled and logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            self._file = open(os.path.join(os.fspath(logdir),
                                           f"{name}.jsonl"), "a")

    def log(self, step: int, metrics: dict[str, Any]) -> None:
        if not self._enabled:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        body = " ".join(f"{k}={v:.4g}" for k, v in record.items()
                        if k not in ("step", "time"))
        print(f"[step {step}] {body}", file=self._stream)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
