"""Fixture: a hot-path function the lint must accept — plain host
arithmetic, monotonic clock reads, small Python containers."""

import time


class GoodBucket:
    def __init__(self, rate: float):
        self.rate = rate
        self.level = rate
        self.stamp = time.monotonic()

    def refill(self) -> None:
        now = time.monotonic()
        self.level = min(self.rate, self.level + (now - self.stamp))
        self.stamp = now

    def pick(self, pending) -> int | None:
        heads = {}
        for i, req in enumerate(pending):
            t = getattr(req, "tenant", None) or "default"
            if t not in heads:
                heads[t] = i
        return min(heads.values()) if heads else None
