"""Fixture: adaptive-speculation controller shapes the hot-path lint
must flag — device work in dispatch planning, numpy buffers in the
per-round feedback, wall-clock reads in the rate estimate, and I/O in
the probe path. Mirrors SpecController's hot surface; never imported
by real code; written in the port's idiom."""

import time  # noqa: F401

import torch  # noqa: F401
import numpy as np  # noqa: F401


class BadSpecController:
    def draft_len_device(self, slot_id):
        # device reduction to pick a draft length: a dispatch planned
        # per iteration must not dispatch
        return int(torch.max(self.lengths))

    def observe_numpy(self, slot_id, drafted, accepted):
        # a numpy buffer materialized per committed round
        rates = np.zeros((drafted + 1,))
        rates[accepted] = 1.0
        self.rate = float(rates.mean())

    def accept_rate_wall_clock(self):
        # wall-clock decay: NTP steps would corrupt the estimate, and
        # the hot path times with monotonic clocks only
        return self.rate * (time.time() - self.stamp)

    def observe_logged(self, slot_id, drafted, accepted):
        import logging
        logging.info("round %s %s", drafted, accepted)

    def on_plain_dispatch_io(self, slot_ids, rounds):
        print("plain dispatch", slot_ids, rounds)
