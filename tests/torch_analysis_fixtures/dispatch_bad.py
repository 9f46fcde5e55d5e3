"""Fixture: every dispatch-discipline violation class, in the port's
idiom: captured programs launched through ``self._launch(body, flags,
staged)``, their switches built by flag functions, the one sync a
program's ``wait()``.

NOT imported — parsed by tests/test_torch_analysis.py to prove the
port's ``dispatch-discipline`` checker fires on each rule (DD1..DD4).
The module also imports torch at top level so the HOST-POLICY purity
rule (DD3) can round-trip on the same source.
"""

import torch


def _decode_body(m, bufs, *, n_rounds: int, rows: bool):
    return {"toks": bufs["last"]}


def _width_body(m, bufs, *, width: int):
    return {"toks": bufs["last"]}


def _pad_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


class BadScheduler:
    def __init__(self, cfg):
        self.cfg = cfg
        self.state = None
        self._prog = None
        self._event = None
        self._jobs = []
        self._table = {}

    def _launch(self, body, flags, staged):
        return self._programs.get(body, flags, staged)

    # a flag function: its `width` parameter is a static switch
    def _width_flags(self, width, use_rows: bool):
        return {"width": width, "rows": use_rows}

    # a flag function computing a switch from data of its own
    def _jobs_flags(self):
        return {"n_rounds": len(self._jobs), "rows": False}

    # sanctioned in the test wiring: the one allowed program wait
    def dispatch(self, staged):
        prog = self._launch(_decode_body, {"n_rounds": 2, "rows": False},
                            staged)
        return prog.wait()

    # DD2: a second, unsanctioned wait on the loop
    def rogue_sync(self):
        return self._prog.wait()

    # DD2: an event sync outside the commit points
    def waiter(self):
        self._event.synchronize()

    # DD2: scalar and copy-home syncs
    def scalarize(self):
        return self.state.item()

    def copy_home(self):
        return self.state.cpu().tolist()

    def settler(self):
        return self._prog.settle()

    # DD2 rot (when wired as sanctioned): no wait inside
    def hollow_commit(self):
        return None

    # DD4: a switch fed from unbounded data
    def bad_rounds(self, prompt, staged):
        n = len(prompt)
        return self._launch(_decode_body, {"n_rounds": n, "rows": False},
                            staged)

    # DD4: a flag function's static fed from unbounded data
    def bad_width(self, prompt, staged):
        flags = self._width_flags(len(prompt), True)
        return self._launch(_width_body, flags, staged)

    # DD4: switches the pass cannot see through
    def opaque_flags(self, key, staged):
        return self._launch(_decode_body, self._table[key], staged)

    def splat_flag_fn(self, kw, staged):
        return self._launch(_width_body, self._width_flags(**kw), staged)

    # DD4: the flag function's own unbounded switch fires at the flag function
    def uses_jobs_flags(self, staged):
        return self._launch(_decode_body, self._jobs_flags(), staged)

    # DD4 (clean shape, for contrast): bucketed values stay bounded
    def good_rounds(self, prompt, staged):
        n = min(_pad_pow2(len(prompt)), 8)
        flags = dict(n_rounds=n, rows=bool(prompt))
        return self._launch(_decode_body, flags, staged)

    def good_width(self, prompt, staged):
        return self._launch(
            _width_body, self._width_flags(_pad_pow2(len(prompt)),
                                           use_rows=len(prompt) > 3),
            staged)

    # a tensor feed is the input path, not a sync
    def feed(self, rows):
        return torch.as_tensor(rows).to("cpu", non_blocking=True)
