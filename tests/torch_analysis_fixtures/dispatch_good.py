"""Fixture: a disciplined scheduler loop in the port's idiom — the
``dispatch-discipline`` checker must stay silent: one sanctioned
program wait, switches fed only from configuration, booleans,
bucketing helpers and a flag function, the plan replaying its flags."""


def _step_body(m, bufs, *, n_rounds: int, use_rows: bool = False):
    return {"toks": bufs["last"]}


def _bucket(n, table):
    for b in table:
        if n <= b:
            return b
    raise ValueError(n)


class GoodScheduler:
    def __init__(self, cfg):
        self.cfg = cfg
        self.decode_chunk = 8
        self.state = None

    def _launch(self, body, flags, staged):
        return self._programs.get(body, flags, staged)

    def _chunk_rounds(self):
        n = self.decode_chunk
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _step_flags(self, n_rounds, rows):
        return {"n_rounds": n_rounds, "use_rows": bool(rows)}

    def step(self, prompt, staged):
        n = self._chunk_rounds()
        prog = self._launch(_step_body, self._step_flags(n, prompt),
                            staged)
        out = prog.wait()
        return out["toks"]

    def _launch_plan(self, plan, staged):
        f = plan.flags
        return self._launch(_step_body, f, staged)
