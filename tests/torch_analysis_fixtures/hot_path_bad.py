"""Fixture: hot-path functions the lint must FLAG — one violation
class per function, in the port's idiom (torch, a program's wait()).
Parsed by tests/test_torch_analysis.py, never imported."""

import time


class BadPolicy:
    def device_work(self, x):
        import torch
        return torch.as_tensor(x)

    def numpy_alloc(self, xs):
        import numpy as np
        return np.asarray(xs)

    def blocking_sync(self, x):
        return x.item()

    def blocking_cpu(self, x):
        return x.cpu()

    def blocking_tolist(self, x):
        return x.tolist()

    def blocking_numpy(self, x):
        return x.numpy()

    def blocking_event(self, event):
        event.synchronize()

    def blocking_program(self, prog):
        return prog.wait()

    def blocking_settle(self, infl):
        return infl.program.settle()

    def host_io(self, x):
        print(x)
        return x

    def wall_clock(self):
        return time.time()

    def sleeper(self):
        time.sleep(0.1)

    def fine_actually(self, cond):
        # a Condition's wait is host-only: not a device sync
        cond.wait(0.01)
        return time.perf_counter()
