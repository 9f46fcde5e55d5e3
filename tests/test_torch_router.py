"""The port's replica router (mirroring tests/test_router.py case for
case): a fleet of port servers equals the reference server's outputs,
least-loaded placement, HTTP behind `HttpFrontend`, embeddings and
adapters across the fleet, a replica's NotImplementedError kept a
client refusal (C10), draining replicas, the
breaker cycle and the racing submits, each stub case run through the
reference's router and the port's alike, and live fleet mutation."""

import dataclasses
import json
import logging
import os
import sys
import threading
import time as _time

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.router import (
    ReplicatedRouter as RefRouter)
from cloud_server_tpu.inference.server import (
    QueueFullError as RefQueueFullError)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.router import ReplicatedRouter
from cloud_server_tpu_torch.inference.server import QueueFullError
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(CFG))
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
TGREEDY = TInferConfig(**dataclasses.asdict(GREEDY))
SRV_KW = dict(max_slots=2, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16])
PROMPT = [5, 9, 3]
# the stub cases run through both routers, each with its own
# QueueFullError (the router tells client refusals by that class)
ROUTERS = [(RefRouter, RefQueueFullError), (ReplicatedRouter,
                                             QueueFullError)]
ROUTER_IDS = ["ref", "port"]


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), TCFG,
                                  device="cpu")


@pytest.fixture(scope="module")
def ref_tokens(weights):
    """The reference server's greedy tokens for PROMPT (8 new)."""
    lone = RefServer(weights[0], CFG, GREEDY, **SRV_KW)
    return lone.generate([PROMPT], max_new_tokens=8)[0]


def _fleet(weights, n=2):
    return ReplicatedRouter.over_devices(
        weights[1], TCFG, TGREEDY, devices=["cpu"] * n, **SRV_KW)


@pytest.fixture(scope="module")
def router(weights):
    return _fleet(weights)


def test_replica_parity_and_balance(router, ref_tokens):
    """Identical greedy requests give identical outputs (the
    reference's) on whichever replica serves them, and the router uses
    every replica."""
    reqs = [router.submit(PROMPT, max_new_tokens=6) for _ in range(4)]
    router.run_until_idle()
    outs = [r.tokens for r in reqs]
    assert all(o == ref_tokens[:6] for o in outs)
    assert all(r.tokens_emitted > 0 for r in router.replicas)


def test_single_replica_reference(router, ref_tokens):
    assert router.generate([PROMPT], max_new_tokens=8)[0] == ref_tokens


def test_over_devices_places_on_cuda_only(weights):
    """`over_devices` moves the params to each named device; with no
    device named and no CUDA device visible it raises (no CPU
    fallback)."""
    r = _fleet(weights, 3)
    assert [str(s.device) for s in r.replicas] == ["cpu"] * 3
    # on the device the tensors already live on, .to() shares them
    w = r.replicas[0].params["embed"]["tokens"]
    assert w.data_ptr() == r.replicas[1].params["embed"]["tokens"].data_ptr()
    if not _cuda_visible():
        with pytest.raises(RuntimeError, match="CUDA"):
            ReplicatedRouter.over_devices(weights[1], TCFG, TGREEDY,
                                          **SRV_KW)


def _cuda_visible() -> bool:
    import torch
    return torch.cuda.is_available()


def test_least_loaded_placement(weights):
    r = _fleet(weights)
    for _ in range(3):
        r.replicas[0].submit(PROMPT, max_new_tokens=4)
    req = r.submit(PROMPT, max_new_tokens=4)
    assert req in list(r.replicas[1]._pending)
    r.run_until_idle()


def test_router_over_http(router):
    from urllib import request as urq
    router.start()
    front = HttpFrontend(router).start()
    try:
        host, port = front.address
        body = json.dumps({"prompt": PROMPT, "max_tokens": 4}).encode()
        with urq.urlopen(urq.Request(
                f"http://{host}:{port}/v1/completions", data=body),
                timeout=300) as resp:
            out = json.loads(resp.read())
        assert len(out["choices"][0]["tokens"]) == 4
        with urq.urlopen(f"http://{host}:{port}/healthz",
                         timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"]
    finally:
        front.stop()
        router.stop()


def test_router_embeddings_and_adapters(weights):
    """The reference's case: the fleet serves embeddings (any replica's
    answer, equal to the reference server's) and adapters registered on
    every replica; adapter-routed requests give the reference server's
    adapted tokens wherever they land."""
    from cloud_server_tpu.models.lora import LoRAConfig as RefLoRAConfig
    from cloud_server_tpu.models.lora import init_lora_params
    from cloud_server_tpu_torch.models.lora import LoRAConfig
    r = _fleet(weights)
    ref = RefServer(weights[0], CFG, GREEDY, **SRV_KW)
    vecs = r.embed([[5, 9, 3], [60]])
    assert vecs.shape == (2, CFG.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(vecs, ref.embed([[5, 9, 3], [60]]),
                               rtol=0, atol=1e-5)
    lcfg = RefLoRAConfig(rank=2, alpha=4.0, targets=("wq",))
    lp = init_lora_params(CFG, lcfg, jax.random.key(1))
    lp["layers"]["wq"]["b"] = 0.3 * jax.random.normal(
        jax.random.key(2), lp["layers"]["wq"]["b"].shape)
    np_lp = jax.tree.map(np.asarray, lp)
    assert r.add_adapter("ad", np_lp,
                         LoRAConfig(**dataclasses.asdict(lcfg))) == 1
    assert r.adapters.adapter_id("ad") == 1
    assert all(rep.adapters.names == ["ad"] for rep in r.replicas)
    ref.add_adapter("ad", lp, lcfg)
    want = ref.generate([PROMPT], max_new_tokens=4)[0]
    want_ad = ref.submit(PROMPT, max_new_tokens=4, adapter="ad")
    ref.run_until_idle()
    reqs = [r.submit(PROMPT, max_new_tokens=4, adapter="ad")
            for _ in range(4)]
    r.run_until_idle()
    assert all(q.tokens == want_ad.result() for q in reqs)
    assert want_ad.result() != want
    assert all(rep.tokens_emitted > 0 for rep in r.replicas)
    with pytest.raises(ValueError, match="unknown adapter"):
        r.submit(PROMPT, max_new_tokens=4, adapter="nope")


def test_unserved_option_is_a_client_refusal():
    """C10 stays repaired: a replica that refuses an option with
    NotImplementedError (as a port server still refuses tensor
    parallelism and MoE) refuses the client, with no breaker event and
    no failover, and the fleet keeps serving."""
    class _Stub:
        def __init__(self):
            self.num_active = self.num_pending = 0
            self.calls = 0

        def submit(self, prompt, **kw):
            self.calls += 1
            if kw.get("adapter") is not None:
                raise NotImplementedError(
                    "multi-LoRA serving is not ported to this backend")
            return prompt

    stubs = [_Stub(), _Stub()]
    r = ReplicatedRouter(stubs)
    with pytest.raises(NotImplementedError, match="not ported"):
        r.submit(PROMPT, max_new_tokens=4, adapter="ad")
    assert sum(s.calls for s in stubs) == 1  # no failover
    assert all(b["state"] == "closed" and b["consecutive_failures"] == 0
               for b in r.breaker_states())
    assert r.submit(PROMPT, max_new_tokens=4) == PROMPT


def test_router_skips_draining_replica(weights):
    r = _fleet(weights)
    inflight = r.replicas[0].submit(PROMPT, max_new_tokens=6)
    assert r.replicas[0].drain(timeout=0.0) is False
    r.run_until_idle()
    assert inflight.done
    assert r.replicas[0].drain() is True
    assert r.replicas[0].ready is False
    assert r.ready is True
    reqs = [r.submit(PROMPT, max_new_tokens=4) for _ in range(4)]
    r.run_until_idle()
    assert all(len(q.tokens) == 4 for q in reqs)
    snap0 = r.replicas[0].metrics_snapshot()
    snap1 = r.replicas[1].metrics_snapshot()
    assert snap0["cloud_server_requests_submitted_total"]["value"] == 1
    assert snap1["cloud_server_requests_submitted_total"]["value"] == 4
    r.replicas[0].resume()
    assert r.replicas[0].ready is True
    for rep in r.replicas:
        assert rep.drain() is True
    assert r.ready is False
    with pytest.raises(RuntimeError, match="draining"):
        r.submit(PROMPT, max_new_tokens=2)
    for rep in r.replicas:
        rep.resume()


@pytest.mark.parametrize("router_cls,_", ROUTERS, ids=ROUTER_IDS)
def test_drainless_stop_counted_and_logged(router_cls, _, caplog):
    class _NoDrainStub:
        def __init__(self):
            self.stopped = False
            self.num_active = 0
            self.num_pending = 0

        def submit(self, prompt, **kw):
            return prompt

        def stop(self):
            self.stopped = True

    stub = _NoDrainStub()
    r = router_cls([stub])
    with caplog.at_level(logging.WARNING,
                         logger=router_cls.__module__):
        r.stop(drain=True, timeout=0.1)
    assert stub.stopped
    assert any("without drain" in rec.message for rec in caplog.records)
    snap = r.metrics_snapshot()
    assert snap["cloud_server_router_drainless_stops_total"][
        "value"] == 1


@pytest.mark.parametrize("router_cls,_", ROUTERS, ids=ROUTER_IDS)
def test_breaker_open_half_open_close_cycle(router_cls, _):
    class _FlakyStub:
        def __init__(self, preload=0):
            self.fail = False
            self.got = []
            self.num_active = 0
            self._preload = preload

        @property
        def num_pending(self):
            return self._preload

        def submit(self, prompt, **kw):
            if self.fail:
                raise RuntimeError("replica exploded")
            self.got.append(prompt)
            return prompt

    flaky, good = _FlakyStub(), _FlakyStub(preload=1)
    r = router_cls([flaky, good], breaker_threshold=2, breaker_reset_s=0.1)
    flaky.fail = True
    for k in range(2):
        assert r.submit([k]) == [k]
    assert [g for g in good.got] == [[0], [1]]
    states = r.breaker_states()
    assert states[0]["state"] == "open"
    assert states[0]["consecutive_failures"] == 2
    snap = r.metrics_snapshot()
    assert snap["cloud_server_router_submit_failovers_total"][
        "value"] == 2
    assert snap["cloud_server_router_breaker_open_total"]["value"] == 1
    r.submit([2])
    assert good.got[-1] == [2]
    assert r.breaker_states()[0]["consecutive_failures"] == 2
    _time.sleep(0.12)
    assert r.breaker_states()[0]["state"] == "half_open"
    r.submit([3])
    assert good.got[-1] == [3]
    assert r.breaker_states()[0]["state"] == "open"
    _time.sleep(0.12)
    flaky.fail = False
    r.submit([4])
    assert flaky.got == [[4]]
    assert r.breaker_states()[0]["state"] == "closed"
    assert r.breaker_states()[0]["consecutive_failures"] == 0


@pytest.mark.parametrize("router_cls,qfe", ROUTERS, ids=ROUTER_IDS)
def test_half_open_probe_released_on_client_refusal(router_cls, qfe):
    class _Stub:
        def __init__(self, preload=0):
            self.mode = "ok"
            self.got = []
            self.num_active = 0
            self._preload = preload

        @property
        def num_pending(self):
            return self._preload

        def submit(self, prompt, **kw):
            if self.mode == "boom":
                raise RuntimeError("boom")
            if self.mode == "full":
                raise qfe("queue full")
            self.got.append(prompt)
            return prompt

    flaky, good = _Stub(), _Stub(preload=1)
    r = router_cls([flaky, good], breaker_threshold=1,
                   breaker_reset_s=0.05)
    flaky.mode = "boom"
    r.submit([0])
    assert r.breaker_states()[0]["state"] == "open"
    _time.sleep(0.06)
    flaky.mode = "full"
    with pytest.raises(qfe):
        r.submit([1])
    assert r.breaker_states()[0]["state"] == "half_open"
    flaky.mode = "ok"
    r.submit([2])
    assert flaky.got == [[2]]
    assert r.breaker_states()[0]["state"] == "closed"


class _DrainStub:
    def __init__(self):
        self._draining = False
        self.got = []
        self._lock = threading.Lock()
        self.num_active = 0

    @property
    def ready(self):
        return not self._draining

    @property
    def num_pending(self):
        return 0

    def submit(self, prompt, **kw):
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "server is draining; not accepting requests")
            self.got.append(prompt)
        return prompt

    def drain(self, *a, **kw):
        with self._lock:
            self._draining = True
        return True

    def resume(self):
        with self._lock:
            self._draining = False

    def stop(self):
        pass


@pytest.mark.parametrize("router_cls,_", ROUTERS, ids=ROUTER_IDS)
def test_drain_resume_racing_concurrent_submits(router_cls, _):
    r0, r1 = _DrainStub(), _DrainStub()
    router = router_cls([r0, r1])
    errors = []
    done = threading.Event()

    def toggler():
        while not done.is_set():
            r0.drain()
            _time.sleep(0.0005)
            r0.resume()
            _time.sleep(0.0005)

    def submitter(base):
        try:
            for k in range(50):
                router.submit([base + k])
        except Exception as exc:  # noqa: BLE001 — the assertion
            errors.append(exc)

    tog = threading.Thread(target=toggler, daemon=True)
    tog.start()
    subs = [threading.Thread(target=submitter, args=(1000 * i,))
            for i in range(4)]
    for t in subs:
        t.start()
    for t in subs:
        t.join(30)
    done.set()
    tog.join(5)
    assert not any(t.is_alive() for t in subs + [tog])
    assert not errors, f"submits failed through the race: {errors!r}"
    landed = r0.got + r1.got
    assert len(landed) == 200
    assert len({tuple(p) for p in landed}) == 200
    assert r1.got


@pytest.mark.parametrize("router_cls,_", ROUTERS, ids=ROUTER_IDS)
def test_burst_submit_sees_inflight_picks(router_cls, _):
    class _Stub:
        def __init__(self, preload=0):
            self.got = []
            self.gate = threading.Event()
            self.gate.set()
            self.num_active = 0
            self._preload = preload

        @property
        def num_pending(self):
            return len(self.got) + self._preload

        def submit(self, prompt, **kw):
            assert self.gate.wait(10)
            self.got.append(prompt)
            return prompt

    a, b = _Stub(), _Stub(preload=1)
    a.gate.clear()
    router = router_cls([a, b])
    t = threading.Thread(target=lambda: router.submit([1]))
    t.start()
    deadline = _time.time() + 10
    while not any(router._inflight) and _time.time() < deadline:
        _time.sleep(0.001)
    assert router._inflight == [1, 0]
    router.submit([2])
    assert b.got == [[2]]
    a.gate.set()
    t.join(10)
    assert not t.is_alive()
    assert a.got == [[1]]
    assert router._inflight == [0, 0]


# ---------------------------------------------------------------------------
# runtime fleet mutation
# ---------------------------------------------------------------------------


def test_add_remove_replica_live(weights, ref_tokens):
    def mk():
        return PagedInferenceServer(weights[1], TCFG, TGREEDY,
                                    device="cpu", **SRV_KW)

    router = ReplicatedRouter([mk()])
    assert router.attached_indices() == [0]
    i = router.add_replica(mk())
    assert i == 1 and router.attached_indices() == [0, 1]
    reqs = [router.submit(PROMPT, max_new_tokens=6) for _ in range(6)]
    router.step()
    assert all(r.num_active + r.num_pending > 0 for r in router.replicas)
    stop = threading.Event()

    def stepper():
        while not stop.is_set():
            router.step()
            _time.sleep(0.002)

    t = threading.Thread(target=stepper, daemon=True)
    t.start()
    try:
        gone = router.remove_replica(0, migrate=True, timeout=60.0)
        assert gone is not None and gone.num_active == 0
        assert router.attached_indices() == [1]
        assert 0 not in router.breaker_states()
        deadline = _time.monotonic() + 60.0
        while (not all(r.done for r in reqs)
               and _time.monotonic() < deadline):
            _time.sleep(0.01)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    assert all(list(r.tokens) == ref_tokens[:6] for r in reqs), (
        [(len(r.tokens), r.finish_reason) for r in reqs])
    with pytest.raises(RuntimeError):
        router.replicas[0].submit(PROMPT)
    after = router.submit(PROMPT, max_new_tokens=4)
    assert router.add_replica(mk()) == 0
    assert router.attached_indices() == [0, 1]
    router.run_until_idle()
    assert len(after.tokens) == 4
    gone.stop()
    router.stop()


def test_remove_replica_validation(weights):
    srv = PagedInferenceServer(weights[1], TCFG, TGREEDY, device="cpu",
                               **SRV_KW)
    router = ReplicatedRouter([srv])
    with pytest.raises(ValueError):
        router.remove_replica(0)
    with pytest.raises(ValueError):
        router.remove_replica(7)
    with pytest.raises(ValueError):
        router.add_replica(object(), role="chaos")
    router.stop()


@pytest.mark.parametrize("router_cls,_", ROUTERS, ids=ROUTER_IDS)
def test_remove_replica_racing_concurrent_submits(router_cls, _):
    victim, survivor = _DrainStub(), _DrainStub()
    router = router_cls([victim, survivor])
    errors = []
    removed = threading.Event()

    def submitter(base):
        try:
            for k in range(80):
                router.submit([base + k])
                if k == 20 and base == 0:
                    removed.set()
        except Exception as exc:  # noqa: BLE001 — the assertion
            errors.append(exc)

    got = []

    def remover():
        assert removed.wait(30)
        got.append(router.remove_replica(0, migrate=True, timeout=10.0))

    subs = [threading.Thread(target=submitter, args=(1000 * i,))
            for i in range(4)]
    rem = threading.Thread(target=remover)
    for t in subs + [rem]:
        t.start()
    for t in subs + [rem]:
        t.join(30)
    assert not any(t.is_alive() for t in subs + [rem])
    assert got == [victim]
    assert not errors, f"submits refused through removal: {errors!r}"
    landed = victim.got + survivor.got
    assert len(landed) == 320
    assert len({tuple(p) for p in landed}) == 320
    assert router.attached_indices() == [1]
    assert survivor.got
