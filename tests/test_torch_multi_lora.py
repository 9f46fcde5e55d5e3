"""The port's multi-LoRA serving against the reference's (mirroring
tests/test_multi_lora.py case for case, less the MoE base, which is not
ported): per-request adapters in one continuous batch give the
reference server's tokens, each equal to serving the merged weights,
with unadapted batch mates equal to the base model; the same through
every scheduler, speculation, preemption, migration, the prefix cache
and HTTP; the adapter set's rebuild count equal to the reference's.
Then the port's own hazard: captured programs read the stacks by
address, so an add that grows them while a dispatch is in flight
releases that dispatch's program only after its commit."""

import dataclasses
import gc
import json
from urllib import request as urq

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.multi_lora import (
    AdapterSet as RefAdapterSet)
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.models.lora import LoRAConfig as RefLoRAConfig
from cloud_server_tpu.models.lora import init_lora_params as ref_init
from cloud_server_tpu.models.lora import merge_lora as ref_merge
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.multi_lora import AdapterSet
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.models.lora import LoRAConfig
from cloud_server_tpu_torch.models.transformer import params_from_numpy

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(CFG))
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
TGREEDY = TInferConfig(**dataclasses.asdict(GREEDY))
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], [60]]
SCHEDULERS = {"overlap": dict(scheduler="mixed", overlap=True),
              "sequential": dict(scheduler="mixed", overlap=False),
              "alternating": dict(scheduler="alternating")}


def _nonzero_lora(lcfg, seed: int, cfg=CFG) -> dict:
    """The reference test's adapter: random (not zero-init) B, so the
    delta is real."""
    lp = ref_init(cfg, lcfg, jax.random.key(seed))
    keys = jax.random.split(jax.random.key(seed + 100), len(lp["layers"]))
    for key, name in zip(keys, sorted(lp["layers"])):
        b = lp["layers"][name]["b"]
        lp["layers"][name]["b"] = 0.3 * jax.random.normal(key, b.shape,
                                                          b.dtype)
    return lp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_lcfg(lcfg):
    return LoRAConfig(**dataclasses.asdict(lcfg))


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and this module's leave about 12
    thousand; a test worker that runs it and other reference-heavy
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(_np(ref), TCFG, device="cpu")


@pytest.fixture(scope="module")
def adapters():
    a_cfg = RefLoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    b_cfg = RefLoRAConfig(rank=2, alpha=4.0,
                          targets=("wo", "w_gate", "w_down"))
    return ((_nonzero_lora(a_cfg, 1), a_cfg),
            (_nonzero_lora(b_cfg, 2), b_cfg))


def _ref(weights, **kw):
    return RefServer(weights[0], CFG, GREEDY, **{**SRV_KW, **kw})


def _port(weights, **kw):
    return PagedInferenceServer(weights[1], TCFG, TGREEDY, device="cpu",
                                **{**SRV_KW, **kw})


def _add(srv, name, lp, lcfg):
    """Register on either server: the port takes numpy arrays."""
    if isinstance(srv, PagedInferenceServer):
        return srv.add_adapter(name, _np(lp), _port_lcfg(lcfg))
    return srv.add_adapter(name, lp, lcfg)


def _merged_ref(weights, lp, lcfg, prompt, n_new):
    merged = ref_merge(weights[0], lp, lcfg)
    return RefServer(merged, CFG, GREEDY, **SRV_KW).generate(
        [prompt], max_new_tokens=n_new)[0]


@pytest.fixture(scope="module")
def merged_tokens(weights, adapters):
    """Merged-weight references: adapter a and b on PROMPTS[0..2]."""
    (lp_a, cfg_a), (lp_b, cfg_b) = adapters
    return {(name, i): _merged_ref(weights, lp, lcfg, PROMPTS[i], 8)
            for name, lp, lcfg in (("a", lp_a, cfg_a), ("b", lp_b, cfg_b))
            for i in range(3)}


@pytest.fixture(scope="module")
def base_tokens(weights):
    return _ref(weights).generate(PROMPTS, max_new_tokens=8)


def test_adapter_matches_merged(weights, adapters, merged_tokens,
                                base_tokens):
    """Each adapter, served per-request, equals its merged model (and
    the reference's per-request serving); the delta is real."""
    (lp_a, cfg_a), (lp_b, cfg_b) = adapters
    srv = _port(weights)
    assert _add(srv, "a", lp_a, cfg_a) == 1
    assert _add(srv, "b", lp_b, cfg_b) == 2
    for name in ("a", "b"):
        out = srv.submit(PROMPTS[0], max_new_tokens=8, adapter=name)
        srv.run_until_idle()
        assert out.result() == merged_tokens[(name, 0)], name
        assert out.result() != base_tokens[0]


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_mixed_batch_base_and_two_adapters(weights, adapters, merged_tokens,
                                           base_tokens, sched):
    """One continuous batch: base + adapter a + adapter b (different
    ranks and targets), each exactly its own reference, under every
    scheduler; the reference server's tokens under the same one."""
    (lp_a, cfg_a), (lp_b, cfg_b) = adapters
    outs = []
    for srv in (_ref(weights, **SCHEDULERS[sched]),
                _port(weights, **SCHEDULERS[sched])):
        _add(srv, "a", lp_a, cfg_a)
        _add(srv, "b", lp_b, cfg_b)
        reqs = [srv.submit(PROMPTS[0], max_new_tokens=8),
                srv.submit(PROMPTS[1], max_new_tokens=8, adapter="a"),
                srv.submit(PROMPTS[2], max_new_tokens=8, adapter="b")]
        srv.run_until_idle()
        outs.append([r.result() for r in reqs])
    want, got = outs
    assert got == want
    assert got == [base_tokens[0], merged_tokens[("a", 1)],
                   merged_tokens[("b", 2)]]


@pytest.mark.parametrize("draft", ["ngram", "draft_model"])
def test_adapter_through_speculation(weights, adapters, draft):
    """Greedy adapter serving is identical with in-server speculation
    (the verify pass runs the adapted model; the draft model serves
    unadapted), as in the reference."""
    (lp_a, cfg_a), _ = adapters
    kw = dict(spec_drafts=2)
    if draft == "draft_model":
        kw_ref = dict(kw, draft_params=weights[0], draft_cfg=CFG)
        kw_port = dict(kw, draft_params=weights[1], draft_cfg=TCFG)
    else:
        kw_ref = kw_port = kw
    outs = []
    for srv in (_ref(weights, **kw_ref), _port(weights, **kw_port),
                _port(weights)):
        _add(srv, "a", lp_a, cfg_a)
        x = srv.submit(PROMPTS[1], max_new_tokens=10, adapter="a")
        y = srv.submit(PROMPTS[0], max_new_tokens=10)
        srv.run_until_idle()
        outs.append((x.result(), y.result()))
    assert outs[1] == outs[0] == outs[2]


def test_adapter_survives_preemption(weights, adapters):
    """Preemption requeues an adapted request as a continuation: its
    tokens, and the preemption count, equal the reference's."""
    (lp_a, cfg_a), _ = adapters
    want = _merged_ref(weights, lp_a, cfg_a, PROMPTS[1], 10)
    runs = []
    for srv in (_ref(weights, num_pages=7), _port(weights, num_pages=7)):
        _add(srv, "a", lp_a, cfg_a)
        r = srv.submit(PROMPTS[1], max_new_tokens=10, adapter="a")
        crowd = [srv.submit(list(range(1, 14)), max_new_tokens=10)
                 for _ in range(2)]
        srv.run_until_idle()
        runs.append((r.result(), [c.result() for c in crowd],
                     srv.preemptions))
    assert runs[1] == runs[0]
    assert runs[1][0] == want
    assert runs[1][2] > 0


def test_adapter_validation(weights, adapters):
    """An unknown adapter is the client's ValueError at submit (as in the
    reference); a duplicate name, a non-dense target and missing targets
    are refused at registration."""
    (lp_a, cfg_a), _ = adapters
    srv = _port(weights)
    with pytest.raises(ValueError, match="unknown adapter"):
        srv.submit(PROMPTS[0], adapter="nope")
    _add(srv, "a", lp_a, cfg_a)
    with pytest.raises(ValueError, match="already registered"):
        _add(srv, "a", lp_a, cfg_a)
    with pytest.raises(ValueError, match="dense targets only"):
        srv.add_adapter("r", {"layers": {}},
                        LoRAConfig(rank=2, targets=("router",)))
    with pytest.raises(ValueError, match="missing params"):
        srv.add_adapter("m", {"layers": {}}, LoRAConfig(rank=2))
    assert srv.adapters.names == ["a"]


def test_adapter_over_http(weights):
    """OpenAI routing: model=<adapter name> selects the adapter;
    /v1/models lists base + adapters; the adapted completion's tokens
    equal the reference server's."""
    cfg = dataclasses.replace(CFG, vocab_size=300)
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    big = ref_transformer.init_params(cfg, jax.random.key(0))
    lcfg = RefLoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    lp = _nonzero_lora(lcfg, 1, cfg)
    prompt = ByteTokenizer().encode("ab")  # the token list sent
    ref = RefServer(big, cfg, GREEDY, **SRV_KW)
    ref.add_adapter("tuned", lp, lcfg)
    want = {}
    for model, kw in (("tuned", {"adapter": "tuned"}),
                      ("cloud-server-tpu", {})):
        r = ref.submit(prompt, max_new_tokens=6, **kw)
        ref.run_until_idle()
        want[model] = r.result()
    srv = PagedInferenceServer(params_from_numpy(_np(big), tcfg,
                                                 device="cpu"),
                               tcfg, TGREEDY, device="cpu",
                               **SRV_KW).start()
    srv.add_adapter("tuned", _np(lp), _port_lcfg(lcfg))
    front = HttpFrontend(srv, tokenizer=ByteTokenizer()).start()
    try:
        host, port = front.address
        with urq.urlopen(f"http://{host}:{port}/v1/models",
                         timeout=30) as resp:
            ids = [m["id"] for m in json.loads(resp.read())["data"]]
        assert "tuned" in ids and "cloud-server-tpu" in ids
        for model in ("tuned", "cloud-server-tpu"):
            body = json.dumps({"prompt": prompt, "max_tokens": 6,
                               "model": model}).encode()
            with urq.urlopen(urq.Request(
                    f"http://{host}:{port}/v1/completions", data=body),
                    timeout=120) as resp:
                out = json.loads(resp.read())["choices"][0]
            assert out["text"] == ByteTokenizer().decode(want[model]), \
                model
        assert want["tuned"] != want["cloud-server-tpu"]
    finally:
        front.stop()
        srv.stop()


def test_prefix_cache_isolated_per_adapter(weights, adapters):
    """The radix prefix cache never serves base KV to an adapter request
    (or back): identical full-page prompts under different adapters take
    per-namespace chains; same-adapter reuse still hits."""
    (lp_a, cfg_a), _ = adapters
    prompt = list(range(1, 20))  # > 2 full 8-token pages
    runs = []
    for srv in (_ref(weights), _port(weights)):
        _add(srv, "a", lp_a, cfg_a)
        outs = []
        for kw in ({}, {"adapter": "a"}, {}, {"adapter": "a"}):
            hits0 = srv.allocator.prefix_hit_pages
            r = srv.submit(prompt, max_new_tokens=8, **kw)
            srv.run_until_idle()
            outs.append((r.result(), srv.allocator.prefix_hit_pages - hits0))
        runs.append(outs)
    assert runs[1] == runs[0]
    toks = [t for t, _ in runs[1]]
    assert toks[0] == toks[2] != toks[1] == toks[3]
    assert toks[1] == _merged_ref(weights, lp_a, cfg_a, prompt, 8)
    assert runs[1][3][1] > 0  # the adapter's second request hit its chain


def test_bad_shape_adapter_rejected_cleanly(weights, adapters):
    """A shape-mismatched adapter does not half-register, and the
    registry still works after it."""
    (lp_a, cfg_a), _ = adapters
    srv = _port(weights)
    bad = {"layers": {t: {"a": np.zeros((2, 7, 4), np.float32),
                          "b": np.zeros((2, 4, 5), np.float32)}
                      for t in cfg_a.targets}}
    with pytest.raises(ValueError, match="do not match"):
        srv.add_adapter("bad", bad, _port_lcfg(cfg_a))
    assert srv.adapters.adapter_id("bad") is None
    with pytest.raises(ValueError):
        srv.submit(PROMPTS[0], adapter="bad")
    _add(srv, "a", lp_a, cfg_a)
    r = srv.submit(PROMPTS[0], max_new_tokens=6, adapter="a")
    srv.run_until_idle()
    assert r.result() == _merged_ref(weights, lp_a, cfg_a, PROMPTS[0], 6)


def test_incremental_add_amortized():
    """add() restacks only on capacity or rank exhaustion, exactly when
    the reference's does (an unseen target zero-stacks without a
    rebuild); each restack or new target advances the generation the
    server keys its programs by."""
    ref, port = RefAdapterSet(CFG), AdapterSet(TCFG)
    steps = [(f"ad{i}", RefLoRAConfig(rank=2, alpha=4.0, targets=("wq",)),
              10 + i) for i in range(5)]
    steps += [("wo_ad", RefLoRAConfig(rank=2, alpha=4.0, targets=("wo",)),
               99),
              ("big", RefLoRAConfig(rank=8, alpha=16.0, targets=("wq",)),
               123)]
    rebuilds, gens = [], []
    for name, lcfg, seed in steps:
        lp = _nonzero_lora(lcfg, seed)
        assert port.add(name, _np(lp), _port_lcfg(lcfg)) == ref.add(
            name, lp, lcfg)
        assert port.rebuilds == ref.rebuilds
        rebuilds.append(port.rebuilds)
        gens.append(port.generation)
    assert rebuilds == [1, 1, 1, 2, 2, 2, 3]
    assert gens == [1, 1, 1, 2, 2, 3, 4]
    stacks, scales = port.device_args()
    rstacks, rscales = ref.device_args()
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    for t in rstacks:
        for part in ("a", "b"):
            np.testing.assert_array_equal(stacks[t][part].numpy(),
                                          np.asarray(rstacks[t][part]))
    assert port.nbytes() == sum(
        x.nbytes for ab in rstacks.values() for x in ab.values()) + \
        np.asarray(rscales).nbytes


def test_many_adapters_each_matches_merged(weights):
    """Across the grow and in-place paths (5 adapters spanning both
    growth boundaries): every one serves the reference's tokens, its
    merged model's, and the server's rebuild count is the reference's."""
    srvs = (_ref(weights), _port(weights))
    regs = []
    for i in range(5):
        lcfg = RefLoRAConfig(rank=2 if i % 2 else 4, alpha=4.0,
                             targets=("wq", "wv") if i % 2 else ("wo",))
        lp = _nonzero_lora(lcfg, 50 + i)
        for srv in srvs:
            _add(srv, f"m{i}", lp, lcfg)
        regs.append((f"m{i}", lp, lcfg))
    assert srvs[1].adapters.rebuilds == srvs[0].adapters.rebuilds
    for name, lp, lcfg in regs:
        outs = []
        for srv in srvs:
            out = srv.submit(PROMPTS[1], max_new_tokens=6, adapter=name)
            srv.run_until_idle()
            outs.append(out.result())
        assert outs[1] == outs[0] == _merged_ref(weights, lp, lcfg,
                                                 PROMPTS[1], 6), name


def test_adapter_migrates_with_its_request(weights, adapters):
    """A drained adapted request resumes on the destination under the
    same adapter (the snapshot's `adapter`), its pages keyed in that
    adapter's namespace: the stream equals an uninterrupted run."""
    (lp_a, cfg_a), _ = adapters
    want = _merged_ref(weights, lp_a, cfg_a, PROMPTS[1], 16)
    src, dst = _port(weights, overlap=False), _port(weights, overlap=False)
    for srv in (src, dst):
        _add(srv, "a", lp_a, cfg_a)
    r = src.submit(PROMPTS[1], max_new_tokens=16, adapter="a")
    while len(r.tokens) < 5:
        src.step()
    snap = src.migrate_export(r, reason="drain")
    assert snap.adapter == "a"
    moved = dst.migrate_import(snap)
    assert moved.adapter == "a"
    dst.run_until_idle()
    assert moved.result() == want


def test_growing_add_under_overlap_mid_decode(weights, adapters):
    """The port's hazard: captured programs read the stacks by address.
    Under the overlap pipeline, with an adapted request mid-decode (its
    dispatch in flight), a third adapter whose rank outgrows the stacks
    restacks them: the in-flight program is released only after its
    commit has waited on it, and every stream equals the reference
    server's run of the same calls."""
    (lp_a, cfg_a), (lp_b, cfg_b) = adapters
    big_cfg = RefLoRAConfig(rank=8, alpha=8.0, targets=("wq", "w_up"))
    lp_big = _nonzero_lora(big_cfg, 7)
    runs = []
    for srv in (_ref(weights, overlap=True), _port(weights, overlap=True)):
        _add(srv, "a", lp_a, cfg_a)
        _add(srv, "b", lp_b, cfg_b)
        reqs = [srv.submit(PROMPTS[1], max_new_tokens=32, adapter="a"),
                srv.submit(PROMPTS[0], max_new_tokens=32)]
        for _ in range(2):
            srv.step()
        if isinstance(srv, PagedInferenceServer):
            assert srv._inflight is not None
            dropped = srv._programs.dropped_in_flight
        rebuilds = srv.adapters.rebuilds
        _add(srv, "big", lp_big, big_cfg)
        assert srv.adapters.rebuilds == rebuilds + 1
        if isinstance(srv, PagedInferenceServer):
            assert srv._programs.dropped_in_flight == dropped + 1
            assert srv._retired  # kept until the next commit
            srv.step()
            assert not srv._retired
        reqs.append(srv.submit(PROMPTS[2], max_new_tokens=8,
                               adapter="big"))
        reqs.append(srv.submit(PROMPTS[2], max_new_tokens=8, adapter="b"))
        srv.run_until_idle()
        runs.append([r.result() for r in reqs])
    assert runs[1] == runs[0]
    assert runs[1][2] == _merged_ref(weights, lp_big, big_cfg,
                                     PROMPTS[2], 8)


def test_drop_of_every_captured_program_takes_a_fresh_pool():
    """`ProgramCache.drop` that leaves no captured graph behind forgets
    the graph pool (the allocator refuses a pool whose graphs were all
    reset), while one that leaves a captured program keeps it; the
    program in flight is handed back unreleased either way."""
    from cloud_server_tpu_torch.inference import graphs

    class _Prog:
        def __init__(self):
            self.graph = object()
            self.released = False

        def release(self):
            self.graph, self.released = None, True

    for keep_one in (False, True):
        cache = graphs.ProgramCache("cpu")
        cache._pool = pool = ("pool", 1)
        progs = {("lora", i): _Prog() for i in range(3)}
        if keep_one:
            progs[("plain", 0)] = _Prog()
        cache._programs.update(progs)
        busy = progs[("lora", 1)]
        kept = cache.drop(lambda k: k[0] == "lora", busy)
        assert kept == [busy] and not busy.released
        assert all(progs[("lora", i)].released for i in (0, 2))
        assert cache.dropped == 3 and cache.dropped_in_flight == 1
        assert cache._pool == (pool if keep_one else None)
