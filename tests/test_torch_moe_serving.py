"""MoE models served (the serving half of tests/test_torch_moe.py, whose
weights and helpers it shares, in a file of its own so that `--dist
loadfile` spreads the module over workers): the paged server against
the reference's with and without drops, under n-gram speculation and
against plain decoding, the contiguous server, speculative_generate
with an MoE draft, and attention adapters on an MoE base."""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402,F401
    CFG, FACTORS, GREEDY, InferenceServer, LoRAConfig, PROMPTS,
    PagedInferenceServer, RefLoRAConfig, RefPaged, RefServer, SRV_KW,
    _attention_adapter, _cfg, _port_engine, _staggered, _tc, _ti, engine,
    moe_draft, paged_reference, prng, speculative, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("kind", list(FACTORS))
def test_contiguous_server_matches_reference(weights, kind):
    """The contiguous server on an MoE model: the reference server's
    tokens under the same schedule (capacity contended over the same
    bucketed rows), and dropless also each prompt's engine tokens."""
    ref, port = weights
    cfg = _cfg(FACTORS[kind])
    kw = dict(max_slots=2, max_len=64, prompt_buckets=[16, 32])
    want = _staggered(RefServer(ref, cfg, GREEDY, **kw))
    got = _staggered(InferenceServer(port, _tc(cfg), _ti(), device="cpu",
                                     **kw))
    assert got == want


@pytest.mark.parametrize("kind", list(FACTORS))
def test_paged_server_matches_reference(weights, paged_reference, kind):
    """The paged server (mixed scheduler, overlap pipeline) routes each
    window_forward's (B, W) rows as the reference's programs do: its
    tokens equal the reference server's, with drops too; dropless they
    also equal each prompt's engine tokens."""
    _, port = weights
    cfg = _cfg(FACTORS[kind])
    srv = PagedInferenceServer(port, _tc(cfg), _ti(), device="cpu",
                               **SRV_KW)
    got = _staggered(srv)
    assert got == paged_reference[kind]
    if kind == "dropless":
        for prompt, out in zip(PROMPTS, got):
            assert out == _port_engine(port, cfg, prompt, 8), prompt


@pytest.mark.parametrize("draft", ["ngram", "moe_draft"])
def test_paged_speculation_matches_plain(weights, paged_reference,
                                         moe_draft, draft):
    """In-server speculation on an MoE target (n-gram drafts, or an MoE
    draft model on its own pools) gives the plain greedy tokens."""
    _, port = weights
    kw = {}
    if draft == "moe_draft":
        kw = dict(draft_params=moe_draft[1], draft_cfg=_tc(moe_draft[2]))
    srv = PagedInferenceServer(port, _tc(CFG), _ti(), device="cpu",
                               spec_drafts=2, **kw, **SRV_KW)
    assert _staggered(srv) == paged_reference["dropless"]


def test_paged_ngram_speculation_under_drops_matches_reference(weights):
    """Under capacity drops (factor 1.25) speculation changes which rows
    contend for expert slots, so the reference's speculative tokens
    differ from its plain ones: the port's n-gram speculative server
    (spec_drafts=2, mixed scheduler, greedy) gives the reference's
    speculative server's tokens. Rows with sentinel tables (padding and
    inert rows) read the last real page, as the reference's gather does,
    not the scratch page."""
    ref, port = weights
    cfg = _cfg(FACTORS["drops"])
    want = _staggered(RefPaged(ref, cfg, GREEDY, overlap=False,
                               spec_drafts=2, **SRV_KW))
    srv = PagedInferenceServer(port, _tc(cfg), _ti(), device="cpu",
                               spec_drafts=2, **SRV_KW)
    assert _staggered(srv) == want


def test_speculative_generate_with_moe_draft(weights, moe_draft):
    """The batch API with an MoE target and an MoE draft gives plain
    greedy generation's tokens (the engine's, held to the reference's
    above)."""
    _, port = weights
    _, pdraft, dcfg = moe_draft
    prompt = torch.tensor([[5, 9, 3, 7], [17, 2, 40, 8]])
    icfg = _ti(dataclasses.replace(GREEDY, max_decode_len=10))
    got = speculative.speculative_generate(
        port, pdraft, prompt, prng.key(0), cfg=_tc(CFG),
        draft_cfg=_tc(dcfg), infer_cfg=icfg, num_draft=3)
    plain = engine.generate(port, prompt, prng.key(0), cfg=_tc(CFG),
                            infer_cfg=icfg)
    assert got.tolist() == plain.tolist()


def test_attention_adapters_on_moe_base(weights, paged_reference):
    """Attention-target adapters serve per request on an MoE base: base
    rows give the plain tokens, adapted rows the reference server's."""
    ref, port = weights
    lp = _attention_adapter(4)

    def run(srv, lcfg):
        srv.add_adapter("att", lp, lcfg)
        base = srv.submit(PROMPTS[0], max_new_tokens=6)
        adapted = srv.submit(PROMPTS[0], max_new_tokens=6, adapter="att")
        srv.run_until_idle()
        return base.result(), adapted.result()

    want = run(RefPaged(ref, CFG, GREEDY, overlap=False, **SRV_KW),
               RefLoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv")))
    got = run(PagedInferenceServer(port, _tc(CFG), _ti(), device="cpu",
                                   **SRV_KW),
              LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv")))
    assert got == want
    assert got[0] == paged_reference["dropless"][0][:6]
    assert got[1] != got[0]  # the adapter bites
