"""The port's copy of the grammar module against the reference's: the
byte DFAs and the token tables lifted against the byte tokenizer are
equal array for array over the patterns of tests/test_grammar.py,
`json_object_regex` and two `json_schema_regex` schemas; the regex and
schema builders give the same patterns and refuse the same inputs; and
the port's server constrains a generation to its pattern, the
reference's tokens on the same weights."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.data.tokenizer import ByteTokenizer as RefTok
from cloud_server_tpu.inference import grammar as ref_grammar
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference import grammar
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

VOCAB = 300
PATTERNS = [
    r"[0-9]+", r"-?[0-9]+(\.[0-9]+)?", r"(abc|de)*f", r"a{2,4}", r"a{3}",
    r"a{2,}", r"\w+@\w+\.(com|org)", r"[^x]+", r"(yes|no)",
    r'"[a-z ]*"', r"\d{4}-\d{2}-\d{2}", r"(?:ab)+", r"x?y?z?",
    r"[\x41-\x43]+",
]
ADDRESS_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"},
                 "maxItems": 3},
        "kind": {"enum": ["a", "b", 3]},
        "nested": {"type": "object",
                   "properties": {"ok": {"type": "boolean"}},
                   "required": ["ok"]},
    },
    "required": ["name", "age", "kind", "nested"],
}
OPTIONAL_SCHEMA = {"type": "object",
                   "properties": {"a": {"type": "integer"},
                                  "b": {"anyOf": [{"type": "integer"},
                                                  {"type": "null"}]},
                                  "c": {"type": "string", "maxLength": 4}},
                   "required": ["b"]}
ALL_PATTERNS = PATTERNS + [
    ref_grammar.json_object_regex(), ref_grammar.json_object_regex(2),
    ref_grammar.json_schema_regex(ADDRESS_SCHEMA),
    ref_grammar.json_schema_regex(OPTIONAL_SCHEMA)]
IDS = [f"p{i}" for i in range(len(PATTERNS))] + [
    "json_object", "json_object_depth2", "schema_address",
    "schema_optional"]


def test_regex_builders_match():
    assert grammar.json_object_regex() == ref_grammar.json_object_regex()
    assert grammar.json_object_regex(2) == ref_grammar.json_object_regex(2)
    for schema in (ADDRESS_SCHEMA, OPTIONAL_SCHEMA):
        assert grammar.json_schema_regex(schema) == \
            ref_grammar.json_schema_regex(schema)
    for bad in ({"type": "integer", "minimum": 3},
                {"type": "object", "properties": {}, "required": ["x"]}):
        with pytest.raises(ValueError):
            grammar.json_schema_regex(bad)
        with pytest.raises(ValueError):
            ref_grammar.json_schema_regex(bad)
    for pat in ["(", "a{3,2}", "[z-a]", "a{", "*a", "[]"]:
        with pytest.raises(ValueError):
            grammar.compile_byte_dfa(pat)


@pytest.mark.parametrize("pattern", ALL_PATTERNS, ids=IDS)
def test_dfa_tables_equal_the_reference(pattern):
    want_b = ref_grammar.compile_byte_dfa(pattern)
    got_b = grammar.compile_byte_dfa(pattern)
    assert np.array_equal(got_b.trans, want_b.trans)
    assert np.array_equal(got_b.accept, want_b.accept)
    tb_ref = ref_grammar.token_bytes(RefTok(), VOCAB)
    tb = grammar.token_bytes(ByteTokenizer(), VOCAB)
    assert tb == tb_ref
    want = ref_grammar.compile_token_dfa(pattern, tb_ref)
    got = grammar.compile_token_dfa(pattern, tb)
    assert got.next_state.dtype == want.next_state.dtype
    assert np.array_equal(got.next_state, want.next_state)
    assert np.array_equal(got.accept, want.accept)
    cache = grammar.GrammarCache(ByteTokenizer(), VOCAB)
    assert np.array_equal(cache.get(pattern).next_state, want.next_state)
    assert got.walk(list(b"12")) == want.walk(list(b"12"))


CFG = ModelConfig(
    vocab_size=VOCAB, embed_dim=32, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=256,
    dtype="float32", param_dtype="float32", remat="none")
TOK = ByteTokenizer()
ICFG = InferConfig(max_decode_len=16, temperature=0.0,
                   eos_token_id=TOK.eos_id, pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=128, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref),
                                  TModelConfig(**dataclasses.asdict(CFG)),
                                  device="cpu")


@pytest.mark.parametrize("pattern,spec", [
    (r"-?[0-9]+(\.[0-9]+)?", 0), (r"(yes|no)", 2),
    (grammar.json_schema_regex(OPTIONAL_SCHEMA), 2)],
    ids=["number", "yes_no_spec", "schema_spec"])
def test_constrained_generation_matches_the_reference(weights, pattern,
                                                      spec):
    """Every emitted prefix is live in the DFA, a finished output is
    accepted, and the tokens are the reference server's."""
    prompt = TOK.encode("answer:")
    ref = RefServer(weights[0], CFG, ICFG, overlap=False, spec_drafts=spec,
                    tokenizer=RefTok(), **SRV_KW)
    want = ref.submit(prompt, max_new_tokens=16,
                      sampling=RefSamplingParams(regex=pattern))
    ref.run_until_idle()
    srv = PagedInferenceServer(
        weights[1], TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(ICFG)), device="cpu",
        spec_drafts=spec, tokenizer=TOK, **SRV_KW)
    got = srv.submit(prompt, max_new_tokens=16,
                     sampling=SamplingParams(regex=pattern))
    srv.run_until_idle()
    assert got.result() == want.result()
    dfa = grammar.GrammarCache(TOK, VOCAB).get(pattern)
    toks = [t for t in got.result() if t != TOK.eos_id]
    st = 0
    for t in toks:
        st = dfa.walk([t], st)
        assert st != grammar.DEAD
    if got.finish_reason == "eos":
        assert dfa.accept[st]


def test_bad_regex_and_missing_tokenizer_refused(weights):
    srv = PagedInferenceServer(
        weights[1], TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(ICFG)), device="cpu", **SRV_KW)
    with pytest.raises(ValueError, match="tokenizer"):
        srv.submit([1, 2], sampling=SamplingParams(regex="[0-9]+"))
    srv = PagedInferenceServer(
        weights[1], TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(ICFG)), device="cpu",
        tokenizer=TOK, **SRV_KW)
    with pytest.raises(ValueError):
        srv.submit([1, 2], sampling=SamplingParams(regex="a{3,2}"))
    assert srv.num_pending == 0
