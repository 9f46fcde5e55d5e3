"""The port's page allocator (a copy of the reference's): the core cases
of tests/test_block_allocator.py run against it, and a seeded random
trace of alloc / lookup / release gives the same results and stats as
the reference allocator."""

import dataclasses

import numpy as np
import pytest

from cloud_server_tpu.inference.block_allocator import (
    BlockAllocator as RefAllocator)
from cloud_server_tpu_torch.inference.block_allocator import BlockAllocator


def toks(n, base=0):
    return [base + i for i in range(n)]


def test_alloc_release_roundtrip():
    a = BlockAllocator(4, page_size=4)
    pages = a.alloc(3)
    assert len(pages) == 3 and len(set(pages)) == 3
    assert a.available == 1
    a.release(pages, toks(9))
    st = a.stats()
    assert st.pages_free + st.pages_cached == 4
    assert st.pages_cached == 2


def test_alloc_insufficient_is_side_effect_free():
    a = BlockAllocator(2, page_size=4)
    assert a.alloc(3) is None
    assert a.available == 2
    assert a.alloc(2) is not None


def test_prefix_hits_after_release_and_boundary():
    a = BlockAllocator(8, page_size=4)
    prompt = toks(11)
    assert a.lookup_prefix(prompt) == ([], 0)
    pages = a.alloc(3)
    a.release(pages, prompt)
    shared, n = a.lookup_prefix(prompt)
    assert shared == pages[:2] and n == 8
    assert a.stats().pages_active == 2
    a.release(shared, prompt[:8])
    # a prompt of exactly N full pages shares at most N-1
    shared, n = a.lookup_prefix(toks(8))
    assert len(shared) == 1 and n == 4
    a.release(shared, toks(4))


def test_concurrent_sharing_refcounts():
    a = BlockAllocator(8, page_size=2)
    prompt = toks(5)
    a.release(a.alloc(3), prompt)
    s1, _ = a.lookup_prefix(prompt)
    s2, _ = a.lookup_prefix(prompt)
    assert s1 == s2 and len(s1) == 2
    a.release(s1, prompt[:4])
    assert a.stats().pages_active == 2
    a.release(s2, prompt[:4])
    assert a.stats().pages_active == 0 and a.stats().pages_cached == 2


def test_eviction_lru_under_pressure():
    a = BlockAllocator(4, page_size=2)
    a.release(a.alloc(2), toks(4, base=0))
    a.release(a.alloc(2), toks(4, base=100))
    got = a.alloc(2)
    assert got is not None and a.evictions == 2
    shared, _ = a.lookup_prefix(toks(5, base=100))
    assert len(shared) == 2
    a.release(shared, toks(4, base=100))
    a.release(got, [])


def test_chain_keys_are_content_keys():
    a = BlockAllocator(2, page_size=2)
    p = a.alloc(2)
    a.release(p, [1, 2, 3, 4])
    assert a.lookup_prefix([9, 9, 3, 4, 5]) == ([], 0)
    q = a.alloc(1)
    assert q == [p[0]] and a.evictions == 1
    a.release(q, [9, 9])
    shared, n = a.lookup_prefix([9, 9, 3, 4, 5])
    assert shared == [p[0]] and n == 2
    a.release(shared, [9, 9])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_trace_matches_reference(seed):
    """The same operations on both allocators give the same pages, hits
    and statistics at every step."""
    rng = np.random.default_rng(seed)
    ref, port = RefAllocator(12, page_size=3), BlockAllocator(12, 3)
    held = []  # (pages, tokens) owned by the trace
    bases = [0, 50, 100]
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            prompt = toks(int(rng.integers(1, 14)),
                          base=int(rng.choice(bases)))
            got_r, got_p = ref.lookup_prefix(prompt), port.lookup_prefix(
                prompt)
            assert got_r == got_p
            shared, n = got_p
            need = -(-len(prompt) // 3) - len(shared)
            fresh_r, fresh_p = ref.alloc(need), port.alloc(need)
            assert fresh_r == fresh_p
            if fresh_p is None:
                ref.release(shared, prompt[:n])
                port.release(shared, prompt[:n])
            else:
                held.append((shared + fresh_p, prompt))
        else:
            pages, prompt = held.pop(int(rng.integers(0, len(held))))
            keep = prompt[:int(rng.integers(0, len(prompt) + 1))]
            ref.release(pages, keep)
            port.release(pages, keep)
        assert dataclasses.asdict(ref.stats()) == dataclasses.asdict(
            port.stats())
        assert ref.available == port.available
