"""Regex-constrained decoding: host-side compilation to a token-level
DFA, consumed device-side with zero per-token host sync.

A copy of the reference's `inference/grammar.py` (stdlib and numpy
only), so the port imports nothing of the JAX package. The design (cf.
the Outlines/vLLM FSM approach):

  1. A regex over BYTES compiles to a DFA (Thompson NFA -> subset
     construction, byte-class alphabet compression).
  2. The DFA lifts to TOKEN granularity against the serving tokenizer:
     `next_state[s, t]` = the DFA state after consuming token t's UTF-8
     bytes from state s (DEAD when any byte dies). One (S, V) int32
     table + an (S,) accept vector per pattern, built once and cached.
  3. The server keeps a REGISTRY of active patterns stacked into one
     (G, S_max, V) device table. Each constrained slot carries a
     grammar id and a current DFA state; every decode dispatch gathers
     its (B, V) allowed mask from the stack, masks the logits ahead of
     the sampling filter chain, and advances the states with the
     sampled tokens — all inside the captured program. EOS is allowed
     exactly in accepting states, so generation can only end on a
     complete match.

Supported syntax: literals, `.`, escapes (\\d \\w \\s \\n \\t \\r and
escaped metachars), character classes `[a-z0-9_]` (ranges, negation),
grouping `(...)`, alternation `|`, quantifiers `* + ?` and bounded
`{m}` / `{m,}` / `{m,n}`. Patterns are anchored (the whole generation
must match). Multi-byte UTF-8 literals work byte-by-byte; `.` matches
any single byte except newline (byte semantics — document for users).

Token byte mapping: exact for the framework's ByteTokenizer; for HF
fast tokenizers the per-token string is recovered via `id_to_token`
with the GPT-2 byte-level alphabet / sentencepiece markers decoded.
Ids the tokenizer cannot spell (specials, out-of-tokenizer padding of
the model vocab) are never allowed inside a constrained generation.
"""

from __future__ import annotations

import functools
import re as _pyre
from typing import Sequence

import numpy as np

MAX_DFA_STATES = 2048  # compilation fails loudly past this; the token
#                        table is (S, V) int32, so device memory is
#                        S * vocab * 4 bytes — see compile_token_dfa's
#                        byte guard
MAX_TABLE_BYTES = 256 << 20  # refuse token tables past 256 MB
DEAD = -1


# ---------------------------------------------------------------------------
# regex parsing -> NFA (Thompson construction over byte sets)
# ---------------------------------------------------------------------------


class _Frag:
    """NFA fragment: start state + list of dangling (state, key) arrows
    to patch. NFA: dict state -> list of (byteset | None, target);
    None = epsilon."""

    __slots__ = ("start", "outs")

    def __init__(self, start, outs):
        self.start = start
        self.outs = outs


_DIGIT = frozenset(range(0x30, 0x3A))
_WORD = frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
                  + list(range(0x61, 0x7B)) + [0x5F])
_SPACE = frozenset(b" \t\n\r\x0b\x0c")
_ANY = frozenset(set(range(256)) - {0x0A})  # '.' (no newline)


class _Parser:
    """Recursive-descent regex -> NFA."""

    def __init__(self, pattern: str):
        self.src = pattern.encode("utf-8")
        self.i = 0
        self.nfa: list[list] = []  # state -> [(byteset|None, target)]

    def _new_state(self) -> int:
        self.nfa.append([])
        return len(self.nfa) - 1

    def _peek(self):
        return self.src[self.i] if self.i < len(self.src) else None

    def _eat(self):
        b = self.src[self.i]
        self.i += 1
        return b

    # grammar: alt := concat ('|' concat)* ; concat := repeat* ;
    # repeat := atom ('*'|'+'|'?'|'{m,n}')* ; atom := literal | class |
    # '(' alt ')' | '.' | escape
    def parse(self) -> _Frag:
        frag = self._alt()
        if self.i != len(self.src):
            raise ValueError(
                f"regex: unexpected {chr(self._peek())!r} at byte {self.i}")
        return frag

    def _alt(self) -> _Frag:
        frags = [self._concat()]
        while self._peek() == 0x7C:  # '|'
            self._eat()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        start = self._new_state()
        outs = []
        for f in frags:
            self.nfa[start].append((None, f.start))
            outs.extend(f.outs)
        return _Frag(start, outs)

    def _concat(self) -> _Frag:
        frags = []
        while self._peek() is not None and self._peek() not in (0x7C, 0x29):
            frags.append(self._repeat())
        if not frags:
            s = self._new_state()
            return _Frag(s, [(s, None)])  # empty: dangling epsilon-ish
        cur = frags[0]
        for nxt in frags[1:]:
            self._patch(cur.outs, nxt.start)
            cur = _Frag(cur.start, nxt.outs)
        return cur

    def _patch(self, outs, target: int) -> None:
        for state, key in outs:
            self.nfa[state].append((key, target))

    def _repeat(self) -> _Frag:
        frag = self._atom()
        while True:
            c = self._peek()
            if c == 0x2A:  # '*'
                self._eat()
                frag = self._star(frag)
            elif c == 0x2B:  # '+'
                self._eat()
                frag = self._plus(frag)
            elif c == 0x3F:  # '?'
                self._eat()
                frag = self._opt(frag)
            elif c == 0x7B:  # '{'
                frag = self._bounded(frag)
            else:
                return frag

    def _clone(self, frag: _Frag) -> _Frag:
        """Deep-copy a fragment's reachable subgraph (bounded repeats
        expand to copies)."""
        mapping = {}

        def copy(s):
            if s in mapping:
                return mapping[s]
            ns = self._new_state()
            mapping[s] = ns
            for key, tgt in list(self.nfa[s]):
                self.nfa[ns].append((key, copy(tgt)))
            return ns

        start = copy(frag.start)
        outs = [(mapping[s], key) for s, key in frag.outs]
        return _Frag(start, outs)

    def _star(self, frag: _Frag) -> _Frag:
        hub = self._new_state()
        self.nfa[hub].append((None, frag.start))
        self._patch(frag.outs, hub)
        return _Frag(hub, [(hub, None)])

    def _plus(self, frag: _Frag) -> _Frag:
        hub = self._new_state()
        self._patch(frag.outs, hub)
        self.nfa[hub].append((None, frag.start))
        return _Frag(frag.start, [(hub, None)])

    def _opt(self, frag: _Frag) -> _Frag:
        hub = self._new_state()
        self.nfa[hub].append((None, frag.start))
        return _Frag(hub, frag.outs + [(hub, None)])

    def _bounded(self, frag: _Frag) -> _Frag:
        assert self._eat() == 0x7B
        spec = bytearray()
        while self._peek() is not None and self._peek() != 0x7D:
            spec.append(self._eat())
        if self._peek() is None:
            raise ValueError("regex: unterminated {m,n}")
        self._eat()  # '}'
        parts = spec.decode().split(",")
        try:
            m = int(parts[0])
            n = (m if len(parts) == 1
                 else (None if parts[1] == "" else int(parts[1])))
        except ValueError as exc:
            raise ValueError(f"regex: bad repeat {{{spec.decode()}}}") \
                from exc
        if n is not None and (m > n or m < 0):
            raise ValueError(f"regex: bad repeat bounds {{{m},{n}}}")
        if m > 256 or (n or 0) > 256:
            raise ValueError("regex: repeat bound > 256")

        def chain_onto(cur: _Frag | None, piece: _Frag) -> _Frag:
            if cur is None:
                return piece
            self._patch(cur.outs, piece.start)
            return _Frag(cur.start, piece.outs)

        # m required copies, then (n - m) optional copies (each
        # skippable — `_opt` keeps the skip arrow in its outs) or a
        # star tail when n is None. ALL clones are made up front, while
        # `frag` is still pristine — cloning after a patch would copy
        # the patched-in arrows and graft spurious subgraphs into later
        # copies.
        total = m + 1 if n is None else n
        copies = [self._clone(frag) for _ in range(max(total - 1, 0))]
        copies.append(frag)  # the original is always the LAST piece
        chain: _Frag | None = None
        for _ in range(m):
            chain = chain_onto(chain, copies.pop(0))
        if n is None:
            tail = self._star(copies.pop(0))
            return chain_onto(chain, tail)
        for _ in range(n - m):
            chain = chain_onto(chain, self._opt(copies.pop(0)))
        if chain is None:  # {0,0}: matches only the empty string
            s = self._new_state()
            return _Frag(s, [(s, None)])
        return chain

    def _atom(self) -> _Frag:
        c = self._peek()
        if c is None:
            raise ValueError("regex: unexpected end")
        if c == 0x28:  # '('
            self._eat()
            # non-capturing group marker (?: is accepted and ignored
            if (self._peek() == 0x3F and self.i + 1 < len(self.src)
                    and self.src[self.i + 1] == 0x3A):
                self._eat()
                self._eat()
            frag = self._alt()
            if self._peek() != 0x29:
                raise ValueError("regex: missing )")
            self._eat()
            return frag
        if c == 0x5B:  # '['
            return self._charclass()
        if c == 0x2E:  # '.'
            self._eat()
            return self._byteset(_ANY)
        if c == 0x5C:  # '\'
            self._eat()
            return self._byteset(self._escape())
        if c in (0x2A, 0x2B, 0x3F, 0x7B, 0x7D, 0x29, 0x7C):
            raise ValueError(f"regex: stray {chr(c)!r}")
        # literal byte (multi-byte UTF-8 chars arrive byte by byte)
        return self._byteset(frozenset([self._eat()]))

    def _escape(self) -> frozenset:
        if self._peek() is None:
            raise ValueError("regex: trailing backslash")
        e = self._eat()
        table = {0x64: _DIGIT, 0x77: _WORD, 0x73: _SPACE,  # d w s
                 0x6E: frozenset([0x0A]), 0x74: frozenset([0x09]),
                 0x72: frozenset([0x0D])}  # n t r
        if e in table:
            return table[e]
        if e == 0x78:  # \xNN
            if self.i + 2 > len(self.src):
                raise ValueError("regex: truncated \\xNN escape")
            try:
                val = int(self.src[self.i:self.i + 2].decode(), 16)
            except ValueError as exc:
                raise ValueError("regex: bad \\xNN escape") from exc
            self.i += 2
            return frozenset([val])
        if e == 0x44:  # \D
            return frozenset(set(range(256)) - _DIGIT)
        if e == 0x57:  # \W
            return frozenset(set(range(256)) - _WORD)
        if e == 0x53:  # \S
            return frozenset(set(range(256)) - _SPACE)
        return frozenset([e])  # escaped literal (\. \\ \[ ...)

    def _byteset(self, bs: frozenset) -> _Frag:
        s = self._new_state()
        return _Frag(s, [(s, bs)])

    def _charclass(self) -> _Frag:
        assert self._eat() == 0x5B
        negate = False
        if self._peek() == 0x5E:  # '^'
            negate = True
            self._eat()
        members: set[int] = set()
        first = True

        def read_one() -> frozenset:
            if self._peek() == 0x5C:
                self._eat()
                return self._escape()
            return frozenset([self._eat()])

        while True:
            c = self._peek()
            if c is None:
                raise ValueError("regex: unterminated [...]")
            if c == 0x5D and not first:  # ']'
                self._eat()
                break
            first = False
            item = read_one()
            if (self._peek() == 0x2D and self.i + 1 < len(self.src)
                    and self.src[self.i + 1] != 0x5D):
                self._eat()  # '-'
                hi_set = read_one()
                if len(item) != 1 or len(hi_set) != 1:
                    raise ValueError(
                        "regex: range endpoints in [...] must be single "
                        "bytes")
                lo, hi = next(iter(item)), next(iter(hi_set))
                if hi < lo:
                    raise ValueError("regex: reversed range in [...]")
                members |= set(range(lo, hi + 1))
            else:
                members |= item
        if negate:
            members = set(range(256)) - members
        if not members:
            raise ValueError("regex: empty character class")
        return self._byteset(frozenset(members))


# ---------------------------------------------------------------------------
# NFA -> byte DFA (subset construction)
# ---------------------------------------------------------------------------


class ByteDFA:
    """trans: (S, 256) int32 (DEAD = dead); accept: (S,) bool; start 0."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray):
        self.trans = trans
        self.accept = accept

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def run(self, state: int, data: bytes) -> int:
        for b in data:
            if state == DEAD:
                return DEAD
            state = int(self.trans[state, b])
        return state

    def matches(self, data: bytes) -> bool:
        s = self.run(0, data)
        return s != DEAD and bool(self.accept[s])


def compile_byte_dfa(pattern: str) -> ByteDFA:
    parser = _Parser(pattern)
    frag = parser.parse()
    nfa = parser.nfa
    final = len(nfa)
    nfa.append([])  # the single accepting NFA state
    parser._patch(frag.outs, final)

    def eps_closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for key, tgt in nfa[s]:
                if key is None and tgt not in seen:
                    seen.add(tgt)
                    stack.append(tgt)
        return frozenset(seen)

    start = eps_closure(frozenset([frag.start]))
    dfa_ids = {start: 0}
    order = [start]
    trans_rows = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        row = np.full((256,), DEAD, np.int32)
        # group target NFA-state-sets by byte
        per_byte: dict[int, set] = {}
        for s in cur:
            for key, tgt in nfa[s]:
                if key is None:
                    continue
                for b in key:
                    per_byte.setdefault(b, set()).add(tgt)
        for b, tgts in per_byte.items():
            nxt = eps_closure(frozenset(tgts))
            if nxt not in dfa_ids:
                if len(dfa_ids) >= MAX_DFA_STATES:
                    raise ValueError(
                        f"regex compiles to more than {MAX_DFA_STATES} "
                        "DFA states; simplify the pattern")
                dfa_ids[nxt] = len(dfa_ids)
                order.append(nxt)
            row[b] = dfa_ids[nxt]
        trans_rows.append(row)
    trans = np.stack(trans_rows)
    accept = np.asarray([final in st for st in order])
    return _trim_coaccessible(ByteDFA(trans, accept))


def _trim_coaccessible(dfa: ByteDFA) -> ByteDFA:
    """Remove states from which no accepting state is reachable.

    Constrained decoding fundamentally requires `allowed => the match
    can still complete`: a transition into a dead-end state would let
    generation wander somewhere nothing (not even EOS) is ever allowed
    again. Matching semantics are unchanged — dead-end paths never
    accepted anyway.
    """
    n = dfa.num_states
    safe = np.where(dfa.trans == DEAD, n, dfa.trans)  # n = sink row
    reach = np.concatenate([dfa.accept, [False]])  # sink never reaches
    while True:
        new = reach.copy()
        new[:n] |= reach[safe].any(axis=1)
        if (new == reach).all():
            break
        reach = new
    if not reach[0]:
        raise ValueError("regex matches nothing (empty language)")
    keep = reach[:n]
    remap = np.full((n + 1,), DEAD, np.int64)
    remap[:n][keep] = np.arange(int(keep.sum()))
    trans = remap[safe[keep]].astype(np.int32)
    return ByteDFA(trans, dfa.accept[keep])


# ---------------------------------------------------------------------------
# token byte mapping + token-level lift
# ---------------------------------------------------------------------------

# GPT-2 byte-level BPE alphabet: printable stand-ins for raw bytes
@functools.lru_cache(maxsize=1)
def _gpt2_unicode_to_byte() -> dict[str, int]:
    bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _declared_special_ids(tokenizer, inner) -> set[int] | None:
    """Special-token ids from the tokenizer's OWN declaration: the
    added-token registry's `special` flags plus the wrapper's resolved
    bos/eos/pad. Returns None when the tokenizer declares nothing, in
    which case the caller falls back to a string-shape heuristic — a
    heuristic alone would misclassify real BPE merges like '[]', '[0]'
    or '<div>' and make them unreachable under a grammar."""
    getter = getattr(inner, "get_added_tokens_decoder", None)
    if getter is None:
        asi = getattr(tokenizer, "all_special_ids", None)
        return {int(i) for i in asi} if asi else None
    try:
        ids = {int(tid) for tid, tok in getter().items()
               if getattr(tok, "special", True)}
    except Exception:  # pragma: no cover — tokenizers API drift
        return None
    # base-vocab specials the wrapper resolved at construction (some
    # tokenizer.json files bake bos/eos into the vocab, not added)
    for name in ("bos_id", "eos_id"):
        v = getattr(tokenizer, name, None)
        if isinstance(v, int) and v >= 0:
            ids.add(v)
    # pad only when the tokenizer actually DECLARED one — the wrapper's
    # fallback (eos, else 0) would otherwise ban real vocab id 0
    pad = getattr(tokenizer, "pad_id", None)
    if (getattr(tokenizer, "pad_is_declared", True)
            and isinstance(pad, int) and pad >= 0):
        ids.add(pad)
    return ids


_BYTE_FALLBACK = _pyre.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def _has_byte_fallback(inner) -> bool:
    """True when the vocab carries the sentencepiece byte-fallback
    convention: ALL 256 '<0xHH>' tokens present. A partial set (e.g. a
    BPE merge that happens to spell '<0x0A>') stays literal text."""
    t2i = getattr(inner, "token_to_id", None)
    if t2i is None:
        return False
    return all(t2i(f"<0x{b:02X}>") is not None for b in range(256))


def token_bytes(tokenizer, vocab_size: int) -> list[bytes | None]:
    """Per-token UTF-8 byte strings; None = unspellable (specials, ids
    past the tokenizer). Exact for ByteTokenizer; HF fast tokenizers go
    through id_to_token with byte-level/sentencepiece markers decoded."""
    out: list[bytes | None] = [None] * vocab_size
    inner = getattr(tokenizer, "_tok", None)
    if inner is not None and hasattr(inner, "id_to_token"):
        g2b = _gpt2_unicode_to_byte()
        specials = _declared_special_ids(tokenizer, inner)
        byte_fb = _has_byte_fallback(inner)
        for i in range(min(vocab_size, tokenizer.vocab_size)):
            s = inner.id_to_token(i)
            if s is None:
                continue
            if specials is not None:
                if i in specials:
                    continue  # never valid inside a constraint
            elif (s.startswith("<") and s.endswith(">")) or (
                    s.startswith("[") and s.endswith("]")):
                continue  # undeclared tokenizer: shape heuristic
            if byte_fb:
                m = _BYTE_FALLBACK.match(s)
                if m:  # sentencepiece byte fallback: '<0x0A>' IS \n
                    out[i] = bytes([int(m.group(1), 16)])
                    continue
            if all(ch in g2b for ch in s):  # byte-level BPE alphabet
                out[i] = bytes(g2b[ch] for ch in s)
            else:  # sentencepiece-style: ▁ marks a leading space
                out[i] = s.replace("▁", " ").encode("utf-8")
        return out
    # byte tokenizer (ids 0..255 are raw bytes; specials unspellable)
    for i in range(min(256, vocab_size)):
        out[i] = bytes([i])
    return out


class TokenDFA:
    """Token-level grammar table.

    next_state: (S, V) int32, DEAD where the token is not allowed;
    accept: (S,) bool — EOS is allowed exactly in accepting states.
    """

    def __init__(self, next_state: np.ndarray, accept: np.ndarray,
                 pattern: str):
        self.next_state = next_state
        self.accept = accept
        self.pattern = pattern

    @property
    def num_states(self) -> int:
        return self.next_state.shape[0]

    def walk(self, tokens: Sequence[int], state: int = 0) -> int:
        """Host-side replay (continuations after preemption)."""
        for t in tokens:
            if state == DEAD:
                return DEAD
            state = int(self.next_state[state, t])
        return state


def compile_token_dfa(pattern: str, tok_bytes: Sequence[bytes | None]
                      ) -> TokenDFA:
    """Lift the pattern's byte DFA to token granularity.

    Vectorised over the vocab: token transitions advance byte-by-byte
    through (S, 256) gathers — O(max_token_len) numpy passes, not
    O(S * V) python loops.
    """
    dfa = compile_byte_dfa(pattern)
    s_count = dfa.num_states
    v = len(tok_bytes)
    if s_count * v * 4 > MAX_TABLE_BYTES:
        raise ValueError(
            f"pattern needs {s_count} DFA states x {v} vocab = "
            f"{s_count * v * 4 >> 20} MB of token table (> "
            f"{MAX_TABLE_BYTES >> 20} MB); simplify the pattern or use a "
            "smaller-vocab tokenizer")
    max_len = max((len(b) for b in tok_bytes if b), default=1)
    # states (S, V): start every column at its row state; dead columns
    # (unspellable tokens) start DEAD
    states = np.tile(np.arange(s_count, dtype=np.int32)[:, None], (1, v))
    spell = np.asarray([b is not None for b in tok_bytes])
    states[:, ~spell] = DEAD
    lens = np.asarray([len(b) if b else 0 for b in tok_bytes])
    byte_mat = np.zeros((max_len, v), np.int32)
    for i, b in enumerate(tok_bytes):
        if b:
            byte_mat[:len(b), i] = np.frombuffer(b, np.uint8)
    trans = np.concatenate(  # DEAD row sends everything to DEAD
        [dfa.trans, np.full((1, 256), DEAD, np.int32)], axis=0)
    for step in range(max_len):
        live = lens > step
        nxt = trans[states[:, live], byte_mat[step, live]]
        states[:, live] = nxt
    # zero-length tokens (shouldn't exist) end where they started; fine
    return TokenDFA(states, dfa.accept.copy(), pattern)


class GrammarCache:
    """Per-(tokenizer, vocab) compile cache: pattern -> TokenDFA."""

    def __init__(self, tokenizer, vocab_size: int):
        self._tok_bytes = token_bytes(tokenizer, vocab_size)
        self._cache: dict[str, TokenDFA] = {}

    def get(self, pattern: str) -> TokenDFA:
        hit = self._cache.get(pattern)
        if hit is None:
            hit = compile_token_dfa(pattern, self._tok_bytes)
            self._cache[pattern] = hit
        return hit


# ---------------------------------------------------------------------------
# canned patterns
# ---------------------------------------------------------------------------

_JSON_STRING = r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
_JSON_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+\-]?[0-9]+)?"
_JSON_SCALAR = f"({_JSON_STRING}|{_JSON_NUMBER}|true|false|null)"


def json_object_regex(max_depth: int = 1) -> str:
    """A bounded-depth JSON object/array grammar as a regex (regular
    languages cannot nest unboundedly; depth-k JSON is regular). Depth 1
    = flat objects/arrays of scalars (~310 DFA states); each extra level
    multiplies states ~4x (depth 2 ~1.3k, depth 3 ~5k) and the device
    table is states x vocab x 4 bytes — keep depth <= 2 on 32k-vocab
    tokenizers."""
    ws = r"[ \n\t]*"
    value = _JSON_SCALAR
    for _ in range(max_depth):
        obj = (f"\\{{{ws}({_JSON_STRING}{ws}:{ws}{value}"
               f"({ws},{ws}{_JSON_STRING}{ws}:{ws}{value})*)?{ws}\\}}")
        arr = f"\\[{ws}({value}({ws},{ws}{value})*)?{ws}\\]"
        value = f"({_JSON_SCALAR}|{obj}|{arr})"
    return (f"\\{{{ws}({_JSON_STRING}{ws}:{ws}{value}"
            f"({ws},{ws}{_JSON_STRING}{ws}:{ws}{value})*)?{ws}\\}}")


# ---------------------------------------------------------------------------
# JSON Schema -> regex (structured output beyond bare json_object mode)
# ---------------------------------------------------------------------------

_RE_SPECIAL = frozenset(b"\\()[]{}*+?|.^$-")
_WS = r"[ \n\t]*"
_JSON_INTEGER = r"-?(0|[1-9][0-9]*)"
# one JSON-text string "character": a plain char or an escape sequence
_JSON_CHAR = r'([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'


def _re_escape(text: str) -> str:
    """Literal text -> this module's regex dialect (byte-wise; regex
    metacharacters backslash-escaped, non-printable bytes as \\xNN)."""
    out = []
    for b in text.encode("utf-8"):
        if b in _RE_SPECIAL:
            out.append("\\" + chr(b))
        elif 0x20 <= b < 0x7F:
            out.append(chr(b))
        else:
            out.append(f"\\x{b:02X}")
    return "".join(out)


def _json_literal(value) -> str:
    """A python value -> regex matching exactly its canonical JSON
    spelling (ensure_ascii keeps the bytes printable)."""
    import json as _json
    return _re_escape(_json.dumps(value, separators=(",", ":")))


def json_schema_regex(schema: dict, *, max_depth: int = 4,
                      max_optional: int = 6) -> str:
    """Compile a practical JSON-Schema subset into a regex for the
    byte-DFA -> token-table pipeline (the same machinery json_object
    mode uses; exact through sampling and speculation).

    Supported: `type` object / array / string / integer / number /
    boolean / null (or a list of those), `properties` + `required`,
    `enum` / `const` (any JSON values), `anyOf` / `oneOf`, `items`,
    `minItems` / `maxItems`, `minLength` / `maxLength`. Semantics are
    generation-oriented (OpenAI structured-output conventions):

      * objects are CLOSED (no additional properties) and their keys
        appear in declared order; optional keys (absent from
        `required`) may be omitted — at most `max_optional` optional
        keys per object (the ordering regex doubles per optional key);
      * nesting is bounded by `max_depth` (depth-k JSON is regular;
        unbounded nesting is not);
      * arrays without `items`, and bare {} subschemas, accept any
        scalar;
      * numeric ranges (`minimum` / `maximum`), string `pattern`, and
        `additionalProperties` are rejected loudly rather than
        silently ignored.

    Raises ValueError on anything outside the subset."""
    if not isinstance(schema, dict):
        raise ValueError("schema must be a JSON object")
    return _schema_re(schema, max_depth, max_optional)


_UNSUPPORTED = ("minimum", "maximum", "exclusiveMinimum",
                "exclusiveMaximum", "multipleOf", "pattern",
                "additionalProperties", "patternProperties", "allOf",
                "not", "$ref", "uniqueItems", "minProperties",
                "maxProperties")

# optional-key ordering doubles the regex per optional key and nesting
# multiplies levels together, so a small schema can compound into a
# multi-GB pattern. Checked at EVERY recursion return (bottom-up), so
# an inner level trips the cap before an outer level multiplies it —
# peak memory stays ~branching x cap, never the full product.
MAX_SCHEMA_REGEX = 1 << 20  # 1 MB of pattern is already a huge DFA


def _schema_re(s, depth: int, max_opt: int) -> str:
    out = _schema_re_inner(s, depth, max_opt)
    if len(out) > MAX_SCHEMA_REGEX:
        raise ValueError(
            "json_schema: schema compiles to a regex over "
            f"{MAX_SCHEMA_REGEX >> 20} MB (optional-key combinations "
            "double per optional key and compound across nesting); "
            "mark more keys required or flatten the schema")
    return out


def _schema_re_inner(s, depth: int, max_opt: int) -> str:
    if not isinstance(s, dict):
        raise ValueError(f"subschema must be an object, got {type(s)}")
    for key in _UNSUPPORTED:
        if key in s:
            raise ValueError(
                f"json_schema: {key!r} is not supported (the regex/DFA "
                "pipeline cannot express it); remove it or use a "
                "supported equivalent")
    if "const" in s:
        return _json_literal(s["const"])
    if "enum" in s:
        if not s["enum"]:
            raise ValueError("json_schema: empty enum matches nothing")
        return "(" + "|".join(_json_literal(v) for v in s["enum"]) + ")"
    for comb in ("anyOf", "oneOf"):
        if comb in s:
            branches = s[comb]
            if not isinstance(branches, list) or not branches:
                raise ValueError(f"json_schema: {comb} needs a non-empty "
                                 "list")
            return ("(" + "|".join(_schema_re(b, depth, max_opt)
                                   for b in branches) + ")")
    t = s.get("type")
    if isinstance(t, list):
        if not t:
            raise ValueError("json_schema: empty type list")
        return ("(" + "|".join(_schema_re({**s, "type": one}, depth,
                                          max_opt)
                               for one in t) + ")")
    if t == "object" or (t is None and "properties" in s):
        return _object_re(s, depth, max_opt)
    if t == "array" or (t is None and "items" in s):
        return _array_re(s, depth, max_opt)
    if t == "string":
        lo = int(s.get("minLength", 0))
        hi = s.get("maxLength")
        if lo == 0 and hi is None:
            return _JSON_STRING
        _check_bound(lo, hi, "minLength/maxLength")
        reps = (f"{{{lo},}}" if hi is None else f"{{{lo},{int(hi)}}}")
        return f'"{_JSON_CHAR}{reps}"'
    if t == "integer":
        return _JSON_INTEGER
    if t == "number":
        return _JSON_NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t is None:
        return _JSON_SCALAR  # unconstrained subschema: any scalar
    raise ValueError(f"json_schema: unsupported type {t!r}")


def _object_re(s, depth: int, max_opt: int) -> str:
    if depth <= 0:
        raise ValueError("json_schema: nesting exceeds max_depth")
    props = s.get("properties", {})
    if not isinstance(props, dict):
        raise ValueError('json_schema: "properties" must be an object')
    required = s.get("required", [])
    unknown = set(required) - set(props)
    if unknown:
        raise ValueError(f"json_schema: required keys {sorted(unknown)} "
                         "missing from properties")
    req = set(required)
    n_opt = sum(1 for k in props if k not in req)
    if n_opt > max_opt:
        raise ValueError(
            f"json_schema: {n_opt} optional properties > max_optional="
            f"{max_opt} (the ordering regex doubles per optional key); "
            "mark more keys required or raise max_optional")
    keys = list(props)
    items = [f"{_json_literal(k)}{_WS}:{_WS}"
             f"{_schema_re(props[k], depth - 1, max_opt)}"
             for k in keys]

    # properties in declared order, commas between those present;
    # memoized over (index, anything-emitted-yet) so the string grows
    # ~2x per OPTIONAL key only
    memo: dict[tuple[int, bool], str] = {}

    def tail(i: int, seen: bool) -> str:
        if i == len(keys):
            return ""
        got = memo.get((i, seen))
        if got is not None:
            return got
        sep = f"{_WS},{_WS}" if seen else ""
        with_it = f"{sep}{items[i]}{tail(i + 1, True)}"
        if keys[i] in req:
            out = with_it
        else:
            out = f"({with_it}|{tail(i + 1, seen)})"
        memo[(i, seen)] = out
        return out

    return f"\\{{{_WS}{tail(0, False)}{_WS}\\}}"


def _check_bound(lo: int, hi, what: str) -> None:
    """Schema-level bound validation: the regex engine caps {m,n}
    repeats at 256, so an oversize bound must fail HERE with the
    keyword named — not later as an opaque regex-internal error."""
    if lo < 0 or (hi is not None and int(hi) < lo):
        raise ValueError(f"json_schema: bad {what}")
    if lo > 256 or (hi is not None and int(hi) > 256):
        raise ValueError(
            f"json_schema: {what} above 256 is not supported (the "
            "DFA pipeline caps bounded repeats at 256); drop the bound "
            "or lower it")


def _array_re(s, depth: int, max_opt: int) -> str:
    if depth <= 0:
        raise ValueError("json_schema: nesting exceeds max_depth")
    item = _schema_re(s.get("items", {}), depth - 1, max_opt)
    lo = int(s.get("minItems", 0))
    hi = s.get("maxItems")
    _check_bound(lo, hi, "minItems/maxItems")
    more = f"{_WS},{_WS}{item}"
    if hi is None:
        body = (f"({item}({more})*)?" if lo == 0
                else f"{item}({more}){{{lo - 1},}}")
    elif int(hi) == 0:
        body = ""
    elif lo == 0:
        body = f"({item}({more}){{0,{int(hi) - 1}}})?"
    else:
        body = f"{item}({more}){{{lo - 1},{int(hi) - 1}}}"
    return f"\\[{_WS}{body}{_WS}\\]"
