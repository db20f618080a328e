"""Grammar-constrained decoding: regex -> byte DFA -> token FSM.

The port's own copy of the JAX package's ``engine/grammar.py`` (numpy
only, so the tables are byte-equal to the reference's). The constraint
compiles on the host to a compressed form: a per-state token-legality
bitmask ``bits[S, V/32] uint32`` plus the underlying byte DFA
``byte_trans[S, 256]`` and the vocabulary's byte strings. The engine
uploads them once per FSM; each decode forward expands the current
state's bitmask row to mask the logits, samples, and advances the state by
walking the sampled token's bytes, all on the device, so constrained
decoding adds no host round trip between the forwards of a decode block.
The dense ``trans[S, V] int32`` table this replaces was about 1 GB at a
128k vocab x 2k states; the compressed form is about 34 MB.

Pipeline:

1. :func:`compile_regex` — a self-contained regex engine for a practical
   subset (literals, escapes, ASCII classes, ``. * + ? {m,n} | ()``),
   Thompson NFA → subset-construction DFA over bytes (fullmatch
   semantics, anchored both ends).
2. :func:`token_fsm` — lifts the byte DFA to the tokenizer vocabulary:
   token-level states ARE byte-DFA states; legality of token v in state
   s = "v's bytes walk to a live state" (vectorized: one [S, V] gather
   per byte position, so a 128k vocab compiles in milliseconds). EOS is
   legal exactly in accepting states.
3. :class:`TokenFSM` — the engine-facing artifact (also constructible
   via :func:`choice_fsm` for forced multiple-choice token sequences,
   which synthesizes a byte DFA over 4-byte token-id encodings so the
   same device steps serve it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenFSM", "compile_regex", "token_fsm", "regex_fsm",
           "choice_fsm", "json_schema_regex", "json_fsm", "vocab_bytes"]


def _gpt2_unicode_to_byte() -> dict:
    """Inverse of GPT-2's bytes_to_unicode map (byte-level BPE tokens
    spell raw bytes via this printable-unicode alphabet)."""
    bs = (list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(0x100 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def vocab_bytes(tokenizer, vocab_size: int) -> list[bytes]:
    """Tokenizer vocabulary as the EXACT byte strings each token
    contributes to decoded text — the alphabet the token FSM walks.

    Per-id ``decode([i])`` is NOT faithful: SentencePiece strips the
    leading ``▁`` space marker (so grammars would accept "yesmaybe" for
    "yes maybe") and byte-level-BPE tokens holding partial UTF-8 decode
    to U+FFFD. This reads the raw token strings instead and undoes the
    two standard surface encodings: SentencePiece (``▁`` → space,
    ``<0xHH>`` → the raw byte) and GPT-2 byte-level BPE (each char maps
    to one byte via bytes_to_unicode). Tokenizers without
    ``convert_ids_to_tokens`` (duck-typed stubs) fall back to per-id
    decode. Tokens that resolve empty are forbidden by every grammar.
    """
    conv = getattr(tokenizer, "convert_ids_to_tokens", None)
    if conv is None:
        return [str(tokenizer.decode([i])).encode("utf-8")
                for i in range(vocab_size)]
    toks = [conv(i) for i in range(vocab_size)]
    sample = [t for t in toks if t][:4096]
    byte_level = any(any(ch in ("Ġ", "Ċ") for ch in t)
                     for t in sample if isinstance(t, str))
    u2b = _gpt2_unicode_to_byte() if byte_level else None
    special = set(getattr(tokenizer, "all_special_ids", ()) or ())
    out: list[bytes] = []
    for i, t in enumerate(toks):
        if t is None or i in special:
            out.append(b"")
            continue
        if byte_level:
            try:
                out.append(bytes(u2b[ch] for ch in t))
                continue
            except KeyError:
                pass  # added/special token spelled literally
        if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
            out.append(bytes([int(t[3:5], 16)]))  # SP raw-byte token
            continue
        out.append(t.replace("▁", " ").encode("utf-8"))
    return out


# ── regex parsing (bytes, ASCII classes) ────────────────────────────────


def _cat_all(parts: list) -> tuple:
    """Balanced concatenation tree (a left-deep chain of {m,n}-expanded
    atoms would overflow Python's recursion limit in _nfa at ~1k)."""
    if not parts:
        return ("eps",)
    while len(parts) > 1:
        parts = [("cat", parts[i], parts[i + 1])
                 if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


class _Parser:
    """Recursive-descent parser → AST of
    ('lit', frozenset(bytes)) | ('cat', a, b) | ('alt', a, b) |
    ('star', a) | ('plus', a) | ('opt', a) | ('eps',)."""

    def __init__(self, pat: str):
        self.s = pat
        self.i = 0

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else None

    def eat(self):
        c = self.s[self.i]
        self.i += 1
        return c

    def parse(self):
        node = self.alternation()
        if self.i != len(self.s):
            raise ValueError(f"unexpected {self.s[self.i]!r} at {self.i}")
        return node

    def alternation(self):
        node = self.concat()
        while self.peek() == "|":
            self.eat()
            node = ("alt", node, self.concat())
        return node

    def concat(self):
        parts = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.repeat())
        return _cat_all(parts)

    def repeat(self):
        node = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            c = self.eat()
            if c == "*":
                node = ("star", node)
            elif c == "+":
                node = ("plus", node)
            elif c == "?":
                node = ("opt", node)
            else:  # {m,n} / {m,} / {m}
                spec = ""
                while self.peek() not in (None, "}"):
                    spec += self.eat()
                if self.peek() != "}":
                    raise ValueError("unterminated {m,n}")
                self.eat()
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(spec)
                parts = [node] * lo
                if hi is None:
                    parts.append(("star", node))
                else:
                    parts.extend([("opt", node)] * (hi - lo))
                node = _cat_all(parts)
        return node

    _ESCAPES = {
        "d": frozenset(range(0x30, 0x3A)),
        "w": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
                       + list(range(0x61, 0x7B)) + [0x5F]),
        "s": frozenset(b" \t\n\r\f\v"),
        "n": frozenset(b"\n"), "t": frozenset(b"\t"),
        "r": frozenset(b"\r"),
    }

    def _escape(self) -> frozenset:
        c = self.eat()
        if c in self._ESCAPES:
            return self._ESCAPES[c]
        if c in ("D", "W", "S"):
            return frozenset(range(256)) - self._ESCAPES[c.lower()]
        return frozenset(c.encode("utf-8"))  # literal escape: \. \[ \\ …

    def atom(self):
        c = self.peek()
        if c == "(":
            self.eat()
            node = self.alternation()
            if self.peek() != ")":
                raise ValueError("unbalanced (")
            self.eat()
            return node
        if c == "[":
            return ("lit", self.char_class())
        if c == ".":
            self.eat()
            return ("lit", frozenset(range(256)) - frozenset(b"\n"))
        if c == "\\":
            self.eat()
            return ("lit", self._escape())
        if c in ("*", "+", "?", "{", ")", "|"):
            raise ValueError(f"unexpected {c!r} at {self.i}")
        self.eat()
        enc = c.encode("utf-8")
        if len(enc) == 1:
            return ("lit", frozenset(enc))
        # multi-byte literal char → byte sequence
        node = ("lit", frozenset(enc[:1]))
        for b in enc[1:]:
            node = ("cat", node, ("lit", frozenset((b,))))
        return node

    def char_class(self) -> frozenset:
        self.eat()  # [
        neg = self.peek() == "^"
        if neg:
            self.eat()
        out: set[int] = set()
        prev: int | None = None
        while self.peek() not in (None, "]"):
            c = self.eat()
            if c == "\\":
                s = self._escape()
                out |= s
                prev = None
                continue
            if c == "-" and prev is not None and self.peek() not in (
                    None, "]"):
                hi = ord(self.eat())
                out |= set(range(prev, hi + 1))
                prev = None
                continue
            b = ord(c)
            if b > 0xFF:
                raise ValueError("non-ASCII char class member")
            out.add(b)
            prev = b
        if self.peek() != "]":
            raise ValueError("unbalanced [")
        self.eat()
        return frozenset(range(256)) - frozenset(out) if neg \
            else frozenset(out)


# ── NFA → DFA ───────────────────────────────────────────────────────────


def _nfa(node, nxt, states):
    """Thompson construction: returns (start, accept); ``states`` is a
    list of dicts {byte: set(states)} with eps edges under key -1."""
    def new():
        states.append({})
        return len(states) - 1

    kind = node[0]
    if kind == "eps":
        s, a = new(), new()
        states[s].setdefault(-1, set()).add(a)
        return s, a
    if kind == "lit":
        s, a = new(), new()
        for b in node[1]:
            states[s].setdefault(b, set()).add(a)
        return s, a
    if kind == "cat":
        s1, a1 = _nfa(node[1], nxt, states)
        s2, a2 = _nfa(node[2], nxt, states)
        states[a1].setdefault(-1, set()).add(s2)
        return s1, a2
    if kind == "alt":
        s, a = new(), new()
        for sub in (node[1], node[2]):
            ss, aa = _nfa(sub, nxt, states)
            states[s].setdefault(-1, set()).add(ss)
            states[aa].setdefault(-1, set()).add(a)
        return s, a
    if kind in ("star", "plus", "opt"):
        s, a = new(), new()
        ss, aa = _nfa(node[1], nxt, states)
        states[s].setdefault(-1, set()).add(ss)
        states[aa].setdefault(-1, set()).add(a)
        if kind in ("star", "opt"):
            states[s].setdefault(-1, set()).add(a)
        if kind in ("star", "plus"):
            states[aa].setdefault(-1, set()).add(ss)
        return s, a
    raise ValueError(kind)


def compile_regex(pattern: str, max_states: int = 4096
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Regex → byte DFA: (trans_byte [S, 256] int32 with -1 dead,
    accepting [S] bool). Fullmatch semantics (anchored)."""
    ast = _Parser(pattern).parse()
    states: list[dict] = []
    start, accept = _nfa(ast, None, states)

    def closure(ss: frozenset) -> frozenset:
        out = set(ss)
        stack = list(ss)
        while stack:
            s = stack.pop()
            for t in states[s].get(-1, ()):
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_c = closure(frozenset((start,)))
    index = {start_c: 0}
    order = [start_c]
    trans_rows: list[list[int]] = []
    acc: list[bool] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = [-1] * 256
        for b in range(256):
            tgt = set()
            for s in cur:
                tgt |= states[s].get(b, set())
            if tgt:
                tc = closure(frozenset(tgt))
                if tc not in index:
                    if len(order) >= max_states:
                        raise ValueError(
                            f"regex DFA exceeds {max_states} states")
                    index[tc] = len(order)
                    order.append(tc)
                row[b] = index[tc]
        trans_rows.append(row)
        acc.append(accept in cur)
        i += 1
    return (np.asarray(trans_rows, np.int32),
            np.asarray(acc, bool))


# ── token-level FSM ─────────────────────────────────────────────────────


def _pack_bits(legal: np.ndarray) -> np.ndarray:
    """[S, V] bool → [S, ceil(V/32)] uint32 little-endian bit packing."""
    s, v = legal.shape
    vw = -(-v // 32)
    pad = np.zeros((s, vw * 32), bool)
    pad[:, :v] = legal
    b = pad.reshape(s, vw, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)[None, None]).sum(
        axis=2, dtype=np.uint32)


@dataclasses.dataclass(frozen=True)
class TokenFSM:
    """Token-level DFA for on-device constrained decoding, in compressed
    storage (a dense [S, V] int32 table would be ~1 GB at 128k vocab x 2k
    states; this is ~30x smaller).

    * ``bits`` uint32 [S, ceil(V/32)]: token-legality bitmask per state
      (bit v of word v//32). Accepting states have the EOS bit; states
      with no legal token at all get a forced EOS bit so a stuck slot
      terminates cleanly.
    * ``byte_trans`` int32 [S, 256]: the underlying byte DFA (-1 dead).
      Token-level states ARE byte-DFA state ids; the next state for a
      sampled token is recovered by walking its bytes — a handful of
      [B]-sized gathers per decode step instead of a [S, V] table. Row
      S-1 is the post-EOS sink.
    * ``tok_bytes`` uint8 [V, L] / ``tok_len`` int32 [V]: each token's
      byte string (len 0 = forbidden/special; EOS walks 0 bytes).
    """
    bits: np.ndarray
    byte_trans: np.ndarray
    tok_bytes: np.ndarray
    tok_len: np.ndarray
    eos_id: int
    start: int = 0

    @property
    def n_states(self) -> int:
        return self.bits.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.tok_len.shape[0]

    def legal(self, state: int, tok: int) -> bool:
        w = int(self.bits[state, tok >> 5])
        return bool((w >> (tok & 31)) & 1)

    def mask_row(self, state: int) -> np.ndarray:
        """int32 [V] row: 0 = legal, -1 = forbidden (sampler contract)."""
        v = self.vocab_size
        w = self.bits[state]
        exp = ((w[:, None] >> np.arange(32, dtype=np.uint32)[None]) & 1)
        return np.where(exp.reshape(-1)[:v] > 0, 0, -1).astype(np.int32)

    def advance(self, state: int, tokens) -> int:
        """Host-side replay (admission of resumed/preempted requests)."""
        for t in tokens:
            t = int(t)
            if not self.legal(state, t):
                raise ValueError(f"token {t} forbidden by FSM")
            if t == self.eos_id:
                state = self.n_states - 1  # sink
                continue
            for b in self.tok_bytes[t, :int(self.tok_len[t])]:
                state = int(self.byte_trans[state, int(b)])
            state = max(state, 0)
        return state


def token_fsm(trans_byte: np.ndarray, accepting: np.ndarray,
              vocab: list[bytes], eos_id: int) -> TokenFSM:
    """Lift a byte DFA to token level.

    ``vocab[v]`` = token v's byte string (empty/special tokens other
    than EOS are simply forbidden everywhere). State S (appended) is the
    post-EOS sink. Vectorized: one [S, V] gather per byte position.
    """
    s_dfa = trans_byte.shape[0]
    v = len(vocab)
    lens = np.asarray([len(t) for t in vocab], np.int32)
    lmax = max(int(lens.max()) if v else 0, 1)
    padded = np.zeros((v, lmax), np.uint8)
    for i, t in enumerate(vocab):
        if t:
            padded[i, :len(t)] = np.frombuffer(t, np.uint8)
    # walk every (state, token) pair in lock-step over byte positions
    tb = np.concatenate(
        [trans_byte, -np.ones((1, 256), np.int32)], axis=0)  # dead row
    cur = np.broadcast_to(
        np.arange(s_dfa, dtype=np.int32)[:, None], (s_dfa, v)).copy()
    for p in range(lmax):
        alive = (p < lens)[None, :]
        stepped = tb[np.where(cur < 0, s_dfa, cur), padded[None, :, p]]
        cur = np.where(alive, stepped, cur)
    if not 0 <= eos_id < v:
        raise ValueError(f"eos_id {eos_id} outside vocab {v}")
    legal = (cur >= 0) & (lens > 0)[None, :]          # [S_dfa, V]
    legal[:, eos_id] = accepting
    sink_row = np.zeros((1, v), bool)
    sink_row[0, eos_id] = True  # EOS self-walk keeps padded steps legal
    legal = np.concatenate([legal, sink_row], axis=0)
    # dead states (nothing legal): force EOS so a stuck slot terminates
    legal[~legal.any(axis=1), eos_id] = True
    bt = np.concatenate(
        [trans_byte, -np.ones((1, 256), np.int32)], axis=0)  # sink row
    lens = lens.copy()
    lens[eos_id] = 0  # EOS advances by the sink rule, never by bytes
    return TokenFSM(bits=_pack_bits(legal), byte_trans=bt,
                    tok_bytes=padded, tok_len=lens, eos_id=eos_id)


def regex_fsm(pattern: str, vocab: list[bytes], eos_id: int) -> TokenFSM:
    """compile_regex + token_fsm in one call."""
    tb, acc = compile_regex(pattern)
    return token_fsm(tb, acc, vocab, eos_id)


_WS = r"[ \n\t\r]{0,4}"  # bounded inter-token whitespace (caps DFA size)


def _re_lit(s: str) -> str:
    """Escape a literal for the regex engine."""
    out = []
    for c in s:
        if c in r"\.[]{}()*+?|":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


def _json_value_regex(schema: dict, root: dict | None = None,
                      depth: int = 0, max_depth: int = 4) -> str:
    """JSON-schema subset → regex over the value's canonical-ish JSON
    text (bounded optional whitespace between structural tokens).

    Supported: type string/integer/number/boolean/null, enum (JSON
    literals), array of items (minItems/maxItems, default 0..8), object
    with ``properties`` emitted in declaration order (all listed
    properties are required — optional properties would square the DFA;
    reject via ValueError so callers know the contract), and RECURSIVE
    schemas via ``$ref`` ("#" or "#/$defs/<name>"): each ref expansion
    unrolls the definition one level (depth-k expansion through the same
    regex→DFA pipeline). At ``max_depth`` a recursive
    ARRAY branch with minItems=0 closes as the empty array; any other
    recursion at the cutoff raises (an all-required recursive object has
    no finite cutoff)."""
    if root is None:
        root = schema
    if "$ref" in schema:
        ref = schema["$ref"]
        if depth >= max_depth:
            raise ValueError(
                f"schema recursion via {ref!r} exceeds max_depth="
                f"{max_depth} with no optional cutoff (make the "
                "recursive branch an array with minItems=0, or raise "
                "max_depth)")
        if ref == "#":
            target = root
        elif ref.startswith("#/$defs/"):
            name = ref[len("#/$defs/"):]
            try:
                target = root["$defs"][name]
            except KeyError:
                raise ValueError(f"unresolved $ref {ref!r}") from None
        elif ref.startswith("#/definitions/"):
            name = ref[len("#/definitions/"):]
            try:
                target = root["definitions"][name]
            except KeyError:
                raise ValueError(f"unresolved $ref {ref!r}") from None
        else:
            raise ValueError(f"unsupported $ref {ref!r} (supported: "
                             "'#', '#/$defs/*', '#/definitions/*')")
        return _json_value_regex(target, root, depth + 1, max_depth)
    if "enum" in schema:
        import json as _json

        alts = "|".join(_re_lit(_json.dumps(v)) for v in schema["enum"])
        return f"({alts})"
    t = schema.get("type")
    if t == "string":
        # ASCII string with escapes; no raw control chars
        return r'"([^"\\]|\\.)*"'
    if t == "integer":
        return r"-?(0|[1-9]\d*)"
    if t == "number":
        return r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?"
    if t == "boolean":
        return r"(true|false)"
    if t == "null":
        return r"null"
    if t == "array":
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 8))
        if lo > hi:
            raise ValueError("minItems > maxItems")
        items = schema.get("items", {"type": "string"})
        try:
            item = _json_value_regex(items, root, depth, max_depth)
        except ValueError:
            if lo == 0 and "$ref" in items and depth + 1 >= max_depth:
                # depth-k cutoff: the recursive branch closes as []
                return rf"\[{_WS}\]"
            raise
        more = f"({_WS},{_WS}{item})"
        if lo == 0:
            body = (f"({item}{more}{{0,{hi - 1}}})?" if hi > 0 else "")
        else:
            body = f"{item}{more}{{{lo - 1},{hi - 1}}}"
        return rf"\[{_WS}{body}{_WS}\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return rf"\{{{_WS}\}}"
        req = schema.get("required")
        if req is not None and set(req) != set(props):
            raise ValueError(
                "guided_json supports all-required objects only "
                "(optional properties square the DFA)")
        parts = []
        for k, sub in props.items():
            parts.append(
                rf'"{_re_lit(k)}"{_WS}:{_WS}'
                + _json_value_regex(sub, root, depth, max_depth))
        body = (_WS + "," + _WS).join(parts)
        return rf"\{{{_WS}{body}{_WS}\}}"
    raise ValueError(f"unsupported schema: {schema!r}")


def json_schema_regex(schema: dict, max_depth: int = 4) -> str:
    """Top-level JSON-schema → anchored regex (compose with
    :func:`regex_fsm`). See :func:`_json_value_regex` for the subset;
    ``max_depth`` bounds $ref recursion unrolling."""
    return _json_value_regex(schema, max_depth=max_depth)


def json_fsm(schema: dict, vocab: list[bytes], eos_id: int,
             max_depth: int = 4, max_states: int = 4096) -> TokenFSM:
    """JSON-schema-constrained decoding: schema → regex → token FSM.
    ``max_states`` guards the DFA against exponential schemas."""
    tb, acc = compile_regex(json_schema_regex(schema, max_depth),
                            max_states=max_states)
    return token_fsm(tb, acc, vocab, eos_id)


def choice_fsm(choices: list[list[int]], vocab_size: int,
               eos_id: int) -> TokenFSM:
    """Force the output to be exactly one of ``choices`` (token-id
    sequences) — a trie DFA, EOS legal only at a completed choice.

    Stored in the same compressed TokenFSM form as regex grammars: the
    token trie becomes a byte DFA over each token id's 4-byte
    little-endian encoding (``tok_bytes[v] = LE4(v)``), so the engine's
    single byte-walk next-state program serves both kinds."""
    # token-level trie first (to know the legality sets)
    children: list[dict[int, int]] = [{}]
    terminal: list[bool] = [False]
    for seq in choices:
        if not seq:
            raise ValueError("empty choice")
        s = 0
        for t in seq:
            t = int(t)
            if not 0 <= t < vocab_size:
                raise ValueError(f"choice token {t} outside vocab")
            if t not in children[s]:
                children.append({})
                terminal.append(False)
                children[s][t] = len(children) - 1
            s = children[s][t]
        terminal[s] = True

    def le4(t: int) -> bytes:
        return bytes((t >> (8 * j)) & 0xFF for j in range(4))

    # byte trie: token-trie nodes keep their ids (so bits rows align);
    # intermediate byte states append after them
    rows: list[dict[int, int]] = [dict() for _ in children]

    def new_state() -> int:
        rows.append({})
        return len(rows) - 1

    for s, kids in enumerate(children):
        for t, child in kids.items():
            cur = s
            bs = le4(t)
            for j, byt in enumerate(bs):
                if j == len(bs) - 1:
                    rows[cur][byt] = child
                elif byt in rows[cur]:
                    cur = rows[cur][byt]
                else:
                    nxt = new_state()
                    rows[cur][byt] = nxt
                    cur = nxt
    n = len(rows)
    bt = -np.ones((n + 1, 256), np.int32)  # + sink row
    for s, kids in enumerate(rows):
        for byt, nxt in kids.items():
            bt[s, byt] = nxt
    legal = np.zeros((n + 1, vocab_size), bool)
    for s, kids in enumerate(children):
        for t in kids:
            legal[s, t] = True
        if terminal[s]:
            legal[s, eos_id] = True
    legal[n, eos_id] = True  # sink
    legal[~legal.any(axis=1), eos_id] = True
    tok_bytes = ((np.arange(vocab_size, dtype=np.uint32)[:, None]
                  >> (8 * np.arange(4, dtype=np.uint32))[None]) & 0xFF
                 ).astype(np.uint8)
    tok_len = np.full((vocab_size,), 4, np.int32)
    tok_len[eos_id] = 0
    return TokenFSM(bits=_pack_bits(legal), byte_trans=bt,
                    tok_bytes=tok_bytes, tok_len=tok_len, eos_id=eos_id)
