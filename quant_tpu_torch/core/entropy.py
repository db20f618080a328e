"""Canonical-Huffman entropy stage — Python mirror of the C++ oracle.

Byte-exact against ``qr_entropy_encode``/``qr_entropy_decode`` in
``cpp/quantref.cpp``: a copy of the JAX package's ``core/entropy.py`` (the
port imports nothing of that package). The port's checkpoint reader and
writer use the C++ library itself through ``core/oracle.py`` when it
builds, and this mirror when no compiler is at hand.

Container format (normative, from cpp/quantref.h):
  "QREF" | u8 version=1 | u8 flags | u64le n_bytes | body
  flags bit0 = stored/raw (set when Huffman would not shrink the payload);
  body = n_bytes raw, or 256×u8 code-length table + MSB-first bitstream.

Determinism: Huffman merges pick the two least nodes by (count, order) with
leaf order = symbol and internal order = 256 + creation index; canonical
codes are assigned in (length, symbol) order.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

_MAGIC = b"QREF"
_HEADER = struct.Struct("<4sBBQ")  # magic, version, flags, n


def _huffman_lengths(hist: np.ndarray) -> np.ndarray:
    """Deterministic Huffman code lengths (uint8[256], 0 = unused)."""
    lengths = np.zeros(256, dtype=np.uint8)
    # node: (count, order, payload) where payload is a symbol or (a, b) pair
    heap: list[tuple[int, int, object]] = [
        (int(hist[s]), s, s) for s in range(256) if hist[s] > 0
    ]
    if not heap:
        return lengths
    if len(heap) == 1:
        lengths[heap[0][2]] = 1  # type: ignore[index]
        return lengths
    heapq.heapify(heap)
    next_order = 256
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        heapq.heappush(heap, (a[0] + b[0], next_order, (a, b)))
        next_order += 1
    stack = [(heap[0], 0)]
    while stack:
        (count, order, payload), depth = stack.pop()
        del count, order
        if isinstance(payload, tuple):
            left, right = payload
            stack.append((left, depth + 1))
            stack.append((right, depth + 1))
        else:
            lengths[payload] = depth
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values (uint32[256]) in (length, symbol) order."""
    codes = np.zeros(256, dtype=np.uint32)
    syms = sorted(
        (s for s in range(256) if lengths[s] > 0),
        key=lambda s: (lengths[s], s),
    )
    code = 0
    prev_len = 0
    for s in syms:
        code <<= int(lengths[s]) - prev_len
        codes[s] = code
        code += 1
        prev_len = int(lengths[s])
    return codes


def encode(data: bytes | np.ndarray) -> bytes:
    """Entropy-encode a byte stream. Byte-exact vs qr_entropy_encode."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = arr.size
    hist = np.bincount(arr, minlength=256).astype(np.uint64)
    lengths = _huffman_lengths(hist)
    total_bits = int(np.sum(hist * lengths.astype(np.uint64)))
    payload_bytes = (total_bits + 7) // 8
    if payload_bytes >= n:  # stored mode
        return _HEADER.pack(_MAGIC, 1, 1, n) + arr.tobytes()
    codes = _canonical_codes(lengths)
    # Vectorized MSB-first bit packing: row i holds the bits of symbol i's
    # code left-aligned in max_len columns; mask selects the valid ones in
    # row-major (stream) order.
    max_len = int(lengths.max())
    sym_len = lengths[arr].astype(np.int32)  # [n]
    sym_code = codes[arr].astype(np.uint32)  # [n]
    bitpos = np.arange(max_len, dtype=np.int32)  # [L]
    shift = sym_len[:, None] - 1 - bitpos[None, :]  # [n, L]
    valid = shift >= 0
    bits = (sym_code[:, None] >> np.maximum(shift, 0)) & 1
    stream = bits[valid].astype(np.uint8)
    payload = np.packbits(stream)  # MSB-first within each byte
    return (
        _HEADER.pack(_MAGIC, 1, 0, n)
        + lengths.tobytes()
        + payload.tobytes()
    )


def decoded_size(comp: bytes) -> int:
    magic, version, _flags, n = _HEADER.unpack_from(comp, 0)
    if magic != _MAGIC or version != 1:
        raise ValueError("bad QREF header")
    return n


_TABLE_BITS = 24   # longest code the table decoder takes (2^24 entries)
_CHUNK_BITS = 1 << 20   # bit positions decoded per pass (bounds the memory)


def _decode_table(lengths: np.ndarray, payload: np.ndarray, n: int) -> bytes:
    """Table-driven canonical-Huffman decode, vectorized, in chunks of
    ``_CHUNK_BITS`` bit positions: the symbol and code length starting at
    every position of a chunk come from one lookup of the next ``max_len``
    bits; the chain of symbol starts p, p + len(p), ... inside the chunk is
    found by pointer doubling (log2 of the chunk's gathers) instead of a
    Python loop over bits, and the position after the chunk's last symbol
    starts the next chunk. Memory is the table (2^max_len entries) plus
    about 30 bytes per position of one chunk, whatever the blob's size."""
    max_len = int(lengths.max())
    codes = _canonical_codes(lengths)
    size = 1 << max_len
    t_sym = np.zeros(size, np.uint8)
    t_len = np.zeros(size, np.uint8)       # 0: no code (an invalid stream)
    for s in np.nonzero(lengths)[0]:
        sh = max_len - int(lengths[s])
        lo = int(codes[s]) << sh
        t_sym[lo:lo + (1 << sh)] = s
        t_len[lo:lo + (1 << sh)] = lengths[s]
    out = np.empty(n, np.uint8)
    total = payload.size * 8
    p = done = 0                           # absolute bit position, symbols
    while done < n:
        if p >= total:
            raise ValueError("truncated bitstream")
        b0 = p >> 3
        bits = np.unpackbits(payload[b0:b0 + (_CHUNK_BITS + max_len) // 8 + 2])
        bits = np.concatenate([bits[p - 8 * b0:], np.zeros(max_len, np.uint8)])
        nb = min(_CHUNK_BITS, bits.size - max_len)
        window = np.zeros(nb, np.int32)
        for j in range(max_len):
            window = (window << 1) | bits[j:j + nb]
        step = t_len[window]
        # nb is the sentinel: the chain left the chunk or met no code
        nxt = np.where(step > 0, np.minimum(
            np.arange(nb, dtype=np.int32) + step, nb), nb).astype(np.int32)
        nxt = np.append(nxt, np.int32(nb))
        pos = np.zeros(1, np.int32)
        while pos.size < n - done and pos[-1] < nb:
            pos = np.concatenate([pos, nxt[pos]])
            nxt = nxt[nxt]
        pos = pos[pos < nb][:n - done]
        if not step[pos].all():
            raise ValueError("invalid code in bitstream")
        out[done:done + pos.size] = t_sym[window[pos]]
        done += pos.size
        p += int(pos[-1]) + int(step[pos[-1]])
    if p > total:
        raise ValueError("truncated bitstream")
    return out.tobytes()


def decode(comp: bytes) -> bytes:
    """Entropy-decode a QREF frame (Python fallback; C++ path is faster)."""
    magic, version, flags, n = _HEADER.unpack_from(comp, 0)
    if magic != _MAGIC or version != 1:
        raise ValueError("bad QREF header")
    off = _HEADER.size
    if flags & 1:  # stored
        return comp[off : off + n]
    lengths = np.frombuffer(comp[off : off + 256], dtype=np.uint8)
    off += 256
    if n == 0:
        return b""
    max_len = int(lengths.max())
    if max_len <= _TABLE_BITS:
        return _decode_table(
            lengths, np.frombuffer(comp, dtype=np.uint8, offset=off), n)
    sorted_syms: list[int] = []
    first_code = np.zeros(max_len + 2, dtype=np.uint64)
    first_idx = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    idx = 0
    for L in range(1, max_len + 1):
        code <<= 1
        first_code[L] = code
        first_idx[L] = idx
        members = [s for s in range(256) if lengths[s] == L]
        sorted_syms.extend(members)
        code += len(members)
        idx += len(members)
    first_idx[max_len + 1] = idx
    bits = np.unpackbits(np.frombuffer(comp[off:], dtype=np.uint8))
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    code = 0
    L = 0
    produced = 0
    nbits = bits.size
    fc = first_code
    fi = first_idx
    while produced < n:
        if pos >= nbits:
            raise ValueError("truncated bitstream")
        code = (code << 1) | int(bits[pos])
        pos += 1
        L += 1
        cnt = int(fi[L + 1] - fi[L]) if L <= max_len else 0
        if cnt > 0 and fc[L] <= code < int(fc[L]) + cnt:
            out[produced] = sorted_syms[int(fi[L]) + code - int(fc[L])]
            produced += 1
            code = 0
            L = 0
        elif L > max_len:
            raise ValueError("invalid code in bitstream")
    return out.tobytes()
