"""UGM `precompiled_charsmap` normalization (sentencepiece format).

T5/Unigram GGUF vocabs carry `tokenizer.ggml.precompiled_charsmap`: a
binary blob holding sentencepiece's compiled normalizer — an
XOR-compressed compact double array (XCDA, Kanda 2018) mapping input
byte prefixes to replacement strings (typically an NFKC-style table),
followed by the NUL-terminated replacement pool. The reference applies
it through vendored llama.cpp (llm_tokenizer_ugm::normalize,
libs/llama_tokenizer/llama-vocab.cpp:1233-1390); HF `tokenizers` ships
the same walker as `normalizers.Precompiled`. This module is a
from-scratch Python implementation of both directions:

  - `Charsmap.from_blob` / `normalize`: parse + longest-prefix trie
    walk + the whitespace escaping/merging/prefix semantics.
  - `build_charsmap`: encode a {prefix: replacement} table into a
    valid blob (double-array construction) — used by the conformance
    tests to round-trip against HF's `normalizers.Precompiled`, and by
    workspace tooling to synthesize normalizers.

Blob layout: uint32 xcda_size | xcda_size bytes of uint32 entries |
replacement pool. Packed entry bits: 0-7 LCHECK (edge byte), 8 LEAF,
9 BASE shift flag (<<8 when set), 10-30 BASE, 31 set on value nodes
(which store a replacement-pool offset in bits 0-30).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["Charsmap", "build_charsmap"]

_REPLACEMENT_CHAR = b"\xef\xbf\xbd"  # U+FFFD
_ESCAPED_SPACE = "▁"


def _utf8_char_len(b0: int) -> int:
    """Length of a UTF-8 sequence from its first byte; 0 if invalid."""
    if b0 < 0x80:
        return 1
    if 0xC2 <= b0 <= 0xDF:
        return 2
    if 0xE0 <= b0 <= 0xEF:
        return 3
    if 0xF0 <= b0 <= 0xF4:
        return 4
    return 0


class Charsmap:
    """Parsed precompiled_charsmap: XCDA trie + replacement pool."""

    def __init__(self, xcda: np.ndarray, pool: bytes):
        self.xcda = xcda  # uint32 [n]
        self.pool = pool

    @classmethod
    def from_blob(cls, blob: bytes) -> "Charsmap":
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (xcda_size,) = struct.unpack_from("<I", blob, 0)
        if 4 + xcda_size > len(blob) or xcda_size % 4:
            raise ValueError("charsmap blob xcda size out of bounds")
        xcda = np.frombuffer(blob, np.uint32, count=xcda_size // 4,
                             offset=4).copy()
        return cls(xcda, blob[4 + xcda_size:])

    # -- XCDA node accessors (packed-bit layout in the module doc) ----------

    def _node(self, i: int) -> int:
        if i >= len(self.xcda):
            return 0xFFFFFFFF  # out of bounds: lcheck can never match
        return int(self.xcda[i])

    def _base(self, i: int) -> int:
        p = self._node(i)
        return (p >> 10) << ((p & (1 << 9)) >> 6)

    def _lcheck(self, i: int) -> int:
        return self._node(i) & ((1 << 31) | 0xFF)

    def _leaf(self, i: int) -> bool:
        return bool((self._node(i) >> 8) & 1)

    def _value(self, i: int) -> int:
        return self._node(i) & ((1 << 31) - 1)

    # -- prefix normalization ----------------------------------------------

    def longest_prefix(self, data: bytes, off: int) -> tuple[int, int]:
        """Walk the trie from `off`: returns (matched_len,
        pool_offset) of the LONGEST matching prefix (0, -1 if none)."""
        best_len, best_off = 0, -1
        if not len(self.xcda):
            return best_len, best_off
        node = self._base(0)
        for i in range(off, len(data)):
            c = data[i]
            if c == 0:
                break
            node ^= c
            if self._lcheck(node) != c:
                break
            is_leaf = self._leaf(node)
            node ^= self._base(node)
            if is_leaf:
                best_len = i - off + 1
                best_off = self._value(node)
        return best_len, best_off

    def _replacement(self, pool_off: int) -> bytes:
        end = self.pool.index(b"\x00", pool_off)
        return self.pool[pool_off:end]

    def normalize_prefix(self, data: bytes, off: int) -> tuple[bytes, int]:
        """(normalized bytes, consumed input bytes) for the prefix at
        `off` — longest charsmap match, else one valid UTF-8 char
        unmodified, else one byte as U+FFFD."""
        n, pool_off = self.longest_prefix(data, off)
        if n > 0:
            return self._replacement(pool_off), n
        ln = _utf8_char_len(data[off])
        if ln and off + ln <= len(data):
            seq = data[off:off + ln]
            if all(0x80 <= b <= 0xBF for b in seq[1:]):
                return seq, ln
        return _REPLACEMENT_CHAR, 1

    def normalize(self, text: str, *, prepend_space: bool = True,
                  append_space: bool = False, merge_spaces: bool = False,
                  escape_spaces: bool = True,
                  specials: list[str] | None = None) -> str:
        """Full UGM normalization (reference normalize() semantics):
        per-prefix replacement, then whitespace handling — spaces
        escape to U+2581, a space is prepended before the first
        non-space (add_space_prefix), runs of spaces merge when
        remove_extra_whitespaces. `specials`: user-defined token
        strings passed through unnormalized (longest-first)."""
        data = text.encode("utf-8")
        sp = (_ESCAPED_SPACE if escape_spaces else " ").encode()
        out = bytearray()
        is_space_prepended = False
        processing_non_ws = False
        specials_b = [s.encode() for s in (specials or [])]
        off = 0
        while off < len(data):
            rep = None
            for s in specials_b:
                if data.startswith(s, off):
                    rep, consumed = s, len(s)
                    break
            if rep is None:
                rep, consumed = self.normalize_prefix(data, off)
            for c in rep:
                if c != 0x20:
                    if not processing_non_ws:
                        processing_non_ws = True
                        if ((prepend_space and not is_space_prepended)
                                or merge_spaces):
                            out += sp
                            is_space_prepended = True
                    out.append(c)
                else:
                    if processing_non_ws:
                        processing_non_ws = False
                    if not merge_spaces:
                        out += sp
            off += consumed
        if append_space:
            out += sp
        return out.decode("utf-8", errors="replace")


def build_charsmap(table: dict[str, str]) -> bytes:
    """Encode {prefix: replacement} into a precompiled_charsmap blob.

    Double-array construction: each trie node n gets an address value
    X_n; the edge for byte c from node n lands at slot X_n ^ c, whose
    packed entry stores LCHECK=c, the LEAF flag, and BASE = slot ^
    X_child (so the walker's `node ^= base` lands on X_child). A node
    with a replacement additionally owns a value entry AT slot X_child
    (bit 31 | pool offset) — reachable because the walker reads the
    value at `node` after the base XOR. X values are chosen greedily
    to avoid slot collisions."""
    # trie over utf-8 byte strings
    root: dict = {}
    values: dict[bytes, int] = {}
    pool = bytearray()
    for k, v in sorted(table.items()):
        kb, vb = k.encode(), v.encode()
        values[kb] = len(pool)
        pool += vb + b"\x00"
        node = root
        for b in kb:
            node = node.setdefault(b, {})

    # assign X values: BFS; slot of child = X_parent ^ c must be free,
    # nodes with values also occupy slot X_node itself, and X values
    # must be UNIQUE across nodes — two nodes sharing an address would
    # falsely match each other's children (lcheck only stores the edge
    # byte, so parentage is encoded entirely in the address)
    entries: dict[int, int] = {}  # slot -> packed
    used: set[int] = {0}
    x_values: set[int] = set()

    def place(node: dict, prefix: bytes) -> int:
        """Pick X for `node`, reserving its value slot (if any) and its
        children's edge slots; returns X."""
        has_val = prefix in values
        x = 1
        while (x in x_values
               or (has_val and x in used)
               or any((x ^ c) in used or (x ^ c) == 0 for c in node)):
            x += 1
        x_values.add(x)
        if has_val:
            used.add(x)
            entries[x] = (1 << 31) | values[prefix]
        for c in node:
            used.add(x ^ c)
        return x

    from collections import deque

    x_root = place(root, b"")
    queue = deque([(root, b"", x_root)])
    while queue:
        node, prefix, x = queue.popleft()
        for c, child in node.items():
            slot = x ^ c
            child_prefix = prefix + bytes([c])
            x_child = place(child, child_prefix)
            is_leaf = child_prefix in values
            base = slot ^ x_child
            assert base < (1 << 21), "BASE overflow in test builder"
            entries[slot] = (base << 10) | (int(is_leaf) << 8) | c
            queue.append((child, child_prefix, x_child))

    # size must cover every PROBE, not just every entry: a walker at
    # node X tests slot X ^ c for arbitrary input bytes c (HF's
    # spm_precompiled indexes unchecked), so pad to max(X) | 0xFF
    size = max(max(entries.keys(), default=0),
               max((x | 0xFF for x in x_values), default=0)) + 1
    xcda = np.full(size, 0xFFFFFFFF, np.uint32)  # lcheck never matches
    xcda[0] = np.uint32(x_root << 10)  # root entry: BASE = X_root
    for slot, packed in entries.items():
        if slot != 0:
            xcda[slot] = np.uint32(packed)
    blob = struct.pack("<I", size * 4) + xcda.tobytes() + bytes(pool)
    return blob
