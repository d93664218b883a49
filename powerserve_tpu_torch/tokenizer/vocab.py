"""Tokenizer over GGUF vocab metadata — a from-scratch implementation of
the SPM and byte-level-BPE algorithms the reference gets from its
vendored llama.cpp vocab (reference src/tokenizer/tokenizer.cpp:22-60,
libs/llama_tokenizer/llama-vocab.cpp).

Supported vocab models (tokenizer.ggml.model):
  - "bert": WordPiece (WPM) — greedy longest-match with BERT
    normalization and [CLS]/[SEP] wrapping (reference llama-vocab.cpp
    llm_tokenizer_wpm)
  - "t5": Unigram (UGM) — Viterbi max-score segmentation with fused
    UNK runs (reference llm_tokenizer_ugm), with the
    precompiled_charsmap normalizer applied when the GGUF carries one
    (tokenizer/charsmap.py: XCDA trie walk + whitespace semantics)
  - "llama": SentencePiece-style BPE driven by per-token scores, with
    byte fallback (<0xNN> tokens) and the U+2581 space convention.
  - "gpt2": byte-level BPE driven by a merge list, with the GPT-2
    byte<->unicode mapping and a llama3-style pre-tokenization regex.

The SPM and BPE merge loops run in C++ (core/native.py NativeVocab, made
at a vocab's first encode), as in the JAX package; the Python loops
(_spm_encode_fragment_py, _bpe_encode_word_py) are their twins, which
the tests hold the C++ loop to.
"""

from __future__ import annotations

import heapq
import re
import threading
from dataclasses import dataclass, field
from typing import Any

try:  # proper \p{L}/\p{N} unicode classes (transformers dependency)
    import regex as _regex
except ImportError:  # pragma: no cover - regex ships with transformers
    _regex = None

# token_type values (gguf tokenizer.ggml.token_type)
TT_NORMAL = 1
TT_UNKNOWN = 2
TT_CONTROL = 3
TT_USER_DEFINED = 4
TT_UNUSED = 5
TT_BYTE = 6

_SPM_SPACE = "▁"  # ▁

# a vocab's C++ merge loop is made once, whichever thread encodes first
_NATIVE_LOCK = threading.Lock()


def _gpt2_byte_to_unicode() -> dict[int, str]:
    """The GPT-2 printable-byte mapping (public algorithm)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_TO_UNI = _gpt2_byte_to_unicode()
_UNI_TO_BYTE = {u: b for b, u in _BYTE_TO_UNI.items()}

# llama3-family pre-tokenizer regex, \w-approximated fallback when the
# `regex` module is unavailable
_PRETOK_RE = re.compile(
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\w]?\w+"
    r"|\d{1,3}"
    r"| ?[^\s\w\d]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+",
    re.UNICODE,
)

# per-family pre-tokenizer regexes (tokenizer.ggml.pre; public patterns
# from the GPT-2 / Llama-3 / Qwen2 tokenizers — reference gets these
# from vendored llama.cpp's pre-tokenizer table)
_PRETOK_FAMILY = {
    "gpt-2": (r"'s|'t|'re|'ve|'m|'ll|'d"
              r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"),
    "llama3": (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
               r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
               r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
    "qwen2": (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
              r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"),
}
_PRETOK_ALIASES = {
    "gpt2": "gpt-2", "starcoder": "gpt-2", "falcon": "gpt-2",
    "llama-bpe": "llama3", "llama-v3": "llama3", "smaug-bpe": "llama3",
    "deepseek-llm": "qwen2", "deepseek-coder": "qwen2", "stablelm2": "qwen2",
}


def _pretok_regex(pre: str):
    """Compiled pre-tokenizer for a tokenizer.ggml.pre family name.
    Missing/unknown pre falls back to the GPT-2 pattern — llama.cpp's
    LLAMA_VOCAB_PRE_TYPE_DEFAULT does the same (llama3-family GGUFs
    carry pre="llama-bpe")."""
    if _regex is None:
        return _PRETOK_RE
    fam = _PRETOK_ALIASES.get(pre, pre)
    pat = _PRETOK_FAMILY.get(fam, _PRETOK_FAMILY["gpt-2"])
    return _regex.compile(pat)


@dataclass
class GGUFVocab:
    tokens: list[str]
    scores: list[float] | None
    token_types: list[int] | None
    merges: list[str] | None
    model: str  # "llama" (spm) | "gpt2" (bpe) | "bert" (wpm) | "t5" (ugm)
    pre: str = ""  # pre-tokenizer family (tokenizer.ggml.pre)
    bos_id: int = -1
    eos_id: int = -1
    eot_id: int = -1
    eom_id: int = -1
    unk_id: int = -1
    pad_id: int = -1
    cls_id: int = -1  # WPM/BERT classifier start token
    sep_id: int = -1  # WPM/BERT separator end token
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    remove_extra_ws: bool = False  # tokenizer.ggml.remove_extra_whitespaces
    # parsed precompiled_charsmap (charsmap.Charsmap); from_metadata gives
    # an empty one to a t5 vocab that removes extra whitespace without one
    charsmap: Any = None
    chat_template: str = ""
    token_to_id: dict[str, int] = field(default_factory=dict)
    _merge_ranks: dict[tuple[str, str], int] = field(default_factory=dict)
    _byte_tokens: dict[int, int] = field(default_factory=dict)
    _special: list[tuple[str, int]] = field(default_factory=list)
    _native_vocab: Any = field(default=None, repr=False, compare=False)

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "GGUFVocab":
        tokens = [str(t) for t in md["tokenizer.ggml.tokens"]]
        scores = md.get("tokenizer.ggml.scores")
        scores = [float(s) for s in scores] if scores is not None else None
        tt = md.get("tokenizer.ggml.token_type")
        tt = [int(t) for t in tt] if tt is not None else None
        merges = md.get("tokenizer.ggml.merges")
        merges = [str(m) for m in merges] if merges is not None else None
        v = cls(
            tokens=tokens, scores=scores, token_types=tt, merges=merges,
            model=str(md.get("tokenizer.ggml.model", "llama")),
            pre=str(md.get("tokenizer.ggml.pre", "")),
            bos_id=int(md.get("tokenizer.ggml.bos_token_id", -1)),
            eos_id=int(md.get("tokenizer.ggml.eos_token_id", -1)),
            eot_id=int(md.get("tokenizer.ggml.eot_token_id", -1)),
            eom_id=int(md.get("tokenizer.ggml.eom_token_id", -1)),
            unk_id=int(md.get("tokenizer.ggml.unknown_token_id", -1)),
            pad_id=int(md.get("tokenizer.ggml.padding_token_id", -1)),
            cls_id=int(md.get("tokenizer.ggml.cls_token_id", -1)),
            sep_id=int(md.get("tokenizer.ggml.seperator_token_id", -1)),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", True)),
            add_eos=bool(md.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", True)),
            remove_extra_ws=bool(
                md.get("tokenizer.ggml.remove_extra_whitespaces", False)),
            chat_template=str(md.get("tokenizer.chat_template", "")),
        )
        csm = md.get("tokenizer.ggml.precompiled_charsmap")
        if csm is not None and len(csm):
            from .charsmap import Charsmap

            blob = csm.tobytes() if hasattr(csm, "tobytes") else bytes(csm)
            v.charsmap = Charsmap.from_blob(blob)
        elif v.model == "t5" and v.remove_extra_ws:
            # UGM whitespace normalization without replacements: an empty
            # charsmap, built here once (encode runs on many threads)
            import numpy as np

            from .charsmap import Charsmap

            v.charsmap = Charsmap(np.zeros(0, np.uint32), b"")
        v.token_to_id = {t: i for i, t in enumerate(tokens)}
        if merges:
            for rank, m in enumerate(merges):
                a, _, b = m.partition(" ")
                v._merge_ranks[(a, b)] = rank
        if tt:
            for i, t in enumerate(tt):
                if t == TT_BYTE:
                    s = tokens[i]
                    if s.startswith("<0x") and s.endswith(">"):
                        v._byte_tokens[int(s[3:-1], 16)] = i
        # specials sorted longest-first for greedy splitting
        specials = []
        for i, t in enumerate(tokens):
            if tt and tt[i] in (TT_CONTROL, TT_USER_DEFINED) and t:
                specials.append((t, i))
        v._special = sorted(specials, key=lambda x: -len(x[0]))
        return v

    # -- encoding -----------------------------------------------------------

    def _split_specials(self, text: str) -> list[tuple[str, int | None]]:
        """Split text into (fragment, special_id|None) pieces.
        Longest special wins (the list is sorted longest-first);
        iterative work stack, so pathological inputs can't hit the
        Python recursion limit."""
        out: list[tuple[str, int | None]] = []
        stack: list[tuple] = [("text", text)]
        while stack:
            kind, *rest = stack.pop()
            if kind == "emit":
                out.append((rest[0], rest[1]))
                continue
            s = rest[0]
            hit = None
            for tok, tid in self._special:
                idx = s.find(tok)
                if idx >= 0:
                    hit = (idx, tok, tid)
                    break
            if hit is None:
                if s:
                    out.append((s, None))
                continue
            idx, tok, tid = hit
            rest_s = s[idx + len(tok):]
            if rest_s:  # LIFO: push right first so left emits first
                stack.append(("text", rest_s))
            stack.append(("emit", tok, tid))
            if idx > 0:
                stack.append(("text", s[:idx]))
        return out

    def _merge_symbols(self, symbols: list[str], pair_key) -> list[str]:
        """Best-pair-first agglomerative merge with a heap + linked
        list: O(n log n) against the old O(n^2) rescan-per-merge (long
        perplexity corpora crawled there). pair_key(a, b) -> sortable
        priority or None; smallest priority merges first, leftmost on
        ties (matches the linear-scan semantics exactly)."""
        n = len(symbols)
        if n < 2:
            return symbols
        sym: list[str | None] = list(symbols)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        heap: list[tuple] = []

        def push(i: int) -> None:
            j = nxt[i]
            if i < 0 or j < 0:
                return
            pr = pair_key(sym[i], sym[j])
            if pr is not None:
                heapq.heappush(heap, (pr, i, sym[i] + sym[j]))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, cand = heapq.heappop(heap)
            j = nxt[i] if sym[i] is not None else -1
            if j < 0 or sym[i] is None or sym[j] is None \
                    or sym[i] + sym[j] != cand:
                continue  # stale entry
            sym[i] = cand
            sym[j] = None
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)
        return [s for s in sym if s is not None]

    def __getstate__(self):
        # copies and pickles make their own C++ vocab: the handle is not
        # theirs to free
        return {**self.__dict__, "_native_vocab": None}

    def _native(self):
        """The C++ merge loop over this vocabulary (core/native.py)."""
        if self._native_vocab is None:
            from ..core.native import NativeVocab

            with _NATIVE_LOCK:
                if self._native_vocab is None:
                    self._native_vocab = NativeVocab(
                        self.tokens, self.scores, self._byte_tokens,
                        self.unk_id, self.merges)
        return self._native_vocab

    def _spm_encode_fragment(self, text: str) -> list[int]:
        """Greedy score-based pair merging (SPM BPE semantics), by the C++
        merge loop."""
        if not text:
            return []
        return self._native().spm_encode(text.replace(" ", _SPM_SPACE))

    def _spm_encode_fragment_py(self, text: str) -> list[int]:
        """The Python twin of _spm_encode_fragment."""
        if not text:
            return []
        text = text.replace(" ", _SPM_SPACE)

        def pair_key(a: str, b: str):
            tid = self.token_to_id.get(a + b)
            if tid is None:
                return None
            sc = self.scores[tid] if self.scores else -len(a + b)
            return -sc  # max score first

        symbols = self._merge_symbols(list(text), pair_key)
        ids: list[int] = []
        for s in symbols:
            tid = self.token_to_id.get(s)
            if tid is not None:
                ids.append(tid)
            else:  # byte fallback
                for b in s.encode("utf-8"):
                    if b in self._byte_tokens:
                        ids.append(self._byte_tokens[b])
                    elif self.unk_id >= 0:
                        ids.append(self.unk_id)
        return ids

    def _bpe_encode_word(self, word: str) -> list[int]:
        """Merge-rank BPE on a byte-mapped word, by the C++ merge loop."""
        return self._native().bpe_encode(word)

    def _bpe_encode_word_py(self, word: str) -> list[int]:
        """The Python twin of _bpe_encode_word."""

        def pair_key(a: str, b: str):
            return self._merge_ranks.get((a, b))  # lowest rank first

        parts = self._merge_symbols([c for c in word], pair_key)
        ids = []
        for p in parts:
            tid = self.token_to_id.get(p)
            if tid is not None:
                ids.append(tid)
            elif self.unk_id >= 0:
                ids.append(self.unk_id)
        return ids

    def _bpe_encode_fragment(self, text: str) -> list[int]:
        ids: list[int] = []
        if not hasattr(self, "_pretok") or self._pretok is None:
            self._pretok = _pretok_regex(self.pre)
        for m in self._pretok.findall(text):
            mapped = "".join(_BYTE_TO_UNI[b] for b in m.encode("utf-8"))
            ids.extend(self._bpe_encode_word(mapped))
        return ids

    # -- WPM (BERT WordPiece; reference llama-vocab llm_tokenizer_wpm) ------

    @staticmethod
    def _wpm_preprocess(text: str) -> list[str]:
        """BERT normalization: NFD + strip combining marks, lowercase,
        split on whitespace, split out punctuation and CJK chars as
        their own words (llama-vocab.cpp llm_tokenizer_wpm::preprocess)."""
        import unicodedata

        norm = unicodedata.normalize("NFD", text)
        out: list[str] = []
        cur: list[str] = []

        def flush():
            if cur:
                out.append("".join(cur))
                cur.clear()

        for ch in norm:
            cat = unicodedata.category(ch)
            if cat.startswith("M"):  # combining mark: stripped
                continue
            ch = ch.lower()
            cp = ord(ch)
            cjk = (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                   or 0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2FFFF)
            if ch.isspace():
                flush()
            elif cat.startswith("P") or cat.startswith("S") or cjk:
                flush()
                out.append(ch)
            else:
                cur.append(ch)
        flush()
        return out

    def _wpm_encode_fragment(self, text: str) -> list[int]:
        """Greedy longest-match-first per word; a word with any
        unmatched position becomes one UNK (WordPiece semantics)."""
        ids: list[int] = []
        for word in self._wpm_preprocess(text):
            w = _SPM_SPACE + word  # GGUF BERT vocabs mark word starts
            n = len(w)
            word_ids: list[int] = []
            i = 0
            ok = True
            while i < n:
                best = None
                for j in range(n, i, -1):
                    tid = self.token_to_id.get(w[i:j])
                    if tid is not None:
                        best = (j, tid)
                        break
                if best is None:
                    ok = False
                    break
                i, tid = best
                word_ids.append(tid)
            if ok and word_ids:
                ids.extend(word_ids)
            elif self.unk_id >= 0:
                ids.append(self.unk_id)
        return ids

    # -- UGM (T5 Unigram; reference llama-vocab llm_tokenizer_ugm) ----------

    def _ugm_encode_fragment(self, text: str) -> list[int]:
        """Viterbi segmentation maximizing summed unigram scores.
        Unknown characters take unk_id at (min_score - 10) per char,
        and consecutive unknowns fuse into one UNK (llama-vocab.cpp
        unknown_token_score_penalty / merging). Callers pass already-
        normalized text when the vocab carries a precompiled_charsmap
        (encode()'s t5 branch); the " "->U+2581 replace below is then
        a no-op."""
        if not text:
            return []
        text = text.replace(" ", _SPM_SPACE)
        if not self.scores:
            return self._spm_encode_fragment(text)
        min_score = min(self.scores)
        unk_score = min_score - 10.0
        n = len(text)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        max_len = max((len(t) for t in self.tokens), default=1)
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for j in range(i + 1, min(n, i + max_len) + 1):
                tid = self.token_to_id.get(text[i:j])
                if tid is not None:
                    sc = best[i] + float(self.scores[tid])
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, tid)
            # unknown fallback: one char as UNK
            j = i + 1
            sc = best[i] + unk_score
            if sc > best[j]:
                best[j] = sc
                back[j] = (i, -1)
        ids_rev: list[int] = []
        pos = n
        while pos > 0:
            i, tid = back[pos]
            if tid < 0:
                tid = self.unk_id
                # fuse runs of unknown chars into ONE unk
                if ids_rev and ids_rev[-1] == tid:
                    pos = i
                    continue
            ids_rev.append(tid)
            pos = i
        return ids_rev[::-1]

    def encode(self, text: str, add_bos: bool | None = None,
               parse_special: bool = True) -> list[int]:
        ids: list[int] = []
        frags = self._split_specials(text) if parse_special else [(text, None)]
        first_normal = True
        for frag, tid in frags:
            if tid is not None:
                ids.append(tid)
                continue
            if self.model == "gpt2":
                ids.extend(self._bpe_encode_fragment(frag))
            elif self.model == "bert":
                ids.extend(self._wpm_encode_fragment(frag))
            elif self.model == "t5":
                if self.charsmap is not None:
                    # full UGM normalization (reference llm_tokenizer_ugm
                    # ::normalize): precompiled_charsmap replacements +
                    # space escape/prefix/merge — the Viterbi then runs
                    # on the normalized text directly
                    norm = self.charsmap.normalize(
                        frag,
                        prepend_space=(self.add_space_prefix
                                       and first_normal),
                        merge_spaces=self.remove_extra_ws,
                        specials=[t for t, _ in self._special])
                    ids.extend(self._ugm_encode_fragment(norm))
                else:
                    f = frag
                    if first_normal and self.add_space_prefix and f \
                            and not f.startswith(" "):
                        f = " " + f
                    ids.extend(self._ugm_encode_fragment(f))
            else:
                f = frag
                if first_normal and self.add_space_prefix and f and not f.startswith(" "):
                    f = " " + f
                ids.extend(self._spm_encode_fragment(f))
            first_normal = False
        if self.model == "bert":
            # BERT sequences: [CLS] ... [SEP] (reference wraps WPM
            # output the same way)
            if self.cls_id >= 0:
                ids = [self.cls_id] + ids
            if self.sep_id >= 0:
                ids = ids + [self.sep_id]
            return ids
        if add_bos is None:
            add_bos = self.add_bos
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if self.add_eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    # -- decoding -----------------------------------------------------------

    def decode_token(self, tid: int) -> str:
        t = self.tokens[tid]
        tt = self.token_types[tid] if self.token_types else TT_NORMAL
        if tt == TT_BYTE and t.startswith("<0x"):
            return chr(int(t[3:-1], 16))  # caller joins + re-encodes utf-8
        if tt in (TT_CONTROL, TT_UNKNOWN, TT_UNUSED):
            return ""
        if self.model == "gpt2":
            try:
                return bytes(_UNI_TO_BYTE[c] for c in t).decode(
                    "utf-8", errors="replace")
            except KeyError:
                return t
        return t.replace(_SPM_SPACE, " ")

    def decode(self, ids: list[int]) -> str:
        if self.model == "gpt2":
            bs = bytearray()
            for i in ids:
                t = self.tokens[i]
                tt = self.token_types[i] if self.token_types else TT_NORMAL
                if tt in (TT_CONTROL, TT_UNUSED):
                    continue
                try:
                    bs.extend(_UNI_TO_BYTE[c] for c in t)
                except KeyError:
                    bs.extend(t.encode("utf-8"))
            return bs.decode("utf-8", errors="replace")
        out = []
        bs = bytearray()
        for i in ids:
            t = self.tokens[i]
            tt = self.token_types[i] if self.token_types else TT_NORMAL
            if tt == TT_BYTE and t.startswith("<0x"):
                bs.append(int(t[3:-1], 16))
                continue
            if bs:
                out.append(bs.decode("utf-8", errors="replace"))
                bs = bytearray()
            if tt in (TT_CONTROL, TT_UNKNOWN, TT_UNUSED):
                continue
            out.append(t.replace(_SPM_SPACE, " "))
        if bs:
            out.append(bs.decode("utf-8", errors="replace"))
        text = "".join(out)
        if text.startswith(" ") and self.add_space_prefix:
            text = text[1:]
        return text
