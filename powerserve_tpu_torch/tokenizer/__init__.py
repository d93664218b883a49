"""Tokenizer facade (reference src/tokenizer/tokenizer.hpp:31-73).

Sources, in priority order:
  1. tokenizer.json in the model dir (HF `tokenizers` fast path)
  2. vocab.gguf / weights.gguf GGUF metadata (from-scratch SPM/BPE,
     vocab.py) — the reference's own format.
"""

from __future__ import annotations

import os
from pathlib import Path

from .chat_template import ChatMessage, apply_chat_template, detect_template
from .vocab import GGUFVocab


class Tokenizer:
    def __init__(self, vocab: GGUFVocab | None = None, hf_tokenizer=None,
                 chat_template: str = "", bos_id: int = -1, eos_id: int = -1,
                 stop_ids: set[int] | None = None, add_bos: bool = True):
        self.vocab = vocab
        self.hf = hf_tokenizer
        self.chat_template = chat_template
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.stop_ids = stop_ids or set()
        self.add_bos = add_bos

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_model_dir(cls, model_dir: str | os.PathLike) -> "Tokenizer":
        d = Path(model_dir)
        tj = d / "tokenizer.json"
        if tj.exists():
            return cls.from_hf_tokenizer_json(tj, d)
        for name in ("vocab.gguf", "weights.gguf"):
            p = d / name
            if p.exists():
                return cls.from_gguf(p)
        raise FileNotFoundError(f"no tokenizer source in {d}")

    @classmethod
    def from_gguf(cls, path: str | os.PathLike) -> "Tokenizer":
        from ..core.gguf import GGUFReader

        with GGUFReader(path) as r:
            vocab = GGUFVocab.from_metadata(r.metadata)
        stop = {i for i in (vocab.eos_id, vocab.eot_id, vocab.eom_id) if i >= 0}
        return cls(vocab=vocab, chat_template=vocab.chat_template,
                   bos_id=vocab.bos_id, eos_id=vocab.eos_id, stop_ids=stop,
                   add_bos=vocab.add_bos)

    @classmethod
    def from_hf_tokenizer_json(cls, path: str | os.PathLike,
                               model_dir: Path | None = None) -> "Tokenizer":
        import json

        from tokenizers import Tokenizer as HFTokenizer

        hf = HFTokenizer.from_file(str(path))
        chat_template = ""
        bos_id = eos_id = -1
        add_bos = False
        stop: set[int] = set()
        if model_dir is not None:
            cfg_p = model_dir / "tokenizer_config.json"
            if cfg_p.exists():
                cfg = json.loads(cfg_p.read_text())
                chat_template = cfg.get("chat_template") or ""

                def tok_id(v):
                    if isinstance(v, dict):
                        v = v.get("content")
                    if not v:
                        return -1
                    i = hf.token_to_id(v)
                    return -1 if i is None else i

                bos_id = tok_id(cfg.get("bos_token"))
                eos_id = tok_id(cfg.get("eos_token"))
                add_bos = bool(cfg.get("add_bos_token", False))
                if eos_id >= 0:
                    stop.add(eos_id)
                for name in ("<|eot_id|>", "<|im_end|>", "<|end|>", "<|eom_id|>"):
                    i = hf.token_to_id(name)
                    if i is not None:
                        stop.add(i)
        return cls(hf_tokenizer=hf, chat_template=chat_template,
                   bos_id=bos_id, eos_id=eos_id, stop_ids=stop,
                   add_bos=add_bos)

    # -- API (reference tokenizer.hpp:48-67) --------------------------------

    @property
    def n_vocab(self) -> int:
        if self.vocab is not None:
            return len(self.vocab.tokens)
        return self.hf.get_vocab_size()

    def tokenize(self, text: str, add_bos: bool | None = None,
                 parse_special: bool = True) -> list[int]:
        """parse_special=True (the reference server's behavior) encodes
        special-token strings appearing in `text` as their ids; pass
        False for untrusted user text that must not inject control
        tokens (the HF default)."""
        if self.vocab is not None:
            return self.vocab.encode(text, add_bos=add_bos,
                                     parse_special=parse_special)
        ids = self.hf.encode(text).ids
        use_bos = self.add_bos if add_bos is None else add_bos
        if use_bos and self.bos_id >= 0 and (not ids or ids[0] != self.bos_id):
            ids = [self.bos_id] + ids
        return ids

    def to_string(self, ids: list[int] | int) -> str:
        if isinstance(ids, int):
            ids = [ids]
        if self.vocab is not None:
            return self.vocab.decode(ids)
        return self.hf.decode(ids, skip_special_tokens=True)

    def should_stop(self, token_id: int) -> bool:
        return token_id in self.stop_ids

    def apply_chat_template(self, messages, add_assistant_prompt: bool = True
                            ) -> str:
        return apply_chat_template(messages, self.chat_template or "chatml",
                                   add_assistant_prompt)


__all__ = ["Tokenizer", "GGUFVocab", "ChatMessage", "apply_chat_template",
           "detect_template"]
