"""Config system mirroring the reference's JSON workspace layout.

The reference resolves workspace.json -> {model_main, model_draft,
hparams_config} and per-model model.json / hparams.json (reference
src/core/config.hpp:33-146, config.cpp:16-130). We keep the same file
names and keys so reference workspaces port over unchanged, and extend
`HyperParams` with runtime knobs (mesh shape, max slots, KV dtype).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# workspace.json keys (reference config.hpp:24-31)
KEY_MODEL_MAIN = "model_main"
KEY_MODEL_DRAFT = "model_draft"
KEY_HPARAMS = "hparams_config"
MODEL_CONFIG_FILENAME = "model.json"
WORKSPACE_CONFIG_FILENAME = "workspace.json"
MODEL_WEIGHTS_FILENAME = "weights.gguf"
MODEL_VOCAB_FILENAME = "vocab.gguf"


def _cfg_hash(self) -> int:
    return hash(dataclasses.astuple(self))


@dataclass
class RopeConfig:
    """Reference config.hpp:38-47 rope params."""

    n_dims: int = 128
    n_ctx_orig: int = 2048
    freq_base: float = 10000.0
    freq_scale: float = 1.0
    ext_factor: float = 0.0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    rope_type: int = 0  # 0 = NORM (rotate pairs), 2 = NEOX (rotate halves)
    # frequency-factor scaling (HF `rope_scaling` / ggml freq_factors):
    # "none" | "llama3"; llama3 divides per-dim frequencies following
    # Llama-3.1's wavelength-banded recipe. "linear" maps to freq_scale
    # and "yarn" to ext_factor/beta_* above (ggml.c:15319-15365).
    scaling_type: str = "none"
    scaling_factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0


@dataclass
class LLMConfig:
    """Transformer dims (reference ModelConfig::LLMConfig, config.hpp:49-80)."""

    dim: int = 2048  # embedding / hidden size
    hidden_dim: int = 5632  # ffn intermediate
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    head_size: int = 64
    seq_len: int = 2048  # max context
    vocab_size: int = 32000
    kv_dim: int = 256  # n_kv_heads * head_size
    rope: RopeConfig = field(default_factory=RopeConfig)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # mixture-of-experts (mixtral / qwen3moe): per-layer FFN becomes
    # n_experts expert FFNs of width hidden_dim, n_experts_used active
    # per token (0 = dense FFN)
    n_experts: int = 0
    n_experts_used: int = 0

    def __post_init__(self) -> None:
        if self.head_size * self.n_kv_heads != self.kv_dim:
            self.kv_dim = self.head_size * self.n_kv_heads


# value-based hash so configs can be jit static args (the @dataclass
# decorator nulls __hash__ when eq is auto-generated)
RopeConfig.__hash__ = _cfg_hash
LLMConfig.__hash__ = _cfg_hash


@dataclass
class ModelConfig:
    """Per-model model.json (reference config.cpp:54-106)."""

    arch: str = "llama"  # llama | qwen2 | internvl
    version: int = 1
    llm: LLMConfig = field(default_factory=LLMConfig)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ModelConfig":
        llm_d = dict(d.get("llm", {}))
        rope_d = llm_d.pop("rope", {})
        known_rope = {f.name for f in dataclasses.fields(RopeConfig)}
        rope = RopeConfig(**{k: v for k, v in rope_d.items() if k in known_rope})
        known_llm = {f.name for f in dataclasses.fields(LLMConfig)} - {"rope"}
        llm = LLMConfig(rope=rope, **{k: v for k, v in llm_d.items() if k in known_llm})
        return cls(arch=d.get("model_arch", d.get("arch", "llama")),
                   version=int(d.get("version", 1)), llm=llm)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model_arch"] = d.pop("arch")
        return d

    @classmethod
    def load(cls, path: str | os.PathLike) -> "ModelConfig":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


@dataclass
class SamplerConfig:
    """Reference HyperParams::SamplerConfig (config.hpp:96-118)."""

    seed: int = 0
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_keep: int = 1
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    penalize_nl: bool = False
    ignore_eos: bool = False


@dataclass
class HyperParams:
    """hparams.json + runtime knobs (reference config.hpp:82-146)."""

    batch_size: int = 128  # prefill chunk size
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    # --- runtime knobs (no reference counterpart) ---
    max_slots: int = 8  # continuous-batching rows
    max_seq_len: int = 0  # 0 = model seq_len
    kv_dtype: str = "int8"  # int8 | bf16
    mesh_shape: dict[str, int] = field(default_factory=dict)  # e.g. {"tp": 4}
    kernel_backend: str = "auto"  # auto | pallas | xla
    decode_horizon: int = 4  # decode steps per device dispatch (scheduler)
    # guarantee decoding slots a tick at least every N scheduler
    # iterations even while prefill traffic is continuous (anti-
    # starvation; 1 = decode every tick)
    decode_every: int = 2
    spec_horizon: int = 2  # speculative steps per device dispatch
    spec_k: int = 4  # chain length (draft tokens per spec step)
    # speculation-tree widths per depth, e.g. "2,1,1" (node at depth d
    # gets widths[d] children); "" = chain of length spec_k
    spec_tree: str = ""
    # factor the DRAFT's lm_head to this rank at load time
    # (speculative/draft_head.py): ~7x fewer draft-head HBM bytes at
    # 512 — the measured per-draft bottleneck. Lossless for the emitted
    # stream; trades acceptance rate. 0 = exact draft head.
    draft_head_rank: int = 0
    prefix_cache: int = 4  # cached prompt prefixes per scheduler (0 = off)
    prefix_cache_min: int = 16  # shortest prefix worth caching (tokens)
    # paged KV pool (kv/paged.py): > 0 = slots share this many pages
    # instead of each reserving max_seq (memory oversubscription with
    # deferred admission + recompute preemption); 0 = dense per-slot KV
    paged_pages: int = 0
    page_size: int = 64  # tokens per page (paged mode)
    # tree-speculation verification: True = SpecInfer-style sampled-
    # without-replacement children + recursive rejection (lossless,
    # higher acceptance on flat dists); False = greedy top-k children +
    # exact-match acceptance
    spec_wor: bool = False

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "HyperParams":
        s = d.get("sampler", {})
        known_s = {f.name for f in dataclasses.fields(SamplerConfig)}
        sampler = SamplerConfig(**{k: v for k, v in s.items() if k in known_s})
        known = {f.name for f in dataclasses.fields(cls)} - {"sampler"}
        return cls(sampler=sampler, **{k: v for k, v in d.items() if k in known})

    @classmethod
    def load(cls, path: str | os.PathLike) -> "HyperParams":
        with open(path) as f:
            return cls.from_json(json.load(f))


@dataclass
class WorkspaceConfig:
    """workspace.json resolution (reference config.cpp:108-130)."""

    root: Path
    main_model_dir: Path
    draft_model_dir: Path | None
    hyper_params: HyperParams

    @classmethod
    def load(cls, workspace_dir: str | os.PathLike) -> "WorkspaceConfig":
        root = Path(workspace_dir)
        with open(root / WORKSPACE_CONFIG_FILENAME) as f:
            ws = json.load(f)
        main_dir = root / ws[KEY_MODEL_MAIN]
        draft = ws.get(KEY_MODEL_DRAFT) or None
        draft_dir = root / draft if draft else None
        hp_path = root / ws.get(KEY_HPARAMS, "hparams.json")
        hp = HyperParams.load(hp_path) if hp_path.exists() else HyperParams()
        return cls(root, main_dir, draft_dir, hp)
