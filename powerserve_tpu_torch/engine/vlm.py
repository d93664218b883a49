"""Vision-language generation for one sequence (the JAX package's
engine/vlm.py).

The prefill embeds the expanded prompt with the projected image features
at the image-context positions and runs one forward over all of it,
eagerly; the first token is the argmax of its last logits. Decode is the
InferenceEngine's greedy block over the same cache (engine/generator.py:
each step a replayed CUDA graph on the card). Greedy only, as in the JAX
engine: the sampler settings are not applied.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from ..core.config import HyperParams, SamplerConfig
from ..core.device import resolve_device
from ..core.logging import Timer
from ..models.internvl import InternVLModel, preprocess_image
from .generator import GenerationStats, InferenceEngine


class VLMEngine:
    """One slot over the model's language half; `device` defaults to
    cuda."""

    def __init__(self, model: InternVLModel, hp: HyperParams | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        hp = dataclasses.replace(hp or HyperParams(), max_slots=1,
                                 sampler=SamplerConfig(temperature=0.0))
        self.engine = InferenceEngine(model.llm, model.cfg, hp,
                                      device=self.device)
        self.max_seq = self.engine.max_seq
        self.vocab = model.cfg.llm.vocab_size

    @property
    def kv(self):
        return self.engine.kv

    def reset(self) -> None:
        self.engine.reset(0)

    def pixel_values(self, images: list, max_tiles: int = 12) -> np.ndarray:
        """Uint8 images -> f32 [tiles, 3, size, size], image after image."""
        return np.concatenate([preprocess_image(
            img, tile=self.model.image_size, max_num=max_tiles)
            for img in images], axis=0)

    @torch.no_grad()
    def generate(self, prompt_ids: list[int], images: list | None,
                 n_predict: int,
                 stop_fn: Callable[[int], bool] | None = None,
                 max_tiles: int = 12,
                 stats: GenerationStats | None = None) -> Iterator[int]:
        """prompt_ids may hold ONE image placeholder (the model's
        image_token_id), where every image's tiles go (else they lead the
        prompt); images are uint8 arrays [H, W(, C)]."""
        stats = stats if stats is not None else GenerationStats()
        px = None
        if images:
            px = self.pixel_values(images, max_tiles)
            prompt_ids = self.model.expand_image_tokens(list(prompt_ids),
                                                        px.shape[0])
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt ({len(prompt_ids)}) exceeds context "
                             f"({self.max_seq})")
        self.reset()
        timer = Timer()
        logits = self.model.prefill_multimodal(self.kv, prompt_ids, px)
        cur = int(torch.argmax(logits[0, :self.vocab]))
        stats.prefill_tokens += len(prompt_ids)
        stats.prefill_ms += timer.elapsed_time_ms()
        yield cur
        if stop_fn is not None and stop_fn(cur):
            return
        yield from self.engine.decode(cur, n_predict - 1, stop_fn, 0, stats,
                                      list(prompt_ids) + [cur])
