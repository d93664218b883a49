"""InternVL vision-language model: the JAX package's models/internvl.py.

  1. the prompt: one image placeholder expands to tokens_per_tile *
     n_tiles image-context ids (expand_image_tokens);
  2. the image: dynamic tiling into image_size tiles plus a thumbnail
     (preprocess_image, in core/image.py with the PNG decoder and
     Pillow's bicubic resize: no PIL);
  3. the vision tower and projector (models/vit.py) give one embedding
     row per image-context id;
  4. the text embeddings with those rows scattered over the image-context
     positions go through the language model's forward (embeds=).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device
# the image preprocessing is numpy only, in core/image.py (the server's
# image worker processes import no torch); re-exported here
from ..core.image import find_best_tile_grid, preprocess_image  # noqa: F401
from ..kv.cache import KVCache
from .llama import LlamaModel
from .vit import VisionParams, encode_images, vision_params_from_hf


@dataclass
class InternVLModel:
    """The vision tower + projector and the language model."""

    vision: VisionParams
    llm: LlamaModel
    cfg: ModelConfig
    image_token_id: int
    tokens_per_tile: int  # image_seq_length (256 for 448 / 14, ds 0.5)
    image_size: int = 448  # the vision tower's tile

    @property
    def device(self) -> torch.device:
        return self.llm.out_norm.device

    def expand_image_tokens(self, token_ids: list[int], n_tiles: int,
                            img_placeholder_id: int | None = None
                            ) -> list[int]:
        """Replace the first placeholder id with n_tiles * tokens_per_tile
        image-context ids; without a placeholder, prepend them."""
        pad = [self.image_token_id] * (n_tiles * self.tokens_per_tile)
        pid = (img_placeholder_id if img_placeholder_id is not None
               else self.image_token_id)
        if pid in token_ids:
            i = token_ids.index(pid)
            return token_ids[:i] + pad + token_ids[i + 1:]
        return pad + token_ids

    @torch.no_grad()
    def embed_multimodal(self, token_ids: torch.Tensor,
                         pixel_values: torch.Tensor | None) -> torch.Tensor:
        """[S, T] ids (+ [N, 3, H, W] pixels) -> f32 [S, T, dim]: the text
        embeddings, the k-th image-context id (row-major over [S, T])
        taking image feature row k (clipped to the last)."""
        embeds = self.llm.embed.lookup(token_ids)  # f32 [S, T, dim]
        if pixel_values is None:
            return embeds
        feats = encode_images(self.vision, pixel_values)  # [N, P, dim]
        flat = feats.reshape(-1, feats.shape[-1]).to(embeds.dtype)
        mask = token_ids == self.image_token_id
        idx = (torch.cumsum(mask.reshape(-1).long(), 0) - 1).clamp(
            0, flat.shape[0] - 1)
        repl = flat[idx].reshape(embeds.shape)
        return torch.where(mask[..., None], repl, embeds)

    @torch.no_grad()
    def prefill_multimodal(self, kv: KVCache, token_ids,
                           pixel_values) -> torch.Tensor:
        """Slot 0's multimodal prefill from position 0 (one forward over
        the whole prompt); the last token's logits f32 [1, vocab]. Inputs
        already on the device are used as they are: nothing is read
        back."""
        dev = self.device
        ids = torch.as_tensor(token_ids, device=dev).long().reshape(1, -1)
        px = (None if pixel_values is None else torch.as_tensor(
            pixel_values, dtype=torch.float32, device=dev))
        embeds = self.embed_multimodal(ids, px)
        positions = torch.arange(ids.shape[1], device=dev)[None]
        return self.llm(kv, ids, positions, logits_mode="last",
                        embeds=embeds)

    def to(self, device: str | torch.device) -> "InternVLModel":
        self.vision.to(device)
        self.llm.to(device)
        return self


def internvl_from_workspace(model_dir, device: str | torch.device | None = None,
                            mxu: bool = False) -> InternVLModel:
    """A VLM from a GGUF model dir, onto `device` (default cuda): the text
    weights from weights.gguf, the vision tower and projector from
    vision.gguf (HF tensor names, vlm.* metadata), as tools/convert_hf.py
    convert_internvl writes them (the JAX package's bytes). An HF
    checkpoint dir is converted first with that tool (`python -m
    powerserve_tpu_torch convert <hf dir> <out>`): the loader does not
    read checkpoints. mxu: the text model in the W8 format
    (load_gguf_model)."""
    from ..core.gguf import GGUFReader
    from .loader import load_gguf_model

    dev = resolve_device(device)
    model_dir = Path(model_dir)
    vision_path = model_dir / "vision.gguf"
    if not vision_path.exists():
        cfg_path = model_dir / "config.json"
        archs = (json.loads(cfg_path.read_text()).get("architectures", [])
                 if cfg_path.exists() else [])
        what = ("an HF InternVL checkpoint" if any("InternVL" in a
                                                   for a in archs)
                else "no vision.gguf")
        raise ValueError(f"{model_dir}: {what}; convert it to a GGUF "
                         f"workspace first (python -m powerserve_tpu_torch "
                         f"convert, tools/convert_hf.py convert_internvl)")
    cfg, llm = load_gguf_model(model_dir, device=dev, mxu=mxu)
    with GGUFReader(vision_path) as r:
        md = r.metadata
        sd = {name: r.tensor_float(name) for name in r.tensors}
        vision = vision_params_from_hf(
            sd, int(md["vlm.block_count"]),
            int(md["vlm.attention.head_count"]), int(md["vlm.patch_size"]),
            float(md["vlm.layer_norm_epsilon"]),
            float(md["vlm.downsample_ratio"]), device=dev)
        return InternVLModel(
            vision=vision, llm=llm, cfg=cfg,
            image_token_id=int(md["vlm.image_token_id"]),
            tokens_per_tile=int(md["vlm.image_seq_length"]),
            image_size=int(md["vlm.image_size"]))
