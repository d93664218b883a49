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
        """The tower's device (rank 0's over a rank group)."""
        return next(self.vision.buffers()).device

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
    convert_internvl writes them (the JAX package's bytes). mxu: the text
    model in the W8 format (load_gguf_model)."""
    dev = resolve_device(device)
    if vlm_source(model_dir) != "gguf":
        raise ValueError(f"{model_dir}: no vision.gguf (an HF InternVL "
                         f"checkpoint dir loads with internvl_from_hf_dir)")
    return load_internvl(model_dir, dev, mxu)


def vlm_source(model_dir) -> str | None:
    """What a VLM dir holds: "gguf" (vision.gguf beside weights.gguf, as
    convert writes them), "hf_internvl" (an HF InternVL checkpoint dir,
    by config.json's architectures as the JAX server tells one), or None
    (no VLM)."""
    d = Path(model_dir)
    if (d / "vision.gguf").exists():
        return "gguf"
    try:
        archs = json.loads((d / "config.json").read_text()).get(
            "architectures", [])
    except (OSError, json.JSONDecodeError):
        return None
    return "hf_internvl" if any("InternVL" in a for a in archs) else None


def load_vision(model_dir, device: str | torch.device | None = None
                ) -> tuple[VisionParams, dict]:
    """The vision tower and projector of a VLM dir onto `device` (default
    cuda), from vision.gguf or from an HF InternVL checkpoint's tensors,
    and the vlm.* metadata."""
    from ..core.gguf import GGUFReader
    from ..tools.convert_hf import read_internvl

    dev = resolve_device(device)
    if vlm_source(model_dir) == "gguf":
        with GGUFReader(Path(model_dir) / "vision.gguf") as r:
            md = dict(r.metadata)
            sd = {name: r.tensor_float(name) for name in r.tensors}
    else:
        _, _, sd, md = read_internvl(model_dir, text=False)
    return _vision_params(sd, md, dev), md


def _vision_params(sd: dict, md: dict, dev: torch.device) -> VisionParams:
    return vision_params_from_hf(
        sd, int(md["vlm.block_count"]), int(md["vlm.attention.head_count"]),
        int(md["vlm.patch_size"]), float(md["vlm.layer_norm_epsilon"]),
        float(md["vlm.downsample_ratio"]), device=dev)


def assemble_internvl(vision: VisionParams, md: dict, llm,
                      cfg: ModelConfig) -> InternVLModel:
    """The VLM of a tower (with its vlm.* metadata) and a language model
    (a LlamaModel, or a rank group's TPModel)."""
    return InternVLModel(vision=vision, llm=llm, cfg=cfg,
                         image_token_id=int(md["vlm.image_token_id"]),
                         tokens_per_tile=int(md["vlm.image_seq_length"]),
                         image_size=int(md["vlm.image_size"]))


def hf_text_reader(model_dir):
    """An HF InternVL checkpoint dir's text model as an in-memory
    weights.gguf (Q8_0, tools/convert_hf.py's layout) and its vision
    part: (GGUFReader, the tower's and projector's f32 tensors by HF
    name, the vlm.* metadata)."""
    from ..core.gguf import GGUFReader
    from ..tools.convert_hf import model_gguf, read_internvl

    flat, tsd, vsd, md = read_internvl(model_dir)
    w, _ = model_gguf(flat, sorted(tsd.items()), "q8_0")
    del tsd
    return GGUFReader.from_bytes(w.to_bytes(), str(model_dir)), vsd, md


def internvl_from_hf_dir(model_dir,
                         device: str | torch.device | None = None,
                         mxu: bool = False) -> InternVLModel:
    """A VLM from an HF InternVL checkpoint dir as it is (config.json and
    *.safetensors, read by tools/safetensors.py), onto `device` (default
    cuda): the JAX package's internvl_from_hf. The text weights are
    quantized to Q8_0 in memory (its params_from_hf_state_dict(...,
    fmt=Q8_0)); the vision tower and projector stay f32. mxu: the text
    model in the W8 format. The tokenizer is the dir's tokenizer.json
    (tokenizer.Tokenizer.from_model_dir)."""
    dev = resolve_device(device)
    if vlm_source(model_dir) != "hf_internvl":
        raise ValueError(f"{model_dir}: not an HF InternVL checkpoint dir")
    return load_internvl(model_dir, dev, mxu)


def load_internvl(model_dir, device: str | torch.device | None = None,
                  mxu: bool = False, text=None) -> InternVLModel:
    """A VLM from a GGUF workspace, or from an HF InternVL checkpoint dir
    as it is (vlm_source), the tower onto `device` (default cuda). text:
    a callable source -> (config, language model) that builds the text
    model elsewhere (a rank group's load); by default it goes onto
    `device` too."""
    from .loader import load_gguf_model

    dev = resolve_device(device)
    source = vlm_source(model_dir)
    if source is None:
        raise ValueError(f"{model_dir}: not a VLM dir (no vision.gguf, no "
                         f"InternVL config.json)")
    if text is not None:
        cfg, llm = text(source)
        return assemble_internvl(*load_vision(model_dir, dev), llm, cfg)
    if source == "hf_internvl":  # one read of the checkpoint for both
        reader, vsd, md = hf_text_reader(model_dir)
        cfg, llm = load_gguf_model(reader, device=dev, mxu=mxu)
        return assemble_internvl(_vision_params(vsd, md, dev), md, llm, cfg)
    cfg, llm = load_gguf_model(model_dir, device=dev, mxu=mxu)
    return assemble_internvl(*load_vision(model_dir, dev), llm, cfg)
