"""A tiny HF InternVL checkpoint dir, as transformers saves one: a
Qwen2 text model of 2 layers at width 64 (vocab 320), a 2-layer vision
tower on 56-pixel tiles (4 image tokens a tile), config.json,
model.safetensors and a byte-level BPE tokenizer.json. Tests of the
port's HF-dir loading (models/internvl.py internvl_from_hf_dir) hold it
against the JAX package's internvl_from_hf on the same transformers
model."""

import json
import os

import torch

# transformers would import TensorFlow too (seconds, and nothing here
# needs it)
os.environ.setdefault("USE_TF", "0")

IMG_ID = 250


def make_hf_internvl(d, seed: int = 0):
    """Write the dir at d; returns the transformers model."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers
    from transformers import (InternVLConfig,
                              InternVLForConditionalGeneration, Qwen2Config)
    from transformers.models.internvl.configuration_internvl import (
        InternVLVisionConfig)

    torch.manual_seed(seed)
    vc = InternVLVisionConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=[56, 56], patch_size=[14, 14])
    tc = Qwen2Config(
        vocab_size=320, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0)
    cfg = InternVLConfig(vision_config=vc.to_dict(), text_config=tc.to_dict(),
                         image_token_id=IMG_ID, downsample_ratio=0.5)
    # 56 / 14 = 4 x 4 patches -> pixel shuffle 0.5 -> 4 image tokens
    cfg.image_seq_length = 4
    model = InternVLForConditionalGeneration(cfg).eval()
    # transformers initializes at std 0.02: widen the text weights, so the
    # logits are not all near-ties
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "language_model" in name and p.dim() == 2:
                p.mul_(8.0)
    model.save_pretrained(d, safe_serialization=True)
    tok = HFTok(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog"]
                            * 8, trainer)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))
    return model
