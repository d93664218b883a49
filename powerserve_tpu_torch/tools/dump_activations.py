"""Per-layer activation dumps for numerics debugging (the JAX package's
tools/dump_activations.py): the residual stream after each layer of one
teacher-forced forward over a prompt, as .npy files, to compare with
another implementation's by tools/cos_sim.py.

  python -m powerserve_tpu_torch dump-activations -d <model dir> \\
      -p "prompt" -o dumps/cuda
  python -m powerserve_tpu_torch dump-activations -d <model dir> \\
      -p "prompt" -o dumps/cpu --device cpu
  python -m powerserve_tpu_torch cos-sim dumps/cuda dumps/cpu

The forward runs over the int8 KV cache, the only one the port has (the
JAX tool defaults to a bf16 cache).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..kv.cache import KVCache
from ..models.llama import LlamaModel


@torch.no_grad()
def dump_forward(model: LlamaModel, token_ids: list[int],
                 out_dir: str | Path) -> Path:
    """layer_NN.npy (f32 [T, dim], the residual stream after layer NN)
    and logits.npy (f32 [T, vocab]) of one forward over token_ids."""
    llm = model.llm
    dev = model.out_norm.device
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    T = len(token_ids)
    kv = KVCache.create(llm.n_layers, 1, max(T + 8, 16), llm.n_kv_heads,
                        llm.head_size, device=dev)
    logits, hidden = model(
        kv, torch.tensor([token_ids], dtype=torch.int32, device=dev),
        torch.arange(T, device=dev)[None, :], logits_mode="all",
        return_hidden=True)
    # f32: bf16 .npy files do not round-trip without ml_dtypes
    hidden = hidden.float().cpu().numpy()  # [L, S, T, dim]
    for layer in range(hidden.shape[0]):
        np.save(out / f"layer_{layer:02d}.npy", hidden[layer, 0])
    np.save(out / "logits.npy", logits.float().cpu().numpy()[0])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch dump-activations")
    ap.add_argument("-d", "--model-dir", required=True)
    ap.add_argument("-p", "--prompt", default="Hello world")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)

    from ..models.loader import load_gguf_model
    from ..tokenizer import Tokenizer

    cfg, model = load_gguf_model(args.model_dir, device=args.device)
    tok = Tokenizer.from_model_dir(args.model_dir)
    out = dump_forward(model, tok.tokenize(args.prompt), args.out_dir)
    print(f"dumped {cfg.llm.n_layers} layers + logits to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
