"""`python -m powerserve_tpu_torch run` — generate from a prompt.

Loads a workspace (workspace.json) or a model dir, streams the tokens to
stdout and logs prefill/decode tok/s. Runs on the GPU (--device cuda,
the default) through the port's kernels, or with --device cpu on the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from .core.config import HyperParams, WorkspaceConfig
from .core.logging import get_logger
from .engine.generator import GenerationStats, InferenceEngine
from .models.loader import load_gguf_model
from .tokenizer import Tokenizer

log = get_logger("run")


@dataclass
class RunResult:
    prompt_ids: list[int]
    ids: list[int]
    stats: GenerationStats


def build_engine(model_dir: str, hp: HyperParams,
                 device: str | torch.device | None = None
                 ) -> tuple[InferenceEngine, Tokenizer]:
    cfg, model = load_gguf_model(model_dir, device=device)
    tok = Tokenizer.from_model_dir(model_dir)
    try:
        nl_id = tok.tokenize("\n", add_bos=False)[-1]
    except (IndexError, ValueError, KeyError):
        nl_id = -1
    engine = InferenceEngine(model, cfg, hp, eos_id=tok.eos_id, nl_id=nl_id,
                             device=device)
    return engine, tok


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch run")
    ap.add_argument("-d", "--work-folder", required=True,
                    help="workspace dir (workspace.json) or model dir")
    ap.add_argument("-p", "--prompt", default="Hello, world")
    ap.add_argument("--prompt-file", default=None)
    ap.add_argument("-n", "--n-predicts", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--use-chat-template", action="store_true")
    ap.add_argument("--no-progress", action="store_true",
                    help="print only the final text, not each token")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    return ap.parse_args(argv)


def run_prompt(args: argparse.Namespace) -> RunResult:
    root = Path(args.work_folder)
    if (root / "workspace.json").exists():
        ws = WorkspaceConfig.load(root)
        model_dir, hp = ws.main_model_dir, ws.hyper_params
    else:
        model_dir, hp = root, HyperParams()
    if args.temperature is not None:
        hp.sampler.temperature = args.temperature
    if args.top_k is not None:
        hp.sampler.top_k = args.top_k
    if args.top_p is not None:
        hp.sampler.top_p = args.top_p
    prompt = args.prompt
    if args.prompt_file:
        prompt = Path(args.prompt_file).read_text()

    log.info(f"loading model from {model_dir} on {args.device}")
    engine, tok = build_engine(str(model_dir), hp, args.device)
    if args.use_chat_template:
        prompt = tok.apply_chat_template([{"role": "user", "content": prompt}])
    ids = tok.tokenize(prompt)
    log.info(f"prompt tokens: {len(ids)}")

    stats = GenerationStats()
    out_ids: list[int] = []
    if not args.no_progress:
        print(prompt, end="", flush=True)
    for t in engine.generate(ids, args.n_predicts, stop_fn=tok.should_stop,
                             stats=stats):
        out_ids.append(t)
        if not args.no_progress:
            print(tok.to_string([t]), end="", flush=True)
    if args.no_progress:
        print(prompt + tok.to_string(out_ids), end="")
    print()
    log.info(f"prefill speed: {stats.prefill_speed:.2f} tokens/s")
    log.info(f"decode speed: {stats.decode_speed:.2f} tokens/s")
    return RunResult(ids, out_ids, stats)


def main(argv: list[str] | None = None) -> int:
    run_prompt(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
