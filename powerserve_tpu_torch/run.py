"""`python -m powerserve_tpu_torch run` — generate from a prompt.

Loads a workspace (workspace.json) or a model dir, streams the tokens to
stdout and logs prefill/decode tok/s. Runs on the GPU (--device cuda,
the default) through the port's kernels, or with --device cpu on the
plain PyTorch path.

--draft <model dir> or --self-draft-layers N decode by speculation with
greedy acceptance (the tokens are the plain run's): --spec-engine chain
(speculative/chain.py, --spec-k draft tokens per step), device-tree
(speculative/device_tree.py, a static tree of --spec-tree widths per
depth) or tree (speculative/engine.py, the host-grown token tree; needs
--draft). A --draft dir holding an EAGLE head (general.architecture
"eagle") selects the EAGLE engine (speculative/eagle.py): a chain of
--spec-k, or with --spec-engine device-tree the tree of --spec-tree;
--spec-engine eagle insists on such a head. --draft-head-rank R factors
the draft's lm_head, or the head's (speculative/draft_head.py).

--image <file> (repeatable) runs a vision-language model (a workspace whose
model dir holds vision.gguf, or an HF InternVL checkpoint dir as it is)
through engine/vlm.py: every image's tiles go at the prompt's image
placeholder, or ahead of the prompt; greedy. Images are PNG or JPEG
(core/image.py FORMATS).

--load-kv <file.npz> fills slot 0 with a saved KV prefix before the
prompt (kv/persist.py: the JAX package's format, written in place), and
`generate` appends the prompt after it; --save-kv <file.npz> writes the
slot's tokens after generation (the prompt and the generated tokens
fed back). Both take the plain engine (no --draft, --self-draft-layers
or --image).

--weight-format w8 requantizes the GGUF's projections to the W8 format
at load (int8 weights with per-128 scales, csrc/qmatmul_w8.cu): the
target, a --draft model and a VLM's text model alike, as the JAX
package's POWERSERVE_WEIGHT_FORMAT=w8 does (the port reads no
environment). Default gguf: the GGUF's own formats.

--dump-speedinfo <file> appends one JSON line of the plain engine's
prefill_speed, decode_speed (tokens/s), n_prefill and n_decode, as the
JAX package's run does under POWERSERVE_DUMP_SPEEDINFO.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from .core.config import HyperParams, WorkspaceConfig
from .core.image import load_image
from .core.logging import get_logger
from .engine.generator import GenerationStats, InferenceEngine
from .engine.vlm import VLMEngine
from .kv.persist import load_prefix, save_prefix
from .models.internvl import load_internvl
from .models.loader import (WEIGHT_FORMATS, gguf_architecture,
                            load_eagle_gguf, load_gguf_model)
from .speculative.chain import ChainSpecEngine, with_draft_head
from .speculative.device_tree import DeviceTreeEngine, TreeTemplate
from .speculative.draft_head import make_draft_head
from .speculative.eagle import EagleChainEngine, with_lm_head_lr
from .speculative.engine import SpecStats, SpeculativeEngine
from .speculative.tree import SpeculativeConfig
from .tokenizer import Tokenizer

log = get_logger("run")


@dataclass
class RunResult:
    prompt_ids: list[int]
    ids: list[int]
    stats: GenerationStats
    spec: SpecStats | None = None


def build_engine(model_dir: str, hp: HyperParams,
                 device: str | torch.device | None = None, mxu: bool = False
                 ) -> tuple[InferenceEngine, Tokenizer]:
    cfg, model = load_gguf_model(model_dir, device=device, mxu=mxu)
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
    ap.add_argument("--weight-format", default="gguf", choices=WEIGHT_FORMATS,
                    help="gguf: the file's formats; w8: requantize the "
                         "projections to int8 with per-128 scales at load")
    ap.add_argument("--draft", default=None,
                    help="draft workspace or model dir: chain speculative "
                         "decoding")
    ap.add_argument("--self-draft-layers", type=int, default=0,
                    help="self-draft over the target's first N layers (no "
                         "draft model needed)")
    ap.add_argument("--draft-head-rank", type=int, default=0,
                    help="factor the draft's lm_head to this rank (the "
                         "emitted tokens do not change; acceptance may)")
    ap.add_argument("--spec-engine", default="chain",
                    choices=["chain", "tree", "device-tree", "eagle"],
                    help="chain: the on-device chain; device-tree: the "
                         "on-device token tree of --spec-tree; tree: the "
                         "host-grown token tree (needs --draft); eagle: "
                         "an EAGLE head's chain (needs --draft <eagle "
                         "head dir>, which selects it by itself)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="chain draft length per speculative step")
    ap.add_argument("--spec-tree", default="2,1,1",
                    help="device-tree widths per depth (a node at depth d "
                         "gets widths[d] draft children)")
    ap.add_argument("--image", action="append", default=None,
                    help="PNG or JPEG image for a vision-language "
                         "workspace or HF InternVL dir (repeatable): the "
                         "multimodal engine, greedy")
    ap.add_argument("--load-kv", default=None,
                    help="a saved KV prefix (.npz) to preload into slot 0")
    ap.add_argument("--save-kv", default=None,
                    help="save slot 0's KV prefix (.npz) after generation")
    ap.add_argument("--dump-speedinfo", default=None,
                    help="append the run's prefill/decode speeds as a JSON "
                         "line to this file (the plain engine)")
    return ap.parse_args(argv)


def resolve_workspace(path: str) -> tuple[Path, HyperParams]:
    """(model dir, hyper-params) of a workspace (workspace.json) or of a
    plain model dir."""
    root = Path(path)
    if (root / "workspace.json").exists():
        ws = WorkspaceConfig.load(root)
        return ws.main_model_dir, ws.hyper_params
    return root, HyperParams()


def run_prompt(args: argparse.Namespace) -> RunResult:
    model_dir, hp = resolve_workspace(args.work_folder)
    if args.temperature is not None:
        hp.sampler.temperature = args.temperature
    if args.top_k is not None:
        hp.sampler.top_k = args.top_k
    if args.top_p is not None:
        hp.sampler.top_p = args.top_p
    prompt = args.prompt
    if args.prompt_file:
        prompt = Path(args.prompt_file).read_text()

    log.info(f"loading model from {model_dir} on {args.device} "
             f"({args.weight_format})")
    mxu = args.weight_format == "w8"
    images = None
    spec = None
    if (args.load_kv or args.save_kv or args.dump_speedinfo) and (
            args.image or args.draft or args.self_draft_layers
            or args.spec_engine != "chain"):
        raise SystemExit("--load-kv/--save-kv/--dump-speedinfo take the "
                         "plain engine (no --image, --draft, "
                         "--self-draft-layers or --spec-engine)")
    if args.image:
        images = [load_image(p) for p in args.image]
        engine = VLMEngine(load_internvl(model_dir, args.device, mxu=mxu),
                           hp, args.device)
        tok = Tokenizer.from_model_dir(model_dir)
    elif args.draft or args.self_draft_layers or args.spec_engine != "chain":
        engine, tok = build_spec_engine(args, str(model_dir), hp)
        spec = SpecStats()
    else:
        engine, tok = build_engine(str(model_dir), hp, args.device, mxu)
    if args.use_chat_template:
        prompt = tok.apply_chat_template([{"role": "user", "content": prompt}])
    ids = tok.tokenize(prompt)
    log.info(f"prompt tokens: {len(ids)}")
    if args.load_kv:
        n = load_prefix(engine.kv, args.load_kv)
        log.info(f"loaded a {n}-token KV prefix from {args.load_kv}")

    stats = GenerationStats()
    out_ids: list[int] = []
    if not args.no_progress:
        print(prompt, end="", flush=True)
    gen = (engine.generate(ids, images, args.n_predicts,
                           stop_fn=tok.should_stop, stats=stats)
           if images else
           engine.generate(ids, args.n_predicts, stop_fn=tok.should_stop,
                           stats=stats if spec is None else spec))
    for t in gen:
        out_ids.append(t)
        if not args.no_progress:
            print(tok.to_string([t]), end="", flush=True)
    if args.no_progress:
        print(prompt + tok.to_string(out_ids), end="")
    print()
    if args.save_kv:
        n = save_prefix(engine.kv, args.save_kv)
        log.info(f"saved a {n}-token KV prefix to {args.save_kv}")
    if spec is not None:
        log.info(spec.summary())
        log.info(f"decode speed: "
                 f"{len(out_ids) / max(spec.decode_ms, 1e-9) * 1e3:.2f} "
                 f"tokens/s")
    else:
        log.info(f"prefill speed: {stats.prefill_speed:.2f} tokens/s")
        log.info(f"decode speed: {stats.decode_speed:.2f} tokens/s")
    if args.dump_speedinfo:
        with open(args.dump_speedinfo, "a") as f:
            json.dump({"prefill_speed": stats.prefill_speed,
                       "decode_speed": stats.decode_speed,
                       "n_prefill": stats.prefill_tokens,
                       "n_decode": stats.decode_tokens}, f)
            f.write("\n")
    return RunResult(ids, out_ids, stats, spec)


def build_spec_engine(args: argparse.Namespace, model_dir: str,
                      hp: HyperParams):
    """The speculation engine of --spec-engine over --draft /
    --self-draft-layers."""
    draft_dir = resolve_workspace(args.draft)[0] if args.draft else None
    arch = gguf_architecture(draft_dir) if draft_dir is not None else None
    if args.spec_engine == "eagle" and arch != "eagle":
        raise SystemExit(f"--spec-engine eagle needs --draft <eagle head "
                         f"dir> (got {args.draft!r}, arch={arch})")
    if arch == "eagle":
        if args.spec_engine == "tree":
            raise SystemExit("--spec-engine tree takes a draft model, not "
                             "an EAGLE head")
        return build_eagle_engine(args, model_dir, draft_dir, hp)
    if args.spec_engine == "tree" and draft_dir is None:
        raise SystemExit("--spec-engine tree needs --draft")
    if draft_dir is None and not args.self_draft_layers:
        raise SystemExit(f"--spec-engine {args.spec_engine} needs --draft "
                         f"or --self-draft-layers")
    mxu = args.weight_format == "w8"
    cfg, model = load_gguf_model(model_dir, device=args.device, mxu=mxu)
    tok = Tokenizer.from_model_dir(model_dir)
    draft = d_cfg = None
    if args.spec_engine == "tree" or not args.self_draft_layers:
        d_cfg, draft = load_gguf_model(draft_dir, device=args.device,
                                       mxu=mxu)
    common = dict(max_seq=hp.max_seq_len,
                  prefill_chunk=max(int(hp.batch_size), 1),
                  device=args.device)
    if args.spec_engine == "tree":
        eng = SpeculativeEngine(model, cfg, draft, d_cfg,
                                SpeculativeConfig(), **common)
    elif args.spec_engine == "device-tree":
        tpl = TreeTemplate.from_widths(
            [int(w) for w in args.spec_tree.split(",")])
        eng = DeviceTreeEngine(model, cfg, draft,
                               self_draft_layers=args.self_draft_layers,
                               template=tpl, **common)
    else:
        eng = ChainSpecEngine(model, cfg, draft,
                              self_draft_layers=args.self_draft_layers,
                              k=args.spec_k, **common)
    if args.draft_head_rank:
        eng.draft = with_draft_head(eng.draft, make_draft_head(
            eng.draft.lm_head, rank=args.draft_head_rank))
    return eng, tok


def build_eagle_engine(args: argparse.Namespace, model_dir: str,
                       head_dir: Path, hp: HyperParams):
    """EagleChainEngine over the head in head_dir: a chain of --spec-k,
    or with --spec-engine device-tree the tree of --spec-tree."""
    cfg, model = load_gguf_model(model_dir, device=args.device,
                                 mxu=args.weight_format == "w8")
    tok = Tokenizer.from_model_dir(model_dir)
    _, head = load_eagle_gguf(head_dir, model, cfg.llm, device=args.device)
    if args.draft_head_rank:
        head = with_lm_head_lr(head, make_draft_head(
            head.lm_head, rank=args.draft_head_rank))
    tpl = None
    if args.spec_engine == "device-tree":
        tpl = TreeTemplate.from_widths(
            [int(w) for w in args.spec_tree.split(",")])
    eng = EagleChainEngine(model, cfg, head, k=args.spec_k, template=tpl,
                           max_seq=hp.max_seq_len,
                           prefill_chunk=max(int(hp.batch_size), 1),
                           device=args.device)
    return eng, tok


def main(argv: list[str] | None = None) -> int:
    run_prompt(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
