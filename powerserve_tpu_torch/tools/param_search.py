"""Speculative-parameter grid search (the JAX package's
tools/param_search.py; reference tools/parameter_search): sweeps the
host token tree's knobs {draft_batch_size, draft_top_k,
draft_temperature, p_base, max_fan_out, min_prob} over a
SpeculativeEngine, or an on-device engine's chain length k or tree
widths, and appends one JSON record a grid point (tokens/step,
acceptance rate, speed) to a jsonl file.

Every grid point fits the port's limits: draft_batch_size <= 16 (a
verify attends through flash-decode) and trees of at most 16 nodes.

  python -m powerserve_tpu_torch param-search -d <model dir> \\
      --engine chain --self-draft-layers 1
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from dataclasses import asdict
from pathlib import Path

from ..speculative.engine import SpecStats, SpeculativeEngine
from ..speculative.tree import SpeculativeConfig

DEFAULT_GRID = {
    "draft_batch_size": [8, 12, 16],
    "draft_top_k": [10, 15],
    "draft_temperature": [1.0, 1.5],
    "p_base": [0.8, 0.9],
    "max_fan_out": [2, 3],
    "min_prob": [0.1, 0.2],
}


def run_search(make_engine, prompt_ids: list[int], n_predict: int,
               grid: dict | None = None,
               out_path: str | Path = "spec_search.jsonl") -> list[dict]:
    """make_engine(cfg: SpeculativeConfig) -> SpeculativeEngine."""
    grid = grid or DEFAULT_GRID
    keys = sorted(grid)
    results = []
    with open(out_path, "a") as f:
        for values in itertools.product(*(grid[k] for k in keys)):
            cfg = SpeculativeConfig(**dict(zip(keys, values)))
            engine = make_engine(cfg)
            stats = SpecStats()
            for _ in engine.generate(prompt_ids, n_predict, stats=stats):
                pass
            rec = {**asdict(cfg),
                   "tokens_per_step": stats.tokens_per_step,
                   "accept_rate": stats.accept_rate,
                   "emitted": stats.emitted,
                   "decode_ms": stats.decode_ms}
            if stats.decode_ms:
                rec["decode_speed"] = stats.emitted / stats.decode_ms * 1e3
            results.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    results.sort(key=lambda r: -r.get("decode_speed",
                                      r["tokens_per_step"]))
    return results


# on-device engine grids (chain k, tree widths: the knobs that set the
# tokens/step vs per-step-cost tradeoff)
CHAIN_GRID = {"k": [3, 4, 6]}
TREE_GRID = {"widths": ["1,1,1", "2,1,1", "2,2,1", "3,1,1"]}


def run_engine_search(make_engine, grid: dict, prompt_ids: list[int],
                      n_predict: int,
                      out_path: str | Path = "spec_search.jsonl"
                      ) -> list[dict]:
    """Grid search over an on-device engine factory
    (make_engine(**params) -> object with .generate(ids, n, stats=))."""
    keys = sorted(grid)
    results = []
    with open(out_path, "a") as f:
        for values in itertools.product(*(grid[k] for k in keys)):
            params = dict(zip(keys, values))
            engine = make_engine(**params)
            stats = SpecStats()
            # a warm-up run captures the step graphs; the timed run
            # replays them
            for _ in engine.generate(prompt_ids, min(n_predict, 8),
                                     stats=SpecStats()):
                pass
            t0 = time.perf_counter()
            for _ in engine.generate(prompt_ids, n_predict, stats=stats):
                pass
            dt = time.perf_counter() - t0
            rec = {**params,
                   "tokens_per_step": stats.tokens_per_step,
                   "accept_rate": stats.accept_rate,
                   "emitted": stats.emitted,
                   "wall_s": round(dt, 3),
                   "wall_tok_s": round(stats.emitted / max(dt, 1e-9), 1)}
            results.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    results.sort(key=lambda r: -r["wall_tok_s"])
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch param-search")
    ap.add_argument("-d", "--model-dir", required=True)
    ap.add_argument("--draft-dir", default=None)
    ap.add_argument("--engine", default="tree",
                    choices=["tree", "chain", "device-tree", "eagle"],
                    help="tree: host token tree (reference knobs); "
                         "chain/device-tree/eagle: on-device engines "
                         "(k / tree-width grids)")
    ap.add_argument("--self-draft-layers", type=int, default=0,
                    help="chain/device-tree: self-draft over the target's "
                         "first N layers instead of --draft-dir")
    ap.add_argument("-p", "--prompt", default="Tell me a story about")
    ap.add_argument("-n", "--n-predict", type=int, default=64)
    ap.add_argument("-o", "--output", default="spec_search.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)

    from ..models.loader import load_gguf_model
    from ..tokenizer import Tokenizer

    dev = args.device
    t_cfg, target = load_gguf_model(args.model_dir, device=dev)
    tok = Tokenizer.from_model_dir(args.model_dir)
    ids = tok.tokenize(args.prompt)

    if args.engine == "tree":
        d_cfg, draft = load_gguf_model(args.draft_dir, device=dev)

        def make_engine(cfg):
            return SpeculativeEngine(target, t_cfg, draft, d_cfg, cfg,
                                     device=dev)

        results = run_search(make_engine, ids, args.n_predict,
                             out_path=args.output)
    elif args.engine == "eagle":
        from ..models.loader import load_eagle_gguf
        from ..speculative.eagle import EagleChainEngine

        _, head = load_eagle_gguf(args.draft_dir, target, t_cfg.llm,
                                  device=dev)

        def mk_eagle(k):
            return EagleChainEngine(target, t_cfg, head, k=k, device=dev)

        results = run_engine_search(mk_eagle, CHAIN_GRID, ids,
                                    args.n_predict, out_path=args.output)
    else:
        dkw: dict = {}
        if args.self_draft_layers:
            dkw["self_draft_layers"] = args.self_draft_layers
        else:
            dkw["draft"] = load_gguf_model(args.draft_dir, device=dev)[1]
        if args.engine == "chain":
            from ..speculative.chain import ChainSpecEngine

            def mk_chain(k):
                return ChainSpecEngine(target, t_cfg, k=k, device=dev, **dkw)

            results = run_engine_search(mk_chain, CHAIN_GRID, ids,
                                        args.n_predict,
                                        out_path=args.output)
        else:
            from ..speculative.device_tree import (DeviceTreeEngine,
                                                   TreeTemplate)

            def mk_tree(widths):
                tpl = TreeTemplate.from_widths(
                    [int(w) for w in widths.split(",")])
                return DeviceTreeEngine(target, t_cfg, template=tpl,
                                        device=dev, **dkw)

            results = run_engine_search(mk_tree, TREE_GRID, ids,
                                        args.n_predict,
                                        out_path=args.output)
    best = results[0]
    print(json.dumps({"best": best}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
