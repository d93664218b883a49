"""One-command eval-readiness gate (the JAX package's tools/gate.py).

Given a model workspace (and optionally a draft + MMLU data), runs the
full quality-gate suite unattended and emits one JSON verdict:

    python -m powerserve_tpu_torch gate -d <ws> [--device cuda|cpu] \
        [--prompt-file wiki.txt] [--ppl-max 9.5] \
        [--draft self:8 | --draft <dir>] [--accept-min 0.6] \
        [--mmlu-data data/mmlu] [--mmlu-min 0.55] \
        [-o gate.json]

Checks (each skipped when its input is absent, recorded as "skipped"):
  1. perplexity  — tools/perplexity.py over --prompt-file (the
     reference's intrinsic-quality metric, app/perplexity/main.cpp).
  2. speculation — greedy chain-spec acceptance/tokens-per-step on a
     REAL checkpoint (the synthetic-weight speedups in the perf log
     assume ~100% acceptance; this is the honest number — reference
     prints it live, token_tree.cpp:246-253).
  3. MMLU        — tools/mmlu.py against a self-spawned server
     subprocess (`python -m powerserve_tpu_torch serve ... --device`,
     in a process group of its own, killed by its pid when the check
     ends or fails; exercises the full serving stack end-to-end).

Thresholds are optional: without them the gate records measurements
and passes — run with thresholds once reference-parity targets exist
(reference README.md:16-29).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from ..core.logging import get_logger

log = get_logger("gate")

# built-in fallback corpus so the gate RUNS without any dataset; real
# parity needs --prompt-file with the reference's text
_FALLBACK_TEXT = (
    "The transformer architecture processes sequences of tokens with "
    "self attention, feed forward networks, and residual connections. "
) * 64


def _gate_perplexity(model_dir: str, prompt_file: str | None,
                     device: str, batch_size: int) -> dict:
    from ..models.loader import load_gguf_model
    from ..tokenizer import Tokenizer
    from .perplexity import compute_perplexity

    _, model = load_gguf_model(model_dir, device=device)
    tok = Tokenizer.from_model_dir(model_dir)
    if prompt_file:
        text = Path(prompt_file).read_text()
        source = prompt_file
    else:
        text = _FALLBACK_TEXT
        source = "builtin-fallback (pass --prompt-file for parity runs)"
    ids = tok.tokenize(text)
    t0 = time.time()
    ppl = compute_perplexity(model, ids, batch_size=batch_size)
    return {"perplexity": round(float(ppl), 4), "n_tokens": len(ids),
            "corpus": source, "seconds": round(time.time() - t0, 1)}


def _gate_speculation(model_dir: str, draft: str, device: str,
                      n_tokens: int) -> dict:
    """Greedy chain speculation on the real checkpoint: acceptance
    rate + tokens/step (blocks of replayed steps on the card)."""
    from ..models.loader import load_gguf_model
    from ..speculative.chain import ChainSpecEngine
    from ..speculative.engine import SpecStats
    from ..tokenizer import Tokenizer

    t_cfg, target = load_gguf_model(model_dir, device=device)
    if draft.startswith("self:"):
        eng = ChainSpecEngine(target, t_cfg,
                              self_draft_layers=int(draft[5:]),
                              device=device)
        draft_desc = f"layer-skip self-draft ({draft[5:]} layers)"
    else:
        _, d_model = load_gguf_model(draft, device=device)
        eng = ChainSpecEngine(target, t_cfg, d_model, device=device)
        draft_desc = draft
    tok = Tokenizer.from_model_dir(model_dir)
    prompt = tok.tokenize("The most important consideration when "
                          "designing a distributed system is")
    stats = SpecStats()
    t0 = time.time()
    out = list(eng.generate(prompt, n_tokens, stats=stats))
    dt = time.time() - t0
    steps = max(stats.steps, 1)
    return {
        "draft": draft_desc,
        "generated": len(out),
        "accept_rate": round(stats.accepted / max(stats.drafted, 1), 4),
        "tokens_per_step": round((stats.accepted + steps) / steps, 3),
        "gen_tok_s": round(len(out) / dt, 2),
    }


def _gate_mmlu(model_dir: str, data_dir: str, device: str,
               limit: int, out_dir: Path) -> dict:
    """Spawn the port's server on a free port, run the MMLU harness
    against it, tear down by pid."""
    import socket

    from .mmlu import main as mmlu_main

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # `-m powerserve_tpu_torch` from the directory that holds the
    # package; the server's log beside the verdict
    log_path = out_dir / "gate_server.log"
    with open(log_path, "wb") as log_f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "powerserve_tpu_torch", "serve", "-d",
             str(Path(model_dir).resolve()), "--port", str(port),
             "--device", device, "--max-slots", "4"],
            cwd=Path(__file__).resolve().parents[2],
            stdout=subprocess.DEVNULL, stderr=log_f,
            start_new_session=True)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(120):  # model load + kernel build can be slow
            if proc.poll() is not None:
                raise RuntimeError(f"gate server exited with code "
                                   f"{proc.returncode} (log: {log_path})")
            try:
                urllib.request.urlopen(url + "/v1/models", timeout=5)
                break
            except OSError:
                time.sleep(5)
        else:
            raise RuntimeError("gate server never came up")
        out_json = out_dir / "gate_mmlu.json"
        rc = mmlu_main(["--data-dir", data_dir, "--url", url,
                        "--limit", str(limit), "-o", str(out_json)])
        if rc != 0:
            raise RuntimeError(f"mmlu harness exited {rc}")
        res = json.loads(out_json.read_text())
        return {"accuracy": res["accuracy"], "total_n": res["total_n"],
                "per_subject": {r["subject"]: r["accuracy"]
                                for r in res["subjects"]}}
    finally:
        # kill the exact process group we started, never by pattern
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
        proc.wait(timeout=15)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch gate")
    ap.add_argument("-d", "--model-dir", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch path)")
    ap.add_argument("--prompt-file", default=None,
                    help="perplexity corpus (reference assets/prompts)")
    ap.add_argument("--ppl-max", type=float, default=None)
    ap.add_argument("--ppl-batch", type=int, default=32)
    ap.add_argument("--draft", default=None,
                    help="'self:N' or a draft model dir; enables the "
                         "acceptance-rate check")
    ap.add_argument("--accept-min", type=float, default=None)
    ap.add_argument("--spec-tokens", type=int, default=128)
    ap.add_argument("--mmlu-data", default=None,
                    help="dir of MMLU *_test.csv files")
    ap.add_argument("--mmlu-min", type=float, default=None)
    ap.add_argument("--mmlu-limit", type=int, default=16)
    ap.add_argument("-o", "--output", default="gate.json")
    args = ap.parse_args(argv)

    # a workspace dir (workspace.json -> model subdir), as run/serve take
    root = Path(args.model_dir)
    if (root / "workspace.json").exists():
        from ..core.config import WorkspaceConfig

        args.model_dir = str(WorkspaceConfig.load(root).main_model_dir)

    report: dict = {"model_dir": str(args.model_dir),
                    "backend": args.device, "checks": {}}
    failures: list[str] = []

    def run_check(name, fn, threshold, key, cmp):
        try:
            res = fn()
            report["checks"][name] = res
            if threshold is not None:
                ok = cmp(res[key], threshold)
                res["threshold"] = threshold
                res["pass"] = bool(ok)
                if not ok:
                    failures.append(name)
            log.info(f"{name}: {res}")
        except Exception as e:  # noqa: BLE001
            report["checks"][name] = {"error": str(e)}
            failures.append(name)
            log.error(f"{name} FAILED: {e}")

    run_check("perplexity",
              lambda: _gate_perplexity(args.model_dir, args.prompt_file,
                                       args.device, args.ppl_batch),
              args.ppl_max, "perplexity", lambda v, t: v <= t)
    if args.draft:
        run_check("speculation",
                  lambda: _gate_speculation(args.model_dir, args.draft,
                                            args.device,
                                            args.spec_tokens),
                  args.accept_min, "accept_rate", lambda v, t: v >= t)
    else:
        report["checks"]["speculation"] = {"skipped": "no --draft"}
    if args.mmlu_data:
        run_check("mmlu",
                  lambda: _gate_mmlu(args.model_dir, args.mmlu_data,
                                     args.device, args.mmlu_limit,
                                     Path(args.output).parent),
                  args.mmlu_min, "accuracy", lambda v, t: v >= t)
    else:
        report["checks"]["mmlu"] = {"skipped": "no --mmlu-data"}

    report["pass"] = not failures
    report["failures"] = failures
    Path(args.output).write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
