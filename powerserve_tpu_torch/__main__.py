"""`python -m powerserve_tpu_torch <command>` (the JAX package's command
names; where a JAX command takes --backend, the port's takes --device
cuda|cpu, default cuda).

Commands:
  run               generate from a prompt (run.py)
  serve             OpenAI-compatible HTTP server (serving/server.py;
                    --paged-pages N --page-size P, --tp/--dp)
  perplexity        perplexity of a corpus (tools/perplexity.py)
  mmlu              MMLU harness over the HTTP API (tools/mmlu.py)
  convert           HF checkpoint -> workspace (tools/convert_hf.py)
  workspace         assemble a workspace (tools/workspace.py)
  synthetic         random-weight workspace for testing
                    (tools/synthetic.py)
  param-search      speculative knob grid search (tools/param_search.py)
  mmmu              multimodal eval harness over the HTTP API
                    (tools/mmmu.py)
  cos-sim           compare activation dumps (tools/cos_sim.py)
  dump-activations  per-layer hidden-state dumps
                    (tools/dump_activations.py)
  bench-kernels     quantized-matmul microbenchmarks
                    (tools/bench_kernels.py)
  gate              perplexity, speculation and MMLU in one verdict
                    (tools/gate.py)
The JAX package's `autotune` (it tunes TPU programs) and `deploy` (it
launches a TPU pod slice; its counterpart belongs with ROADMAP item 8b)
exit with code 2.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "run": ".run",
    "serve": ".serving.server",
    "perplexity": ".tools.perplexity",
    "mmlu": ".tools.mmlu",
    "convert": ".tools.convert_hf",
    "workspace": ".tools.workspace",
    "synthetic": ".tools.synthetic",
    "param-search": ".tools.param_search",
    "mmmu": ".tools.mmmu",
    "cos-sim": ".tools.cos_sim",
    "dump-activations": ".tools.dump_activations",
    "bench-kernels": ".tools.bench_kernels",
    "gate": ".tools.gate",
}
REFUSED = {
    "autotune": "tunes the JAX package's TPU programs; the port has no "
                "counterpart",
    "deploy": "launches serving across a TPU pod slice; the port's "
              "counterpart belongs with multi-host serving (ROADMAP "
              "item 8b)",
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd in REFUSED:
        print(f"powerserve_tpu_torch {cmd}: not in the port: "
              f"{REFUSED[cmd]}", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command '{cmd}'\n{__doc__}")
        return 1
    module = importlib.import_module(COMMANDS[cmd], __package__)
    return module.main(rest) or 0


if __name__ == "__main__":
    raise SystemExit(main())
