"""Workspace assembly CLI (the JAX package's tools/workspace.py;
reference `powerserve create`): builds a deployment workspace directory
that workspace.json-aware tools (run/serve) consume.

  python -m powerserve_tpu_torch workspace create -m <model_dir_or_hf_dir>
      [--draft draft] -o out [--quant q4_k]

Model sources may be ready GGUF model dirs (linked/copied) or HF
checkpoints (converted via convert_hf)."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path


def _is_gguf_dir(p: Path) -> bool:
    return (p / "weights.gguf").exists()


def _is_hf_dir(p: Path) -> bool:
    return (p / "config.json").exists()


def _materialize(src: Path, dst: Path, quant: str, copy: bool) -> None:
    if _is_gguf_dir(src):
        if dst.exists():
            return
        if copy:
            shutil.copytree(src, dst)
        else:
            dst.symlink_to(src.resolve())
        return
    if _is_hf_dir(src):
        from .convert_hf import convert_hf_model
        import tempfile

        tmp = Path(tempfile.mkdtemp(prefix="psv_conv_"))
        try:
            convert_hf_model(src, tmp, quant)
            shutil.move(str(tmp / "model"), str(dst))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return
    raise FileNotFoundError(f"{src}: neither a GGUF model dir nor a HF dir")


def create_workspace(out_dir: str | Path, main_model: str | Path,
                     draft_model: str | Path | None = None,
                     quant: str = "q4_k", copy: bool = False,
                     hparams: dict | None = None) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    _materialize(Path(main_model), out / "model_main", quant, copy)
    if draft_model:
        _materialize(Path(draft_model), out / "model_draft", quant, copy)
    (out / "workspace.json").write_text(json.dumps({
        "model_main": "model_main",
        "model_draft": "model_draft" if draft_model else "",
        "hparams_config": "hparams.json",
    }, indent=2))
    hp = {"batch_size": 128, "max_slots": 4, "kv_dtype": "int8",
          "sampler": {"temperature": 0.8, "top_k": 40, "top_p": 0.95}}
    hp.update(hparams or {})
    (out / "hparams.json").write_text(json.dumps(hp, indent=2))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch workspace")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cr = sub.add_parser("create")
    cr.add_argument("-m", "--model", required=True)
    cr.add_argument("--draft", default=None)
    cr.add_argument("-o", "--out", required=True)
    cr.add_argument("--quant", default="q4_k")
    cr.add_argument("--copy", action="store_true",
                    help="copy model dirs instead of symlinking")
    args = ap.parse_args(argv)
    if args.cmd == "create":
        out = create_workspace(args.out, args.model, args.draft, args.quant,
                               args.copy)
        print(f"workspace ready at {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
