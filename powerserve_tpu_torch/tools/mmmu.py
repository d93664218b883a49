"""MMMU-style multimodal eval harness over the OpenAI HTTP API (the JAX
package's tools/mmmu.py; reference tools/mmmu_test/mmmu_test.py): sends
image questions to the running server, robust choice parsing; over the
standard library's http.client.

Dataset: a JSONL file with rows
  {"question": str, "options": [str, ...], "answer": "A",
   "image": "relative/path.png"}
(nothing is fetched; convert HF MMMU to this layout offline). The port's
server decodes PNG images.

  python -m powerserve_tpu_torch mmmu --data mmmu.jsonl \\
      --url http://127.0.0.1:8080
"""

from __future__ import annotations

import argparse
import base64
import json
from pathlib import Path

from .mmlu import chat_content, parse_choice

LETTERS = "ABCDEFGHIJ"


def image_to_data_uri(path: Path) -> str:
    suffix = path.suffix.lstrip(".").lower() or "png"
    b64 = base64.b64encode(path.read_bytes()).decode()
    return f"data:image/{suffix};base64,{b64}"


def build_question(question: str, options: list[str]) -> str:
    lines = [question, ""]
    for letter, opt in zip(LETTERS, options):
        lines.append(f"{letter}. {opt}")
    lines.append("")
    lines.append("Answer with just the letter of the correct option.")
    return "\n".join(lines)


def ask(base_url: str, model: str, text: str, image_uri: str | None,
        timeout: float = 300.0) -> str:
    content: list[dict] = []
    if image_uri:
        content.append({"type": "image_url", "image_url": {"url": image_uri}})
    content.append({"type": "text", "text": text})
    return chat_content(base_url, model, content, timeout)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch mmmu")
    ap.add_argument("--data", required=True, help="JSONL dataset file")
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--model", default="default")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("-o", "--output", default="mmmu_results.json")
    args = ap.parse_args(argv)

    data_path = Path(args.data)
    rows = [json.loads(line) for line in data_path.read_text().splitlines()
            if line.strip()]
    if args.limit:
        rows = rows[:args.limit]
    correct = 0
    results = []
    for row in rows:
        img_uri = None
        if row.get("image"):
            img_uri = image_to_data_uri(data_path.parent / row["image"])
        out = ask(args.url, args.model,
                  build_question(row["question"], row["options"]), img_uri)
        pred = parse_choice(out)
        ok = pred == row["answer"].strip().upper()
        correct += ok
        results.append({"pred": pred, "answer": row["answer"], "ok": ok})
    summary = {"n": len(rows), "correct": correct,
               "accuracy": correct / len(rows) if rows else 0.0,
               "results": results}
    Path(args.output).write_text(json.dumps(summary, indent=2))
    print(f"accuracy: {summary['accuracy']:.2%} ({correct}/{len(rows)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
