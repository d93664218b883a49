"""MMLU evaluation harness over the OpenAI HTTP API (the JAX package's
tools/mmlu.py; reference tools/mmlu/mmlu_test.py: 1-shot prompts
against the running server, per-subject accuracy JSON), over the
standard library's http.client. Dataset: a local dir in the standard
MMLU layout (subject_test.csv with question,A,B,C,D,answer); nothing is
fetched.

  python -m powerserve_tpu_torch mmlu --data-dir data/mmlu \\
      --url http://127.0.0.1:8080
"""

from __future__ import annotations

import argparse
import csv
import http.client
import json
import re
from pathlib import Path
from urllib.parse import urlsplit

CHOICES = ["A", "B", "C", "D"]


def build_prompt(question: str, options: list[str],
                 example: tuple[str, list[str], str] | None = None) -> str:
    """1-shot multiple-choice prompt (reference mmlu_test.py prompt)."""
    parts = ["The following is a multiple choice question. Answer with "
             "just the letter of the correct option.\n"]
    if example:
        eq, eopts, eans = example
        parts.append(eq + "\n")
        for c, o in zip(CHOICES, eopts):
            parts.append(f"{c}. {o}\n")
        parts.append(f"Answer: {eans}\n\n")
    parts.append(question + "\n")
    for c, o in zip(CHOICES, options):
        parts.append(f"{c}. {o}\n")
    parts.append("Answer:")
    return "".join(parts)


def parse_choice(text: str) -> str | None:
    """Robust letter extraction (reference mmmu_test.py choice parsing)."""
    m = re.search(r"\b([ABCD])\b", text.strip().upper())
    return m.group(1) if m else None


def post_json(url: str, body: dict, timeout: float) -> dict:
    """POST body as JSON to url; the decoded JSON reply. A status of 400
    or more raises RuntimeError with the reply's text."""
    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("POST", u.path or "/", json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    if r.status >= 400:
        raise RuntimeError(f"POST {url}: {r.status} {r.reason}: "
                           f"{data[:500].decode(errors='replace')}")
    return json.loads(data)


def chat_content(base_url: str, model: str, content, timeout: float) -> str:
    """The reply text of one greedy 8-token chat completion."""
    out = post_json(f"{base_url}/v1/chat/completions", {
        "model": model,
        "messages": [{"role": "user", "content": content}],
        "max_tokens": 8, "temperature": 0.0,
    }, timeout)
    return out["choices"][0]["message"]["content"]


def ask_server(base_url: str, model: str, prompt: str,
               timeout: float = 120.0) -> str:
    return chat_content(base_url, model, prompt, timeout)


def run_subject(base_url: str, model: str, csv_path: Path,
                limit: int = 0) -> dict:
    rows = []
    with open(csv_path) as f:
        for row in csv.reader(f):
            if len(row) >= 6:
                rows.append((row[0], row[1:5], row[5].strip().upper()))
    example = rows[0] if rows else None
    rows_eval = rows[1:] if len(rows) > 1 else rows
    if limit:
        rows_eval = rows_eval[:limit]
    correct = 0
    for q, opts, ans in rows_eval:
        out = ask_server(base_url, model, build_prompt(q, opts, example))
        if parse_choice(out) == ans:
            correct += 1
    n = len(rows_eval)
    return {"subject": csv_path.stem.replace("_test", ""),
            "n": n, "correct": correct,
            "accuracy": correct / n if n else 0.0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch mmlu")
    ap.add_argument("--data-dir", required=True,
                    help="dir of MMLU *_test.csv files")
    ap.add_argument("--url", default="http://127.0.0.1:8080")
    ap.add_argument("--model", default="",
                    help="model name ('' = the server's default)")
    ap.add_argument("--limit", type=int, default=0,
                    help="max questions per subject")
    ap.add_argument("-o", "--output", default="mmlu_results.json")
    args = ap.parse_args(argv)

    results = []
    for csv_path in sorted(Path(args.data_dir).glob("*_test.csv")):
        res = run_subject(args.url, args.model, csv_path, args.limit)
        results.append(res)
        print(f"{res['subject']}: {res['accuracy']:.2%} "
              f"({res['correct']}/{res['n']})")
    total_n = sum(r["n"] for r in results)
    total_c = sum(r["correct"] for r in results)
    summary = {"subjects": results, "total_n": total_n,
               "total_correct": total_c,
               "accuracy": total_c / total_n if total_n else 0.0}
    Path(args.output).write_text(json.dumps(summary, indent=2))
    print(f"overall: {summary['accuracy']:.2%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
