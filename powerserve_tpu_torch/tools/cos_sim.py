"""Tensor-dump comparison tool (the JAX package's tools/cos_sim.py): cosine
similarity between dumped activations from two implementations (e.g.
our forward vs a PyTorch reference), for numerics debugging.

Dumps are .npy files; directories are compared file-by-file on matching
names."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def cos_sim(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))


def compare(path_a: Path, path_b: Path) -> list[tuple[str, float, float]]:
    """Returns [(name, cosine, max_abs_diff)]."""
    out = []
    if path_a.is_file():
        a, b = np.load(path_a), np.load(path_b)
        out.append((path_a.name, cos_sim(a, b),
                    float(np.abs(a - b).max())))
        return out
    for fa in sorted(path_a.glob("*.npy")):
        fb = path_b / fa.name
        if not fb.exists():
            out.append((fa.name, float("nan"), float("nan")))
            continue
        a, b = np.load(fa), np.load(fb)
        if a.shape != b.shape:
            out.append((fa.name, float("nan"), float("nan")))
            continue
        out.append((fa.name, cos_sim(a, b), float(np.abs(a - b).max())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="powerserve_tpu_torch cos-sim")
    ap.add_argument("a", help=".npy file or dir of dumps")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    rows = compare(Path(args.a), Path(args.b))
    for name, cs, mad in rows:
        print(f"{name}: cos={cs:.6f} max_abs_diff={mad:.6g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
