"""`python -m powerserve_tpu_torch <command>`.

Commands:
  run    generate from a prompt (see run.py; --device cuda|cpu)
"""

from __future__ import annotations

import sys


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "run":
        from .run import main as run_main
        return run_main(argv)
    print(f"unknown command '{cmd}'\n{__doc__}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
