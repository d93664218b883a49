"""The server's image worker processes: PNG decode and InternVL's
preprocessing (core/image.py's pixel_values, numpy only) off the
interpreter lock that the scheduler thread needs between its kernel
launches.

Each worker is `python -c` running core/image.py's worker_loop over a
pair of pipes. It imports that module and numpy, and nothing of the
host's `__main__`, so a script that builds a server or a LocalServer
needs no `if __name__ == "__main__":` guard. A worker that exits (killed,
out of memory) is replaced and its request fails with a RuntimeError;
one that takes longer than `timeout` seconds over an image is killed and
replaced, and the image refused with a ValueError.
"""

from __future__ import annotations

import queue
import select
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from ..core.image import recv_frame, send_frame

# the directory that holds the package
_ROOT = Path(__file__).resolve().parents[2]
_MAIN = (f"import sys; sys.path.insert(0, {str(_ROOT)!r}); "
         f"from powerserve_tpu_torch.core.image import worker_loop; "
         f"worker_loop()")


class ImageWorkers:
    """`n` worker processes, started and ready when the constructor
    returns; run() takes an idle one (waiting for one if all are busy)."""

    def __init__(self, n: int, timeout: float = 60.0):
        self.timeout = timeout
        self._lock = threading.Lock()
        self._procs: set[subprocess.Popen] = set()
        self._closed = False
        self._idle: queue.Queue[subprocess.Popen | None] = queue.Queue()
        started = [self._start() for _ in range(n)]
        for p in started:
            self._idle.put(self._ready(p))

    def _start(self) -> subprocess.Popen:
        with self._lock:
            if self._closed:
                raise RuntimeError("the image workers are closed")
            p = subprocess.Popen([sys.executable, "-c", _MAIN],
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, bufsize=0)
            self._procs.add(p)
            return p

    def _ready(self, p: subprocess.Popen) -> subprocess.Popen:
        try:
            if recv_frame(p.stdout) != "ready":
                raise EOFError("no ready frame")
        except EOFError as e:
            self._kill(p)
            raise RuntimeError(f"an image worker did not start "
                               f"(exit code {p.returncode})") from e
        return p

    def _kill(self, p: subprocess.Popen) -> None:
        p.kill()
        p.wait()
        for f in (p.stdin, p.stdout):
            f.close()
        with self._lock:
            self._procs.discard(p)

    def _take(self) -> subprocess.Popen | None:
        p = self._idle.get()
        if p is None or p.poll() is not None:  # died idle, or not replaced
            if p is not None:
                self._kill(p)
            p = self._ready(self._start())
        return p

    def pids(self) -> list[int]:
        """The live workers' process ids (a dead idle one is replaced when
        it is next taken)."""
        with self._lock:
            return sorted(p.pid for p in self._procs if p.poll() is None)

    def run(self, data: bytes, tile: int, max_num: int = 12) -> np.ndarray:
        """pixel_values(data, tile, max_num) in a worker."""
        p = None
        try:
            p = self._take()
            send_frame(p.stdin, (bytes(data), tile, max_num))
            if not select.select([p.stdout], [], [], self.timeout)[0]:
                self._kill(p)
                p = None
                raise ValueError(f"the image took more than "
                                 f"{self.timeout:g} s to decode")
            kind, value = recv_frame(p.stdout)
        except (OSError, EOFError) as e:  # the worker exited mid-request
            if p is not None:
                self._kill(p)
                p = None
            raise RuntimeError("an image worker exited while decoding "
                               "(killed or out of memory); it is "
                               "replaced") from e
        finally:
            self._idle.put(p)  # None: the next taker starts a new one
        if kind == "refused":
            raise ValueError(value)
        if kind == "failed":
            raise RuntimeError(f"image worker: {value}")
        return value

    def close(self) -> None:
        with self._lock:
            self._closed = True
            procs = list(self._procs)
        for p in procs:
            self._kill(p)
        for _ in procs:
            self._idle.put(None)
