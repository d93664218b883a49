"""Rank processes over torch.distributed.

The JAX package runs one controller over every device and joins hosts
with jax.distributed. The port runs one process a rank: rank 0 owns the
host side (the scheduler, the server) and ranks 1..N-1 are followers
that apply, to their own shards, the operations rank 0 broadcasts
(parallel/tp.py). This module starts and joins them:

  init_distributed(rank, world, addr, backend)  joins the process group
  Followers(world, backend, device_type)        starts ranks 1..N-1 as
                                                `python -c` processes

The followers import the package and nothing of the host's `__main__`,
so a script that serves with --tp needs no main guard. Rank r takes
cuda:(r % device_count). NCCL takes one card a rank; gloo runs the same
collectives (all_reduce and broadcast only) with ranks sharing a card,
or on the CPU. Nothing picks the backend: the caller names it, and NCCL
with more ranks than cards is refused with an error naming gloo.

A follower that exits while the group runs takes rank 0 down: a watch
thread logs which rank and its exit code, stops the other followers and
ends the process with exit code 1, so a server never hangs on a
collective that cannot complete. A follower ends itself when rank 0's
process is gone.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..core.logging import get_logger

log = get_logger("distributed")

BACKENDS = ("nccl", "gloo")
# a follower waits on its next operation for as long as the server idles
GROUP_TIMEOUT = datetime.timedelta(days=7)
# the directory that holds the package
_ROOT = Path(__file__).resolve().parents[2]


def default_backend(device: str | torch.device) -> str:
    """The backend `serve` names when --dist-backend is not given: nccl on
    cuda, gloo on the cpu."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def check_backend(backend: str, world: int,
                  device: str | torch.device) -> None:
    """Refuse a backend that cannot run `world` ranks on `device`."""
    dev = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on cuda; on the cpu use "
                             "--dist-backend gloo")
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"nccl takes one card a rank: {world} ranks on {n} "
                f"card(s); --dist-backend gloo lets ranks share a card")


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: the cpu, or cuda:(r % device_count)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(rank: int, world: int, addr: str,
                     backend: str) -> None:
    """Join the process group at `addr` (tcp://host:port) as `rank` of
    `world` (the JAX package's init_distributed, for one process a
    rank)."""
    dist.init_process_group(backend, init_method=addr, rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Followers:
    """Ranks 1..world-1 as `python -c` processes joining the group at a
    free port on this host; rank 0 then joins with join()."""

    def __init__(self, world: int, backend: str, device_type: str,
                 threads: int):
        self.world = world
        self.addr = f"tcp://127.0.0.1:{free_port()}"
        self.closing = False
        self.procs = []
        for rank in range(1, world):
            code = (f"import sys; sys.path.insert(0, {str(_ROOT)!r}); "
                    f"from powerserve_tpu_torch.parallel.tp import "
                    f"follower_main; follower_main({rank}, {world}, "
                    f"{self.addr!r}, {backend!r}, {device_type!r}, "
                    f"{threads}, {os.getpid()})")
            self.procs.append(subprocess.Popen([sys.executable, "-c", code]))
        self._watch = threading.Thread(target=self._watch_loop, daemon=True,
                                       name="rank-watch")
        self._watch.start()

    def _watch_loop(self) -> None:
        while not self.closing:
            for rank, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and not self.closing:
                    log.error(f"rank {rank} of {self.world} exited with code "
                              f"{code}: the rank group cannot go on; "
                              f"stopping the server")
                    self.kill()
                    os._exit(1)
            time.sleep(0.2)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def close(self, timeout: float = 30.0) -> None:
        """Wait for the followers to exit (after the stop operation), and
        kill any that does not."""
        self.closing = True
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def watch_parent(parent_pid: int) -> None:
    """A follower's thread: end this process when rank 0's is gone."""
    def loop():
        while os.getppid() == parent_pid:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=loop, daemon=True, name="parent-watch").start()
