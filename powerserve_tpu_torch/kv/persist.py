"""Persistent KV prefixes: a slot's first n tokens to a .npz file and
back, and the prefix-cache entries of HTTP sessions.

A prefix file has the JAX package's format (its kv/persist.py), so a
file written by either package loads in the other: k, v int8 [L, H, n,
D], k_scale, v_scale f32 [L, H, n], quantized (always True: the port
keeps an int8 cache only) and n. load_prefix refuses what the JAX
package refuses, with a ValueError: another quantization mode, another
cache geometry, or a prefix longer than the cache.

Unlike the JAX package's, load_prefix writes into the cache in place and
returns n: a replayed decode step (engine/graphs.py) captured the
cache's addresses, so a new cache would leave it reading the old memory.

A session file (serving/server.py, /v1/sessions) holds a prefix-cache
entry with its token ids, in the JAX server's _save_session_npz layout:
`ids`, then each group's arrays as "<group>.<name>": kv.* the target
cache's snapshot (n, k, v, k_scale, v_scale), d.* the draft cache's, and
feat.v an EAGLE scheduler's carried feature. The server inflates one in
a child process (load_session_apart): a llama-8b session of 1,536 tokens
is ~100 MB of arrays, and inflating them in a thread of the server holds
the interpreter lock its scheduler thread needs between kernel launches.
This module imports only numpy at run time, so that child starts fast.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from .cache import KVCache


def save_prefix(kv: KVCache, path: str | os.PathLike, slot: int = 0,
                length: int | None = None) -> int:
    """Write the slot's first `length` (default: pos) tokens to `path`;
    returns that count."""
    n = int(kv.pos[slot]) if length is None else int(length)
    snap = kv.snapshot_to_host(kv.save_slot_prefix(slot, n))
    np.savez_compressed(path, k=snap["k"], v=snap["v"],
                        quantized=np.asarray(True), n=np.asarray(n),
                        k_scale=snap["k_scale"], v_scale=snap["v_scale"])
    return n


def load_prefix(kv: KVCache, path: str | os.PathLike, slot: int = 0) -> int:
    """Write a saved prefix into the slot in place (a paged cache: into
    its allocated pages); its pos and mask then cover exactly the prefix.
    Returns the prefix's length."""
    with np.load(path) as z:
        if not bool(z["quantized"]):
            raise ValueError("KV quantization mode mismatch")
        host = {"n": int(z["n"]),
                **{k: z[k] for k in ("k", "v", "k_scale", "v_scale")}}
    kv.restore_slot_prefix(slot, kv.snapshot_from_host(host))
    return host["n"]


def save_session(path: str | os.PathLike, ids: list[int],
                 groups: dict) -> None:
    """Write a session: its token ids and its entry's groups ({"kv":
    {...}[, "d": {...}][, "feat": {"v": ...}]}, host arrays)."""
    flat = {"ids": np.asarray(ids, np.int64)}
    for group, sub in groups.items():
        for name, arr in sub.items():
            flat[f"{group}.{name}"] = np.asarray(arr)
    np.savez_compressed(path, **flat)


def _session(entries) -> tuple[list[int], dict]:
    """(token ids, groups) from a session file's (key, array) pairs."""
    ids, groups = [], {}
    for key, arr in entries:
        if key == "ids":
            ids = [int(t) for t in arr]
            continue
        group, _, name = key.partition(".")
        groups.setdefault(group, {})[name] = int(arr) if name == "n" else arr
    return ids, groups


def load_session(path: str | os.PathLike) -> tuple[list[int], dict]:
    """(token ids, groups of host arrays; each group's n an int) of a
    session file."""
    with np.load(path) as z:
        return _session((key, z[key]) for key in z.files)


def unpack_session(path: str | os.PathLike, out_dir: str) -> None:
    """Inflate a session file into out_dir, an uncompressed .npy file an
    entry (load_session_apart's child)."""
    with np.load(path) as z:
        for key in z.files:
            np.save(os.path.join(out_dir, key + ".npy"), z[key])


_UNPACK = ("import importlib.util as u, sys; "
           f"s = u.spec_from_file_location('persist', {__file__!r}); "
           "m = u.module_from_spec(s); s.loader.exec_module(m); "
           "m.unpack_session(sys.argv[1], sys.argv[2])")


def load_session_apart(path: str | os.PathLike) -> tuple[list[int], dict]:
    """load_session, with the file inflated by a child process (`python
    -c` over this file alone: numpy, nothing of the caller's `__main__`)
    and its arrays mapped back from uncompressed files, so this process
    only maps them. A file the child cannot read is a ValueError."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no session file {path}")
    with tempfile.TemporaryDirectory() as tmp:
        done = subprocess.run([sys.executable, "-c", _UNPACK, str(path), tmp],
                              capture_output=True, text=True)
        if done.returncode:
            why = (done.stderr.strip().splitlines() or ["no message"])[-1]
            raise ValueError(f"session file {path}: {why}")
        # copy-on-write maps: writable arrays, still valid once the
        # files are gone
        return _session(
            (name[:-len(".npy")],
             np.load(os.path.join(tmp, name), mmap_mode="c"))
            for name in sorted(os.listdir(tmp)))
