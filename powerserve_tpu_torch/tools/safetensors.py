"""The safetensors file format, read and written without the
`safetensors` package (which tools/convert_hf.py would otherwise need).

A file is an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optionally
"__metadata__": {str: str}}, padded with spaces to a multiple of 8),
then the tensors' bytes, little-endian and C-ordered, each at its
offsets from the end of the header.

load_file returns the floating tensors (F32, F16, BF16, F64) as float32
numpy arrays, the integer and boolean ones in their own dtype, in the
order of their data (the order `safetensors.numpy.load_file` gives).
BF16, which numpy lacks, is widened through torch. save_file writes the
bytes the package's save_file writes.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

# safetensors dtype -> numpy dtype of the stored bytes (BF16: torch)
_NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U8": np.uint8, "BOOL": np.bool_}
_FLOAT = {"F64", "F32", "F16", "BF16"}
# save_file's order: by dtype, larger ones first, as the safetensors
# package sorts (its dtype enum's order), then by name
_SAVE_RANK = {"F32": 0, "BF16": 1, "F16": 2}
_SAVE_DTYPE = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}


def read_header(path: str | Path) -> tuple[dict, int]:
    """(the header without "__metadata__", the data's start offset)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str | Path, keep=None) -> dict[str, np.ndarray]:
    """The file's tensors by name (keep: read only the names it takes)."""
    header, start = read_header(path)
    out = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as mm:
        for name, info in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            if keep is not None and not keep(name):
                continue
            dtype, shape = info["dtype"], tuple(info["shape"])
            begin, end = info["data_offsets"]
            raw = mm[start + begin:start + end]
            if dtype == "BF16":
                t = (torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
                     if raw else torch.zeros(0, dtype=torch.bfloat16))
                arr = t.float().numpy()
            elif dtype in _NUMPY:
                arr = np.frombuffer(raw, dtype=np.dtype(_NUMPY[dtype])
                                    .newbyteorder("<")).copy()
            else:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{dtype}, which this reader does not take")
            if dtype in _FLOAT:
                arr = arr.astype(np.float32)
            out[name] = arr.reshape(shape)
    return out


def save_file(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """F32 and F16 numpy arrays, or torch tensors of those dtypes or
    bf16, to a safetensors file (no metadata)."""
    items = []
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                items.append((name, "BF16", list(t.shape),
                              t.view(torch.int16).numpy().tobytes()))
                continue
            t = t.numpy()
        t = np.ascontiguousarray(t)
        if t.dtype not in _SAVE_DTYPE:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} (save_file "
                             f"writes F32, F16 and BF16)")
        items.append((name, _SAVE_DTYPE[t.dtype], list(t.shape),
                      t.astype(t.dtype.newbyteorder("<")).tobytes()))
    items.sort(key=lambda it: (_SAVE_RANK[it[1]], it[0]))
    header = {}
    off = 0
    for name, dtype, shape, data in items:
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [off, off + len(data)]}
        off += len(data)
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for _, _, _, data in items:
            f.write(data)
