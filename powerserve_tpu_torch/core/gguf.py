"""GGUF file reader/writer (pure numpy + mmap).

A from-scratch implementation of the GGUF v3 container format so that
workspaces built for the reference engine (weights.gguf / vocab.gguf,
see reference src/model/llama/llama_model.cpp:32-47 and
src/tokenizer/tokenizer.cpp:22-48) load directly into this framework.

Format constants follow the public GGUF spec (magic "GGUF", version 3,
little-endian, default data alignment 32; reference
libs/ggml/include/ggml.h:265-269, 2428-2441 documents the same enums).

Tensor dims in a GGUF file are stored innermost-first (ggml `ne[]`
order): a row-major [n_rows, n_cols] matrix is stored with
dims = [n_cols, n_rows]. `GGUFTensorInfo.shape` keeps numpy
(outermost-first) order; `.ne` keeps the raw file order.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGMLType(IntEnum):
    """ggml tensor dtypes (subset we support; ids are the public enum)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    IQ4_NL = 20
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_elements, bytes_per_block)
GGML_TYPE_LAYOUT: dict[int, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.Q4_0: (32, 2 + 16),
    GGMLType.Q4_1: (32, 2 + 2 + 16),
    GGMLType.Q5_0: (32, 2 + 4 + 16),
    GGMLType.Q5_1: (32, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (32, 2 + 32),
    GGMLType.Q2_K: (256, 16 + 64 + 2 + 2),
    GGMLType.Q3_K: (256, 32 + 64 + 12 + 2),
    GGMLType.Q4_K: (256, 2 + 2 + 12 + 128),
    GGMLType.Q5_K: (256, 2 + 2 + 12 + 32 + 128),
    GGMLType.Q6_K: (256, 128 + 64 + 16 + 2),
    GGMLType.IQ4_NL: (32, 2 + 16),
    GGMLType.IQ4_XS: (256, 2 + 2 + 4 + 128),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.F64: (1, 8),
    GGMLType.BF16: (1, 2),
}


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def tensor_nbytes(ggml_type: int, n_elements: int) -> int:
    block, nbytes = GGML_TYPE_LAYOUT[ggml_type]
    if n_elements % block != 0:
        raise ValueError(
            f"n_elements={n_elements} not a multiple of block={block} "
            f"for ggml type {ggml_type}"
        )
    return (n_elements // block) * nbytes


@dataclass
class GGUFTensorInfo:
    name: str
    ne: tuple[int, ...]  # raw ggml order (innermost first)
    ggml_type: int
    offset: int  # relative to start of data section

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy-order shape (outermost first)."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.ggml_type, self.n_elements)


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return val

    def read_string(self) -> str:
        n = self.read("<Q")
        raw = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def read_value(self, vtype: int) -> Any:
        vtype = GGUFValueType(vtype)
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = self.read("<I")
            count = self.read("<Q")
            if elem_type == GGUFValueType.STRING:
                return [self.read_string() for _ in range(count)]
            if elem_type == GGUFValueType.ARRAY:
                return [self.read_value(elem_type) for _ in range(count)]
            fmt = _SCALAR_FMT[GGUFValueType(elem_type)]
            itemsize = struct.calcsize(fmt)
            arr = np.frombuffer(
                self.buf, dtype=np.dtype(fmt[1]).newbyteorder("<"),
                count=count, offset=self.pos,
            )
            self.pos += itemsize * count
            return arr.copy()
        return self.read(_SCALAR_FMT[vtype])


def _load_file(path: str, method: str) -> tuple[Any, Any, memoryview]:
    """File-loading strategies (reference src/storage/file_loader.cpp:16-35
    strategy factory: MMap / BIO buffered / DIO O_DIRECT / UV async).

    Returns (file_obj, mm_or_none, view). "mmap" gives zero-copy views;
    the read strategies materialize the file in anonymous memory —
    "bio" is one buffered read, "dio" bypasses the page cache
    (O_DIRECT, page-aligned anonymous map), "async" overlaps pread
    ranges across threads (the reference's libuv role)."""
    f = open(path, "rb")
    size = os.fstat(f.fileno()).st_size
    if method == "mmap":
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return f, mm, memoryview(mm)
    buf = mmap.mmap(-1, max(size, 1))  # page-aligned anonymous buffer
    if method == "dio":
        try:
            fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECT", 0))
            try:
                align = 4096
                aligned = size // align * align
                off = 0
                view = memoryview(buf)
                while off < aligned:
                    chunk = min(aligned - off, 16 << 20)
                    n = os.preadv(fd, [view[off:off + chunk]], off)
                    if n <= 0 or n % align:
                        raise OSError("short O_DIRECT read")
                    off += n
            finally:
                os.close(fd)
            if aligned < size:  # unaligned tail via the buffered handle
                f.seek(aligned)
                buf[aligned:size] = f.read(size - aligned)
            return f, buf, memoryview(buf)
        except OSError:
            pass  # filesystem without O_DIRECT: fall through to bio
    if method == "async":
        import concurrent.futures as _fut

        chunk = 8 << 20
        view = memoryview(buf)

        def read_range(off: int) -> None:
            want = min(size - off, chunk)
            done = 0
            while done < want:
                n = os.preadv(f.fileno(),
                              [view[off + done:off + want]], off + done)
                if n <= 0:
                    raise OSError(f"short read at {off + done}")
                done += n

        with _fut.ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(read_range, range(0, max(size, 1), chunk)))
        return f, buf, memoryview(buf)
    # bio: one buffered sequential read
    f.seek(0)
    got = f.readinto(buf)
    if size and got != size:
        raise OSError(f"short read: {got}/{size}")
    return f, buf, memoryview(buf)


class GGUFReader:
    """GGUF reader with pluggable file-loading strategy.

    Tensor payloads are exposed as zero-copy numpy uint8 views into the
    loaded buffer; `dequantize()` in quant.py turns them into float
    arrays. method: "mmap" (default) | "bio" | "dio" | "async" — see
    _load_file; default overridable via POWERSERVE_FILE_LOAD.
    """

    def __init__(self, path: str | os.PathLike, method: str | None = None):
        self.path = os.fspath(path)
        method = method or os.environ.get("POWERSERVE_FILE_LOAD", "mmap")
        if method not in ("mmap", "bio", "dio", "async"):
            raise ValueError(f"unknown file load method: {method}")
        self.method = method
        self._file, self._mm, self._view = _load_file(self.path, method)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse()

    def _parse(self) -> None:
        r = _Reader(self._view)
        magic = bytes(self._view[:4])
        r.pos = 4
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic={magic!r})")
        version = r.read("<I")
        if version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {version}")
        n_tensors = r.read("<Q")
        n_kv = r.read("<Q")
        for _ in range(n_kv):
            key = r.read_string()
            vtype = r.read("<I")
            self.metadata[key] = r.read_value(vtype)
        for _ in range(n_tensors):
            name = r.read_string()
            n_dims = r.read("<I")
            ne = tuple(r.read("<Q") for _ in range(n_dims))
            ggml_type = r.read("<I")
            offset = r.read("<Q")
            self.tensors[name] = GGUFTensorInfo(name, ne, ggml_type, offset)
        alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.data_offset = (r.pos + alignment - 1) // alignment * alignment

    def tensor_raw(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of the tensor's on-disk payload."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.frombuffer(self._view, dtype=np.uint8,
                             count=info.nbytes, offset=start)

    def tensor_float(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in numpy-order shape."""
        from .quant import dequantize

        info = self.tensors[name]
        return dequantize(self.tensor_raw(name), info.ggml_type).reshape(info.shape)

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            # zero-copy tensor views are still alive; leave the mapping open
            # (the OS reclaims it at process exit)
            pass
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


@dataclass
class GGUFWriter:
    """Minimal GGUF v3 writer (used by tests and the model converter)."""

    metadata: dict[str, Any] = field(default_factory=dict)
    _tensors: list[tuple[str, tuple[int, ...], int, bytes]] = field(default_factory=list)
    alignment: int = GGUF_DEFAULT_ALIGNMENT

    def add_tensor(self, name: str, ne: tuple[int, ...], ggml_type: int,
                   payload: bytes | np.ndarray) -> None:
        payload = bytes(np.ascontiguousarray(payload).view(np.uint8)) \
            if isinstance(payload, np.ndarray) else bytes(payload)
        n = 1
        for d in ne:
            n *= d
        expect = tensor_nbytes(ggml_type, n)
        if len(payload) != expect:
            raise ValueError(f"{name}: payload {len(payload)}B != expected {expect}B")
        self._tensors.append((name, tuple(ne), int(ggml_type), payload))

    def add_float_tensor(self, name: str, arr: np.ndarray) -> None:
        """Convenience: store a numpy-order float array as F32."""
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        self.add_tensor(name, tuple(reversed(arr.shape)), GGMLType.F32, arr.tobytes())

    @staticmethod
    def _pack_string(s: str) -> bytes:
        raw = s.encode("utf-8")
        return struct.pack("<Q", len(raw)) + raw

    def _pack_value(self, v: Any) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", GGUFValueType.BOOL) + struct.pack("<?", v)
        if isinstance(v, int):
            if v < 0:
                return struct.pack("<I", GGUFValueType.INT64) + struct.pack("<q", v)
            return struct.pack("<I", GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64) \
                + (struct.pack("<I", v) if v < 2**32 else struct.pack("<Q", v))
        if isinstance(v, float):
            return struct.pack("<I", GGUFValueType.FLOAT32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", GGUFValueType.STRING) + self._pack_string(v)
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            if not v:
                return (struct.pack("<I", GGUFValueType.ARRAY)
                        + struct.pack("<I", GGUFValueType.INT32) + struct.pack("<Q", 0))
            out = struct.pack("<I", GGUFValueType.ARRAY)
            if isinstance(v[0], str):
                out += struct.pack("<I", GGUFValueType.STRING) + struct.pack("<Q", len(v))
                for s in v:
                    out += self._pack_string(s)
            elif isinstance(v[0], float):
                out += struct.pack("<I", GGUFValueType.FLOAT32) + struct.pack("<Q", len(v))
                out += np.asarray(v, dtype="<f4").tobytes()
            elif isinstance(v[0], (int, np.integer)):
                out += struct.pack("<I", GGUFValueType.INT32) + struct.pack("<Q", len(v))
                out += np.asarray(v, dtype="<i4").tobytes()
            else:
                raise TypeError(f"unsupported array element {type(v[0])}")
            return out
        raise TypeError(f"unsupported metadata value type {type(v)}")

    def write(self, path: str | os.PathLike) -> None:
        header = bytearray()
        header += GGUF_MAGIC
        header += struct.pack("<I", GGUF_VERSION)
        header += struct.pack("<Q", len(self._tensors))
        header += struct.pack("<Q", len(self.metadata))
        for k, v in self.metadata.items():
            header += self._pack_string(k)
            header += self._pack_value(v)
        # tensor infos with aligned running offsets
        offset = 0
        infos = bytearray()
        offsets = []
        for name, ne, ggml_type, payload in self._tensors:
            offset = (offset + self.alignment - 1) // self.alignment * self.alignment
            offsets.append(offset)
            infos += self._pack_string(name)
            infos += struct.pack("<I", len(ne))
            for d in ne:
                infos += struct.pack("<Q", d)
            infos += struct.pack("<I", ggml_type)
            infos += struct.pack("<Q", offset)
            offset += len(payload)
        head = bytes(header) + bytes(infos)
        data_start = (len(head) + self.alignment - 1) // self.alignment * self.alignment
        with open(path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * (data_start - len(head)))
            pos = 0
            for (name, ne, ggml_type, payload), off in zip(self._tensors, offsets):
                f.write(b"\x00" * (off - pos))
                f.write(payload)
                pos = off + len(payload)
