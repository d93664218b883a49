"""ctypes bindings for the port's native host runtime
(csrc/host/gguf_loader.cpp: the GGUF reader over mmap (or another
loading strategy), the multithreaded weight repack at load, the fp16
conversion and the tokenizer's merge loop; csrc/host/jpeg_decode.cpp:
the JPEG decoder of core/image.py).

The library is built from both sources with g++ at first use into
powerserve_tpu_torch/_build/<hash of the sources and flags>/, under a
file lock and through a temporary name, so processes that start at once
(test workers, server ranks) build it once and never load a half-written
file. A failed build raises with the compiler's output: nothing falls
back to the Python code quietly. The Python twins (core/quant.py's
repack_gguf_tensor, core/gguf.py's GGUFReader, the merge loop in
tokenizer/vocab.py) stay as the references the tests hold this library
to.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .gguf import GGMLType, tensor_nbytes
from .logging import get_logger
from .quant import choose_pack_group

log = get_logger("native")

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host" / "gguf_loader.cpp"
JPEG_SOURCE = PKG_DIR / "csrc" / "host" / "jpeg_decode.cpp"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libpowerserve_native.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LINK_FLAGS = ["-lpthread"]

_lib: ctypes.CDLL | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the runtime (if these sources and flags are not built
    under root yet) and return the shared library's path."""
    sources = (SOURCE, JPEG_SOURCE)
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = Path(root) / h.hexdigest()[:16]
    so = out / LIB_NAME
    if so.exists():
        return so
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while we waited
            return so
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("g++ not found: the port's native runtime "
                               f"({', '.join(s.name for s in sources)}) is "
                               "built with it at first use")
        tmp = out / f"{LIB_NAME}.tmp{os.getpid()}"
        r = subprocess.run([cxx, *CXX_FLAGS, *map(str, sources),
                            *LINK_FLAGS, "-o", str(tmp)],
                           capture_output=True, text=True)
        if r.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("building the native runtime failed "
                               f"({cxx}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
        log.info(f"built {so}")
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded runtime (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.psv_open.restype = ctypes.c_void_p
    lib.psv_open.argtypes = [ctypes.c_char_p]
    lib.psv_open_ex.restype = ctypes.c_void_p
    lib.psv_open_ex.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.psv_close.restype = None
    lib.psv_close.argtypes = [ctypes.c_void_p]
    lib.psv_meta_json.restype = ctypes.c_char_p
    lib.psv_meta_json.argtypes = [ctypes.c_void_p]
    lib.psv_tensor_count.restype = ctypes.c_int64
    lib.psv_tensor_count.argtypes = [ctypes.c_void_p]
    lib.psv_tensor_info.restype = ctypes.c_int
    lib.psv_tensor_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.psv_tensor_data.restype = _u8p
    lib.psv_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    for name in ("psv_repack_q4_0", "psv_repack_q8_0", "psv_repack_q4_k",
                 "psv_repack_q6_k", "psv_fp16_to_f32",
                 "psv_vocab_set_merges", "psv_vocab_free"):
        getattr(lib, name).restype = None
    lib.psv_repack_q4_0.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, _u8p, _f32p]
    lib.psv_repack_q8_0.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                    _i8p, _f32p]
    lib.psv_repack_q4_k.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, _u8p, _f32p, _f32p]
    lib.psv_repack_q6_k.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                    _i8p, _f32p]
    lib.psv_fp16_to_f32.argtypes = [_u8p, ctypes.c_int64, _f32p]
    lib.psv_vocab_create.restype = ctypes.c_void_p
    lib.psv_vocab_create.argtypes = [_u8p, _i64p, ctypes.c_int64, _f32p,
                                     _i32p, ctypes.c_int32]
    lib.psv_vocab_set_merges.argtypes = [ctypes.c_void_p, _u8p, _i64p,
                                         ctypes.c_int64]
    lib.psv_vocab_free.argtypes = [ctypes.c_void_p]
    for name in ("psv_spm_encode", "psv_bpe_encode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                       _i32p]
    lib.psv_jpeg_decode.restype = ctypes.c_int
    lib.psv_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(_u8p), ctypes.c_char_p, ctypes.c_int]
    lib.psv_jpeg_free.restype = None
    lib.psv_jpeg_free.argtypes = [_u8p]
    _lib = lib
    return lib


def _blob(strings: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """UTF-8 strings as one byte blob and their offsets [n + 1]."""
    parts = [t.encode("utf-8") for t in strings]
    offs = np.zeros(len(parts) + 1, np.int64)
    offs[1:] = np.cumsum([len(b) for b in parts])
    blob = np.frombuffer(b"".join(parts) or b"\x00", np.uint8).copy()
    return blob, offs


class NativeVocab:
    """The C++ merge loop over a vocabulary: the same ids as
    tokenizer/vocab.py's Python loop (its twin), SPM by scores and BPE by
    merge ranks."""

    def __init__(self, tokens: list[str], scores, byte_tokens: dict,
                 unk_id: int, merges: list[str] | None):
        lib = self._lib = get_lib()
        blob, offs = _blob(tokens)
        sc = None
        if scores is not None:
            self._scores = np.asarray(scores, np.float32)
            sc = _ptr(self._scores, _f32p)
        bt = np.full(256, -1, np.int32)
        for b, tid in byte_tokens.items():
            bt[b] = tid
        self._h = lib.psv_vocab_create(_ptr(blob, _u8p), _ptr(offs, _i64p),
                                       len(tokens), sc, _ptr(bt, _i32p),
                                       unk_id)
        if merges:
            mblob, moffs = _blob(merges)
            lib.psv_vocab_set_merges(self._h, _ptr(mblob, _u8p),
                                     _ptr(moffs, _i64p), len(merges))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.psv_vocab_free(h)

    def _encode(self, fn, text: str) -> list[int]:
        b = text.encode("utf-8")
        out = np.empty(max(4 * len(b), 8), np.int32)
        n = fn(self._h, b, len(b), _ptr(out, _i32p))
        return out[:n].tolist()

    def spm_encode(self, text: str) -> list[int]:
        return self._encode(self._lib.psv_spm_encode, text)

    def bpe_encode(self, word: str) -> list[int]:
        return self._encode(self._lib.psv_bpe_encode, word)


LOAD_METHODS = {"mmap": 0, "bio": 1, "dio": 2, "async": 3}


class NativeGGUFReader:
    """The C++ GGUF parser: metadata and tensor payloads as
    core/gguf.py's GGUFReader gives them (its twin). method: the loading
    strategy, mmap (default), bio, dio or async."""

    def __init__(self, path: str | os.PathLike, method: str = "mmap"):
        if method not in LOAD_METHODS:
            raise ValueError(f"unknown file load method: {method}")
        lib = self._lib = get_lib()
        self._h = lib.psv_open_ex(os.fspath(path).encode(),
                                  LOAD_METHODS[method])
        if not self._h:
            raise ValueError(f"psv_open failed for {path}")
        self.metadata = json.loads(lib.psv_meta_json(self._h).decode())
        # name -> (ggml type, data offset, dims)
        self.tensors: dict[str, tuple[int, int, tuple[int, ...]]] = {}
        self._index: dict[str, int] = {}
        for i in range(lib.psv_tensor_count(self._h)):
            name = ctypes.c_char_p()
            ggml_type = ctypes.c_uint32()
            n_dims = ctypes.c_uint32()
            ne = (ctypes.c_uint64 * 4)()
            off = ctypes.c_uint64()
            lib.psv_tensor_info(self._h, i, ctypes.byref(name),
                                ctypes.byref(ggml_type), ctypes.byref(n_dims),
                                ne, ctypes.byref(off))
            nm = name.value.decode()
            self._index[nm] = i
            self.tensors[nm] = (int(ggml_type.value), int(off.value),
                                tuple(int(ne[d]) for d in range(n_dims.value)))

    def tensor_raw(self, name: str) -> np.ndarray:
        """The payload's bytes (a view of the reader's memory: valid until
        close)."""
        ggml_type, _, ne = self.tensors[name]
        nbytes = tensor_nbytes(ggml_type, int(np.prod(ne)) if ne else 1)
        ptr = self._lib.psv_tensor_data(self._h, self._index[name])
        return np.ctypeslib.as_array(ptr, shape=(nbytes,))

    def close(self) -> None:
        if self._h:
            self._lib.psv_close(self._h)
            self._h = None


NATIVE_REPACK_TYPES = (GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_K,
                       GGMLType.Q6_K)


def native_repack(payload: np.ndarray, ggml_type: int, n_out: int,
                  k_in: int):
    """The C++ repack of a GGUF payload [n_out rows, k_in] ->
    (q, scales, bias, pack group, unsigned) in core/quant.py's layout,
    4-bit formats nibble-packed by choose_pack_group(k_in) groups (Q4_0
    stored +8), Q6_K requantized to per-32 int8. None for another type
    (the caller repacks those with core/quant.py)."""
    if ggml_type not in NATIVE_REPACK_TYPES:
        return None
    lib = get_lib()
    payload = np.ascontiguousarray(payload, np.uint8)
    pp = _ptr(payload, _u8p)
    scales = np.empty((k_in // 32, n_out), np.float32)
    sp = _ptr(scales, _f32p)
    if ggml_type in (GGMLType.Q4_0, GGMLType.Q4_K):
        group = choose_pack_group(k_in)
        q = np.zeros((k_in // 2, n_out), np.uint8)
        if ggml_type == GGMLType.Q4_0:
            lib.psv_repack_q4_0(pp, n_out, k_in, group, _ptr(q, _u8p), sp)
            return q, scales, None, group, False
        bias = np.empty((k_in // 32, n_out), np.float32)
        lib.psv_repack_q4_k(pp, n_out, k_in, group, _ptr(q, _u8p), sp,
                            _ptr(bias, _f32p))
        return q, scales, bias, group, True
    q = np.empty((k_in, n_out), np.int8)
    fn = (lib.psv_repack_q8_0 if ggml_type == GGMLType.Q8_0
          else lib.psv_repack_q6_k)
    fn(pp, n_out, k_in, _ptr(q, _i8p), sp)
    return q, scales, None, 0, False


def jpeg_decode(data: bytes, max_pixels: int
                ) -> tuple[int, np.ndarray | str]:
    """csrc/host/jpeg_decode.cpp on JPEG bytes: (0, RGB uint8 [H, W, 3]),
    or (1, why) for a corrupt or truncated stream (or more than
    max_pixels pixels), or (2, what) for a JPEG of a kind not taken."""
    lib = get_lib()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rgb = _u8p()
    err = ctypes.create_string_buffer(256)
    status = lib.psv_jpeg_decode(data, len(data), max_pixels,
                                 ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(rgb), err, len(err))
    if status:
        return status, err.value.decode(errors="replace")
    try:
        out = np.ctypeslib.as_array(rgb, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.psv_jpeg_free(rgb)
    return 0, out


def fp16_to_f32(payload: np.ndarray) -> np.ndarray:
    """IEEE half values (as their bytes or as float16) -> f32."""
    raw = np.ascontiguousarray(payload).view(np.uint8)
    out = np.empty(raw.size // 2, np.float32)
    get_lib().psv_fp16_to_f32(_ptr(raw, _u8p), out.size, _ptr(out, _f32p))
    return out
