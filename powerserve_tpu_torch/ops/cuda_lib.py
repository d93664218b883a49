"""Build, load and count the port's CUDA kernels.

The sources in powerserve_tpu_torch/csrc/*.cu are compiled with nvcc for
sm_90a into one shared library with a plain C interface, loaded with
ctypes. The build happens at first use, into
powerserve_tpu_torch/_build/<hash of the sources and flags>/, one nvcc
process per source started together, then one link. Nothing here runs at
import time: modules that wrap kernels import this file on machines with
neither nvcc nor a GPU.

Every wrapper adds one to its entry of LAUNCHES where it launches its
kernel, so a run can show that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libpowerserve_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

LAUNCHES = {"qmatmul": 0, "fused_head": 0, "flash_decode": 0,
            "flash_prefill": 0, "flash_decode_paged": 0,
            "qmatmul_grouped": 0, "qmatmul_w8": 0, "fused_norm": 0,
            "fused_x": 0, "fused_x_argmax": 0, "fused_glu": 0,
            "fused_concat2": 0, "flash_decode_paged_state": 0,
            "flash_decode_tree": 0, "flash_decode_paged_tree": 0,
            "qmatmul_w8_grouped": 0, "sample": 0,
            "flash_decode_state": 0, "flash_prefill_state": 0,
            "flash_decode_state_tree": 0}
BUILD_INFO: dict = {}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's kernels are built with the CUDA "
            "toolkit on a machine with an NVIDIA GPU")
    return path


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (if this source hash is not built yet) and
    return the shared library's path."""
    out = BUILD_ROOT / _build_key()
    so = out / LIB_NAME
    if so.exists():
        BUILD_INFO.setdefault("dir", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        return so
    nvcc = _nvcc()
    tmp = BUILD_ROOT / f"{out.name}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
         "-o", str(tmp / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / f"{src.stem}.o") for src in sources]],
        capture_output=True, text=True)
    if link.returncode:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    (tmp / "build.log").write_text(log)
    try:
        os.replace(tmp, out)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(dir=str(out), seconds=time.perf_counter() - t0,
                      log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.ps_qmatmul.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
        L.ps_qmatmul.restype = I
        L.ps_qmatmul_grouped.argtypes = [P] * 6 + [I] * 9 + [P]
        L.ps_qmatmul_grouped.restype = I
        L.ps_qmatmul_w8.argtypes = [P] * 6 + [I] * 3 + [P]
        L.ps_qmatmul_w8.restype = I
        L.ps_qmatmul_w8_grouped.argtypes = [P] * 7 + [I] * 5 + [P]
        L.ps_qmatmul_w8_grouped.restype = I
        L.ps_w8_quantize.argtypes = [P] * 3 + [I] * 2 + [P]
        L.ps_w8_quantize.restype = I
        L.ps_fused_linear.argtypes = [I, I, P, P, P, I, I, P, F, P, P, P,
                                      P, I, I, I, I, I, I, I, P, I, P, P,
                                      I, P, P, P, P, P]
        L.ps_fused_linear.restype = I
        L.ps_flash_decode.argtypes = [P] * 11 + [I] * 8 + [F, P]
        L.ps_flash_decode.restype = I
        L.ps_flash_decode_smem.argtypes = [I] * 8
        L.ps_flash_decode_smem.restype = ctypes.c_size_t
        L.ps_flash_decode_geometry.argtypes = [I] * 10 + [P]
        L.ps_flash_decode_geometry.restype = I
        L.ps_flash_decode_paged.argtypes = [P] * 12 + [I] * 9 + [F, P]
        L.ps_flash_decode_paged.restype = I
        L.ps_flash_prefill.argtypes = [P] * 10 + [I] * 7 + [F, I, P]
        L.ps_flash_prefill.restype = I
        L.ps_flash_prefill_smem.argtypes = [I, I]
        L.ps_flash_prefill_smem.restype = ctypes.c_size_t
        L.ps_sample.argtypes = [I] + [P] * 4 + [I] * 4 + [P]
        L.ps_sample.restype = I
        L.ps_empty_launch.argtypes = [P]
        L.ps_empty_launch.restype = I
        _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def max_dynamic_smem(device: torch.device) -> int:
    """Shared memory one block may opt into (232,448 bytes on Hopper)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, device: torch.device,
            dtypes: tuple, shape: tuple | None = None) -> None:
    """Raise unless t lies on `device`, has one of `dtypes`, the given
    shape (None entries match anything) and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
