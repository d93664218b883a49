"""The port stands alone: it imports neither jax nor any module of
powerserve_tpu, its kernel wrappers run the plain twins on CPU tensors,
and its entry points refuse to fall back to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "powerserve_tpu_torch"


def _port_sources() -> list[pathlib.Path]:
    """The package's Python files (not the kernel build directory)."""
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.relative_to(PORT).parts)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports():
    files = _port_sources() + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "powerserve_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_imports_with_jax_blocked():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in _port_sources() if p.name != "__init__.py"]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'powerserve_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cpu_tensors_run_the_plain_twins():
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.flash_decode import flash_decode_quant
    from powerserve_tpu_torch.ops.fused import fused_linear
    from powerserve_tpu_torch.ops.qmatmul import QLinear, qmatmul

    import numpy as np

    before = cuda_lib.launch_counts()
    lin = QLinear.from_float(np.ones((64, 32), np.float32), GGMLType.Q8_0,
                             device="cpu")
    qmatmul(torch.ones(2, 64), lin)
    fused_linear(lin, norm=(torch.ones(1, 64), torch.ones(64)), argmax=True)
    kq = torch.zeros(1, 1, 8, 16, dtype=torch.int8)
    ks = torch.zeros(1, 1, 8)
    flash_decode_quant(torch.ones(1, 1, 2, 16), kq, ks, kq, ks,
                       torch.ones(1, 1, 8, dtype=torch.bool), 0.25)
    assert cuda_lib.launch_counts() == before


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.tools.bench_params import make_device_params
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    ws = make_synthetic_gguf(tmp_path, "tiny", GGMLType.Q8_0, seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_gguf_model(ws / "model")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_params("tiny", "q8_0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(1, 1, 8, 1, 16)
    cfg, model = load_gguf_model(ws / "model", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["-d", str(ws), "-n", "1"])
    # asked for explicitly, the CPU works
    assert run.main(["-d", str(ws), "-n", "2", "--temperature", "0",
                     "--device", "cpu", "--no-progress"]) == 0
