"""The port stands alone: it imports neither jax nor any module of
powerserve_tpu (nor aiohttp, PIL, transformers, httpx or safetensors:
it has its own code for what the JAX package takes from them), its
kernel wrappers run the plain twins on CPU tensors, and its entry points
refuse to fall back to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "powerserve_tpu_torch"
BLOCKED = ("jax", "jaxlib", "powerserve_tpu", "aiohttp", "PIL",
           "transformers", "httpx", "safetensors")


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
            if top in BLOCKED:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_no_environment_reads():
    """The port takes no knob from the environment: every setting is an
    argument or a flag."""
    bad = []
    for f in _port_sources() + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(f.read_text())):
            name = None
            if isinstance(node, ast.Attribute) and node.attr in (
                    "environ", "getenv", "environb", "getenvb"):
                name = node.attr
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                name = next((a.name for a in node.names if a.name in (
                    "environ", "getenv", "environb", "getenvb")), None)
            if name:
                bad.append(f"{f.relative_to(ROOT)}:{node.lineno}: {name}")
    assert not bad, bad


def test_relative_imports_resolve():
    """Every module a port source imports from within the package exists:
    no import that can only fail (and be swallowed)."""
    bad = []
    for f in _port_sources():
        for node in ast.walk(ast.parse(f.read_text())):
            if not isinstance(node, ast.ImportFrom) or not node.level:
                continue
            base = f.parent
            for _ in range(node.level - 1):
                base = base.parent
            parts = (node.module or "").split(".") if node.module else []
            target = base.joinpath(*parts)
            if not (target.with_suffix(".py").exists()
                    or (target / "__init__.py").exists()):
                bad.append(f"{f.relative_to(ROOT)}:{node.lineno}: "
                           f"{'.' * node.level}{node.module}")
    assert not bad, bad


def test_imports_with_jax_blocked():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in _port_sources() if p.name != "__init__.py"]
    code = ("import sys\n"
            f"for m in {BLOCKED!r}:\n"
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
    from powerserve_tpu_torch.ops.flash_decode import (flash_decode_paged,
                                                       flash_decode_quant)
    from powerserve_tpu_torch.ops.flash_prefill import flash_prefill_quant
    from powerserve_tpu_torch.core.quant import quantize, repack_gguf_tensor
    from powerserve_tpu_torch.ops.fused import fused_linear
    from powerserve_tpu_torch.ops.moe import combine, group_dispatch
    from powerserve_tpu_torch.ops.qmatmul import (QLinear, qmatmul,
                                                  qmatmul_grouped)

    import numpy as np

    before = cuda_lib.launch_counts()
    lin = QLinear.from_float(np.ones((64, 32), np.float32), GGMLType.Q8_0,
                             device="cpu")
    qmatmul(torch.ones(2, 64), lin)
    fused_linear(lin, norm=(torch.ones(1, 64), torch.ones(64)), argmax=True)
    stack = QLinear.stack([lin, lin])
    topi = torch.tensor([[1, 0]])
    tok, w, tile_e = group_dispatch(topi, torch.ones(1, 2), 2, 0, 16)
    y = qmatmul_grouped(torch.ones(tok.shape[0], 64), stack, tile_e, 16)
    combine(y, tok, w, 1, 2)
    w8 = QLinear.from_quantized(repack_gguf_tensor(
        quantize(np.ones((32, 128), np.float32), GGMLType.Q8_0),
        GGMLType.Q8_0, (32, 128)), device="cpu", mxu=True)
    assert w8.w8
    qmatmul(torch.ones(3, 128), w8)
    fused_linear(w8, norm=(torch.ones(1, 128), torch.ones(128)), argmax=True)
    kq = torch.zeros(1, 1, 8, 16, dtype=torch.int8)
    ks = torch.zeros(1, 1, 8)
    flash_decode_quant(torch.ones(1, 1, 2, 16), kq, ks, kq, ks,
                       torch.ones(1, 8, dtype=torch.bool),
                       torch.zeros(1, 1, dtype=torch.int32), 0.25)
    flash_prefill_quant(torch.ones(1, 20, 2, 16), kq, ks, kq, ks,
                        torch.zeros(1, 8, dtype=torch.bool),
                        torch.zeros(1, dtype=torch.int32), 0.25)
    flash_decode_paged(torch.ones(1, 1, 2, 16), kq, ks, kq, ks,
                       torch.zeros(1, 1, dtype=torch.int32),
                       torch.ones(1, 8, dtype=torch.bool),
                       torch.zeros(1, 1, dtype=torch.int32), 0.25)
    assert cuda_lib.launch_counts() == before


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.engine.generator import InferenceEngine
    from powerserve_tpu_torch.engine.scheduler import BatchScheduler
    from powerserve_tpu_torch.kv.cache import KVCache
    from powerserve_tpu_torch.kv.paged import PagedKVCache
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.serving import server
    from powerserve_tpu_torch.serving.local import LocalServer
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache.create(1, 1, 8, 1, 16, n_pages=2, page_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.ServerContext(ws)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalServer(ws)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["-d", str(ws), "--port", "0"])
    from powerserve_tpu_torch.models import internvl

    for load in (internvl.internvl_from_hf_dir, internvl.load_internvl):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(tmp_path)
    # asked for explicitly, the CPU works
    assert run.main(["-d", str(ws), "-n", "2", "--temperature", "0",
                     "--device", "cpu", "--no-progress"]) == 0


def test_speculation_runs_the_twins_and_defaults_to_cuda(tmp_path):
    """Every fused-linear mode and the state mode run their twins on CPU
    tensors (no launch counted); the chain engine and `run --self-draft-
    layers` refuse to fall back to the CPU on their own."""
    import numpy as np

    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.gguf import GGMLType
    from powerserve_tpu_torch.ops import cuda_lib
    from powerserve_tpu_torch.ops.flash_decode import (
        flash_decode_paged, flash_decode_paged_deferred)
    from powerserve_tpu_torch.ops.fused import fused_linear
    from powerserve_tpu_torch.ops.qmatmul import QLinear
    from powerserve_tpu_torch.models.loader import load_gguf_model
    from powerserve_tpu_torch.speculative.chain import ChainSpecEngine
    from powerserve_tpu_torch.tools.synthetic import make_synthetic_gguf

    before = cuda_lib.launch_counts()
    lin = QLinear.from_float(np.ones((64, 32), np.float32), GGMLType.Q8_0,
                             device="cpu")
    x = torch.ones(2, 64)
    fused_linear(lin, x=x, argmax=True)
    fused_linear(lin, norm=(x, x, x, torch.ones(64)), bias=torch.ones(32),
                 resids=(torch.ones(2, 32), torch.ones(2, 32)))
    fused_linear(lin, glu=torch.ones(2, 128))
    fused_linear(lin, parts=(x[:, :16], x[:, 16:]))
    kq = torch.zeros(1, 1, 8, 16, dtype=torch.int8)
    ks = torch.zeros(1, 1, 8)
    pt = torch.zeros(1, 1, dtype=torch.int32)
    mask = torch.ones(1, 8, dtype=torch.bool)
    q = torch.ones(1, 2, 2, 16)
    flash_decode_paged(q, kq, ks, kq, ks, pt, mask, None, 0.25, state=True)
    new, news = torch.zeros(1, 1, 2, 16, dtype=torch.int8), torch.ones(1, 1, 2)
    flash_decode_paged_deferred(q, kq, ks, kq, ks, pt, mask, new, news, new,
                                news, torch.ones(1, 2, 2, dtype=torch.bool),
                                0.25)
    assert cuda_lib.launch_counts() == before
    if torch.cuda.is_available():
        return
    ws = make_synthetic_gguf(tmp_path, "tiny", GGMLType.Q8_0, seq_len=32)
    cfg, model = load_gguf_model(ws / "model", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChainSpecEngine(model, cfg, self_draft_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["-d", str(ws), "-n", "1", "--self-draft-layers", "1"])


def test_vlm_entry_points_default_to_cuda(tmp_path):
    """The VLM loader, engine and device params run on cuda by default
    and raise without a GPU; `run --image` too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    import numpy as np

    from powerserve_tpu_torch import run
    from powerserve_tpu_torch.core.image import encode_png
    from powerserve_tpu_torch.engine.vlm import VLMEngine
    from powerserve_tpu_torch.models.internvl import internvl_from_workspace
    from powerserve_tpu_torch.tools.bench_params import (
        make_device_internvl, make_device_vision_params)
    from powerserve_tpu_torch.tools.synthetic import make_vlm_workspace

    ws = make_vlm_workspace(tmp_path, "tiny-vlm", seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        internvl_from_workspace(ws / "model")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_vision_params("tiny-vit", 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_internvl("tiny-vlm", "q8_0")
    model = internvl_from_workspace(ws / "model", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VLMEngine(model)
    png = tmp_path / "a.png"
    png.write_bytes(encode_png(np.zeros((8, 8, 3), np.uint8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["-d", str(ws), "-n", "1", "--image", str(png)])
    assert run.main(["-d", str(ws), "-n", "2", "--image", str(png),
                     "--device", "cpu", "--no-progress"]) == 0
