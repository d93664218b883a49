"""The port's InternVL path on the CPU against the JAX package's
(models/internvl.py, engine/vlm.py) and against Pillow, which the port
does not use (core/image.py decodes PNG and resizes by itself):

- the PNG decoder bit-equal to Pillow's decode + convert("RGB"), for
  every color type taken and every row filter, also with its wavefront
  cut into bands of rows and its resize into blocks of columns; other
  formats refused;
- preprocess_image (Pillow's bicubic resize, the tiles and the
  thumbnail, the normalization) bit-equal to JAX's PIL path;
- find_best_tile_grid and expand_image_tokens equal;
- embed_multimodal and prefill_multimodal on a workspace both packages
  load (make_vlm_workspace: the tiny text model, the tiny tower), and
  VLMEngine's and `run --image`'s greedy tokens against JAX's VLMEngine;
- an HF InternVL checkpoint dir loaded as it is (internvl_from_hf_dir:
  tests/hf_internvl.py writes one with transformers) against JAX's
  internvl_from_hf on the same transformers model, and `run --image` on
  it with a JPEG.

The language model's logits follow tests/test_torch_model.py's bar:
within 1.5% (JAX's interpret-mode kernels) or 3% (its XLA route) of the
range, and greedy tokens equal up to a near-tie (the JAX top-2 logit
gap < 0.5).
"""

import io
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.core.config import HyperParams as JHyperParams
from powerserve_tpu.engine.vlm import VLMEngine as JVLMEngine
from powerserve_tpu.kv.cache import KVCache as JKVCache
from powerserve_tpu.models import internvl as jivl
from powerserve_tpu_torch import run
from powerserve_tpu_torch.core.config import HyperParams
from powerserve_tpu_torch.core.gguf import GGMLType
from powerserve_tpu_torch.core import image as core_image
from powerserve_tpu_torch.core.image import (decode_image, encode_png,
                                             resize_bicubic)
from powerserve_tpu_torch.engine.vlm import VLMEngine
from powerserve_tpu_torch.kv.cache import KVCache
from powerserve_tpu_torch.models import internvl as ivl
from powerserve_tpu_torch.tools.synthetic import make_vlm_workspace
from hf_internvl import make_hf_internvl
from torch_threads import one_torch_thread  # noqa: F401

Image = pytest.importorskip("PIL.Image")

LOGIT_REL = {"pallas_interpret": 1.5e-2, "xla": 3e-2}
NEAR_TIE = 0.5
IMG_ID = 250


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(workspace model dir, JAX InternVLModel, the port's)."""
    ws = make_vlm_workspace(tmp_path_factory.mktemp("vlm"), "tiny-vlm",
                            GGMLType.Q8_0, seed=0, seq_len=256)
    d = ws / "model"
    return d, jivl.internvl_from_workspace(d), ivl.internvl_from_workspace(
        d, device="cpu")


# -- image input --------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4],
                         ids=["gray", "gray+alpha", "RGB", "RGBA"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_decode_bit_equal_to_pillow(channels, ftype):
    rng = np.random.default_rng(channels * 10 + ftype)
    shape = (19, 27) if channels == 1 else (19, 27, channels)
    data = encode_png(rng.integers(0, 256, shape, dtype=np.uint8), (ftype,))
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_png_palette_bit_equal_to_pillow(bits):
    rng = np.random.default_rng(bits)
    h, w, n = 11, 13, 1 << bits
    idx = rng.integers(0, n, (h, w), dtype=np.uint8)
    img = Image.fromarray(idx, "P")
    img.putpalette(rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes())
    buf = io.BytesIO()
    img.save(buf, format="PNG", bits=bits)
    data = buf.getvalue()
    assert data[24] == bits and data[25] == 3  # IHDR bit depth, palette
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


def test_pillow_written_pngs_and_mixed_filters():
    rng = np.random.default_rng(5)
    for mode in ("L", "LA", "RGB", "RGBA"):
        arr = rng.integers(0, 256, (33, 41, 4), dtype=np.uint8)
        img = Image.fromarray(arr, "RGBA").convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="PNG")  # Pillow's adaptive row filters
        data = buf.getvalue()
        np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))
    data = encode_png(rng.integers(0, 256, (25, 9, 3), dtype=np.uint8),
                      (0, 1, 2, 3, 4))
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


@pytest.mark.parametrize("band_bytes", [1, 4096], ids=["row-by-row",
                                                     "bands"])
def test_bands_and_blocks_bit_equal_to_pillow(monkeypatch, band_bytes):
    """The wavefront in bands of rows (one row, or several with a short
    last band) and the resize in blocks of 50 columns: Pillow's bits."""
    monkeypatch.setattr(core_image, "_BAND_BYTES", band_bytes)
    monkeypatch.setattr(core_image, "_RESAMPLE_BLOCK", 50)
    rng = np.random.default_rng(band_bytes)
    for channels, filters in ((3, (3, 4, 0, 1, 2)), (4, (4,)), (1, (3,))):
        img = rng.integers(0, 256, (37, 23, channels), dtype=np.uint8)
        data = encode_png(img, filters)
        got = decode_image(data)
        np.testing.assert_array_equal(got, _pil_rgb(data))
        for dst in ((50, 17), (9, 80)):
            want = np.asarray(Image.fromarray(got).resize(dst, Image.BICUBIC))
            np.testing.assert_array_equal(resize_bicubic(got, dst), want)


def test_other_formats_are_refused_by_name():
    """What stays refused names FORMATS: WebP, a CMYK JPEG, an
    arithmetic-coded JPEG (its SOF marker), a 2-bit gray PNG. JPEG and
    interlaced PNGs decode (tests/test_torch_jpeg.py)."""
    webp = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(webp, format="WEBP")
    with pytest.raises(ValueError, match="WebP.*the port takes PNG"):
        decode_image(webp.getvalue())
    cmyk = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("CMYK").save(
        cmyk, format="JPEG")
    with pytest.raises(ValueError, match="CMYK.*the port takes PNG"):
        decode_image(cmyk.getvalue())
    plain = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(plain, format="JPEG")
    arith = plain.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1)
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        decode_image(arith)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(buf, format="PNG")
    # an 8-bit gray PNG's IHDR made 2-bit by hand
    data = bytearray(buf.getvalue())
    data[24] = 2
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    with pytest.raises(ValueError, match="2-bit gray PNG.*the port takes"):
        decode_image(bytes(data))
    with pytest.raises(ValueError, match="not a PNG or JPEG file"):
        decode_image(b"hello")
    with pytest.raises(ValueError, match="image array of shape"):
        ivl.preprocess_image(np.zeros((0, 5, 3), np.uint8))


@pytest.mark.parametrize("src,dst", [((300, 600), (896, 448)),
                                     ((700, 500), (448, 448)),
                                     ((61, 999), (17, 230))],
                         ids=["up", "down", "mixed"])
def test_resize_bit_equal_to_pillow(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, dst), want)


@pytest.mark.parametrize("hw,max_num", [((300, 600), 6), ((40, 30), 12),
                                        ((500, 160), 4)],
                         ids=["wide-tiles", "small-up", "tall-down"])
def test_preprocess_image_bit_equal_to_jax(hw, max_num):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,),
                                                dtype=np.uint8)
    want = jivl.preprocess_image(img, tile=56, max_num=max_num)
    got = ivl.preprocess_image(img, tile=56, max_num=max_num)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # 2:1 -> a 2 x 1 grid and the thumbnail, as the JAX test has it
    if hw == (300, 600):
        assert got.shape == (3, 3, 56, 56)


def test_tile_grid_and_token_expansion(models):
    for w, h in ((448, 448), (896, 448), (448, 1344), (1000, 300),
                 (37, 2000)):
        for max_num in (1, 6, 12):
            assert ivl.find_best_tile_grid(w, h, max_num=max_num) == \
                jivl.find_best_tile_grid(w, h, max_num=max_num)
    _, jm, m = models
    assert (m.image_token_id, m.tokens_per_tile, m.image_size) == \
        (jm.image_token_id, jm.tokens_per_tile, jm.image_size) == (IMG_ID, 4,
                                                                   56)
    for ids, n in (([5, IMG_ID, 6], 2), ([5, 6], 1), ([IMG_ID], 3)):
        assert m.expand_image_tokens(ids, n) == jm.expand_image_tokens(ids, n)
    assert m.expand_image_tokens([5, IMG_ID, 6], 2) == [5] + [IMG_ID] * 8 + [6]


# -- the model --------------------------------------------------------------

def _prompt(m, n_tiles: int) -> list[int]:
    return m.expand_image_tokens([1, 7, IMG_ID, 9, 11, 13], n_tiles)


def test_embed_multimodal_matches_jax(models):
    _, jm, m = models
    px = np.random.default_rng(2).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    ids = np.asarray([_prompt(m, 2), _prompt(m, 2)[::-1]], np.int32)
    want = np.asarray(jm.embed_multimodal(jnp.asarray(ids), jnp.asarray(px)))
    got = m.embed_multimodal(torch.from_numpy(ids).long(),
                             torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, ids.shape[1], 64)
    text = ids != IMG_ID
    # the text rows are the same dequantized table rows
    np.testing.assert_array_equal(got[text], want[text])
    assert _rel(got, want) < 1e-4
    # more image tokens than features: the extra take the last row
    many = np.asarray([[IMG_ID] * 11], np.int32)
    want = np.asarray(jm.embed_multimodal(jnp.asarray(many),
                                          jnp.asarray(px)))
    got = m.embed_multimodal(torch.from_numpy(many).long(),
                             torch.from_numpy(px)).numpy()
    assert _rel(got, want) < 1e-4
    np.testing.assert_array_equal(got[0, 8], got[0, 10])


@pytest.mark.parametrize("backend", list(LOGIT_REL))
def test_prefill_multimodal_matches_jax(models, backend):
    _, jm, m = models
    px = np.random.default_rng(3).standard_normal(
        (3, 3, 56, 56)).astype(np.float32)
    ids = _prompt(m, 3)
    llm = m.cfg.llm
    jkv = JKVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads,
                          llm.head_size)
    want, _ = jm.prefill_multimodal(jkv, np.asarray(ids, np.int32), px,
                                    backend=backend)
    kv = KVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    got = m.prefill_multimodal(kv, ids, px)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < LOGIT_REL[backend]
    assert int(kv.pos[0]) == len(ids)
    jax.clear_caches()


def _near_tie_equal(got, want, jm, ids, px):
    """got == want, or they first part where JAX's teacher-forced top-2
    gap is < NEAR_TIE."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        assert got == want
        return
    llm = jm.cfg.llm
    kv = JKVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads, llm.head_size)
    logits, _ = jm.prefill_multimodal(
        kv, np.asarray(ids + want[:i], np.int32), px, backend="xla")
    top2 = np.sort(np.asarray(logits)[0])[-2:]
    assert top2[1] - top2[0] < NEAR_TIE, (i, got, want)


def _images():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (60, 130, 3), dtype=np.uint8),
            rng.integers(0, 256, (50, 50, 3), dtype=np.uint8)]


def test_vlm_engine_greedy_matches_jax(models):
    _, jm, m = models
    images = _images()
    jeng = JVLMEngine(jm, JHyperParams(max_seq_len=64), backend="xla")
    want = list(jeng.generate([1, 5, IMG_ID, 9], images, 8, max_tiles=4))
    eng = VLMEngine(m, HyperParams(max_seq_len=64), device="cpu")
    got = list(eng.generate([1, 5, IMG_ID, 9], images, 8, max_tiles=4))
    px = np.concatenate([jivl.preprocess_image(i, tile=56, max_num=4)
                         for i in images])
    ids = jm.expand_image_tokens([1, 5, IMG_ID, 9], px.shape[0])
    assert len(got) == 8
    _near_tie_equal(got, want, jm, ids, px)
    # a stop ends it and the next prompt starts from a fresh cache
    again = list(eng.generate([1, 5, IMG_ID, 9], images, 8, max_tiles=4,
                              stop_fn=lambda t: t == got[2]))
    assert again == got[:got.index(got[2]) + 1]
    assert list(eng.generate([1, 5, IMG_ID, 9], images, 8,
                             max_tiles=4)) == got
    jax.clear_caches()


def test_run_image_cli_matches_the_engine(models, tmp_path, capsys):
    d, jm, m = models
    images = _images()
    paths = []
    for i, img in enumerate(images):
        paths.append(tmp_path / f"img{i}.png")
        paths[-1].write_bytes(encode_png(img, (4,)))
    argv = ["-d", str(d), "-p", "hello", "-n", "6", "--device", "cpu",
            "--no-progress"]
    for p in paths:
        argv += ["--image", str(p)]
    res = run.run_prompt(run.parse_args(argv))
    eng = VLMEngine(m, HyperParams(max_seq_len=256), device="cpu")
    want = list(eng.generate(res.prompt_ids, images, 6))
    assert res.ids == want and len(want) == 6
    assert capsys.readouterr().out.startswith("hello")
    bad = tmp_path / "x.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    with pytest.raises(ValueError, match="corrupt JPEG"):
        run.run_prompt(run.parse_args(argv[:-2] + ["--image", str(bad)]))


# -- an HF InternVL checkpoint dir, as it is -----------------------------------

@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """(HF dir, JAX's internvl_from_hf of its transformers model, the
    port's internvl_from_hf_dir of the dir)."""
    d = tmp_path_factory.mktemp("hf_internvl")
    model = make_hf_internvl(d)
    return d, jivl.internvl_from_hf(model), ivl.internvl_from_hf_dir(
        d, device="cpu")


def test_hf_dir_matches_jax_internvl_from_hf(hf):
    """Q8_0 text weights and f32 tower from the safetensors, without
    transformers: logits within the XLA route's bar, greedy tokens equal
    up to a near-tie."""
    _, jm, m = hf
    assert (m.image_token_id, m.tokens_per_tile, m.image_size) == (
        jm.image_token_id, jm.tokens_per_tile, jm.image_size)
    assert m.cfg.arch == jm.cfg.arch == "qwen2"
    llm = m.cfg.llm
    assert llm.vocab_size == 320 and m.llm.layers[0].bqkv is not None
    # the engine's own prompt and tiles: JAX compiles its prefill once
    images = _images()[:1]
    px = np.concatenate([jivl.preprocess_image(i, tile=56, max_num=2)
                         for i in images])
    ids = jm.expand_image_tokens([1, 5, IMG_ID, 9], px.shape[0])
    jkv = JKVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads,
                          llm.head_size)
    want, _ = jm.prefill_multimodal(jkv, np.asarray(ids, np.int32), px,
                                    backend="xla")
    kv = KVCache.create(llm.n_layers, 1, 64, llm.n_kv_heads, llm.head_size,
                        device="cpu")
    got = m.prefill_multimodal(kv, ids, px)
    assert _rel(got.numpy(), want) < LOGIT_REL["xla"]
    jeng = JVLMEngine(jm, JHyperParams(max_seq_len=64), backend="xla")
    want = list(jeng.generate([1, 5, IMG_ID, 9], images, 5, max_tiles=2))
    eng = VLMEngine(m, HyperParams(max_seq_len=64), device="cpu")
    got = list(eng.generate([1, 5, IMG_ID, 9], images, 5, max_tiles=2))
    _near_tie_equal(got, want, jm, ids, px)
    jax.clear_caches()


def test_run_image_on_an_hf_dir_with_a_jpeg(hf, tmp_path, capsys):
    d, _, m = hf
    img = _images()[0]
    path = tmp_path / "a.jpg"
    Image.fromarray(img).save(path, "JPEG", quality=85, progressive=True)
    pixels = _pil_rgb(path.read_bytes())
    res = run.run_prompt(run.parse_args([
        "-d", str(d), "-p", "the quick", "-n", "5", "--device", "cpu",
        "--no-progress", "--image", str(path)]))
    eng = VLMEngine(m, HyperParams(max_seq_len=256), device="cpu")
    assert res.ids == list(eng.generate(res.prompt_ids, [pixels], 5))
    assert len(res.ids) == 5
    capsys.readouterr()


def test_local_server_on_an_hf_dir_answers_the_engines_tokens(hf):
    """LocalServer (ServerContext._get) takes the HF dir as it is: a chat
    with a JPEG data URI answers VLMEngine's greedy tokens."""
    import base64

    from powerserve_tpu_torch.serving.local import LocalServer

    d, _, m = hf
    img = _images()[1]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    url = "data:image/jpeg;base64," + base64.b64encode(
        buf.getvalue()).decode()
    with LocalServer(d.parent, d.name, HyperParams(max_slots=1, batch_size=8,
                                                   max_seq_len=128),
                     device="cpu") as srv:
        reply = srv.chat([{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": url}},
            {"type": "text", "text": "the quick fox"}]}], max_tokens=4,
            temperature=0.0)
        mctx = srv.ctx.get(d.name)
        assert mctx.vlm is not None
        tok = mctx.tokenizer
    eng = VLMEngine(m, HyperParams(max_seq_len=128), device="cpu")
    ids = tok.tokenize(tok.apply_chat_template(
        [{"role": "user", "content": "the quick fox"}]))
    want = list(eng.generate(ids, [_pil_rgb(buf.getvalue())], 4))
    assert reply == tok.to_string(want)
