"""The port's image decoders (core/image.py, csrc/host/jpeg_decode.cpp)
bit-equal to Pillow's `Image.open(...).convert("RGB")`, which the port
does not use:

- the committed JPEG fixtures (tests/data/jpeg/make_fixtures.py: baseline
  and progressive, 4:4:4, 4:2:2, 4:4:0, 4:2:0 and gray, restart
  intervals, an Adobe RGB file, optimized tables, odd sizes) against the
  sha256 of Pillow's pixels recorded with them, and against Pillow now;
- fresh JPEGs written by Pillow at run time over a grid of modes,
  subsamplings, qualities, restart intervals and sizes;
- PNGs that Pillow cannot write (Adam7 interlaced, 16-bit colour),
  written by a small encoder here, and 16-bit gray written by Pillow;
- mutated and truncated JPEGs: an array or a ValueError, never a crash
  or a hang (hypothesis, with a time limit per example);
- the pixel limit read from the SOF before any buffer is sized;
- scans without their Huffman tables: a sequential frame takes the
  standard tables for slots 0 and 1, as libjpeg-turbo does for
  Motion-JPEG frames; any other missing table is a ValueError.
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from powerserve_tpu_torch.core import image as core_image
from powerserve_tpu_torch.core.image import decode_image

DATA = Path(__file__).resolve().parent / "data" / "jpeg"
EXPECTED = json.loads((DATA / "expected.json").read_text())


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _scene(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * 7 + y * 3) % 256], -1)
    return np.clip(img + rng.integers(-40, 40, img.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixtures_bit_equal_to_pillow(name):
    data = (DATA / name).read_bytes()
    got = decode_image(data)
    want = EXPECTED[name]
    assert list(got.shape) == want["shape"] and got.dtype == np.uint8
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_fresh_jpegs_bit_equal_to_pillow(progressive, subsampling):
    for i, (w, h) in enumerate(((1, 1), (2, 9), (5, 3), (8, 8), (17, 13),
                                (33, 70), (100, 7))):
        for mode in ("RGB", "L"):
            for quality, restart in ((50, 0), (95, 2), (100, 0)):
                buf = io.BytesIO()
                opts = dict(quality=quality, subsampling=subsampling,
                            progressive=progressive)
                if restart:
                    opts["restart_marker_blocks"] = restart
                Image.fromarray(_scene(w, h, i)).convert(mode).save(
                    buf, "JPEG", **opts)
                data = buf.getvalue()
                np.testing.assert_array_equal(
                    decode_image(data), _pil_rgb(data),
                    err_msg=f"{w}x{h} {mode} q{quality} restart {restart}")


def _png(samples: np.ndarray, depth: int, color: int,
         interlace: bool) -> bytes:
    """A PNG of samples [H, W, C] at `depth` bits (filter None), Adam7
    interlaced or not."""
    h, w, _ = samples.shape

    def rows(sub: np.ndarray) -> bytes:
        flat = sub.reshape(sub.shape[0], -1)
        dtype = ">u2" if depth == 16 else np.uint8
        return b"".join(b"\x00" + r.astype(dtype).tobytes() for r in flat)

    if interlace:
        raw = b"".join(rows(samples[y0::dy, x0::dx])
                       for x0, y0, dx, dy in core_image._ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = rows(samples)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color,channels",
                         [(0, 1), (4, 2), (2, 3), (6, 4)],
                         ids=["gray", "gray+alpha", "rgb", "rgba"])
def test_pngs_interlaced_and_16_bit(color, channels, depth, interlace):
    rng = np.random.default_rng(color * 31 + depth)
    for h, w in ((1, 1), (3, 9), (11, 13), (17, 5), (8, 8)):
        px = rng.integers(0, 1 << depth, (h, w, channels))
        if depth == 16 and w >= 4:  # Pillow clips I;16 and keeps high bytes
            px[0, :4] = np.array([0, 200, 300, 65535])[:, None]
        data = _png(px, depth, color, interlace)
        np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


def test_pillow_written_16_bit_gray_clips():
    """Pillow writes 16-bit gray itself (mode I;16); convert("RGB")
    clips it: [0, 200, 300, 65535] -> [0, 200, 255, 255]."""
    px = np.array([[0, 200, 300, 65535]], np.uint16)
    buf = io.BytesIO()
    img = Image.fromarray(px)
    assert img.mode == "I;16"
    img.save(buf, "PNG")
    got = decode_image(buf.getvalue())
    np.testing.assert_array_equal(got, _pil_rgb(buf.getvalue()))
    assert got[0, :, 0].tolist() == [0, 200, 255, 255]


def test_pixel_limit_is_read_from_the_sof():
    data = bytearray((DATA / "baseline_gray.jpg").read_bytes())
    i = data.find(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", 20000, 20000)  # height, width
    with pytest.raises(ValueError, match="20000 x 20000 pixels: more than"):
        decode_image(bytes(data))


def _strip_dht(data: bytes) -> bytes:
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = 2 + int.from_bytes(data[p + 2:p + 4], "big")
        if data[p + 1] != 0xC4:
            out += data[p:p + n]
        p += n
    return bytes(out + data[p:])


@pytest.mark.parametrize("mode,subsampling", [("L", 0), ("RGB", 0),
                                              ("RGB", 2)])
def test_scans_without_their_huffman_tables(mode, subsampling):
    img = Image.fromarray(_scene(27, 19, 3)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85, subsampling=subsampling,
             restart_marker_blocks=2)
    data = _strip_dht(buf.getvalue())
    assert b"\xff\xc4" not in data[:data.find(b"\xff\xda")]
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))
    # a sequential scan naming an AC table that no DHT defines
    bad = bytearray(buf.getvalue())
    i = bad.find(b"\xff\xda")
    bad[i + 6] = (bad[i + 6] & 0xF0) | 2
    with pytest.raises(ValueError, match="scan without its Huffman table"):
        decode_image(bytes(bad))
    # libjpeg-turbo loads no standard table for a progressive frame
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=85, subsampling=subsampling,
             progressive=True)
    data = _strip_dht(buf.getvalue())
    with pytest.raises(OSError):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="scan without its Huffman table"):
        decode_image(data)


_SEEDS = [(DATA / n).read_bytes() for n in (
    "baseline_420_restart.jpg", "progressive_422_odd.jpg",
    "progressive_gray_odd.jpg", "baseline_440.jpg")]


@settings(max_examples=300, deadline=2000,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.sampled_from(range(len(_SEEDS))),
       edits=st.lists(st.tuples(st.floats(0, 1), st.integers(0, 255)),
                      min_size=1, max_size=6),
       cut=st.floats(0.05, 1.0))
def test_mutated_and_truncated_jpegs_give_an_array_or_a_value_error(
        seed, edits, cut):
    data = bytearray(_SEEDS[seed])
    for where, byte in edits:
        data[int(where * (len(data) - 1))] = byte
    data = bytes(data[:max(int(cut * len(data)), 4)])
    try:
        out = decode_image(data)
    except ValueError:
        return
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
