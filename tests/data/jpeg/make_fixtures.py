"""Write the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py
with Pillow, and expected.json: each file's size and the sha256 of
Pillow's `Image.open(...).convert("RGB")` pixels (uint8 [H, W, 3] in C
order). Needs Pillow; the decoder under test does not.

    python tests/data/jpeg/make_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def scene(w: int, h: int, seed: int) -> np.ndarray:
    """Smooth gradients, hard edges and a little noise: what a photo
    stresses in a decoder, at a size that compresses."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin((x + 2 * y) / 9.0)], -1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, w / 3)
        inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[inside] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def swap_to_440(data: bytes) -> bytes:
    """A 4:2:2 file (Y 2x1) whose MCU count 4:4:0 keeps, made 4:4:0 (Y
    1x2) in its SOF: Pillow writes no 4:4:0 itself."""
    b = bytearray(data)
    i = max(b.find(b"\xff\xc0"), b.find(b"\xff\xc2"))
    assert b[i + 11] == 0x21
    b[i + 11] = 0x12
    return bytes(b)


def strip_dht(data: bytes) -> bytes:
    """The file without the DHT segments before its first scan: a
    Motion-JPEG frame, which leaves the standard tables out."""
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = 2 + int.from_bytes(data[p + 2:p + 4], "big")
        if data[p + 1] != 0xC4:
            out += data[p:p + n]
        p += n
    return bytes(out + data[p:])


# name -> (width, height, mode, save options, post-process)
CASES = {
    "baseline_444_q90": (48, 32, "RGB", dict(quality=90, subsampling=0), None),
    "baseline_422_odd": (37, 23, "RGB", dict(quality=75, subsampling=1), None),
    "baseline_420_odd": (45, 29, "RGB", dict(quality=80, subsampling=2), None),
    "baseline_440": (30, 15, "RGB", dict(quality=85, subsampling=1),
                     swap_to_440),
    "baseline_gray": (41, 19, "L", dict(quality=70), None),
    "baseline_420_restart": (53, 35, "RGB", dict(
        quality=88, subsampling=2, restart_marker_blocks=3), None),
    "baseline_rgb_adobe": (24, 17, "RGB", dict(quality=90, keep_rgb=True),
                           None),
    "optimized_420": (33, 47, "RGB", dict(quality=60, subsampling=2,
                                          optimize=True), None),
    "progressive_444": (40, 24, "RGB", dict(quality=90, subsampling=0,
                                            progressive=True), None),
    "progressive_422_odd": (35, 21, "RGB", dict(
        quality=80, subsampling=1, progressive=True), None),
    "progressive_gray_odd": (29, 31, "L", dict(quality=85, progressive=True),
                             None),
    "progressive_420_restart": (50, 34, "RGB", dict(
        quality=75, subsampling=2, progressive=True,
        restart_marker_rows=1), None),
    # the chip_smoke image: an InternVL tile pair at 4:2:0
    "progressive_420_896x448": (896, 448, "RGB", dict(
        quality=90, subsampling=2, progressive=True), None),
    "mjpeg_422_no_dht": (40, 30, "RGB", dict(quality=80, subsampling=1),
                         strip_dht),
}


def pixel_sha(data: bytes) -> tuple[str, list[int]]:
    rgb = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))
                                          .convert("RGB")))
    return hashlib.sha256(rgb.tobytes()).hexdigest(), list(rgb.shape)


def main() -> None:
    expected = {}
    for i, (name, (w, h, mode, opts, post)) in enumerate(CASES.items()):
        buf = io.BytesIO()
        Image.fromarray(scene(w, h, i)).convert(mode).save(buf, "JPEG",
                                                           **opts)
        data = buf.getvalue() if post is None else post(buf.getvalue())
        (HERE / f"{name}.jpg").write_bytes(data)
        sha, shape = pixel_sha(data)
        expected[f"{name}.jpg"] = {"sha256": sha, "shape": shape,
                                   "bytes": len(data)}
    (HERE / "expected.json").write_text(json.dumps(expected, indent=1) + "\n")


if __name__ == "__main__":
    main()
