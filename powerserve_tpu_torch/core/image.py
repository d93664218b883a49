"""Image input without PIL: PNG and JPEG decoders and Pillow's bicubic
resize.

decode_image(data) takes
  - a PNG of 8-bit or 16-bit gray, gray + alpha, RGB or RGBA, or a
    palette of 1, 2, 4 or 8 bits, with any of the five row filters,
    interlaced (Adam7) or not;
  - a JPEG: Huffman-coded 8-bit baseline, extended-sequential or
    progressive, gray or 3-component (YCbCr, or RGB), sampling factors
    of 1 or 2 (4:4:4, 4:2:2, 4:4:0, 4:2:0), with restart intervals
    (csrc/host/jpeg_decode.cpp through core/native.py: libjpeg-turbo's
    islow IDCT, fancy upsampling and fixed-point color tables);
and returns RGB uint8 [H, W, 3] bit-equal to Pillow's
`Image.open(...).convert("RGB")`: alpha dropped (not composited), gray
and palette expanded, 16-bit samples as Pillow takes them (gray opens as
I;16 and is clipped to 255, the other types keep the high byte).
Anything else (WebP, GIF, BMP, TIFF, arithmetic-coded, lossless, 12-bit
or CMYK JPEGs, other files) raises a ValueError naming what is taken
(FORMATS).

encode_png writes an 8-bit PNG (each row with a chosen filter).

An image of more than MAX_PIXELS pixels (Pillow's MAX_IMAGE_PIXELS) is
refused from its header, before any pixel buffer is sized; PNG data is
inflated to the IHDR's rows and no further; a malformed PNG (truncated,
a corrupt zlib stream, a bad IHDR or PLTE, no pixels) and a corrupt or
truncated JPEG are ValueErrors too.

find_best_tile_grid and preprocess_image are InternVL's dynamic tiling
and normalization (the JAX package's models/internvl.py, re-exported by
the port's); pixel_values(data) runs decode and preprocessing for one
image. This module imports numpy, the standard library and
core/native.py (numpy and ctypes) only: the server runs it in worker
processes (worker_loop, serving/image_workers.py), so that images are
decoded off the interpreter lock the scheduler thread needs.

resize_bicubic(img, (width, height)) reproduces Pillow's
`Image.resize(size, Image.BICUBIC)` for 8-bit images bit for bit: the
cubic convolution kernel with a = -0.5 and support 2 * max(scale, 1),
coefficients normalized per output pixel and rounded to 22-bit fixed
point, a horizontal pass over the rows the vertical pass reads, then a
vertical pass, each rounded and clipped to uint8.
"""

from __future__ import annotations

import os
import pickle
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

FORMATS = ("PNG (8- or 16-bit gray, gray + alpha, RGB or RGBA, or a "
           "1/2/4/8-bit palette; interlaced or not) or JPEG (8-bit "
           "Huffman-coded baseline or progressive, gray, YCbCr or RGB, "
           "sampling factors of 1 or 2)")
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Pillow's Image.MAX_IMAGE_PIXELS: a larger PNG is refused before its data
# is inflated (Pillow warns above it and refuses above twice it)
MAX_PIXELS = 89_478_485
# the Average/Paeth wavefront's working buffers per band of rows
_BAND_BYTES = 64 << 20
# color type -> (name, channels, bit depths taken)
_COLOR_TYPES = {0: ("gray", 1, (8, 16)), 2: ("RGB", 3, (8, 16)),
                3: ("palette", 1, (1, 2, 4, 8)),
                4: ("gray + alpha", 2, (8, 16)), 6: ("RGBA", 4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _refuse(what: str) -> ValueError:
    return ValueError(f"unsupported image ({what}); the port takes "
                      f"{FORMATS}")


def _sniff(data: bytes) -> str:
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "not a PNG or JPEG file"


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw rows of 1 + stride bytes ->
    uint8 [height, stride]."""
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    if (ftypes > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftypes.max())}")
    if (ftypes >= 3).any():
        return _unfilter_wavefront(ftypes, data, bpp)
    # None, Sub and Up only: each row at once
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    lanes = np.zeros(-(-stride // bpp) * bpp, np.uint64)
    for y in range(height):
        if ftypes[y] == 1:  # Sub: a running sum per byte lane, mod 256
            lanes[:stride] = data[y]
            out[y] = (np.cumsum(lanes.reshape(-1, bpp), axis=0) % 256
                      ).astype(np.uint8).reshape(-1)[:stride]
        else:
            out[y] = data[y] + prior if ftypes[y] == 2 else data[y]
        prior = out[y]
    return out


def _unfilter_wavefront(ftypes: np.ndarray, data: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Every filter at once: pixel (y, x) depends on (y, x - 1), (y - 1,
    x) and (y - 1, x - 1) only, so the pixels of one anti-diagonal x + y
    = d are independent. The rows go in bands whose skewed buffers stay
    under _BAND_BYTES, each band's row above carried in."""
    height, stride = data.shape
    units = -(-stride // bpp)
    # two int16 buffers of band x (units + band) x bpp
    band = 1
    while band < height and (2 * band) * (units + 2 * band) * bpp * 4 \
            <= _BAND_BYTES:
        band *= 2
    out = np.empty((height, units * bpp), np.uint8)
    prior = np.zeros((units, bpp), np.int16)
    for y0 in range(0, height, band):
        y1 = min(y0 + band, height)
        out[y0:y1] = _wavefront_band(ftypes[y0:y1], data[y0:y1], prior,
                                     bpp)
        prior = out[y1 - 1].reshape(units, bpp).astype(np.int16)
    return out[:, :stride]


def _wavefront_band(ftypes: np.ndarray, data: np.ndarray, prior: np.ndarray,
                    bpp: int) -> np.ndarray:
    """Rows `data` unfiltered under the row `prior` (int16 [units, bpp]).
    Stored skewed: column d + 2 of row y + 1 holds pixel (y, d - y), row 0
    the prior row (pixel (-1, x) in column x + 1), and the columns before
    the image are zeros, so each diagonal is a column slice."""
    height, stride = data.shape
    units = prior.shape[0]
    n_diag = units + height - 1
    skew_f = np.zeros((height, n_diag, bpp), np.int16)
    for y in range(height):
        row = np.zeros(units * bpp, np.int16)
        row[:stride] = data[y]
        skew_f[y, y:y + units] = row.reshape(units, bpp)
    rec = np.zeros((height + 1, n_diag + 2, bpp), np.int16)
    rec[0, 1:1 + units] = prior
    sub, up, avg, paeth_rows = (ftypes[:, None] == t
                                for t in (1, 2, 3, 4))
    for d in range(n_diag):
        y0, y1 = max(0, d - units + 1), min(height - 1, d) + 1
        a = rec[y0 + 1:y1 + 1, d + 1]  # left
        b = rec[y0:y1, d + 1]  # up
        c = rec[y0:y1, d]  # up-left
        ab = a + b
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(ab - c - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth_rows[y0:y1], paeth, np.where(
            avg[y0:y1], ab >> 1, np.where(up[y0:y1], b, a * sub[y0:y1])))
        rec[y0 + 1:y1 + 1, d + 2] = (skew_f[y0:y1, d] + pred) & 0xFF
    out = np.empty((height, units * bpp), np.uint8)
    for y in range(height):
        out[y] = rec[y + 1, y + 2:y + 2 + units].reshape(-1)
    return out


def _inflate(idat: bytes, size: int) -> bytes:
    """The image data's `size` bytes (the IHDR's filtered rows): zlib
    output beyond them is refused unread, as is a corrupt stream."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(idat, size)
        if len(raw) == size and d.decompress(d.unconsumed_tail, 1):
            raise ValueError("PNG image data longer than its IHDR's rows")
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data ({e})") from e
    if len(raw) < size:
        raise ValueError("truncated PNG image data")
    return raw


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 [H, W, 3] (see the module docstring)."""
    if not data.startswith(_PNG_MAGIC):
        raise _refuse(_sniff(data))
    off, ihdr, plte, idat = len(_PNG_MAGIC), None, None, []
    while off + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + length]
        crc = data[off + 8 + length:off + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {ctype!r}: bad CRC")
        off += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError(f"PNG IHDR of {length} bytes, not 13")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            if length % 3:
                raise ValueError(f"PNG PLTE of {length} bytes")
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = ihdr
    if not width or not height:
        raise ValueError(f"PNG of {width} x {height} pixels")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width} x {height} pixels: more than "
                         f"{MAX_PIXELS}")
    if color not in _COLOR_TYPES:
        raise _refuse(f"PNG color type {color}")
    name, channels, depths = _COLOR_TYPES[color]
    if depth not in depths:
        raise _refuse(f"{depth}-bit {name} PNG")
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace}")
    bpp = max(1, channels * depth // 8)
    passes = (_ADAM7 if interlace else ((0, 0, 1, 1),))
    # (x0, y0, dx, dy, pass width, pass height, row bytes) of each pass
    layout = []
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            layout.append((x0, y0, dx, dy, pw, ph,
                           (pw * channels * depth + 7) // 8))
    raw = _inflate(b"".join(idat), sum(ph * (st + 1)
                                       for *_, ph, st in layout))
    px = np.empty((height, width, channels),
                  np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph, st in layout:
        rows = _unfilter(raw[off:off + ph * (st + 1)], ph, st, bpp)
        off += ph * (st + 1)
        px[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if color == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[px[:, :, 0]]
    if depth == 16:  # Pillow: I;16 gray clipped, else the high byte
        px = (np.minimum(px, 255) if channels == 1 else px >> 8
              ).astype(np.uint8)
    if channels <= 2:  # gray (+ alpha): the gray value thrice
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered rows uint8 [h, row bytes] -> samples [h, width,
    channels] (uint16 for 16-bit, palette indices unpacked below 8)."""
    rows = np.ascontiguousarray(rows)
    h = rows.shape[0]
    if depth == 16:
        be = rows[:, :width * channels * 2].reshape(h, -1, 2).astype(
            np.uint16)
        return ((be[:, :, 0] << 8) | be[:, :, 1]).reshape(h, width,
                                                          channels)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        return (bits * weights).sum(-1, dtype=np.uint8)[:, :width, None]
    return rows[:, :width * channels].reshape(h, width, channels)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3] (see the module docstring)."""
    from . import native

    status, out = native.jpeg_decode(bytes(data), MAX_PIXELS)
    if status == 2:
        raise _refuse(out)
    if status:
        raise ValueError(f"corrupt JPEG ({out})")
    return out


def _filter_row(line: np.ndarray, prior: np.ndarray, ftype: int,
                bpp: int) -> np.ndarray:
    """One row filtered with `ftype` (the inverse of _unfilter's)."""
    x = line.astype(np.int64)
    b = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) % 256).astype(np.uint8)


def encode_png(img: np.ndarray, filters: tuple[int, ...] = (0,)) -> bytes:
    """uint8 [H, W] (gray), [H, W, 2] (gray + alpha), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA) -> PNG bytes, row y filtered with filters[y %
    len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    height, width, channels = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = img.reshape(height, width * channels)
    prior = np.zeros(width * channels, np.uint8)
    raw = bytearray()
    for y in range(height):
        ftype = filters[y % len(filters)]
        raw.append(ftype)
        raw += _filter_row(rows[y], prior, ftype, channels).tobytes()
        prior = rows[y]

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> RGB uint8 [H, W, 3]: a PNG or a JPEG (FORMATS)."""
    data = bytes(data)
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data)
    return decode_png(data)


def load_image(path: str | Path) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3]."""
    return decode_image(Path(path).read_bytes())


def as_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W] (gray), [H, W, 3] or [H, W, 4] -> [H, W, 3], as
    Pillow's convert("RGB") (alpha dropped)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"images are uint8 arrays, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or not img.size:
        raise ValueError(f"image array of shape {img.shape}")
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# ---------------------------------------------------------------------------
# Pillow's BICUBIC resize
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2
# int64 entries of one block of a resize pass's sums (32 MB)
_RESAMPLE_BLOCK = 4 << 20


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, ...]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): (xmin [out], xmax [out] (a count), int64 fixed-point
    weights [out, ksize], zero from xmax on)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize, dtype=np.int64)
    valid = x[None, :] < xmax[:, None]
    w = _bicubic(((x[None, :] + xmin[:, None]).astype(np.float64)
                  - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(valid, w, 0.0)
    ww = np.zeros(out_size, np.float64)
    for j in range(ksize):  # summed in order, as the C loop does
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * float(1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, xmax, np.where(valid, k, 0)


def _resample(src: np.ndarray, xmin: np.ndarray, k: np.ndarray) -> np.ndarray:
    """One pass along axis 0 of uint8 [in, M] -> uint8 [out, M]: each
    output row the fixed-point sum of its taps, rounded (the 2^21 offset)
    and clipped; in blocks of columns whose int64 sums stay near
    _RESAMPLE_BLOCK entries."""
    out = np.empty((len(xmin), src.shape[1]), np.uint8)
    step = max(1, _RESAMPLE_BLOCK // max(len(src), len(xmin)))
    taps = [j for j in range(k.shape[1]) if k[:, j].any()]
    rows = [np.minimum(xmin + j, len(src) - 1) for j in taps]
    for m0 in range(0, src.shape[1], step):
        blk = src[:, m0:m0 + step].astype(np.int64)
        acc = np.full((len(xmin), blk.shape[1]), 1 << (_PRECISION_BITS - 1),
                      np.int64)
        for j, r in zip(taps, rows):
            acc += blk[r] * k[:, j, None]
        out[:, m0:m0 + step] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return out


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C] for size = (width,
    height), bit-equal to Pillow's resize(size, Image.BICUBIC)."""
    width, height = size
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    ymin, ymax, ky = _coeffs(h, height)
    out = img
    if width != w:
        # the horizontal pass over the rows the vertical pass reads
        first, last = ((int(ymin[0]), int(ymin[-1] + ymax[-1]))
                       if height != h else (0, h))
        xmin, _, kx = _coeffs(w, width)
        part = img[first:last]
        r, c = part.shape[0], part.shape[2]
        out = _resample(part.transpose(1, 0, 2).reshape(w, r * c), xmin,
                        kx).reshape(width, r, c).transpose(1, 0, 2)
        ymin = ymin - first
    if height != h:
        wc = out.shape[1] * out.shape[2]
        out = _resample(np.ascontiguousarray(out).reshape(-1, wc), ymin,
                        ky).reshape(height, -1, out.shape[2])
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# InternVL's preprocessing
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def find_best_tile_grid(width: int, height: int, tile: int = 448,
                        min_num: int = 1, max_num: int = 12
                        ) -> tuple[int, int]:
    """The (cols, rows) tile grid whose aspect ratio best matches the
    image (InternVL's dynamic preprocessing)."""
    aspect = width / height
    best, best_diff = (1, 1), float("inf")
    for total in range(min_num, max_num + 1):
        for cols in range(1, total + 1):
            if total % cols:
                continue
            rows = total // cols
            diff = abs(aspect - cols / rows)
            area = width * height
            if diff < best_diff or (
                    diff == best_diff and area > 0.5 * tile * tile * cols * rows):
                best, best_diff = (cols, rows), diff
    return best


def preprocess_image(img: np.ndarray, tile: int = 448, max_num: int = 12,
                     use_thumbnail: bool = True) -> np.ndarray:
    """uint8 image [H, W(, C)] -> f32 [n_tiles, 3, tile, tile] normalized
    pixel values: the grid's tiles of the bicubic resize, then, when there
    is more than one, the whole image resized to one tile."""
    img = as_rgb(img)
    height, width = img.shape[:2]
    cols, rows = find_best_tile_grid(width, height, tile, max_num=max_num)
    resized = resize_bicubic(img, (cols * tile, rows * tile))
    tiles = [resized[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile]
             for r in range(rows) for c in range(cols)]
    if use_thumbnail and len(tiles) > 1:
        tiles.append(resize_bicubic(img, (tile, tile)))
    out = np.stack([np.asarray(t, np.float32) / 255.0 for t in tiles])
    out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return out.transpose(0, 3, 1, 2).astype(np.float32)


def pixel_values(data: bytes, tile: int = 448, max_num: int = 12) -> np.ndarray:
    """Image bytes -> preprocess_image's f32 [n_tiles, 3, tile, tile] (the
    server's image workers run this)."""
    return preprocess_image(decode_image(data), tile=tile, max_num=max_num)


# ---------------------------------------------------------------------------
# The server's worker processes
# ---------------------------------------------------------------------------

def send_frame(f, obj) -> None:
    """One frame on a binary pipe: an 8-byte big-endian length, then the
    pickle of `obj`."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack(">Q", len(body)) + body)
    f.flush()


def recv_frame(f):
    """The object of the next frame; EOFError if the pipe closes first."""
    def exactly(n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            got = f.read(n - len(buf))
            if not got:
                raise EOFError("pipe closed")
            buf += got
        return bytes(buf)

    return pickle.loads(exactly(struct.unpack(">Q", exactly(8))[0]))


def worker_loop() -> None:
    """An image worker's main: "ready", then for each (data, tile,
    max_num) frame on stdin, ("ok", pixel_values(...)), ("refused",
    the ValueError's text) or ("failed", any other error's) on stdout,
    until stdin closes. Stray prints go to stderr."""
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    inp = sys.stdin.buffer
    send_frame(out, "ready")
    while True:
        try:
            data, tile, max_num = recv_frame(inp)
        except EOFError:
            return
        try:
            reply = ("ok", pixel_values(data, tile, max_num))
        except ValueError as e:
            reply = ("refused", str(e))
        except Exception as e:  # noqa: BLE001 — answered, the worker lives
            reply = ("failed", f"{type(e).__name__}: {e}")
        send_frame(out, reply)
