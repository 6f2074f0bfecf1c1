"""PNG reading and writing, and OpenCV's ``INTER_AREA`` resize, in numpy and
the standard library: the port reads its reference images and video frames
without cv2, PIL or imageio, which the machine with the card may lack.

- :func:`read_png`: 8-bit, non-interlaced grey, grey + alpha, RGB, RGBA and
  palette files, all five row filters; what ``cv2.imread(path,
  IMREAD_UNCHANGED)`` gives, in RGB(A) order instead of cv2's BGR(A) (grey +
  alpha and a palette with ``tRNS`` give RGBA).  Other files raise
  :class:`PNGError`.  Rows filtered with None / Sub / Up are undone with
  numpy (``cumsum`` for Sub); Average and Paeth read the reconstructed left
  neighbour and are undone by a loop over the row's bytes.
- :func:`write_png`: 8-bit grey, grey + alpha, RGB or RGBA; each row takes
  the filter with the least sum of absolute filtered bytes (``"adaptive"``,
  libpng's heuristic) or one fixed filter type.
- :func:`resize_area`: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  on uint8 images, computed the way OpenCV computes it: the 2×2 box average
  rounded half up; other integer factors as an integer box sum times the
  float32 reciprocal of its area, rounded half to even; non-integer
  down-scales as float32 sums of OpenCV's area weights; up-scales (either
  axis) as OpenCV's bilinear emulation in 11-bit fixed point.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


class PNGError(ValueError):
    """Not a PNG file, or a PNG outside the supported kinds."""


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise PNGError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + length]
        crc = data[i + 8 + length:i + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError("truncated PNG file")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        i += 12 + length
    raise PNGError("PNG file without IEND")


def _unfilter_average(line: list, prev: list, bpp: int) -> list:
    out = line
    for i in range(bpp):
        out[i] = (line[i] + (prev[i] >> 1)) & 255
    for i in range(bpp, len(line)):
        out[i] = (line[i] + ((out[i - bpp] + prev[i]) >> 1)) & 255
    return out


def _unfilter_paeth(line: list, prev: list, bpp: int) -> list:
    out = line
    for i in range(bpp):  # a = c = 0: the predictor is b
        out[i] = (line[i] + prev[i]) & 255
    for i in range(bpp, len(line)):
        a, b, c = out[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (line[i] + pred) & 255
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array: (H, W) for grey, (H, W, 3) for RGB and
    palette, (H, W, 4) for RGBA, grey + alpha and palette with ``tRNS``."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("PNG file without IHDR")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise PNGError(f"only 8-bit PNGs are supported (bit depth {depth}, colour type {ctype})")
    if compression != 0 or filter_method != 0 or interlace != 0:
        raise PNGError("interlaced or non-standard PNGs are not supported")
    if trns is not None and ctype != 3:
        raise PNGError("tRNS on a grey or RGB PNG is not supported")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise PNGError("PNG image data has the wrong size")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prev
        elif kind == 3:
            out[y] = _unfilter_average(line.tolist(), prev.tolist(), bpp)
        elif kind == 4:
            out[y] = _unfilter_paeth(line.tolist(), prev.tolist(), bpp)
        else:
            raise PNGError(f"unknown PNG filter type {kind}")
        prev = out[y]
    if ctype == 3:
        if palette is None:
            raise PNGError("palette PNG without PLTE")
        index = out
        if int(index.max(initial=0)) >= len(palette):
            raise PNGError("palette index out of range")
        if trns is None:
            return palette[index]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(palette)]
        return np.concatenate([palette[index], alpha[index][..., None]], -1)
    img = out.reshape(height, width, bpp)
    if bpp == 2:  # grey + alpha comes out as RGBA, as cv2.IMREAD_UNCHANGED gives it
        return img[..., [0, 0, 0, 1]]
    return img[..., 0] if bpp == 1 else img


def read_png(path: str) -> np.ndarray:
    """The image of a PNG file (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _filtered_rows(raw: np.ndarray, bpp: int, kinds) -> np.ndarray:
    """Filter types ``kinds`` applied to every row: (len(kinds), H, stride)
    uint8."""
    x = raw.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]

    def paeth():
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        return np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))

    predict = (lambda: 0, lambda: left, lambda: up, lambda: (left + up) >> 1, paeth)
    return np.stack([((x - predict[k]()) & 255).astype(np.uint8) for k in kinds])


def encode_png(img: np.ndarray, filter_type="adaptive", level: int = 6) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) -> PNG
    bytes.  ``filter_type``: ``"adaptive"`` or a PNG filter type 0–4."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise PNGError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise PNGError(f"cannot write an image of shape {img.shape} as PNG")
    height, width, bpp = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    raw = img.reshape(height, width * bpp)
    if filter_type == "adaptive":
        filtered = _filtered_rows(raw, bpp, range(5))
        cost = np.abs(filtered.view(np.int8).astype(np.int32)).sum(-1)  # (5, H)
        kinds = np.argmin(cost, axis=0)
        rows = filtered[kinds, np.arange(height)]
    elif filter_type in range(5):
        kinds = np.full(height, filter_type)
        rows = _filtered_rows(raw, bpp, [filter_type])[0]
    else:
        raise PNGError(f"unknown filter type {filter_type!r}")
    data = np.concatenate([kinds.astype(np.uint8)[:, None], rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data, level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type="adaptive") -> str:
    """Write ``img`` (see :func:`encode_png`) to ``path``; returns ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
    return path


# ---------------------------------------------------------------------------
# cv2.INTER_AREA
# ---------------------------------------------------------------------------


def _area_table(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab``: for each destination index the
    source indices and float32 weights, in the order OpenCV sums them;
    padded with weight 0 to (dst, J)."""
    scale = src / dst
    entries = [[] for _ in range(dst)]
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            entries[d].append((s1 - 1, (s1 - f1) / cell))
        for s in range(s1, s2):
            entries[d].append((s, 1.0 / cell))
        if f2 - s2 > 1e-3:
            entries[d].append((s2, min(min(f2 - s2, 1.0), cell) / cell))
    j = max(len(e) for e in entries)
    idx = np.zeros((dst, j), np.int64)
    w = np.zeros((dst, j), np.float32)
    for d, e in enumerate(entries):
        for k, (s, a) in enumerate(e):
            idx[d, k], w[d, k] = s, np.float32(a)
    return idx, w


def _linear_table(src: int, dst: int, clamp_right: bool):
    """OpenCV's bilinear emulation of ``INTER_AREA`` for an up-scaled axis:
    source index and 11-bit weights (w0, w1) per destination index, and
    whether the index sits at the right edge (one tap, weight 2048)."""
    scale, inv = src / dst, dst / src
    idx = np.zeros(dst, np.int64)
    w = np.zeros((dst, 2), np.int32)
    edge = np.zeros(dst, bool)
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if clamp_right and s + 1 >= src:
            edge[d] = True
            if s >= src - 1:
                f, s = np.float32(0.0), src - 1
        idx[d] = s
        w[d] = [np.rint(np.float32(np.float32(1.0) - f) * np.float32(2048)),
                np.rint(f * np.float32(2048))]
    if clamp_right:
        edge[np.argmax(edge):] = edge.any()  # OpenCV's xmax: every index from the first edge on
    return idx, w, edge


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`` for
    a uint8 (H, W) or (H, W, C) image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8 images, not {img.dtype}")
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    src_h, src_w, cn = x.shape
    if (src_h, src_w) == (height, width):
        return img.copy()
    sx, sy = src_w / width, src_h / height
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(float).eps and abs(sy - iy) < np.finfo(float).eps:
            blocks = x.reshape(height, iy, width, ix, cn).astype(np.int32).sum((1, 3))
            if ix == 2 and iy == 2 and cn != 2:
                out = (blocks + 2) >> 2
            else:
                area = np.float32(1.0) / np.float32(ix * iy)
                out = np.rint(blocks.astype(np.float32) * area)
        else:
            xi, xw = _area_table(src_w, width)
            yi, yw = _area_table(src_h, height)
            xf = x.astype(np.float32)
            buf = np.zeros((src_h, width, cn), np.float32)
            for j in range(xi.shape[1]):
                buf = buf + xf[:, xi[:, j]] * xw[:, j, None]
            acc = np.zeros((height, width, cn), np.float32)
            for j in range(yi.shape[1]):
                acc = acc + yw[:, j, None, None] * buf[yi[:, j]]
            out = np.rint(acc)
    else:
        xi, xw, edge = _linear_table(src_w, width, clamp_right=True)
        yi, yw, _ = _linear_table(src_h, height, clamp_right=False)
        xs = x.astype(np.int32)
        right = np.minimum(xi + 1, src_w - 1)
        rows = np.where(edge[None, :, None], xs[:, xi] * 2048,
                        xs[:, xi] * xw[None, :, 0, None] + xs[:, right] * xw[None, :, 1, None])
        r0 = rows[np.clip(yi, 0, src_h - 1)] >> 4
        r1 = rows[np.clip(yi + 1, 0, src_h - 1)] >> 4
        out = (((yw[:, 0, None, None] * r0) >> 16) + ((yw[:, 1, None, None] * r1) >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out
