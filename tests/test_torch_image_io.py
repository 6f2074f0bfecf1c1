"""The port's PNG codec and ``INTER_AREA`` resize against cv2, and its
``load_rgba`` against the JAX package's (CPU).

- ``read_png`` equals ``cv2.imread(path, IMREAD_UNCHANGED)`` bit for bit
  (channels in RGB(A) order) on files cv2 writes (grey, RGB, RGBA), on files
  the port's encoder writes with each of the five filter types and the
  adaptive choice (grey, grey + alpha, RGB, RGBA), and on palette files
  with and without ``tRNS`` and grey + alpha files that PIL writes.
- ``resize_area`` equals ``cv2.resize(..., interpolation=INTER_AREA)``
  exactly — no 1-LSB difference — on uint8 images of 1, 3 and 4 channels,
  noise and smooth, for integer down-scales (2×, which cv2 rounds half up,
  and 3×, 4×, which it rounds half to even), non-integer down-scales,
  up-scales and mixed factors.
- ``load_rgba`` equals the JAX package's (cv2-based) ``load_rgba`` bit for bit.
- Files outside the supported kinds raise ``PNGError``.
- The saver's colour maps (``jet``, ``magma``, ``viridis``) equal the JAX
  ``Saver._colorize`` (OpenCV's ``applyColorMap``) bit for bit.
"""

import os
import struct
import zlib

import cv2
import torch
import numpy as np
import pytest
from PIL import Image

from dreammesh4d_tpu.data.image import load_rgba as j_load_rgba
from dreammesh4d_tpu_torch.data import png
from dreammesh4d_tpu_torch.data.image import load_rgba

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, c, smooth, seed=0):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [xx * 5, yy * 3, (xx * yy) // 7, ((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (h / 3) ** 2) * 255]
    img = np.stack(planes[:c], -1) % 256 + rng.integers(0, 4, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_read_rgb(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
    return img


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decodes_files_cv2_writes(tmp_path, channels):
    img = _image(37, 53, channels, smooth=True)
    path = str(tmp_path / "cv.png")
    bgr = img[..., 0] if channels == 1 else (img[..., ::-1] if channels == 3 else img[..., [2, 1, 0, 3]])
    assert cv2.imwrite(path, bgr)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, _cv2_read_rgb(path))
    np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "adaptive"])
def test_decodes_each_filter_the_port_writes(tmp_path, channels, filter_type):
    img = _image(29, 41, channels, smooth=filter_type != 0)
    path = png.write_png(str(tmp_path / "port.png"), img, filter_type)
    data = open(path, "rb").read()
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    kinds = {raw[i * (41 * channels + 1)] for i in range(29)}
    assert kinds == {filter_type} if filter_type != "adaptive" else kinds <= set(range(5))
    got = png.read_png(path)
    np.testing.assert_array_equal(got, _cv2_read_rgb(path))
    want = img[..., 0] if channels == 1 else (img[..., [0, 0, 0, 1]] if channels == 2 else img)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["P", "P+tRNS", "LA"])
def test_decodes_palette_and_grey_alpha_files(tmp_path, kind):
    img = _image(31, 23, 4, smooth=True)
    path = str(tmp_path / "pil.png")
    if kind == "LA":
        Image.fromarray(img[..., [0, 3]], "LA").save(path)
    else:
        pal = Image.fromarray(img[..., :3]).quantize(64)
        extra = {"transparency": bytes([255] * 40 + [0] * 8)} if kind == "P+tRNS" else {}
        pal.save(path, **extra)
    got = png.read_png(path)
    assert got.shape == (31, 23, 3 if kind == "P" else 4)
    np.testing.assert_array_equal(got, _cv2_read_rgb(path))


SIZES = [(256, 256), (128, 128), (171, 171), (100, 100), (64, 48), (300, 200), (511, 511),
         (640, 640), (1024, 768), (512, 300), (700, 300), (256, 700)]


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_resize_area_equals_cv2(size, smooth):
    src = _image(512, 512, 4, smooth, seed=1)
    h, w = size
    for img in (src, src[..., :3], src[..., 0]):
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        got = png.resize_area(img, h, w)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert int((got != want).sum()) == 0, (size, img.shape, int(np.abs(got.astype(int) - want).max()))


@pytest.mark.parametrize("hw", [(512, 512), (256, 256), (320, 320), (96, 64)])
def test_load_rgba_matches_jax(tmp_path, hw):
    img = _image(512, 512, 4, smooth=True, seed=2)
    path = png.write_png(str(tmp_path / "x_rgba.png"), img)
    for got, want in zip(load_rgba(path, *hw), j_load_rgba(path, *hw)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


@pytest.mark.parametrize("case", ["not_png", "crc", "depth16", "interlaced", "truncated"])
def test_unsupported_files_raise(case):
    good = png.encode_png(_image(4, 5, 3, smooth=True))
    if case == "not_png":
        data = b"GIF89a" + good[6:]
    elif case == "crc":
        data = good[:-5] + bytes([good[-5] ^ 1]) + good[-4:]
    elif case == "truncated":
        data = good[:40]
    else:
        depth, interlace = (16, 0) if case == "depth16" else (8, 1)
        data = (png._SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, depth, 2, 0, 0, interlace))
                + good[33:])
    with pytest.raises(png.PNGError):
        png.decode_png(data)


def test_encoder_refuses_what_it_cannot_write():
    with pytest.raises(png.PNGError):
        png.encode_png(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(png.PNGError):
        png.encode_png(np.zeros((4, 4, 5), np.uint8))
    with pytest.raises(png.PNGError):
        png.encode_png(np.zeros((4, 4, 3), np.uint8), filter_type=5)


@pytest.mark.parametrize("cmap", ["jet", "magma", "viridis", None])
def test_colour_maps_equal_jax(tmp_path, cmap):
    """A grey layer through the port's colour tables is bit-equal to the JAX
    ``Saver._colorize`` (OpenCV's ``applyColorMap``), with and without
    ``data_range``, and so is the grid ``save_image_grid`` writes; an
    unknown name raises ``KeyError`` in both."""
    from dreammesh4d_tpu.utils.saving import Saver as JSaver
    from dreammesh4d_tpu_torch.utils.saving import Saver

    g = np.random.default_rng(7).uniform(-1.0, 3.0, (40, 50)).astype(np.float32)
    for data_range in (None, (0.0, 2.0)):
        np.testing.assert_array_equal(Saver._gray(g, cmap, data_range), JSaver._colorize(g, cmap, data_range))
    rgb = np.random.default_rng(8).random((40, 50, 3)).astype(np.float32)
    layers = [{"type": "rgb", "img": rgb}, {"type": "grayscale", "img": g[..., None], "kwargs": {"cmap": cmap}}]
    path = Saver(str(tmp_path / "port")).save_image_grid("grid.png", layers)
    jpath = JSaver(str(tmp_path / "jax")).save_image_grid("grid.png", layers)
    np.testing.assert_array_equal(png.read_png(path), np.asarray(Image.open(jpath)))
    if cmap is not None:
        with pytest.raises(KeyError):
            Saver._gray(g, cmap.upper())
        with pytest.raises(KeyError):
            JSaver._colorize(g, cmap.upper())
