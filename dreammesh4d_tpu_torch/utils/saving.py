"""Artifact saving under a trial's ``save`` directory (counterpart of
``dreammesh4d_tpu/utils/saving.py`` ``Saver``): image grids of typed
layers (grey or colour-mapped), image sequences, json and npz dumps.  Images are written by the
port's own PNG writer (:mod:`..data.png`), so nothing beyond numpy is
needed.

An image sequence is a numbered PNG sequence in a directory named after the
requested file's stem (``it120-test.mp4`` -> ``it120-test/0000.png`` …),
whatever the machine has installed; the JAX package writes an mp4 there.
Under more than one device only rank 0 writes: elsewhere every method
returns its path and writes nothing.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..data.png import write_png
from ..parallel import mesh as _mesh
from .colormaps import apply_colormap

_PNG_FILTER = 1  # Sub: the cheapest filter to compute, and it compresses renders well


class Saver:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        self.writes = _mesh.is_main_process()
        if self.writes:
            os.makedirs(save_dir, exist_ok=True)

    def path(self, name: str) -> str:
        p = os.path.join(self.save_dir, name)
        if self.writes:
            os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    # ---------------- images ----------------
    @staticmethod
    def _to_u8(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        return img

    @staticmethod
    def _gray(img: np.ndarray, cmap: Optional[str], data_range=None) -> np.ndarray:
        """A grey layer normalized to its range (or ``data_range``) as RGB:
        grey, or through the colour map ``cmap`` (``jet``, ``magma`` or
        ``viridis``; another name raises ``KeyError``)."""
        g = np.asarray(img, np.float32)
        lo, hi = (float(g.min()), float(g.max())) if data_range is None else data_range
        g8 = (np.clip((g - lo) / max(hi - lo, 1e-8), 0, 1) * 255).astype(np.uint8)
        if cmap is None:
            return np.stack([g8] * 3, -1)
        return apply_colormap(g8, cmap)

    def save_image_grid(self, name: str, layers: List[dict], align: str = "h") -> str:
        """``layers``: ``[{"type": "rgb" | "grayscale", "img": (H, W, 3) /
        (H, W[, 1]) array, "kwargs": {...}}]`` side by side (``align="h"``)
        or stacked."""
        imgs = []
        for layer in layers:
            img = np.asarray(layer["img"])
            kwargs = layer.get("kwargs", {})
            if layer["type"] == "rgb":
                imgs.append(self._to_u8(img))
            else:
                imgs.append(self._gray(img[..., 0] if img.ndim == 3 else img,
                                       kwargs.get("cmap"), kwargs.get("data_range")))
        grid = np.concatenate(imgs, axis=1 if align == "h" else 0)
        if not self.writes:
            return self.path(name)
        return write_png(self.path(name), grid, _PNG_FILTER)

    def save_rgb(self, name: str, img: np.ndarray) -> str:
        if not self.writes:
            return self.path(name)
        return write_png(self.path(name), self._to_u8(img), _PNG_FILTER)

    def save_img_sequence(self, name: str, frames: List[np.ndarray]) -> str:
        """Frames as ``<stem>/0000.png``, ``<stem>/0001.png``, …; returns the
        directory."""
        out = self.path(os.path.splitext(name)[0])
        if not self.writes:
            return out
        os.makedirs(out, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(out, f"{i:04d}.png"), self._to_u8(frame), _PNG_FILTER)
        return out

    # ---------------- data ----------------
    def save_json(self, name: str, data) -> str:
        out = self.path(name)
        if not self.writes:
            return out
        with open(out, "w") as f:
            json.dump(data, f, indent=2, default=float)
        return out

    def save_npz(self, name: str, **arrays) -> str:
        out = self.path(name)
        if not self.writes:
            return out
        np.savez(out, **{k: np.asarray(v) for k, v in arrays.items()})
        return out
