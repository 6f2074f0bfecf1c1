"""Video-frame timing (``frame_timestamps`` of
``dreammesh4d_tpu/data/temporal_image.py:69``; the datamodule comes with the
training slice)."""

from __future__ import annotations

import numpy as np


def frame_timestamps(video_length: int) -> np.ndarray:
    """linspace(0, 1, L+2)[1:-1]: L frame times strictly inside (0, 1)."""
    return np.linspace(0.0, 1.0, video_length + 2)[1:-1].astype(np.float32)
