"""Render a trained dynamic trial of the port from the command line (the
serving CLI; counterpart of the repository's ``scripts/render_4d.py``).

    # azimuth orbit at a fixed time: orbit_000.png … orbit_059.png + orbit.json
    python3 -m dreammesh4d_tpu_torch.scripts.render_4d --trial outputs/sugar-dynamic/mytag \\
        --mode orbit --t 0.0 --n 60 --out orbit.gif
    # fixed view, sweep the trained video's timeline
    python3 -m dreammesh4d_tpu_torch.scripts.render_4d --trial outputs/sugar-dynamic/mytag \\
        --mode play --azimuth 30 --out play.gif
    # single frame
    python3 -m dreammesh4d_tpu_torch.scripts.render_4d --trial outputs/sugar-dynamic/mytag \\
        --mode frame --azimuth 45 --elevation 10 --t 0.5 --out frame.png

The flags are the JAX script's, with ``--device`` (default ``cuda``) in
place of ``--platform``.  ``frame`` writes one PNG at ``--out``; ``orbit``
and ``play`` write numbered PNGs ``<stem>_000.png`` … beside ``--out`` (the
port writes no GIF: it needs no imaging package) and a sidecar
``<stem>.json`` with ``fps`` and the frame count.  Images go through the
port's own PNG writer (``data/png.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trial", required=True, help="trial dir (contains configs/parsed.yaml, ckpts/)")
    p.add_argument("--mode", choices=["frame", "orbit", "play"], default="orbit")
    p.add_argument("--checkpoint", default="LAST")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--elevation", type=float, default=15.0)
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--distance", type=float, default=2.2)
    p.add_argument("--t", type=float, default=0.0, help="normalized time in [0,1]")
    p.add_argument("--n", type=int, default=30, help="orbit views / play frames")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--out", default="render.gif")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def main(argv=None) -> list:
    """Render as the flags say; returns the paths written."""
    args = parse_args(argv)
    from ..data.png import write_png
    from ..serving import Viewer4D

    viewer = Viewer4D.from_trial(args.trial, checkpoint=args.checkpoint, height=args.height,
                                 width=args.width, device=args.device)
    if args.mode == "frame":
        img = viewer.render(args.elevation, args.azimuth, args.distance, args.t)
        written = [write_png(args.out, to_u8(img))]
    else:
        if args.mode == "orbit":
            frames = viewer.orbit(args.n, args.elevation, args.distance, args.t)
        else:
            frames = viewer.play(args.elevation, args.azimuth, args.distance, args.n)
        stem = os.path.splitext(args.out)[0]
        written = [write_png(f"{stem}_{i:03d}.png", to_u8(f)) for i, f in enumerate(frames)]
        with open(f"{stem}.json", "w") as f:
            json.dump({"fps": args.fps, "frames": len(frames), "mode": args.mode}, f)
        written.append(f"{stem}.json")
    print(f"wrote {written[0] if len(written) == 1 else f'{len(written) - 1} frames to {stem}_*.png'}")
    return written


if __name__ == "__main__":
    main()
