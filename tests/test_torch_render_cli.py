"""The serving CLI ``dreammesh4d_tpu_torch.scripts.render_4d`` (counterpart
of the repository's ``scripts/render_4d.py``) on a tiny dynamic trial made
by the port's launcher (the dynamic stage of ``dreammesh4d_tpu_torch.dryrun``
at 32², guidance off, 2 steps, ``--device cpu``): ``frame`` writes the PNG
that ``write_png`` writes of ``Viewer4D.render`` at the same arguments, byte
for byte; ``orbit`` and ``play`` write ``n`` numbered PNGs of the viewer's
frames and the sidecar with ``fps`` and the frame count."""

import json
import os

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch import dryrun, launch
from dreammesh4d_tpu_torch.data.png import read_png, write_png
from dreammesh4d_tpu_torch.scripts import render_4d
from dreammesh4d_tpu_torch.serving import Viewer4D

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trial(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    yaml, extras = dryrun.stage_dotlists(dryrun.write_assets(root), os.path.join(root, "out"),
                                         "cli")["dynamic"]
    launch.main(launch.make_args(os.path.join(REPO, yaml), "train", device="cpu"),
                extras + ["system.guidance.pretrained_model_name_or_path=none"])
    return dryrun.trial_dir(os.path.join(root, "out"), "cli", "dynamic")


def test_frame_is_the_viewers_render(trial, tmp_path):
    out = str(tmp_path / "frame.png")
    args = ["--elevation", "10", "--azimuth", "45", "--distance", "2.0", "--t", "0.5"]
    assert render_4d.main(["--trial", trial, "--mode", "frame", "--out", out, "--device", "cpu",
                           *args]) == [out]
    viewer = Viewer4D.from_trial(trial, device="cpu")
    img = viewer.render(10.0, 45.0, 2.0, 0.5)
    ref = write_png(str(tmp_path / "ref.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with open(out, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert read_png(out).shape == (32, 32, 3) and read_png(out).std() > 0


@pytest.mark.parametrize("mode", ["orbit", "play"])
def test_orbit_and_play_write_numbered_pngs_and_sidecar(trial, tmp_path, mode):
    out = str(tmp_path / f"{mode}.gif")
    written = render_4d.main(["--trial", trial, "--mode", mode, "--n", "3", "--fps", "12",
                              "--t", "0.25", "--azimuth", "30", "--out", out, "--device", "cpu"])
    frames = [str(tmp_path / f"{mode}_{i:03d}.png") for i in range(3)]
    assert written == frames + [str(tmp_path / f"{mode}.json")]
    assert sorted(os.listdir(tmp_path)) == sorted([f"{mode}_{i:03d}.png" for i in range(3)] + [f"{mode}.json"])
    assert json.loads((tmp_path / f"{mode}.json").read_text()) == {"fps": 12, "frames": 3, "mode": mode}
    viewer = Viewer4D.from_trial(trial, device="cpu")
    want = viewer.orbit(3, 15.0, 2.2, 0.25) if mode == "orbit" else viewer.play(15.0, 30.0, 2.2, 3)
    for path, img in zip(frames, want):
        np.testing.assert_array_equal(read_png(path), (np.clip(img, 0, 1) * 255).astype(np.uint8))
