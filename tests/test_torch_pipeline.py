"""The README's six-stage recipe chained through the port on the CPU
(``dreammesh4d_tpu_torch.scripts.full_pipeline --tiny``), port only: the
static NeRF, its ``mc-cpu`` mesh export, QEM simplification, the static
refine bound to that mesh, the dynamic stage from the refine's checkpoint
and the 4D export, each stage reading the file the stage before it wrote.

Sizes are ``tests/test_full_pipeline.py``'s (reference 48², random views
2 × 32², 6 hash levels of 2¹⁴ rows, a 48³ export grid; the Gaussian stages
at 32² on ``backend: xla``, 8 frames, 32 graph nodes; 3 refine and 10
dynamic steps), with 16 of 64 occupancy candidates a ray and 6 stage-1
steps, not 25 (~1.5 s a step here).
"""

import json
import os

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch.export.mesh_io import load_mesh, load_obj
from dreammesh4d_tpu_torch.scripts import full_pipeline


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_readme_chain(tmp_path):
    out = str(tmp_path / "pipeline")
    result = full_pipeline.main(["--tiny", "--device", "cpu", "--out", out])
    assert result["guidance"] == "none" and result["tiny"] and result["device"] == "cpu"
    assert [k for k in result["stages"]] == ["assets", "static_nerf", "mc_export", "simplify_qem",
                                             "sugar_refine", "dynamic", "export_4d"]
    with open(os.path.join(out, "pipeline.json")) as f:
        assert json.load(f)["stages"].keys() == result["stages"].keys()
    files = result["files"]
    trials = os.path.join(out, "outputs")
    # stage 1-2: the NeRF trial and its coloured mesh
    nerf = os.path.join(trials, "zero123-sai", "nerf")
    assert os.listdir(os.path.join(nerf, "ckpts")) == ["step_00000006"]
    model = load_obj(files["model_obj"])
    assert files["model_obj"] == os.path.join(nerf, "save", "model.obj")
    assert model.n_faces > 1000 and model.v_rgb is not None
    assert model.v_rgb.min() >= 0 and model.v_rgb.max() <= 1 and np.abs(model.v_pos).max() <= 2.0
    # stage 3: the QEM mesh beside it, at most 500 faces
    bind = load_mesh(files["bind_mesh"])
    assert os.path.dirname(files["bind_mesh"]) == os.path.dirname(files["model_obj"])
    assert os.path.basename(files["bind_mesh"]) == f"model_qem{bind.n_faces}_{bind.n_verts}.ply"
    assert 0 < bind.n_faces <= 500
    # stage 4: the refine's checkpoint, stage 5 the dynamic trial from it
    assert files["refine_ckpt"].endswith(os.path.join("sugar-refine", "refine", "ckpts", "step_00000003"))
    assert os.path.exists(os.path.join(files["refine_ckpt"], "state.pt"))
    dyn = os.path.join(trials, "sugar-dynamic", "dyn")
    assert os.listdir(os.path.join(dyn, "ckpts")) == ["step_00000010"]
    # stage 6: one OBJ per frame on the bind mesh's faces, one texture
    frames = files["frames"]
    assert [os.path.basename(p) for p in frames] == [f"frame_{i:03d}.obj" for i in range(8)]
    export_dir = os.path.dirname(frames[0])
    assert {"material0.mtl", "material0.png"} <= set(os.listdir(export_dir))
    v0, v4 = load_obj(frames[0]), load_obj(frames[4])
    assert v0.v_pos.shape == v4.v_pos.shape == (bind.n_verts, 3)
    np.testing.assert_array_equal(v0.t_pos_idx, bind.t_pos_idx)
    assert np.abs(v0.v_pos - v4.v_pos).max() > 1e-5  # the video moves
    for stage in ("static_nerf", "sugar_refine", "dynamic"):
        per_size = result["stages"][stage]["ms_per_step"]
        assert sum(v["steps"] for v in per_size.values()) == result["stages"][stage]["steps"]
