"""More than one device through the port's launcher (counterpart of
``tests/test_launch_multidevice.py`` and of
``tests/test_sharding.py::test_dryrun_multichip_entrypoint``).

``dreammesh4d_tpu_torch.dryrun.dryrun_multichip(4, STAGES)`` runs the four
experiments from their YAML through ``launch.main`` with
``trainer.devices=4 trainer.mesh=[2,2]`` (one spawn of 4 ``gloo`` ranks on
the CPU, one torch thread each; the JAX tests use 8 virtual devices at
[2, 4]): the static refine and the dynamic stage for 2 steps, the Gaussian
stage for 4 steps across one density control, stage 1 for 1 step, each with
a random-weight tiny guidance in bfloat16 whose output convolutions are
drawn too, so that the tensor-parallel attention and FF layers reach the
loss.  The same dotlists run on one device in this process.  The port's
single-device run is held to the JAX package by ``test_torch_launch_*``;
here the multi-rank run is held to it: every logged loss at rtol 1e-5 /
atol 1e-7, the parameters after the last step within 1e-6 of each leaf's
max, the Gaussian stage's alive mask and densify statistics equal.
"""

import contextlib
import csv
import io
import os

import numpy as np
import pytest
import torch

from dreammesh4d_tpu_torch import dryrun, launch
from dreammesh4d_tpu_torch.parallel import mesh as pmesh
from dreammesh4d_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI = ["trainer.devices=4", "trainer.mesh=[2,2]"]


def _rows(trial):
    with open(os.path.join(trial, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _losses(trial):
    rows = _rows(trial)
    return {k: [float(r[k]) for r in rows] for k in rows[0] if k.startswith("loss")}


def _state(trial):
    return restore_checkpoint(latest_checkpoint(os.path.join(trial, "ckpts")), "cpu")


def _flat(tree, prefix=""):
    if torch.is_tensor(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four stages on 4 ranks (the dry run's one spawn) and on one
    device, from the same assets and dotlists."""
    root = str(tmp_path_factory.mktemp("multi"))
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        multi = dryrun.dryrun_multichip(4, "cpu", dryrun.STAGES, out=os.path.join(root, "multi"))
    assets = dryrun.write_assets(os.path.join(root, "single"))
    out = os.path.join(root, "single", "out")
    lists = dryrun.stage_dotlists(assets, out, "single")
    single = {}
    for stage in dryrun.STAGES:
        yaml, extras = lists[stage]
        launch.main(launch.make_args(os.path.join(REPO, yaml), "train", device="cpu"), extras)
        single[stage] = dryrun.trial_dir(out, "single", stage)
    return {"multi": multi, "single": single, "stdout": stdout.getvalue(), "assets": assets,
            "lists": lists}


def test_dryrun_multichip_entrypoint(runs):
    """``dryrun_multichip`` prints one "ok" line per stage, at dp=2, tp=2."""
    for stage in dryrun.STAGES:
        assert f"dryrun_multichip(4): {stage} ok via launch.main" in runs["stdout"], runs["stdout"]
    assert runs["stdout"].count("(dp=2, tp=2, cpu)") == len(dryrun.STAGES)


@pytest.mark.parametrize("stage", dryrun.STAGES)
def test_losses_and_parameters_match_single_device(runs, stage):
    """Every logged loss of the [2,2] run equals the single-device one.
    After the last step, Adam's first moment (the steps' averaged
    gradients) is within 1e-5 of the state's largest, and the parameters
    within 1e-6 of each leaf's max wherever their gradient is above
    rounding: Adam (eps 1e-15) takes a full learning-rate step on a
    gradient at rounding level, whatever its size, so a leaf whose largest
    first moment is below 1e-6 of the state's, and an element whose
    second-moment root is below 5 % of its leaf's max, are not held.  Nor is
    the static stage's ``complex_rot``: its gradient at the initial state is
    zero up to rounding (an in-plane rotation of the in-plane-isotropic
    Gaussians changes nothing), so the first step moves it by ±lr on noise
    in either run."""
    single, multi = _losses(runs["single"][stage]), _losses(runs["multi"][stage])
    assert sorted(multi) == sorted(single)
    assert stage == "gaussian" or any(k.startswith("loss_sds") for k in single), sorted(single)
    for k in single:
        np.testing.assert_allclose(multi[k], single[k], rtol=1e-5, atol=1e-7, err_msg=k)
    sa, sb = _state(runs["multi"][stage]), _state(runs["single"][stage])
    a, b = _flat(sa), _flat(sb)
    assert sorted(a) == sorted(b)
    params = [k for k in b if b[k].is_floating_point() and "opt_state" not in k and "stats" not in k]
    ma, mb = sa["opt_state"]["state"], sb["opt_state"]["state"]
    assert len(params) == len(mb)
    m_max = max(float(m["exp_avg"].abs().max()) for m in mb.values())
    held_leaves = 0
    for i, k in enumerate(params):
        np.testing.assert_allclose(ma[i]["exp_avg"].numpy(), mb[i]["exp_avg"].numpy(), rtol=0,
                                   atol=1e-5 * m_max, err_msg=k)
        if float(mb[i]["exp_avg"].abs().max()) < 1e-6 * m_max or k == "/params/complex_rot":
            continue
        root_v = mb[i]["exp_avg_sq"].sqrt()
        held = root_v >= 0.05 * float(root_v.max())
        scale = float(b[k].abs().max()) or 1.0
        np.testing.assert_allclose(a[k][held].numpy(), b[k][held].numpy(), rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
        held_leaves += 1
    assert held_leaves >= len(params) // 2


def test_gaussian_densify_statistics_match(runs):
    """Across the density control at step 2: the alive mask (n_alive) and
    the statistics accumulated after it (grad_accum, denom, max_radii) are
    the single-device ones."""
    a, b = _state(runs["multi"]["gaussian"]), _state(runs["single"]["gaussian"])
    alive = b["gaussians"]["alive"]
    assert int(alive.sum()) > 64  # the density control cloned
    assert torch.equal(a["gaussians"]["alive"], alive)
    assert float(b["stats"]["denom"].sum()) > 0
    for k in ("denom", "max_radii"):
        assert torch.equal(a["stats"][k], b["stats"][k]), k
    g_a, g_b = a["stats"]["grad_accum"], b["stats"]["grad_accum"]
    np.testing.assert_allclose(g_a.numpy(), g_b.numpy(), rtol=1e-5, atol=1e-6 * float(g_b.max()))


def test_rank_zero_alone_writes(runs, tmp_path, monkeypatch):
    """The [2,2] trials hold one metrics row per step and one checkpoint, as
    the single-device ones do; a rank other than 0 writes no file at all."""
    for stage in dryrun.STAGES:
        multi, single = runs["multi"][stage], runs["single"][stage]
        assert [r["step"] for r in _rows(multi)] == [r["step"] for r in _rows(single)]
        assert os.listdir(os.path.join(multi, "ckpts")) == os.listdir(os.path.join(single, "ckpts"))
        assert sorted(os.listdir(multi)) == sorted(os.listdir(single))

    monkeypatch.setattr(pmesh, "is_main_process", lambda: False)
    yaml, extras = runs["lists"]["dynamic"]
    extras = [e for e in extras if not e.startswith(("exp_root_dir", "system.guidance"))]
    launch.main(launch.make_args(os.path.join(REPO, yaml), "train", device="cpu"),
                extras + [f"exp_root_dir={tmp_path}/out", "system.guidance.pretrained_model_name_or_path=none",
                          "trainer.max_steps=1"])
    assert not os.path.exists(tmp_path / "out")


def test_mesh_batch_and_device_errors(runs, tmp_path):
    """Raised by the launcher before any rank starts, as the JAX package
    raises them."""
    yaml, extras = runs["lists"]["static"]
    args = launch.make_args(os.path.join(REPO, yaml), "train", device="cpu")
    extras = extras + [f"exp_root_dir={tmp_path}"]
    with pytest.raises(ValueError, match="factor"):
        launch.main(args, extras + ["trainer.devices=4", "trainer.mesh=[3,2]"])
    odd = [e if not e.startswith("data.random_camera.batch_size") else "data.random_camera.batch_size=3"
           for e in extras]
    with pytest.raises(ValueError, match="divisible"):
        launch.main(args, odd + MULTI)
    dyn_yaml, dyn_extras = runs["lists"]["dynamic"]
    with pytest.raises(ValueError, match="divisible"):
        launch.main(launch.make_args(os.path.join(REPO, dyn_yaml), "train", device="cpu"),
                    dyn_extras + [f"exp_root_dir={tmp_path}", "data.num_frames=3"] + MULTI)
    with pytest.raises(ValueError, match="only .* visible"):
        launch.main(args, extras + ["trainer.devices=100000"])
    assert not os.listdir(tmp_path)
