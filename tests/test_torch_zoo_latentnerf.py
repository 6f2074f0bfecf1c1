"""The port's ``latentnerf-system`` from ``configs/zoo/latentnerf.yaml`` and
``sketchshape.yaml`` against the JAX package's (CPU).

One train step of ``latentnerf.yaml`` with ``system.guide_shape`` (the
80-face OBJ of ``test_torch_shape_loss.py``) and ``system.loss.lambda_shape
= 5.0``, so that one JAX step runs the LR scheduler (its warm-up factor
0.1 at step 0), the 4-channel latent render through SDS with
``rgb_as_latents`` and the sketch-shape term (4096 points over [-2, 2]³,
the same draws on both sides).  Size, draws and bands those of
``test_torch_zoo_dreamfusion.py``: metrics within 1e-4 relative, each
leaf's gradient within 1e-3 of its max |g|, the parameters after Adam
within 1e-6 where |g| ≥ 5 % of the leaf's max.  ``sketchshape.yaml`` is
built by both packages (the guidance off): the same losses, the same shape
grids (at ``grid_res`` 64) and no scheduler.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_shape_loss import write_guide_obj
from test_torch_zoo_dreamfusion import (GRID, REPO, TINY_SD, _one_torch_thread, build_jax,  # noqa: F401
                                        check_one_step, np_tree)

from dreammesh4d_tpu.ops import shape_loss as jsl
from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.systems.optim import scheduler_factor_fn


def build_both(path, dotlist):
    """(JAX experiment, its ShapeLoss or None, the port's experiment) of the
    YAML at ``path``."""
    made = []

    class Recorded(jsl.ShapeLoss):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsl, "ShapeLoss", Recorded)
        jexp = build_jax(path, dotlist)
    exp = assembly.build_experiment(load_config(path, cli_args=dotlist), device="cpu")
    return jexp, (made[0] if made else None), exp


def build_pair(yaml, dotlist):
    """Both packages' experiments and the JAX ShapeLoss; the port's starts
    from the JAX one's parameters (fresh Adam moments on both sides) and SD
    weights."""
    jexp, jshape, exp = build_both(os.path.join(REPO, "configs", "zoo", yaml), dotlist)
    s = np_tree(jexp.state)
    exp.load_state(convert.zero123_checkpoint({"geo_params": s.geo_params, "step": s.step}, eps=exp.adam["eps"]))
    guidance = exp.pack[0]
    guidance.modules.load_state_dict({k: torch.tensor(v) for k, v in convert.sd_guidance_params(
        np_tree(jexp._gstate["params"]), guidance.cfg).items()})
    return jexp, jshape, exp


@pytest.fixture(scope="module")
def guide(tmp_path_factory):
    return write_guide_obj(tmp_path_factory.mktemp("latentnerf_guide") / "guide.obj")


@pytest.fixture(scope="module")
def dotlist(guide, tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_latentnerf")
    return TINY_SD + GRID + ["data.width=8", "data.height=8", f"exp_root_dir={out}", "use_timestamp=false",
                             f"system.guide_shape={guide}"]


def test_latentnerf_step_matches_jax(dotlist, monkeypatch):
    jexp, jshape, exp = build_pair("latentnerf.yaml", dotlist + ["system.loss.lambda_shape=5.0"])
    assert type(exp).__name__ == "ZooTextExperiment" and exp.geo_cfg.n_feature_dims == 4
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg)
    assert exp.shape_loss is not None and exp.shape_loss.n_faces == 80
    np.testing.assert_array_equal(exp.shape_loss.occ_grid.numpy(), np.asarray(jshape.occ_grid))
    factor = scheduler_factor_fn(exp.cfg.system.scheduler)
    metrics = check_one_step(jexp, exp, monkeypatch, jax_grads=lambda state: state.opt_state[0][0])
    assert set(metrics) == {"loss_sds", "loss_shape", "loss_orient", "loss_sparsity", "loss_opaque", "loss_total"}
    assert float(metrics["loss_shape"]) > 0
    # the update was taken at the warm-up's first factor, as the JAX scale_by_schedule's count 0
    assert exp.state.opt_state.param_groups[0]["lr"] == 0.01 * factor(0) and factor(0) == pytest.approx(0.1)
    assert int(np_tree(jexp.state.opt_state[1]).count) == 1


def test_sketchshape_builds_like_jax(dotlist):
    jexp, jshape, exp = build_both(os.path.join(REPO, "configs", "zoo", "sketchshape.yaml"),
                                   dotlist + ["system.guidance.pretrained_model_name_or_path=none"])
    assert exp.lr_schedule is None and "schedule" not in exp.state.opt_state.param_groups[0]
    assert dict(exp.cfg.system.loss) == dict(jexp.cfg.system.loss) and exp.cfg.system.loss.lambda_shape == 5.0
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg) and exp.geo_cfg.n_feature_dims == 4
    np.testing.assert_array_equal(exp.shape_loss.occ_grid.numpy(), np.asarray(jshape.occ_grid))
    np.testing.assert_allclose(exp.shape_loss.weight_grid.numpy(), np.asarray(jshape.weight_grid), atol=1e-6)
    assert exp.shape_loss.occ_grid.shape == (64, 64, 64) and 0 < float(exp.shape_loss.occ_grid.mean()) < 1
