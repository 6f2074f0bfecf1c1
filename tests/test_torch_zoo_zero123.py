"""``configs/zoo/zero123.yaml`` on the port's ``zero123-system`` against the
JAX package's ``Zero123Experiment`` (CPU), guidance on.

The YAML names ``guidance_type: "zero123-guidance"`` (the vanilla camera
embedding); the JAX launcher builds ``StableZero123Guidance`` whatever that
key says, and so does the port's (``assembly.LAUNCHER_GUIDANCE``), while
``find("zero123-guidance")`` gives the vanilla class.  At a tiny size — a
24² RGBA reference read at 8², 4 random views at 8² (the YAML's batch), 2
hash levels of 2⁸ corner rows (the YAML's corner layout, base 4, scale 2),
the YAML's MLPs and renderer (importance sampling, 64 + 64 samples), Stable
Zero123 at ``random:0`` with a UNet 16 × [1], a VAE 8 × [1], latents and
images 8² and no CLIP — both packages' experiments come from the YAML
through their config loaders, the port's from the JAX one's state and
guidance weights (``convert.zero123_checkpoint``,
``convert.zero123_guidance_params``, the bank rebuilt from them).

- The initial state and configs: leaf by leaf equal, Adam with the YAML's
  ``optimizer.args``, the geometry (corner layout) and renderer configs
  equal, the guidance the stable variant, the bank within 1e-5 of the JAX
  bank's max.
- ``train_step(0)`` on the same draws (``test_torch_zoo_dreamfusion.py``'s
  ``same_draws``, the ambient ratio from the global numpy stream seeded
  alike): every metric within 1e-4 relative (1e-6 absolute floor), every
  leaf's gradient within 1e-3 of its max |g|, the parameters after Adam
  within 1e-6 where |g| ≥ 5 % of the leaf's max.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_zoo_dreamfusion import (GRID, REPO, _one_torch_thread, build_jax, build_port,  # noqa: F401
                                        check_one_step, leaves, np_tree)

from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.data.png import write_png
from dreammesh4d_tpu_torch.models.guidance.zero123 import guidance as pg
from dreammesh4d_tpu_torch.registry import find

YAML = os.path.join(REPO, "configs", "zoo", "zero123.yaml")
TINY_Z = ["system.guidance.pretrained_model_name_or_path=random:0", "system.guidance.model_channels=16",
          "system.guidance.channel_mult=[1]", "system.guidance.num_res_blocks=1", "system.guidance.num_heads=2",
          "system.guidance.context_dim=16", "system.guidance.vae_ch=8", "system.guidance.vae_ch_mult=[1]",
          "system.guidance.vae_num_res_blocks=1", "system.guidance.image_size=8",
          "system.guidance.latent_size=8", "system.guidance.use_clip=false"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_zero123")
    yy, xx = np.mgrid[0:24, 0:24]
    inside = (xx - 11.5) ** 2 + (yy - 11.5) ** 2 < 7.0 ** 2
    write_png(str(d / "ref_rgba.png"), np.stack([xx * 10, yy * 10, (xx + yy) * 5, inside * 255], -1).astype(np.uint8))
    dotlist = TINY_Z + GRID + [f"data.image_path={d}/ref_rgba.png", "data.height=8", "data.width=8",
                               "data.random_camera.height=8", "data.random_camera.width=8",
                               f"exp_root_dir={d}/out", "use_timestamp=false"]
    jexp = build_jax(YAML, dotlist)
    exp = build_port(YAML, dotlist, jexp)
    gparams, jbank = jexp._gstate
    sd = convert.zero123_guidance_params(np_tree(gparams), exp.guidance.cfg)
    exp.guidance.modules.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    exp.bank = exp.guidance.prepare_embeddings(exp.data.ref_batch()["ref_rgb"])
    return jexp, exp, jbank


def test_initial_state_and_guidance(pair):
    jexp, exp, jbank = pair
    assert exp.cfg.system.guidance.guidance_type == "zero123-guidance"
    assert type(exp.guidance) is find("stable-zero123-guidance")
    assert find("zero123-guidance") is pg.Zero123Guidance
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg)
    assert exp.geo_cfg.hashgrid.layout == "corner" and exp.rcfg.estimator == "importance"
    assert exp.rcfg == convert.nerf_renderer_config(jexp.rcfg)
    for got, ref in zip(leaves(exp.state.geo_params), leaves(np_tree(jexp.state.geo_params))):
        np.testing.assert_array_equal(got.detach().numpy(), ref)
    group = exp.state.opt_state.param_groups[0]
    assert (group["lr"], tuple(group["betas"]), group["eps"]) == (0.01, (0.9, 0.99), 1e-8)
    for k, perm in (("c_crossattn", None), ("c_concat", (0, 2, 3, 1))):
        got, want = exp.bank[k].numpy(), np.asarray(jbank[k])
        got = got.transpose(perm) if perm else got
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k


def test_one_step_matches_jax(pair, monkeypatch):
    jexp, exp, _ = pair
    metrics = check_one_step(jexp, exp, monkeypatch, reseed=7)
    assert {"loss_sds", "loss_rgb", "loss_mask", "loss_normal_smooth", "loss_orient"} <= set(metrics)
