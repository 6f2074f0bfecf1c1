"""The port's ``magic123-system`` from ``configs/zoo/magic123-coarse-sd.yaml``
against the JAX package's (CPU): one train step of each experiment from
the YAML with both priors on, at the sizes, draws and bands of
``test_torch_zoo_dreamfusion.py`` (whose helpers it uses): a 24² RGBA
reference read at 8², one 8² random view, the SD guidance of that file, and
``system.guidance_3d`` (Stable Zero123 at ``random:0``: UNet 16 × [1],
VAE 8 × [1], latents and images 8², the mean-colour projector in place
of CLIP), its weights carried by ``convert.zero123_guidance_params`` and its
bank rebuilt from them (held to the JAX bank within 1e-5 of its max).  The
loss has every term: rgb, mask, sds_2d, sds_3d, the normal smoothness
(the YAML's 1000) and the regularisers at nonzero weights.

Both views have a fovy of 20° (the YAML's 40°), so that most rays meet the
density blob.  At 40° most rays cross only near-empty space, where the
analytic normal −∇σ of a density below ~1e-3 is ill-conditioned in
float32: there the JAX package's ∇σ lies up to 3.2e-3 (relative) from a
float64 evaluation and the port's within 3.5e-6, which moves the normal
smoothness of the JAX step by 1.2e-3 (measured at this size).
"""

import numpy as np
import pytest
import torch
from test_torch_zoo_dreamfusion import (GRID, TINY_SD, _one_torch_thread, build_pair,  # noqa: F401
                                        check_one_step, np_tree)

from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.data.png import write_png

TINY_Z = ["system.guidance_3d.pretrained_model_name_or_path=random:0", "system.guidance_3d.model_channels=16",
          "system.guidance_3d.channel_mult=[1]", "system.guidance_3d.num_res_blocks=1",
          "system.guidance_3d.num_heads=2", "system.guidance_3d.context_dim=16", "system.guidance_3d.vae_ch=8",
          "system.guidance_3d.vae_ch_mult=[1]", "system.guidance_3d.vae_num_res_blocks=1",
          "system.guidance_3d.image_size=8", "system.guidance_3d.latent_size=8",
          "system.guidance_3d.use_clip=false"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo_magic123")
    yy, xx = np.mgrid[0:24, 0:24]
    inside = (xx - 11.5) ** 2 + (yy - 11.5) ** 2 < 7.0 ** 2
    write_png(str(d / "ref_rgba.png"), np.stack([xx * 10, yy * 10, (xx + yy) * 5, inside * 255], -1).astype(np.uint8))
    jexp, exp = build_pair("magic123-coarse-sd.yaml", TINY_SD + TINY_Z + GRID + [
        f"data.image_path={d}/ref_rgba.png", "data.height=8", "data.width=8",
        "data.random_camera.height=8", "data.random_camera.width=8", "data.default_fovy_deg=20",
        "data.random_camera.fovy_range=[20,20]", "system.loss.lambda_orient=1.0",
        "system.loss.lambda_sparsity=0.5", "system.loss.lambda_opaque=0.5", f"exp_root_dir={d}/out",
        "use_timestamp=false"])
    g3 = jexp._gstate["3d"]
    sd = convert.zero123_guidance_params(np_tree(g3["params"]), exp.guidance_3d.cfg)
    exp.guidance_3d.modules.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    exp.bank = exp.guidance_3d.prepare_embeddings(exp.data.ref_batch()["ref_rgb"])
    for k, perm in (("c_crossattn", None), ("c_concat", (0, 2, 3, 1))):
        got, want = exp.bank[k].numpy(), np.asarray(g3["bank"][k])
        got = got.transpose(perm) if perm else got
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
    return jexp, exp


def test_magic123_step_matches_jax(pair, monkeypatch):
    jexp, exp = pair
    assert type(exp).__name__ == "ZooImageExperiment" and exp.guidance_3d is not None
    assert type(exp.guidance_3d).__name__ == "StableZero123GuidanceComponent"
    metrics = check_one_step(jexp, exp, monkeypatch, sds_keys=("loss_sds_2d", "loss_sds_3d"))
    assert set(metrics) == {"loss_rgb", "loss_mask", "loss_sds_2d", "loss_sds_3d", "loss_normal_smooth",
                            "loss_orient", "loss_sparsity", "loss_opaque", "loss_total"}
