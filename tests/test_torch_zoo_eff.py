"""The port's ``efficient-dreamfusion-system`` from
``configs/zoo/dreamfusion-sd-eff.yaml`` against the JAX package's (CPU):
one train step of each experiment from the YAML, with the Stable Diffusion
guidance on, at the size, weights, draws and bands of
``test_torch_zoo_dreamfusion.py`` (whose helpers it uses), but 32² views of
which an 8² subgrid is rendered (``sample_efficient``, a random offset from
the sampler's stream) and resized to 32² before SDS, and the z-variance
term switched on (``lambda_z_variance`` 0.5; the YAML has it at 0).
"""

import numpy as np
import pytest
from test_torch_zoo_dreamfusion import GRID, TINY_SD, _one_torch_thread, build_pair, check_one_step  # noqa: F401


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_eff")
    return build_pair("dreamfusion-sd-eff.yaml", TINY_SD + GRID + [
        "data.width=32", "data.height=32", "system.loss.lambda_z_variance=0.5", f"exp_root_dir={out}",
        "use_timestamp=false"])


def test_eff_dreamfusion_step_matches_jax(pair, monkeypatch):
    jexp, exp = pair
    assert exp._eff and jexp._eff
    batch = exp.train_batch(0)
    assert tuple(batch["rays_o"].shape) == (1, 8, 8, 3)
    jbatch = jexp.sampler.sample_efficient(8, 8)
    np.testing.assert_allclose(batch["rays_d"].numpy(), np.asarray(jbatch["rays_d"]), atol=1e-6)
    metrics = check_one_step(jexp, exp, monkeypatch)
    assert "loss_z_variance" in metrics
