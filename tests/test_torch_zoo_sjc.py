"""The port's ``sjc-system`` from ``configs/zoo/sjc.yaml`` against the JAX
package's (CPU): one train step with ``system.loss.lambda_depth`` set, so
that the SDS term, the emptiness term (under its ``C`` schedule) and the
centre-depth contrast all run.  Size, draws and bands those of
``test_torch_zoo_dreamfusion.py`` (metrics within 1e-4 relative, each
leaf's gradient within 1e-3 of its max |g|, the parameters after Adam
within 1e-6 where |g| ≥ 5 % of the leaf's max).
"""

from test_torch_zoo_dreamfusion import GRID, TINY_SD, _one_torch_thread, build_pair, check_one_step  # noqa: F401

from dreammesh4d_tpu_torch import convert


def test_sjc_step_matches_jax(tmp_path, monkeypatch):
    jexp, exp = build_pair("sjc.yaml", TINY_SD + GRID + [
        "data.width=8", "data.height=8", f"exp_root_dir={tmp_path}", "use_timestamp=false",
        "system.loss.lambda_depth=0.5"])
    assert type(exp).__name__ == "ZooTextExperiment" and exp.shape_loss is None
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg) and exp.geo_cfg.n_feature_dims == 3
    assert exp.adam["lr"] == 0.05 and exp.lr_schedule is None
    metrics = check_one_step(jexp, exp, monkeypatch)
    assert set(metrics) == {"loss_sds", "loss_emptiness", "loss_depth", "loss_total"}
    assert float(metrics["loss_emptiness"]) > 0 and float(metrics["loss_depth"]) != 0
