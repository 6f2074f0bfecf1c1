"""The port's ``prolificdreamer-system`` from ``configs/zoo/prolificdreamer.yaml``
against the JAX package's (CPU).

One train step of both, the size, draws and bands of
``test_torch_zoo_dreamfusion.py``, with the VSD guidance at the tiny SD
widths (weights carried by ``convert.sd_guidance_params``).  Both start
from the JAX experiment's scene and LoRA, the LoRA's B drawn non-zero (at
its init B = 0 leaves every A without a gradient), carried by
``convert.vsd_checkpoint``.  Held: every metric within 1e-4 relative; the
scene's and every LoRA leaf's gradient within 1e-3 of its max |g|; the
scene and the LoRA after their Adams within 1e-6 where |g| ≥ 5 % of the
leaf's max.

A tie at the ReLU: at the JAX initialisation one pre-activation of the
feature MLP's first layer is 3.4e-13 (its terms are ~1e-5, whose float32
rounding decides its sign), and the two packages take opposite sides of
the kink, which moves that layer's gradient by 1.7e-3 of its max (measured:
with that one derivative flipped the gap is 3e-5).  The port's step here
takes the other side of each such tie (first-layer pre-activations within
TIE of zero, at most MAX_TIES of them); the bands are unchanged.

Port only: the checkpoint written by the trainer's ``save_checkpoint`` and
read back by ``load_state`` gives the next step exactly (metrics, scene,
LoRA and both Adams' counts).
"""

import os

import jax
import numpy as np
import pytest
import torch
from test_torch_zoo_dreamfusion import (GRID, REPO, TINY_SD, _one_torch_thread, build_jax,  # noqa: F401
                                        check_one_step, np_tree, same_draws)

from dreammesh4d_tpu_torch import convert
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.models.geometry import implicit_volume as piv
from dreammesh4d_tpu_torch.systems import assembly
from dreammesh4d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from dreammesh4d_tpu_torch.utils.tree import tree_leaves

TIE, MAX_TIES = 1e-11, 3


class _TieFlippedRelu(torch.autograd.Function):
    """ReLU whose derivative takes the other side of the kink where |z| < TIE."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return torch.relu(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return g * ((z > 0) ^ (z.abs() < TIE))


def flip_relu_ties(monkeypatch, exp):
    """The port's feature MLP runs its first ReLU through _TieFlippedRelu;
    returns the list that receives each call's number of ties."""
    ties, plain = [], piv._mlp_apply

    def mlp_apply(params, x):
        if params is not exp.state.geo_params["feature_mlp"] or not torch.is_grad_enabled():
            return plain(params, x)
        z = x @ params[0]["w"] + params[0]["b"]
        ties.append(int((z.abs() < TIE).sum()))
        return plain(params[1:], _TieFlippedRelu.apply(z))

    monkeypatch.setattr(piv, "_mlp_apply", mlp_apply)
    return ties


def lora_leaves(tree):
    return [(f"{name}.{k}", v) for name, leaves in tree.items() for k, v in leaves.items()]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("zoo_prolificdreamer")
    dotlist = TINY_SD + GRID + ["data.width=8", "data.height=8", f"exp_root_dir={out}", "use_timestamp=false"]
    path = os.path.join(REPO, "configs", "zoo", "prolificdreamer.yaml")
    jexp = build_jax(path, dotlist, fast_compile=False)  # at a ReLU's kink: XLA's full passes
    rng = np.random.default_rng(9)
    lora = np_tree(jexp.state.lora_params)
    for leaves in lora.values():
        if "B" in leaves:
            leaves["B"] = (0.3 * rng.normal(size=leaves["B"].shape)).astype(np.float32)
    jexp.state = jexp.state._replace(lora_params=jax.tree.map(jax.numpy.asarray, lora))
    exp = assembly.build_experiment(load_config(path, cli_args=dotlist), device="cpu")
    guidance = exp.pack[0]
    guidance.modules.load_state_dict({k: torch.tensor(v) for k, v in convert.sd_guidance_params(
        np_tree(jexp._gstate["params"]), guidance.cfg).items()})
    s = np_tree(jexp.state)
    exp.load_state(convert.vsd_checkpoint({"geo_params": s.geo_params, "lora_params": s.lora_params,
                                           "step": s.step}, guidance.cfg, eps=exp.adam["eps"]))
    return jexp, exp


def test_prolificdreamer_step_matches_jax(pair, monkeypatch):
    jexp, exp = pair
    assert type(exp).__name__ == "ZooVSDExperiment" and type(exp.pack[0]).__name__ == "VSDGuidance"
    assert exp.geo_cfg == convert.implicit_volume_config(jexp.geo_cfg)
    assert (exp.adam["lr"], exp.adam["betas"], exp.adam["eps"], exp.lora_lr) == (0.01, (0.9, 0.99), 1e-15, 1e-3)
    lora_opt = exp.state.lora_opt_state.param_groups[0]
    assert (lora_opt["betas"], lora_opt["eps"]) == ((0.9, 0.999), 1e-8)
    cfg = exp.pack[0].cfg
    jlora0 = convert.vsd_lora_params(np_tree(jexp.state.lora_params), cfg)
    ties = flip_relu_ties(monkeypatch, exp)
    metrics = check_one_step(jexp, exp, monkeypatch, sds_keys=("loss_vsd", "loss_lora"))
    assert set(metrics) == {"loss_vsd", "loss_lora", "loss_orient", "loss_sparsity", "loss_opaque", "loss_total"}
    assert 0 < sum(ties) <= MAX_TIES, ties
    jgrads = convert.vsd_lora_params(np_tree(jexp.state.lora_opt_state[0]), cfg)
    jnew = convert.vsd_lora_params(np_tree(jexp.state.lora_params), cfg)
    n_checked = 0
    for name, leaf in lora_leaves(exp.state.lora_params):
        key, part = name.rsplit(".", 1)
        jg, jp, jn = jgrads[key][part], jlora0[key][part], jnew[key][part]
        g = leaf.grad.numpy()
        assert np.abs(jg).max() > 0, name
        err = np.abs(g - jg).max() / np.abs(jg).max()
        assert err <= 1e-3, (name, err)
        sure = np.abs(jg) >= 0.05 * np.abs(jg).max()
        n_checked += int(sure.sum())
        np.testing.assert_allclose(leaf.detach().numpy()[sure], jn[sure], atol=1e-6, err_msg=name)
        assert np.abs(jn - jp).max() > 0, name
    assert n_checked > 100


def test_checkpoint_round_trip_gives_the_same_next_step(pair, monkeypatch, tmp_path):
    _, exp = pair
    same_draws(monkeypatch)
    step = exp.state.step
    path = save_checkpoint(str(tmp_path), step, exp.state_for_checkpoint())
    batch = exp.train_batch(1)
    gen_state = exp.generator.get_state()
    state, metrics = exp._step(exp.state, batch, exp.generator)
    after = [x.detach().clone() for x in tree_leaves(state.geo_params) + tree_leaves(state.lora_params)]

    exp.load_state(restore_checkpoint(path, "cpu"))
    assert exp.state.step == step
    exp.generator.set_state(gen_state)
    state2, metrics2 = exp._step(exp.state, batch, exp.generator)
    assert state2.step == step + 1
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in metrics2.items()}
    for a, b in zip(after, tree_leaves(state2.geo_params) + tree_leaves(state2.lora_params)):
        assert torch.equal(a, b.detach())
    for opt in (state2.opt_state, state2.lora_opt_state):
        assert {int(s["step"]) for s in opt.state.values()} == {step + 1}
