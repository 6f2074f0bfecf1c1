"""The port's LR scheduler (``systems/optim.py``) against the JAX package's
(CPU).

- Every scheduler name, SequentialLR with two milestones and
  ChainedScheduler: ``scheduler_factor_fn`` at steps 0–300 within 1e-6 of
  the JAX ``scheduler_factor_fn`` (float64 on the host) and of
  ``jnp_factor_fn`` (float32, what the JAX step runs); an unknown name
  raises ``NotImplementedError`` in both packages.
- ``configs/zoo/latentnerf.yaml``'s block, resolved by both config loaders
  (the warm-up milestone and ``calc_exp_lr_decay_rate``): equal blocks, the
  factor within 1e-6 of ``jnp_factor_fn`` at steps 0–300.  Against the
  float64 twin the band is 1e-5: its decay rate 0.99976744…, rounded to
  float32 as both float32 evaluations round it, moves the factor by up to
  3.8e-6 at step 300 (measured).
- Three Adam updates of a toy tensor under that block (``scheduled_lr`` and
  ``set_learning_rates``) against optax ``with_scheduler(adam)``, within
  1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreammesh4d_tpu.config import load_config as j_load_config
from dreammesh4d_tpu.systems import optim as joptim
from dreammesh4d_tpu_torch.config import load_config
from dreammesh4d_tpu_torch.systems import optim

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """With several test workers on the cores, torch's intra-op pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = np.arange(0, 301)

LINEAR = {"name": "LinearLR", "args": {"start_factor": 0.1, "end_factor": 1.0, "total_iters": 100}}
CASES = {
    "StepLR": {"name": "StepLR", "args": {"step_size": 30, "gamma": 0.5}},
    "MultiStepLR": {"name": "MultiStepLR", "args": {"milestones": [120, 50, 200], "gamma": 0.3}},
    "ExponentialLR": {"name": "ExponentialLR", "args": {"gamma": 0.99}},
    "LinearLR": LINEAR,
    "ConstantLR": {"name": "ConstantLR", "args": {"factor": 0.25, "total_iters": 40}},
    "CosineAnnealingLR": {"name": "CosineAnnealingLR", "args": {"T_max": 200, "eta_min": 0.1}},
    "LambdaLR": {"name": "LambdaLR", "args": {"lr_lambda": [10, 1.0, 0.2, 250]}},
    "SequentialLR": {"name": "SequentialLR", "milestones": [60, 150], "schedulers": [
        LINEAR, {"name": "ConstantLR", "args": {"factor": 0.5, "total_iters": 30}},
        {"name": "ExponentialLR", "args": {"gamma": 0.98}}]},
    "ChainedScheduler": {"name": "ChainedScheduler", "schedulers": [
        {"name": "StepLR", "args": {"step_size": 70, "gamma": 0.7}}, LINEAR]},
}


def _max_gap(factor, ref):
    return max(abs(factor(int(s)) - float(ref(s))) for s in STEPS)


@pytest.fixture(scope="module")
def jnp_values():
    """Every case's ``jnp_factor_fn`` at STEPS, in one jit."""
    fns = {k: joptim.jnp_factor_fn(c) for k, c in CASES.items()}
    out = jax.jit(lambda s: {k: jax.vmap(f)(s) for k, f in fns.items()})(jnp.asarray(STEPS))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_matches_jax(name, jnp_values):
    cfg = CASES[name]
    factor = optim.scheduler_factor_fn(cfg)
    host = joptim.scheduler_factor_fn(cfg)
    got = np.array([factor(int(s)) for s in STEPS])
    assert np.abs(got - np.array([host(int(s)) for s in STEPS])).max() <= 1e-6
    assert np.abs(got - jnp_values[name]).max() <= 1e-6
    assert got.max() > got.min()  # the schedule moves within the window


def test_unknown_name_raises_in_both():
    for fn in (optim.scheduler_factor_fn, joptim.scheduler_factor_fn, joptim.jnp_factor_fn):
        with pytest.raises(NotImplementedError):
            fn({"name": "OneCycleLR", "args": {}})
    assert optim.scheduled_lr(0.01, None) is None
    with pytest.raises(ValueError):
        optim.scheduled_lr(0.01, {"name": "StepLR", "interval": "batch", "args": {"step_size": 1}})


@pytest.fixture(scope="module")
def latentnerf_blocks(tmp_path_factory):
    path = os.path.join(REPO, "configs", "zoo", "latentnerf.yaml")
    dotlist = ["system.prompt_processor.prompt=x", f"exp_root_dir={tmp_path_factory.mktemp('sched')}"]
    port = load_config(path, cli_args=dotlist, makedirs=False).system["scheduler"]
    ref = j_load_config(path, cli_args=dotlist, makedirs=False).system["scheduler"]
    return port, ref


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def test_latentnerf_block_matches_jax(latentnerf_blocks):
    port, ref = latentnerf_blocks
    assert _plain(port) == _plain(ref)
    assert port["milestones"] == [100] and port["schedulers"][1]["args"]["gamma"] == pytest.approx(
        0.1 ** (1 / 9900), rel=1e-12)
    factor = optim.scheduler_factor_fn(port)
    jnp_factor = jax.jit(jax.vmap(joptim.jnp_factor_fn(ref)))(jnp.asarray(STEPS))
    assert _max_gap(factor, lambda s: jnp_factor[s]) <= 1e-6
    assert _max_gap(factor, joptim.scheduler_factor_fn(ref)) <= 1e-5
    assert factor(0) == pytest.approx(0.1) and factor(100) == 1.0 and factor(50) == pytest.approx(0.55)


def test_adam_under_the_schedule_matches_optax(latentnerf_blocks):
    port, ref = latentnerf_blocks
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    lr, betas, eps = 0.01, (0.9, 0.99), 1e-15

    tx = joptim.with_scheduler(optax.adam(lr, b1=betas[0], b2=betas[1], eps=eps), ref)
    params = jnp.asarray(x0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)

    p = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.Adam([{"params": [p], "schedule": optim.scheduled_lr(lr, port)}], lr=lr, betas=betas,
                           eps=eps)
    lrs = []
    for g in grads:
        p.grad = torch.tensor(g)
        optim.set_learning_rates(opt)
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
    assert lrs == [lr * optim.scheduler_factor_fn(port)(k) for k in range(3)] and lrs[0] < lrs[1] < lrs[2]
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=0, atol=1e-7)
    assert np.abs(np.asarray(params) - x0).max() > 1e-3  # the updates moved it
