"""The port's Adan optimiser (``systems/adan.py``) against the JAX package's
optax transformation (``dreammesh4d_tpu/systems/adan.py``), on the CPU.

20 steps on a tree of three leaves with seeded numpy gradients (the same
for both), ``weight_decay`` 0 and 0.01: after every step each parameter
within 1e-6 of its leaf's max |value|, and the moments m, v, n within 1e-6
of theirs at the end.  The first step takes no gradient difference.  The
JAX update runs under one ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreammesh4d_tpu.systems.adan import adan
from dreammesh4d_tpu_torch.systems.adan import Adan

SHAPES = {"a": (5,), "b": (4, 3), "c": (2, 2, 2)}
STEPS, LR = 20, 0.05


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adan_matches_optax(weight_decay):
    rng = np.random.default_rng(41)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(STEPS)]
    opt = adan(learning_rate=LR, weight_decay=weight_decay)
    update = jax.jit(opt.update)
    jp, state = jax.tree.map(jnp.asarray, params), opt.init(params)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = Adan(list(tp.values()), lr=LR, weight_decay=weight_decay)
    assert topt.defaults["betas"] == (0.98, 0.92, 0.99) and topt.defaults["eps"] == 1e-8
    for step, g in enumerate(grads):
        updates, state = update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
        for k, p in tp.items():
            err = _rel(p.detach().numpy(), np.asarray(jp[k]))
            assert err <= 1e-6, (step, k, err)
        if step == 0:  # no gradient difference on the first step: v stays 0
            assert all(not topt.state[p]["v"].any() for p in tp.values())
    assert int(state.count) == STEPS == topt.state[tp["a"]]["step"]
    for name in ("m", "v", "n"):
        for k, p in tp.items():
            err = _rel(topt.state[p][name].numpy(), np.asarray(getattr(state, name)[k]))
            assert err <= 1e-6, (name, k, err)


def test_adan_takes_no_step_without_a_gradient():
    p, q = torch.ones(3, requires_grad=True), torch.ones(2, requires_grad=True)
    opt = Adan([p, q], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(q.detach(), torch.ones(2)) and q not in opt.state
    assert (p.detach() < 1).all()
