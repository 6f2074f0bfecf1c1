"""The Adan optimiser (Adaptive Nesterov momentum; counterpart of the optax
transformation ``dreammesh4d_tpu/systems/adan.py:31-78``), computing what
it computes:

    d_k = g_k − g_{k−1} (0 on the first step)
    m_k = (1 − β1) m_{k−1} + β1 g_k
    v_k = (1 − β2) v_{k−1} + β2 d_k
    n_k = (1 − β3) n_{k−1} + β3 (g_k + (1 − β2) d_k)²
    u_k = −lr (m_k / c1 + (1 − β2) v_k / c2) / (√(n_k / c3) + ε),
          c_i = 1 − (1 − β_i)^k in float32
    with weight decay: u_k ← (u_k − lr·wd·θ) / (1 + lr·wd)
    θ_{k+1} = θ_k + u_k

The betas follow the reference's "1 − β" convention (defaults 0.98, 0.92,
0.99).  Reached from Python only, as in the JAX package (no
``optimizer.name`` selects it).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1e-3, betas: Tuple[float, float, float] = (0.98, 0.92, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            b1, b2, b3 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for k in ("m", "v", "n", "prev_grad"):
                        state[k] = torch.zeros_like(p)
                diff = torch.zeros_like(g) if state["step"] == 0 else g - state["prev_grad"]
                state["step"] += 1
                m, v, n = state["m"], state["v"], state["n"]
                m.mul_(1 - b1).add_(b1 * g)
                v.mul_(1 - b2).add_(b2 * diff)
                n.mul_(1 - b3).add_(b3 * (g + (1 - b2) * diff) ** 2)
                k = torch.tensor(float(state["step"]), dtype=torch.float32, device=p.device)
                c1, c2, c3 = (1 - torch.tensor(1 - b, dtype=torch.float32, device=p.device) ** k
                              for b in (b1, b2, b3))
                upd = -lr * ((m / c1 + (1 - b2) * v / c2) / (torch.sqrt(n / c3) + eps))
                if wd > 0:
                    upd = (upd - lr * wd * p) / (1 + lr * wd)
                p.add_(upd)
                state["prev_grad"].copy_(g)
        return loss
