"""K-nearest-neighbour queries by chunked brute force (counterpart of
``dreammesh4d_tpu/ops/knn.py``: ``knn`` :33, ``dist_knn3_mean`` :68).

Squared distances of a chunk of queries to every point through the
|q|² + |p|² − 2 q·p expansion (the cross term is one matmul), clamped at 0,
then the k smallest.  Plain PyTorch on any device: the heavy call sites
run once (initial scales) or every ``reset_neighbors`` steps (the SuGaR
regulariser's neighbour table).

Order: ascending distance, and on equal distances the lower point index
first, as ``jax.lax.top_k`` of the negated distances gives them.  Equal
distances are common here (a clone copies its source's centre exactly;
dead slots all sit at one far point), and ``torch.topk`` does not promise
an order among them, so the selection runs on an int64 key: the distance's
float32 bits (monotone for non-negative floats) above the point index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """|x|² of 3-vectors rounded as XLA's fused reduction forms it,
    fma(z, z, fma(y, y, x·x)): one float32 rounding per step (the products
    are exact in float64).  Geometric ties (a mesh's vertices) then stay
    ties, as in the JAX package, and keep its index order."""
    x = x.double()
    acc = (x[:, 0] * x[:, 0]).float().double()
    acc = (x[:, 1] * x[:, 1] + acc).float().double()
    return (x[:, 2] * x[:, 2] + acc).float()


def _chunk_dists(q: torch.Tensor, p: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (Qc, P) via the |q|²+|p|²−2qp expansion."""
    return torch.clamp(_sq_norms(q)[:, None] + p2[None, :] - 2.0 * (q @ p.T), min=0.0)


def knn(queries: torch.Tensor, points: torch.Tensor, k: int, chunk: int = 1024,
        exclude_self: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq_dists (Q, k), indices (Q, k) int64) of the k nearest points of
    every query.  ``exclude_self`` masks the point of the query's own index
    (for ``queries`` being ``points``)."""
    P = points.shape[0]
    pidx = torch.arange(P, device=points.device)
    p2 = _sq_norms(points)
    dists, idxs = [], []
    for start in range(0, queries.shape[0], chunk):
        d = _chunk_dists(queries[start:start + chunk], points, p2)
        if exclude_self:
            qidx = start + torch.arange(d.shape[0], device=d.device)
            d = torch.where(qidx[:, None] == pidx[None, :], torch.full_like(d, float("inf")), d)
        key = (d.view(torch.int32).to(torch.int64) << 32) | pidx[None, :]
        key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        idx = key & 0xFFFFFFFF
        dists.append(torch.gather(d, 1, idx))
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)


def dist_knn3_mean(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean squared distance to the 3 nearest other points (the initial
    scales' ``distCUDA2``)."""
    d, _ = knn(points, points, k=3, chunk=chunk, exclude_self=True)
    return d.mean(-1)
