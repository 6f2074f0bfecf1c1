"""Quaternion / SO(3) / dual-quaternion algebra, wxyz convention
(counterpart of ``dreammesh4d_tpu/ops/quaternion.py:24-226``).

This module also stands in for ``dreammesh4d_tpu/ops/quaternion_planar.py``:
the ``pl_*`` functions there compute the same values with the component axis
leading, a layout chosen for the TPU's vector lanes.  Here every function
keeps the component axis last — ``(..., 4)`` quaternions, ``(..., 8)`` dual
quaternions — and the planar names map one to one:

    pl_norm / pl_quat_normalize -> quat_normalize     pl_quat_mul -> quat_multiply
    pl_quat_conjugate -> quat_conjugate               pl_cross -> cross
    pl_quat_apply -> quat_apply                       pl_quat_log / pl_quat_exp -> quat_log / quat_exp
    pl_fuse_rotations -> fuse_rotations               pl_dq_* -> dq_*
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting leading dims)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_standardize(q: torch.Tensor) -> torch.Tensor:
    """Force w >= 0 (q and -q are the same rotation)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (wxyz)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_apply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (...,3) by unit quaternions q (...,4):
    p' = p + 2 w (v × p) + 2 v × (v × p)."""
    w = q[..., :1]
    v = q[..., 1:]
    uv = cross(v, p)
    uuv = cross(v, uv)
    return p + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz) -> rotation matrix (...,3,3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        -1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (wxyz), branch-free: the
    four-candidate construction, taking the candidate with the largest score
    (first on ties, as ``jnp.argmax``), then normalized and standardized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = safe_sqrt(1.0 + tr) / 2.0
    qx = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    qy = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    qz = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0

    # the never-selected small denominators are clamped so a backward pass
    # stays NaN-free (same as the JAX package)
    dw = torch.clamp(4 * qw, min=0.1)
    dx = torch.clamp(4 * qx, min=0.1)
    dy = torch.clamp(4 * qy, min=0.1)
    dz = torch.clamp(4 * qz, min=0.1)

    q0 = torch.stack([qw, (m21 - m12) / dw, (m02 - m20) / dw, (m10 - m01) / dw], -1)
    q1 = torch.stack([(m21 - m12) / dx, qx, (m01 + m10) / dx, (m02 + m20) / dx], -1)
    q2 = torch.stack([(m02 - m20) / dy, (m01 + m10) / dy, qy, (m12 + m21) / dy], -1)
    q3 = torch.stack([(m10 - m01) / dz, (m02 + m20) / dz, (m12 + m21) / dz, qz], -1)

    cand = torch.stack([q0, q1, q2, q3], -2)  # (...,4,4)
    score = torch.stack([qw, qx, qy, qz], -1)  # (...,4)
    idx = torch.argmax(score, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return quat_standardize(quat_normalize(q))


# ---------------------------------------------------------------------------
# so(3) log/exp on quaternions
# ---------------------------------------------------------------------------


def quat_log(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log map: unit quaternion -> rotation vector (...,3) = axis * angle,
    with the smoothed norm sqrt(‖v‖²+ε²) (finite at the identity)."""
    q = quat_standardize(quat_normalize(q))
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.sqrt((v * v).sum(-1, keepdim=True) + eps * eps)
    angle = 2.0 * torch.atan2(vn, w)
    return v * (angle / vn)


def quat_exp(rotvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exp map: rotation vector (...,3) -> unit quaternion (wxyz)."""
    angle = torch.sqrt((rotvec * rotvec).sum(-1, keepdim=True) + eps * eps)
    half = 0.5 * angle
    k = torch.sin(half) / angle
    return torch.cat([torch.cos(half), rotvec * k], -1)


def fuse_rotations(neighbor_idx: torch.Tensor, weights: torch.Tensor,
                   rotations: torch.Tensor) -> torch.Tensor:
    """q'_i = Exp(Σ_j w_ij Log(q_{n(i,j)})).

    neighbor_idx: (P, K) int; weights: (P, K); rotations: (..., N, 4).
    Returns (..., P, 4)."""
    logs = quat_log(rotations[..., neighbor_idx, :])  # (..., P, K, 3)
    fused = (weights[..., None] * logs).sum(-2)
    return quat_exp(fused)


# ---------------------------------------------------------------------------
# Dual quaternions (for DQS skinning): (..., 8) = [real wxyz, dual wxyz]
# ---------------------------------------------------------------------------


def dq_from_quat_translation(q_r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """σ = r + ε/2·t·r."""
    q_r = quat_normalize(q_r)
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], -1)
    q_d = 0.5 * quat_multiply(t_quat, q_r)
    return torch.cat([q_r, q_d], -1)


def dq_normalize(dq: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize so the real part is unit and real·dual = 0."""
    q_r, q_d = dq[..., :4], dq[..., 4:]
    n = torch.linalg.norm(q_r, dim=-1, keepdim=True) + eps
    q_r = q_r / n
    q_d = q_d / n
    dot = (q_r * q_d).sum(-1, keepdim=True)
    return torch.cat([q_r, q_d - dot * q_r], -1)


def dq_translation(dq: torch.Tensor) -> torch.Tensor:
    """t = 2 · q_d ⊗ conj(q_r) (vector part)."""
    t_quat = quat_multiply(2.0 * dq[..., 4:], quat_conjugate(dq[..., :4]))
    return t_quat[..., 1:]


def dq_apply(dq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a unit dual-quaternion rigid transform: p' = R p + t."""
    return quat_apply(dq[..., :4], p) + dq_translation(dq)


def dq_blend(dqs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Sign-consistent weighted blend (pivot = first neighbour), normalized.

    dqs: (..., K, 8); weights: (..., K).  Returns (..., 8)."""
    pivot = dqs[..., :1, :4]
    sign = torch.sign((dqs[..., :4] * pivot).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    blended = (weights[..., None] * (dqs * sign)).sum(-2)
    return dq_normalize(blended)
