"""Quaternion <-> rotation-matrix conversion, differentiable both ways
(counterpart of ``evennicer_slam_tpu/core/quaternion.py``).

Camera pose tensor layout: ``[qw, qx, qy, qz, tx, ty, tz]``.
"""

from __future__ import annotations

import torch


def quat_to_rotation(quad: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) ``[..., 4]`` (w, x, y, z; not necessarily unit) to
    rotation matrices ``[..., 3, 3]``. Non-normalized form:
    ``two_s = 2 / <q, q>``, so a non-unit quaternion still yields a rotation."""
    qr, qi, qj, qk = quad[..., 0], quad[..., 1], quad[..., 2], quad[..., 3]
    two_s = 2.0 / torch.sum(quad * quad, dim=-1)
    r00 = 1.0 - two_s * (qj**2 + qk**2)
    r01 = two_s * (qi * qj - qk * qr)
    r02 = two_s * (qi * qk + qj * qr)
    r10 = two_s * (qi * qj + qk * qr)
    r11 = 1.0 - two_s * (qi**2 + qk**2)
    r12 = two_s * (qj * qk - qi * qr)
    r20 = two_s * (qi * qk - qj * qr)
    r21 = two_s * (qj * qk + qi * qr)
    r22 = 1.0 - two_s * (qi**2 + qj**2)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def pose_matrix_from_tensor(inputs: torch.Tensor) -> torch.Tensor:
    """7-vector ``[quat(4), t(3)]`` (or batch ``[..., 7]``) -> ``[..., 3, 4]``
    camera-to-world matrix. Differentiable (used to optimize poses)."""
    quad, t = inputs[..., :4], inputs[..., 4:]
    R = quat_to_rotation(quad)
    return torch.cat([R, t[..., :, None]], dim=-1)


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w,x,y,z).

    Branch-free Shepperd-style conversion: all four candidate quaternions are
    computed and the best-conditioned one is selected with ``where``.
    Canonicalized to ``w >= 0``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )

    # pick the candidate with the largest pivot (classic case analysis)
    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def tensor_from_pose_matrix(RT: torch.Tensor, t_first: bool = False) -> torch.Tensor:
    """Camera matrix ``[..., 3or4, 4]`` -> 7-vector ``[quat, t]``
    (or ``[t, quat]`` if ``t_first``)."""
    R = RT[..., :3, :3]
    t = RT[..., :3, 3]
    quad = rotation_to_quat(R)
    if t_first:
        return torch.cat([t, quad], dim=-1)
    return torch.cat([quad, t], dim=-1)
