"""Batched quaternion / SE(3) operations (counterpart of ``ops/lie.py``).

Quaternions use the ``[x, y, z, w]`` layout and SE(3) elements are
``(quat [.., 4], trans [.., 3])`` pairs for the world->camera transform
``Xc = R(q) @ Xw + t``.  Same formulas and branch structure as the JAX
package (Rodrigues with a ``theta < 1e-5`` Taylor branch, branchless
Shepperd selection, sign-normalised quaternions), so small-angle steps
produce the same floats.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two quaternion arrays ``[..., 4]`` (xyzw)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v [..., 3]`` by quaternions ``q [..., 4]``
    (two-cross-product form ``v + w*(2 qv x v) + qv x (2 qv x v)``)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(qv, v)
    uv = uv + uv
    return v + w * uv + _cross(qv, uv)


def quat_normalize_signed(q: torch.Tensor) -> torch.Tensor:
    """Normalise quaternions, flipping sign so the scalar part is >= 0."""
    invn = 1.0 / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    invn = torch.where(q[..., 3:4] < 0, -invn, invn)
    return q * invn


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (xyzw).

    Branchless Shepperd selection: all four candidates are evaluated and the
    one the reference's branch structure would pick is selected."""

    def r(i, j):
        return R[..., i, j]

    trace = r(0, 0) + r(1, 1) + r(2, 2)

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-300))

    t0 = _safe_sqrt(trace + 1.0)
    w0 = 0.5 * t0
    s0 = 0.5 / t0
    q_tr = torch.stack(
        [(r(2, 1) - r(1, 2)) * s0, (r(0, 2) - r(2, 0)) * s0, (r(1, 0) - r(0, 1)) * s0, w0],
        dim=-1,
    )

    def _branch(i):
        j = (i + 1) % 3
        k = (j + 1) % 3
        t = _safe_sqrt(r(i, i) - r(j, j) - r(k, k) + 1.0)
        qi = 0.5 * t
        s = 0.5 / t
        qw = (r(k, j) - r(j, k)) * s
        qj = (r(j, i) + r(i, j)) * s
        qk = (r(k, i) + r(i, k)) * s
        out = [None, None, None, qw]
        out[i], out[j], out[k] = qi, qj, qk
        return torch.stack(out, dim=-1)

    q0, q1, q2 = _branch(0), _branch(1), _branch(2)
    # reference tie-breaking: i=1 if R11 > R00; i=2 if R22 > R(i,i)
    i_is_1 = r(1, 1) > r(0, 0)
    q_major = torch.where(i_is_1[..., None], q1, q0)
    diag_major = torch.where(i_is_1, r(1, 1), r(0, 0))
    q_major = torch.where((r(2, 2) > diag_major)[..., None], q2, q_major)
    return torch.where((trace > 0)[..., None], q_tr, q_major)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices ``[..., 3, 3]`` from vectors ``[..., 3]``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    row0 = torch.stack([zero, -z, y], dim=-1)
    row1 = torch.stack([z, zero, -x], dim=-1)
    row2 = torch.stack([-y, x, zero], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _skew_sq(v: torch.Tensor) -> torch.Tensor:
    """``skew(v) @ skew(v)`` in closed form (reference ``skew2``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, zx = x * y, y * z, z * x
    row0 = torch.stack([-yy - zz, xy, zx], dim=-1)
    row1 = torch.stack([xy, -zz - xx, yz], dim=-1)
    row2 = torch.stack([zx, yz, -xx - yy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SE(3) exponential of twists ``xi [..., 6]`` = ``[omega(3), upsilon(3)]``.

    Returns ``(quat [..., 4], trans [..., 3])`` with the reference's
    Rodrigues coefficients and ``theta < 1e-5`` Taylor fallback."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:6]
    theta = torch.linalg.vector_norm(omega, dim=-1)

    O1 = _skew(omega)
    O2 = _skew_sq(omega)

    small = theta < 1e-5
    # guard against 0/0 in the untaken branch
    theta_safe = torch.where(small, 1.0, theta)
    sin_t = torch.sin(theta_safe)
    cos_t = torch.cos(theta_safe)
    a1 = torch.where(small, 1.0, sin_t / theta_safe)
    a2 = torch.where(small, 0.5, (1.0 - cos_t) / (theta_safe * theta_safe))
    a3 = torch.where(
        small, 1.0 / 6.0, (theta_safe - sin_t) / (theta_safe * theta_safe * theta_safe)
    )
    v1 = torch.where(small, 0.5, a2)
    v2 = torch.where(small, 1.0 / 6.0, a3)

    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a1[..., None, None] * O1 + a2[..., None, None] * O2
    V = eye + v1[..., None, None] * O1 + v2[..., None, None] * O2

    q = rotmat_to_quat(R)
    t = (V * upsilon[..., None, :]).sum(-1)
    return q, t


def se3_update_left(
    dq: torch.Tensor, dt: torch.Tensor, q: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-compose an increment onto poses: ``T <- exp(xi) o T``.

    ``t_new = dt + R(dq) t``; ``q_new = signed_normalize(dq * q)``."""
    t_new = dt + quat_rotate(dq, t)
    q_new = quat_normalize_signed(quat_mul(dq, q))
    return q_new, t_new
