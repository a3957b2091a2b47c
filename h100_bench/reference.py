"""Plain PyTorch reference of one benchmark solve: Levenberg-Marquardt on a
BA graph of monocular and stereo edges, no robust kernel.

It follows the port's numpy oracle ``utils/dense_reference.py DenseLM`` at
commit 99f61eb (residuals, g2o-convention Jacobians, damping, the SE3-exp
update, the gain-ratio control flow, ``maxq = 10``, ``tau = 1e-5``; a
stereo edge's third row ``u - bf / z``), written
with whole-array torch operations so that it runs at KITTI-00 size on the
card.  Where DenseLM solves the whole damped system with one dense solve,
this eliminates the landmarks first (the Schur complement, dense, over the
active poses) and back-substitutes; the two are the same linear algebra.

It imports nothing of the port and takes nothing the port made: it packs the
problem's arrays itself, works out the structure (which edges share a
landmark) from the index arrays, and runs every LM step.  ``dtype`` is the
precision of every value it holds: float64 is the reference, float32 the
control that a correct run must be told apart from.  TF32 is switched off so
that a float32 product is float32.
"""

from __future__ import annotations

import numpy as np
import torch

MAXQ = 10
TAU = 1e-5
RHO_DONE = 1e-6


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    qv, w = q[..., :3], q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + w * uv + _cross(qv, uv)


def quat_to_rotmat(q):
    x, y, z, w = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    w0, w1, w2 = w.unbind(-1)
    return torch.stack(
        [torch.stack([z, -w2, w1], -1), torch.stack([w2, z, -w0], -1), torch.stack([-w1, w0, z], -1)],
        dim=-2,
    )


def se3_exp(xi):
    """``xi [N, 6]`` (rotation first) -> ``(R [N, 3, 3], t [N, 3])``, with
    DenseLM's Taylor branch below ``theta = 1e-5``."""
    omega, upsilon = xi[:, :3], xi[:, 3:]
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = theta < 1e-5
    th = torch.where(small, torch.ones_like(theta), theta)
    a1 = torch.where(small, torch.ones_like(theta), torch.sin(th) / th)
    a2 = torch.where(small, torch.full_like(theta, 0.5), (1 - torch.cos(th)) / th**2)
    a3 = torch.where(small, torch.full_like(theta, 1.0 / 6.0), (th - torch.sin(th)) / th**3)
    Ox = _skew(omega)
    O2 = Ox @ Ox
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a1[:, None, None] * Ox + a2[:, None, None] * O2
    V = eye + a2[:, None, None] * Ox + a3[:, None, None] * O2
    return R, (V @ upsilon[:, :, None])[:, :, 0]


def rotmat_to_quat(R):
    """DenseLM's branch structure, every candidate computed and the one its
    branches pick selected."""
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    s = torch.sqrt(torch.clamp(tr + 1.0, min=1e-30))
    h = 0.5 / s
    cands = [torch.stack([(R[:, 2, 1] - R[:, 1, 2]) * h, (R[:, 0, 2] - R[:, 2, 0]) * h,
                          (R[:, 1, 0] - R[:, 0, 1]) * h, 0.5 * s], dim=-1)]
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        s = torch.sqrt(torch.clamp(R[:, i, i] - R[:, j, j] - R[:, k, k] + 1.0, min=1e-30))
        h = 0.5 / s
        q = [None] * 4
        q[i] = 0.5 * s
        q[3] = (R[:, k, j] - R[:, j, k]) * h
        q[j] = (R[:, j, i] + R[:, i, j]) * h
        q[k] = (R[:, k, i] + R[:, i, k]) * h
        cands.append(torch.stack(q, dim=-1))
    i = torch.zeros_like(tr, dtype=torch.long)
    i = torch.where(R[:, 1, 1] > R[:, 0, 0], 1, i)
    i = torch.where(R[:, 2, 2] > R[torch.arange(R.shape[0], device=R.device), i, i], 2, i)
    pick = torch.where(tr > 0, 0, i + 1)
    return torch.stack(cands, dim=1)[torch.arange(R.shape[0], device=R.device), pick]


def edge_sets(problem) -> list:
    """The problem's edge sets, ``[{kind, meas, pose_idx, lm_idx, omega}]``:
    a ``MixedBAProblem``'s specs, or a ``BAProblem``'s one set."""
    if hasattr(problem, "specs"):
        sets = list(problem.specs)
    else:
        sets = [dict(kind=problem.kind, meas=problem.meas, pose_idx=problem.pose_idx,
                     lm_idx=problem.lm_idx, omega=problem.omega)]
    for s in sets:
        if s["kind"] not in ("mono", "stereo"):
            raise ValueError(f"the reference runs mono and stereo edges, not {s['kind']!r}")
        if "cam" in s and not np.array_equal(np.asarray(s["cam"]), np.asarray(problem.cam)):
            raise ValueError("the reference runs one camera for every edge set")
    return sets


class ReferenceLM:
    """LM on a ``BAProblem`` or a ``MixedBAProblem`` of mono and stereo edge
    sets over one camera (active-first arrays) in ``dtype`` on ``device``.
    :meth:`optimize` returns the chi2 trace; the final state is in ``q``,
    ``t``, ``Xw`` in the problem's order.  Every edge carries three rows:
    a mono edge's third row, its measurement and its Jacobian are zero."""

    def __init__(self, problem, dtype=torch.float64, device="cpu"):
        sets = edge_sets(problem)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        def dev(a, dt=dtype):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        self.q, self.t, self.Xw = dev(problem.pose_q), dev(problem.pose_t), dev(problem.landmarks)
        self.Pa, self.La = int(problem.num_active_poses), int(problem.num_active_landmarks)
        meas = []
        for s in sets:
            m = np.asarray(s["meas"], dtype=np.float64)
            meas.append(np.pad(m, ((0, 0), (0, 3 - m.shape[1]))))
        cat = np.concatenate
        self.meas = dev(cat(meas))
        self.omega = dev(cat([np.asarray(s["omega"], dtype=np.float64) for s in sets]))
        self.stereo = dev(cat([np.full(len(s["omega"]), float(s["kind"] == "stereo")) for s in sets]))
        self.pi = dev(cat([np.asarray(s["pose_idx"]) for s in sets]), torch.long)
        self.li = dev(cat([np.asarray(s["lm_idx"]) for s in sets]), torch.long)
        self.cam = [float(c) for c in problem.cam]
        self.dtype, self.device = dtype, device
        # the structure: edges with a free pose and a free landmark, sorted
        # by landmark, and the number of edges each landmark has
        act = (self.pi < self.Pa) & (self.li < self.La)
        e = torch.nonzero(act)[:, 0]
        e = e[torch.argsort(self.li[e], stable=True)]
        self.pair_edges = e
        self.max_deg = int(torch.bincount(self.li[e]).max()) if e.numel() else 0

    # -- residuals and the linear system -------------------------------------------

    def _project(self, q, t, Xw):
        Xc = quat_rotate(q[self.pi], Xw[self.li]) + t[self.pi]
        fx, fy, cx, cy, bf = self.cam
        iz = 1.0 / Xc[:, 2]
        u = fx * Xc[:, 0] * iz + cx
        proj = torch.stack([u, fy * Xc[:, 1] * iz + cy, self.stereo * (u - bf * iz)], dim=-1)
        return proj - self.meas, Xc

    def chi(self, q=None, t=None, Xw=None):
        r, _ = self._project(self.q if q is None else q, self.t if t is None else t,
                             self.Xw if Xw is None else Xw)
        return torch.sum(self.omega * torch.sum(r * r, dim=-1))

    def linearise(self):
        """Hpp ``[Pa, 6, 6]``, bp, Hll ``[La, 3, 3]``, bl and the per-edge
        Hpl ``[E, 6, 3]`` (zero where the pose or the landmark is fixed)."""
        r, Xc = self._project(self.q, self.t, self.Xw)
        fx, fy, bf = self.cam[0], self.cam[1], self.cam[4]
        X, Y, Z = Xc.unbind(-1)
        iz = 1.0 / Z
        x, y = X * iz, Y * iz
        R = quat_to_rotmat(self.q[self.pi])
        ju = -fx * iz[:, None] * (R[:, 0] - x[:, None] * R[:, 2])
        st = self.stereo[:, None]
        JL = torch.stack([ju, -fy * iz[:, None] * (R[:, 1] - y[:, None] * R[:, 2]),
                          st * (ju - bf * (iz * iz)[:, None] * R[:, 2])], dim=1)
        zero = torch.zeros_like(x)
        pu = torch.stack([fx * x * y, -fx * (1 + x * x), fx * y, -fx * iz, zero, fx * iz * x], -1)
        bz = bf * iz * iz
        JP = torch.stack([
            pu,
            torch.stack([fy * (1 + y * y), -fy * x * y, -fy * x, zero, -fy * iz, fy * iz * y], -1),
            st * (pu + torch.stack([-bz * Y, bz * X, zero, zero, zero, -bz], -1)),
        ], dim=1)
        w = self.omega[:, None, None]
        JPt, JLt = JP.transpose(1, 2), JL.transpose(1, 2)
        pa = self.pi < self.Pa
        la = self.li < self.La
        Hpp = torch.zeros((self.Pa, 6, 6), dtype=self.dtype, device=self.device)
        bp = torch.zeros((self.Pa, 6), dtype=self.dtype, device=self.device)
        Hll = torch.zeros((self.La, 3, 3), dtype=self.dtype, device=self.device)
        bl = torch.zeros((self.La, 3), dtype=self.dtype, device=self.device)
        Hpp.index_add_(0, self.pi[pa], (w * JPt @ JP)[pa])
        bp.index_add_(0, self.pi[pa], (w * JPt @ r[:, :, None])[pa, :, 0])
        Hll.index_add_(0, self.li[la], (w * JLt @ JL)[la])
        bl.index_add_(0, self.li[la], (w * JLt @ r[:, :, None])[la, :, 0])
        Hpl = (w * JPt @ JL) * (pa & la).to(self.dtype)[:, None, None]
        return Hpp, bp, Hll, bl, Hpl

    def max_diagonal(self, Hpp, Hll):
        return max(float(torch.diagonal(Hpp, dim1=1, dim2=2).max()) if self.Pa else 0.0,
                   float(torch.diagonal(Hll, dim1=1, dim2=2).max()) if self.La else 0.0)

    def solve(self, system, lam):
        """The damped step ``(xp [Pa, 6], xl [La, 3], success)``: landmarks
        eliminated, the dense Schur complement factored by Cholesky."""
        Hpp, bp, Hll, bl, Hpl = system
        Pa, La = self.Pa, self.La
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        eye6 = torch.eye(6, dtype=self.dtype, device=self.device)
        Hll_inv = torch.linalg.inv(Hll + lam * eye3)
        e = self.pair_edges
        pe, le = self.pi[e], self.li[e]
        W = Hpl[e]  # [n, 6, 3]
        V = W @ Hll_inv[le]  # Hpl inv(Hll + lam I)
        bsc = bp.clone()
        bsc.index_add_(0, pe, -(V @ bl[le][:, :, None])[:, :, 0])
        blocks = torch.zeros((Pa * Pa, 6, 6), dtype=self.dtype, device=self.device)
        diag = torch.arange(Pa, device=self.device) * (Pa + 1)
        blocks.index_add_(0, diag, Hpp + lam * eye6)
        for d in range(self.max_deg):
            a = torch.arange(e.numel() - d, device=self.device)
            a = a[le[a] == le[a + d]]
            C = V[a] @ W[a + d].transpose(1, 2)
            blocks.index_add_(0, pe[a] * Pa + pe[a + d], -C)
            if d:
                blocks.index_add_(0, pe[a + d] * Pa + pe[a], -C.transpose(1, 2))
        Hsc = blocks.reshape(Pa, Pa, 6, 6).permute(0, 2, 1, 3).reshape(6 * Pa, 6 * Pa)
        del blocks
        L, info = torch.linalg.cholesky_ex(Hsc)
        del Hsc
        xp = torch.cholesky_solve(bsc.reshape(-1, 1), L).reshape(Pa, 6)
        del L
        rhs = bl.clone()
        rhs.index_add_(0, le, -(W.transpose(1, 2) @ xp[pe][:, :, None])[:, :, 0])
        xl = (Hll_inv @ rhs[:, :, None])[:, :, 0]
        ok = int(info) == 0 and bool(torch.isfinite(xp).all()) and bool(torch.isfinite(xl).all())
        return xp, xl, ok

    def updated(self, xp, xl):
        R, dt = se3_exp(xp)
        dq = rotmat_to_quat(R)
        Pa, La = self.Pa, self.La
        t = self.t.clone()
        q = self.q.clone()
        t[:Pa] = dt + quat_rotate(dq, self.t[:Pa])
        qn = quat_mul(dq, self.q[:Pa])
        n = torch.linalg.vector_norm(qn, dim=-1, keepdim=True)
        q[:Pa] = qn / torch.where(qn[:, 3:4] < 0, -n, n)
        Xw = self.Xw.clone()
        Xw[:La] = Xw[:La] + xl
        return q, t, Xw

    # -- the LM loop ---------------------------------------------------------------

    def optimize(self, niterations: int) -> list[float]:
        trace = []
        nu, lam = 2.0, 0.0
        F = float(self.chi())
        for it in range(niterations):
            system = self.linearise()
            if it == 0:
                lam = TAU * self.max_diagonal(system[0], system[2])
            q_cnt, rho = 0, -1.0
            while q_cnt < MAXQ and rho < 0:
                xp, xl, ok = self.solve(system, lam)
                if ok:
                    cand = self.updated(xp, xl)
                    Fhat = float(self.chi(*cand))
                    scale = float(torch.sum(xp * (lam * xp + system[1]))
                                  + torch.sum(xl * (lam * xl + system[3]))) + 1e-3
                else:
                    cand, Fhat, scale = None, F, 1e-3
                Fdiff = Fhat - F
                rho = (F - Fhat) / scale if ok else -1.0
                if rho > 0:
                    att = 1 - (2 * rho - 1) ** 3
                    lam *= min(max(att, 1 / 3), 2 / 3)
                    nu = 2.0
                    F = Fhat
                    self.q, self.t, self.Xw = cand
                    break
                lam *= nu
                nu *= 2
                if lam != lam or lam in (float("inf"), float("-inf")) or Fdiff < 1e-4:
                    break
                q_cnt += 1
            trace.append(F)
            if q_cnt == MAXQ or rho < RHO_DONE or lam != lam or lam in (float("inf"), float("-inf")):
                break
        return trace

    def state(self):
        """``(q, t, Xw)`` as float64 numpy arrays in the problem's order."""
        return tuple(a.double().cpu().numpy() for a in (self.q, self.t, self.Xw))
