"""The borderline reduced solves, settled over a population.

Late robust iterations of small graphs reach reduced camera systems (scaled
condition ~1e6 and worse) on which an f32 band factor and exactly two f64
refinement rounds end near the ``1e-8 ||b||`` residual limit, so that two
f32 implementations of the same factorisation can part ways on the verdict.
The port's band factor therefore accumulates its window in f64 and rounds
to f32 once.  Here every reduced system that the port's CPU path meets in
``optimize(10)`` on the 16-pose mono graph, seeds 0..15, under Cauchy and
Tukey, goes through

(a) the port's ``solve_reduced_band`` (the band twins on the CPU),
(b) the JAX package's band route with its Pallas kernels in interpret mode
    (``band_factor2`` / ``band_solve``, two refinement rounds),
(c) the JAX package's dense route (three rounds),

and no system that (b) takes may be refused by (a).

Run as a script (``python tests/test_torch_population.py``, some minutes) it
prints the same count for other ways to accumulate the factor and the solve,
each over the population of its own path: the table in ROADMAP.md section C.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import ROBUST, borderline_population, reduced_residual_ratio
from cuda_bundle_adjustment_tpu.pallas import bandchol as jband
from cuda_bundle_adjustment_tpu.solver import block_solver as jbs
from cuda_bundle_adjustment_tpu_torch.kernels import bandchol

torch.set_num_threads(1)


def _exact_step(blocks, bsc, plan):
    """The f64 dense solve of the reduced system (what DenseLM's step is)."""
    Pa = bsc.shape[0]
    A = np.zeros((Pa, 6, Pa, 6))
    r, c = plan.blk_row.numpy(), plan.blk_col.numpy()
    B = blocks.numpy().reshape(-1, 6, 6)
    A[r, :, c, :] = B
    A[c, :, r, :] = B.transpose(0, 2, 1)
    return np.linalg.solve(A.reshape(Pa * 6, Pa * 6), bsc.numpy().reshape(-1)).reshape(Pa, 6)


def _jax_routes(monkeypatch, system):
    """(ok, step) of the JAX band route in interpret mode and of its dense route."""
    for name in ("band_factor2", "band_solve"):
        fn = getattr(jband, name)
        if not isinstance(fn, functools.partial):
            monkeypatch.setattr(jband, name, functools.partial(fn, interpret=True))
    p = system["plan"]
    assert p.band.sb * 6 <= 128  # the v2 factor
    args = (jnp.asarray(system["blocks"].numpy()), jnp.asarray(p.blk_row.numpy()),
            jnp.asarray(p.blk_col.numpy()), jnp.asarray(p.diag_pos.numpy()),
            jnp.asarray(system["bsc"].numpy()), system["bsc"].shape[0], True)
    xb, okb = jbs._solve_reduced_blocks(*args, band=jbs.BandMeta(*p.band))
    xd, okd = jbs._solve_reduced_blocks(*args)
    return (bool(okb), np.asarray(xb)), (bool(okd), np.asarray(xd))


@pytest.mark.parametrize("seeds", [range(0, 4), range(4, 8), range(8, 12), range(12, 16)],
                         ids=["seeds0-3", "seeds4-7", "seeds8-11", "seeds12-15"])
@pytest.mark.parametrize("rname", ["cauchy", "tukey"])
def test_port_refuses_no_system_the_jax_band_route_takes(monkeypatch, rname, seeds):
    """Zero systems that the JAX band kernels take and the port refuses.  A
    system that the port takes and the JAX band route refuses is counted and
    printed; its step must be no further from the exact f64 solve of the
    system than 1e-6 of the step's largest entry, or than twice the error of
    the JAX band route's own (refused) step (1e-3 where the JAX f32 factor
    met a non-positive pivot and gave no step at all)."""
    systems = borderline_population(ROBUST[rname], seeds)
    assert len(systems) >= 9 * len(seeds)
    refused, extra, rows = [], [], []
    for s in systems:
        (okb, xb), (okd, xd) = _jax_routes(monkeypatch, s)
        tag = (rname, s["seed"], s["index"])
        if okb and not s["ok"]:
            refused.append(tag)
        rows.append((s["ok"], okb, okd))
        if s["ok"] and not okb:
            xe = _exact_step(s["blocks"], s["bsc"], s["plan"])
            scale = np.abs(xe).max()
            err = np.abs(s["xp"].numpy() - xe).max() / scale
            err_b = np.abs(xb - xe).max() / scale
            ratio = reduced_residual_ratio(s["blocks"], s["bsc"], s["plan"], s["xp"])
            extra.append((tag, f"residual/limit {ratio:.3f}", f"step error {err:.2e}",
                          f"JAX band step error {err_b:.2e}", f"JAX dense takes it: {okd}"))
            assert err <= (max(1e-6, 2 * err_b) if np.isfinite(err_b) else 1e-3), extra[-1]
    n = len(rows)
    print(f"{rname} seeds {list(seeds)}: {n} systems; taken by the port "
          f"{sum(r[0] for r in rows)}, the JAX band route {sum(r[1] for r in rows)}, "
          f"the JAX dense route {sum(r[2] for r in rows)}; refused by the port and taken "
          f"by the JAX band route: {refused}; the other way round: {extra}")
    assert refused == []


def test_f32_window_would_refuse_systems_the_jax_band_route_takes(monkeypatch):
    """Why the window is f64: the same factor accumulated in f32 refuses
    systems of this population that the JAX band kernels take (Cauchy,
    seeds 7, 9 and 11, where the f64 window refuses none)."""
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs

    systems = borderline_population(ROBUST["cauchy"], [7, 9, 11])
    monkeypatch.setattr(bandchol, "F64_WINDOW_MAX_SB", 0)
    assert bandchol.accumulation_dtype(16) == torch.float32
    lost = 0
    for s in systems:
        _, ok32 = tbs.solve_reduced_band(s["blocks"], s["bsc"], s["plan"])
        (okb, _), _ = _jax_routes(monkeypatch, s)
        assert not (okb and not s["ok"])
        lost += okb and not bool(ok32)
    assert lost >= 1


# -- other accumulations, for the table only ---------------------------------------


def _factor_variant(band, Pa, SB, acc, rounded_inverse):
    """``band_factor_plain`` with the window in ``acc`` and ``Lt`` formed from
    the exact or the f32-rounded ``inv(L_cc)``."""
    win = band.to(acc).clone()
    out = torch.zeros_like(band)
    d1, d2 = torch.meshgrid(torch.arange(1, SB), torch.arange(1, SB), indexing="ij")
    keep = d2 <= d1
    d1, d2 = d1[keep], d2[keep]
    rel = d2 * SB + (d1 - d2)
    for c in range(Pa):
        base = c * SB
        S = win[base : base + SB].view(SB, 6, 6)
        invL = bandchol._chol6_inv_plain(S[0])
        out[base] = invL.reshape(36).to(torch.float32)
        if rounded_inverse:
            invL = invL.to(torch.float32).to(acc)
        Lt32 = torch.matmul(invL, S[1:]).to(torch.float32)
        out[base + 1 : base + SB] = Lt32.reshape(SB - 1, 36)
        Lt = Lt32.to(acc)
        upd = torch.matmul(Lt[d2 - 1].transpose(-1, -2), Lt[d1 - 1]).reshape(-1, 36)
        win[base + rel] = win[base + rel] - upd
    return out


def _solve_variant(L, b, Pa, SB, bw, acc):
    """Forward substitution in place (``b_{c+d} -= Lt_d^T y_c`` as it comes),
    sums in ``acc``, the result rounded to f32."""
    L3 = L.view(-1, SB, 6, 6).to(acc)
    x = b.to(acc).clone()
    for c in range(Pa):
        y = L3[c, 0] @ x[c]
        x[c] = y
        n = min(bw, Pa - 1 - c)
        if n:
            x[c + 1 : c + 1 + n] -= (L3[c, 1 : 1 + n] * y[None, :, None]).sum(1)
    for c in range(Pa - 1, -1, -1):
        n = min(bw, Pa - 1 - c)
        z = x[c]
        if n:
            z = z - (L3[c, 1 : 1 + n] * x[c + 1 : c + 1 + n, None, :]).sum((0, 2))
        x[c] = L3[c, 0].T @ z
    return x.to(torch.float32)


def _variant_table():
    from cuda_bundle_adjustment_tpu_torch.solver import block_solver as tbs

    f32, f64 = torch.float32, torch.float64
    P = functools.partial
    variants = {
        "f32 window, exact inverse, in place": (
            P(_factor_variant, acc=f32, rounded_inverse=False), P(_solve_variant, acc=f32)),
        "f64 window, exact inverse, in place": (
            P(_factor_variant, acc=f64, rounded_inverse=False), P(_solve_variant, acc=f32)),
        "f64 window, exact inverse, pending sums": (
            P(_factor_variant, acc=f64, rounded_inverse=False), bandchol.band_solve_plain),
        "f64 window, rounded inverse, in place": (
            P(_factor_variant, acc=f64, rounded_inverse=True), P(_solve_variant, acc=f32)),
        "f64 window, rounded inverse, pending sums (the port)": (
            bandchol.band_factor_plain, bandchol.band_solve_plain),
        "f64 window, rounded inverse, in place, f64 sums in the solve": (
            P(_factor_variant, acc=f64, rounded_inverse=True), P(_solve_variant, acc=f64)),
    }
    for name in ("band_factor2", "band_solve"):
        setattr(jband, name, functools.partial(getattr(jband, name), interpret=True))

    class NoPatch:  # _jax_routes' monkeypatch: the kernels are in interpret mode already
        def setattr(self, *a):
            raise AssertionError(a)

    for label, (factor, solve) in variants.items():
        tbs.band_factor, tbs.band_solve = factor, solve
        n = taken = jtaken = 0
        refused, extra = [], 0
        for rname in ("cauchy", "tukey"):
            for s in borderline_population(ROBUST[rname], range(16)):
                (okb, _), _ = _jax_routes(NoPatch(), s)
                n += 1
                taken += s["ok"]
                jtaken += okb
                extra += s["ok"] and not okb
                if okb and not s["ok"]:
                    refused.append((rname, s["seed"], s["index"]))
        print(f"{label}: {n} systems, the variant takes {taken}, the JAX band route {jtaken}; "
              f"JAX band takes and the variant refuses {len(refused)} {refused}; "
              f"the variant takes and JAX band refuses {extra}", flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")  # what tests/conftest.py sets for the suite
    jax.config.update("jax_enable_x64", True)
    _variant_table()
