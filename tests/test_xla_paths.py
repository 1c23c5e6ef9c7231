"""The XLA forms that every device runs: triangular solves, the precision
of their contractions, and the platform-free ``auto`` decisions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cpkrylov_tpu.precond.cp import _build_tri, _build_tri_upper
from cpkrylov_tpu.precond.trisolve import (ReducedScanTriFactor,
                                           build_block_tri, build_scan_tri,
                                           tri_solve)
from cpkrylov_tpu.utils.fixtures import random_sqd_system

# f32: a unit-scaled, diagonally dominant banded solve loses a few ulps per
# row of reach, so 1e-5 relative is ~100 eps_f32; f64 keeps 1e-12.
TRI_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _banded_triangular(n, reach, lower, seed):
    rng = np.random.default_rng(seed)
    diags = [4.0 + rng.random(n)]
    offs = [0]
    for k in range(1, reach + 1):
        diags.append(0.5 * rng.standard_normal(n - k) / k)
        offs.append(-k if lower else k)
    return sp.diags(diags, offs, shape=(n, n), format="csr")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("reach", [1, 3, 5])
def test_xla_trisolve_matches_scipy(reach, lower, dtype):
    """The factor builders' XLA forms (reduced-state scan at this size)
    solve T x = b like scipy's exact triangular solve."""
    n = 4096
    T = _banded_triangular(n, reach, lower, seed=reach)
    b = np.random.default_rng(7).standard_normal(n)
    want = spla.spsolve_triangular(T, b, lower=lower)
    if lower:
        tf = _build_tri(T, panel=256, dtype=dtype)
        x = tri_solve(tf, jnp.asarray(b, dtype))
    else:
        # Upper factors are stored reversed: U x = b is
        # flip(solve_lower(J U J, flip(b))), as FactorApply.solve does.
        tf = _build_tri_upper(T, panel=256, dtype=dtype)
        x = jnp.flip(tri_solve(tf, jnp.flip(jnp.asarray(b, dtype))))
    assert isinstance(tf, ReducedScanTriFactor)
    x = np.asarray(x, np.float64)
    err = np.linalg.norm(x - want) / np.linalg.norm(want)
    assert err < TRI_TOL[dtype], err


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr and its sub-jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (tuple, list)) else (val,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


def _f32_forms():
    from cpkrylov_tpu.ops import spmv
    from cpkrylov_tpu.ops.formats import bsr_from_scipy, ell_from_scipy

    n = 1024
    T = _banded_triangular(n, 3, True, seed=1)
    A = sp.random(n, n, density=0.01, random_state=2, format="csr") \
        + sp.identity(n, format="csr")
    x = jnp.ones(n, jnp.float32)
    X = jnp.ones((n, 3), jnp.float32)
    bsr = bsr_from_scipy(A, blocksize=8, dtype=np.float32)
    ell = ell_from_scipy(A, dtype=np.float32)
    dense = jnp.asarray(A.toarray(), jnp.float32)
    return {
        "block_tri": (tri_solve, build_block_tri(T, 64, np.float32), x),
        "scan_tri": (tri_solve, build_scan_tri(T, 64, np.float32), x),
        "reduced_scan_tri": (tri_solve, _build_tri(T, 256, np.float32), x),
        "bsr_matvec": (spmv.matvec, bsr, x),
        "bsr_matmat": (spmv.matmat, bsr, X),
        "ell_matmat": (spmv.matmat, ell, X),
        "dense_matvec": (spmv.matvec, dense, x),
    }


@pytest.mark.parametrize("form", ["block_tri", "scan_tri",
                                  "reduced_scan_tri", "bsr_matvec",
                                  "bsr_matmat", "ell_matmat",
                                  "dense_matvec"])
def test_f32_contractions_ask_for_highest_precision(form):
    """Without HIGHEST a float32 dot may run in TF32 on a GPU."""
    fn, mat, v = _f32_forms()[form]
    precs = _dot_precisions(jax.make_jaxpr(fn)(mat, v).jaxpr)
    assert precs, f"{form} has no dot_general to check"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == hi for q in p) for p in precs), \
        precs


def test_auto_spmv_format_keeps_csr():
    from cpkrylov_tpu.ops.formats import CSR
    from cpkrylov_tpu.precond.cp import _select_spmv_format, \
        make_preconditioner

    assert _select_spmv_format("auto") is False
    assert _select_spmv_format("csr") is False
    assert _select_spmv_format("dia") and _select_spmv_format("pgell")
    with pytest.raises(ValueError):
        _select_spmv_format("ell")
    s = random_sqd_system(300, 100, seed=3)
    M = make_preconditioner(s.G, s.B, s.C, dtype=np.float32)
    assert isinstance(M.kp, CSR)


def test_auto_ordering_is_rcm():
    from cpkrylov_tpu.precond.cp import make_preconditioner

    s = random_sqd_system(300, 100, seed=4)
    z = jnp.arange(400, dtype=jnp.float64)
    Ma = make_preconditioner(s.G, s.B, s.C, ordering="auto")
    Mr = make_preconditioner(s.G, s.B, s.C, ordering="rcm")
    np.testing.assert_array_equal(np.asarray(Ma.factor.pin.apply(z)),
                                  np.asarray(Mr.factor.pin.apply(z)))
    assert Ma.factor_kind == "HostLDL"


def test_f32_solve_does_not_refine_by_default(monkeypatch):
    from cpkrylov_tpu import SolverOptions, mixed, solve

    def refuse(*a, **k):
        raise AssertionError("solve() routed through solve_mixed")

    monkeypatch.setattr(mixed, "solve_mixed", refuse)
    s = random_sqd_system(200, 80, seed=5)
    out = solve("cpminres", s.b, s.A, s.B, s.C, s.G, dtype=np.float32,
                opts=SolverOptions(itmax=50))
    assert out.result is not None and np.all(np.isfinite(np.asarray(out.x)))


def test_solve_mixed_defaults_to_host_loop():
    from cpkrylov_tpu import SolverOptions, solve_mixed

    s = random_sqd_system(200, 80, seed=6)
    out = solve_mixed("cpminres", s.b, s.A, s.B, s.C, s.G,
                      opts=SolverOptions(atol=0.0, rtol=1e-8, itmax=200))
    assert out.solved
    # The host loop keeps one SolveOutput per outer pass; the
    # device-resident loop keeps none.
    assert len(out.inner_outputs) == out.nouter >= 1
