"""Mixed-precision solves (f32 inner Krylov + f64 outer refinement).

The reference is f64-MATLAB-only; ``solve_mixed`` is the capability that
recovers f64-class accuracy from f32 device work (cpkrylov_tpu/mixed.py).
On CPU these tests exercise the same code path a GPU runs (explicit
dtype=np.float32 inner solves).
"""
import numpy as np
import pytest
import scipy.sparse.linalg as spla

from cpkrylov_tpu import SolverOptions, PrecondOptions, solve_mixed
from cpkrylov_tpu.operators.linop import aslinearoperator
from cpkrylov_tpu.utils import fixtures


def _relerr(sys_, x):
    xref = spla.spsolve(sys_.K.tocsc(), sys_.b)
    return np.linalg.norm(x - xref) / np.linalg.norm(xref)


@pytest.mark.parametrize("method", ["cpminres", "cpcg"])
def test_mixed_reaches_f64_accuracy(method):
    sys_ = fixtures.random_sqd_system(160, 60, seed=3)
    out = solve_mixed(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                      opts=SolverOptions(atol=1e-10, rtol=1e-10, itmax=400))
    assert out.solved
    rnorm = np.linalg.norm(sys_.b - sys_.K @ out.x)
    assert rnorm <= 1e-10 + 1e-10 * np.linalg.norm(sys_.b)
    assert _relerr(sys_, out.x) < 1e-9          # far beyond f32's ~1e-4 floor
    assert out.nouter <= 6
    # history is the true-residual norm and must be monotone decreasing
    assert np.all(np.diff(out.resid_history) < 0)


def test_mixed_nonsymmetric_gmres():
    sys_ = fixtures.random_sqd_system(120, 40, seed=5, nonsymmetric=True)
    out = solve_mixed("cpgmres", sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                      opts=SolverOptions(atol=1e-9, rtol=1e-9, itmax=400,
                                         restart=60))
    assert out.solved
    assert _relerr(sys_, out.x) < 1e-8


def test_mixed_fixture_parity(cvxqp1):
    """The headline fixture to 1e-8 — BASELINE.json configs[0] in f32."""
    out = solve_mixed(
        "cpminres", cvxqp1.b, cvxqp1.A, cvxqp1.B, cvxqp1.C, cvxqp1.G,
        opts=SolverOptions(atol=1e-8, rtol=1e-8, itmax=500),
        precond_opts=PrecondOptions(residual_update=True, nitref=1,
                                    force_itref=True))
    assert out.solved
    assert _relerr(cvxqp1, out.x) < 1e-7
    assert out.nouter <= 5


def test_mixed_rejects_operator_only_A():
    sys_ = fixtures.random_sqd_system(60, 20, seed=0)
    A_op = aslinearoperator(sys_.A, dtype=np.float32)
    with pytest.raises(TypeError, match="explicit matrix"):
        solve_mixed("cpminres", sys_.b, A_op, sys_.B, sys_.C, sys_.G)


def test_stagwin_bounds_f32_iterations(cvxqp1):
    """An unreachable f32 tolerance must exit via STATUS_STAGNATED within
    the window instead of burning itmax iterations."""
    from cpkrylov_tpu import SolverOptions, solve
    from cpkrylov_tpu.solvers.common import STATUS_STAGNATED

    b32 = (cvxqp1.b / np.linalg.norm(cvxqp1.b)).astype(np.float32)
    out = solve("cpminres", b32, cvxqp1.A, cvxqp1.B, cvxqp1.C, cvxqp1.G,
                opts=SolverOptions(atol=0.0, rtol=1e-12, itmax=500,
                                   stagwin=25), dtype=np.float32)
    assert not out.solved
    assert out.niters < 200
    assert out.istatus in (STATUS_STAGNATED, 2)  # stagnated or indefinite


def test_stagwin_off_preserves_f64_behavior():
    """stagwin=0 (default) must not change converged f64 iteration counts;
    a generous window must not fire during a healthy convergence plateau."""
    from cpkrylov_tpu import SolverOptions, solve

    sys_ = fixtures.random_sqd_system(160, 60, seed=3)
    o1 = solve("cpminres", sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
               opts=SolverOptions(itmax=400))
    o2 = solve("cpminres", sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
               opts=SolverOptions(itmax=400, stagwin=50))
    assert o1.solved and o2.solved
    assert o1.niters == o2.niters


def test_gmres_reorth_parity_and_f32_benefit(cvxqp2):
    """reorth (unimplemented in the reference, cpgmres.m:81-82) must leave
    healthy f64 runs untouched and cut iterations at the f32 floor."""
    from cpkrylov_tpu import SolverOptions, PrecondOptions, solve

    popts = PrecondOptions(residual_update=True, nitref=1, force_itref=True)
    o64 = solve("cpgmres", cvxqp2.b, cvxqp2.A, cvxqp2.B, cvxqp2.C, cvxqp2.G,
                opts=SolverOptions(itmax=500, restart=100, reorth=True),
                precond_opts=popts)
    assert o64.solved and abs(int(o64.niters) - 127) <= 2   # BASELINE.md

    def run_f32(reorth):
        return solve(
            "cpgmres", cvxqp2.b.astype(np.float32), cvxqp2.A, cvxqp2.B,
            cvxqp2.C, cvxqp2.G, dtype=np.float32,
            opts=SolverOptions(atol=0.0, rtol=3e-4, itmax=500, restart=150,
                               reorth=reorth), precond_opts=popts)

    plain, re2 = run_f32(False), run_f32(True)
    assert re2.solved
    assert int(re2.niters) < int(plain.niters)


def test_mixed_honest_when_budget_exhausted():
    sys_ = fixtures.random_sqd_system(100, 30, seed=7)
    out = solve_mixed("cpminres", sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                      opts=SolverOptions(atol=0.0, rtol=1e-14, itmax=300),
                      max_outer=1)
    assert not out.solved               # one f32 pass cannot reach 1e-14
    assert out.nouter == 1


def test_mixed_cache_tracks_inplace_updates():
    """solve_mixed's host/f64 and df64 caches must not serve stale
    operators when a caller updates matrix values IN PLACE between calls
    (review r4): the fingerprinted keys re-pack and the solve converges on
    the NEW system."""
    import scipy.sparse as sp

    from cpkrylov_tpu import SolverOptions, solve_mixed
    from cpkrylov_tpu.utils.fixtures import banded_saddle_system

    sysm = banded_saddle_system(1024, 256, bandwidth=3, with_oracle=False)
    opts = SolverOptions(atol=0.0, rtol=1e-10, itmax=300)
    out1 = solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                       opts=opts, device_resident=True)
    assert out1.solved

    # in-place value change on the SAME object (same sparsity)
    sysm.A.data *= 1.5
    sysm.G = sp.diags(sysm.A.diagonal()).tocsr()
    out2 = solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                       opts=opts, device_resident=True)
    assert out2.solved
    K2 = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    r2 = sysm.b - K2 @ out2.x
    assert np.linalg.norm(r2) <= 1e-10 * np.linalg.norm(sysm.b), (
        "stale cached operator: residual checked against the old A")
