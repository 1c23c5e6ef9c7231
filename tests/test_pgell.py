"""PGELL format + Pallas SpMV kernel tests (interpret mode on CPU)."""
import numpy as np
import pytest
import scipy.sparse as sp

from cpkrylov_tpu.ops.pgell import pack_pgell, pgell_matvec_reference


def _banded_random(rows, cols, k, band, seed=0):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), k)
    c = (r + rng.integers(-band, band + 1, size=r.shape)).clip(0, cols - 1)
    v = rng.standard_normal(r.shape)
    return sp.csr_matrix((v, (r, c)), shape=(rows, cols))


@pytest.mark.parametrize("rows,cols,k,band,tr", [
    (256, 256, 4, 16, 128),
    (700, 700, 6, 64, 256),
    (512, 300, 3, 32, 128),   # rectangular
    (1000, 1000, 8, 200, 512),
])
def test_pgell_reference_matches_scipy(rows, cols, k, band, tr):
    A = _banded_random(rows, cols, k, band)
    x = np.random.default_rng(1).standard_normal(cols)
    mat = pack_pgell(A, tile_rows=tr, dtype=np.float64)
    y = np.asarray(pgell_matvec_reference(mat, x))
    np.testing.assert_allclose(y, A @ x, rtol=1e-10, atol=1e-10)


def test_pgell_duplicate_rows_per_page():
    # rows with several entries in the same page exercise slot depth > 1
    rng = np.random.default_rng(3)
    A = _banded_random(256, 256, 12, 20, seed=3)
    x = rng.standard_normal(256)
    mat = pack_pgell(A, tile_rows=128, dtype=np.float64)
    y = np.asarray(pgell_matvec_reference(mat, x))
    np.testing.assert_allclose(y, A @ x, rtol=1e-10, atol=1e-10)


def test_pgell_fixture_matrix(cvxqp1):
    # real KKT block (RCM-reordered for locality)
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    K = cvxqp1.K.tocsr()
    perm = reverse_cuthill_mckee(K, symmetric_mode=True)
    Kp = K[perm][:, perm].tocsr()
    x = np.random.default_rng(5).standard_normal(Kp.shape[1])
    mat = pack_pgell(Kp, tile_rows=512, dtype=np.float64)
    y = np.asarray(pgell_matvec_reference(mat, x))
    np.testing.assert_allclose(y, Kp @ x, rtol=1e-9, atol=1e-9)
    assert mat.nnz_density > 0.02  # padding within reason for banded KKT


# ---------------------------------------------------------------------------
# Solve-path integration (VERDICT r1 item 1): the production solve must be
# able to run its hot-loop SpMVs through the PGELL layout.
# ---------------------------------------------------------------------------

def test_sym_permuted_matvec_matches_scipy():
    from cpkrylov_tpu.ops.pgell import pack_sym_pgell
    from cpkrylov_tpu.ops.spmv import matvec

    A = _banded_random(500, 500, 5, 40, seed=11)
    A = A + A.T  # symmetric, general pattern
    mat = pack_sym_pgell(A, tile_rows=256, dtype=np.float64,
                         max_bytes_ratio=0)  # no gate
    assert mat is not None
    x = np.random.default_rng(7).standard_normal(500)
    y = np.asarray(matvec(mat, x))
    np.testing.assert_allclose(y, A @ x, rtol=1e-10, atol=1e-10)


def test_pgell_gate_rejects_random_pattern():
    from cpkrylov_tpu.ops.pgell import pack_sym_pgell

    # uniformly random pattern has no band structure even after RCM
    rng = np.random.default_rng(0)
    n, nnz = 4096, 4096 * 4
    A = sp.csr_matrix(
        (rng.standard_normal(nnz),
         (rng.integers(0, n, nnz), rng.integers(0, n, nnz))), shape=(n, n))
    assert pack_sym_pgell(A, tile_rows=1024, dtype=np.float32,
                          max_bytes_ratio=3.0) is None


def test_matrix_operator_mat_t_rmatvec():
    from cpkrylov_tpu.operators.linop import MatrixOperator
    from cpkrylov_tpu.ops.formats import csr_from_scipy

    B = _banded_random(200, 300, 4, 30, seed=2)
    op = MatrixOperator(csr_from_scipy(B), mat_t=csr_from_scipy(B.T.tocsr()))
    y = np.random.default_rng(1).standard_normal(200)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), B.T @ y,
                               rtol=1e-12, atol=1e-12)


def test_solve_pgell_format_matches_csr(cvxqp1):
    """Forced-PGELL solve (jnp reference path on CPU) converges like CSR."""
    from cpkrylov_tpu import SolverOptions, solve
    from cpkrylov_tpu.ops.pgell import SymPermuted

    opts = SolverOptions(atol=1e-6, rtol=1e-6, itmax=200)
    base = solve("cpminres", cvxqp1.b, cvxqp1.A, cvxqp1.B, cvxqp1.C,
                 cvxqp1.G, opts=opts, spmv_format="csr")
    out = solve("cpminres", cvxqp1.b, cvxqp1.A, cvxqp1.B, cvxqp1.C,
                cvxqp1.G, opts=opts, spmv_format="pgell")
    assert out.solved
    assert abs(out.niters - base.niters) <= 2
    ref = np.asarray(base.x)
    np.testing.assert_allclose(np.asarray(out.x), ref,
                               rtol=0, atol=1e-5 * np.linalg.norm(ref))
