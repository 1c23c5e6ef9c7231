"""Unit tests: sparse containers and matvecs against scipy oracles."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from cpkrylov_tpu.ops import (CSR, ELL, csr_from_scipy, csr_matvec,
                              csr_rmatvec, csr_to_scipy, ell_from_scipy,
                              ell_matvec)


@pytest.mark.parametrize("shape,density", [((40, 40), 0.1), ((30, 50), 0.2),
                                           ((64, 16), 0.05), ((1, 1), 1.0)])
def test_csr_matvec_matches_scipy(shape, density, rng):
    A = sp.random(*shape, density=density, random_state=rng, format="csr")
    x = rng.standard_normal(shape[1])
    dev = csr_from_scipy(A)
    np.testing.assert_allclose(np.asarray(csr_matvec(dev, x)), A @ x,
                               rtol=1e-12, atol=1e-12)


def test_csr_rmatvec_matches_scipy(rng):
    A = sp.random(25, 60, density=0.15, random_state=rng, format="csr")
    y = rng.standard_normal(25)
    dev = csr_from_scipy(A)
    np.testing.assert_allclose(np.asarray(csr_rmatvec(dev, y)), A.T @ y,
                               rtol=1e-12, atol=1e-12)


def test_csr_padding_is_inert(rng):
    A = sp.random(10, 10, density=0.3, random_state=rng, format="csr")
    x = rng.standard_normal(10)
    padded = csr_from_scipy(A, pad_to=A.nnz + 37)
    np.testing.assert_allclose(np.asarray(csr_matvec(padded, x)), A @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lane_pad", [1, 8])
def test_ell_matvec_matches_scipy(rng, lane_pad):
    A = sp.random(37, 53, density=0.12, random_state=rng, format="csr")
    x = rng.standard_normal(53)
    dev = ell_from_scipy(A, lane_pad=lane_pad)
    np.testing.assert_allclose(np.asarray(ell_matvec(dev, x)), A @ x,
                               rtol=1e-12, atol=1e-12)


def test_empty_matrix():
    A = sp.csr_matrix((5, 5))
    x = np.ones(5)
    np.testing.assert_array_equal(np.asarray(csr_matvec(csr_from_scipy(A), x)),
                                  np.zeros(5))
    np.testing.assert_array_equal(np.asarray(ell_matvec(ell_from_scipy(A), x)),
                                  np.zeros(5))


def test_csr_roundtrip(rng):
    A = sp.random(20, 20, density=0.2, random_state=rng, format="csr")
    back = csr_to_scipy(csr_from_scipy(A))
    assert abs(A - back).max() < 1e-15


def test_pytree_flatten():
    import jax

    A = sp.random(8, 8, density=0.3, random_state=np.random.default_rng(0),
                  format="csr")
    dev = csr_from_scipy(A)
    leaves, treedef = jax.tree_util.tree_flatten(dev)
    dev2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert dev2.shape == dev.shape


def test_bsr_matvec_matches_scipy():
    import scipy.sparse as sp

    from cpkrylov_tpu.ops.formats import bsr_from_scipy
    from cpkrylov_tpu.ops.spmv import bsr_matvec

    rng_ = np.random.default_rng(11)
    A = sp.random(100, 90, density=0.08, random_state=rng_, format="csr")
    for bs in (4, 8):
        mat = bsr_from_scipy(A, blocksize=bs)
        x = rng_.standard_normal(90)
        xp = np.zeros(mat.shape[1]); xp[:90] = x
        y = np.asarray(bsr_matvec(mat, jnp.asarray(xp)))
        np.testing.assert_allclose(y[:100], A @ x, rtol=1e-12, atol=1e-12)


def test_spmm_all_formats_match_scipy():
    import scipy.sparse as sp

    from cpkrylov_tpu.ops.formats import (bsr_from_scipy, csr_from_scipy,
                                          ell_from_scipy)
    from cpkrylov_tpu.ops.spmv import matmat

    rng_ = np.random.default_rng(12)
    A = sp.random(64, 48, density=0.1, random_state=rng_, format="csr")
    X = rng_.standard_normal((48, 7))
    want = A @ X
    got_csr = np.asarray(matmat(csr_from_scipy(A), jnp.asarray(X)))
    got_ell = np.asarray(matmat(ell_from_scipy(A), jnp.asarray(X)))
    np.testing.assert_allclose(got_csr, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_ell, want, rtol=1e-12, atol=1e-12)
    bsr = bsr_from_scipy(A, blocksize=8)
    Xp = np.zeros((bsr.shape[1], 7)); Xp[:48] = X
    got_bsr = np.asarray(matmat(bsr, jnp.asarray(Xp)))
    np.testing.assert_allclose(got_bsr[:64], want, rtol=1e-12, atol=1e-12)


def test_bsr_empty_matrix():
    import scipy.sparse as sp

    from cpkrylov_tpu.ops.formats import bsr_from_scipy
    from cpkrylov_tpu.ops.spmv import bsr_matvec

    A = sp.csr_matrix((16, 16))
    mat = bsr_from_scipy(A, blocksize=8)
    y = np.asarray(bsr_matvec(mat, jnp.ones(16)))
    np.testing.assert_array_equal(y, 0.0)


# ---------------------------------------------------------------------------
# DIA — diagonal storage (ops/dia.py)
# ---------------------------------------------------------------------------

def test_dia_matvec_rmatvec_matmat_match_scipy(rng):
    from cpkrylov_tpu.ops.dia import (dia_matmat, dia_matvec, dia_rmatvec,
                                      pack_dia)

    n = 300
    M = sp.random(n, n, density=0.03, random_state=rng, format="csr")
    M = M + sp.diags(rng.standard_normal(n))
    d = pack_dia(M, dtype=np.float64, max_bytes_ratio=0)
    x = rng.standard_normal(n)
    X = rng.standard_normal((n, 6))
    np.testing.assert_allclose(np.asarray(dia_matvec(d, jnp.asarray(x))),
                               M @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dia_rmatvec(d, jnp.asarray(x))),
                               M.T @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dia_matmat(d, jnp.asarray(X))),
                               M @ X, rtol=1e-12, atol=1e-12)


def test_dia_bytes_gate():
    from cpkrylov_tpu.ops.dia import pack_dia

    band = sp.diags([1.0] * 5, [-2, -1, 0, 1, 2], shape=(1000, 1000))
    assert pack_dia(band.tocsr(), dtype=np.float32) is not None
    rnd = sp.random(1000, 1000, density=0.005,
                    random_state=np.random.default_rng(3))
    assert pack_dia(rnd.tocsr(), dtype=np.float32) is None  # scattered fill
    rect = sp.random(100, 50, density=0.1,
                     random_state=np.random.default_rng(3))
    assert pack_dia(rect.tocsr(), dtype=np.float32) is None  # non-square


def test_sym_dia_matches_scipy_and_dispatch(rng):
    from cpkrylov_tpu.ops.dia import pack_sym_dia
    from cpkrylov_tpu.ops.spmv import matmat, matvec

    n = 257
    M = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    M = M + M.T + sp.diags(np.full(n, 3.0))
    s = pack_sym_dia(M, dtype=np.float64, max_bytes_ratio=0)
    x = rng.standard_normal(n)
    X = rng.standard_normal((n, 4))
    np.testing.assert_allclose(np.asarray(matvec(s, jnp.asarray(x))),
                               M @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(matmat(s, jnp.asarray(X))),
                               M @ X, rtol=1e-12, atol=1e-12)


def test_dia_operator_rmatvec(rng):
    from cpkrylov_tpu.operators.linop import aslinearoperator
    from cpkrylov_tpu.ops.dia import pack_dia, pack_sym_dia

    n = 120
    M = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    M = M + sp.diags(np.full(n, 2.0))
    x = rng.standard_normal(n)
    op = aslinearoperator(pack_dia(M, dtype=np.float64, max_bytes_ratio=0))
    np.testing.assert_allclose(np.asarray(op.rmatvec(jnp.asarray(x))),
                               M.T @ x, rtol=1e-12, atol=1e-12)
    sym = pack_sym_dia(M, dtype=np.float64, max_bytes_ratio=0)
    op2 = aslinearoperator(sym)
    np.testing.assert_allclose(np.asarray(op2.rmatvec(jnp.asarray(x))),
                               M.T @ x, rtol=1e-12, atol=1e-12)


def test_dia_spill_matches_scipy(rng):
    from cpkrylov_tpu.operators.linop import aslinearoperator
    from cpkrylov_tpu.ops.dia import DIASpill, pack_dia_spill
    from cpkrylov_tpu.ops.spmv import matmat, matvec

    n = 4000
    band = sp.diags([np.ones(n)] * 7, [-3, -2, -1, 0, 1, 2, 3],
                    shape=(n, n)).tocsr()
    scatter = sp.random(n, n, density=0.0002, random_state=rng,
                        format="csr")
    M = (band + scatter).tocsr()
    pk = pack_dia_spill(M, dtype=np.float64)
    assert isinstance(pk, DIASpill)
    x = rng.standard_normal(n)
    X = rng.standard_normal((n, 3))
    np.testing.assert_allclose(np.asarray(matvec(pk, jnp.asarray(x))),
                               M @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(aslinearoperator(pk).rmatvec(jnp.asarray(x))),
        M.T @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(matmat(pk, jnp.asarray(X))),
                               M @ X, rtol=1e-12, atol=1e-12)


def test_cvxqp1_kp_packs_dia_spill(cvxqp1):
    """VERDICT r2 item 8 done-criterion: the shipped cvxqp1_m K_P must keep
    a fast device layout (not fall off to CSR) within ~1.5x CSR bytes."""
    from cpkrylov_tpu.ops.dia import DIASpill
    from cpkrylov_tpu.ops.dia import pack_sym_dia
    from cpkrylov_tpu.ops.spmv import matvec
    from cpkrylov_tpu.precond.cp import assemble_kp

    ksp = assemble_kp(cvxqp1.G, cvxqp1.B, cvxqp1.C).tocsr()
    packed = pack_sym_dia(ksp, dtype=np.float32)
    assert packed is not None, "cvxqp1 K_P lost the fast SpMV path"
    inner = getattr(packed, "inner", packed)
    assert isinstance(inner, DIASpill)
    ratio = inner.device_bytes / (ksp.nnz * 12.0)
    assert ratio <= 1.5, f"device bytes {ratio:.2f}x CSR"
    x = np.random.default_rng(5).standard_normal(ksp.shape[0]) \
        .astype(np.float32)
    y = np.asarray(matvec(packed, jnp.asarray(x)))
    ref = (ksp @ x.astype(np.float64)).astype(np.float32)
    denom = np.linalg.norm(ref)
    assert np.linalg.norm(y - ref) / denom < 1e-5


def test_dia_rectangular_matches_scipy(rng):
    from cpkrylov_tpu.ops.dia import (dia_matmat, dia_matvec, dia_rmatvec,
                                      pack_dia)

    for nr, nc in [(60, 200), (200, 60), (128, 128)]:
        M = sp.random(nr, nc, density=0.05, random_state=rng, format="csr")
        d = pack_dia(M, dtype=np.float64, max_bytes_ratio=0)
        x = rng.standard_normal(nc)
        y = rng.standard_normal(nr)
        X = rng.standard_normal((nc, 4))
        np.testing.assert_allclose(np.asarray(dia_matvec(d, jnp.asarray(x))),
                                   M @ x, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{nr}x{nc} matvec")
        np.testing.assert_allclose(np.asarray(dia_rmatvec(d, jnp.asarray(y))),
                                   M.T @ y, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{nr}x{nc} rmatvec")
        np.testing.assert_allclose(np.asarray(dia_matmat(d, jnp.asarray(X))),
                                   M @ X, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{nr}x{nc} matmat")


def test_diagonal_operator_sums_duplicate_entries():
    """A COO with repeated (i, i) coordinates is a valid scipy matrix whose
    duplicates SUM; the Diagonal fast path must match CSR semantics
    (ADVICE r3: last-write-wins silently corrupted such inputs)."""
    import scipy.sparse as sp

    from cpkrylov_tpu.operators.linop import aslinearoperator

    rows = np.array([0, 1, 1, 2])
    data = np.array([1.0, 2.0, 3.0, 4.0])
    A = sp.coo_matrix((data, (rows, rows)), shape=(3, 3))
    op = aslinearoperator(A, dtype=np.float64)
    x = np.array([1.0, 1.0, 1.0])
    got = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, A.tocsr() @ x)
