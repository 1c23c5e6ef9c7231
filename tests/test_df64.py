"""df64 (double-f32) arithmetic and the device-resident mixed solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from cpkrylov_tpu.ops import df64


def test_two_sum_exact():
    a = np.float32(1.0)
    b = np.float32(1e-8)
    s, e = df64.two_sum(jnp.float32(a), jnp.float32(b))
    assert float(s) + float(e) == float(np.float64(a) + np.float64(b))


def test_two_prod_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = df64.two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_df_split_roundtrip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000) * 1e3
    hi, lo = df64.df_from_f64(x)
    np.testing.assert_allclose(df64.df_to_f64(hi, lo), x, rtol=1e-14)


def test_df_dia_matvec_accuracy():
    rng = np.random.default_rng(2)
    n = 5000
    A = sp.diags([rng.standard_normal(n) for _ in range(5)],
                 [-2, -1, 0, 1, 2], shape=(n, n), format="csr")
    x = rng.standard_normal(n)
    dfa = df64.pack_df_dia(A)
    xh, xl = df64.df_from_f64(x)
    yh, yl = df64.df_dia_matvec(dfa, (jnp.asarray(xh), jnp.asarray(xl)))
    y = df64.df_to_f64(np.asarray(yh), np.asarray(yl))
    exact = A @ x
    rel = np.linalg.norm(y - exact) / np.linalg.norm(exact)
    assert rel < 1e-12, rel     # ~2^-48-class, far beyond f32's 6e-8


def test_df_saddle_residual_cancellation():
    """The df64 residual must survive the cancellation b - K x ~ 0 that
    destroys a plain f32 evaluation."""
    from cpkrylov_tpu.utils.fixtures import banded_saddle_system

    sysm = banded_saddle_system(2000, 500, bandwidth=3, with_oracle=False)
    K = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(K.shape[0])
    b = K @ x   # residual of x is exactly 0 in f64
    Kdf = df64.pack_df_saddle(sysm.A, sysm.B, sysm.C)
    assert Kdf is not None
    xh, xl = df64.df_from_f64(x)
    kx = Kdf.matvec((jnp.asarray(xh), jnp.asarray(xl)))
    bh, bl = df64.df_from_f64(b)
    rh, rl = df64.df_add((jnp.asarray(bh), jnp.asarray(bl)),
                         df64.df_neg(kx))
    rel = float(jnp.linalg.norm(rh)) / np.linalg.norm(b)
    # plain f32 evaluation floors at ~1e-7 relative; df64 goes ~7 digits
    # further down
    assert rel < 5e-13, rel


def test_device_resident_mixed_matches_host():
    """Forced device-resident outer loop == host outer loop (CPU backend:
    same f32 math, no transfers to save — pure parity check)."""
    from cpkrylov_tpu import SolverOptions, solve_mixed
    from cpkrylov_tpu.utils.fixtures import banded_saddle_system

    sysm = banded_saddle_system(2048, 512, bandwidth=3, with_oracle=False)
    opts = SolverOptions(atol=0.0, rtol=1e-10, itmax=300)

    host = solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                       opts=opts, device_resident=False)
    dev = solve_mixed("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                      opts=opts, device_resident=True)
    assert host.solved and dev.solved
    assert dev.nouter <= host.nouter + 1
    K = sp.bmat([[sysm.A, sysm.B.T], [sysm.B, -sysm.C]]).tocsr()
    for out in (host, dev):
        r = sysm.b - K @ out.x
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(sysm.b)
    rel = (np.linalg.norm(dev.x - host.x)
           / max(np.linalg.norm(host.x), 1e-300))
    assert rel < 1e-8, rel
