"""Example 2: nonsymmetric 3x3-block permuted CVXQP system, CP-GMRES.

JAX equivalent of the reference example program
/root/reference/examples/cpk_exprog2.m — solves the nonsymmetric permuted
interior-point KKT system of ``cvxqp2-s`` (725x725, n=500, m=225) with the
restarted constraint-preconditioned GMRES kernel (restart=100), validates
against a sparse direct solve, and plots the residual history.

Run:  python examples/exprog2.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)   # reference-parity f64 mode

import numpy as np
import scipy.sparse.linalg as spla

import cpkrylov_tpu as cpk
from cpkrylov_tpu.utils.fixtures import load_fixture

# -- load the fixture and slice the blocks (cpk_exprog2.m:47-66) ------------
sys_ = load_fixture("cvxqp2_s")
asym = abs(sys_.A - sys_.A.T).max()
print(f"system {sys_.name}: n={sys_.n} m={sys_.m} "
      f"nnz(K)={sys_.K.nnz}  max|A-A'|={asym:.3g}")

# -- solver selection (cpk_exprog2.m:69-74): nonsymmetric A -> Arnoldi family
method = "cpgmres"            # with opts.restart = 100
# method = "cpdqgmres"        # with opts.mem = 100

# -- options (cpk_exprog2.m:79-92) ------------------------------------------
opts = cpk.SolverOptions(atol=1.0e-6, rtol=1.0e-6, itmax=500,
                         restart=100, mem=100)
precond_opts = cpk.PrecondOptions(residual_update=True, nitref=1,
                                  force_itref=True)

# -- solve (cpk_exprog2.m:96) -----------------------------------------------
out = cpk.solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                opts=opts, precond_opts=precond_opts)

# -- validate against the sparse direct solve (cpk_exprog2.m:99-103) --------
x_direct = spla.spsolve(sys_.K.tocsc(), sys_.b)
relerr = np.linalg.norm(np.asarray(out.x) - x_direct) / np.linalg.norm(x_direct)

print(f"solver     : {method}(restart={opts.restart})")
print(f"solved     : {out.solved}  (status: {out.result.status})")
print(f"iterations : {out.niters}")
print(f"rel. error : {relerr:.2e}")
print(f"ptime      : {out.ptime:.3f} s   (preconditioner build)")
print(f"stime      : {out.stime:.3f} s   (solve)")

# -- residual-history plot (cpk_exprog2.m:106-116) --------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(out.resid_history, lw=1.5)
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual norm")
    ax.set_title(f"{method}({opts.restart}) on {sys_.name}")
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig("examples/exprog2_resid.png", dpi=120)
    print("plot       : examples/exprog2_resid.png")
except ImportError:  # headless environments without matplotlib
    pass
