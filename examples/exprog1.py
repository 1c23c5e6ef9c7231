"""Example 1: symmetric 2x2-block CVXQP saddle-point system, CP-MINRES.

JAX equivalent of the reference example program
/root/reference/examples/cpk_exprog1.m — solves the interior-point KKT
system of the CUTEst QP ``cvxqp1-m`` (iteration 10; 5500x5500, n=3000,
m=2500) with the constraint-preconditioned MINRES kernel, validates
against a sparse direct solve, and plots the residual history.

Run:  python examples/exprog1.py
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

# -- load the fixture and slice the blocks (cpk_exprog1.m:45-64) ------------
sys_ = load_fixture("cvxqp1_m")
print(f"system {sys_.name}: n={sys_.n} m={sys_.m} "
      f"nnz(K)={sys_.K.nnz}")

# G = diag(diag(Q)): the Jacobi approximation of the leading block
# (cpk_exprog1.m:59-64) is already attached by load_fixture as sys_.G.

# -- solver selection (cpk_exprog1.m:67-74) ---------------------------------
method = "cpminres"
# method = "cpcg"
# method = "cpcglanczos"
# method = "cpdqgmres"        # with opts.mem = 2

# -- options (cpk_exprog1.m:79-92) ------------------------------------------
opts = cpk.SolverOptions(atol=1.0e-6, rtol=1.0e-6, itmax=500, mem=2)
precond_opts = cpk.PrecondOptions(residual_update=True, nitref=1,
                                  force_itref=True)

# -- solve (cpk_exprog1.m:97) -----------------------------------------------
out = cpk.solve(method, sys_.b, sys_.A, sys_.B, sys_.C, sys_.G,
                opts=opts, precond_opts=precond_opts)

# -- validate against the sparse direct solve (cpk_exprog1.m:100-104) -------
x_direct = spla.spsolve(sys_.K.tocsc(), sys_.b)
relerr = np.linalg.norm(np.asarray(out.x) - x_direct) / np.linalg.norm(x_direct)

print(f"solver     : {method}")
print(f"solved     : {out.solved}  (status: {out.result.status})")
print(f"iterations : {out.niters}")
print(f"rel. error : {relerr:.2e}")
print(f"ptime      : {out.ptime:.3f} s   (preconditioner build)")
print(f"stime      : {out.stime:.3f} s   (solve)")

# -- residual-history plot (cpk_exprog1.m:110-117) --------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(out.resid_history, lw=1.5)
    ax.set_xlabel("iteration")
    ax.set_ylabel("residual norm")
    ax.set_title(f"{method} on {sys_.name}")
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig("examples/exprog1_resid.png", dpi=120)
    print("plot       : examples/exprog1_resid.png")
except ImportError:  # headless environments without matplotlib
    pass
