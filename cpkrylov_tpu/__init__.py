"""cpkrylov_tpu — constraint-preconditioned Krylov solvers in JAX.

A from-scratch JAX/XLA framework for regularized saddle-point systems

    [ A  B' ] [x1]   [b1]
    [ B  -C ] [x2] = [b2]

implementing the constraint-preconditioned Krylov family (CPCG,
CP-CG-Lanczos, CPMINRES, CPSYMMLQ, CPGMRES(l), CPDQGMRES) with the same
capabilities as the MATLAB reference ``cpkrylov`` (di Serafino & Orban,
SISC 2021) on accelerators: sparse containers as pytrees,
SpMV/trisolve device kernels, a host-factorized LDL^T constraint
preconditioner with Gould-Hribar-Nocedal residual update and iterative
refinement threaded as explicit functional state, and solvers as
``lax.while_loop`` pure functions that jit/pjit across device meshes.
"""

from .config import PrecondOptions, SolverOptions
from .driver import SolveOutput, solve
from .mixed import MixedSolveOutput, solve_mixed
from .operators.linop import (FunctionOperator, MatrixOperator,
                              aslinearoperator)
from .ops.formats import CSR, ELL, Diagonal, csr_from_scipy, ell_from_scipy
from .precond.cp import CPPrecond, CPState, make_preconditioner
from .solvers.common import KrylovResult
from .solvers.cpcg import cpcg
from .solvers.cpcglanczos import cpcglanczos
from .solvers.cpdqgmres import cpdqgmres
from .solvers.cpgmres import cpgmres
from .solvers.cpminres import cpminres
from .solvers.cpsymmlq import cpsymmlq

__all__ = [
    "CSR", "ELL", "Diagonal", "csr_from_scipy", "ell_from_scipy",
    "MatrixOperator", "FunctionOperator", "aslinearoperator",
    "PrecondOptions", "SolverOptions",
    "CPPrecond", "CPState", "make_preconditioner",
    "KrylovResult", "SolveOutput", "solve",
    "MixedSolveOutput", "solve_mixed",
    "cpminres", "cpcg", "cpcglanczos", "cpsymmlq", "cpgmres", "cpdqgmres",
]

__version__ = "0.1.0"
