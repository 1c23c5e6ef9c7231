"""Host-side matrix IO: MATLAB .mat and MatrixMarket loaders.

The reference ships .mat fixtures and loads them with MATLAB ``load``
(examples/cpk_exprog1.m:45-46); this module provides the equivalents,
returning scipy sparse matrices ready for the block
converters in ``formats.py`` / ``pgell.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def load_mat(path: str, key: str = "K"):
    """Load a sparse matrix (and companions) from a MATLAB .mat file.

    Returns a dict of contents with sparse matrices as csr_matrix.
    """
    import scipy.io as sio

    raw = sio.loadmat(path)
    out = {}
    for k, v in raw.items():
        if k.startswith("__"):
            continue
        if sp.issparse(v):
            out[k] = v.tocsr()
        else:
            arr = np.asarray(v)
            out[k] = arr.item() if arr.size == 1 else arr
    return out


def load_matrix_market(path: str) -> sp.csr_matrix:
    """Load a MatrixMarket .mtx file (symmetric storage expanded)."""
    from scipy.io import mmread

    return sp.csr_matrix(mmread(path))


def save_matrix_market(path: str, mat) -> None:
    from scipy.io import mmwrite

    mmwrite(path, sp.coo_matrix(mat))
