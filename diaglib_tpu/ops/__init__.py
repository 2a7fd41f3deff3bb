"""Operator kernels: the hot matvec paths."""

from .bsr import (
    BSRMatrix,
    bsr_astype,
    bsr_diagonal,
    bsr_from_dense,
    bsr_matvec,
    bsr_to_dense,
    random_bsr_spd,
)
from .dist_bsr import DistBSRMatrix, dist_bsr_matvec, distribute_bsr
from .ell import (
    ELLMatrix,
    ell_diagonal,
    ell_from_coo,
    ell_from_dense,
    ell_matvec,
    ell_to_dense,
)

__all__ = [
    "BSRMatrix",
    "DistBSRMatrix",
    "ELLMatrix",
    "bsr_astype",
    "bsr_diagonal",
    "bsr_from_dense",
    "bsr_matvec",
    "bsr_to_dense",
    "dist_bsr_matvec",
    "distribute_bsr",
    "ell_diagonal",
    "ell_from_coo",
    "ell_from_dense",
    "ell_matvec",
    "ell_to_dense",
    "random_bsr_spd",
]
