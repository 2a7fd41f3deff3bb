from .masking import (
    gather_rows,
    masked_cholesky,
    masked_eigh,
    masked_svd,
    prefix_lock,
    prefix_mask,
    scatter_rows,
)
from .guess import check_guess, guess_evec

__all__ = [
    "gather_rows",
    "masked_cholesky",
    "masked_eigh",
    "masked_svd",
    "prefix_lock",
    "prefix_mask",
    "scatter_rows",
    "check_guess",
    "guess_evec",
]
