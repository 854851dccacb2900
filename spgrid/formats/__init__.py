"""Sparse storage formats as host containers + static-shape padded layouts."""

from spgrid.formats.csr import (
    CSRMatrix,
    COOMatrix,
    coo_to_csr,
    csr_to_coo,
    dense_to_csr,
    random_csr,
    IDX_DTYPE,
)
from spgrid.formats.csc import CSCMatrix, csr_to_csc, csc_to_csr
from spgrid.formats.ldu import LDUMatrix, csr_to_ldu, ldu_to_csr
from spgrid.formats.cv import CVMatrix, csr_to_cv, cv_to_csr, \
    quantization_error
from spgrid.formats.ell import ELLMatrix, csr_to_ell, ell_to_csr
from spgrid.formats.sell import SELLMatrix, SELLBucket, csr_to_sell, sell_to_dense
from spgrid.formats.bsr import BSRMatrix, csr_to_bsr, bsr_to_csr
from spgrid.formats.partition import (
    balance_iterations,
    balance_prefix_sums,
    balance_mixed,
    merge_path_blocks,
)

__all__ = [
    "CSRMatrix", "COOMatrix", "coo_to_csr", "csr_to_coo", "dense_to_csr",
    "random_csr", "IDX_DTYPE",
    "CSCMatrix", "csr_to_csc", "csc_to_csr",
    "LDUMatrix", "csr_to_ldu", "ldu_to_csr",
    "CVMatrix", "csr_to_cv", "cv_to_csr", "quantization_error",
    "ELLMatrix", "csr_to_ell", "ell_to_csr",
    "SELLMatrix", "SELLBucket", "csr_to_sell", "sell_to_dense",
    "BSRMatrix", "csr_to_bsr", "bsr_to_csr",
    "balance_iterations", "balance_prefix_sums", "balance_mixed",
    "merge_path_blocks",
]
