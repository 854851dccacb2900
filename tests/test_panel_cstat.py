"""Vertical-panel SpMM layout and format routing."""

import numpy as np
import jax.numpy as jnp

from spgrid.formats import random_csr, dense_to_csr
from spgrid.ops import DevicePanels, panel_spmm


def _check(kernel, dev, csr, n=96, atol=1e-4):
    x = np.random.default_rng(0).random((csr.k, n)).astype(np.float32)
    y = np.asarray(kernel(dev, jnp.asarray(x)))
    gold = csr.to_dense() @ x
    np.testing.assert_allclose(y, gold, rtol=1e-4, atol=atol)


def test_panels_basic():
    csr = random_csr(100, 300, 0.05, seed=3)
    _check(panel_spmm, DevicePanels.from_csr(csr, bk=128, band_rows=64), csr)


def test_panels_skips_empty():
    dense = np.zeros((256, 512), dtype=np.float32)
    dense[:64, :128] = 1.0
    dense[128:, 384:] = 2.0
    csr = dense_to_csr(dense)
    dev = DevicePanels.from_csr(csr, bk=128, band_rows=128)
    assert dev.num_panels == 2        # only 2 of 8 (band, col) panels kept
    _check(panel_spmm, dev, csr)


def test_panels_footprint_between_bsr_and_dense():
    csr = random_csr(256, 256, 0.02, seed=4)
    dev = DevicePanels.from_csr(csr, bk=128, band_rows=64)
    dense_bytes = 256 * 256 * 4
    assert dev.panels.size * 4 <= dense_bytes


def test_dispatch_new_formats():
    from spgrid.ops.dispatch import build, spmm_fn
    csr = random_csr(64, 64, 0.2, seed=5)
    x = np.random.default_rng(1).random((64, 32)).astype(np.float32)
    gold = csr.to_dense() @ x
    for fmt in ("bsr_pallas", "panel"):
        a = build(csr, fmt)
        y = np.asarray(spmm_fn(fmt)(a, jnp.asarray(x)))[:64]
        np.testing.assert_allclose(y, gold, rtol=1e-4, atol=1e-4)


# Kernel classes: dense-block execution vs the gather family.
BLOCK_CLASS = ("dense", "bsr_pallas", "panel", "rbh")
GATHER_CLASS = ("gell", "ell", "coo", "merge", "sell", "scoo")


def test_select_format_regimes(test_consts):
    from spgrid.ops.dispatch import select_format
    from spgrid.features import matrix_features
    from spgrid.gen import artificial_matrix_generation

    # small or locally dense matrices cost little to run as dense blocks;
    # large hypersparse ones must route to the gather kernel family
    banded = artificial_matrix_generation(512, 512, 64, 8, "normal", seed=1,
                                          placement="random", bw=0.05)
    assert select_format(matrix_features(banded),
                         consts=test_consts) in BLOCK_CLASS
    dense_m = random_csr(256, 256, 0.4, seed=1)
    assert select_format(matrix_features(dense_m),
                         consts=test_consts) in BLOCK_CLASS
    hyper = artificial_matrix_generation(60000, 60000, 5, 1.7, "normal",
                                         seed=1, placement="random", bw=0.9)
    assert select_format(matrix_features(hyper),
                         consts=test_consts) in GATHER_CLASS
