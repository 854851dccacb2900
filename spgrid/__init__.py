"""spgrid — sparse linear-algebra benchmark framework in JAX.

A from-scratch JAX / XLA / Pallas / pjit re-design of the capabilities of the
SpMM-Research benchmark platform (reference: NTUA CSLab sparse-kernel research
suite): deterministic artificial matrix generation driven by structural
features, sparse storage formats as padded device arrays, SpMV / SpMM / SDDMM
and the sparse-attention pipeline as XLA and Pallas (Triton) kernels for the
GPU, a benchmark harness with high-precision accuracy oracles and roofline
accounting, and multi-device/multi-host scaling over a device mesh.

Layer map (mirrors SURVEY.md §7):
    spgrid.core      — config, deterministic RNG, timing protocol, error metrics,
                       roofline model                       (ref: lib/)
    spgrid.formats   — COO/CSR/ELL/SELL-C-sigma/BSR device layouts + partitioners
                       (ref: lib/storage_formats, lib/parallel_util.h)
    spgrid.io        — .mtx/.smtx readers (C++ native + numpy fallback)
                       (ref: lib/storage_formats/{matrix_market,dlcm_matrices})
    spgrid.gen       — artificial matrix generator + attention mask generator
                       (ref: artificial-matrix-generator, sddmm_mask.h)
    spgrid.features  — structural/value feature extraction
                       (ref: lib/storage_formats/csr_util)
    spgrid.ops       — SpMV/SpMM/SDDMM/pipeline kernels (XLA + Pallas)
                       (ref: benchmark_code/*/spmv_code_bench kernels)
    spgrid.bench     — sweep harness, CSV schema, accuracy gate
                       (ref: benchmark_code/*/spmv_bench.cpp, run.sh)
    spgrid.dist      — mesh setup, row-partitioned distributed SpMM
                       (new capability; ref has shared-memory only)
    spgrid.viz       — plotting / analysis (ref: results_visualization)
"""

__version__ = "0.1.0"
