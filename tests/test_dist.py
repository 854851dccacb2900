import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from spgrid.core.metrics import error_metrics, gold_spmm_fast
from spgrid.dist import (
    make_mesh, device_mesh_shape, partition_bsr, make_dist_spmm,
    DistSparseAttention, make_dist_pipeline_step,
)
from spgrid.formats import random_csr, CSRMatrix
from spgrid.gen import artificial_matrix_generation, create_mask
from spgrid.ops.attention import gold_pipeline


def check(gold, test, eps=5e-4):
    m = error_metrics(gold, np.asarray(test), epsilon=eps)
    assert m.passed, f"max_rel_diff={m.max_rel_diff}"


def test_device_mesh_shape():
    assert np.prod(device_mesh_shape(8, 2)) == 8
    assert device_mesh_shape(1, 2) == (1, 1)


def test_mesh_has_8_cpu_devices():
    assert len(jax.devices()) == 8
    mesh = make_mesh(("data", "model"), shape=(2, 4))
    assert mesh.shape == {"data": 2, "model": 4}


def test_partition_bsr_covers_all_blocks():
    csr = artificial_matrix_generation(300, 300, 10, 3, seed=14, bw=0.4)
    sh = partition_bsr(csr, 4, bm=8, bk=128)
    assert sh.num_shards == 4
    assert sh.nnz == csr.nnz
    # reassemble dense and compare
    dense = np.zeros((4 * sh.rows_per_shard, 128 * ((300 + 127) // 128)),
                     dtype=np.float32)
    rows = np.asarray(sh.block_rows)
    cols = np.asarray(sh.block_cols)
    blocks = np.asarray(sh.blocks)
    mb_local = sh.rows_per_shard // 8
    for s in range(4):
        for b in range(blocks.shape[1]):
            if rows[s, b] < mb_local:
                r0 = s * sh.rows_per_shard + rows[s, b] * 8
                c0 = cols[s, b] * 128
                dense[r0:r0 + 8, c0:c0 + 128] += blocks[s, b]
    np.testing.assert_allclose(dense[:300, :300], csr.to_dense())


@pytest.mark.parametrize("x_partition", ["replicated", "row_sharded"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_dist_spmm_matches_gold(x_partition, use_pallas):
    m = k = 256
    csr = artificial_matrix_generation(m, k, 12, 4, seed=14, bw=0.5)
    rng = np.random.default_rng(0)
    x = (rng.random((k, 64)) + 0.5).astype(np.float32)
    gold = gold_spmm_fast(csr.row_ptr, csr.col_idx, csr.values, x)

    mesh = make_mesh(("data", "model"), shape=(2, 4))
    sh = partition_bsr(csr, 4, bm=8, bk=128)
    if x_partition == "row_sharded":
        # row-sharded x requires k divisible into model shards of x rows:
        # gather reassembles full k rows.
        pass
    fn = make_dist_spmm(mesh, sh, x_partition=x_partition,
                        use_pallas=use_pallas)
    xd = jax.device_put(
        jnp.asarray(x),
        NamedSharding(mesh, P("model" if x_partition == "row_sharded" else None,
                              "data")))
    y = np.asarray(fn(xd))
    check(gold, y[:m])


def test_dist_pipeline_matches_gold():
    m, k, n = 256, 128, 64

    def pos(csr):
        return CSRMatrix(csr.row_ptr, csr.col_idx,
                         np.abs(csr.values) + 0.1, csr.shape, csr.name)

    wk = pos(random_csr(m, k, density=0.4, seed=1))
    wq = pos(random_csr(m, k, density=0.4, seed=2))
    wv = pos(random_csr(m, k, density=0.4, seed=3))
    mask = create_mask("band_and_random", m, sparsity=0.85, band_size=8,
                       seed=14)
    rng = np.random.default_rng(0)
    x = (rng.random((k, n)).astype(np.float32) * 0.2)

    mesh = make_mesh(("data", "model"), shape=(2, 4))
    attn = DistSparseAttention.from_csr(wk, wq, wv, mask, num_shards=4)
    step = make_dist_pipeline_step(mesh, attn)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "data")))
    y = np.asarray(step(xd))

    gold = gold_pipeline(wk, wq, wv, mask, x)
    check(gold, y[:m], eps=1e-3)


def test_dist_pipeline_pallas_interpret():
    m, k, n = 128, 128, 32
    wk = random_csr(m, k, density=0.3, seed=1)
    wk = CSRMatrix(wk.row_ptr, wk.col_idx, np.abs(wk.values) + 0.1,
                   wk.shape, wk.name)
    mask = create_mask("band_and_random", m, sparsity=0.9, band_size=4, seed=14)
    x = (np.random.default_rng(0).random((k, n)).astype(np.float32) * 0.2)

    mesh = make_mesh(("data", "model"), shape=(2, 4))
    attn = DistSparseAttention.from_csr(wk, wk, wk, mask, num_shards=4)
    step = make_dist_pipeline_step(mesh, attn, use_pallas=True)
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(None, "data")))
    y = np.asarray(step(xd))
    gold = gold_pipeline(wk, wk, wk, mask, x)
    check(gold, y[:m], eps=1e-3)


def test_device_topology():
    from spgrid.dist.mesh import device_topology
    topo = device_topology()
    assert topo["num_devices"] >= 1
    assert len(topo["devices"]) == topo["num_devices"]
    assert topo["devices"][0]["kind"]


def test_halo_partition_and_spmm():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from spgrid.dist.mesh import make_mesh, available_devices
    from spgrid.dist.partition import partition_bsr_halo
    from spgrid.dist.spmm import make_dist_spmm
    from spgrid.gen import artificial_matrix_generation

    S = 4
    mesh = make_mesh(("data", "model"), shape=(1, S),
                     devices=available_devices(S))
    csr = artificial_matrix_generation(512, 512, 32, 4, "normal", seed=14,
                                       placement="random", bw=0.1,
                                       name="banded")
    sh = partition_bsr_halo(csr, S, bm=8, bk=128)
    # banded matrix: halo must be narrow, not the full matrix
    assert sh.halo_left + sh.halo_right < S - 1 or S <= 2
    fn = make_dist_spmm(mesh, sh, x_partition="halo")
    x = np.random.default_rng(0).random((512, 16)).astype(np.float32)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("model", "data")))
    y = np.asarray(fn(xd))[:512]
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-4, atol=1e-4)


def test_halo_requires_halo_partition():
    import pytest
    from spgrid.dist.mesh import make_mesh, available_devices
    from spgrid.dist.partition import partition_bsr
    from spgrid.dist.spmm import make_dist_spmm
    from spgrid.formats import random_csr

    mesh = make_mesh(("data", "model"), shape=(1, 2),
                     devices=available_devices(2))
    sh = partition_bsr(random_csr(64, 64, 0.1, seed=1), 2)
    with pytest.raises(ValueError):
        make_dist_spmm(mesh, sh, x_partition="halo")
