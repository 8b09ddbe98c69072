"""Dense-tile SpMM: the Triton kernel (interpret mode) against the plain form
and ``spmm_ref``, and the one place that chooses between them.

The kernel's compiled form runs only on a GPU (``test_kernel_compiled_on_gpu``
skips elsewhere); ``chip_smoke.py`` runs the same checks on the card at the
models' real widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph
from tcgnn.graph import TiledGraph
from tcgnn.ops import spmm as S
from tcgnn.ops.reference import spmm_ref

CFG = TileConfig(blk_h=32, blk_w=16, edge_chunk=16)


def _graph(n, e, seed, cfg=CFG, empty_rows=(), narrow_rows=()):
    src, dst = powerlaw_graph(n, e, seed=seed)
    keep = ~np.isin(src, empty_rows) & ~np.isin(dst, empty_rows)
    src, dst = src[keep], dst[keep]
    narrow = np.isin(src, narrow_rows)
    dst = np.where(narrow, dst % 10, dst)  # <= 10 distinct neighbours
    ptr, cols = coo_to_csr(src, dst, n)
    return ptr, cols, TiledGraph(ptr, cols, n, cfg, block_diag=False)


@pytest.fixture(scope="module")
def graph():
    # At blk_h=32: window 2 (rows 64..95) has no edge, so its only block is
    # SGT's all-zero padding block; window 3 (rows 96..127) reads at most
    # 10 distinct neighbours, so one block of 16 columns holds them all.
    return _graph(300, 2400, seed=3, empty_rows=np.arange(64, 96),
                  narrow_rows=np.arange(96, 128))


def _kernel(x, a, meta, **kw):
    return S._spmm_dense_triton(
        x, a, meta.col_ids, meta.block_window, cfg=meta.config,
        num_windows=meta.num_windows, interpret=True, **kw,
    )


def _plain(x, a, meta):
    return S._spmm_dense_plain(
        x, a, meta.col_ids, meta.block_window, cfg=meta.config,
        num_windows=meta.num_windows,
    )


def test_window_block_counts_cover_0_1_and_many(graph):
    _, _, g = graph
    bw = np.asarray(g.meta.block_window)
    counts = np.bincount(bw)
    tiles = np.asarray(g.arrays()[2])
    # window 2 has no edge: its only block is SGT's all-zero padding block
    assert counts[2] == 1 and not tiles[bw == 2].any()
    assert counts[3] == 1 and tiles[bw == 3].any()
    assert counts.max() > 4


@pytest.mark.parametrize("d", [3, 16, 40, 130])
@pytest.mark.parametrize("split", [1, 3, 32])
def test_kernel_matches_plain_and_reference(graph, d, split):
    ptr, cols, g = graph
    x = jax.random.normal(jax.random.PRNGKey(d), (g.num_nodes, d))
    a = g.arrays()[2]
    got = _kernel(x, a, g.meta, split=split, r_blk=16)[: g.num_nodes]
    want = spmm_ref(x, jnp.asarray(ptr), jnp.asarray(cols))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    plain = _plain(x, a, g.meta)
    np.testing.assert_allclose(
        _kernel(x, a, g.meta, split=split, r_blk=16), plain,
        rtol=1e-5, atol=1e-4,
    )


def test_kernel_weighted_tiles(graph):
    ptr, cols, g = graph
    x = jax.random.normal(jax.random.PRNGKey(0), (g.num_nodes, 24))
    w = jax.random.uniform(jax.random.PRNGKey(1), (g.num_edges,))
    tiles = S.build_a_tiles(g.meta, w)
    got = _kernel(x, tiles, g.meta)[: g.num_nodes]
    want = spmm_ref(x, jnp.asarray(ptr), jnp.asarray(cols), w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_transpose_tiling():
    n = 200
    rng = np.random.default_rng(5)
    src = rng.integers(0, n, 900)
    dst = (src * 7 + rng.integers(0, 40, 900)) % n  # directed
    ptr, cols = coo_to_csr(src, dst, n)
    g = TiledGraph(ptr, cols, n, CFG, block_diag=False)
    assert not g.symmetric
    from tcgnn.sgt.translate import transpose_csr

    t_ptr, t_idx, _ = transpose_csr(ptr, cols, n)
    x = jax.random.normal(jax.random.PRNGKey(2), (n, 8))
    a_t = g.arrays()[3]
    got = _kernel(x, a_t, g.meta_t)[:n]
    want = spmm_ref(x, jnp.asarray(t_ptr), jnp.asarray(t_idx))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_bf16_and_block_group():
    cfg = TileConfig(blk_h=32, blk_w=16, edge_chunk=16, block_group=2,
                     compute_dtype=jnp.bfloat16)
    ptr, cols, g = _graph(256, 3000, seed=9, cfg=cfg)
    x = jax.random.normal(jax.random.PRNGKey(4), (256, 32))
    a = g.arrays()[2]
    got = _kernel(x, a, g.meta)
    assert got.dtype == jnp.bfloat16
    want = _plain(x, a, g.meta)
    np.testing.assert_allclose(
        np.asarray(got, np.float32)[:256], np.asarray(want, np.float32)[:256],
        rtol=2e-2, atol=2e-2 * float(jnp.max(jnp.abs(want))),
    )


def test_work_items_cover_every_block_once(graph):
    _, _, g = graph
    bw = g.meta.block_window
    for split in (1, 2, 5, 64):
        start, end, win = map(
            np.asarray, S._work_items(bw, g.meta.num_windows, split)
        )
        covered = np.concatenate(
            [np.arange(s, e) for s, e in zip(start, end)]
        )
        assert np.array_equal(np.sort(covered), np.arange(bw.shape[0]))
        assert (end - start <= split).all()
        bw_np = np.asarray(bw)
        for s, e, w in zip(start, end, win):
            if e > s:
                assert (bw_np[s:e] == w).all()


def test_d_block_and_tiling_rules():
    assert [S._triton_d_block(d) for d in (1, 3, 16, 17, 96, 500)] == [
        16, 16, 16, 32, 128, 128,
    ]
    assert S._triton_tiling(356, 16) == (8, 32)
    assert S._triton_tiling(11942, 128) == (32, 64)


def test_implementation_choice():
    big = dict(num_blocks=S.TRITON_MIN_BLOCKS, d=16)
    small = dict(num_blocks=S.TRITON_MIN_BLOCKS - 1, d=500)
    cfg = TileConfig()
    assert S.dense_spmm_impl(cfg, "cpu", **big) == "plain"
    assert S.dense_spmm_impl(cfg, "gpu", **big) == "triton"
    assert S.dense_spmm_impl(cfg, "gpu", **small) == "plain"
    odd = TileConfig(blk_h=24, blk_w=16)
    assert S.dense_spmm_impl(odd, "gpu", **big) == "plain"
    narrow = TileConfig(blk_h=16, blk_w=8)
    assert S.dense_spmm_impl(narrow, "gpu", **big) == "plain"
    with S.forced_dense_impl("triton"):
        assert S.dense_spmm_impl(cfg, "gpu", **small) == "triton"
        assert S.dense_spmm_impl(cfg, "cpu", **small) == "plain"
    for platform in ("tpu", "rocm", "metal"):
        with pytest.raises(RuntimeError, match="no SpMM implementation"):
            S.dense_spmm_impl(cfg, platform, **big)


def test_default_backend_chooses_plain_here(graph):
    _, _, g = graph
    assert jax.default_backend() == "cpu"
    assert S.dense_spmm_impl(g.config, num_blocks=10**6, d=512) == "plain"


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel runs only there")


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu, graph):
    ptr, cols, g = graph
    x = jax.random.normal(jax.random.PRNGKey(0), (g.num_nodes, 16))
    a = g.arrays()[2]
    got = S._spmm_dense_triton(
        x, a, g.meta.col_ids, g.meta.block_window, cfg=g.config,
        num_windows=g.meta.num_windows,
    )[: g.num_nodes]
    with jax.default_matmul_precision("highest"):
        want = spmm_ref(x, jnp.asarray(ptr), jnp.asarray(cols))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
