"""Regression tests for cross-shard padding in the distributed metadata.

The stacked per-shard block/chunk padding must keep every shard's output
window map non-decreasing: the dense-tile Triton kernel locates a window's
blocks as one contiguous range, so a padding block that pointed back at
window 0 would be folded into the wrong window (or dropped).  These tests
(a) assert the monotone-output-map invariant directly on the host metadata
and (b) run each shard's local op — the dense-tile Triton kernel in
interpret mode, the chunk form as plain XLA — padded metadata included, and
assemble the results against ``spmm_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tcgnn.config import TileConfig
from tcgnn.ops.reference import spmm_ref
from tcgnn.parallel import DistributedTiledGraph, make_mesh
from tcgnn.parallel.partition import partition_graph

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def random_csr(n, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n).clip(0, n - 1)
    cols = [np.unique(rng.integers(0, n, d)) for d in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(cols).astype(np.int32)


def _assert_monotone_output_maps(meta):
    """Every per-shard output index map the kernels derive must be
    non-decreasing (consecutive revisits only)."""
    group = max(int(meta.config.block_group), 1)
    for s in range(meta.num_shards):
        bw = meta.block_window[s][::group]
        assert (np.diff(bw) >= 0).all(), f"shard {s}: dense map revisits"
        cw = meta.chunk_window[s]
        assert (np.diff(cw) >= 0).all(), f"shard {s}: chunk map revisits"
        assert bw[-1] == meta.windows_per_shard - 1
    if meta.overlap is not None:
        for cls in ("local", "remote"):
            w = meta.overlap[cls]["block_window"]
            for s in range(meta.num_shards):
                ws = w[s][::group]
                assert (np.diff(ws) >= 0).all(), f"{cls} shard {s} revisits"
    if meta.split is not None:
        for s in range(meta.num_shards):
            ws = meta.split["block_window"][s]
            assert (np.diff(ws) >= 0).all(), f"split shard {s} revisits"
            # every output window (own + guest slots) is written at least once
            wd = meta.windows_per_shard + max(meta.split["guest_cap"], 1)
            assert set(np.unique(ws)) == set(range(wd)), f"split shard {s} gaps"


@pytest.mark.parametrize("group", [1, 2])
def test_stacked_padding_keeps_output_maps_monotone(group):
    cfg = TileConfig(blk_h=16, blk_w=16, edge_chunk=16, block_group=group)
    n = 150
    ptr, cols = random_csr(n, avg_deg=6, seed=3)
    fwd, bwd = partition_graph(ptr, cols, n, 4, cfg)
    # Padding must actually be exercised: shards have unequal block counts.
    per_shard_real = [
        int((fwd.a_tiles[s] != 0).any(axis=(1, 2)).sum())
        for s in range(fwd.num_shards)
    ]
    assert len(set(per_shard_real)) > 1, per_shard_real
    _assert_monotone_output_maps(fwd)
    _assert_monotone_output_maps(bwd)


# Each shard's local op runs on its own — exactly the program one device
# executes inside the shard map, padded metadata included — and the
# results are assembled on the host.
def _dense_spmm(x, tiles, col_ids, block_window, num_windows):
    from tcgnn.ops.spmm import _spmm_dense_triton

    return _spmm_dense_triton(
        jnp.asarray(x), jnp.asarray(tiles), jnp.asarray(col_ids),
        jnp.asarray(block_window), cfg=CFG, num_windows=num_windows,
        interpret=True,
    )


@pytest.fixture(scope="module")
def strict_setup():
    n, d = 150, 48
    ptr, cols = random_csr(n, avg_deg=6, seed=3)
    fwd, _ = partition_graph(ptr, cols, n, 4, CFG)
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    x_full = np.zeros((fwd.padded_nodes, d), np.float32)
    x_full[:n] = x
    want = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))
    return fwd, x, x_full, want, ptr, cols


def test_strict_interpret_dense_spmm_per_shard(strict_setup):
    fwd, x, x_full, want, ptr, cols = strict_setup
    n, d = x.shape
    outs = []
    for s in range(fwd.num_shards):
        outs.append(
            np.asarray(
                _dense_spmm(
                    x_full, fwd.a_tiles[s], fwd.col_ids[s],
                    fwd.block_window[s], fwd.windows_per_shard,
                )
            )
        )
    got = np.concatenate(outs)[:n, :d]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_strict_interpret_chunk_spmm_per_shard(strict_setup):
    from tcgnn.ops.spmm import _spmm_padded

    fwd, x, x_full, want, ptr, cols = strict_setup
    n, d = x.shape
    outs = []
    for s in range(fwd.num_shards):
        chunk_w = jnp.zeros_like(jnp.asarray(fwd.chunk_r[s]))
        outs.append(
            np.asarray(
                _spmm_padded(
                    jnp.asarray(x_full),
                    jnp.asarray(fwd.col_ids[s]),
                    jnp.asarray(fwd.chunk_r[s]),
                    jnp.asarray(fwd.chunk_c[s]),
                    chunk_w,
                    jnp.asarray(fwd.chunk_block[s]),
                    jnp.asarray(fwd.chunk_window[s]),
                    cfg=CFG,
                    num_windows=fwd.windows_per_shard,
                    weighted=False,
                )
            )
        )
    got = np.concatenate(outs)[:n, :d]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_strict_interpret_overlap_classes_per_shard(strict_setup):
    fwd, x, x_full, want, ptr, cols = strict_setup
    n, d = x.shape
    ov = fwd.overlap
    rows_per_shard = fwd.rows_per_shard
    outs = []
    for s in range(fwd.num_shards):
        x_loc = x_full[s * rows_per_shard : (s + 1) * rows_per_shard]
        part = np.zeros((rows_per_shard, d), np.float32)
        for cls, xin in (("local", x_loc), ("remote", x_full)):
            m = ov[cls]
            part += np.asarray(
                _dense_spmm(
                    xin, m["a_tiles"][s], m["col_ids"][s],
                    m["block_window"][s], fwd.windows_per_shard,
                )
            )[:, :d]
        outs.append(part)
    got = np.concatenate(outs)[:n, :d]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_overflow_falls_back_to_compute_dtype():
    """Multigraphs with >127 duplicate edges must not crash partitioning
    (mirrors the single-device to_dev fallback in graph.py)."""
    n = 48
    # row 0: 200 copies of neighbor 0; rows 1..n-1: one self-ish edge each
    cols = np.concatenate([np.zeros(200, np.int64), np.arange(1, n)])
    ptr = np.zeros(n + 1, np.int64)
    ptr[1] = 200
    ptr[2:] = 200 + np.arange(1, n)
    fwd, bwd = partition_graph(ptr.astype(np.int32), cols.astype(np.int32), n, 2, CFG)
    assert fwd.a_tiles.dtype != np.int8
    assert fwd.a_tiles.max() == 200
    # The overlap classes (the DEFAULT distributed dense path) must carry
    # the same fallback dtype — int8 would silently wrap 200 -> -56.
    for cls in ("local", "remote"):
        assert fwd.overlap[cls]["a_tiles"].dtype != np.int8
    assert max(
        fwd.overlap[cls]["a_tiles"].max() for cls in ("local", "remote")
    ) == 200


def test_multigraph_distributed_spmm_exact(mesh42_cached={}):
    """End-to-end distributed SpMM on a >127-duplicate multigraph: the
    duplicate count must aggregate as 200, not wrap."""
    from tcgnn.parallel import DistributedTiledGraph, make_mesh

    n, d = 64, 8
    cols = np.concatenate([np.zeros(200, np.int64), np.arange(1, n)])
    ptr = np.zeros(n + 1, np.int64)
    ptr[1] = 200
    ptr[2:] = 200 + np.arange(1, n)
    mesh = mesh42_cached.setdefault("m", make_mesh(n_graph=2, n_feature=1))
    dg = DistributedTiledGraph(
        ptr.astype(np.int32), cols.astype(np.int32), n, mesh, CFG
    )
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    out = np.asarray(jax.jit(dg.spmm)(dg.shard_features(x)))[:n, :d]
    want = np.zeros((n, d), np.float32)
    want[0] = 200.0 * x[0]
    want[1:] = x[1:]
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_strict_interpret_split_spmm_per_shard():
    """Split streams (guest windows + pads) through the dense-tile kernel:
    output maps must stay non-decreasing, and the host-side replay of the
    partial-tile exchange must reproduce spmm_ref."""

    rng = np.random.default_rng(0)
    n, d = 400, 32
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160  # mega-window -> split engages
    cols_l = [np.unique(rng.integers(0, n, dd)) for dd in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols_l], out=ptr[1:])
    ptr = ptr.astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    fwd, _ = partition_graph(ptr, cols, n, 4, CFG, split=True)
    sp = fwd.split
    assert sp is not None
    _assert_monotone_output_maps(fwd)

    x = rng.standard_normal((n, d)).astype(np.float32)
    x_full = np.zeros((fwd.padded_nodes, d), np.float32)
    x_full[:n] = x
    want = np.asarray(spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols)))

    g, rows = fwd.num_shards, fwd.rows_per_shard
    gcap, qcap = sp["guest_cap"], sp["pair_cap"]
    blk_h = CFG.blk_h
    wd = fwd.windows_per_shard
    own = np.zeros((g, rows, d), np.float32)
    guests = np.zeros((g, max(gcap, 1), blk_h, d), np.float32)
    for s in range(g):
        out = np.asarray(
            _dense_spmm(
                x_full, sp["a_tiles"][s], sp["col_ids_global"][s],
                sp["block_window"][s], wd + max(gcap, 1),
            )
        )[:, :d]
        own[s] = out[:rows]
        guests[s] = out[rows:].reshape(max(gcap, 1), blk_h, d)
    # host replay of the partial-tile all_to_all + owner scatter-add
    for s in range(g):
        for j in range(max(gcap, 1)):
            pos = int(sp["send_pos"][s, j])
            if pos >= g * qcap:
                continue  # unused slot
            o, lane = divmod(pos, qcap)
            ridx = sp["recv_row_idx"][o].reshape(g, qcap, blk_h)[s, lane]
            assert ridx[0] < rows
            own[o, ridx[0] : ridx[0] + blk_h] += guests[s, j]
    got = own.reshape(-1, d)[:n]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_strict_interpret_split_weighted_spmm_per_shard():
    """Weighted split stream: per-shard tiles rebuilt on host from the
    edge_pos/w_src maps (mirroring the device scatter against the
    all-gathered edge vector), run through the dense-tile kernel,
    exchanged, and checked against the weighted spmm_ref."""

    rng = np.random.default_rng(1)
    n, d = 400, 32
    deg = rng.poisson(4, n).clip(0, n - 1)
    deg[:16] = 160  # mega-window -> split engages
    cols_l = [np.unique(rng.integers(0, n, dd)) for dd in deg]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(c) for c in cols_l], out=ptr[1:])
    ptr = ptr.astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    fwd, _ = partition_graph(ptr, cols, n, 4, CFG, split=True)
    sp = fwd.split
    assert sp is not None and "w_src" in sp

    w = rng.standard_normal(len(cols)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_full = np.zeros((fwd.padded_nodes, d), np.float32)
    x_full[:n] = x
    want = np.asarray(
        spmm_ref(jnp.asarray(x), jnp.asarray(ptr), jnp.asarray(cols), jnp.asarray(w))
    )

    g, rows = fwd.num_shards, fwd.rows_per_shard
    e_max = fwd.edge_capacity
    # forward padded edge layout + trailing zero (the w_src sentinel target)
    w_pad = np.zeros(g * e_max + 1, np.float32)
    es = fwd.edge_start
    for s in range(g):
        w_pad[s * e_max : s * e_max + es[s + 1] - es[s]] = w[es[s] : es[s + 1]]

    gcap, qcap = sp["guest_cap"], sp["pair_cap"]
    blk_h, blk_w = CFG.blk_h, CFG.blk_w
    wd = fwd.windows_per_shard
    bs = sp["a_tiles"].shape[1]
    own = np.zeros((g, rows, d), np.float32)
    guests = np.zeros((g, max(gcap, 1), blk_h, d), np.float32)
    for s in range(g):
        tiles = np.zeros(bs * blk_h * blk_w + 1, np.float32)
        np.add.at(
            tiles, np.minimum(sp["edge_pos"][s], bs * blk_h * blk_w),
            w_pad[sp["w_src"][s]],
        )
        tiles = tiles[:-1].reshape(bs, blk_h, blk_w)
        # scatter-built tiles must structurally match the stacked int8 tiles
        assert ((tiles != 0) <= (np.asarray(sp["a_tiles"][s]) != 0)).all()
        out = np.asarray(
            _dense_spmm(
                x_full, tiles, sp["col_ids_global"][s],
                sp["block_window"][s], wd + max(gcap, 1),
            )
        )[:, :d]
        own[s] = out[:rows]
        guests[s] = out[rows:].reshape(max(gcap, 1), blk_h, d)
    for s in range(g):
        for j in range(max(gcap, 1)):
            pos = int(sp["send_pos"][s, j])
            if pos >= g * qcap:
                continue
            o, lane = divmod(pos, qcap)
            ridx = sp["recv_row_idx"][o].reshape(g, qcap, blk_h)[s, lane]
            assert ridx[0] < rows
            own[o, ridx[0] : ridx[0] + blk_h] += guests[s, j]
    got = own.reshape(-1, d)[:n]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
