"""Measured collective bytes (parallel.comm_stats) — instrumented scaling.

Reconciles the *measured* per-step collective traffic (parsed from the
compiled HLO) with the partition model (bench.partition_stats): the halo
all_to_all must move boundary-row volume, not full feature matrices, and
a bandwidth-ordered (banded) graph must move far less than a random one
on the same node/edge budget.
"""

import numpy as np
import optax
import pytest

import jax

from tcgnn.config import TileConfig
from tcgnn.data import synthetic
from tcgnn.data.dataset import coo_to_csr
from tcgnn.parallel import make_mesh
from tcgnn.parallel.comm_stats import (
    collective_bytes_from_hlo,
    step_collective_bytes,
)
from tcgnn.parallel.graph import DistributedTiledGraph
from tcgnn.parallel.train import (
    init_distributed_net,
    make_distributed_train_step,
)

CFG = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)


def _step_stats(ptr, cols, n, mesh, dim=16, classes=4, kind="gcn"):
    dg = DistributedTiledGraph(ptr, cols, n, mesh, CFG)
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((n, dim)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, classes, n).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), kind, x.shape[1], 8, classes, 2, dg
    )
    opt = optax.adam(0.01)
    step = make_distributed_train_step(
        dg, kind, x, y, opt, 0.0, num_valid_classes=classes
    )
    return (
        step_collective_bytes(
            step, params, opt.init(params), jax.random.PRNGKey(1),
            num_devices=mesh.size,
        ),
        dg,
    )


def _banded(n, halfband=12, seed=0):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), 4)
    dst = src + rng.integers(1, halfband, size=len(src))
    keep = dst < n
    src, dst = src[keep], dst[keep]
    return coo_to_csr(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n
    )


def test_hlo_parser_counts_shapes():
    hlo = """
  a = f32[128,64]{1,0} all-to-all(b), dimensions={0}
  c = (f32[16,8]{1,0}, f32[16,8]{1,0}) all-to-all(x, y)
  d = bf16[256]{0} all-gather-start(e), dimensions={0}
  d2 = bf16[256]{0} all-gather-done(d)
  f = f32[4]{0} all-reduce(g), to_apply=sum
  h = s32[10]{0} collective-permute(i), source_target_pairs={{0,1}}
"""
    s = collective_bytes_from_hlo(hlo)
    assert s["all_to_all"]["count"] == 2
    assert s["all_to_all"]["bytes"] == 128 * 64 * 4 + 2 * 16 * 8 * 4
    assert s["all_gather"] == {"count": 1, "bytes": 512}
    assert s["all_reduce"]["bytes"] == 16
    assert s["collective_permute"]["bytes"] == 40


def test_step_emits_collectives_and_boundary_scale(mesh42):
    """Random graph: the step must contain all_to_alls, and their measured
    bytes must sit within a small factor of the modeled boundary volume
    (boundary rows x padded width x 4 bytes x a handful of ops) — far
    below full-feature-matrix exchange."""
    ds = synthetic.synthesize("rand_4000_32000", 16, 4)
    stats, dg = _step_stats(
        ds.row_pointers, ds.column_index, ds.num_nodes, mesh42
    )
    # Halo rides per-offset collective-permutes (one per owner offset per
    # pass); split partial-tile returns, when present, are all_to_alls.
    assert stats["collective_permute"]["count"] >= 2  # fwd + bwd halos
    from tcgnn.bench.partition_stats import shard_stats

    rows_per_shard, shards = shard_stats(
        ds.row_pointers, ds.column_index, ds.num_nodes, dg.pg, config=CFG
    )
    boundary_total = sum(s["boundary"] for s in shards)
    # Per-op modeled volume; the step runs a handful of halo ops (layers x
    # fwd/bwd).  Sharded width is dim padded over the feature axis.
    # Measured bytes are the PER-DEVICE average (partial permutes weighted
    # by active-pair fraction), so the floor divides by the graph shards.
    per_op = boundary_total * 8 * 4 // dg.pg
    measured = (
        stats["collective_permute"]["bytes"] + stats["all_to_all"]["bytes"]
    )
    assert measured >= per_op, (measured, per_op)
    assert measured <= 40 * per_op, (measured, per_op)
    # The quantized partial-pair rounds bound the wire volume near the
    # ideal boundary: scheduled rows (sz x active pairs summed over
    # rounds) vs the exact per-pair sum — and always <= the former
    # global-max all_to_all padding.
    halo = dg.host_fwd.halo
    ideal = int(halo["pair_counts"].sum())
    n_pairs = int((halo["pair_counts"] > 0).sum())
    wire = sum(sz * len(pairs) for _, sz, pairs in halo["rounds"])
    global_max = dg.pg * dg.pg * int(halo["capacity"])
    assert wire <= global_max, (wire, global_max)
    assert wire <= 1.25 * ideal + 64 * n_pairs, (wire, ideal)


def test_banded_moves_less_than_random(mesh42):
    """Boundary-only exchange, instrumented: a banded graph's halo bytes
    must be a small fraction of a same-size random graph's."""
    n = 4096
    ptr_b, cols_b = _banded(n)
    s_band, _ = _step_stats(ptr_b, cols_b, n, mesh42)
    ds = synthetic.synthesize(f"rand_{n}_{len(cols_b)}", 16, 4)
    s_rand, _ = _step_stats(
        ds.row_pointers, ds.column_index, ds.num_nodes, mesh42
    )

    def halo_bytes(s):
        return s["collective_permute"]["bytes"] + s["all_to_all"]["bytes"]

    assert halo_bytes(s_band) * 4 < halo_bytes(s_rand), (
        s_band["collective_permute"],
        s_rand["collective_permute"],
    )


@pytest.fixture
def mesh42():
    return make_mesh(n_graph=4, n_feature=2)


def test_two_level_mesh_dcn_fraction_and_step():
    """make_mesh_two_level: same axes, host-major placement; on a banded
    graph the measured halo pair matrix puts only a small fraction of rows
    on DCN (host-crossing pairs), and the step trains correctly."""
    from tcgnn.parallel.comm_stats import dcn_halo_fraction
    from tcgnn.parallel.mesh import make_mesh_two_level

    mesh = make_mesh_two_level(n_hosts=2, chips_per_host=4, n_feature=1)
    assert dict(mesh.shape) == {"graph": 8, "feature": 1}
    n = 8192
    ptr, cols = _banded(n)
    # block_diag=False: exercise the build_halo path (the BD path's rim
    # ppermutes are nearest-neighbor by construction — nothing to measure).
    dg = DistributedTiledGraph(ptr, cols, n, mesh, CFG, block_diag=False)
    pc = dg.host_fwd.halo["pair_counts"]
    frac = dcn_halo_fraction(pc, chips_per_host=4)
    # band halfband=12 << rows/shard: halo is nearest-neighbor only, and
    # exactly one of the 7 neighboring shard pairs crosses the host split.
    assert 0.0 < frac < 0.35, (frac, pc.sum())
    # the step itself is placement-agnostic: loss decreases.
    rng = np.random.default_rng(0)
    x = dg.shard_features(rng.standard_normal((n, 16)).astype(np.float32))
    y = dg.shard_nodes(rng.integers(0, 4, n).astype(np.int32))
    params, _, _ = init_distributed_net(
        jax.random.PRNGKey(0), "gcn", x.shape[1], 8, 4, 2, dg
    )
    opt = optax.adam(0.01)
    st = opt.init(params)
    step = make_distributed_train_step(
        dg, "gcn", x, y, opt, 0.0, num_valid_classes=4
    )
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(4):
        params, st, key, loss = step(params, st, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_hlo_parser_async_start_counts_result_only():
    hlo = """
  ag = (f32[8,256]{1,0}, f32[32,256]{1,0}) all-gather-start(x), dimensions={0}
  ag2 = f32[32,256]{1,0} all-gather-done(ag)
"""
    s = collective_bytes_from_hlo(hlo)
    assert s["all_gather"] == {"count": 1, "bytes": 32 * 256 * 4}


def test_collective_bytes_raw_hlo_fixture():
    """Pin the HLO text-format parsing against a handwritten fixture so an
    XLA dump-format drift fails loudly (round-3 advisor finding)."""
    import warnings

    from tcgnn.parallel.comm_stats import collective_bytes_from_hlo

    hlo = """\
HloModule jit_step

%fused_computation (p0: f32[8,16]) -> f32[8,16] {
  ROOT %r = f32[8,16] add(%p0, %p0)
}

ENTRY %main (a: f32[4,32]) -> f32[4,32] {
  %a2a = (f32[1,2,32]{2,1,0}, f32[1,2,32]{2,1,0}) all-to-all(%s0, %s1), replica_groups={}
  %ags = (f32[2,32]{1,0}, f32[8,32]{1,0}) all-gather-start(%a), dimensions={0}
  %agd = f32[8,32]{1,0} all-gather-done(%ags)
  %ar = f32[4,32]{1,0} all-reduce(%agd2), to_apply=%sum
  ROOT %out = f32[4,32]{1,0} copy(%ar)
}
"""
    s = collective_bytes_from_hlo(hlo)
    assert s["all_to_all"] == {"count": 1, "bytes": 2 * 2 * 32 * 4}
    # async all-gather: only the RESULT element (f32[8,32]) is counted
    assert s["all_gather"] == {"count": 1, "bytes": 8 * 32 * 4}
    assert s["all_reduce"] == {"count": 1, "bytes": 4 * 32 * 4}
    assert "_flags" not in s

    hlo_loop = hlo.replace(
        "%fused_computation (p0: f32[8,16]) -> f32[8,16] {",
        "%body.1 (p0: f32[8,16]) -> f32[8,16] {\n"
        "  %lar = f32[8,16]{1,0} all-reduce(%p0), to_apply=%sum",
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s2 = collective_bytes_from_hlo(hlo_loop)
    assert s2.get("_flags", {}).get("in_loop_body") == 1
    assert any("while-loop body" in str(x.message) for x in w)
