"""End-to-end trainer tests (CPU, interpret-mode kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tcgnn.config import TileConfig
from tcgnn.data.dataset import coo_to_csr
from tcgnn.data.synthetic import powerlaw_graph, synthesize
from tcgnn.graph import TiledGraph
from tcgnn.models import nets
from tcgnn.train import make_train_step

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


@pytest.mark.parametrize("kind", ["gcn", "gin"])
def test_loss_decreases(kind):
    n, e, d, classes = 120, 700, 16, 4
    src, dst = powerlaw_graph(n, e, seed=2)
    indptr, indices = coo_to_csr(src, dst, n)
    graph = TiledGraph(indptr, indices, n, CFG, symmetric=True)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, d), dtype=np.float32))
    y = jnp.asarray(rng.integers(0, classes, n).astype(np.int32))

    params = nets.init_net(jax.random.PRNGKey(0), kind, d, 16, classes, 2, init="uniform")
    optimizer = optax.adam(0.01)
    opt_state = optimizer.init(params)
    step = make_train_step(graph, kind, x, y, optimizer, dropout_rate=0.0)

    key = jax.random.PRNGKey(1)
    params, opt_state, key, loss0 = step(params, opt_state, key)
    loss = loss0
    for _ in range(30):
        params, opt_state, key, loss = step(params, opt_state, key)
    assert float(loss) < float(loss0)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("kind", ["gcn", "gin"])
def test_hoisted_l1_aggregate_is_exact(kind):
    """Hoisting A·X out of the epoch loop changes nothing: identical loss
    trajectory (incl. through dropout — same key sequence, same mask)."""
    n, e, d, classes = 120, 700, 16, 4
    src, dst = powerlaw_graph(n, e, seed=3)
    indptr, indices = coo_to_csr(src, dst, n)
    graph = TiledGraph(indptr, indices, n, CFG, symmetric=True)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((n, d), dtype=np.float32))
    y = jnp.asarray(rng.integers(0, classes, n).astype(np.int32))
    optimizer = optax.adam(0.01)

    losses = {}
    for hoist in (False, True):
        params = nets.init_net(
            jax.random.PRNGKey(0), kind, d, 16, classes, 2, init="uniform"
        )
        opt_state = optimizer.init(params)
        step = make_train_step(
            graph, kind, x, y, optimizer, dropout_rate=0.5, hoist=hoist
        )
        key = jax.random.PRNGKey(1)
        traj = []
        for _ in range(6):
            params, opt_state, key, loss = step(params, opt_state, key)
            traj.append(float(loss))
        losses[hoist] = traj
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


def test_synthetic_edge_counts():
    ds = synthesize("pubmed")
    n, e, d, c = 19717, 88648, 500, 3
    assert ds.num_nodes == n
    assert ds.num_features == d
    assert ds.num_classes == c
    # Within 25% of the target edge count after dedup/top-up.
    assert abs(ds.num_edges - e) / e < 0.25
    # Symmetric by construction.
    from tcgnn.sgt.translate import transpose_csr

    t_ptr, t_idx, _ = transpose_csr(ds.row_pointers, ds.column_index, ds.num_nodes)
    np.testing.assert_array_equal(t_ptr, ds.row_pointers)
    np.testing.assert_array_equal(t_idx, ds.column_index)


def test_trainer_cli_smoke(capsys):
    """The CLI runs end-to-end and prints the reference's output contract."""
    from tcgnn import train as train_mod

    train_mod.main(
        [
            "--dataset", "rand_200_1000",
            "--dim", "8", "--hidden", "8", "--classes", "3",
            "--num_layers", "2", "--epochs", "3", "--model", "gcn",
            "--blk_h", "16", "--blk_w", "16", "--edge_chunk", "16",
        ]
    )
    out = capsys.readouterr().out
    assert "Prep. (ms):" in out
    assert "TC_Blocks:" in out
    assert "Train (ms):" in out


def test_step_many_matches_step_chain():
    """The device-side epoch loop (`step.many`) must reproduce the
    dispatch-per-epoch chain exactly: same PRNG split per epoch, same
    params, same loss."""
    import optax

    from tcgnn.config import TileConfig
    from tcgnn.data.synthetic import synthesize
    from tcgnn.graph import TiledGraph
    from tcgnn.models import nets

    ds = synthesize("rand_500_2500", dim=12, num_classes=3, seed=0)
    cfg = TileConfig(blk_h=32, blk_w=32, edge_chunk=32)
    g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, cfg)
    x = jnp.asarray(ds.x)
    y = jnp.asarray(ds.y.astype(np.int32))
    opt = optax.adam(0.01)
    step = make_train_step(g, "gcn", x, y, opt, dropout_rate=0.5)

    def fresh():
        p = nets.init_net(jax.random.PRNGKey(0), "gcn", 12, 8, 3, 2)
        return p, opt.init(p), jax.random.PRNGKey(7)

    p1, o1, k1 = fresh()
    for _ in range(4):
        p1, o1, k1, loss1 = step(p1, o1, k1)
    p2, o2, k2 = fresh()
    p2, o2, k2, loss2 = step.many(p2, o2, k2, 4)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_auto_block_group_resolution():
    """block_group=0 resolves per graph: dense windows -> 2, sparse -> 1;
    explicit values pass through untouched."""
    from tcgnn.config import TileConfig
    from tcgnn.data.synthetic import synthesize
    from tcgnn.graph import TiledGraph

    # dense windows: a small dense-ish random graph has many blocks/window
    ds = synthesize("rand_2000_80000", dim=8, num_classes=2, seed=1)
    g = TiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes,
        TileConfig(blk_h=128, blk_w=128, edge_chunk=64, block_group=0),
    )
    assert g.config.block_group in (1, 2)
    g2 = TiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes,
        TileConfig(blk_h=128, blk_w=128, edge_chunk=64, block_group=1),
    )
    assert g2.config.block_group == 1
    # grouped and ungrouped agree numerically
    x = jnp.asarray(ds.x)
    np.testing.assert_allclose(
        np.asarray(g.spmm(x)), np.asarray(g2.spmm(x)), rtol=1e-4, atol=1e-4
    )
