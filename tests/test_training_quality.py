"""Learnability / normalization / checkpoint tests (accuracy-level checks).

The reference has no accuracy verification at all (its labels are all-ones,
dataset.py:122, and PyG's ``test()`` is dead code).  Here a planted
community task must actually be *learned* by the GCN through the Pallas
aggregation path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tcgnn.config import TileConfig
from tcgnn.data.synthetic import synthesize
from tcgnn.graph import tiled_graph_from_dataset
from tcgnn.models import nets
from tcgnn.train import make_train_step
from tcgnn.utils import checkpoint as ckpt

CFG = TileConfig(blk_h=16, blk_w=16, edge_chunk=16)


def _train(ds, graph, kind="gcn", epochs=200, hidden=16, norm=None, seed=0):
    x = jnp.asarray(ds.x)
    y = jnp.asarray(ds.y.astype(np.int32))
    key = jax.random.PRNGKey(seed)
    key, ik = jax.random.split(key)
    params = nets.init_net(
        ik, kind, ds.num_features, hidden, ds.num_classes, 2, init="uniform"
    )
    opt = optax.adam(0.01)
    state = opt.init(params)
    step = make_train_step(graph, kind, x, y, opt, dropout_rate=0.0, norm=norm)
    for _ in range(epochs):
        params, state, key, loss = step(params, state, key)
    return params, float(loss)


def _accuracy(params, ds, graph, mask, kind="gcn", norm=None):
    logp = nets.apply_net(params, kind, jnp.asarray(ds.x), graph, norm=norm)
    pred = np.asarray(jnp.argmax(logp, axis=1))
    return float((pred[mask] == ds.y[mask]).mean())


def test_gcn_learns_planted_communities():
    ds = synthesize("planted_600_4000", dim=16, num_classes=4, seed=0)
    graph = tiled_graph_from_dataset(ds, CFG)
    params, loss = _train(ds, graph)
    acc = _accuracy(params, ds, graph, ds.test_mask)
    assert acc > 0.75, f"GCN failed to learn planted task: test acc {acc}"


def test_gcn_norm_changes_and_still_learns():
    ds = synthesize("planted_600_4000", dim=16, num_classes=4, seed=1)
    graph = tiled_graph_from_dataset(ds, CFG)
    norm = jnp.asarray(1.0 / ds.norm_degrees())
    params, _ = _train(ds, graph, norm=norm)
    acc = _accuracy(params, ds, graph, ds.test_mask, norm=norm)
    assert acc > 0.75, acc
    # normalization must actually alter the forward pass
    a = nets.apply_net(params, "gcn", jnp.asarray(ds.x), graph, norm=norm)
    b = nets.apply_net(params, "gcn", jnp.asarray(ds.x), graph)
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip(tmp_path):
    ds = synthesize("planted_400_2500", dim=8, num_classes=3, seed=2)
    graph = tiled_graph_from_dataset(ds, CFG)
    params, _ = _train(ds, graph, epochs=10)
    path = os.path.join(str(tmp_path), "params")
    written = ckpt.save(path, params)
    like = jax.tree.map(jnp.zeros_like, params)
    restored = ckpt.restore(written, like)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    params = [{"weights": jnp.ones((4, 3))}]
    path = ckpt.save(os.path.join(str(tmp_path), "p"), params)
    bad = [{"weights": jnp.ones((5, 3))}]
    if path.endswith(".npz"):
        import pytest

        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore(path, bad)


def test_state_checkpoint_roundtrip_and_latest(tmp_path):
    """save_state/restore_state: params + optimizer + epoch round-trip
    exactly; LATEST always points at the newest complete checkpoint."""
    import optax

    params = [{"weights": jnp.arange(12.0).reshape(3, 4)}]
    opt = optax.adam(0.01)
    st = opt.init(params)
    d = str(tmp_path / "ck")
    ckpt.save_state(d, params, st, epoch=2)
    params2 = jax.tree.map(lambda a: a + 1.0, params)
    ckpt.save_state(d, params2, st, epoch=4)
    # pruning: keep=3 default retains all here; keep=1 drops the older one
    ckpt.save_state(d, params2, st, epoch=6, key=jax.random.PRNGKey(3), keep=1)
    import os
    snaps = [f for f in os.listdir(d) if f.startswith("state_")]
    assert snaps == ["state_00000006.npz"], snaps
    got6 = ckpt.restore_state(d, params, st)
    assert got6[2] == 6 and got6[3] is not None
    np.testing.assert_array_equal(np.asarray(got6[3]), np.asarray(jax.random.PRNGKey(3)))
    ckpt.save_state(d, params, st, epoch=2)
    ckpt.save_state(d, params2, st, epoch=4)
    got = ckpt.restore_state(d, params, st)
    assert got is not None
    rp, rs, epoch, saved_key = got
    assert epoch == 4 and saved_key is None
    np.testing.assert_allclose(rp[0]["weights"], np.asarray(params2[0]["weights"]))
    # optimizer state round-trips leaf-exactly (incl. the int step count)
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ckpt.restore_state(str(tmp_path / "empty"), params, st) is None


def test_trainer_resume_continues_from_checkpoint(tmp_path, capsys):
    """Failure-recovery drive: train with periodic checkpoints, then
    'crash' (a second invocation) and --resume — the run picks up at the
    saved epoch, runs only the remaining epochs, and ends with a loss in
    the same regime."""
    from tcgnn import train as train_mod

    d = str(tmp_path / "ck")
    args = [
        "--dataset", "rand_600_3000", "--dim", "8", "--classes", "3",
        "--hidden", "8", "--epochs", "6", "--model", "gcn",
        "--blk_h", "32", "--blk_w", "32", "--edge_chunk", "32",
        "--checkpoint_dir", d, "--checkpoint_every", "2",
    ]
    train_mod.main(args)
    assert (tmp_path / "ck" / "LATEST").exists()
    capsys.readouterr()
    train_mod.main(args + ["--resume", "--epochs", "8"])
    out = capsys.readouterr().out
    assert "# resumed at epoch 6" in out
    assert "Final loss" in out
