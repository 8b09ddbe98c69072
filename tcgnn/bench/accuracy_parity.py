"""Accuracy-parity harness: tiled kernels vs a dense oracle, end to end.

The north star in BASELINE.md is TC-GNN-parity *accuracy* on real-label
graphs.  No real Planetoid ``.npz`` ships in this environment, so this
script pre-validates the whole path on a checked-in golden fixture in the
reference's exact ``.npz`` contract (``/root/reference/dataset.py:69-83``
plus the labeled-extension keys) — the moment a real ``cora.npz`` etc.
appears, the same command produces the parity numbers:

    python -m tcgnn.bench.accuracy_parity [--npz path/to/graph.npz]
                                              [--models gcn agnn]

For each model it:
  1. builds the SGT-tiled graph AND a dense ``A @ X`` oracle graph;
  2. checks forward logits agree (allclose) on identical params —
     covering every layer's aggregation composed;
  3. trains both with the same schedule (Adam 0.01, masked NLL on
     ``train_mask``, symmetric GCN normalization) and reports train/test
     accuracy side by side;
  4. exits nonzero on any parity failure.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


class DenseOracleGraph:
    """Duck-typed oracle: the ops surface of TiledGraph over a dense A.

    Small graphs only (materializes [N, N]); the ground truth the kernel
    paths are judged against (SURVEY.md §4 oracle strategy).
    """

    def __init__(self, row_pointers, column_index, num_nodes):
        import jax.numpy as jnp

        a = np.zeros((num_nodes, num_nodes), np.float32)
        rows = np.repeat(
            np.arange(num_nodes), np.diff(np.asarray(row_pointers))
        )
        np.add.at(a, (rows, np.asarray(column_index)), 1.0)
        self._a = jnp.asarray(a)
        self._rows = jnp.asarray(rows.astype(np.int32))
        self._cols = jnp.asarray(np.asarray(column_index, np.int32))
        self.num_nodes = num_nodes
        self.num_edges = len(column_index)
        self.agnn_aggregate = None  # layers fall back to sddmm+weighted

    def spmm(self, x):
        return self._a @ x

    def spmm_weighted(self, x, w):
        import jax.numpy as jnp

        aw = jnp.zeros_like(self._a).at[self._rows, self._cols].add(w)
        return aw @ x

    def sddmm(self, x):
        import jax.numpy as jnp

        return jnp.sum(x[self._rows] * x[self._cols], axis=1)


def run_model(kind, ds, graph, norm, epochs, hidden, seed=0):
    import jax
    import jax.numpy as jnp
    import optax

    from tcgnn.models import nets

    params = nets.init_net(
        jax.random.PRNGKey(seed), kind, ds.x.shape[1], hidden,
        int(ds.y.max()) + 1, 2, init="uniform",
    )
    x = jnp.asarray(ds.x)
    y = jnp.asarray(ds.y.astype(np.int32))
    train_mask = jnp.asarray(ds.train_mask)
    optimizer = optax.adam(0.01)
    opt_state = optimizer.init(params)

    def loss_fn(p):
        logp = nets.apply_net(p, kind, x, graph, norm=norm)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * train_mask) / jnp.sum(train_mask)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    for _ in range(epochs):
        params, opt_state, _ = step(params, opt_state)
    # Loss of the FINAL params (the same state the accuracies use).
    loss = loss_fn(params)

    logp = nets.apply_net(params, kind, x, graph, norm=norm)
    pred = np.asarray(jnp.argmax(logp, axis=1))
    yy = np.asarray(ds.y)

    def acc(mask):
        m = np.asarray(mask)
        return float((pred[m] == yy[m]).mean()) if m.any() else float("nan")

    return params, float(loss), acc(ds.train_mask), acc(ds.test_mask)


def main(argv=None):
    p = argparse.ArgumentParser()
    default_npz = os.path.join(
        os.path.dirname(__file__), "..", "..", "tests", "fixtures",
        "golden_tiny.npz",
    )
    p.add_argument("--npz", default=None)
    p.add_argument(
        "--data_dir", default="tcgnn-ae-graphs/",
        help="scanned for real labeled graphs (cora/citeseer/pubmed "
        ".npz with x/y keys); the first hit is preferred over the "
        "golden fixture automatically",
    )
    p.add_argument("--models", nargs="*", default=["gcn", "agnn"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=16)
    args = p.parse_args(argv)

    if args.npz is None:
        # Prefer real drop-in graphs the moment they appear (README:
        # "Real-data drop-in") — flagged by the loader's provenance line.
        for name in ("cora", "citeseer", "pubmed"):
            cand = os.path.join(args.data_dir, name + ".npz")
            if os.path.exists(cand):
                args.npz = cand
                break
        else:
            args.npz = default_npz

    import jax
    import jax.numpy as jnp

    from tcgnn.data import dataset as data_lib
    from tcgnn.graph import TiledGraph
    from tcgnn.models import nets

    ds = data_lib.load_npz(args.npz, dim=16, num_classes=2)
    print(
        f"graph: {ds.num_nodes} nodes, {ds.num_edges} edges, "
        f"dim {ds.x.shape[1]}, classes {int(ds.y.max()) + 1}"
    )
    tiled = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes)
    oracle = DenseOracleGraph(ds.row_pointers, ds.column_index, ds.num_nodes)
    norm = jnp.asarray(1.0 / ds.norm_degrees())

    failures = 0
    for kind in args.models:
        # 1) forward logits parity on identical params (all layers composed)
        params = nets.init_net(
            jax.random.PRNGKey(7), kind, ds.x.shape[1], args.hidden,
            int(ds.y.max()) + 1, 2, init="uniform",
        )
        x = jnp.asarray(ds.x)
        use_norm = norm if kind == "gcn" else None
        lt = np.asarray(nets.apply_net(params, kind, x, tiled, norm=use_norm))
        lo = np.asarray(nets.apply_net(params, kind, x, oracle, norm=use_norm))
        fwd_ok = np.allclose(lt, lo, rtol=1e-3, atol=1e-3)

        # 2) trained accuracy parity
        _, loss_t, tr_t, te_t = run_model(
            kind, ds, tiled, use_norm, args.epochs, args.hidden
        )
        _, loss_o, tr_o, te_o = run_model(
            kind, ds, oracle, use_norm, args.epochs, args.hidden
        )
        acc_ok = abs(te_t - te_o) <= 0.05
        ok = fwd_ok and acc_ok
        failures += 0 if ok else 1
        print(
            f"{kind:5s} fwd_allclose={fwd_ok}  "
            f"tiled: loss={loss_t:.4f} train_acc={tr_t:.3f} test_acc={te_t:.3f}  "
            f"oracle: loss={loss_o:.4f} train_acc={tr_o:.3f} test_acc={te_o:.3f}  "
            f"{'OK' if ok else 'FAIL'}"
        )
    return failures


if __name__ == "__main__":
    sys.exit(main())
