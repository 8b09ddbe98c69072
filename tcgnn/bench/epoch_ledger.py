"""Measured per-stage epoch ledger.

Decomposes one training epoch into stages and MEASURES each stage as its
own in-program differenced chain (the same methodology as the epoch
number itself: N rounds inside one compiled ``fori_loop`` with a dynamic
trip count, long-minus-short chain differencing, each timing ending in
``block_until_ready``).  Every row of the table is a measured number,
and the stages must SUM to the measured epoch (the residual
column shows what composition costs/saves — XLA fuses and pipelines
across stage boundaries, so a small +/- residual is expected).

Stages for a 2-layer GCN/GIN no-hoist epoch (the headline configuration,
reference ``main_tcgnn.py:146-151``):

  * ``spmm@din``  — layer-1 aggregation at the input width
  * ``spmm@h``    — layer-2 aggregation at the hidden width
  * ``spmm_t@h``  — the backward pass's transpose aggregation A^T dy
  * ``dense_rest``— everything else: dense GEMMs, ReLU/dropout, loss,
                    log-softmax, NLL + Adam — measured by running the FULL
                    epoch chain with every aggregation stubbed to identity
                    (same shapes, same dense op sequence)

Run:  python -m tcgnn.bench.epoch_ledger --dataset DD --datasets ...
Writes ``epoch_ledger.csv`` (one row per dataset) and prints the table.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tcgnn import train as T
from tcgnn.bench.datasets import AE_TABLE, GCN_CONFIG
from tcgnn.config import TileConfig
from tcgnn.graph import TiledGraph
from tcgnn.models import nets
from tcgnn.models.layers import gcn_aggregates_first


class _IdentityGraph:
    """Duck-typed TiledGraph whose aggregations are identity.

    Running the real epoch step over this stub executes exactly the dense
    remainder of the epoch (GEMMs at the true shapes, ReLU, dropout mask,
    log-softmax, NLL, Adam) with zero aggregation cost — identity's VJP is
    identity, so the backward dense ops run at true shapes too.
    """

    def __init__(self, real: TiledGraph):
        self.config = real.config
        self.block_diag = real.block_diag
        self.dense_tiles = real.dense_tiles
        self.streamed = real.streamed
        self.num_nodes = real.num_nodes
        self.num_edges = real.num_edges

    def arrays(self):
        return ()

    def bind(self, _garr):
        return self

    def spmm(self, x):
        return x

    def spmm_t(self, dy):
        return dy

    def spmm_weighted(self, x, w):
        # Shape-faithful stand-in: weights gate row 0's scale only (cheap,
        # keeps w in the graph so grads flow where the real epoch has them).
        return x * (1.0 + 0.0 * jnp.sum(w)).astype(x.dtype)

    def sddmm(self, x):
        return jnp.zeros((self.num_edges,), jnp.float32) + jnp.sum(
            x[:1, :1]
        ).astype(jnp.float32)

    agnn_aggregate = None


def _epoch_chain_runner(step, params, opt_state, key):
    """run(n) for _timed_scan_rounds over a donating step.many chain."""
    state = [params, opt_state, key]

    def run(n):
        p, o, k, loss = step.many(state[0], state[1], state[2], n)
        state[0], state[1], state[2] = p, o, k
        return loss

    return run


def _spmm_chain_s(graph, width, rounds, transpose=False):
    """Seconds per aggregation pass at ``width`` (chain-differenced)."""
    garr = graph.arrays()
    ct = graph.config.compute_dtype
    x = jnp.zeros((graph.num_nodes, width), ct) + jnp.asarray(0.01, ct)

    @jax.jit
    def chain(garr, x, n):
        g = graph.bind(garr)
        op = g.spmm_t if transpose else g.spmm
        out = jax.lax.fori_loop(0, n, lambda i, c: op(c).astype(c.dtype), x)
        return jnp.sum(out[:1, :1].astype(jnp.float32))

    n_lo = max(rounds // 10, 2)
    return T._timed_scan_rounds(lambda n: chain(garr, x, n), n_lo, rounds)


def _agg_stages(graph, kind, din, hidden, classes, num_layers):
    """The epoch's aggregation passes as (label, width, transpose) tuples.

    Per layer (in->out): aggregate-first runs A at the IN width and the
    backward transpose at the same width; project-first runs A at the OUT
    width (+ transpose).  Layer 1's input carries no gradient, so its
    backward transpose exists only on the project-first schedule (the
    aggregate feeds dW1 through the saved forward value).  GIN always
    aggregates first (gin_conv).
    """
    dims = [din] + [hidden] * max(num_layers - 1, 0)
    dims = dims[:num_layers] + [classes]
    stages = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        first = True if kind == "gin" else gcn_aggregates_first(graph, d_in, d_out)
        w = d_in if first else d_out
        stages.append((f"spmm@L{i + 1}", w, False))
        if i > 0 or not first:
            stages.append((f"spmm_t@L{i + 1}", w, True))
    return stages


def ledger_for(ds, args):
    cfg = TileConfig(
        blk_h=args.blk_h, blk_w=args.blk_w,
        compute_dtype=jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32,
        block_group=0,
    )
    graph = TiledGraph(
        ds.row_pointers, ds.column_index, ds.num_nodes, cfg,
        weighted_traffic=False,
    )
    x = jnp.asarray(ds.x)
    y = jnp.asarray(ds.y.astype(np.int32))
    optimizer = optax.adam(0.01)

    def epoch_ms(g):
        params = nets.init_net(
            jax.random.PRNGKey(0), args.model, ds.num_features, args.hidden,
            ds.num_classes, args.num_layers,
        )
        opt_state = optimizer.init(params)
        step = T.make_train_step(
            g, args.model, x, y, optimizer, dropout_rate=0.5, hoist=False
        )
        key = jax.random.PRNGKey(1)
        params, opt_state, key, loss = step.many(params, opt_state, key, 5)
        jax.block_until_ready(loss)
        run = _epoch_chain_runner(step, params, opt_state, key)
        n_lo = max(args.epochs // 10, 2)
        return T._timed_scan_rounds(run, n_lo, args.epochs) * 1e3

    rounds = args.epochs
    row = {"dataset": args.dataset}
    row["epoch_ms"] = epoch_ms(graph)
    row["dense_rest_ms"] = epoch_ms(_IdentityGraph(graph))
    stages = _agg_stages(
        graph, args.model, ds.num_features, args.hidden, ds.num_classes,
        args.num_layers,
    )
    # Measure each unique (width, transpose) signature once; identical
    # passes cost the same program.
    cache = {}
    agg_total = 0.0
    details = []
    for label, width, transpose in stages:
        sig = (width, transpose)
        if sig not in cache:
            cache[sig] = _spmm_chain_s(graph, width, rounds, transpose) * 1e3
        details.append((label, width, cache[sig]))
        agg_total += cache[sig]
    row["agg_stages"] = details
    row["agg_ms"] = agg_total
    total = row["dense_rest_ms"] + agg_total
    row["stage_sum_ms"] = total
    row["residual_ms"] = row["epoch_ms"] - total
    row["residual_pct"] = 100.0 * row["residual_ms"] / row["epoch_ms"]
    return row


COLUMNS = (
    "dataset", "epoch_ms", "agg_ms", "dense_rest_ms", "stage_sum_ms",
    "residual_ms", "residual_pct", "agg_stages",
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="*", default=["DD", "amazon0601"])
    p.add_argument("--model", default="gcn", choices=["gcn", "gin"])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--hidden", type=int, default=GCN_CONFIG["hidden"])
    p.add_argument("--num_layers", type=int, default=GCN_CONFIG["num_layers"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--reorder", default="rcm")
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--blk_h", type=int, default=512)
    p.add_argument("--blk_w", type=int, default=128)
    p.add_argument("--out", default="epoch_ledger.csv")
    args = p.parse_args(argv)

    dims = {n: (d, c) for n, d, c in AE_TABLE}
    rows = []
    with open(args.out, "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for name in args.datasets:
            dim, classes = dims.get(name, (96, 10))
            largs = argparse.Namespace(
                dataset=name, data_dir=args.data_dir, dim=dim,
                classes=classes, seed=0,
            )
            ds = T.load_dataset(largs)
            if args.reorder != "none":
                from tcgnn.sgt.reorder import reorder_dataset

                reorder_dataset(ds, args.reorder)
            args.dataset = name
            print(f"=== {name} ===", flush=True)
            t0 = time.perf_counter()
            row = ledger_for(ds, args)
            row["dataset"] = name
            rows.append(row)
            agg_str = " + ".join(
                f"{lbl}[w{w}]={ms:.3f}" for lbl, w, ms in row["agg_stages"]
            )
            f.write(",".join(
                row[c] if c == "dataset"
                else (agg_str.replace(",", ";") if c == "agg_stages"
                      else f"{row[c]:.3f}")
                for c in COLUMNS
            ) + "\n")
            f.flush()
            print(
                "  epoch {epoch_ms:8.3f} = [{agg}] + "
                "dense_rest {dense_rest_ms:.3f}  "
                "(residual {residual_ms:+.3f} ms / {residual_pct:+.1f}%)  "
                "[{t:.0f}s]".format(
                    t=time.perf_counter() - t0, agg=agg_str, **row
                ),
                flush=True,
            )
            jax.clear_caches()
            gc.collect()
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
