"""Multi-chip scaling-efficiency benchmark (edges/s vs mesh size).

The north-star distributed metric (BASELINE.md: >=80% edges/s scaling
efficiency from 1 chip to N): run the same full-graph training step on
('graph' x 'feature') meshes of growing size over the available devices and
report edges/s plus efficiency vs the 1-device run.

On a virtual-CPU mesh this exercises the full distributed code path and the
*collective/overhead* scaling shape only; times mean something only on real
devices (the four-GPU host, same code).

Run (virtual 8-device mesh):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m tcgnn.bench.scaling --dataset rand_20000_100000 --tile 32 32 32
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax


def measure(mesh_shape, ds, cfg, model, hidden, epochs, seed=0):
    from tcgnn.parallel import (
        make_mesh,
        distributed_graph_from_dataset,
        init_distributed_net,
        make_distributed_train_step,
    )

    ng, nf = mesh_shape
    mesh = make_mesh(n_graph=ng, n_feature=nf)
    graph = distributed_graph_from_dataset(ds, mesh, cfg)
    x = graph.shard_features(ds.x)
    y = graph.shard_nodes(ds.y.astype(np.int32))
    params, _, classes_p = init_distributed_net(
        jax.random.PRNGKey(seed), model, x.shape[1], hidden, ds.num_classes, 2, graph
    )
    opt = optax.adam(0.01)
    step = make_distributed_train_step(
        graph, model, x, y, opt, dropout_rate=0.0,
        num_valid_classes=ds.num_classes,
    )
    state = opt.init(params)
    key = jax.random.PRNGKey(seed + 1)
    for _ in range(3):
        params, state, key, loss = step(params, state, key)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(epochs):
        params, state, key, loss = step(params, state, key)
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / epochs
    return dt, ds.num_edges / dt


def main(argv=None):
    from tcgnn.config import TileConfig
    from tcgnn.train import build_argparser, load_dataset

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="rand_20000_100000")
    p.add_argument("--model", default="gcn", choices=["gcn", "gin", "agnn"])
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--n_feature", type=int, default=1)
    p.add_argument("--data_dir", default="tcgnn-ae-graphs/")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--tile", type=int, nargs=3, default=None, metavar=("H", "W", "EC"),
        help="tile geometry blk_h blk_w edge_chunk (default: TileConfig's); "
        "small tiles keep virtual-CPU meshes fast",
    )
    args = p.parse_args(argv)

    ds = load_dataset(args)
    cfg = (
        TileConfig()
        if args.tile is None
        else TileConfig(blk_h=args.tile[0], blk_w=args.tile[1],
                        edge_chunk=args.tile[2])
    )

    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s * args.n_feature <= n_dev]
    base = None
    print("devices,epoch_ms,edges_per_s,efficiency")
    for s in sizes:
        dt, eps = measure((s, args.n_feature), ds, cfg, args.model, args.hidden, args.epochs, args.seed)
        if base is None:
            base = eps
        eff = eps / (base * s)
        print(f"{s * args.n_feature},{dt*1e3:.3f},{eps:.3e},{eff:.3f}")


if __name__ == "__main__":
    main()
