"""Headline benchmark: GCN full-graph training epoch time vs the reference.

Reproduces the reference's flagship configuration — 2-layer GCN, hidden 16,
200 timed epochs after 10 warm-ups (``/root/reference/1_bench_gcn.py:5-7``,
``main_tcgnn.py:166-181``) — on a pubmed-scale graph, in bf16 on one GPU,
and compares the average epoch time against the reference's archived
RTX3090 measurement (``/root/reference/logs/RTX3090_GCN.csv:4`` → 2.793 ms;
see BASELINE.md).  AGNN (4 layers, hidden 32, the reference's
``1_bench_agnn.py`` configuration) is timed on the same graph.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": speedup, ...}
(vs_baseline > 1 means faster than the reference GPU).  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_MS = 2.793  # RTX3090, GCN 2L h16, pubmed (logs/RTX3090_GCN.csv:4)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX runs on {dev.platform!r}")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from tcgnn.config import TileConfig
    from tcgnn.data import synthetic
    from tcgnn.graph import tiled_graph_from_dataset
    from tcgnn.models import nets
    from tcgnn.train import make_train_step

    # pubmed scale: 19717 nodes / 88k edges / dim 500 / 3 classes
    # (1_bench_gcn.py:12, dataset table in SURVEY.md §6).
    ds = synthetic.synthesize("pubmed", seed=0)
    cfg = TileConfig(compute_dtype=jnp.bfloat16)

    t0 = time.perf_counter()
    graph = tiled_graph_from_dataset(ds, cfg)
    prep_ms = (time.perf_counter() - t0) * 1e3
    # Warm prep: a second build in the same process, with the scatter and
    # upload executables already compiled — what a long-lived service pays
    # per graph.
    t0 = time.perf_counter()
    graph = tiled_graph_from_dataset(ds, cfg)
    prep_warm_ms = (time.perf_counter() - t0) * 1e3

    x = jnp.asarray(ds.x)
    y = jnp.asarray(ds.y.astype(np.int32))
    optimizer = optax.adam(0.01)

    def measure(hoist, kind="gcn", hidden=16, layers=2, epochs=200, reps=3):
        """Median over ``reps`` of the average epoch time of a device-side
        chain of ``epochs`` epochs (``step.many``), each ending in
        ``block_until_ready``."""
        params = nets.init_net(
            jax.random.PRNGKey(0), kind, ds.num_features, hidden,
            ds.num_classes, layers,
        )
        opt_state = optimizer.init(params)
        step = make_train_step(
            graph, kind, x, y, optimizer, dropout_rate=0.5, hoist=hoist
        )
        key = jax.random.PRNGKey(1)
        params, opt_state, key, loss = step.many(params, opt_state, key, 10)
        jax.block_until_ready(loss)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            params, opt_state, key, loss = step.many(
                params, opt_state, key, epochs
            )
            jax.block_until_ready(loss)
            samples.append((time.perf_counter() - t0) * 1e3 / epochs)
        samples.sort()
        return samples[len(samples) // 2], float(loss)

    # The headline is measured WITHOUT the layer-1 aggregate hoist, like
    # for like with the reference schedule (which recomputes that SpMM
    # every epoch); the framework's default (hoisted) epoch rides beside it.
    epoch_ms, final_loss = measure(hoist=False)
    epoch_ms_hoisted, _ = measure(hoist=True)
    agnn_ms, _ = measure(hoist=False, kind="agnn", hidden=32, layers=4,
                         epochs=50)

    print(
        json.dumps(
            {
                "metric": "gcn_pubmed_epoch_ms",
                "value": round(epoch_ms, 4),
                "unit": "ms",
                "vs_baseline": round(BASELINE_MS / epoch_ms, 3),
                "value_hoisted_default": round(epoch_ms_hoisted, 4),
                "agnn_pubmed_epoch_ms": round(agnn_ms, 4),
                "prep_ms": round(prep_ms, 1),
                "prep_warm_ms": round(prep_warm_ms, 1),
                "tc_blocks": graph.tc_blocks,
                "route": graph.route,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "nvidia_smi": power,
                "final_loss": final_loss,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
