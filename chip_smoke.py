"""Smoke test of the trainer's main path on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # the distributed phase only, on four GPUs

Phases (each a function that raises on failure; nothing catches and goes
on):

1. device — platform, device kind, count, JAX version, XLA flags, compile
   cache, the card's name and power limit; fails unless the platform is gpu;
2. ops — every route's SpMM (binary, weighted, transpose), SDDMM and
   score-fused AGNN forward/backward against ``ops/reference.py`` at the
   models' real widths, in f32 and bf16, and the dense-tile Triton kernel
   against the plain form;
3. trainer — ``tcgnn.train.main`` in-process on each route's graph;
   the loss must be finite and fall;
4. kernel against plain — the dense-tile SpMM alone and the GCN epoch,
   Triton kernel and plain XLA in turns;
5. ``--four`` — the distributed train step on 4x1 and 2x2 meshes against
   the single-device step.

The last line of standard output is one JSON object with the device as
JAX reports it.  A run without a GPU exits non-zero before that line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

# Relative-error limits, stated against max|reference|.  f32: the
# reference runs at "highest" matmul precision and the ops sum in another
# order (atomics in the Triton kernel), ~1e-6 typical.  bf16: operands keep
# 8 mantissa bits (relative rounding 2^-9 per operand, several roundings
# per score-weighted term) while accumulation stays f32.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# Graphs of the main path and of each TiledGraph route (bench/datasets.py).
PUBMED = dict(dataset="pubmed", dim=500, classes=3)
AMAZON = dict(dataset="amazon0601", dim=96, classes=22)
DD = dict(dataset="DD", dim=89, classes=2)
STREAM_SEGMENTS = 4


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def phase_device(n_devices: int = 1):
    """Print what JAX runs on; raise unless it is ``n_devices`` GPUs."""
    import jax

    devs = jax.devices()
    print(f"platform: {devs[0].platform}  device_kind: {devs[0].device_kind}"
          f"  count: {len(devs)}  jax: {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform!r}")
    if len(devs) < n_devices:
        raise RuntimeError(f"{n_devices} GPUs needed, {len(devs)} found")
    print(_nvidia_smi())  # the card's name and power limit
    return devs


# ---------------------------------------------------------------------------
# Phase 2: ops against the reference
# ---------------------------------------------------------------------------
class _Checker:
    def __init__(self):
        self.n = 0

    def __call__(self, label, got, want, dtype_name):
        import numpy as np

        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
        if not np.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite output")
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        lim = TOL[dtype_name]
        print(f"  {label:<44s} max err {err:.3e}  limit {lim:.0e}")
        if not err <= lim:
            raise AssertionError(f"{label}: error {err:.3e} > {lim:.0e}")
        self.n += 1


def _build(spec, dtype, **kw):
    import jax.numpy as jnp

    from tcgnn.config import TileConfig
    from tcgnn.data import synthetic
    from tcgnn.graph import TiledGraph

    ds = synthetic.synthesize(spec["dataset"], seed=0)
    cfg = TileConfig(compute_dtype=jnp.dtype(dtype).type, block_group=0)
    g = TiledGraph(ds.row_pointers, ds.column_index, ds.num_nodes, cfg, **kw)
    return ds, g


def _check_graph(check, ds, g, widths, agnn_width, dtype_name, seed=0):
    """SpMM (binary, weighted, transpose), SDDMM and, where the route has
    it, the score-fused AGNN forward and backward against the oracles."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tcgnn.ops.reference import sddmm_ref, spmm_ref
    from tcgnn.sgt.translate import transpose_csr

    ptr = jnp.asarray(ds.row_pointers)
    cols = jnp.asarray(ds.column_index)
    t_ptr, t_idx, _ = transpose_csr(
        np.asarray(ds.row_pointers), np.asarray(ds.column_index), ds.num_nodes
    )
    t_ptr, t_idx = jnp.asarray(t_ptr), jnp.asarray(t_idx)
    n = ds.num_nodes
    garr = g.arrays()

    def op(name):
        # Graph arrays enter as jit arguments, not multi-GB constants.
        return jax.jit(lambda garr, *a: getattr(g.bind(garr), name)(*a))

    key = jax.random.PRNGKey(seed)
    w = jax.random.uniform(key, (g.num_edges,), jnp.float32)
    hi = jax.default_matmul_precision("highest")
    for d in widths:
        x = jax.random.normal(jax.random.fold_in(key, d), (n, d), jnp.float32)
        with hi:
            r_u = spmm_ref(x, ptr, cols)
            r_w = spmm_ref(x, ptr, cols, w)
            r_t = spmm_ref(x, t_ptr, t_idx)
            r_s = sddmm_ref(x, ptr, cols)
        check(f"{g.route} spmm d={d}", op("spmm")(garr, x), r_u, dtype_name)
        check(f"{g.route} spmm_weighted d={d}",
              op("spmm_weighted")(garr, x, w), r_w, dtype_name)
        check(f"{g.route} spmm_t d={d}", op("spmm_t")(garr, x), r_t,
              dtype_name)
        check(f"{g.route} sddmm d={d}", op("sddmm")(garr, x), r_s,
              dtype_name)
    if agnn_width and g.agnn_aggregate is not None:
        d = agnn_width
        x = 0.3 * jax.random.normal(jax.random.fold_in(key, 7), (n, d))
        att = jnp.asarray([0.7, 1.3], jnp.float32)
        probe = jax.random.normal(jax.random.fold_in(key, 8), (n, d))

        def plain(x, att):
            return jnp.mean(att) * spmm_ref(x, ptr, cols, sddmm_ref(x, ptr, cols))

        def fused(garr, x, att):
            return g.bind(garr).agnn_aggregate(x, att)

        def loss(f):
            return lambda *a: jnp.sum(f(*a).astype(jnp.float32) * probe)

        with hi:
            r_f = plain(x, att)
            r_dx, r_da = jax.grad(loss(plain), argnums=(0, 1))(x, att)
        f_dx, f_da = jax.jit(jax.grad(loss(fused), argnums=(1, 2)))(
            garr, x, att
        )
        check(f"{g.route} agnn fwd d={d}", jax.jit(fused)(garr, x, att), r_f,
              dtype_name)
        check(f"{g.route} agnn bwd dx d={d}", f_dx, r_dx, dtype_name)
        check(f"{g.route} agnn bwd datt d={d}", f_da, r_da, dtype_name)


def _check_kernel(check, g, widths, dtype_name):
    """The dense-tile Triton kernel against the plain XLA form."""
    import jax

    from tcgnn.ops.spmm import _spmm_dense_plain, _spmm_dense_triton

    m, a = g.meta, g.arrays()[2]
    for d in widths:
        x = jax.random.normal(jax.random.PRNGKey(d), (g.num_nodes, d))
        args = (x, a, m.col_ids, m.block_window)
        kw = dict(cfg=g.config, num_windows=m.num_windows)
        got = _spmm_dense_triton(*args, **kw)
        want = _spmm_dense_plain(*args, **kw)
        check(f"triton vs plain {g.route} d={d}", got, want, dtype_name)


def phase_ops():
    check = _Checker()
    for dtype in ("float32", "bfloat16"):
        print(f"# ops, {dtype}")
        ds, g = _build(PUBMED, dtype)
        _check_graph(check, ds, g, [500, 16, 3], 32, dtype)
        _check_kernel(check, g, [500, 16, 3], dtype)
        ds, g = _build(PUBMED, dtype, dense_tiles=False)
        _check_graph(check, ds, g, [16, 3], 0, dtype)
        ds, g = _build(PUBMED, dtype, dense_tiles=False, streamed=True,
                       stream_segments=STREAM_SEGMENTS)
        _check_graph(check, ds, g, [32, 16], 0, dtype)
        ds, g = _build(DD, dtype)
        _check_graph(check, ds, g, [89, 16], 32, dtype)
        ds, g = _build(AMAZON, dtype)
        _check_graph(check, ds, g, [96, 16], 0, dtype)
        _check_kernel(check, g, [96], dtype)
    print(f"ops: {check.n} comparisons within their limits")


# ---------------------------------------------------------------------------
# Phase 3: the trainer CLI in-process
# ---------------------------------------------------------------------------
TRAIN_RUNS = [
    ("gcn", PUBMED, []),
    ("gin", PUBMED, []),
    # AGNN's attention is unnormalised (reference parity): at 4 layers, or
    # on 500-wide inputs, activations overflow to inf at init in every
    # dtype, so the AGNN run uses 2 layers on 64-wide features.
    ("agnn", dict(PUBMED, dim=64), ["--hidden", "32", "--num_layers", "2"]),
    ("gcn", PUBMED, ["--stream_segments", str(STREAM_SEGMENTS)]),
    ("gcn", DD, []),
    ("gcn", AMAZON, []),
]


def _run_main(argv):
    from tcgnn import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    out = buf.getvalue()
    sys.stdout.write(out)
    return out


def phase_trainer():
    for model, spec, extra in TRAIN_RUNS:
        argv = [
            "--dataset", spec["dataset"], "--dim", str(spec["dim"]),
            "--classes", str(spec["classes"]), "--model", model,
            "--dtype", "bfloat16", "--epochs", "50", "--no_dropout",
            "--memory_report",
        ] + extra
        print(f"# train {' '.join(argv)}")
        out = _run_main(argv)
        first = float(re.search(r"Initial loss:\s*(\S+)", out).group(1))
        last = float(re.search(r"Final loss:\s*(\S+)", out).group(1))
        route = re.search(r"Route:\s*(\S+)", out).group(1)
        if not (math.isfinite(first) and math.isfinite(last)):
            raise AssertionError(f"{model} {spec['dataset']}: loss not finite")
        if not last < first:
            raise AssertionError(
                f"{model} {spec['dataset']}: loss did not fall "
                f"({first} -> {last})"
            )
        print(f"trainer {model} {spec['dataset']} [{route}]: loss "
              f"{first:.4f} -> {last:.4f}")


# ---------------------------------------------------------------------------
# Phase 4: Triton kernel against the plain form
# ---------------------------------------------------------------------------
def _time_ms(fn, n):
    import jax

    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    t = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t) / n * 1e3


def phase_kernel_vs_plain():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tcgnn.models import nets
    from tcgnn.ops.spmm import (
        _spmm_dense_plain, _spmm_dense_triton, dense_spmm_impl,
        forced_dense_impl,
    )
    from tcgnn.train import make_train_step

    for spec, widths in ((PUBMED, [16, 500]), (AMAZON, [96, 16])):
        ds, g = _build(spec, "bfloat16")
        m, a = g.meta, g.arrays()[2]
        kw = dict(cfg=g.config, num_windows=m.num_windows)
        for d in widths:
            x = jax.random.normal(jax.random.PRNGKey(d), (g.num_nodes, d))
            args = (x, a, m.col_ids, m.block_window)
            chosen = dense_spmm_impl(g.config, num_blocks=m.num_blocks, d=d)
            fk = lambda: _spmm_dense_triton(*args, **kw)  # noqa: E731
            fp = lambda: _spmm_dense_plain(*args, **kw)  # noqa: E731
            ts = [_time_ms(f, 50) for f in (fk, fp, fp, fk)]
            print(f"spmm {spec['dataset']} d={d} bf16 ({m.num_blocks} "
                  f"blocks, default {chosen}): triton "
                  f"{(ts[0] + ts[3]) / 2:.4f} ms  plain "
                  f"{(ts[1] + ts[2]) / 2:.4f} ms  (turns {ts})")
        x = jnp.asarray(ds.x)
        y = jnp.asarray(ds.y.astype(np.int32))
        opt = optax.adam(0.01)
        p0 = nets.init_net(jax.random.PRNGKey(0), "gcn", ds.num_features, 16,
                           ds.num_classes, 2)
        for hoist in (False, True):
            steps, state = {}, {}
            for impl in ("triton", "plain"):
                # The choice is made while tracing: trace each step once
                # under its implementation, then time them in turns.
                with forced_dense_impl(impl):
                    steps[impl] = make_train_step(g, "gcn", x, y, opt, 0.5,
                                                  hoist=hoist)
                    p = jax.tree.map(jnp.copy, p0)
                    st = steps[impl].many(p, opt.init(p),
                                          jax.random.PRNGKey(1), 10)
                    jax.block_until_ready(st)
                    state[impl] = st[:3]
            ts = {"triton": [], "plain": []}
            for impl in ("triton", "plain", "plain", "triton"):
                t = time.perf_counter()
                *st, loss = steps[impl].many(*state[impl], 100)
                jax.block_until_ready(loss)
                ts[impl].append((time.perf_counter() - t) * 10)
                state[impl] = tuple(st)
            print(f"gcn epoch {spec['dataset']} hoist={hoist} bf16: triton "
                  f"{np.mean(ts['triton']):.4f} ms  plain "
                  f"{np.mean(ts['plain']):.4f} ms  (turns {ts})")


# ---------------------------------------------------------------------------
# Phase 5 (--four): distributed step against the single-device step
# ---------------------------------------------------------------------------
def _hub_csr(n, e, hubs, hub_deg, seed):
    """Sparse background plus ``hubs`` dense rows: the hub windows exceed
    what the window balance can fix, so the block-stream split engages."""
    import numpy as np

    from tcgnn.data import synthetic

    ds = synthetic.synthesize(f"rand_{n}_{e}", dim=8, num_classes=4,
                              seed=seed)
    rng = np.random.default_rng(seed)
    hub_cols = [np.unique(rng.integers(0, n, hub_deg)) for _ in range(hubs)]
    ptr = np.asarray(ds.row_pointers, np.int64)
    cols = np.asarray(ds.column_index, np.int64)
    tail = [cols[ptr[r]:ptr[r + 1]] for r in range(hubs, n)]
    rows = hub_cols + tail
    new_ptr = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=new_ptr[1:])
    return new_ptr.astype(np.int32), np.concatenate(rows).astype(np.int32)


def _compare_steps(label, ptr, cols, n, mesh, cfg, devices, dg_kw=None,
                   steps=3):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tcgnn.graph import TiledGraph
    from tcgnn.models import nets
    from tcgnn.parallel import (
        DistributedTiledGraph, make_distributed_train_step,
    )
    from tcgnn.train import make_train_step

    d, hidden, classes = 32, 16, 4
    hi = jax.default_matmul_precision("highest")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (np.arange(n) * 7 % classes).astype(np.int32)
    opt = optax.adam(0.01)
    dg = DistributedTiledGraph(ptr, cols, n, mesh, cfg, **(dg_kw or {}))
    xs = dg.shard_features(x)
    if xs.shape[1] != d:
        raise AssertionError(f"{label}: feature padding {xs.shape[1]} != {d}")
    shards = xs.addressable_shards
    if sorted(s.device.id for s in shards) != sorted(v.id for v in devices):
        raise AssertionError(f"{label}: features not on every device")
    shapes = {s.data.shape for s in shards}
    want = (dg.padded_nodes // dg.pg, d // dg.pf)
    if shapes != {want}:
        raise AssertionError(f"{label}: shard shapes {shapes} != {want}")
    ys = dg.shard_nodes(y)
    p0 = nets.init_net(jax.random.PRNGKey(3), "gcn", d, hidden, classes, 2)
    step_d = make_distributed_train_step(
        dg, "gcn", xs, ys, opt, dropout_rate=0.0, num_valid_classes=classes
    )
    with jax.default_device(devices[0]):
        sg = TiledGraph(ptr, cols, n, cfg)
        step_s = make_train_step(sg, "gcn", jnp.asarray(x), jnp.asarray(y),
                                 opt, 0.0)
    pd, sd_, kd = p0, opt.init(p0), jax.random.PRNGKey(5)
    ps, ss, ks = jax.tree.map(jnp.copy, p0), opt.init(p0), jax.random.PRNGKey(5)
    for i in range(steps):
        with hi:
            pd, sd_, kd, ld = step_d(pd, sd_, kd)
            ps, ss, ks, ls = step_s(ps, ss, ks)
        ld, ls = float(ld), float(ls)
        rel = abs(ld - ls) / max(abs(ls), 1e-30)
        print(f"  {label} step {i}: distributed loss {ld:.6f}  single "
              f"{ls:.6f}  rel diff {rel:.2e}")
        if not (np.isfinite(ld) and rel <= 1e-4):
            raise AssertionError(f"{label}: losses disagree ({ld} vs {ls})")
    perr = max(
        float(jnp.max(jnp.abs(a - b)) / max(float(jnp.max(jnp.abs(b))), 1e-30))
        for a, b in zip(jax.tree.leaves(pd), jax.tree.leaves(ps))
    )
    print(f"  {label}: params after {steps} steps max rel diff {perr:.2e}")
    # Adam divides by the gradient's own scale, so a near-zero gradient
    # entry can move by up to the learning rate on summation-order noise.
    if not perr <= 5e-2:
        raise AssertionError(f"{label}: params disagree ({perr})")
    return dg


def phase_four(devices):
    """Distributed step on 4x1 and 2x2 meshes, three routes each."""
    from tcgnn.config import TileConfig
    from tcgnn.data.dataset import coo_to_csr
    from tcgnn.data.synthetic import component_union_graph
    from tcgnn.ops.spmm import forced_dense_impl
    from tcgnn.parallel import make_mesh

    hub = _hub_csr(n=4096, e=16384, hubs=128, hub_deg=1536, seed=7)
    bd = coo_to_csr(*component_union_graph(8192, 24000, 256, seed=7), 8192)
    for ng, nf in ((4, 1), (2, 2)):
        mesh = make_mesh(n_graph=ng, n_feature=nf, devices=devices[:4])
        print(f"# mesh {ng}x{nf}")
        cfg = TileConfig(blk_h=64, blk_w=64, edge_chunk=64)
        dg = _compare_steps(f"{ng}x{nf} condensed", *hub, 4096, mesh, cfg,
                            devices[:4])
        if ng >= 4 and dg.host_fwd.split is None:
            raise AssertionError("hub graph must engage the split at G=4")
        print(f"  split engaged: {dg.host_fwd.split is not None}")
        # The graph is below the Triton kernel's size threshold; force it so
        # the kernel also runs inside the shard map.
        with forced_dense_impl("triton"):
            _compare_steps(f"{ng}x{nf} condensed (triton)", *hub, 4096, mesh,
                           cfg, devices[:4])
        cfg_bd = TileConfig(blk_h=128, blk_w=128, edge_chunk=64)
        dg = _compare_steps(f"{ng}x{nf} block-diagonal", *bd, 8192, mesh,
                            cfg_bd, devices[:4])
        if not dg.block_diag:
            raise AssertionError("union graph must take the BD route")
        dg = _compare_steps(
            f"{ng}x{nf} streamed", *hub, 4096, mesh, cfg, devices[:4],
            dg_kw=dict(streamed=True, _stream_limits=(8, 24 * cfg.blk_w)),
        )
        if not (dg.streamed and dg._stream_static[0]["num_segments"] > 1):
            raise AssertionError("streamed composition must run segments")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the distributed phase, on four GPUs")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    if args.four:
        devs = phase_device(n_devices=4)
        phase_four(devs)
    else:
        devs = phase_device()
        for phase in (phase_ops, phase_trainer, phase_kernel_vs_plain):
            t = time.perf_counter()
            print(f"## {phase.__name__}")
            phase()
            print(f"## {phase.__name__} done in {time.perf_counter() - t:.1f} s")
    print(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))


if __name__ == "__main__":
    main()
