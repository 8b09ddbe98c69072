"""Profiling helpers.

The reference's profiling is external (Nsight Compute invocations +
``proc_prof.py`` CSV averaging, SURVEY.md §5).  Here:

* :func:`trace` — context manager around ``jax.profiler.trace`` (an xplane
  dump the JAX profiler tools read);
* :func:`op_stats` / :func:`kernel_report` — edges/s, TFLOP/s and the
  share of the device's published peak, from a measured time;
* :data:`PEAKS` — published peaks keyed by ``device_kind``.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str | None):
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
    print(f"# profiler trace written to {log_dir}")


# Published dense peaks, keyed by ``jax.Device.device_kind``.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates without
# sparsity, at the full 700 W power limit (a card set below it cannot hold
# its top clock under load — report its power limit beside any share).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gb_per_s": 3350.0},
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peaks of ``device_kind`` (default: the first JAX device).  A device
    missing from :data:`PEAKS` is an error, never a default."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def op_stats(num_edges: int, feature_dim: int, seconds: float) -> dict:
    """Throughput stats for one aggregation pass over the whole graph."""
    edges_per_s = num_edges / seconds if seconds > 0 else float("inf")
    # 2 flops (mul+add) per edge per feature — the *useful* work; the tiles
    # carry padding, so this is the end-to-end efficiency view.
    tflops = 2.0 * num_edges * feature_dim / seconds / 1e12 if seconds > 0 else 0.0
    return {"edges_per_s": edges_per_s, "useful_tflops": tflops}


def kernel_report(
    num_edges: int,
    exp_edges: int,
    feature_dim: int,
    seconds: float,
    device_kind: str | None = None,
) -> dict:
    """Per-kernel utilization: the BASELINE.md metric contract.

    Two rates bracket the kernel:

    * ``useful_tflops`` — 2 * E * d / t: the algorithmic work (what a
      perfect zero-padding sparse engine would count);
    * ``tile_tflops`` / ``peak_pct`` — 2 * Exp_Edges * d / t against the
      device's published bf16 peak: the dense tile work the kernel issues
      (Exp_Edges = TC_Blocks * blk_h * blk_w, the reference's own
      tile-inflation statistic, TCGNN.cpp:225).  The ratio of the two is
      the SGT padding overhead.
    """
    stats = op_stats(num_edges, feature_dim, seconds)
    peak = device_peaks(device_kind)["bf16_tflops"]
    tile_tflops = (
        2.0 * exp_edges * feature_dim / seconds / 1e12 if seconds > 0 else 0.0
    )
    stats["tile_tflops"] = tile_tflops
    stats["peak_pct"] = 100.0 * tile_tflops / peak
    stats["peak_tflops"] = peak
    return stats
