"""Distributed block-diagonal fast path: bin-sharded packs + rim halo.

The single-device packed-diagonal design (``sgt/blockdiag.py``: after RCM,
component/banded graphs collapse every op into uniform batched matmuls
with zero gather) generalizes cleanly to a ``('graph', 'feature')`` mesh
because diagonals ARE locality: a shard owning a contiguous range of
128-row bins touches at most ``max|k| * 128`` rows beyond its own range.
The halo is therefore a fixed-width *rim* moved between NEIGHBORING shards
with two ``jax.lax.ppermute`` shifts per op — a nearest-neighbour
collective of O(max|k|·128·d) bytes, overlappable with the local diagonal
matmuls — instead of the condensed path's index-driven
``all_to_all``.  Mesh-edge shards receive ppermute's zero fill, which is
exactly the zero rim the single-device op pads with.

Applies when the (reordered) adjacency is FULLY covered by the selected
diagonals in both directions (the biomolecule AE class: OVCAR-8H, Yeast,
DD, YeastH, PROTEINS_full); anything with a residual falls back to the
condensed dense/chunk distributed path.  No reference counterpart
(single-GPU system, SURVEY.md §2.3) — this is additive scope applied to
the banded graph class.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BDShardMeta:
    """Host-side per-shard arrays for the sharded packed-diagonal ops.

    ``pack_idx/pack_cnt`` are the shard-local sparse tile entries (flat
    indices into the shard's [K, B_loc, bn, bn] tile space; padding rows
    carry the one-past-the-end sentinel that scatter ``mode="drop"``
    ignores).  ``cov_slot`` maps each shard edge SLOT (the padded
    contiguous-CSR-slice layout every distributed per-edge vector uses) to
    its cell in the shard's packed [B_loc, bn, K*bn] layout — the scatter
    target for weighted tiles and the gather source for SDDMM scores.
    """

    offsets: tuple
    bin_rows: int
    bins_per_shard: int
    pack_idx: np.ndarray   # [G, cap] int32 (sentinel = K*B_loc*bn*bn)
    pack_cnt: np.ndarray   # [G, cap] tile count dtype
    cov_slot: np.ndarray   # [G, edge_capacity] int32 (sentinel = B_loc*bn*K*bn)


def build_bd_shard_meta(
    bdm,
    edge_start: np.ndarray,
    rows_per_shard: int,
    num_shards: int,
    edge_capacity: int,
) -> BDShardMeta:
    """Shard a full-coverage :class:`~tcgnn.sgt.blockdiag.BDMeta` by
    contiguous bin ranges aligned with the row partition."""
    bn, k = bdm.bin_rows, len(bdm.offsets)
    assert rows_per_shard % bn == 0, (rows_per_shard, bn)
    b_loc = rows_per_shard // bn
    bnbn = bn * bn
    local_size = k * b_loc * bnbn
    assert local_size + 1 < 2**31, (k, b_loc, bn)

    # ---- sparse pack entries, re-addressed into shard-local tile space ----
    ki, rem = np.divmod(bdm.tile_idx, bdm.num_bins * bnbn)
    b, rc = np.divmod(rem, bnbn)
    shard = b // b_loc  # bins align with shards by construction
    local_idx = (ki * b_loc + (b - shard * b_loc)) * bnbn + rc
    counts = np.bincount(shard, minlength=num_shards)
    cap = max(int(counts.max(initial=0)), 1)
    pack_idx = np.full((num_shards, cap), local_size, dtype=np.int32)
    pack_cnt = np.zeros((num_shards, cap), dtype=bdm.tile_cnt.dtype)
    order = np.argsort(shard, kind="stable")
    pos = np.concatenate([[0], np.cumsum(counts)])
    for s in range(num_shards):
        sel = order[pos[s] : pos[s + 1]]
        pack_idx[s, : len(sel)] = local_idx[sel].astype(np.int32)
        pack_cnt[s, : len(sel)] = bdm.tile_cnt[sel]

    # ---- per-edge cov addresses in the shard slot layout -------------------
    packed = bdm.packed_cov_idx()  # (b*bn + r) * (K*bn) + ki*bn + c
    cov_sentinel = b_loc * bn * k * bn
    eb = packed // (bn * k * bn) // b_loc  # edge's shard via its row bin
    local_packed = packed - eb * cov_sentinel
    cov_slot = np.full((num_shards, edge_capacity), cov_sentinel, np.int32)
    slot = bdm.cov_edge_ids - edge_start[eb]
    cov_slot[eb, slot] = local_packed.astype(np.int32)

    return BDShardMeta(
        offsets=bdm.offsets,
        bin_rows=bn,
        bins_per_shard=b_loc,
        pack_idx=pack_idx,
        pack_cnt=pack_cnt,
        cov_slot=cov_slot,
    )
