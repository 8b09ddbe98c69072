// Native SGT tiling pass: per-row-window sort + dedup + condensed-column
// ranking, fused with dense A-tile materialization.
//
// Counterpart of the reference's C++ preprocessing
// (/root/reference/TCGNN_conv/TCGNN.cpp:157-226: per 16-row window copy
// neighbor ids, thrust::sort, in-place dedup into a map, write
// blockPartition/edgeToColumn/edgeToRow, OpenMP over windows).  Same math,
// different geometry (wider windows) and different outputs: instead of
// per-edge row/col arrays consumed by a GPU shared-memory build, we emit
//   * col_ids   [B * blk_w]  — condensed-column -> global node gather table
//   * edge_pos  [E]          — flat dense-tile slot of each CSR edge
//   * a_tiles   [B*blk_h*blk_w] (optional) — structural tiles, built here so
//     Python never rescans the edge list.
// Windows own disjoint block ranges, so the OpenMP loop is race-free.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Pass 1: number of real TC blocks per window (ceil(unique/blk_w); 0 for
// empty windows — Python applies the max(1) padding rule).
void sgt_count(int64_t n_rows, int blk_h, int blk_w,
               const int64_t* row_ptr, const int32_t* col_idx,
               int32_t* blocks_per_window /* [ceil(n_rows/blk_h)] */) {
  const int64_t n_windows = (n_rows + blk_h - 1) / blk_h;
#pragma omp parallel
  {
    std::vector<int32_t> scratch;
#pragma omp for schedule(dynamic, 16)
    for (int64_t w = 0; w < n_windows; ++w) {
      const int64_t r0 = w * blk_h;
      const int64_t r1 = std::min(r0 + blk_h, n_rows);
      const int64_t lo = row_ptr[r0], hi = row_ptr[r1];
      scratch.assign(col_idx + lo, col_idx + hi);
      std::sort(scratch.begin(), scratch.end());
      const int64_t uniq =
          std::unique(scratch.begin(), scratch.end()) - scratch.begin();
      blocks_per_window[w] = (int32_t)((uniq + blk_w - 1) / blk_w);
    }
  }
}

// Pass 2: fill col_ids / edge_pos / (optionally) structural a_tiles.
// block_start[w] = first global block of window w (Python cumsum with the
// empty-window padding applied); col_ids and a_tiles must be zeroed.
//
// tile_mode: 0 = no tiles, 1 = float32 tiles, 2 = int8 tiles (the kernels'
// storage format — duplicate-edge counts saturate at 127 and set *overflow,
// in which case the caller rebuilds in float; writing int8 directly avoids
// a 4x-larger f32 materialization plus a Python-side convert pass).
void sgt_fill(int64_t n_rows, int blk_h, int blk_w,
              const int64_t* row_ptr, const int32_t* col_idx,
              const int64_t* block_start /* [n_windows+1] */,
              int32_t* col_ids /* [B*blk_w] */,
              int64_t* edge_pos /* [nnz] */,
              void* a_tiles /* [B*blk_h*blk_w] or nullptr */,
              int tile_mode, int32_t* overflow) {
  const int64_t n_windows = (n_rows + blk_h - 1) / blk_h;
  const int64_t tile = (int64_t)blk_h * blk_w;
  float* tiles_f32 = tile_mode == 1 ? (float*)a_tiles : nullptr;
  int8_t* tiles_i8 = tile_mode == 2 ? (int8_t*)a_tiles : nullptr;
#pragma omp parallel
  {
    std::vector<int32_t> uniq;
#pragma omp for schedule(dynamic, 16)
    for (int64_t w = 0; w < n_windows; ++w) {
      const int64_t r0 = w * blk_h;
      const int64_t r1 = std::min(r0 + blk_h, n_rows);
      const int64_t lo = row_ptr[r0], hi = row_ptr[r1];
      uniq.assign(col_idx + lo, col_idx + hi);
      std::sort(uniq.begin(), uniq.end());
      uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());

      const int64_t b0 = block_start[w];
      for (size_t k = 0; k < uniq.size(); ++k)
        col_ids[(b0 + (int64_t)k / blk_w) * blk_w + (int64_t)(k % blk_w)] =
            uniq[k];

      for (int64_t r = r0; r < r1; ++r) {
        for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
          const int64_t rank =
              std::lower_bound(uniq.begin(), uniq.end(), col_idx[e]) -
              uniq.begin();
          const int64_t blk = b0 + rank / blk_w;
          const int64_t pos =
              blk * tile + (r - r0) * (int64_t)blk_w + rank % blk_w;
          edge_pos[e] = pos;
          if (tiles_f32) {
            tiles_f32[pos] += 1.0f;
          } else if (tiles_i8) {
            // Windows own disjoint block ranges, so writes are race-free;
            // overflow is a benign write-1-only flag.
            if (tiles_i8[pos] == 127) *overflow = 1;
            else ++tiles_i8[pos];
          }
        }
      }
    }
  }
}

// Analytics: naive sliding-window tile count (no column condensation) —
// the reference's Fig-7 comparison baseline (3_cnt_TC_blk_SpMM.py:73-84:
// greedy tiles of width blk_w over each window's sorted unique columns).
void sgt_naive_count(int64_t n_rows, int blk_h, int blk_w,
                     const int64_t* row_ptr, const int32_t* col_idx,
                     int64_t* naive_per_window) {
  const int64_t n_windows = (n_rows + blk_h - 1) / blk_h;
#pragma omp parallel
  {
    std::vector<int32_t> uniq;
#pragma omp for schedule(dynamic, 16)
    for (int64_t w = 0; w < n_windows; ++w) {
      const int64_t r0 = w * blk_h;
      const int64_t r1 = std::min(r0 + blk_h, n_rows);
      uniq.assign(col_idx + row_ptr[r0], col_idx + row_ptr[r1]);
      std::sort(uniq.begin(), uniq.end());
      uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
      int64_t cnt = 0;
      size_t i = 0;
      while (i < uniq.size()) {
        const int32_t end = uniq[i] + blk_w;
        i = std::lower_bound(uniq.begin() + i, uniq.end(), end) - uniq.begin();
        ++cnt;
      }
      naive_per_window[w] = cnt;
    }
  }
}

// CSR transpose via counting sort (O(nnz), no comparison sort): stable by
// construction — rows are scanned ascending, so within each transpose row
// the source columns come out ascending (CSR-sorted).  Replaces a numpy
// stable argsort over the edge list (~27 s at reddit's 115M edges; this
// runs in ~2 s).  t_ptr must be zeroed on entry; cursor is scratch
// [n_cols], contents ignored.
void sgt_transpose(int64_t n_rows, int64_t n_cols, int64_t nnz,
                   const int64_t* row_ptr, const int32_t* col_idx,
                   int64_t* t_ptr /* [n_cols+1], zeroed */,
                   int32_t* t_cols /* [nnz] */,
                   int32_t* t_src /* [nnz] */,
                   int64_t* cursor /* [n_cols] scratch */) {
  for (int64_t e = 0; e < nnz; ++e) ++t_ptr[col_idx[e] + 1];
  for (int64_t c = 0; c < n_cols; ++c) t_ptr[c + 1] += t_ptr[c];
  for (int64_t c = 0; c < n_cols; ++c) cursor[c] = t_ptr[c];
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      const int64_t p = cursor[col_idx[e]]++;
      t_cols[p] = (int32_t)r;
      t_src[p] = (int32_t)e;
    }
  }
}

// Chunk-layout emission for the streamed/chunk kernels: given the per-edge
// flat dense-tile slots (sgt_fill), place every edge into its block's
// uniform edge_chunk run.  Replaces the numpy fancy-indexing build (~60 s
// at reddit scale).  Edges are scanned in CSR order, so slots within a
// block keep CSR order (the layout contract).  Python zeroes cursor and
// pre-fills chunk_r / chunk_c / chunk_edge_id with their pad sentinels.
void sgt_chunk_count(int64_t nnz, int64_t tile, const int64_t* edge_pos,
                     int64_t* edges_per_block /* [num_blocks], zeroed */) {
  for (int64_t e = 0; e < nnz; ++e) ++edges_per_block[edge_pos[e] / tile];
}

void sgt_chunk_fill(int64_t nnz, int64_t tile, int blk_w, int ec,
                    const int64_t* edge_pos,
                    const int64_t* block_chunk_start /* [num_blocks+1] */,
                    int32_t* chunk_r, int32_t* chunk_c,
                    int32_t* chunk_edge_id, int32_t* edge_perm /* [nnz] */,
                    int64_t* cursor /* [num_blocks], zeroed */) {
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t pos = edge_pos[e];
    const int64_t blk = pos / tile;
    const int64_t rem = pos % tile;
    const int64_t slot = cursor[blk]++;
    const int64_t flat = (block_chunk_start[blk] + slot / ec) * ec + slot % ec;
    chunk_r[flat] = (int32_t)(rem / blk_w);
    chunk_c[flat] = (int32_t)(rem % blk_w);
    chunk_edge_id[flat] = (int32_t)e;
    edge_perm[e] = (int32_t)flat;
  }
}

// Reverse Cuthill-McKee ordering over a *symmetric* CSR (caller passes
// A + A^T).  BFS from min-degree seeds, neighbors enqueued in degree order,
// final order reversed.  Replaces scipy's implementation, which takes ~70 s
// on 3M-edge graphs where this takes ~1 s.
void sgt_rcm(int64_t n, const int64_t* row_ptr, const int32_t* col_idx,
             int32_t* perm_out /* [n]: perm[new] = old */) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = row_ptr[i + 1] - row_ptr[i];

  std::vector<int32_t> by_deg(n);
  for (int64_t i = 0; i < n; ++i) by_deg[i] = (int32_t)i;
  std::sort(by_deg.begin(), by_deg.end(),
            [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });

  std::vector<char> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<std::pair<int64_t, int32_t>> nbrs;
  size_t seed_cursor = 0;

  while ((int64_t)order.size() < n) {
    while (seed_cursor < by_deg.size() && visited[by_deg[seed_cursor]])
      ++seed_cursor;
    int32_t seed = by_deg[seed_cursor];
    visited[seed] = 1;
    size_t head = order.size();
    order.push_back(seed);
    while (head < order.size()) {
      int32_t u = order[head++];
      nbrs.clear();
      for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; ++e) {
        int32_t v = col_idx[e];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.emplace_back(deg[v], v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end());
      for (auto& p : nbrs) order.push_back(p.second);
    }
  }
  for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// Block-diagonal extraction (sgt/blockdiag.py's hot pass, native).
//
// The numpy extraction pass costs seconds on multi-million-edge banded
// graphs (DD 3 s, YeastH 7 s of host prep) because it makes ~8 full passes
// over the edge list (offset compute, np.unique histogram, isin mask, K
// boolean scans, flat-index arithmetic, a full sort inside np.unique on the
// flat indices).  Native layout insight that kills the sort: the flat tile
// index (k-major, then bin, then row-in-bin, then col-in-bin) is
// NON-DECREASING along CSR edge order *within one offset class k* whenever
// per-row columns are sorted — so the globally sorted unique tile list is
// just the K per-k streams concatenated in k order and deduped by a linear
// adjacency scan.  One counting pass + one writing pass, OpenMP over row
// ranges, no comparison sort (a per-k repair sort runs only if an unsorted
// CSR is detected).

// Pass 0: histogram of per-edge block offsets (col/bin - row/bin), indexed
// hist[off + nbins - 1]; hist has 2*nbins-1 slots, zeroed by the caller.
// Python applies the offset-selection policy to this histogram (it replaces
// np.unique(off, return_counts=True)).
void sgt_bd_hist(int64_t n_rows, int bin, const int64_t* row_ptr,
                 const int32_t* col_idx, int64_t nbins, int64_t* hist) {
#pragma omp parallel
  {
    std::vector<int64_t> local(2 * nbins - 1, 0);
#pragma omp for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
      const int64_t rb = r / bin;
      for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
        ++local[col_idx[e] / bin - rb + nbins - 1];
    }
#pragma omp critical
    for (int64_t i = 0; i < 2 * nbins - 1; ++i) hist[i] += local[i];
  }
}

// Pass 1+2: given the selected (sorted) offsets, emit in ONE parallel
// counting pass + ONE parallel writing pass:
//   cov_flat [C]  — flat tile index of each covered edge, CSR edge order
//   cov_eid  [C]  — CSR edge id of each covered edge, edge order
//   tile_idx [<=C], tile_cnt [<=C] — sorted unique flat indices + duplicate
//       counts (the sparse tile contents); *u_out = number of uniques
//   res_ptr  [n_rows+1] — residual CSR row counts at [r+1] (caller cumsums)
//   res_idx  [R], res_eid [R] — residual columns / edge ids, edge order
// seg_flat [C] is scratch (per-k segments of cov_flat, k-major = sorted).
// k_base is the exclusive prefix over per-offset edge counts (from the
// histogram), giving each k's segment base in seg_flat.
// cov_pack [C] additionally carries each covered edge's index into the
// kernels' packed [Bp, bin, K*bin] tile layout (ops/spmm.build_bd_pack) —
// row-major in (b, r, k, c) — which the Python path otherwise re-derives
// from cov_flat with a chain of full-length divmods (BDMeta.packed_cov_idx,
// ~1.2 s on DD).  Edge ids and packed indices are emitted as int32 (their
// consumers' dtype — E and the packed range are int32-gated upstream;
// emit_pack=0 skips cov_pack when the packed range would overflow).
void sgt_bd_fill(int64_t n_rows, int bin, int64_t nbins, int K,
                 const int64_t* offsets /* [K] sorted */,
                 const int64_t* k_base /* [K+1] */,
                 const int64_t* row_ptr, const int32_t* col_idx,
                 int64_t* cov_flat, int32_t* cov_eid, int32_t* cov_pack,
                 int emit_pack, int64_t* seg_flat,
                 int64_t* tile_idx, int32_t* tile_cnt, int64_t* u_out,
                 int64_t* res_ptr /* [n_rows+1], zeroed */,
                 int32_t* res_idx, int32_t* res_eid) {
  const int64_t binsq = (int64_t)bin * bin;
  int n_threads = 1;
#pragma omp parallel
  {
#pragma omp single
    {
#ifdef _OPENMP
      n_threads = omp_get_num_threads();
#endif
    }
  }
  // Static row ranges; per-range counters for covered / residual / per-k.
  const int64_t rows_per = (n_rows + n_threads - 1) / n_threads;
  std::vector<int64_t> base_cov(n_threads + 1, 0), base_res(n_threads + 1, 0);
  std::vector<int64_t> base_k((int64_t)n_threads * K + K, 0);
#pragma omp parallel num_threads(n_threads)
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const int64_t r0 = std::min((int64_t)t * rows_per, n_rows);
    const int64_t r1 = std::min(r0 + rows_per, n_rows);
    int64_t c_cov = 0, c_res = 0;
    std::vector<int64_t> c_k(K, 0);
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t rb = r / bin;
      int64_t res_in_row = 0;
      for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
        const int64_t off = col_idx[e] / bin - rb;
        int k = -1;
        for (int i = 0; i < K; ++i)
          if (offsets[i] == off) { k = i; break; }
        if (k >= 0) { ++c_cov; ++c_k[k]; }
        else { ++c_res; ++res_in_row; }
      }
      res_ptr[r + 1] = res_in_row;
    }
    base_cov[t + 1] = c_cov;
    base_res[t + 1] = c_res;
    for (int i = 0; i < K; ++i) base_k[(int64_t)(t + 1) * K + i] = c_k[i];
#pragma omp barrier
#pragma omp single
    {
      for (int i = 0; i < n_threads; ++i) {
        base_cov[i + 1] += base_cov[i];
        base_res[i + 1] += base_res[i];
        for (int j = 0; j < K; ++j)
          base_k[(int64_t)(i + 1) * K + j] += base_k[(int64_t)i * K + j];
      }
    }
    // Write pass: within a range edges are visited in CSR order and ranges
    // are row-major, so edge order is globally preserved in every stream.
    int64_t p_cov = base_cov[t], p_res = base_res[t];
    std::vector<int64_t> p_k(K);
    for (int i = 0; i < K; ++i)
      p_k[i] = k_base[i] + base_k[(int64_t)t * K + i];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t rb = r / bin;
      for (int64_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
        const int64_t c = col_idx[e];
        const int64_t off = c / bin - rb;
        int k = -1;
        for (int i = 0; i < K; ++i)
          if (offsets[i] == off) { k = i; break; }
        if (k >= 0) {
          const int64_t cc = c - (rb + off) * bin;
          const int64_t flat =
              ((int64_t)k * nbins + rb) * binsq + (r % bin) * bin + cc;
          cov_flat[p_cov] = flat;
          cov_eid[p_cov] = (int32_t)e;
          if (emit_pack)
            cov_pack[p_cov] =
                (int32_t)(r * ((int64_t)K * bin) + (int64_t)k * bin + cc);
          ++p_cov;
          seg_flat[p_k[k]++] = flat;
        } else {
          res_idx[p_res] = (int32_t)c;
          res_eid[p_res++] = (int32_t)e;
        }
      }
    }
  }
  // Per-k segments are sorted for row-sorted CSR inputs; repair-sort a
  // segment only if an unsorted input is detected (multigraph fuzz inputs).
  const int64_t C = k_base[K];
#pragma omp parallel for schedule(dynamic, 1)
  for (int k = 0; k < K; ++k)
    if (!std::is_sorted(seg_flat + k_base[k], seg_flat + k_base[k + 1]))
      std::sort(seg_flat + k_base[k], seg_flat + k_base[k + 1]);
  // Linear dedup over the k-major (globally sorted) stream.
  int64_t u = 0;
  for (int64_t i = 0; i < C; ++i) {
    if (u > 0 && tile_idx[u - 1] == seg_flat[i]) ++tile_cnt[u - 1];
    else { tile_idx[u] = seg_flat[i]; tile_cnt[u] = 1; ++u; }
  }
  *u_out = u;
}

// Community (Rabbit-style) ordering over a *symmetric* CSR (caller passes
// A + A^T).  Single-pass incremental aggregation (Arai et al., "Rabbit
// Order", IPDPS'16 — the ordering the TC-GNN README pairs with SGT):
// vertices are visited in increasing-degree order and each one merges into
// the neighboring community with the best modularity gain
//     dQ ∝ w(u,c) - deg(u)·deg(c) / 2m
// (merge only when dQ > 0).  Merges form a dendrogram; the final ordering
// is a DFS over each community tree, so community members get contiguous
// new ids — which is exactly what SGT wants: rows in the same 512-row
// window share neighbors, shrinking the condensed column set and the
// per-row gather that dominates power-law graphs.
//
// Community adjacency uses lazy relabeling: merged lists are concatenated
// with stale ids and compacted through union-find on access.
void sgt_community(int64_t n, const int64_t* row_ptr, const int32_t* col_idx,
                   int32_t* perm_out /* [n]: perm[new] = old */) {
  std::vector<double> deg(n);
  double two_m = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    deg[i] = (double)(row_ptr[i + 1] - row_ptr[i]);
    two_m += deg[i];
  }
  if (two_m == 0.0) {  // edgeless graph: identity
    for (int64_t i = 0; i < n; ++i) perm_out[i] = (int32_t)i;
    return;
  }

  // Union-find with path halving.
  std::vector<int32_t> uf(n);
  for (int64_t i = 0; i < n; ++i) uf[i] = (int32_t)i;
  auto find = [&](int32_t x) {
    while (uf[x] != x) {
      uf[x] = uf[uf[x]];
      x = uf[x];
    }
    return x;
  };

  // Per-community adjacency (community id -> weight), stored as flat
  // pair-vectors with lazy duplicates/stale ids.
  std::vector<std::vector<std::pair<int32_t, float>>> adj(n);
  for (int64_t i = 0; i < n; ++i) {
    adj[i].reserve(row_ptr[i + 1] - row_ptr[i]);
    for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
      if (col_idx[e] != i) adj[i].emplace_back(col_idx[e], 1.0f);
  }

  std::vector<int32_t> by_deg(n);
  for (int64_t i = 0; i < n; ++i) by_deg[i] = (int32_t)i;
  std::sort(by_deg.begin(), by_deg.end(), [&](int32_t a, int32_t b) {
    return deg[a] < deg[b] || (deg[a] == deg[b] && a < b);
  });

  // Dendrogram: children lists in merge order.
  std::vector<std::vector<int32_t>> children(n);
  std::vector<std::pair<int32_t, float>> tmp;

  auto compact = [&](std::vector<std::pair<int32_t, float>>& v,
                     int32_t self) {
    // Relabel through find(), sum duplicate weights, drop self-loops.
    tmp.clear();
    tmp.reserve(v.size());
    for (auto& p : v) {
      int32_t r = find(p.first);
      if (r != self) tmp.emplace_back(r, p.second);
    }
    std::sort(tmp.begin(), tmp.end(),
              [](const std::pair<int32_t, float>& a,
                 const std::pair<int32_t, float>& b) {
                return a.first < b.first;
              });
    v.clear();
    for (auto& p : tmp) {
      if (!v.empty() && v.back().first == p.first) v.back().second += p.second;
      else v.push_back(p);
    }
  };

  for (int64_t it = 0; it < n; ++it) {
    const int32_t u = by_deg[it];
    if (find(u) != u) continue;  // already absorbed
    compact(adj[u], u);
    if (adj[u].empty()) continue;
    // Best-gain neighbor community: maximize w(u,c) - deg(u)*deg(c)/2m.
    int32_t best = -1;
    double best_gain = 0.0;
    for (auto& p : adj[u]) {
      const double gain = (double)p.second - deg[u] * deg[p.first] / two_m;
      if (gain > best_gain) {
        best_gain = gain;
        best = p.first;
      }
    }
    if (best < 0) continue;  // no positive-gain merge: u stays a root
    // Merge u into community `best`.
    uf[u] = best;
    deg[best] += deg[u];
    children[best].push_back(u);
    auto& dst = adj[best];
    dst.insert(dst.end(), adj[u].begin(), adj[u].end());
    std::vector<std::pair<int32_t, float>>().swap(adj[u]);
    // Bound the lazy list: compact when it outgrows 4x the true community
    // degree (keeps total work near O(E log E)).
    if (dst.size() > 64 && (double)dst.size() > 4.0 * deg[best])
      compact(dst, best);
  }

  // Ordering: DFS over each dendrogram tree (children in merge order —
  // low-degree absorbees first, matching the aggregation locality).
  int64_t out = 0;
  std::vector<int32_t> roots;
  for (int64_t i = 0; i < n; ++i)
    if (find((int32_t)i) == (int32_t)i) roots.push_back((int32_t)i);
  // Heavy communities first: hubs land at low ids where windows are
  // densest, and singleton leftovers pack together at the tail.
  std::sort(roots.begin(), roots.end(), [&](int32_t a, int32_t b) {
    return deg[a] > deg[b] || (deg[a] == deg[b] && a < b);
  });
  std::vector<int32_t> stack;
  for (const int32_t r : roots) {
    stack.push_back(r);
    while (!stack.empty()) {
      const int32_t v = stack.back();
      stack.pop_back();
      perm_out[out++] = v;
      for (int64_t k = (int64_t)children[v].size() - 1; k >= 0; --k)
        stack.push_back(children[v][k]);
    }
  }
}

}  // extern "C"
