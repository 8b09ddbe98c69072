"""ctypes loader for the native (C++/OpenMP) SGT tiling pass.

Builds ``sgt.cpp`` with g++ on first use; falls back silently to the NumPy
pass if no toolchain is available.  The native pass mirrors the reference's
C++ preprocessing role (``/root/reference/TCGNN_conv/TCGNN.cpp:157-226``) —
host-side, OpenMP over row windows.

The library is built into ``.cache/native/`` at the repository root (git
ignores it) under a name keyed by a hash of the source, the build command
and the host CPU's instruction-set flags: a build from another machine or
another source revision is never loaded, only rebuilt beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sgt.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))), ".cache", "native"
)
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_flags() -> str:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return os.uname().machine


def library_path() -> str:
    """Path of the library built from this source, flags and host CPU."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_flags().encode())
    return os.path.join(_BUILD_DIR, f"libsgt-{h.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Build under a temporary name and rename: concurrent test workers may
    # race to build, and none may load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = library_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.sgt_count.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, i64p, i32p, i32p,
        ]
        lib.sgt_count.restype = None
        lib.sgt_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            i64p, i32p, i64p, i32p, i64p, ctypes.c_void_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sgt_fill.restype = None
        lib.sgt_naive_count.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, i64p, i32p, i64p,
        ]
        lib.sgt_naive_count.restype = None
        lib.sgt_rcm.argtypes = [ctypes.c_int64, i64p, i32p, i32p]
        lib.sgt_rcm.restype = None
        lib.sgt_transpose.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i32p, i64p, i32p, i32p, i64p,
        ]
        lib.sgt_transpose.restype = None
        lib.sgt_chunk_count.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ]
        lib.sgt_chunk_count.restype = None
        lib.sgt_chunk_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            i64p, i64p, i32p, i32p, i32p, i32p, i64p,
        ]
        lib.sgt_chunk_fill.restype = None
        lib.sgt_community.argtypes = [ctypes.c_int64, i64p, i32p, i32p]
        lib.sgt_community.restype = None
        lib.sgt_bd_hist.argtypes = [
            ctypes.c_int64, ctypes.c_int, i64p, i32p, ctypes.c_int64, i64p,
        ]
        lib.sgt_bd_hist.restype = None
        lib.sgt_bd_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            i64p, i64p, i64p, i32p,
            i64p, i32p, i32p, ctypes.c_int, i64p, i64p, i32p,
            ctypes.POINTER(ctypes.c_int64), i64p, i32p, i32p,
        ]
        lib.sgt_bd_fill.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def count_blocks(row_ptr: np.ndarray, col_idx: np.ndarray, blk_h: int, blk_w: int) -> np.ndarray:
    lib = load()
    n_rows = len(row_ptr) - 1
    n_windows = max(-(-n_rows // blk_h), 1)
    out = np.zeros(n_windows, np.int32)
    if n_rows:
        lib.sgt_count(n_rows, blk_h, blk_w, row_ptr, col_idx, out)
    return out


def naive_count(row_ptr: np.ndarray, col_idx: np.ndarray, blk_h: int, blk_w: int) -> np.ndarray:
    """Per-window naive (uncondensed) sliding-window tile counts."""
    lib = load()
    n_rows = len(row_ptr) - 1
    n_windows = max(-(-n_rows // blk_h), 1)
    out = np.zeros(n_windows, np.int64)
    if n_rows:
        lib.sgt_naive_count(n_rows, blk_h, blk_w, row_ptr, col_idx, out)
    return out


def rcm(sym_row_ptr: np.ndarray, sym_col_idx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old) of a symmetric CSR."""
    lib = load()
    n = len(sym_row_ptr) - 1
    out = np.zeros(n, np.int32)
    if n:
        lib.sgt_rcm(
            n,
            np.ascontiguousarray(sym_row_ptr, np.int64),
            np.ascontiguousarray(sym_col_idx, np.int32),
            out,
        )
    return out.astype(np.int64)


def community(sym_row_ptr: np.ndarray, sym_col_idx: np.ndarray) -> np.ndarray:
    """Rabbit-style community permutation (perm[new] = old) of a symmetric CSR."""
    lib = load()
    n = len(sym_row_ptr) - 1
    out = np.zeros(n, np.int32)
    if n:
        lib.sgt_community(
            n,
            np.ascontiguousarray(sym_row_ptr, np.int64),
            np.ascontiguousarray(sym_col_idx, np.int32),
            out,
        )
    return out.astype(np.int64)


def transpose(row_ptr: np.ndarray, col_idx: np.ndarray, num_cols: int):
    """Counting-sort CSR transpose: (t_ptr, t_cols, t_src), CSR-sorted."""
    lib = load()
    n_rows = len(row_ptr) - 1
    nnz = len(col_idx)
    t_ptr = np.zeros(num_cols + 1, np.int64)
    t_cols = np.zeros(nnz, np.int32)
    t_src = np.zeros(nnz, np.int32)
    if nnz:
        lib.sgt_transpose(
            n_rows, num_cols, nnz,
            np.ascontiguousarray(row_ptr, np.int64),
            np.ascontiguousarray(col_idx, np.int32),
            t_ptr, t_cols, t_src, np.zeros(num_cols, np.int64),
        )
    return t_ptr, t_cols, t_src


def chunk_layout(
    edge_pos: np.ndarray,
    num_blocks: int,
    blk_h: int,
    blk_w: int,
    ec: int,
    row_sentinel: int,
):
    """Uniform chunk layout from per-edge flat slots (see sgt.cpp).

    Returns (chunk_r, chunk_c, chunk_edge_id, edge_perm, chunks_per_block,
    block_chunk_start) matching the numpy layout in translate.py exactly.
    """
    lib = load()
    nnz = len(edge_pos)
    tile = blk_h * blk_w
    edge_pos = np.ascontiguousarray(edge_pos, np.int64)
    edges_per_block = np.zeros(num_blocks, np.int64)
    if nnz:
        lib.sgt_chunk_count(nnz, tile, edge_pos, edges_per_block)
    chunks_per_block = np.maximum(-(-edges_per_block // ec), 1)
    block_chunk_start = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(chunks_per_block, out=block_chunk_start[1:])
    num_chunks = int(block_chunk_start[-1])
    chunk_r = np.full(num_chunks * ec, row_sentinel, np.int32)
    chunk_c = np.zeros(num_chunks * ec, np.int32)
    chunk_edge_id = np.full(num_chunks * ec, nnz, np.int32)
    edge_perm = np.zeros(nnz, np.int32)
    if nnz:
        lib.sgt_chunk_fill(
            nnz, tile, blk_w, ec, edge_pos, block_chunk_start,
            chunk_r, chunk_c, chunk_edge_id, edge_perm,
            np.zeros(num_blocks, np.int64),
        )
    return (
        chunk_r.reshape(num_chunks, ec),
        chunk_c.reshape(num_chunks, ec),
        chunk_edge_id.reshape(num_chunks, ec),
        edge_perm,
        chunks_per_block,
        block_chunk_start,
    )


def fill(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    block_start: np.ndarray,
    blk_h: int,
    blk_w: int,
    build_tiles: bool,
):
    """Returns (col_ids [B*blk_w], edge_pos [E], a_tiles or None, overflow).

    Tiles come back as int8 (the kernels' storage format); ``overflow`` is
    True when some duplicate-edge count exceeded 127 — the caller should
    rebuild the tiles in a wider dtype from ``edge_pos``.
    """
    lib = load()
    n_rows = len(row_ptr) - 1
    num_blocks = int(block_start[-1])
    col_ids = np.zeros(num_blocks * blk_w, np.int32)
    edge_pos = np.zeros(len(col_idx), np.int64)
    a_tiles = (
        np.zeros(num_blocks * blk_h * blk_w, np.int8) if build_tiles else None
    )
    overflow = ctypes.c_int32(0)
    if n_rows:
        lib.sgt_fill(
            n_rows, blk_h, blk_w, row_ptr, col_idx, block_start, col_ids,
            edge_pos,
            a_tiles.ctypes.data_as(ctypes.c_void_p) if build_tiles else None,
            2 if build_tiles else 0,
            ctypes.byref(overflow),
        )
    return col_ids, edge_pos, a_tiles, bool(overflow.value)


def bd_hist(row_ptr: np.ndarray, col_idx: np.ndarray, bin_rows: int, nbins: int):
    """Block-offset histogram: (offset values present, their edge counts).

    Native replacement for ``np.unique((cols//bin)-(rows//bin),
    return_counts=True)`` in ``sgt/blockdiag.py`` (one OpenMP pass, no
    edge-length temporaries).
    """
    lib = load()
    n_rows = len(row_ptr) - 1
    hist = np.zeros(2 * nbins - 1, np.int64)
    if n_rows and len(col_idx):
        lib.sgt_bd_hist(
            n_rows, bin_rows,
            np.ascontiguousarray(row_ptr, np.int64),
            np.ascontiguousarray(col_idx, np.int32),
            nbins, hist,
        )
    nz = np.nonzero(hist)[0]
    return nz - (nbins - 1), hist[nz]


def bd_fill(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    bin_rows: int,
    nbins: int,
    offsets,
    k_counts: np.ndarray,
    num_res: int,
):
    """Covered/residual streams for the block-diagonal decomposition.

    Returns ``(cov_flat, cov_eid, cov_pack, tile_idx, tile_cnt,
    res_ptr_counts, res_idx, res_eid)`` — see ``sgt.cpp:sgt_bd_fill``.
    ``res_ptr_counts`` holds per-row residual degrees at ``[r+1]`` (caller
    cumsums); ``tile_idx``/``tile_cnt`` are already truncated to the unique
    count.
    """
    lib = load()
    n_rows = len(row_ptr) - 1
    k = len(offsets)
    k_base = np.zeros(k + 1, np.int64)
    np.cumsum(np.asarray(k_counts, np.int64), out=k_base[1:])
    c = int(k_base[-1])
    # The packed index range fits int32 iff the [B, bin, K*bin] pack does;
    # past that graph.py's per-edge BD ops are gated off anyway, so the
    # pack column is simply skipped (emit_pack=0).
    emit_pack = int(nbins * bin_rows * k * bin_rows < 2**31)
    cov_flat = np.zeros(c, np.int64)
    cov_eid = np.zeros(c, np.int32)
    cov_pack = np.zeros(c if emit_pack else 1, np.int32)
    seg_flat = np.zeros(c, np.int64)
    tile_idx = np.zeros(c, np.int64)
    tile_cnt = np.zeros(c, np.int32)
    res_ptr = np.zeros(n_rows + 1, np.int64)
    res_idx = np.zeros(num_res, np.int32)
    res_eid = np.zeros(num_res, np.int32)
    u = ctypes.c_int64(0)
    if n_rows and (c or num_res):
        lib.sgt_bd_fill(
            n_rows, bin_rows, nbins, k,
            np.ascontiguousarray(offsets, np.int64), k_base,
            np.ascontiguousarray(row_ptr, np.int64),
            np.ascontiguousarray(col_idx, np.int32),
            cov_flat, cov_eid, cov_pack, emit_pack, seg_flat,
            tile_idx, tile_cnt,
            ctypes.byref(u), res_ptr, res_idx, res_eid,
        )
    nu = int(u.value)
    return (
        cov_flat, cov_eid, cov_pack if emit_pack else None,
        tile_idx[:nu], tile_cnt[:nu], res_ptr, res_idx, res_eid,
    )
