#!/bin/bash
# One-command artifact-evaluation driver — the analogue of the reference's
# 0_run_tcgnn_model.sh + 2_tcgnn_single_kernel.py + 3_cnt_TC_blk_*.py chain
# (/root/reference/0_run_tcgnn_model.sh).  Produces, in the working dir:
#   1_bench_{gcn,gin,agnn}.csv        per-model epoch times (no-hoist)
#   Fig_6a_xla_{gcn,gin,agnn}.csv     speedups vs the same-chip XLA baseline
#                                     (+ hoisted-schedule columns)
#   2_tcgnn_single_kernel.csv         per-kernel SAG/SDDMM ms, edges/s, peak share
#   3_cnt_TC_blk_*.csv                SGT tile-reduction analytics
# CSVs are written incrementally; rerunning resumes whole sweeps cheaply
# (prep + compile caches are warm).  Each stage continues on failure, but
# the script's exit status is nonzero if ANY stage failed.
set -u
cd "$(dirname "$0")"
rc=0

python -m tcgnn.bench.sweep --model gcn  --epochs 50 --reorder rcm || rc=1
python -m tcgnn.bench.sweep --model gin  --epochs 50 --reorder rcm || rc=1
python -m tcgnn.bench.sweep --model agnn --epochs 30 --reorder rcm || rc=1
python -m tcgnn.bench.sweep --single_kernel --reorder rcm || rc=1
python -m tcgnn.bench.tc_block_count --out_prefix 3_cnt_TC_blk || rc=1

exit $rc
