#!/usr/bin/env bash
# Arbitrary-CSR (RCM reorder + segmented executor) benchmark records —
# the verdict-3 acceptance case at scale: randomly-permuted Poisson
# systems solved through KSP mat_reorder=auto.  Run on the GPU host.
set -euo pipefail
cd "$(dirname "$0")/.."
python -m tpusparse.bench.reorderbench 100 --pc gamg \
    --out runs/reordered_matrix_100.json
# >= 2M rows (150^3 = 3.375M): above the gather-row cap, the level-0
# container is the segmented BandedELL
python -m tpusparse.bench.reorderbench 150 --pc gamg --skip-natural \
    --out runs/reordered_matrix_150.json
