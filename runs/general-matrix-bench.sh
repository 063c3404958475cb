#!/usr/bin/env bash
# The GENERAL-MATRIX (arbitrary-CSR) benchmark: the same 300^3 Poisson
# system assembled as a general matrix and solved through -mat_type aij —
# DMSetMatType(MATAIJ) parity (/root/reference/src/helper.cpp:39), the
# matrix type the reference actually ships, solved by PETSc through its
# patched general-CSR kernel (src/openacc-step1/MatMult_SeqAIJ.patch).
#
# Two records per size:
#   general_matrix_<N>.json          — production defaults: structure
#     detection ON (sparse/starlift.py proves the assembled coefficients
#     form an exact constant-coefficient star and lifts onto the
#     structured executor — what a structure-aware Mat type does)
#   general_matrix_<N>_nodetect.json — -mat_structure_detect 0: the pure
#     general banded-DIA executor, no structural shortcuts anywhere
#
# Comparison point: the reference's best node (16 cores + K20x) solves
# this in ~25-35 s of KSPSolve time (BASELINE.md).
set -euo pipefail
cd "$(dirname "$0")/.."
N="${N:-300}"
OUT="${OUT:-runs/general_matrix_${N}.json}"
OUT2="${OUT2:-runs/general_matrix_${N}_nodetect.json}"
python -m tpusparse -da_grid_x "$N" -da_grid_y "$N" -da_grid_z "$N" \
  -mat_type aij -ksp_rtol 1e-8 -ksp_atol 1e-12 -log_view \
  | tee /dev/stderr | awk '/^JSON:/ {sub(/^JSON: /, ""); print}' > "$OUT"
echo "record: $OUT" >&2
python -m tpusparse -da_grid_x "$N" -da_grid_y "$N" -da_grid_z "$N" \
  -mat_type aij -mat_structure_detect 0 -ksp_rtol 1e-8 -ksp_atol 1e-12 \
  -log_view \
  | tee /dev/stderr | awk '/^JSON:/ {sub(/^JSON: /, ""); print}' > "$OUT2"
echo "record: $OUT2" >&2
