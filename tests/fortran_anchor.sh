#!/bin/sh
# Reference-anchor runner for tests/test_iteration_parity.py.
#
# This build image has NO gfortran and NO network egress, so the reference
# Fortran binary cannot be built or run here; the iteration-parity fixtures
# therefore pin the JAX library's own converged behavior (see the test
# module docstring).  Run THIS script once on any machine with gfortran +
# BLAS/LAPACK and a checkout of the reference (Molecolab-Pisa/diaglib) to
# produce the authoritative numbers, then paste the summary block it prints
# into tests/test_iteration_parity.py as the anchor comment.
#
# Usage: tests/fortran_anchor.sh /path/to/diaglib-reference
set -eu
REF=${1:?usage: fortran_anchor.sh /path/to/diaglib-reference}
cd "$REF"
make                                    # gfortran -O2, links -lblas -llapack
OUT=$(mktemp -d)
# the test driver is interactive (main.f90:26-45): 1=symm 2=geneig 3=scflr
# 4=caslr 6=nonsym
for i in 1 2 3 4 6; do
  echo "$i" | ./main.exe > "$OUT/protocol_$i.log" 2>&1 || true
  for f in lapack.txt lobcpg.txt davidson.txt caslr.txt cashp.txt \
           caslr_eff.txt; do
    [ -f "$f" ] && mv "$f" "$OUT/p${i}_$f"
  done
done
echo "=== ANCHOR SUMMARY (paste into tests/test_iteration_parity.py) ==="
echo "# reference run: $(gfortran --version | head -1), $(uname -sm), $(date -u +%F)"
for i in 1 2 3 4 6; do
  echo "# --- protocol $i ---"
  # per-iteration verbose tables end at the last printed iteration index;
  # grab the final iteration count per driver plus the converged flag
  grep -E "iterations|converged|davidson|lobpcg|caslr|nonsym" \
      "$OUT/protocol_$i.log" | tail -20 | sed 's/^/# /'
  for f in "$OUT"/p${i}_*.txt; do
    [ -f "$f" ] && { echo "# $(basename "$f") first 3 eigenvalues:"; \
                     head -3 "$f" | sed 's/^/#   /'; }
  done
done
echo "# full logs in $OUT"
