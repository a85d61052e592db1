#!/bin/bash
# Compare the machine code two trees build for the same kernels.
#
#     tools/sass_diff.sh TREE_A TREE_B NAME...
#
# For each NAME (a src/repro_torch/csrc/NAME.cu in both trees), compiles
# both with the build's architecture and optimisation flags to a cubin,
# disassembles it with cuobjdump -sass, and prints how many SASS lines and
# ptxas resource lines (registers, stack, spills) differ; the diffs go to
# $OUT (default build/sass_diff).  Needs the CUDA toolkit (/usr/local/cuda
# or CUDA_HOME).  Exits 1 if any NAME differs.
set -u
A=$(cd "$1" && pwd) B=$(cd "$2" && pwd)
shift 2
CUDA=${CUDA_HOME:-/usr/local/cuda}
OUT=${OUT:-build/sass_diff}
mkdir -p "$OUT"
for name in "$@"; do
  for side in a b; do
    tree=$([ $side = a ] && echo "$A" || echo "$B")
    "$CUDA/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin -Xptxas -v \
      -o "$OUT/$side.$name.cubin" "$tree/src/repro_torch/csrc/$name.cu" > "$OUT/$side.$name.ptxas" 2>&1 &
  done
done
wait
rc=0
norm='s/_INTERNAL_[0-9a-f_]+//g; s/_GLOBAL__N__[0-9a-f_]+//g'
for name in "$@"; do
  for side in a b; do
    "$CUDA/bin/cuobjdump" -sass "$OUT/$side.$name.cubin" | sed -E "$norm" > "$OUT/$side.$name.sass"
    grep -E "Used|stack" "$OUT/$side.$name.ptxas" | sed -E "$norm" > "$OUT/$side.$name.res"
  done
  sass=$(diff "$OUT/a.$name.sass" "$OUT/b.$name.sass" | grep -c '^[<>]')
  res=$(diff "$OUT/a.$name.res" "$OUT/b.$name.res" | grep -c '^[<>]')
  echo "$name: SASS lines $(wc -l < "$OUT/a.$name.sass") / $(wc -l < "$OUT/b.$name.sass"), differing $sass; ptxas resource lines differing $res"
  [ "$sass" = 0 ] && [ "$res" = 0 ] || rc=1
done
exit $rc
