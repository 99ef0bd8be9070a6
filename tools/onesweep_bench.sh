#!/bin/bash
# One pass of csrc/radix.cuh's one-sweep sort in variants of the header,
# each built into tools/onesweep_bench.cu and timed on the card (run from
# the repository root; the copies go under build/onesweep/):
#
#   bash tools/onesweep_bench.sh [n]
#
# "cut" variants drop a part of the pass to time the rest: their output is
# not sorted.
set -u
n=${1:-4194304}
nvcc=${NVCC:-/usr/local/cuda/bin/nvcc}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
variant() {  # name, then python statements that edit the header text s
  local name=$1 code=$2 dir=build/onesweep/$1
  mkdir -p "$dir"
  python3 - spark_rapids_tpu_torch/csrc/radix.cuh "$dir/radix.cuh" "$code" <<'PY'
import sys
s = open(sys.argv[1]).read()
t = s
exec(sys.argv[3])
if sys.argv[3] != "pass":
    assert s != t, "the edit changed nothing"
open(sys.argv[2], "w").write(s)
PY
  "$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I "$dir" \
    -o "$dir/bench" tools/onesweep_bench.cu || return
  echo "== $name"
  "$dir/bench" "$n"
}
define() { echo "s = s.replace('#define $1 ', '#define $1 $2 //', 1);"; }
variant base 'pass'
variant threads256_items16 "$(define OS_THREADS 256) $(define OS_ITEMS 16)"
variant items12 "$(define OS_ITEMS 12)"
variant blocks3 "$(define OS_MIN_BLOCKS 3)"
variant match_any '
a = s.index("    const bool uniform =")
b = s.index("    pos[i] = (int)base + le - 1;")
s = s[:a] + """    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int le = __popc(peers & lane_le);
    const int leader = 31 - __clz(peers);
    unsigned base = 0;
    if (lane == leader) {
      base = s_cnt[warp][d];
      s_cnt[warp][d] = base + le;
    }
    __syncwarp();
    base = __shfl_sync(peers, base, leader);
""" + s[b:]'
variant cut_look_back 's = s.replace("os_look_back(status, tile, t, epoch)", "0ull")'
variant cut_global_scatter 's = s.replace("    kout[g] = key;\n    vout[g] = s_vals[j];", "    if (g < 0) kout[0] = key + s_vals[j];")'
