#!/bin/bash
# Parent/change A/B of one benchmark cell on one card, in turns:
#
#   bash scripts/bench_ab.sh PARENT_DIR OUT_DIR CELL SIDE:SEED:TRACE ...
#
# SIDE is p (run from PARENT_DIR, a checkout of the parent commit with
# this benchmark laid over it) or c (run from the current directory).
# Each run is `python3 portbench/run.py --workload CELL --seed SEED
# --seconds 51 --trace TRACE`; its output and errors go to
# OUT_DIR/SIDE_SEED_TRACE.{out,err}, and its result line is printed
# after the card's name and power limit.  A c run given as cc:SEED:TRACE
# goes through scripts/bench_counters.py instead, which prints the
# latent-attention counters after the result line.
parent=$(cd "$1" && pwd); out=$(mkdir -p "$2" && cd "$2" && pwd)
cell=$3; here=$(pwd); shift 3
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in "$@"; do
  side=${spec%%:*}; rest=${spec#*:}; seed=${rest%%:*}; trace=${rest#*:}
  dir=$here; cmd=portbench/run.py
  [ "$side" = p ] && dir=$parent
  [ "$side" = cc ] && cmd=scripts/bench_counters.py
  t0=$(date +%s)
  (cd "$dir" && python3 $cmd --workload "$cell" --seed "$seed" \
      --seconds 51 --trace "$trace") \
    > "$out/${side}_${seed}_${trace}.out" 2> "$out/${side}_${seed}_${trace}.err"
  rc=$?
  echo "== $cell $side seed=$seed trace=$trace rc=$rc $(( $(date +%s) - t0 ))s"
  tail -n 2 "$out/${side}_${seed}_${trace}.out" | cut -c1-1500
done
