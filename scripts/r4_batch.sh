#!/bin/bash
# Round-4 evidence batch: runs after the full acceptance sweep.
# Each stage logs to its own file under /tmp/r4_batch.
set -x
mkdir -p /tmp/r4_batch
cd "$(dirname "$0")/.."

# (a) sensor-fidelity ablations on 10-12-32, full length (OXFORD_RESULTS §5)
for ab in saturation multipath jitter; do
  timeout 3600 python scripts/run_acceptance.py --seqs 10-12-32 \
      --ablate "$ab" --suffix "_abl_$ab" --outdir acceptance \
      --tmp /tmp/acc_r4_abl > /tmp/r4_batch/abl_$ab.log 2>&1
done

# (b) cadence-faithful online acceptance, 2 full sequences
timeout 7200 python scripts/oxford_sim.py --seq 10-12-32 --online \
    --output /tmp/r4_batch/online_10-12-32 > /tmp/r4_batch/online_10-12-32.log 2>&1
timeout 7200 python scripts/oxford_sim.py --seq 16-13-09 --online \
    --output /tmp/r4_batch/online_16-13-09 > /tmp/r4_batch/online_16-13-09.log 2>&1

# (c) loop-recall sensitivity sweep on the revisit window
timeout 5400 python scripts/loop_sweep.py --output /tmp/r4_batch/loop_sweep \
    > /tmp/r4_batch/loop_sweep.log 2>&1

# (d) DCS / two-stage PGO evidence on the revisit window
timeout 2400 python scripts/oxford_sim.py --seq 10-12-32 --start 1200 \
    --frames 1600 --chunk 200 --robust-kernel dcs \
    --output /tmp/r4_batch/dcs_window > /tmp/r4_batch/dcs.log 2>&1
timeout 2400 python scripts/oxford_sim.py --seq 10-12-32 --start 1200 \
    --frames 1600 --chunk 200 --robust-kernel dcs --robust-two-stage \
    --output /tmp/r4_batch/dcs2_window > /tmp/r4_batch/dcs2.log 2>&1

echo BATCH_DONE
