#!/bin/bash
# Round-5 repo-side seed queue (VERDICT r4 item 3): bring the repo
# halves of the DQN and HDQN parity comparisons to n>=8 seeds, matching
# the torch sides collected by torch_dqn_hdqn_batch.sh.  Serialized --
# one process per accelerator at a time; each timeout is sized at 4x a
# seed's run so a slow compile never gets killed mid-run.
set -u
cd /root/repo
DOUT=docs/parity/repo_dqn_seeds
HOUT=docs/parity/repo_hdqn_seeds
mkdir -p "$DOUT" "$HOUT"

run_job() {
  local kind=$1 s=$2 out script
  if [ "$kind" = hdqn ]; then
    out="$HOUT/seed$s"; script=examples/parity_hdqn.py
  else
    out="$DOUT/seed$s"; script=examples/parity_dqn.py
  fi
  if [ -s "$out.json" ]; then echo "repo $kind seed $s already done"; return; fi
  timeout 2400 python "$script" --summary-only --seed "$s" --out "$out" \
    > "$out.log" 2>&1
  echo "repo $kind seed $s exit $?"
}

for s in 4 5 6 7; do run_job dqn $s; done
for s in 3 4 5 6 7; do run_job hdqn $s; done
echo "REPO SEEDS DONE"
