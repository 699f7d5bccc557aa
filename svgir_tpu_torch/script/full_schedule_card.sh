#!/bin/bash
# The recipe on one card with its kernel tables: cli/full_schedule.py (the
# scene when it is missing, both stages, both evaluations; any arguments
# go to it), then chip_smoke.py --recipe-tables on the run's newest
# checkpoints.  The logs, the evaluations' metrics, schedule.json, the
# tables' output and their profiles are copied to $KEEP; checkpoints stay
# under $RUN.  Exits with the first failure's code.
#
#   KEEP=output/keep svgir_tpu_torch/script/full_schedule_card.sh \
#       --s1_iters 30000 --s2_iters 32500
set -u -o pipefail
SCENE=${SCENE:-scenes/synth800}
RUN=${RUN:-output/full_r5}
KEEP=${KEEP:-$RUN/keep}
mkdir -p "$KEEP"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$KEEP/card.txt"

python -m svgir_tpu_torch.cli.full_schedule --scene "$SCENE" --run "$RUN" \
    "$@" 2>&1 | tee "$KEEP/schedule.log"
rc=$?
for s in gss render_relight; do
  mkdir -p "$KEEP/$s"
  cp "$RUN/$s/train_log.jsonl" "$KEEP/$s/" 2>/dev/null
  for f in "$RUN/$s"/eval/metrics.json "$RUN/$s"/eval/*/metrics.json; do
    [ -f "$f" ] && cp "$f" "$KEEP/$s/$(echo "${f#$RUN/$s/}" | tr / _)"
  done
done
cp "$RUN/schedule.json" "$KEEP/" 2>/dev/null
[ "$rc" = 0 ] || exit "$rc"

python chip_smoke.py --recipe-tables "$RUN" --profile "$KEEP/profile" 2>&1 \
    | tee "$KEEP/tables.log"
