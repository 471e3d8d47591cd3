#!/bin/bash
# D-NeRF 8-scene benchmark suite on the card: train -> render -> metrics per
# scene, then the suite's means (counterpart: scripts/launchers/train_dnerf.sh).
set -e
DATA=${DATA:-data/dnerf}
OUT=${OUT:-output/dnerf}
for scene in bouncingballs hellwarrior hook jumpingjacks lego mutant standup trex; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs fourdgs_tpu_torch/configs/dnerf/$scene.py --expname "dnerf/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
