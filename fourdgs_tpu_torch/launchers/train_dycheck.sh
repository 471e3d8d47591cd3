#!/bin/bash
# DyCheck (iphone) 4-scene suite on the card: train -> render -> metrics per
# scene (counterpart: scripts/launchers/train_dycheck.sh).
set -e
DATA=${DATA:-data/dycheck}
OUT=${OUT:-output/dycheck}
for scene in spin space-out teddy apple; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs fourdgs_tpu_torch/configs/dycheck/default.py --expname "dycheck/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
