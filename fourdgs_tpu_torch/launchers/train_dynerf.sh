#!/bin/bash
# DyNeRF/Neu3D 6-scene suite on the card: train -> render -> metrics per
# scene (counterpart: scripts/launchers/train_dynerf.sh).
set -e
DATA=${DATA:-data/dynerf}
OUT=${OUT:-output/dynerf}
for scene in coffee_martini cook_spinach cut_roasted_beef flame_salmon_1 flame_steak sear_steak; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs fourdgs_tpu/configs/dynerf/$scene.py --expname "dynerf/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
