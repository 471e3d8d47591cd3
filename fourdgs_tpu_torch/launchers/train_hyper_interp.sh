#!/bin/bash
# HyperNeRF interp split, 6 scenes, on the card: train -> render -> metrics
# per scene (counterpart: scripts/launchers/train_hyper_interp.sh).
set -e
DATA=${DATA:-data/hypernerf/interp}
OUT=${OUT:-output/hypernerf/interp}
for scene in aleks-teapot slice-banana chickchicken cut-lemon1 hand1-dense-v2 torchocolate; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs fourdgs_tpu/configs/hypernerf/default.py \
    --expname "hypernerf/interp/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
