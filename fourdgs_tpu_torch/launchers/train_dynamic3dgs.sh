#!/bin/bash
# Dynamic3DGS (CMU panoptic) 6-scene suite on the card: train -> render ->
# metrics (counterpart: scripts/launchers/train_dynamic3dgs.sh; the scenes use
# the MultipleView reader and config family, CFG overrides the config).
set -e
DATA=${DATA:-data/dynamic3dgs/data}
OUT=${OUT:-output/dynamic3dgs}
CFG=${CFG:-fourdgs_tpu_torch/configs/multipleview/default.py}
for scene in basketball boxes football juggle softball tennis; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs "$CFG" --expname "dynamic3dgs/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
