#!/bin/bash
# HyperNeRF vrig split, 4 scenes with per-scene configs, on the card: train ->
# render (the video split only: --skip_train --skip_test) -> metrics
# (counterpart: scripts/launchers/train_hyper_virg.sh).
set -e
DATA=${DATA:-data/hypernerf/virg}
OUT=${OUT:-output/hypernerf/virg}
declare -A CFG=([broom2]=broom2 [vrig-3dprinter]=3dprinter
                [peel-banana]=banana [vrig-chicken]=chicken)
for scene in broom2 vrig-3dprinter peel-banana vrig-chicken; do
  python3 -m fourdgs_tpu_torch.tools.train -s "$DATA/$scene" -m "$OUT/$scene" \
    --configs "fourdgs_tpu/configs/hypernerf/${CFG[$scene]}.py" \
    --expname "hypernerf/virg/$scene"
  python3 -m fourdgs_tpu_torch.tools.render -m "$OUT/$scene" --skip_train --skip_test
  python3 -m fourdgs_tpu_torch.tools.metrics -m "$OUT/$scene"
done
python3 -m fourdgs_tpu_torch.tools.read_all_metrics "$OUT"
