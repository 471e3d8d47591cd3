"""Extract the DyNeRF videos' frames ahead of training (counterpart:
scripts/preprocess_dynerf.py), so that the first training run decodes no
video.

    python -m fourdgs_tpu_torch.tools.preprocess_dynerf --datadir <scene>

Each <scene>/cam*.mp4 goes through data/dynerf.py:extract_video_frames:
frames already under camNN/images are listed and kept; a video without
them is decoded with OpenCV, and on a machine without OpenCV the
function's ImportError, which names the video and what to do, ends the
run with a nonzero exit.
"""
from __future__ import annotations

import argparse
import glob
import os

from fourdgs_tpu_torch.data.dynerf import IMG_WH, extract_video_frames


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract images from dynerf videos")
    parser.add_argument("--datadir", required=True)
    args = parser.parse_args(argv)
    for video in sorted(glob.glob(os.path.join(args.datadir, "cam*.mp4"))):
        d = extract_video_frames(video, IMG_WH)
        print(f"{video} -> {d} ({len(os.listdir(d))} frames)")


if __name__ == "__main__":
    main()
