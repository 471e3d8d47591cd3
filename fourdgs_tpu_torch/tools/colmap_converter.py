"""Read, write and convert COLMAP sparse models between .bin and .txt
(counterpart: scripts/colmap_converter.py, with its flags and summary).

    python -m fourdgs_tpu_torch.tools.colmap_converter \\
        --input_model <dir> [--input_format .bin|.txt] \\
        [--output_model <dir>] [--output_format .txt|.bin]

Host code on data/colmap.py's full records: point ids and observation
tracks survive the round trip.
"""
from __future__ import annotations

import argparse

from fourdgs_tpu_torch.data.colmap import read_model, write_model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Read and write COLMAP binary and text models")
    parser.add_argument("--input_model", help="path to input model folder")
    parser.add_argument("--input_format", choices=[".bin", ".txt"],
                        help="input model format", default="")
    parser.add_argument("--output_model", help="path to output model folder")
    parser.add_argument("--output_format", choices=[".bin", ".txt"],
                        help="outut model format", default=".txt")
    args = parser.parse_args(argv)

    cameras, images, points3d = read_model(path=args.input_model,
                                           ext=args.input_format)
    print("num_cameras:", len(cameras))
    print("num_images:", len(images))
    print("num_points3D:", len(points3d))
    if args.output_model is not None:
        write_model(cameras, images, points3d, path=args.output_model,
                    ext=args.output_format)


if __name__ == "__main__":
    main()
