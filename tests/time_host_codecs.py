"""Times the port's host library against Pillow on this machine's CPU.

    python tests/time_host_codecs.py [--repeats 5] [--seed 0]

On a seeded photograph-like 1352x1014 image (chip_smoke.photo_like:
gradients plus Gaussian noise of sigma 6), each written by the codec
named: a PNG with Paeth on every row (data/png.py `write_png`), the same
PNG as Pillow writes it (its own filter choice), a quality-95 4:2:0 JPEG
from Pillow, baseline and progressive, and LANCZOS 1352x1014 -> 676x507.
Prints, for each, Pillow's, the host library's and the plain version's
best time in ms (the plain version once) and whether all three decode to
the same bytes, as one JSON line. Needs Pillow, so it is no part of the
port and does not run on the card machine; not a test (timings stay out
of the test suite).
"""
from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from fourdgs_tpu_torch import native  # noqa: E402
from fourdgs_tpu_torch.data import jpeg, png, resample  # noqa: E402


def best_ms(fn, repeats: int):
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * min(times), out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    native.load_library()
    img = chip_smoke.photo_like((1014, 1352, 3), args.seed)
    tmp = Path(tempfile.mkdtemp())
    png.write_png(str(tmp / "paeth.png"), img, row_filter=4)
    Image.fromarray(img).save(tmp / "pillow.png")
    for name, kw in (("baseline", {}), ("progressive", {"progressive": True})):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=95, subsampling=2, **kw)
        (tmp / f"{name}.jpg").write_bytes(b.getvalue())
    cases = {
        "png_paeth": (lambda: np.asarray(Image.open(tmp / "paeth.png")),
                      lambda: png.read_png(str(tmp / "paeth.png"))),
        "png_pillow_filters": (
            lambda: np.asarray(Image.open(tmp / "pillow.png")),
            lambda: png.read_png(str(tmp / "pillow.png"))),
        "jpeg_q95_420_baseline": (
            lambda: np.asarray(Image.open(tmp / "baseline.jpg").convert(
                "RGB")),
            lambda: jpeg.read_jpeg(str(tmp / "baseline.jpg"))),
        "jpeg_q95_420_progressive": (
            lambda: np.asarray(Image.open(tmp / "progressive.jpg").convert(
                "RGB")),
            lambda: jpeg.read_jpeg(str(tmp / "progressive.jpg"))),
        "lanczos_1352x1014_to_676x507": (
            lambda: np.asarray(Image.fromarray(img).resize((676, 507),
                                                           Image.LANCZOS)),
            lambda: resample.resize(img, (676, 507), "lanczos")),
    }
    plain = chip_smoke.plain_host_route
    out = {"cpu": "this machine", "repeats": args.repeats}
    for name, (pil_fn, port_fn) in cases.items():
        pil_ms, want = best_ms(pil_fn, args.repeats)
        native_ms, got = best_ms(port_fn, args.repeats)
        with plain():
            plain_ms, slow = best_ms(port_fn, 1)
        out[name] = {"pillow_ms": pil_ms, "native_ms": native_ms,
                     "plain_ms": plain_ms,
                     "native_over_pillow": native_ms / pil_ms,
                     "equal": bool(np.array_equal(got, want)
                                   and np.array_equal(slow, want))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
