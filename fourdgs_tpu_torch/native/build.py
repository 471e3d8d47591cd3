"""Builds the port's host library (csrc/host/*.cpp) with the host C++
compiler at first use (the counterpart of fourdgs_tpu/native/build.py).

    python -m fourdgs_tpu_torch.native.build     # build, print the path

One shared library with a plain C interface holds the data layer's hot
loops: the PNG unfilter, the JPEG decoder, Pillow's resampling and the
COLMAP binary readers. It needs no CUDA and links nothing beyond libc and
libstdc++. The compiler is the first of `g++` and `c++` on PATH; each
source compiles in its own process, all started together, and one more
links them into build/fourdgs_tpu_torch/libfourdgs_host_<hash>.so at the
checkout's root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file. A failed
build raises with the compiler's log: nothing falls back to numpy.

`hashed_library` and `build_once` are shared with the CUDA build
(ops/_build.py): a build runs under an exclusive `fcntl` lock beside its
output and moves the finished library into place with one `os.replace`,
so concurrent processes (test workers, decode workers) build it once and
no loader sees half a file. Importing this module runs no compiler.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fourdgs_tpu_torch"
HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
# -ffp-contract=off: no fused multiply-add may change the resampling
# weights' rounding, which must equal Pillow's
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off"]
LINK_FLAGS = ["-shared"]

# what the last build reported: seconds, library path, cached
build_info: dict = {}


def hashed_library(stem: str, files, flags) -> Path:
    """build/fourdgs_tpu_torch/<stem>_<hash>.so, the hash over the flags
    and each file's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_once(out: Path, make) -> bool:
    """Build `out` unless it exists: `make(tmp_dir)` returns the path of
    the library it built in a temporary directory beside `out`, which then
    replaces `out` atomically. Runs under an exclusive lock on
    `<out>.lock`, and looks again once it holds it. True when this call
    built the library."""
    if out.exists():
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                return False
            with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
                os.replace(make(tmp_dir), out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return True


def compiler() -> str:
    """The host C++ compiler: `g++`, else `c++`, on PATH."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the host "
                       "library (fourdgs_tpu_torch/csrc/host) cannot be "
                       "built, and nothing decodes without it")


def sources() -> list[Path]:
    return sorted(HOST_SRC.glob("*.cpp"))


def library_path() -> Path:
    return hashed_library("libfourdgs_host", sources(),
                          CXX_FLAGS + LINK_FLAGS)


def _compile(tmp_dir: str, out_name: str) -> str:
    cxx = compiler()
    srcs = sources()
    objs = [os.path.join(tmp_dir, src.stem + ".o") for src in srcs]
    procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", "-o", obj, str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{' '.join(proc.args)}\n{log}")
    lib = os.path.join(tmp_dir, out_name)
    link = [cxx, *LINK_FLAGS, "-o", lib, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    return lib


def build() -> Path:
    """Compile csrc/host/*.cpp into the host library unless it exists."""
    out = library_path()
    t0 = time.perf_counter()
    built = build_once(out, lambda tmp: _compile(tmp, out.name))
    if built or build_info.get("path") != str(out):
        build_info.update(seconds=time.perf_counter() - t0 if built else 0.0,
                          path=str(out), cached=not built)
    return out


if __name__ == "__main__":
    print(build())
