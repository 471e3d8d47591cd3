"""Builds the package's CUDA sources (csrc/*.cu) with `nvcc` at first use
and loads them with ctypes (the role of fourdgs_tpu/native/build.py).

One shared library with a plain C interface holds every kernel. Each
source compiles to an object in its own `nvcc` process, all started
together, and one more links them. The library is written to
build/fourdgs_tpu_torch/ at the checkout's root, named by a hash of the
sources, headers and flags, so an edited source rebuilds and an unchanged
one loads the existing file; the hash, the lock and the atomic move are
native/build.py's, which the host library's build shares. Importing this
module touches neither `nvcc` nor the card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from fourdgs_tpu_torch.native.build import build_once, hashed_library

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build reported: seconds, ptxas lines, library path
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    # sources and headers
    return hashed_library("libfourdgs_kernels", sorted(CSRC.glob("*.cu*")),
                          NVCC_FLAGS)


def _compile(tmp_dir: str, out_name: str, logs: list) -> str:
    nvcc = _nvcc()
    objs = [os.path.join(tmp_dir, src.stem + ".o") for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs += [proc.communicate()[0] for proc in procs]
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(proc.args)}\n{log}")
    tmp = os.path.join(tmp_dir, out_name)
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}"
                           f"{proc.stderr}")
    return tmp


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library unless it exists. Prints
    ptxas' registers and spills per kernel when `verbose`."""
    out = _library_path()
    t0 = time.perf_counter()
    logs: list = []
    if not build_once(out, lambda tmp: _compile(tmp, out.name, logs)):
        if build_info.get("path") != str(out):  # not built by this process
            build_info.update(seconds=0.0, ptxas=[], path=str(out),
                              cached=True)
        return out
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for log in logs for ln in log.splitlines()
             if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                   or "Compiling" in ln)]
    build_info.update(seconds=seconds, ptxas=ptxas, path=str(out),
                      cached=False)
    if verbose:
        print(f"built {out.name} in {seconds:.1f} s")
        for ln in ptxas:
            print(ln)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """ctypes signatures: every pointer and the stream as c_void_p, so that
    no 64-bit address is cut to 32 bits."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.blend_fwd_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                     vp, vp, vp, vp]
    lib.blend_fwd_launch.restype = i
    lib.blend_bwd_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i,
                                     vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.blend_bwd_launch.restype = i
    lib.blend_bwd_slots_launch.argtypes = lib.blend_bwd_launch.argtypes
    lib.blend_bwd_slots_launch.restype = i
    ll = ctypes.c_longlong
    lib.scatter_add_rows_launch.argtypes = [vp, vp, ll, i, i, vp, vp]
    lib.scatter_add_rows_launch.restype = i
    lib.scatter_set_scalars_launch.argtypes = [vp, vp, ll, i, vp, vp]
    lib.scatter_set_scalars_launch.restype = i
    lib.gather_rows_launch.argtypes = [vp, vp, ll, i, i, vp, vp]
    lib.gather_rows_launch.restype = i
    lib.rank_segment_items.argtypes = []
    lib.rank_segment_items.restype = i
    lib.scalar_store_launch.argtypes = [vp, vp, i, i, vp, vp]
    lib.scalar_store_launch.restype = i
    lib.tile_counter_store_launch.argtypes = [vp, vp, i, i, i, i, vp, vp,
                                              vp, vp, vp]
    lib.tile_counter_store_launch.restype = i
    lib.expand_rank_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i, i,
                                       i, i, vp, vp, vp]
    lib.expand_rank_launch.restype = i
    lib.bin_items_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp, vp, vp,
                                     ll, i, vp]
    lib.bin_items_launch.restype = i
    lib.bin_tiles_launch.argtypes = [vp, vp, ll, i, i, i, i, i, i, vp, vp,
                                     vp, vp, vp, vp, vp, vp, vp]
    lib.bin_tiles_launch.restype = i
    lib.blend_variant_launch.argtypes = [i, vp, vp, i, i, i, vp, vp]
    lib.blend_variant_launch.restype = i
    lib.trace_stamp_launch.argtypes = [vp, vp, i, i, i, i, vp]
    lib.trace_stamp_launch.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error: a refused launch
    never runs, and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")


def _launch(lib: ctypes.CDLL, fn, x: torch.Tensor, *args) -> None:
    """Call launch function fn of lib with args and the handle of PyTorch's
    current stream on x's card, and raise if it failed. The host path is
    kept short, since some kernels take a few microseconds: the raw stream
    handle (`torch._C._cuda_getCurrentRawStream`, not the Stream object
    that `torch.cuda.current_stream()` builds on every call), and the
    device's context only when x is off the current device."""
    d = x.get_device()
    if d == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(d))
    else:
        with torch.cuda.device(d):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(d))
    check_launch(lib, fn.__name__, err)


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' library, built on first use. Raises when CUDA is not
    available: there is nothing to fall back to here. Once loaded, the
    library is returned before anything else is asked: the wrappers call
    this on every launch."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; the plain "
                           "versions run only for CPU tensors")
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build(verbose))))
    return _lib
