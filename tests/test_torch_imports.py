"""Import hygiene of the PyTorch port: nothing under fourdgs_tpu_torch/ or in
chip_smoke.py and ab_smoke.py imports jax, jaxlib, the JAX package or PIL (the card's
machine has no PIL), and importing the serving, training and data modules
(the readers and the codecs among them), the training driver and its CLI,
the render and metrics CLIs with LPIPS, the viewer bridge, the triptych,
the dense grid, the per-frame export and the merge tool, the serving
bench and the suite aggregate, the nine preparation, point and report
tools (no OpenCV either), the multi-GPU
package (fourdgs_tpu_torch.parallel) and its scaling tool, the host
library's bindings (fourdgs_tpu_torch.native), and the dev tools' kernels
and tools leaves jax
and PIL out of sys.modules; importing the dev tools touches neither nvcc
nor CUDA, importing the multi-GPU package touches no CUDA and starts no
process group, and importing the codecs and the host library's bindings
imports no torch and runs no compiler. The host library is built from
fourdgs_tpu_torch/csrc/host alone, never from the JAX package's native/
sources."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fourdgs_tpu")


def _port_files():
    files = sorted((ROOT / "fourdgs_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "ab_smoke.py"]
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_pil_imports(path):
    assert "PIL" not in set(_imported_roots(path)), \
        f"{path.relative_to(ROOT)} imports PIL"


# the dev tools' kernels (D1-D6): wrappers, tools and the timing helpers
_DEV_MODULES = ", ".join(
    "fourdgs_tpu_torch." + m for m in (
        "ops.gather", "ops.serial", "ops.binner_proto", "ops.blend_variants",
        "utils.timing", "tools.exp_gather", "tools.exp_scatter",
        "tools.exp_serial", "tools.exp_binner_proto",
        "tools.profile_blend_split", "tools.profile_kernel_variants"))


# the multi-GPU package: mesh, process wiring, collectives, sharded step
_PARALLEL_MODULES = ", ".join(
    "fourdgs_tpu_torch." + m for m in (
        "parallel", "parallel.mesh", "parallel.multihost",
        "parallel._collectives", "parallel.sharded"))


def test_parallel_modules_touch_no_cuda():
    """Importing the multi-GPU package initialises no CUDA context, starts
    no process group and loads no kernel library."""
    code = ("import torch, torch.distributed as dist\n"
            f"import {_PARALLEL_MODULES}\n"
            "from fourdgs_tpu_torch.ops import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not dist.is_initialized()\n"
            "assert _build._lib is None and not _build.build_info\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_dev_modules_touch_neither_nvcc_nor_cuda():
    """Importing the dev kernels' wrappers and tools starts no process,
    initialises no CUDA context and loads no kernel library."""
    code = ("import subprocess, torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError(f'a process at import: {a}')\n"
            "subprocess.Popen = subprocess.run = refuse\n"
            f"import {_DEV_MODULES}\n"
            "from fourdgs_tpu_torch.ops import _build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert _build._lib is None and not _build.build_info\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_serve_import_leaves_jax_out():
    code = ("import sys, fourdgs_tpu_torch.render.serve, "
            "fourdgs_tpu_torch.ops._build, fourdgs_tpu_torch.train.loop, "
            "fourdgs_tpu_torch.train.state, fourdgs_tpu_torch.convert, "
            "fourdgs_tpu_torch.ops.rasterize_ref, "
            "fourdgs_tpu_torch.ops.knn, "
            "fourdgs_tpu_torch.tools.profile_render, "
            "fourdgs_tpu_torch.tools.train, "
            "fourdgs_tpu_torch.tools.make_synthetic_scene, "
            "fourdgs_tpu_torch.tools.render, "
            "fourdgs_tpu_torch.tools.metrics, "
            "fourdgs_tpu_torch.ops.lpips, "
            "fourdgs_tpu_torch.data.scene, fourdgs_tpu_torch.data.blender, "
            "fourdgs_tpu_torch.data.png, fourdgs_tpu_torch.ops.scatter, "
            "fourdgs_tpu_torch.data.jpeg, fourdgs_tpu_torch.data.images, "
            "fourdgs_tpu_torch.data.colmap, "
            "fourdgs_tpu_torch.data.colmap_scene, "
            "fourdgs_tpu_torch.data.multiview, "
            "fourdgs_tpu_torch.data.panoptic, "
            "fourdgs_tpu_torch.train.densify, "
            "fourdgs_tpu_torch.train.checkpoint, "
            "fourdgs_tpu_torch.train.sampler, "
            "fourdgs_tpu_torch.utils.point_grow, "
            "fourdgs_tpu_torch.render.state_at_time, "
            "fourdgs_tpu_torch.models.dense_grid, "
            "fourdgs_tpu_torch.utils.visualize, "
            "fourdgs_tpu_torch.viewer.network_gui, "
            "fourdgs_tpu_torch.tools.export_perframe, "
            "fourdgs_tpu_torch.tools.merge_many, "
            "fourdgs_tpu_torch.tools.bench_scaling, "
            "fourdgs_tpu_torch.tools.bench_fps, "
            "fourdgs_tpu_torch.tools.read_all_metrics, "
            "fourdgs_tpu_torch.native, fourdgs_tpu_torch.native.build, "
            + _PARALLEL_MODULES + ", "
            + _DEV_MODULES + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fourdgs_tpu', 'PIL')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_codecs_import_without_torch_or_a_build():
    """The image banks' decode workers import the codecs and the host
    library's bindings: no torch comes with them, and importing them
    starts no compiler and loads no library."""
    code = ("import subprocess, sys\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError(f'a process at import: {a}')\n"
            "subprocess.Popen = subprocess.run = refuse\n"
            "import fourdgs_tpu_torch.data.images, "
            "fourdgs_tpu_torch.data.colmap\n"
            "from fourdgs_tpu_torch import native\n"
            "from fourdgs_tpu_torch.native import build\n"
            "assert 'torch' not in sys.modules\n"
            "assert native._lib is None and not build.build_info\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_host_library_reads_only_the_ports_sources():
    """native/build.py compiles fourdgs_tpu_torch/csrc/host/*.cpp, whose
    includes are system headers or files beside them: no source is read
    from the repo root's native/ or from fourdgs_tpu/."""
    from fourdgs_tpu_torch.native import build
    host = ROOT / "fourdgs_tpu_torch" / "csrc" / "host"
    assert build.HOST_SRC == host
    srcs = build.sources()
    assert srcs and all(p.parent == host for p in srcs)
    for src in host.iterdir():
        for kind, name in re.findall(r'#include\s*([<"])([^>"]+)',
                                     src.read_text()):
            assert kind == "<" or (host / name).is_file(), (src, name)
    for py in (ROOT / "fourdgs_tpu_torch" / "native").glob("*.py"):
        tree = ast.parse(py.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        paths = [n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and id(n) not in docs]
        bad = [v for v in paths if re.search(
            r"(^|/)native/|colmap_native|libcolmap|fourdgs_tpu/", v)]
        assert not bad, (py, bad)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "fourdgs_tpu_torch" / "launchers").glob("*.sh")),
    ids=lambda p: p.name)
def test_launchers_run_only_the_port(path):
    """A suite launcher runs the port's CLIs as modules under python3 and
    names no path of the JAX package: its config files are the port's
    (fourdgs_tpu_torch/configs/)."""
    text = "\n".join(line for line in path.read_text().splitlines()
                     if not line.lstrip().startswith("#"))
    runs = re.findall(r"^\s*(python\S*)\s+(\S+)\s+(\S+)", text, re.M)
    assert len(runs) == 4, runs        # train, render, metrics, aggregate
    assert all(prog == "python3" and flag == "-m"
               and mod.startswith("fourdgs_tpu_torch.tools.")
               for prog, flag, mod in runs), runs
    assert "scripts/" not in text
    assert not re.findall(r"(?<![\w/])fourdgs_tpu/", text)
    assert re.findall(r"(?<![\w/])fourdgs_tpu_torch/configs/\S+", text)


# a file:line or file:function label of a JAX kernel (chip_smoke.py's
# "replaces" and "tpu_kernel" keys); utils/standalone.py names the JAX
# package's tree to refuse it
JAX_LABEL = re.compile(r"fourdgs_tpu/\S+\.py:\w+")
NAMES_THE_JAX_TREE = ("fourdgs_tpu_torch/utils/standalone.py",)


@pytest.mark.parametrize("path", _port_files() + [ROOT / "chip_k2_states.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_package_paths(path):
    """No string of the port's code (docstrings aside) names a path under
    fourdgs_tpu/, or the directory `fourdgs_tpu` itself (as an
    os.path.join part), except a kernel's file:line label; the config
    files the port reads are its own (CONFIG_DIR)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef,
                              ast.AsyncFunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    bad = [n.value for n in ast.walk(tree)
           if isinstance(n, ast.Constant) and isinstance(n.value, str)
           and id(n) not in docs
           and (n.value == "fourdgs_tpu" or re.search(
               r"(?<![\w/])fourdgs_tpu/", JAX_LABEL.sub("", n.value)))]
    if str(path.relative_to(ROOT)) in NAMES_THE_JAX_TREE:
        assert bad == ["fourdgs_tpu"] * len(bad) and bad, bad
    else:
        assert not bad, bad


# the preparation, point and report tools (counterparts of the JAX
# package's scripts of the same names)
PREP_TOOLS = ("poses2colmap", "colmap_converter", "downsample_point",
              "grow_point", "merge_point", "preprocess_dynerf",
              "cal_modelsize", "visualize_hexplane", "diag_checkpoint")


def test_prep_tools_import_without_jax_pil_or_opencv():
    """The card's machine has no JAX or Pillow, and a user's may have no
    OpenCV: importing the nine tools brings none of them in
    (preprocess_dynerf reaches OpenCV only for a video whose frames are
    missing)."""
    code = ("import sys\n"
            + "".join(f"import fourdgs_tpu_torch.tools.{m}\n"
                      for m in PREP_TOOLS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fourdgs_tpu', 'PIL', 'cv2')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_visualize_imports_without_matplotlib():
    """The card's machine has no matplotlib: the debug plot imports it
    when called, not the module."""
    code = ("import sys, fourdgs_tpu_torch.utils.visualize\n"
            "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
