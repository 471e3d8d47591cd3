"""Import hygiene of the PyTorch port: nothing under fourdgs_tpu_torch/ or in
chip_smoke.py and ab_smoke.py imports jax, jaxlib, the JAX package or PIL (the card's
machine has no PIL), and importing the serving, training and data modules
(the readers and the codecs among them), the training driver and its CLI,
the render and metrics CLIs with LPIPS, the viewer bridge, the triptych,
the dense grid, the per-frame export and the merge tool, and the dev
tools' kernels and tools leaves jax and PIL out of sys.modules; importing the dev tools
touches neither nvcc nor CUDA."""
import ast
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
            + _DEV_MODULES + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fourdgs_tpu', 'PIL')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
