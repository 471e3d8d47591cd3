"""Import hygiene of the PyTorch port: nothing under fourdgs_tpu_torch/ or in
chip_smoke.py imports jax, jaxlib or the JAX package, and importing the
serving, training and data modules, the training driver and its CLI leaves
jax out of sys.modules."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fourdgs_tpu")


def _port_files():
    files = sorted((ROOT / "fourdgs_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
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


def test_serve_import_leaves_jax_out():
    code = ("import sys, fourdgs_tpu_torch.render.serve, "
            "fourdgs_tpu_torch.ops._build, fourdgs_tpu_torch.train.loop, "
            "fourdgs_tpu_torch.train.state, fourdgs_tpu_torch.convert, "
            "fourdgs_tpu_torch.ops.rasterize_ref, "
            "fourdgs_tpu_torch.ops.knn, "
            "fourdgs_tpu_torch.tools.profile_render, "
            "fourdgs_tpu_torch.tools.train, "
            "fourdgs_tpu_torch.tools.make_synthetic_scene, "
            "fourdgs_tpu_torch.data.scene, fourdgs_tpu_torch.data.blender, "
            "fourdgs_tpu_torch.data.png, fourdgs_tpu_torch.ops.scatter, "
            "fourdgs_tpu_torch.train.densify, "
            "fourdgs_tpu_torch.train.checkpoint, "
            "fourdgs_tpu_torch.train.sampler, "
            "fourdgs_tpu_torch.utils.point_grow, "
            "fourdgs_tpu_torch.render.state_at_time; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fourdgs_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
