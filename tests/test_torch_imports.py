"""The port stands alone: no module of texir_code_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package texir_code_tpu (an AST scan;
`texir_code_tpu_torch` itself shares that prefix and is allowed), nor
OpenCV, PIL or orbax, which the machine with the card does not have."""

import ast
import os

import pytest
import torch

torch.set_num_threads(2)  # six test workers share the host's cores

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _sources():
    pkg = os.path.join(ROOT, "texir_code_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "texir_code_tpu", "cv2",
                   "PIL", "orbax")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") in
              ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scan_covers_the_port():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    for mod in (("ops", "pallas_culled.py"), ("ops", "pallas_fan.py"),
                ("ops", "chunking.py"), ("eval", "renderer.py"),
                ("eval", "runners.py"), ("ops", "scatter_acc.py"),
                ("scripts", "sampler_bwd_variants.py"),
                ("ops", "raycast.py"), ("ops", "fan_raycast.py"),
                ("data", "export.py"), ("train", "material_syn.py"),
                ("scripts", "quality_run.py"),
                ("scripts", "roughness_classes.py"),
                ("eval", "path_tracer.py"), ("tools", "relighting_varying.py"),
                ("tools", "padding_texture.py"), ("tools", "trans_hdr_tex.py"),
                ("tools", "hdr2ldr.py"), ("tools", "arrange_syn.py"),
                ("models", "material_heads.py"), ("train", "heads.py"),
                ("scripts", "heads_quality.py"), ("registry.py",),
                ("models", "material_mlp.py"),
                ("models", "material_redner.py"),
                ("scripts", "building_quality.py"),
                ("parallel", "multihost.py"), ("parallel", "mesh.py"),
                ("parallel", "bake.py"), ("parallel", "atlas_tp.py"),
                ("parallel", "dryrun.py"), ("ops", "tiled_raycast.py"),
                ("profiling.py",)):
        assert os.path.join("texir_code_tpu_torch", *mod) in names
    assert len(names) > 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("texir_code_tpu.ops")
    assert _forbidden("texir_code_tpu")
    assert _forbidden("cv2") and _forbidden("PIL.Image")
    assert _forbidden("orbax.checkpoint")
    assert not _forbidden("texir_code_tpu_torch.ops.sampling")
    assert not _forbidden("torch") and not _forbidden("scipy.ndimage")
