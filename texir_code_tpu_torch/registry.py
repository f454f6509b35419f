"""Dynamic class resolution: the confs' dotted class names.

The port of the JAX package's `registry.py`.  The reference selects its
dataset, model and loss classes by dotted-path strings in the HOCON conf,
resolved reflectively (reference utils/general.py:12-18, used at
trainer/train_material.py:97,110,115).  The confs name the reference's own
classes (``models.mat_nvdiffrast.MaterialModel``); the aliases below map
each to its counterpart in this package.  Any other dotted path is imported
as it is.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

_PKG = "texir_code_tpu_torch"

# reference dotted paths → texir_code_tpu_torch counterparts
_ALIASES: Dict[str, str] = {
    # datasets (reference datasets/dataset.py)
    "datasets.dataset.MeshPoint": f"{_PKG}.data.datasets.MeshPoint",
    "datasets.dataset.ImageMeshPoint": f"{_PKG}.data.datasets.ImageMeshPoint",
    "datasets.dataset.ImageDerived": f"{_PKG}.data.datasets.ImageDerived",
    "datasets.dataset.ImageCubeDerived":
        f"{_PKG}.data.datasets.ImageCubeDerived",
    "datasets.dataset.ImageCubeNovel": f"{_PKG}.data.datasets.ImageCubeNovel",
    "datasets.dataset.ImageCubeSyn": f"{_PKG}.data.datasets.ImageCubeSyn",
    # models
    "models.tracer_o3d.TracerO3d": f"{_PKG}.models.tracer_irf.TracerIRF",
    "models.mat_mlp.MaterialMLP": f"{_PKG}.models.material_mlp.MaterialMLP",
    "models.mat_redner.MaterialModel":
        f"{_PKG}.models.material_redner.RednerMaterialModel",
    "models.tracer_o3d_irrf.TracerO3d":
        f"{_PKG}.models.tracer_irrf.TracerIRRF",
    "models.tracer_o3d_irt.TracerO3d":
        f"{_PKG}.models.tracer_irt.IrradianceTextureBaker",
    "models.tracer_o3d_pil.TracerO3d": f"{_PKG}.models.tracer_pil.TracerPIL",
    "models.mat_nvdiffrast.MaterialModel":
        f"{_PKG}.models.material.MaterialModel",
    "models.mat_nvdiffrast_invrender.MaterialModel":
        f"{_PKG}.models.material_heads.InvRenderMaterialModel",
    "models.mat_nvdiffrast_neilf.MaterialModel":
        f"{_PKG}.models.material_heads.NeILFMaterialModel",
    "models.mat_nvdiffrast_recMLP.MaterialModel":
        f"{_PKG}.models.material_heads.NvDiffRecMaterialModel",
    "models.mat_nvdiffrast_rec.MaterialModel":
        f"{_PKG}.models.material_heads.NvDiffRecMaterialModel",
    "models.test_nvdiffrast.MaterialModel":
        f"{_PKG}.eval.renderer.EvalMaterialModel",
    "models.test_redner.MaterialModel":
        f"{_PKG}.eval.path_tracer.PathTracedMaterialModel",
    # losses
    "models.loss.IRFLoss": f"{_PKG}.models.losses.IRFLoss",
    "models.loss.RenderLoss": f"{_PKG}.models.losses.RenderLoss",
    "models.loss.InvLoss": f"{_PKG}.models.losses.InvLoss",
    "models.loss.NeILFLoss": f"{_PKG}.models.losses.NeILFLoss",
    "models.loss.NvDiffRecLoss": f"{_PKG}.models.losses.NvDiffRecLoss",
}

_REGISTRY: Dict[str, Any] = {}


def register(name: str, obj: Any) -> Any:
    """Register an object under a short name (usable from confs)."""
    _REGISTRY[name] = obj
    return obj


def get_class(path: str) -> Any:
    """Resolve a dotted path (or a registered short name, or a reference
    alias)."""
    if path in _REGISTRY:
        return _REGISTRY[path]
    path = _ALIASES.get(path, path)
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ImportError(f"not a dotted path or registered name: {path!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)
