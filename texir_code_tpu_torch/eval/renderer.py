"""Evaluation renderer over optimized materials.

The port of the JAX package's `eval/renderer.py` (reference
models/test_nvdiffrast.py:37-365) for the re-render tester:

  * `load_optimized_materials` loads the optimized albedo/roughness atlases
    from a Mat run's plots dir (the reference's `sort_res` picks the
    newest dump, :119-130);
  * `EvalMaterialModel` is the MaterialModel with pixel-chunked shading
    (`shade_chunk`, 4096 pixels by default), so the reference's eval spp
    (diffuse 1024 / specular 256, configs/test.conf:10) fits one device.

Not ported yet: the scan's seg atlas and seg-texture editing
(`edited_params`), and relighting (`relit_tbl`, `forward_relit`), which
come with the Editing and Relighting testers (ROADMAP.md queue A item 10).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.models.material import MaterialModel, MaterialParams


def load_optimized_materials(plots_dir: str, device="cuda") -> MaterialParams:
    """Newest atlas dump from a Mat run (reference sort_res, :119-130):
    the last `mat_albedo_*.hdr` / `mat_roughness_*.hdr` in name order,
    roughness from its first channel."""
    from texir_code_tpu_torch.data import hdrio

    def newest(pattern):
        files = sorted(glob.glob(os.path.join(plots_dir, pattern)))
        if not files:
            raise FileNotFoundError(f"no {pattern} in {plots_dir}")
        return files[-1]

    dev = resolve_device(device)
    albedo = hdrio.read_hdr(newest("mat_albedo_*.hdr"))
    rough = hdrio.read_hdr(newest("mat_roughness_*.hdr"))[..., 0:1]
    return MaterialParams(
        albedo=torch.from_numpy(np.ascontiguousarray(albedo)).to(dev),
        roughness=torch.from_numpy(np.ascontiguousarray(rough)).to(dev),
    )


class EvalMaterialModel(MaterialModel):
    """MaterialModel for evaluation: pixel-chunked shading."""

    def __init__(self, *args, shade_chunk: Optional[int] = 4096, **kw):
        super().__init__(*args, **kw)
        # pixel chunking so the reference eval spp fits one device
        # (reference split_input, utils/general.py:28-58)
        self.shade_chunk = shade_chunk
