"""Where the quality run's mapped-roughness PSNR comes from, per seg class.

    python -m texir_code_tpu_torch.scripts.roughness_classes [RUN_DIR]

RUN_DIR is a MatSyn run of `scripts/quality_run.py` (default: the newest
under `<root>/exps/Mat-quality`).  It rebuilds the quality run's apartment
(`make_apartment_scene(atlas_res=256, subdiv=24)`) for its GT roughness and
seg atlases and prints one JSON object: per seg class of the mapped texels
the texel count, the GT and predicted mean roughness, the prediction's
spread (std) and the class's share of the mapped squared error.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np


def roughness_by_class(run_dir: str, scene) -> dict:
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.models.tracer_irt import bake_geometry_textures

    gt = scene.gt_roughness[..., 0]
    res = gt.shape[0]
    pred = hdrio.read_hdr(os.path.join(run_dir, "plots",
                                       "mat_roughness_final.hdr"))[..., 0]
    idx = np.arange(res) * pred.shape[0] // res
    pred = pred[idx][:, idx]
    valid = bake_geometry_textures(scene.mesh, res).valid
    seg = scene.seg_texture
    err = (pred - gt) ** 2
    total = float(err[valid].sum())
    out = {}
    for c in np.unique(seg[valid]):
        m = valid & (seg == c)
        out[int(c)] = dict(texels=int(m.sum()), gt=float(gt[m].mean()),
                           pred=float(pred[m].mean()),
                           pred_std=float(pred[m].std()),
                           err_share=float(err[m].sum()) / total)
    return out


def main(argv=None):
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene

    argv = sys.argv[1:] if argv is None else argv
    run_dir = argv[0] if argv else os.path.dirname(sorted(glob.glob(
        os.path.join(os.getcwd(), "exps", "Mat-quality", "*",
                     "timings.json")))[-1])
    print(json.dumps(roughness_by_class(
        run_dir, make_apartment_scene(atlas_res=256, subdiv=24))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
