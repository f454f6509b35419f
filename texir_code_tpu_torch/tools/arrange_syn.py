"""Arrange externally rendered synthetic data into the dataset layout.

Reference tools/arrange_syn.py:1-208 converts OptixRenderer output
(per-view HDR panos + GT material maps) into the dataset directory
structure, with skip/novel view lists and an HDR scale.  This tool does the
same for any directory of per-view HDR panos:

    python -m texir_code_tpu_torch.tools.arrange_syn --src renders/ \
        --out data/ --mesh out1.obj [--hdr-scale -5] [--novel 3 7]

src layout expected: <src>/<view>.hdr (+ optional <view>_albedo.hdr,
<view>_roughness.hdr, extrinsics.txt with 4 rows of 4 per view).

As the port's exporter, it writes the LDR preview as
`derived/<id>/panoImage_orig.png` (there is no JPEG encoder without
OpenCV; the datasets read the pano's size from either).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np


def arrange(
    src: str,
    out: str,
    mesh_path: str,
    hdr_scale: float = 0.0,
    novel=(),
    skip=(),
):
    from texir_code_tpu_torch.data import hdrio

    panos = sorted(glob.glob(os.path.join(src, "*.hdr")))
    panos = [p for p in panos if "_albedo" not in p and "_roughness" not in p]
    ids = []
    os.makedirs(os.path.join(out, "info"), exist_ok=True)
    os.makedirs(os.path.join(out, "mesh"), exist_ok=True)
    scale = 2.0 ** hdr_scale
    for i, p in enumerate(panos):
        if i in skip:
            continue
        vid = f"view{i:03d}"
        ids.append(vid)
        os.makedirs(os.path.join(out, "hdr", vid), exist_ok=True)
        os.makedirs(os.path.join(out, "derived", vid), exist_ok=True)
        img = hdrio.read_hdr(p) * scale
        hdrio.write_hdr(os.path.join(out, "hdr", vid, "ccm.hdr"), img)
        hdrio.write_png(
            os.path.join(out, "derived", vid, "panoImage_orig.png"),
            hdrio.tonemap_to_ldr(img),
        )
        seg = np.zeros(img.shape[:2], np.uint8)
        hdrio.write_png(
            os.path.join(out, "derived", vid, "panoImage_gray.png"), seg)
    with open(os.path.join(out, "info", "aligned.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    if novel:
        with open(os.path.join(out, "info", "novel.txt"), "w") as f:
            f.write("\n".join(f"view{i:03d}" for i in novel) + "\n")
    ext_src = os.path.join(src, "extrinsics.txt")
    if os.path.exists(ext_src):
        shutil.copy(ext_src, os.path.join(out, "info", "final_extrinsics.txt"))
    if os.path.exists(mesh_path):
        shutil.copy(mesh_path, os.path.join(out, "mesh", "out1.obj"))
        for aux in ("hdr_texture.hdr", "irt.hdr"):
            a = mesh_path.replace("out1.obj", aux)
            if os.path.exists(a):
                shutil.copy(a, os.path.join(out, "mesh", aux))
    # GT materials
    gts = sorted(glob.glob(os.path.join(src, "*_albedo.hdr")))
    if gts:
        os.makedirs(os.path.join(out, "gt"), exist_ok=True)
        shutil.copy(gts[0], os.path.join(out, "gt", "albedo.hdr"))
        r = gts[0].replace("_albedo", "_roughness")
        if os.path.exists(r):
            shutil.copy(r, os.path.join(out, "gt", "roughness.hdr"))
    return ids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--hdr-scale", type=float, default=0.0)
    ap.add_argument("--novel", type=int, nargs="*", default=[])
    ap.add_argument("--skip", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    ids = arrange(args.src, args.out, args.mesh, args.hdr_scale,
                  tuple(args.novel), tuple(args.skip))
    print(f"arranged {len(ids)} views into {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
