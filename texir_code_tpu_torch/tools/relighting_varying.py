"""Relighting ground-truth generation: colour-varying / moving lights.

Reference tools/relighting_varying.py drives an external OptixRenderer +
OIDN to produce GT frames for the paper's relighting videos (:53-80,
102-128).  Here the port's path tracer (eval/path_tracer.py) renders the
same sequences — a quad light whose colour or position interpolates
across frames — with the à-trous denoiser applied per frame, on
`--device` (default the card).  Frame f draws with seed f.

    python -m texir_code_tpu_torch.tools.relighting_varying --mesh out1.obj \
        --albedo a.hdr --roughness r.hdr --out-dir frames \
        [--frames 30] [--mode color|move] [--spp 16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_sequence(
    mesh,
    albedo: np.ndarray,
    roughness: np.ndarray,
    cam_position,
    num_frames: int = 30,
    mode: str = "color",
    pano_res=(64, 128),
    spp: int = 16,
    denoise: bool = True,
    base_radiance: float = 30.0,
    device="cuda",
):
    """The sequence's frames ([h, w, 3] float32 each).  The tracer (its BVH
    and atlases) is built once; each frame swaps in its light."""
    import torch

    from texir_code_tpu_torch.eval.path_tracer import (
        PathTracedMaterialModel,
        light_under_camera,
    )
    from texir_code_tpu_torch.ops.postprocess import atrous_denoise

    cam = np.asarray(cam_position, np.float32)
    tracer = None
    frames = []
    for f in range(num_frames):
        t = f / max(num_frames - 1, 1)
        if mode == "color":
            color = np.asarray(
                [1.0, 1.0 - 0.8 * t, 1.0 - 0.8 * t], np.float32
            ) * base_radiance
            light = light_under_camera(cam, radiance=color)
        else:  # moving light along +x
            pos = cam + np.asarray([2.0 * t - 1.0, 0.0, 0.0], np.float32)
            light = light_under_camera(pos, radiance=(base_radiance,) * 3)
        if tracer is None:
            tracer = PathTracedMaterialModel(
                mesh, albedo, roughness, [light], max_bounces=2, spp=spp,
                device=device)
        else:
            tracer.set_lights([light])
        img = tracer.render_pano(cam, pano_res, seed=f)
        if denoise:
            img = atrous_denoise(
                torch.from_numpy(img).to(tracer.device)).cpu().numpy()
        frames.append(img)
    return frames


def main(argv=None):
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.geometry import load_obj

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--albedo", required=True)
    ap.add_argument("--roughness", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--mode", choices=["color", "move"], default="color")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--cam", type=float, nargs=3, default=[2.0, 1.5, 2.5])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = load_obj(args.mesh)
    albedo = hdrio.read_hdr(args.albedo)
    roughness = hdrio.read_hdr(args.roughness)[..., 0:1]
    os.makedirs(args.out_dir, exist_ok=True)
    frames = render_sequence(
        mesh, albedo, roughness, args.cam,
        num_frames=args.frames, mode=args.mode, spp=args.spp,
        device=args.device,
    )
    for i, img in enumerate(frames):
        hdrio.write_hdr(os.path.join(args.out_dir, f"relit_{i:04d}.hdr"), img)
    print(f"wrote {len(frames)} frames to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
