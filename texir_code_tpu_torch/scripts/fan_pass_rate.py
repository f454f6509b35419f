"""CPU replay of the fan stream's t test (kernels B2/B3): how often it passes.

    python -m texir_code_tpu_torch.scripts.fan_pass_rate [--texels 4] [--res 256]

Run it from the root of a checkout: its scene and rays are chip_smoke.py's
(the bench apartment; `--texels` bake texels of a `--res`² atlas, 2048
uniform rays each, one shared origin a texel).  Every ray meets every real
triangle in row order with fan_stream_plain's arithmetic.  It prints the
share of (ray, triangle) tests that pass |n·d| > 1e-12, t > 0 and t < the
ray's best t so far — after which csrc/fan_stream.cu forms barycentrics —
and, for groups of G consecutive rays (G = 32 · rays a thread: a warp),
the share of (group, triangle) pairs in which some ray of the group passes:
the warp then enters the barycentric path.  Rays in their order, sorted by
octant, and sorted by the kernel's 64 direction bins, each within blocks of
1024 rays.  Plain arithmetic on the CPU: counts of the algorithm, not
device numbers.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

BLOCK = 1024  # rays of a block at 4 rays a thread


def dir_bin(d):
    """csrc/fan_stream.cu::dir_bin: each component to 4 levels, Morton."""
    q = [torch.clamp((a + 1.0) * 2.0, 0.0, 3.0).floor().long() for a in d]
    return ((q[0] >> 1) << 5 | (q[1] >> 1) << 4 | (q[2] >> 1) << 3
            | (q[0] & 1) << 2 | (q[1] & 1) << 1 | (q[2] & 1))


def octant(d):
    return (d[0] < 0).long() * 4 + (d[1] < 0).long() * 2 + (d[2] < 0).long()


def pass_shares(tri, o, d, groups):
    """(per-ray pass share, {G: per-group pass share}) over rays o, d
    (3-tuples of [N]) against records tri [K, 12], in chunks of 1024."""
    passes, per_group = [], {g: [] for g in groups}
    col = [tri[None, :, i] for i in range(12)]
    nx, ny, nz, pd, s1x, s1y, s1z, p0s1, s2x, s2y, s2z, p0s2 = col
    for c0 in range(0, d[0].numel(), BLOCK):
        ox, oy, oz = (a[c0:c0 + BLOCK, None] for a in o)
        dx, dy, dz = (a[c0:c0 + BLOCK, None] for a in d)
        nd = nx * dx + ny * dy + nz * dz
        ok = nd.abs() > 1e-12
        t = (pd - (nx * ox + ny * oy + nz * oz)) / torch.where(ok, nd, 1.0)
        uu = (s1x * ox + s1y * oy + s1z * oz - p0s1) + t * (
            s1x * dx + s1y * dy + s1z * dz)
        vv = (s2x * ox + s2y * oy + s2z * oz - p0s2) + t * (
            s2x * dx + s2y * dy + s2z * dz)
        hit = (ok & (t > 0) & (torch.minimum(uu, vv) >= -1e-7)
               & (uu + vv <= 1 + 1e-7))
        best = torch.cummin(torch.where(hit, t, float("inf")), dim=1).values
        before = torch.cat([torch.full_like(best[:, :1], float("inf")),
                            best[:, :-1]], 1)
        p = ok & (t > 0) & (t < before)
        passes.append(p.float().mean())
        for g in groups:
            per_group[g].append(p.reshape(-1, g, p.shape[1]).any(1)
                                .float().mean())
    return (float(torch.stack(passes).mean()),
            {g: float(torch.stack(v).mean()) for g, v in per_group.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--texels", type=int, default=4)
    ap.add_argument("--res", type=int, default=256)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the checkout's root
    import chip_smoke as C
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene
    from texir_code_tpu_torch.ops.fan_raycast import pack_records
    from texir_code_tpu_torch.ops.sampling import generate_dir_soa

    syn = make_apartment_scene(atlas_res=256, subdiv=24)
    tri, _ = pack_records(torch.from_numpy(C.fan_scene(syn.mesh).rows))
    pts, nrm, ids = C.bake_texels(syn, args.texels, res=args.res)
    n = torch.from_numpy(nrm)
    d = tuple(a.reshape(-1) for a in generate_dir_soa(
        tuple(n[:, k] for k in range(3)), C.SPP, mode="uniform",
        row_ids=torch.from_numpy(ids), seed=777))
    o = tuple((torch.from_numpy(pts[:, k]) + 1e-2 * n[:, k])
              .repeat_interleave(C.SPP) for k in range(3))
    print(f"{len(tri)} triangles, {d[0].numel()} rays of {args.texels} "
          f"texels")
    for name, key in (("in order", None), ("octant-sorted", octant),
                      ("bin-sorted", dir_bin)):
        ds = d
        if key is not None:
            perm = torch.cat([b0 + torch.argsort(key(tuple(
                a[b0:b0 + BLOCK] for a in d)), stable=True)
                for b0 in range(0, d[0].numel(), BLOCK)])
            ds = tuple(a[perm] for a in d)
        ray, group = pass_shares(tri, o, ds, (32, 64, 128, 256))
        print(f"[pass-rate] {name}: per ray {ray:.4f}; per group of "
              + ", ".join(f"{g}: {v:.4f}" for g, v in group.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
