"""The work a culled walk's inputs need, counted by the frozen copy of
today's packing, culling and plain walk (port_bench.frozen), so that the
count is the same whatever implements the walk.

A ray needs every candidate of its exit group's near-to-far list whose
distance bound lies below its closest hit (capped at 1.05 scene
diameters), lb x 4 triangle tests each; the bytes are the walk's inputs
read once and its outputs written once.  The closest hits come from the
frozen plain walk over the whole, untruncated list: a two-pass trace or
a proxy seed needs no more than this.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.frozen import cluster as fz
from port_bench.frozen.bvh import build_bvh
from port_bench.frozen.occluders import extract_occluders
from port_bench.readings import WalkWork


class FrozenScene:
    """The scene packed by the frozen code at the cell's cluster size."""

    def __init__(self, mesh, lb: int, occluders: bool, device):
        flat = build_bvh(mesh.vertices, mesh.faces)
        tuv = mesh.uvs[mesh.uv_faces].reshape(-1, 2)
        fan = fz.FanScene.from_flat(flat, triangle_uvs=tuv)
        self.clusters = fz.ClusterScene.from_fan(fan, lb=lb, device=device)
        self.occluders = (extract_occluders(mesh, device=device)
                          if occluders else None)


def walk_work(fs: FrozenScene, origins, dirs, fan_block: int,
              exit_rows: int, per_ray: bool) -> WalkWork:
    """Tests and bytes the walk of these rows needs.

    origins: 3 x [T] shared row origins, or 3 x [T, R] with per_ray;
    dirs: 3 x [T, R]."""
    scene = fs.clusters
    tp, r = dirs[0].shape
    tf = fan_block
    pad = (-tp) % tf

    def padded(a):
        if not pad:
            return a
        z = torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
        return torch.cat([a, z])

    o = tuple(padded(a) for a in origins)
    d = tuple(padded(a).contiguous() for a in dirs)
    er = exit_rows if (exit_rows and tf % exit_rows == 0) else tf
    if per_ray:
        lo = tuple(a.amin(dim=1) for a in o)
        hi = tuple(a.amax(dim=1) for a in o)
        o_pack = torch.stack(o, dim=0).contiguous()
    else:
        lo = hi = o
        o_pack = torch.stack(o, dim=-1).contiguous()
    cand, count, dist = fz.cull_blocks(scene, lo, hi, d, er,
                                       occluders=fs.occluders)
    g = (tp + pad) // er
    cc = scene.num_clusters
    count = count.reshape(g).contiguous()
    cand = cand.reshape(g, cc).contiguous()
    dist = dist.reshape(g, cc).contiguous()
    t_cap = float(np.float32(1.05) * np.float32(scene.diameter))
    t, _, _, _ = fz.culled_walk_plain(
        count, cand, dist, t_cap, o_pack, d[0], d[1], d[2], scene.rows3,
        scene.prims3, er, emit_uv=False, emit_prim=False, per_ray=per_ray)
    t_fin = torch.clamp_max(t, t_cap).reshape(g, -1).contiguous()
    need = torch.searchsorted(dist, t_fin)
    need = torch.minimum(need, count[:, None].long())
    need = need.reshape(g * er, r)[:tp]  # padding rows need nothing
    tests = int(need.sum()) * scene.rows3.shape[1] * 4
    rays = d[0].numel()
    nbytes = sum(x.numel() * x.element_size() for x in
                 (count, cand, dist, o_pack, d[0], d[1], d[2],
                  scene.rows3)) + rays * 16
    return WalkWork(tests=tests, nbytes=nbytes)
