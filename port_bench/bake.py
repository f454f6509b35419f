"""The IrrT bake cells: `IrradianceTextureBaker.bake_batch` streamed over
the atlas as `bake` streams it.

Set-up builds the configuration's scene (port_bench.scenes), packs it
for the card through the program (BVH, TBL, leaf rows, cluster scene,
occluders), rasterizes the atlas' texels and orders them as `bake` does
(Morton order, fixed-size batches, global texel ids), then bakes two
batches to warm up.  The window streams batch after batch with no host
sync between them (the two-pass trace syncs once a batch by itself),
wrapping over the atlas with a fresh bake seed drawn from --seed on each
pass, and ends in a device sync.  bake_mrays_per_s is every finished
batch's valid texels x spp over the window's wall time.

Afterwards a sample of the texels baked in the window, drawn from the
seed, is held against the plain reference (reference/bake_ref.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import scenes
from port_bench.readings import Readings
from port_bench.trace import patched, span, traced_window


class Program:
    """The program's baker for a configuration, on `device`."""

    def __init__(self, scene, cfg: dict, device):
        from texir_code_tpu_torch.geometry.bvh import build_bvh
        from texir_code_tpu_torch.geometry.mesh import Mesh
        from texir_code_tpu_torch.geometry.occluders import extract_occluders
        from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
        from texir_code_tpu_torch.models.tracer_irt import (
            IrradianceTextureBaker,
            bake_geometry_textures,
            morton_order,
        )
        from texir_code_tpu_torch.ops.fan_raycast import FanScene
        from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

        m = scene.mesh
        mesh = Mesh(vertices=m.vertices.copy(), faces=m.faces.copy(),
                    uvs=m.uvs.copy(), uv_faces=m.uv_faces.copy())
        mesh.compute_vertex_normals()
        flat = build_bvh(mesh.vertices, mesh.faces)
        tbl = build_tbl_from_flat(flat, mesh, scene.hdr_texture,
                                  device=device)
        fan = FanScene.from_flat(flat, triangle_uvs=mesh.triangle_uvs())
        clusters = ClusterScene.from_fan(fan, lb=cfg["cluster_lb"],
                                         dense=True, device=device)
        baker = IrradianceTextureBaker(
            tbl, spp=cfg["spp"], texel_batch=cfg["texel_batch"],
            surface_eps=cfg["surface_eps"], cluster_scene=clusters,
            wedges=cfg["wedges"])
        baker.fan_block = cfg["fan_block"]
        baker.exit_rows = cfg["exit_rows"]
        baker.two_pass_cut = cfg["two_pass_cut"]
        baker.two_pass_cap = cfg["two_pass_cap"]
        if cfg["occluders"]:
            baker.occluders = extract_occluders(mesh, device=device)
        self.baker = baker

        # the texels as `bake` orders and batches them
        geom = bake_geometry_textures(mesh, cfg["atlas_res"])
        vr, vc = np.nonzero(geom.valid)
        order = morton_order(geom.position[vr, vc])
        self.rows, self.cols = vr[order], vc[order]
        self.n = len(order)
        bs = baker.texel_batch
        self.batches = -(-self.n // bs)
        padded = self.batches * bs
        pts = torch.zeros((padded, 3), dtype=torch.float32, device=device)
        nrm = torch.zeros((padded, 3), dtype=torch.float32, device=device)
        nrm[:, 2] = 1.0
        pts[:self.n] = torch.from_numpy(
            geom.position[self.rows, self.cols]).to(device)
        nrm[:self.n] = torch.from_numpy(
            geom.normal[self.rows, self.cols]).to(device)
        self.pts, self.nrm = pts, nrm
        self.ids = torch.arange(padded, dtype=torch.int64, device=device)
        self.padded = padded

    def batch(self, i: int, seed: int) -> torch.Tensor:
        bs = self.baker.texel_batch
        sl = slice(i * bs, (i + 1) * bs)
        return self.baker.bake_batch(self.pts[sl], self.nrm[sl],
                                     self.ids[sl], seed)

    def valid_in(self, i: int) -> int:
        bs = self.baker.texel_batch
        return max(0, min(self.n - i * bs, bs))


def pass_seeds(seed: int):
    """The bake seed of each pass over the atlas, drawn from --seed."""
    rng = np.random.default_rng([int(seed) % 2**63, 0])
    while True:
        yield int(rng.integers(0, 2**31 - 1))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, check=None, keep=None):
    """One run of a bake cell.  Returns (Readings, e2e values, checks,
    attempted, failed, memory peak).  `check` replaces the comparison
    with the reference (the control's and the tests' hook); `keep`, a
    dict, keeps the scene and the program for the next call with it (the
    control's seeds in one process)."""
    cfg = cell.config["bake"]
    traffic = cell.traffic
    t0 = time.time()
    if keep is not None and "prog" in keep:
        scene, prog = keep["scene"], keep["prog"]
    else:
        scene = scenes.make(cell.config)
        prog = Program(scene, cfg, device)
        if keep is not None:
            keep.update(scene=scene, prog=prog)
    sync(device)
    pack_s = time.time() - t0

    # warm-up: every shape the window uses is a batch's
    for i in range(min(2, prog.batches)):
        prog.batch(i, 12345 + i)
    sync(device)
    setup_s = time.time() - t_start

    seeds = pass_seeds(seed)
    outs, pass_seed = [], []
    done = 0  # batches enqueued (and, after the sync, finished)
    rays = 0
    limit = traffic["trace_batches"] if trace else None
    holder = None

    def stream():
        nonlocal done, rays
        tw = time.perf_counter()
        while True:
            p, i = divmod(done, prog.batches)
            if i == 0:
                pass_seed.append(next(seeds))
                outs.append(torch.zeros((prog.padded, 3),
                                        dtype=torch.float32, device=device))
            bs = prog.baker.texel_batch
            with span("batch"):
                outs[p][i * bs:(i + 1) * bs] = prog.batch(i, pass_seed[p])
            done += 1
            rays += prog.valid_in(i) * prog.baker.spp
            if limit is not None:
                if done >= limit:
                    break
            elif time.perf_counter() - tw >= seconds:
                break

    from texir_code_tpu_torch.ops import pallas_culled

    sync(device)
    w0 = time.perf_counter()
    if trace:
        with patched(pallas_culled, "cull_blocks", "cull"):
            with traced_window(device) as holder:
                stream()
    else:
        stream()
    sync(device)
    window_s = time.perf_counter() - w0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    # what the window produced: failed = batches with a non-finite texel
    bs = prog.baker.texel_batch
    failed = 0
    for p, out in enumerate(outs):
        n_b = min(prog.batches, done - p * prog.batches)
        ok = torch.isfinite(out[:n_b * bs].reshape(n_b, -1)).all(dim=1)
        failed += int((~ok).sum())
    # the sample to check, drawn from the seed among the texels baked
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    baked = [(p, min(prog.n, (min(prog.batches, done - p * prog.batches))
                     * bs)) for p in range(len(outs))]
    total = sum(n for _, n in baked)
    k = min(traffic["check_texels"], total)
    picks = np.sort(rng.choice(total, size=k, replace=False))
    sample = []
    for flat in picks:
        for p, n in baked:
            if flat < n:
                sample.append((p, int(flat)))
                break
            flat -= n
    got = torch.stack([outs[p][i] for p, i in sample]).cpu()
    sample_rows = prog.rows[[i for _, i in sample]]
    sample_cols = prog.cols[[i for _, i in sample]]
    sample_ids = [i for _, i in sample]
    sample_seeds = [pass_seed[p] for p, _ in sample]

    walk = None
    if trace:
        walk = _walk_work(scene, cfg, prog, pass_seed, limit, device)
    host = {"pack_s": pack_s}
    del prog, outs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if check is None:
        check = reference_check
    checks = check(scene=scene, cfg=cfg, got=got, rows=sample_rows,
                   cols=sample_cols, ids=sample_ids, seeds=sample_seeds,
                   device=device)
    readings = Readings(kind="bake", units=done,
                        trace=holder.trace if holder else None, host=host,
                        walk=walk)
    e2e = {"bake_mrays_per_s": rays / window_s / 1e6, "setup_s": setup_s}
    return readings, e2e, checks, done, failed, memory_peak


def reference_check(scene, cfg, got, rows, cols, ids, seeds, device,
                    dtype=torch.float32):
    """The sampled texels against the plain reference: (value, limit)
    of each number compared."""
    from port_bench.reference import bake_ref

    ref_scene = bake_ref.Scene(scene.mesh, scene.hdr_texture, device,
                               dtype=dtype)
    ref, covered = bake_ref.irradiance(
        ref_scene, scene.mesh, cfg["atlas_res"], cfg["spp"],
        cfg["surface_eps"], rows, cols, ids, seeds)
    return compare(got, ref.cpu(), covered, cfg["limits"])


def compare(got: torch.Tensor, ref: torch.Tensor, covered, limits: dict):
    """The numbers a bake is judged by, each with its limit:
    irr_rel_l2: |got - ref| / |ref| over all sampled texels' channels;
    texel_rel_max: the worst texel's |got - ref| over the larger of its
    |ref| and the median texel's; uncovered: texels the program baked
    that no triangle covers."""
    got = got.double()
    ref = ref.double()
    bad = ~torch.isfinite(got).all(dim=1)
    got = torch.where(bad[:, None], torch.full_like(got, 1e30), got)
    err = (got - ref).norm(dim=1)
    mag = ref.norm(dim=1)
    floor = torch.clamp_min(mag, float(mag.median()))
    vals = {
        "irr_rel_l2": float((got - ref).norm() / ref.norm().clamp_min(1e-30)),
        "texel_rel_max": float((err / floor.clamp_min(1e-30)).max()),
        "uncovered": float((~torch.as_tensor(covered)).sum()),
    }
    return {k: (v, float(limits[k])) for k, v in vals.items()}


def _walk_work(scene, cfg, prog, pass_seed, n_batches, device):
    """The walk's needed work on the traced batches' rays, counted by the
    frozen code (port_bench.roofline) from the rays the benchmark draws
    itself for those texels."""
    from port_bench import roofline
    from port_bench.frozen import cluster as fz
    from port_bench.reference import bake_ref
    from port_bench.readings import WalkWork

    fs = roofline.FrozenScene(scene.mesh, cfg["cluster_lb"],
                              cfg["occluders"], device)
    base = torch.as_tensor(bake_ref.hammersley(cfg["spp"]), device=device)
    g = cfg["wedges"]
    bs = cfg["texel_batch"]
    total = WalkWork(tests=0, nbytes=0)
    for k in range(n_batches):
        p, i = divmod(k, prog.batches)
        sl = slice(i * bs, (i + 1) * bs)
        pts, nrm, ids = prog.pts[sl], prog.nrm[sl], prog.ids[sl]
        shift = bake_ref.hash_uniforms(pass_seed[p], ids, 2)
        d = bake_ref.hemisphere_dirs(nrm, shift, base)  # [B, S, 3]
        ds = fz.sort_dirs_octant(tuple(d[..., c] for c in range(3)))
        rows_d = tuple(fz.wedge_rows(a, g) for a in ds)
        o = pts + cfg["surface_eps"] * nrm
        rows_o = tuple(fz.tile_rows(o[:, c], g) for c in range(3))
        w = roofline.walk_work(fs, rows_o, rows_d, cfg["fan_block"],
                               cfg["exit_rows"], per_ray=False)
        total = WalkWork(tests=total.tests + w.tests,
                         nbytes=total.nbytes + w.nbytes)
    return total
