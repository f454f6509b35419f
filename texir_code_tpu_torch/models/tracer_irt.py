"""IrT — Monte-Carlo irradiance-texture baking (stage IrrT).

The port of the JAX package's `models/tracer_irt.py` on its culled path.
Per-texel world positions/normals come from a texture-space rasterization
of the uv-unwrapped mesh (host numpy or the native C++ rasterizer); the
bake is the reference's estimator — S uniform hemisphere samples per texel,
irradiance = Σ L·ndl·2π/S (reference models/tracer_o3d_irt.py:156-174) —
streamed through the device in fixed-size texel batches.  Each texel is
one ray fan: its directions are octant-sorted and split into wedge rows,
traced by the culled cluster walk (ops.pallas_culled, a CUDA kernel on the
card) with the hit's atlas uv interpolated in the walk, and the radiance
read with one fetch from the prefiltered RGBE atlas.  Multi-room scans
trace in two passes (`two_pass_cut`) and may seed the walk from an
occlusion proxy (`proxy_scene`); both are exact.  Cluster rows without
uv columns give prim + barycentrics instead, and the radiance is an exact
bilinear fetch from the RGBE atlas.  A baker given only a FanScene traces
each fan against every leaf row when its leaf budget covers the scene
(ops.pallas_fan, another CUDA kernel), or else against its first
`max_leaves` culled leaves, re-tracing overflowing fans with the BVH
(ops.fan_raycast.cast_ray_fans_exact).  A baker given neither scene
traces every ray with the BVH (`bake_irradiance_soa`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.models.tbl import (
    TBL,
    bilinear_rgbe,
    nearest_rgbe,
    query_tbl_fans,
    query_tbl_soa,
    radiance_from_hit,
    rgbe_pack,
    rgbe_prefilter,
)
from texir_code_tpu_torch.ops.fan_raycast import (
    FAN_ROW_WIDTH_UV,
    cast_ray_fans_exact,
)
from texir_code_tpu_torch.ops.pallas_fan import cast_ray_fans_pallas
from texir_code_tpu_torch.ops.pallas_culled import (
    cast_fans_culled,
    cast_fans_culled_twopass,
    sort_dirs_octant,
    tile_rows,
    wedge_rows,
)
from texir_code_tpu_torch.ops.sampling import (
    generate_dir_soa,
    hammersley_azimuth_sorted,
)
from texir_code_tpu_torch.ops.shading import irradiance_estimator_soa


def bake_irradiance_soa(tbl: TBL, points, normals, texel_ids: torch.Tensor,
                        seed: int, spp: int, surface_eps: float,
                        fan_scene=None, max_leaves: int = 768,
                        samples=None):
    """Core SoA bake: points/normals 3×[B] → irradiance 3×[B].

    The uniforms are keyed by (seed, global texel id), so a batch split
    changes nothing; `samples` ([B, spp, 2]) replaces them.  With
    `fan_scene` the rays go through the leaf-budgeted fan trace with
    tangent-plane culling (each texel one fan, query_tbl_fans); otherwise
    every ray through the BVH (query_tbl_soa)."""
    dirs = generate_dir_soa(normals, spp, mode="uniform", samples=samples,
                            row_ids=texel_ids, seed=seed)
    b = points[0].shape[0]
    origins = tuple(points[k] + surface_eps * normals[k] for k in range(3))
    if fan_scene is not None:
        lighting = query_tbl_fans(tbl, fan_scene, origins, dirs,
                                  fan_normals=normals, max_leaves=max_leaves)
    else:
        lighting = query_tbl_soa(
            tbl, tuple(o[:, None].expand(b, spp) for o in origins), dirs)
    return irradiance_estimator_soa(lighting, dirs, normals, spp)


def morton_order(points: np.ndarray) -> np.ndarray:
    """argsort of [N, 3] points by 30-bit Morton code of quantized position.

    Bake batches are built from atlas texels in raster order — consecutive
    texels of a scan-scale chart can lie METERS apart in world space, which
    ruins the culled tracer's per-block origin boxes (a block spanning the
    whole building culls nothing).  Sorting texels in Morton order makes
    every kernel block a tight spatial neighborhood; the estimator result is
    unchanged (per-texel scatter-back) and stays deterministic."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = (
        spread(q[:, 0])
        | (spread(q[:, 1]) << np.uint64(1))
        | (spread(q[:, 2]) << np.uint64(2))
    )
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class GeometryTextures:
    """Per-texel geometry of the uv atlas."""

    position: np.ndarray  # [R, R, 3] world position at the texel center
    normal: np.ndarray    # [R, R, 3] shading normal
    valid: np.ndarray     # [R, R] bool — texel is covered by a triangle


@profiling.timed("pack", "texels")
def bake_geometry_textures(
    mesh, res: int, offset: float = 0.0, use_native: bool = True
) -> GeometryTextures:
    """Texture-space rasterization: world position/normal per atlas texel.

    For every triangle, texels whose centers fall inside its uv footprint get
    barycentric-interpolated world position and vertex normal.  Dispatches to
    the C++ rasterizer (texir_code_tpu_torch.native) when available; this numpy
    loop is the fallback and oracle.

    Args:
        mesh: geometry.Mesh with uvs and vertex normals.
        res: atlas resolution (reference bakes 1024,
            models/tracer_o3d_irt.py:95).
        offset: displace positions by offset·normal (bake-time surface
            epsilon; the reference offsets at trace time instead).
    """
    if use_native and offset == 0.0:
        from texir_code_tpu_torch import native

        g = native.bake_geometry_native(mesh, res)
        if g is not None:
            return g
    if mesh.vertex_normals is None:
        mesh.compute_vertex_normals()
    position = np.zeros((res, res, 3), np.float32)
    normal = np.zeros((res, res, 3), np.float32)
    valid = np.zeros((res, res), bool)

    tri_uv = mesh.triangle_uvs().reshape(-1, 3, 2) * res - 0.5  # texel coords
    tri_pos = mesh.triangle_corners()
    tri_nrm = mesh.vertex_normals[mesh.faces]

    for f in range(mesh.num_faces):
        uv = tri_uv[f]
        lo = np.maximum(np.floor(uv.min(axis=0)).astype(int), 0)
        hi = np.minimum(np.ceil(uv.max(axis=0)).astype(int) + 1, res)
        if (hi <= lo).any():
            continue
        xs = np.arange(lo[0], hi[0])
        ys = np.arange(lo[1], hi[1])
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        p = np.stack([gx, gy], axis=-1).astype(np.float32)  # texel centers
        # barycentrics of p in the uv triangle
        a, b, c = uv[0], uv[1], uv[2]
        v0, v1 = b - a, c - a
        v2 = p - a
        d00 = v0 @ v0
        d01 = v0 @ v1
        d11 = v1 @ v1
        denom = d00 * d11 - d01 * d01
        if abs(denom) < 1e-12:
            continue
        d20 = v2 @ v0
        d21 = v2 @ v1
        u = (d11 * d20 - d01 * d21) / denom
        v = (d00 * d21 - d01 * d20) / denom
        w = 1.0 - u - v
        inside = (u >= -1e-6) & (v >= -1e-6) & (w >= -1e-6)
        if not inside.any():
            continue
        pos = (
            w[..., None] * tri_pos[f, 0]
            + u[..., None] * tri_pos[f, 1]
            + v[..., None] * tri_pos[f, 2]
        )
        nrm = (
            w[..., None] * tri_nrm[f, 0]
            + u[..., None] * tri_nrm[f, 1]
            + v[..., None] * tri_nrm[f, 2]
        )
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        rows, cols = gy[inside], gx[inside]
        position[rows, cols] = pos[inside] + offset * nrm[inside]
        normal[rows, cols] = nrm[inside]
        valid[rows, cols] = True
    return GeometryTextures(position=position, normal=normal, valid=valid)



class IrradianceTextureBaker:
    """One-shot MC bake of the irradiance texture (reference :145-180)."""

    def __init__(
        self,
        tbl: TBL,
        spp: int = 2048,
        texel_batch: int = 4096,
        surface_eps: float = 1e-2,
        fan_scene=None,
        max_leaves: int = 768,
        cluster_scene=None,
        wedges: int = 4,
        mesh=None,
    ):
        """Args:
            tbl: lighting scene; the bake runs on its device.
            spp: uniform hemisphere samples per texel (train.sample_light[0],
                2048 in configs/hdrhouse_ir_texture.conf).
            texel_batch: texels per bake step.
            surface_eps: ray-origin offset along the normal.
            fan_scene: ops.fan_raycast.FanScene — without a cluster scene,
                each texel's fan is traced exhaustively against every leaf
                row (ops.pallas_fan) when max_leaves covers the leaf count,
                else against its first max_leaves culled leaves with the
                overflowing fans re-traced by the BVH.  With neither scene
                every ray goes through the TBL's BVH.
            max_leaves: the fan path's per-texel leaf budget.
            cluster_scene: ops.pallas_culled.ClusterScene — the culled,
                early-exiting walk (exact); takes precedence over
                fan_scene.
            wedges: direction wedges per texel (spp/wedges rays per row).
            mesh: parallel.mesh.DeviceMesh whose ranks split the texel
                batches (rank r takes the contiguous share
                process_local_slice(nb, r, world) and one all-reduce (SUM)
                merges the disjoint rows: adding zeros changes no bit);
                default: this process alone.  Each texel's random numbers
                are keyed by its global id and every rank runs whole
                batches, so the texture is bit-identical for any rank
                count.
        """
        from texir_code_tpu_torch.parallel.mesh import one_rank_mesh

        self.tbl = tbl
        self.spp = spp
        self.texel_batch = texel_batch
        self.surface_eps = surface_eps
        self.fan_scene = fan_scene
        self.max_leaves = max_leaves
        self.cluster_scene = cluster_scene
        self.wedges = wedges
        self.mesh = mesh if mesh is not None else one_rank_mesh(
            tbl.planes[0].device)
        # how a texel's directions become wedge rows: "octant" sorts them by
        # world octant at run time (world-sign-pure wedges: the culling
        # boxes are world-axis-aligned); "azimuth" draws them from the
        # u2-sorted Hammersley table, so each wedge is an azimuth arc and
        # nothing is sorted
        self.chunk_mode = "octant"
        self.fan_block = 32
        # rows per independent exit group (0 = one group per fan block);
        # each group gets its own, tighter candidate list
        self.exit_rows = 0
        # kept for the JAX baker's interface: there it folds batches into
        # one device dispatch; here every batch is its own step
        self.batches_per_dispatch = 4
        # two-pass trace (ops.pallas_culled.cast_fans_culled_twopass):
        # truncate the walk at two_pass_cut x scene diameter and re-trace
        # the few rays that need farther clusters.  Exact; pays on
        # multi-room scans.  None = single pass.
        self.two_pass_cut: Optional[float] = None
        self.two_pass_cap = 0.125
        # optional second level (3-pass ladder): the re-trace itself
        # truncates at two_pass_cut2 and re-compacts its own tail
        self.two_pass_cut2: Optional[float] = None
        self.two_pass_cap2 = 0.25
        # occlusion proxy (ops.pallas_culled.ClusterScene.proxy_from_fan):
        # the scene's k largest triangles, traced first to seed per-ray t
        # upper bounds.  Exact.  None = off.
        self.proxy_scene = None
        # proven rectangular occluders (geometry.occluders): exact PVS
        # culling of the candidate lists; None = off
        self.occluders = None
        self._rgbe = rgbe_pack(torch.stack(tbl.planes, dim=-1))
        # 2x-supersampled prefiltered atlas: radiance in ONE word fetch
        # (bilinear snapped to the nearest half-texel);
        # rgbe_supersample=0 selects the exact 4-fetch bilinear instead
        self.rgbe_supersample = 2
        self._rgbe_pre = rgbe_prefilter(tbl.planes, 2)
        self._fan_has_uv = (
            fan_scene is not None
            and fan_scene.rows.shape[1] >= FAN_ROW_WIDTH_UV
        )

    @property
    def device(self) -> torch.device:
        return self.tbl.planes[0].device

    def _bake_culled_impl(self, points, normals, texel_ids, seed, samples=None):
        """Culled wedge path: one texel = one fan, its spp directions
        octant-sorted (chunk_mode "octant") or drawn in azimuth order
        ("azimuth") and split into `wedges` rows; hits from the culled
        walk with the atlas uv interpolated in the walk when the cluster
        rows carry per-triangle uv coefficients (radiance one RGBE fetch a
        ray), else prim + barycentrics (_fan_estimate_prim_rgbe).  Spans:
        `bake.dirs` (the directions and the wedge rows), the trace's own,
        `bake.estimate` (the estimator and the wedges' sum)."""
        scene = self.cluster_scene
        emit_uv = bool(scene.has_uv)
        nrm = tuple(normals[:, k] for k in range(3))
        g = self.wedges
        with profiling.span("bake.dirs"):
            if self.chunk_mode == "azimuth":
                ds = generate_dir_soa(
                    nrm, self.spp, mode="uniform", samples=samples,
                    row_ids=texel_ids, seed=seed,
                    base=hammersley_azimuth_sorted(self.spp, points.device),
                )
            else:
                ds = sort_dirs_octant(generate_dir_soa(
                    nrm, self.spp, mode="uniform", samples=samples,
                    row_ids=texel_ids, seed=seed,
                ))
            rows_d = tuple(wedge_rows(a, g) for a in ds)
            origins = tuple(
                points[:, k] + self.surface_eps * normals[:, k]
                for k in range(3)
            )
            rows_o = tuple(tile_rows(a, g) for a in origins)
        if self.two_pass_cut is not None:
            hit = cast_fans_culled_twopass(
                scene, rows_o, rows_d,
                emit_uv=emit_uv,
                fan_block=self.fan_block,
                exit_rows=self.exit_rows,
                cut_frac=self.two_pass_cut,
                cap_frac=self.two_pass_cap,
                proxy=self.proxy_scene,
                cut_frac2=self.two_pass_cut2,
                cap_frac2=self.two_pass_cap2,
                occluders=self.occluders,
            )
        else:
            hit = cast_fans_culled(
                scene, rows_o, rows_d,
                emit_uv=emit_uv,
                fan_block=self.fan_block,
                exit_rows=self.exit_rows,
                proxy=self.proxy_scene,
                occluders=self.occluders,
            )
        with profiling.span("bake.estimate"):
            rows_n = tuple(tile_rows(a, g) for a in nrm)
            if emit_uv:
                part = self._fan_estimate_uv(hit.t, hit.u, hit.v, rows_d,
                                             rows_n)
            else:
                part = self._fan_estimate_prim_rgbe(hit, rows_d, rows_n)
            t = points.shape[0]
            return part.reshape(g, t, 3).sum(dim=0)

    def _fan_estimate_uv(self, hit_t, uu, vv, dirs, normals_soa):
        """Estimator for the uv-emitting walk: the hit's atlas uv is
        already interpolated, radiance is one RGBE fetch (prefiltered
        supersampled atlas: 1 fetch; rgbe_supersample=0 → exact bilinear:
        4 fetches)."""
        valid = torch.isfinite(hit_t) & (hit_t > 1e-4)
        u = torch.clamp(uu, 0.0, 1.0)
        v = torch.clamp(vv, 0.0, 1.0)
        if self.rgbe_supersample:
            r, g, b = nearest_rgbe(self._rgbe_pre, u, v)
        else:
            r, g, b = bilinear_rgbe(self._rgbe, u, v)
        z = torch.zeros_like(r)
        lighting = (
            torch.where(valid, r, z),
            torch.where(valid, g, z),
            torch.where(valid, b, z),
        )
        return torch.stack(
            irradiance_estimator_soa(lighting, dirs, normals_soa, self.spp),
            dim=-1,
        )

    def _fan_estimate_prim_rgbe(self, hit, dirs, normals_soa):
        """Estimator from barycentric hits: per-corner uv lerp and one exact
        bilinear fetch from the RGBE atlas a ray."""
        valid = torch.isfinite(hit.t) & (hit.t > 1e-4)
        prim = torch.where(valid, hit.prim, 0).to(torch.int64)
        u = torch.clamp(hit.u, 0.0, 1.0)
        v = torch.clamp(hit.v, 0.0, 1.0)
        w0 = 1.0 - u - v
        base = prim * 3
        uv_u, uv_v = self.tbl.uv_u, self.tbl.uv_v
        uu = uv_u[base] * w0 + uv_u[base + 1] * u + uv_u[base + 2] * v
        vv = uv_v[base] * w0 + uv_v[base + 1] * u + uv_v[base + 2] * v
        rgb = bilinear_rgbe(self._rgbe, torch.clamp(uu, 0.0, 1.0),
                            torch.clamp(vv, 0.0, 1.0))
        lighting = tuple(torch.where(valid, c, torch.zeros_like(c))
                         for c in rgb)
        return torch.stack(
            irradiance_estimator_soa(lighting, dirs, normals_soa, self.spp),
            dim=-1,
        )

    def _bake_fan_impl(self, points, normals, texel_ids, seed, samples=None):
        """Fan path: one texel = one shared-origin row of its spp
        directions (no octant sort, no wedges).  With a leaf budget that
        covers the scene each fan is traced against every leaf row; with
        uv rows the stream interpolates the hit's atlas uv (one RGBE fetch
        a ray).  With a smaller budget each fan is traced against its
        first max_leaves culled leaves and an overflowing fan again by the
        BVH (cast_ray_fans_exact).  Without uv rows, or with the budget,
        radiance comes from prim + barycentrics (radiance_from_hit)."""
        nrm = tuple(normals[:, k] for k in range(3))
        dirs = generate_dir_soa(
            nrm, self.spp, mode="uniform", samples=samples,
            row_ids=texel_ids, seed=seed,
        )
        origins = tuple(
            points[:, k] + self.surface_eps * normals[:, k] for k in range(3)
        )
        if self.max_leaves < self.fan_scene.num_leaves:
            hit = cast_ray_fans_exact(
                self.fan_scene, self.tbl.bvh, origins, dirs, t_min=0.0,
                max_leaves=self.max_leaves, fan_normals=nrm,
            )
        else:
            hit = cast_ray_fans_pallas(
                self.fan_scene, origins, dirs, t_min=0.0, fan_block=8,
                leaf_block=32, emit_uv=self._fan_has_uv,
            )
            if self._fan_has_uv:
                return self._fan_estimate_uv(hit.t, hit.u, hit.v, dirs, nrm)
        lighting = radiance_from_hit(self.tbl, hit)
        return torch.stack(
            irradiance_estimator_soa(lighting, dirs, nrm, self.spp), dim=-1)

    def bake_batch(
        self,
        points: torch.Tensor,
        normals: torch.Tensor,
        texel_ids: torch.Tensor,
        seed: int,
        samples: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Irradiance for one flat batch of texels: [B, 3] → [B, 3].

        The random numbers are a pure function of (seed, global texel id),
        so results do not depend on batching.  samples: optional
        [B, spp, 2] uniforms that replace the drawn ones (parity tests feed
        the JAX reference's own draws through it; under chunk_mode
        "azimuth" the culled path takes them in the azimuth table's order,
        as the JAX baker draws them).  Under the span `bake.batch`."""
        if self.cluster_scene is not None:
            impl = self._bake_culled_impl
        elif self.fan_scene is not None:
            impl = self._bake_fan_impl
        else:
            impl = self._bake_batch_traversal
        with profiling.span("bake.batch"):
            return impl(points, normals, texel_ids, seed, samples)

    def _bake_batch_traversal(self, points, normals, texel_ids, seed,
                              samples=None):
        """No scene but the TBL's BVH: every ray traced by the traversal."""
        return torch.stack(bake_irradiance_soa(
            self.tbl, tuple(points[:, k] for k in range(3)),
            tuple(normals[:, k] for k in range(3)), texel_ids, seed,
            self.spp, self.surface_eps, samples=samples), dim=-1)

    def bake(
        self,
        geom: GeometryTextures,
        generator: torch.Generator,
        progress: bool = False,
    ) -> np.ndarray:
        """Full-texture bake: [R, R, 3] irradiance; invalid texels zero.

        Streams texel batches (Morton-ordered, so each block of rows is a
        tight spatial neighborhood) through `bake_batch`; total rays =
        valid_texels × spp.  The bake seed is drawn from `generator`.
        Under a mesh of several ranks each traces its share of the batches
        and every rank returns the whole texture."""
        from texir_code_tpu_torch.parallel.mesh import pad_to_multiple

        dev = self.device
        res = geom.position.shape[0]
        vr, vc = np.nonzero(geom.valid)
        order = morton_order(geom.position[vr, vc])
        vr, vc = vr[order], vc[order]
        n = len(vr)
        bs = self.texel_batch
        padded = pad_to_multiple(n, bs)
        nb = padded // bs
        pts = torch.zeros((padded, 3), dtype=torch.float32, device=dev)
        nrm = torch.zeros((padded, 3), dtype=torch.float32, device=dev)
        nrm[:, 2] = 1.0
        pts[:n] = torch.from_numpy(geom.position[vr, vc]).to(dev)
        nrm[:n] = torch.from_numpy(geom.normal[vr, vc]).to(dev)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        ids = torch.arange(padded, dtype=torch.int64, device=dev)
        out = torch.zeros((padded, 3), dtype=torch.float32, device=dev)
        # batches whose two-pass trace took the full-trace branch
        self.overflowed_batches = []
        twopass = profiling.counter("twopass")
        share = self.mesh.share(nb)
        mine = range(share.start, share.stop)
        for k, i in enumerate(mine):
            sl = slice(i * bs, (i + 1) * bs)
            before = twopass["overflows"]
            out[sl] = self.bake_batch(pts[sl], nrm[sl], ids[sl], seed)
            if twopass["overflows"] > before:
                self.overflowed_batches.append(i)
            if progress and (k + 1) % 16 == 0:
                print(f"bake: {k + 1}/{len(mine)} batches")
        self.mesh.all_reduce_(out)  # the ranks' disjoint rows
        tex = np.zeros((res, res, 3), np.float32)
        tex[vr, vc] = out[:n].cpu().numpy()
        return tex
