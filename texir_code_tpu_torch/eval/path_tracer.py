"""Monte-Carlo path tracer over the recovered materials — the redner
replacement for relighting evaluation.

The port of the JAX package's `eval/path_tracer.py` (reference
models/test_redner.py:35-285): the recovered SVBRDF atlases are re-lit by
explicit quad area lights (one under each camera, :117-124) and rendered
by path tracing on the port's BVH traversal (`ops/raycast.py::
cast_rays_soa`, plain PyTorch, as the JAX package leaves it to XLA):

  * next-event estimation at every bounce (one uniform sample on every
    quad light + a shadow ray);
  * cosine-sampled diffuse bounces, throughput *= albedo, with the
    Cook-Torrance BRDF toward the lights;
  * fixed bounce count and spp.

Random numbers.  Every uniform is `hash_uniform(seed, path id, stream)`,
the path id being (sample, pixel) and the stream naming (bounce, light,
su/sv) or (bounce, u1/u2).  A path's draws therefore depend on nothing
else, so `render_pano` traces all `spp` samples of a view as one ray
batch (and all lights' shadow rays of a bounce as one cast): a view is
2 · max_bounces casts, not spp · max_bounces · (1 + lights) as in the
JAX loop, with the same image however the samples are batched.  Tests
inject JAX's own draws through `trace(draws=)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.raycast import cast_rays_soa
from texir_code_tpu_torch.ops.sampling import (
    TINY_NUMBER,
    generate_dir_soa,
    hash_uniform,
)
from texir_code_tpu_torch.ops.texture import bilinear_sample


@dataclasses.dataclass
class QuadLight:
    """Rectangular area light: corner + two edges, constant radiance."""

    corner: np.ndarray    # [3]
    edge_u: np.ndarray    # [3]
    edge_v: np.ndarray    # [3]
    radiance: np.ndarray  # [3]

    @property
    def area(self) -> float:
        return float(np.linalg.norm(np.cross(self.edge_u, self.edge_v)))

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.edge_u, self.edge_v)
        return n / max(np.linalg.norm(n), 1e-12)


def light_under_camera(
    cam_position: np.ndarray,
    size: float = 0.3,
    drop: float = 0.2,
    radiance: Sequence[float] = (30.0, 30.0, 30.0),
) -> QuadLight:
    """The reference's add_light_source: a small quad just below the camera
    (models/test_redner.py:117-124), facing down."""
    c = np.asarray(cam_position, np.float32)
    corner = c + np.asarray([-size / 2, -drop, -size / 2], np.float32)
    return QuadLight(
        corner=corner,
        edge_u=np.asarray([size, 0, 0], np.float32),
        edge_v=np.asarray([0, 0, size], np.float32),
        radiance=np.asarray(radiance, np.float32),
    )


def _soa_dot(a, b):
    return sum(a[k] * b[k] for k in range(3))


def _inv_norm(v):
    """1 / |v| (+1e-20 under the root) by an IEEE square root and
    division, which the card and the CPU round alike: the card's rsqrt is
    approximate, and the GGX peak at low roughness turns an ulp of the
    half vector into ~1e-3 of a path's radiance (JAX: lax.rsqrt)."""
    return 1.0 / torch.sqrt(sum(c * c for c in v) + 1e-20)


class PathTracedMaterialModel:
    """Path-traced renderer of the recovered materials under quad lights,
    on an explicit device."""

    def __init__(
        self,
        mesh,
        albedo_tex,
        roughness_tex,
        lights: List[QuadLight],
        max_bounces: int = 3,
        spp: int = 64,
        leaf_width: int = 4,
        device="cuda",
    ):
        from texir_code_tpu_torch.geometry.bvh import build_bvh
        from texir_code_tpu_torch.ops.raycast import DeviceBVH

        dev = resolve_device(device)
        self.device = dev
        self.mesh = mesh
        flat = build_bvh(mesh.vertices, mesh.faces, leaf_width=leaf_width)
        self.bvh = DeviceBVH.from_flat(flat, device=dev)
        tuv = mesh.triangle_uvs()
        self.uv_u = torch.tensor(tuv[:, 0], dtype=torch.float32, device=dev)
        self.uv_v = torch.tensor(tuv[:, 1], dtype=torch.float32, device=dev)
        if mesh.vertex_normals is None:
            mesh.compute_vertex_normals()
        vn = mesh.vertex_normals[mesh.faces]  # [F, 3, 3]
        self.nrm_corners = tuple(
            tuple(torch.tensor(vn[:, c, k], dtype=torch.float32, device=dev)
                  for c in range(3))
            for k in range(3)
        )
        self.albedo = torch.as_tensor(albedo_tex, dtype=torch.float32,
                                      device=dev)
        self.roughness = torch.as_tensor(roughness_tex, dtype=torch.float32,
                                         device=dev)
        self.max_bounces = max_bounces
        self.spp = spp
        self.set_lights(lights)
        # one entry per cast_rays_soa call: its rays and the traversal's
        # stats (iterations, host syncs, compactions)
        self.casts: List[dict] = []

    def set_lights(self, lights: List[QuadLight]) -> None:
        """Swap the lights (the BVH and the atlases stay)."""
        def stack(vals):
            return torch.tensor(np.stack(vals), dtype=torch.float32,
                                device=self.device)

        self.lights = lights
        self._l_corner = stack([l.corner for l in lights])   # [L, 3]
        self._l_eu = stack([l.edge_u for l in lights])
        self._l_ev = stack([l.edge_v for l in lights])
        self._l_rad = stack([l.radiance for l in lights])
        self._l_area = stack([l.area for l in lights])       # [L]
        self._l_nrm = stack([l.normal for l in lights])

    @property
    def draws_per_bounce(self) -> int:
        """Uniforms a path draws a bounce: (su, sv) on every light, then
        (u1, u2) for the cosine bounce."""
        return 2 * len(self.lights) + 2

    def draws(self, seed: int, ids: torch.Tensor) -> List[torch.Tensor]:
        """The paths' uniforms, one [B, draws_per_bounce] tensor a bounce:
        stream bounce·D + 2·light + {0: su, 1: sv}, and bounce·D + 2·L +
        {0: u1, 1: u2}."""
        d = self.draws_per_bounce
        return [
            hash_uniform(seed, ids, torch.arange(
                b * d, (b + 1) * d, device=ids.device))
            for b in range(self.max_bounces)
        ]

    def _cast(self, o, d):
        hit = cast_rays_soa(self.bvh, o, d, t_min=1e-4)
        self.casts.append(dict(rays=o[0].numel(), **cast_rays_soa.stats))
        return hit

    # ------------------------------------------------------------------
    def _surface(self, hit):
        """Hit → (uv-sampled albedo [B,3], roughness [B], shading normal
        3×[B], valid)."""
        valid = torch.isfinite(hit.t) & (hit.prim >= 0)
        prim = torch.where(valid, hit.prim, torch.zeros_like(hit.prim)).long()
        u = torch.clamp(hit.u, 0.0, 1.0)
        v = torch.clamp(hit.v, 0.0, 1.0)
        w0 = 1.0 - u - v
        base = prim * 3
        uu = (self.uv_u[base] * w0 + self.uv_u[base + 1] * u
              + self.uv_u[base + 2] * v)
        vv = (self.uv_v[base] * w0 + self.uv_v[base + 1] * u
              + self.uv_v[base + 2] * v)
        uv = torch.stack([uu, vv], dim=-1)
        albedo = bilinear_sample(self.albedo, uv, boundary="clamp")
        rough = bilinear_sample(self.roughness, uv, boundary="clamp")[..., 0]
        n = tuple(
            self.nrm_corners[k][0][prim] * w0
            + self.nrm_corners[k][1][prim] * u
            + self.nrm_corners[k][2][prim] * v
            for k in range(3)
        )
        inv = _inv_norm(n)
        n = tuple(c * inv for c in n)
        return albedo, rough, n, valid

    def _direct_light(self, pts, n, view, albedo, rough, su, sv):
        """NEE: one uniform sample (su, sv [B, L]) on every light, all
        lights' shadow rays in one cast; summed over the lights in order."""
        b, nl = su.shape
        lp = tuple(
            self._l_corner[:, k] + su * self._l_eu[:, k]
            + sv * self._l_ev[:, k]
            for k in range(3)
        )
        wi = tuple(lp[k] - pts[k][:, None] for k in range(3))
        dist2 = sum(w * w for w in wi) + 1e-12
        dist = torch.sqrt(dist2)
        wi = tuple(w / dist for w in wi)
        nn = tuple(c[:, None] for c in n)
        vv = tuple(c[:, None] for c in view)
        ndl = torch.clamp(_soa_dot(nn, wi), 0.0, 1.0)
        # light faces its -normal side too (double-sided emitter)
        cos_l = torch.abs(sum(self._l_nrm[:, k] * wi[k] for k in range(3)))
        shadow = self._cast(tuple(c[:, None].expand(b, nl) for c in pts), wi)
        unoccluded = ~torch.isfinite(shadow.t) | (shadow.t > dist - 1e-3)
        # BRDF: diffuse + Cook-Torrance specular toward the light
        h = tuple(wi[k] + vv[k] for k in range(3))
        hn = _inv_norm(h)
        h = tuple(c * hn for c in h)
        ndh = torch.clamp(_soa_dot(nn, h), 0.0, 1.0)
        ndv = torch.clamp(_soa_dot(nn, vv), 0.0, 1.0)
        vdh = torch.clamp(_soa_dot(vv, h), 0.0, 1.0)
        r = rough[:, None]
        f = shading.fresnel_schlick_ue4(vdh)
        d_term = shading.ggx_d(ndh, r)
        g_term = shading.smith_g(ndv, ndl, r)
        spec = f * d_term * g_term / torch.clamp(4 * ndl * ndv, min=1e-7)
        brdf = albedo[:, None, :] / math.pi + spec[..., None]
        geom = ndl * cos_l / dist2 * self._l_area
        contrib = self._l_rad * brdf * (geom * unoccluded)[..., None]
        total = torch.zeros((b, 3), device=pts[0].device)
        for li in range(nl):
            total = total + contrib[:, li]
        return total

    def trace(self, origins, dirs, seed: int = 0,
              ids: Optional[torch.Tensor] = None,
              draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Path-trace a flat SoA ray batch → radiance [B, 3].

        ids: the paths' global ids (default 0..B-1), which key their draws
        under `seed`; draws: the uniforms themselves, one
        [B, draws_per_bounce] tensor a bounce (see `draws`)."""
        b = origins[0].shape[0]
        dev = origins[0].device
        if draws is None:
            if ids is None:
                ids = torch.arange(b, device=dev)
            draws = self.draws(seed, ids)
        nl = len(self.lights)
        radiance = torch.zeros((b, 3), device=dev)
        throughput = torch.ones((b, 3), device=dev)
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
        o, d = origins, dirs

        for bounce in range(self.max_bounces):
            hit = self._cast(o, d)
            albedo, rough, n, valid = self._surface(hit)
            alive = alive & valid
            t_safe = torch.where(torch.isfinite(hit.t), hit.t,
                                 torch.zeros_like(hit.t))
            pts = tuple(o[k] + t_safe * d[k] for k in range(3))
            # face-forward the shading normal against the incoming ray
            ndi = _soa_dot(n, d)
            n = tuple(torch.where(ndi > 0, -c, c) for c in n)
            view = tuple(-c for c in d)

            u = draws[bounce]
            direct = self._direct_light(pts, n, view, albedo, rough,
                                        u[:, 0:2 * nl:2], u[:, 1:2 * nl:2])
            radiance = radiance + throughput * direct * alive[:, None]

            if bounce + 1 == self.max_bounces:
                break
            # cosine-sampled diffuse bounce: throughput *= albedo
            samples = torch.clamp(u[:, None, 2 * nl:2 * nl + 2],
                                  TINY_NUMBER, 1.0 - TINY_NUMBER)
            nd = generate_dir_soa(n, 1, mode="cosine", samples=samples)
            d = tuple(c[:, 0] for c in nd)
            o = tuple(pts[k] + 1e-4 * n[k] for k in range(3))
            throughput = throughput * albedo * alive[:, None]

        return radiance

    def render_pano(self, cam_position, res: Tuple[int, int], seed: int = 0,
                    samples_per_cast: Optional[int] = None) -> np.ndarray:
        """Pano render at `spp` paths a pixel, averaged in float64 in
        sample order (as JAX's loop).  Path (s, p) has id s·h·w + p, so the
        image is the same however many samples a cast traces
        (`samples_per_cast`: all by default; fewer bounds the memory)."""
        from texir_code_tpu_torch.data.export import pano_dirs

        h, w = res
        p = h * w
        dev = self.device
        d1 = torch.from_numpy(pano_dirs(h, w).reshape(-1, 3)).to(dev)
        step = samples_per_cast or self.spp
        acc = torch.zeros((p, 3), dtype=torch.float64, device=dev)
        for s0 in range(0, self.spp, step):
            ns = min(step, self.spp - s0)
            d = tuple(d1[:, k].repeat(ns) for k in range(3))
            o = tuple(torch.full((ns * p,), float(cam_position[k]),
                                 device=dev) for k in range(3))
            ids = torch.arange(s0 * p, (s0 + ns) * p, device=dev)
            out = self.trace(o, d, seed, ids).reshape(ns, p, 3)
            for s in range(ns):
                acc += out[s].double()
        return (acc / self.spp).float().reshape(h, w, 3).cpu().numpy()
