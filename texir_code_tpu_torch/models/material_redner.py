"""Per-object explicit-texture material model with optional camera refinement.

The port of the JAX package's `models/material_redner.py` (reference
models/mat_redner.py:32-253, the pyredner pipeline): one explicit albedo +
roughness texture per OBJ object group, stacked as [G, R, R, C] trainable
tensors and sampled with one gather by the pixel's object id; a panorama
camera rendered into a G-buffer; optional per-view camera refinement
(axis-angle rotation and translation deltas around the dataset extrinsics,
reference :61-67,106-112).

The G-buffer is two-phase, as in the JAX model: a BVH cast without
gradients (`ops.raycast.cast_rays_soa`, t_min 1e-2, pyredner's clip_near)
pins each pixel's triangle, then Möller–Trumbore is solved again for the
pinned triangle in autograd, so the uv and camera-pose gradients flow
(d(uv)/d(camera), d(colour)/d(texels)).  Shading inputs are detached as
the reference detaches them (:131).  Incident lighting comes from the TBL
through the BVH (`models.tbl.query_tbl_soa`) or from an IRF network
(`irf_apply`, e.g. a `fields.IRNetwork`: hdr_recover(net(p, d))·2^7),
detached in both.

Random numbers: the diffuse and specular sample shifts are a counter hash
of (seed, pixel id, stream) (`draw`); `forward(draws=)` takes the JAX
model's own in the parity tests.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.models.material_mlp import draw_shifts, pano_dirs
from texir_code_tpu_torch.models.tbl import build_tbl, query_tbl_soa
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.raycast import cast_rays_soa
from texir_code_tpu_torch.ops.sampling import (
    TINY_NUMBER,
    generate_dir_soa,
    reflect_soa,
    shifted_samples,
)


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([torch.stack([z, -k[2], k[1]]),
                        torch.stack([k[2], z, -k[0]]),
                        torch.stack([-k[1], k[0], z])])


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [3] axis-angle → [3, 3] rotation, differentiable at 0
    (below θ² = 1e-12 the first-order I + [w]ₓ, where the unit-axis form
    is 0/0)."""
    theta2 = (w * w).sum()
    theta = torch.sqrt(theta2 + 1e-24)
    kx = _skew(w / theta)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)
    r0 = eye + _skew(w)
    return torch.where(theta2 > 1e-12, r, r0)


def moller_trumbore_soa(o, d, v0, v1, v2):
    """Ray/triangle solve of pinned primitives, differentiable in (o, d):
    o, d, v0..v2 3×[B] → (t, u, v) each [B], the cast's (t, barycentric)
    contract.  A determinant under 1e-12 in magnitude becomes 1e-12 (the
    JAX model's `where`, so the gradient takes the same branch)."""

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    e1 = tuple(v1[k] - v0[k] for k in range(3))
    e2 = tuple(v2[k] - v0[k] for k in range(3))
    p = cross(d, e2)
    det = dot(e1, p)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12,
                            torch.full_like(det, 1e-12), det)
    s = tuple(o[k] - v0[k] for k in range(3))
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    return t, u, v


def sample_object_textures(tex: torch.Tensor, obj: torch.Tensor,
                           uv: Tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """Bilinear sample of stacked per-object textures with border clamp
    (pyredner's Texture default): tex [G, R, R, C], obj [B] object ids, uv
    (u, v) each [B] in [0, 1], v-up → [B, C].  Differentiable in uv and
    tex; the texture's backward is one scatter-add into the flat
    [G·R·R, C] view."""
    g, res, _, c = tex.shape
    flat = tex.reshape(g * res * res, c)
    x = torch.clamp(uv[0] * res - 0.5, 0.0, res - 1.0)
    y = torch.clamp(uv[1] * res - 0.5, 0.0, res - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, res - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, res - 2).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    base = (obj.to(torch.int64) * res + y0) * res + x0
    c00 = flat[base]
    c01 = flat[base + 1]
    c10 = flat[base + res]
    c11 = flat[base + res + 1]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


class RednerMaterialModel:
    """Explicit per-object textures + optional pose refinement (mat_redner)."""

    def __init__(
        self,
        mesh,
        hdr_texture: np.ndarray,
        ids: Sequence,
        extrinsics: Sequence[np.ndarray],
        optim_cam: bool = False,
        texture_res: int = 2048,
        pano_res: Tuple[int, int] = (256, 512),
        sample_light: Tuple[int, int] = (64, 64),
        sample_type: Tuple[str, str] = ("uniform", "importance"),
        hdr_exposure: float = 0.0,
        irf_apply: Optional[Callable] = None,
        device="cuda",
    ):
        """ids / extrinsics: the views and their [4, 4] camera-to-world
        matrices.  irf_apply: (points [N, 3], dirs [N, 3]) → hdr_scale
        radiance [N, 3] in place of the TBL.  device: where every scene
        tensor lives (default: the card)."""
        self.device = dev = resolve_device(device)
        self.mesh = mesh
        self.ids = list(ids)
        self.optim_cam = optim_cam
        self.texture_res = texture_res
        self.pano_res = tuple(pano_res)
        self.sample_light = tuple(sample_light)
        self.sample_type = tuple(sample_type)
        self.irf_apply = irf_apply
        self.tbl = build_tbl(mesh, hdr_texture, hdr_exposure, device=dev)

        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        mat_ids = mesh.material_ids
        if mat_ids is None:
            mat_ids = np.zeros(mesh.num_faces, np.int32)
        self.num_objects = int(mat_ids.max()) + 1
        self._face_obj = col(mat_ids.astype(np.int64))
        corners = mesh.triangle_corners()  # [F, 3, 3]
        self._corners = tuple(tuple(col(corners[:, ci, k]) for k in range(3))
                              for ci in range(3))
        tuvs = mesh.triangle_uvs().reshape(-1, 3, 2)  # [F, 3, 2]
        self._corner_uvs = tuple(tuple(col(tuvs[:, ci, k]) for k in range(2))
                                 for ci in range(3))
        fn = mesh.face_normals()
        self._face_n = tuple(col(fn[:, k]) for k in range(3))
        self._extrinsics = col(np.stack(
            [np.asarray(e, np.float32).reshape(4, 4) for e in extrinsics]))
        self._cam_dirs = col(pano_dirs(self.pano_res))  # [B, 3], camera frame

    # -- parameters --------------------------------------------------------

    def init_params(self) -> Dict[str, torch.Tensor]:
        """Leaf tensors (requires_grad): albedo 0.5 and roughness 0.4
        (reference mat_redner.py:51,57), and with optim_cam the [V, 3]
        rotation and translation deltas at zero."""
        g, r = self.num_objects, self.texture_res

        def leaf(shape, value):
            return torch.full(shape, value, dtype=torch.float32,
                              device=self.device, requires_grad=True)

        params = {"albedo": leaf((g, r, r, 3), 0.5),
                  "roughness": leaf((g, r, r, 1), 0.4)}
        if self.optim_cam:
            v = len(self.ids)
            params["cam_rot"] = leaf((v, 3), 0.0)
            params["cam_trans"] = leaf((v, 3), 0.0)
        return params

    def cam_to_world(self, params: Dict, view_idx: int) -> torch.Tensor:
        """Effective [4, 4] pose of a view: the dataset extrinsic (+ delta)."""
        base = self._extrinsics[view_idx]
        if not self.optim_cam:
            return base
        dr = axis_angle_to_matrix(params["cam_rot"][view_idx])
        top = torch.cat([base[:3, :3] @ dr,
                         (base[:3, 3] + params["cam_trans"][view_idx])[:, None]],
                        dim=1)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        return torch.cat([top, bottom], dim=0)

    def draw(self, seed: int, num_pixels: int) -> Dict[str, torch.Tensor]:
        return draw_shifts(seed, num_pixels, self.device)

    # -- forward -----------------------------------------------------------

    def forward(self, params: Dict, view_idx: int, seed: int = 0,
                detach_cam: bool = False, draws: Optional[Dict] = None
                ) -> Dict[str, torch.Tensor]:
        """Render view `view_idx`: rgb, albedo [H, W, 3], roughness,
        empty_mask [H, W, 1]."""
        h, w = self.pano_res
        b = h * w
        if draws is None:
            draws = self.draw(seed, b)
        draws = {k: torch.as_tensor(v, dtype=torch.float32,
                                    device=self.device).reshape(b, 2)
                 for k, v in draws.items()}
        c2w = self.cam_to_world(params, view_idx)
        if detach_cam:
            c2w = c2w.detach()
        rot = c2w[:3, :3]
        cam_pos = c2w[:3, 3]

        dirs_w = self._cam_dirs @ rot.T  # [B, 3], differentiable in pose
        d = tuple(dirs_w[:, k] for k in range(3))
        o = tuple(cam_pos[k].expand(b) for k in range(3))

        # phase 1: pin the per-pixel primitive (no gradient)
        with torch.no_grad():
            hit = cast_rays_soa(self.tbl.bvh, tuple(x.detach() for x in o),
                                tuple(x.detach() for x in d), t_min=1e-2)
        prim = torch.clamp_min(hit.prim, 0).to(torch.int64)
        valid = hit.prim >= 0

        # phase 2: solve the pinned triangle again, in autograd
        v0, v1, v2 = (tuple(c[k][prim] for k in range(3))
                      for c in self._corners)
        t, bu, bv = moller_trumbore_soa(o, d, v0, v1, v2)
        bu = torch.clamp(bu, 0.0, 1.0)
        bv = torch.clamp(bv, 0.0, 1.0)
        w0 = 1.0 - bu - bv
        uv = tuple(self._corner_uvs[0][k][prim] * w0
                   + self._corner_uvs[1][k][prim] * bu
                   + self._corner_uvs[2][k][prim] * bv for k in range(2))

        obj = self._face_obj[prim]
        albedo = sample_object_textures(params["albedo"], obj, uv)
        roughness = sample_object_textures(params["roughness"], obj, uv)
        albedo = torch.where(valid[:, None], albedo, 0.0)
        roughness = torch.clamp(torch.where(valid[:, None], roughness, 1.0),
                                TINY_NUMBER, 1.0)

        # shading inputs detached as the reference's (:131)
        n = tuple(self._face_n[k][prim] for k in range(3))
        pos = tuple((o[k] + t * d[k]).detach() for k in range(3))
        pts = tuple(pos[k] + 1e-2 * n[k] for k in range(3))
        view = tuple(cam_pos[k] - pos[k] for k in range(3))
        vn = torch.clamp_min(torch.sqrt(view[0] * view[0] + view[1] * view[1]
                                        + view[2] * view[2]), 1e-4)
        view = tuple((v / vn).detach() for v in view)

        s_diff, s_spec = self.sample_light
        ld = generate_dir_soa(n, s_diff, mode=self.sample_type[0],
                              samples=shifted_samples(s_diff,
                                                      draws["diff_shift"]))
        light_d = self._lighting(pts, ld, b, s_diff)
        ndl = (n[0][:, None] * ld[0] + n[1][:, None] * ld[1]
               + n[2][:, None] * ld[2]).clamp(0.0, 1.0)
        if self.sample_type[0] == "cosine":
            # pdf cosθ/π: estimator Σ L·albedo (reference :187-188)
            diff_rgb = torch.stack([light_d[k].sum(dim=1) for k in range(3)],
                                   dim=-1) * np.pi / s_diff
        else:
            diff_rgb = torch.stack([(light_d[k] * ndl).sum(dim=1)
                                    for k in range(3)], dim=-1
                                   ) * 2.0 * np.pi / s_diff
        diffuse = diff_rgb * albedo / np.pi

        half = generate_dir_soa(n, s_spec, mode=self.sample_type[1],
                                roughness=roughness[:, 0],
                                samples=shifted_samples(s_spec,
                                                        draws["spec_shift"]))
        light_dirs, _ = reflect_soa(view, half)
        light_s = self._lighting(pts, tuple(x.detach() for x in light_dirs),
                                 b, s_spec)
        spec = shading.specular_estimator_soa(light_s, half, n, view,
                                              light_dirs, roughness[:, 0])
        specular = torch.stack(spec, dim=-1) / s_spec

        rgb = torch.where(valid[:, None], diffuse + specular, 0.0)
        return {
            "rgb": rgb.reshape(h, w, 3),
            "albedo": albedo.reshape(h, w, 3),
            "roughness": roughness.reshape(h, w, 1),
            "empty_mask": valid.to(torch.float32).reshape(h, w, 1),
        }

    def _lighting(self, pts, dirs, b: int, s: int):
        """Detached incident radiance 3×[B, S]: the IRF network or the TBL
        (reference :164-175 / :214-242)."""
        p = tuple(x[:, None].expand(b, s) for x in pts)
        with torch.no_grad():
            if self.irf_apply is not None:
                rgb = shading.hdr_recover(self.irf_apply(
                    torch.stack(p, dim=-1).reshape(-1, 3),
                    torch.stack(dirs, dim=-1).reshape(-1, 3),
                )) * (2.0 ** 7)  # reference :165 hdr_recover(...) * 2**7
                rgb = rgb.reshape(b, s, 3)
                return tuple(rgb[..., k] for k in range(3))
            return query_tbl_soa(self.tbl, p, dirs)
