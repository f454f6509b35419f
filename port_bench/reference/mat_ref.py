"""Plain reference of the Mat stage-2 training step (TexIR
models/mat_nvdiffrast.py forward, models/loss.py stage 2, Adam and the
clamps of trainer/train_material.py), from the scene, the cameras and the
step's inputs alone.

It works out again what the program derives: each view's G-buffer (a ray
a pixel of the six 90-degree cube faces, the closest hit by a brute-force
Möller–Trumbore test against every triangle, the hit's position, vertex
normal and atlas uv), the mip LODs (finite differences of uv between
neighbouring pixels), the pyramids (2x2 means), the per-pixel draws (the
counter hash of the step's seed and the pixel id: the toroidal shift of
the 16 Hammersley points, the stochastic level and bilinear corner), the
GGX importance half vectors and their reflected light directions, the
specular rays' closest hits (brute force again, from every pixel's own
origin) and their radiance (the HDR atlas resampled at 2x, RGBE-quantized,
read nearest), the shading, the loss with its per-(room, class)
roughness prior, the backward (autograd), Adam and the clamps.

Plain PyTorch and NumPy only; it imports nothing of the program.  `dtype`
is the precision of the whole chain: float32 as the configuration states,
bfloat16 for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from port_bench.reference.bake_ref import (
    _TINY,
    hammersley,
    hash_uniforms,
    prefiltered_atlas,
    vertex_normals,
)

_PAIRS = 1 << 27  # ray x triangle pairs held at once


def cube_rays(position: np.ndarray, res: int) -> np.ndarray:
    """[6, res, res, 3] unit ray directions of a cube rig at `position`
    with the world axes as its frame (right x, up y, front z), in the
    face order left, front, right, back, top, bottom; row 0 is the top
    of a face, pixel centres at NDC x = (j + 0.5) / res * 2 - 1 (right),
    y = 1 - (i + 0.5) / res * 2 (up); 90-degree faces, so a face's ray
    is x R + y U + F."""
    del position  # a cube rig's rays do not depend on where it stands
    ex, ey, ez = np.eye(3)
    frames = [  # (R, U, F)
        (ez, ey, -ex), (ex, ey, ez), (-ez, ey, ex), (-ex, ey, -ez),
        (ex, -ez, ey), (ex, ez, -ey),
    ]
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x = c[None, :]
    y = -c[:, None]
    out = np.zeros((6, res, res, 3))
    for f, (r, u, fw) in enumerate(frames):
        d = x[..., None] * r + y[..., None] * u + fw
        out[f] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return out


class Geometry:
    """The triangles, vertex normals and atlas uvs on the device."""

    def __init__(self, mesh, device, dtype):
        v = mesh.vertices.astype(np.float64)
        tri = v[mesh.faces]
        self.np_p0 = tri[:, 0]
        self.np_e1 = tri[:, 1] - tri[:, 0]
        self.np_e2 = tri[:, 2] - tri[:, 0]
        self.faces = torch.as_tensor(mesh.faces.astype(np.int64),
                                     device=device)
        t = self.tensor = lambda x: torch.as_tensor(
            np.ascontiguousarray(x), dtype=torch.float32,
            device=device).to(dtype)
        self.vertices = t(v)
        self.vnormals = t(vertex_normals(mesh.vertices, mesh.faces))
        self.tuv = t(mesh.uvs.astype(np.float64)[mesh.uv_faces])  # [F,3,2]
        self.device = device
        self.dtype = dtype

    def closest_hits(self, origins: torch.Tensor, dirs: torch.Tensor,
                     t_min: float, centre: np.ndarray):
        """Closest hit (t > t_min) of rays with origins [N, 3] (or one
        [3]) along dirs [N, 3] against every triangle: (t [N], inf on a
        miss; face [N], -1 on a miss; barycentrics b1, b2 [N]).

        The candidates are found with Möller–Trumbore's triple products
        regrouped into products of each ray's (o x d, d) with
        per-triangle vectors, in coordinates centred at `centre`; each
        ray's closest one is then tested again directly."""
        dev, dt = self.device, self.dtype
        t = self.tensor
        p0 = self.np_p0 - centre
        e1, e2 = self.np_e1, self.np_e2
        nrm = np.cross(e1, e2)
        # det = -d.n ; b1 det = (o x d).e2 - d.(e2 x p0)
        # b2 det = -(o x d).e1 - d.(p0 x e1) ; t det = o.n - e2.(p0 x e1)
        b_det = t(-nrm)
        b1 = t(np.concatenate([e2, -np.cross(e2, p0)], axis=1))
        b2 = t(np.concatenate([-e1, -np.cross(p0, e1)], axis=1))
        tn_o = t(nrm)
        tn_c = t((e2 * np.cross(p0, e1)).sum(-1))
        o_all = origins - t(centre)
        n = dirs.shape[0]
        nf = p0.shape[0]
        per_ray = o_all.dim() == 2
        faces = []
        step = max(1, _PAIRS // nf)
        inf = torch.tensor(float("inf"), dtype=dt, device=dev)
        for a in range(0, n, step):
            d = dirs[a:a + step]
            o = o_all[a:a + step] if per_ray else o_all[None].expand_as(d)
            od = torch.cat([torch.linalg.cross(o, d), d], dim=1)
            det = d @ b_det.T
            ok = torch.abs(det) > 1e-12
            inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
            u = (od @ b1.T) * inv
            v = (od @ b2.T) * inv
            tt = (o @ tn_o.T - tn_c[None]) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > t_min)
            tt = torch.where(hit, tt, inf)
            best, f = tt.min(dim=1)
            faces.append(torch.where(torch.isfinite(best), f, -1))
        face = torch.cat(faces)
        # the closest candidate tested directly, from its own corner
        fs = face.clamp_min(0)
        o = (o_all if per_ray else o_all[None].expand(n, 3))
        tp0 = t(p0)[fs]
        te1 = t(e1)[fs]
        te2 = t(e2)[fs]
        pvec = torch.linalg.cross(dirs, te2)
        det = (te1 * pvec).sum(-1)
        ok = (face >= 0) & (torch.abs(det) > 1e-12)
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tvec = o - tp0
        qvec = torch.linalg.cross(tvec, te1)
        u = (tvec * pvec).sum(-1) * inv
        v = (dirs * qvec).sum(-1) * inv
        tt = (te2 * qvec).sum(-1) * inv
        tt = torch.where(ok, tt, inf)
        return tt, torch.where(ok, face, -1), u, v


def gbuffer(geo: Geometry, position: np.ndarray, res: int):
    """A view's G-buffer: position, normal [6, res, res, 3], uv
    [6, res, res, 2] and coverage [6, res, res, 1]; background pixels
    get position and normal (1, 0, 0) and uv 0."""
    dirs = geo.tensor(cube_rays(position, res).reshape(-1, 3))
    t, face, u, v = geo.closest_hits(geo.tensor(position), dirs, 1e-6,
                                     position)
    hit = face >= 0
    fs = face.clamp_min(0)
    corners = geo.faces[fs]
    w = torch.stack([1.0 - u - v, u, v], dim=-1)[..., None]
    pos = (geo.vertices[corners] * w).sum(1)
    nrm = (geo.vnormals[corners] * w).sum(1)
    nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(
        nrm, dim=-1, keepdim=True), 1e-12)
    uv = (geo.tuv[fs] * w).sum(1)
    bg = torch.tensor([1.0, 0.0, 0.0], dtype=geo.dtype, device=geo.device)
    m = hit[:, None]
    pos = torch.where(m, pos, bg)
    nrm = torch.where(m, nrm, bg)
    uv = torch.where(m, uv, torch.zeros_like(uv))
    shp = (6, res, res)
    return dict(position=pos.reshape(shp + (3,)),
                normal=nrm.reshape(shp + (3,)), uv=uv.reshape(shp + (2,)),
                mask=hit.to(geo.dtype).reshape(shp + (1,)))


def lod(uv_img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[6, R, R] mip level: log2 of the larger texel footprint of the
    differences to the right and lower neighbours (the last column and
    row take their neighbour's), at least 0."""
    dx = uv_img[:, :, 1:] - uv_img[:, :, :-1]
    dx = torch.cat([dx, dx[:, :, -1:]], dim=2)
    dy = uv_img[:, 1:] - uv_img[:, :-1]
    dy = torch.cat([dy, dy[:, -1:]], dim=1)

    def length(d):
        return torch.sqrt((d[..., 0] * w) ** 2 + (d[..., 1] * h) ** 2)

    fp = torch.clamp_min(torch.maximum(length(dx), length(dy)), 1e-12)
    return torch.clamp_min(torch.log2(fp), 0.0)


def pyramid(tex: torch.Tensor, max_levels=None) -> List[torch.Tensor]:
    """2x2-mean mip chain down to an odd or unit side (or max_levels)."""
    out = [tex]
    while True:
        h, w = out[-1].shape[:2]
        if h < 2 or w < 2 or h % 2 or w % 2:
            break
        if max_levels is not None and len(out) >= max_levels + 1:
            break
        out.append(out[-1].reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3)))
    return out


def sample(levels: List[torch.Tensor], uv, lvl_f, rng) -> torch.Tensor:
    """Stochastic trilinear fetch with wrapped edges: level floor(lod) or
    the next (the next where rng0 < frac(lod)), then one bilinear corner
    (x + 1 where rng1 < fx, y + 1 where rng2 < fy)."""
    n = len(levels)
    lvl_f = torch.clamp(lvl_f, 0.0, n - 1.0)
    lo = torch.floor(lvl_f).long()
    hi = torch.clamp_max(lo + 1, n - 1)
    frac = lvl_f - lo.to(lvl_f.dtype)
    lvl = torch.where(rng[:, 0] >= frac, lo, hi)
    c = levels[0].shape[-1]
    out = torch.zeros((uv.shape[0], c), dtype=levels[0].dtype,
                      device=uv.device)
    for k, tex in enumerate(levels):
        sel = torch.nonzero(lvl == k).squeeze(1)
        if not sel.numel():
            continue
        h, w = tex.shape[:2]
        x = uv[sel, 0] * w - 0.5
        y = uv[sel, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        xi = torch.where(rng[sel, 1] < x - x0, x0 + 1, x0).long() % w
        yi = torch.where(rng[sel, 2] < y - y0, y0 + 1, y0).long() % h
        out = out.index_put((sel,), tex[yi, xi])
    return out


def bilinear_wrap(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = tex.shape[:2]
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0 = x0.long()
    y0 = y0.long()
    xa, xb = x0 % w, (x0 + 1) % w
    ya, yb = y0 % h, (y0 + 1) % h
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def onb(n: torch.Tensor):
    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _TINY)

    big = torch.abs(n[:, 0]) > 0.99
    axis = torch.zeros_like(n)
    axis[:, 0] = (~big).to(n.dtype)
    axis[:, 1] = big.to(n.dtype)
    nn = unit(n)
    u = unit(torch.linalg.cross(axis, nn))
    v = unit(torch.linalg.cross(nn, u))
    return nn, u, v


class MatReference:
    """Stage-2 steps of the Mat stage on a scene, from its inputs."""

    def __init__(self, mesh, hdr: np.ndarray, irt: torch.Tensor, cfg: dict,
                 device, dtype=torch.float32):
        self.cfg = cfg
        self.device = device
        self.dtype = dtype
        self.geo = Geometry(mesh, device, dtype)
        self.table = self.geo.tensor(prefiltered_atlas(hdr, 2))
        self.irt_levels = pyramid(irt.to(dtype))
        self.res = cfg["pano_res"][1] // 4
        self.spp = cfg["sample_light"][1]
        self.base = torch.as_tensor(hammersley(self.spp),
                                    device=device).to(dtype)
        self.views: Dict[int, dict] = {}

    def view(self, k: int, position) -> dict:
        if k not in self.views:
            self.views[k] = gbuffer(self.geo, np.asarray(position,
                                                         np.float64),
                                    self.res)
        return self.views[k]

    def forward(self, albedo, roughness, g: dict, cam, seed: int):
        """rgb, albedo and roughness of every pixel of a view ([P, C])."""
        cfg = self.cfg
        dt = self.dtype
        p = g["uv"].numel() // 2
        uv = g["uv"].reshape(p, 2)
        ids = torch.arange(p, device=self.device)
        draws = hash_uniforms(seed, ids, 5).to(dt)
        rng = draws[:, 2:5]
        max_l = cfg["max_mip_level"]
        alb = sample(pyramid(albedo, max_l), uv,
                     lod(g["uv"], *albedo.shape[:2]).reshape(p), rng)
        rgh = sample(pyramid(roughness, max_l), uv,
                     lod(g["uv"], *roughness.shape[:2]).reshape(p), rng)
        irr = sample(self.irt_levels, uv,
                     lod(g["uv"], *self.irt_levels[0].shape[:2]).reshape(p),
                     rng)
        n = g["normal"].reshape(p, 3)
        pts = g["position"].reshape(p, 3) + 1e-2 * n
        camt = torch.as_tensor(np.asarray(cam, np.float64),
                               dtype=torch.float32, device=self.device).to(dt)
        view = camt[None] - pts
        view = view / torch.clamp_min(torch.linalg.vector_norm(
            view, dim=-1, keepdim=True), 1e-4)
        diffuse = irr * alb / math.pi
        # GGX importance half vectors from the shifted Hammersley points
        s = torch.clamp(torch.remainder(self.base[None] + draws[:, None, :2],
                                        1.0), _TINY, 1.0 - _TINY)
        u1, u2 = s[..., 0], s[..., 1]
        r = rgh.reshape(p, 1)
        a = r * r
        cos_t = torch.sqrt((1.0 - u1) / (1.0 + (a * a - 1.0) * u1))
        cos_t = torch.clamp(cos_t, -1.0 + _TINY, 1.0 - _TINY)
        phi = 2.0 * math.pi * u2 - math.pi
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
        nn, uu, vv = onb(n)
        half = (vv[:, None] * (torch.sin(phi) * sin_t)[..., None]
                + nn[:, None] * cos_t[..., None]
                + uu[:, None] * (-(torch.cos(phi) * sin_t))[..., None])
        vdh = torch.clamp((half * view[:, None]).sum(-1), 0.0, 1.0)
        light = 2.0 * vdh[..., None] * half - view[:, None]
        # the specular rays' radiance (no gradient, as the reference's)
        with torch.no_grad():
            origins = pts.detach()[:, None].expand(p, self.spp, 3)
            rad = self._radiance(origins.reshape(-1, 3),
                                 light.detach().reshape(-1, 3), cam)
        rad = rad.reshape(p, self.spp, 3)
        ndl = torch.clamp((n[:, None] * light).sum(-1), 0.0, 1.0)
        ndh = torch.clamp((n[:, None] * half).sum(-1), 0.0, 1.0)
        ndv = torch.clamp((n * view).sum(-1), 0.0, 1.0)[:, None]
        fres = 0.04 + 0.96 * torch.pow(2.0, (-5.55472 * vdh - 6.98316) * vdh)
        k = (r + 1.0) * (r + 1.0) / 8.0
        g1l = ndl / torch.clamp_min(ndl * (1.0 - k) + k, 1e-14)
        g1v = ndv / torch.clamp_min(ndv * (1.0 - k) + k, 1e-14)
        brdf = fres * g1l * g1v / torch.clamp_min(4.0 * ndl * ndv, 1e-14)
        weight = brdf * ndl * 4.0 * vdh / torch.clamp_min(ndh, 1e-14)
        spec = (rad * weight[..., None]).sum(1)
        rgb = diffuse + spec / self.spp
        return rgb, alb, rgh

    def _radiance(self, origins: torch.Tensor, dirs: torch.Tensor, cam):
        """Radiance along rays from per-ray origins: the nearest texel of
        the prefiltered table at the closest hit's uv; 0 on a miss or a
        hit nearer than 1e-4."""
        centre = np.asarray(cam, np.float64)
        t, face, u, v = self.geo.closest_hits(origins, dirs, 0.0, centre)
        fs = face.clamp_min(0)
        w = torch.stack([1.0 - u - v, u, v], dim=-1)[..., None]
        uv = torch.clamp((self.geo.tuv[fs] * w).sum(1), 0.0, 1.0)
        h, wd, _ = self.table.shape
        x = torch.clamp((uv[:, 0].float() * wd).long(), 0, wd - 1)
        y = torch.clamp((uv[:, 1].float() * h).long(), 0, h - 1)
        rad = self.table[y, x]
        ok = torch.isfinite(t) & (t > 1e-4)
        return torch.where(ok[:, None], rad, torch.zeros_like(rad))

    def loss(self, albedo, roughness, v: dict, it: int):
        """(total, seg term) of stage 2 on view v at global step `it`:
        L1 of log(1 + x) over the seg region / classes, plus 0.2 x the
        mean distance of each pixel's roughness to its (room, class)
        mean (TexIR models/loss.py:81-115, :214-295)."""
        cfg = self.cfg
        g = self.view(v["index"], v["position"])
        seed = cfg["draw_seed_base"] + it
        rgb, _, rgh = self.forward(albedo, roughness, g, v["position"], seed)
        p = rgb.shape[0]
        c = cfg["num_classes"]
        rooms = cfg["n_rooms"]
        pred = rgb * g["mask"].reshape(p, 1)
        region = v["region"].reshape(p, 1).to(self.dtype)
        gt = v["gt"].reshape(p, 3).to(self.dtype)
        direct = (torch.log(gt * region + 1.0)
                  - torch.log(pred * region + 1.0)).abs().mean() / c
        joint = v["room"].reshape(p).long() * c + v["seg"].reshape(p).long()
        sums = rgh.new_zeros((rooms * c, 1)).index_add(0, joint, rgh)
        counts = rgh.new_zeros((rooms * c, 1)).index_add(
            0, joint, torch.ones_like(rgh))
        means = sums / (counts + _TINY)
        seg = ((rgh - means[joint]).abs().sum() / (rooms * c * p)
               * 0.2 * cfg["seg_weight_scale"])
        return direct + seg, seg

    def train(self, views: List[dict]):
        """One Adam step a view from the configuration's initial atlases,
        each followed by the clamps.  Returns (losses, the first step's
        gradients, the atlases' change over all the steps)."""
        cfg = self.cfg
        dt, dev = self.dtype, self.device
        ra, rr = cfg["albedo_res"], cfg["roughness_res"]
        params = [torch.full((ra, ra, 3), cfg["albedo_init"], dtype=dt,
                             device=dev),
                  torch.full((rr, rr, 1), cfg["roughness_init"], dtype=dt,
                             device=dev)]
        init = [p.clone() for p in params]
        m = [torch.zeros_like(p) for p in params]
        s = [torch.zeros_like(p) for p in params]
        b1, b2 = 0.9, 0.999
        lr, eps = cfg["lr"], 1e-8
        losses, first = [], None
        for k, v in enumerate(views):
            leaves = [p.clone().requires_grad_(True) for p in params]
            total, _ = self.loss(leaves[0], leaves[1], v, k)
            grads = torch.autograd.grad(total, leaves)
            if first is None:
                first = [g.detach().clone() for g in grads]
            losses.append(float(total.detach()))
            with torch.no_grad():
                for j, g in enumerate(grads):
                    m[j] = b1 * m[j] + (1 - b1) * g
                    s[j] = b2 * s[j] + (1 - b2) * g * g
                    step = k + 1
                    den = (s[j].sqrt() / math.sqrt(1 - b2 ** step)) + eps
                    params[j] = params[j] - (lr / (1 - b1 ** step)) * m[j] / den
                params[0] = torch.clamp_min(params[0], 0.0)
                params[1] = torch.clamp(params[1], cfg["roughness_min"],
                                        cfg["roughness_max"])
        return losses, first, [p - q for p, q in zip(params, init)]
