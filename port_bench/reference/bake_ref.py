"""Plain reference of the IrrT bake: a texel's irradiance from the scene's
triangles and HDR atlas alone.

It works out again everything the program derives: the texel's world
position and normal (a uv-space barycentric test against every triangle),
its sample directions (the counter-hash toroidal shift of the Hammersley
set, keyed by the bake seed and the texel's global id, mapped to the
uniform hemisphere about the normal), each ray's closest hit (a
brute-force Möller–Trumbore test against every triangle; no BVH, no
culling), the radiance at the hit's atlas uv (the configuration's fetch:
the HDR atlas bilinearly resampled at 2x, RGBE-quantized, read nearest)
and the estimator, irradiance = sum of L * max(n.d, 0) * 2 pi / S
(TexIR models/tracer_o3d_irt.py:156-174).

Plain PyTorch and NumPy only; it imports nothing of the program.  `dtype`
is the precision of the whole chain: float32 as the configuration states,
bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_TINY = 1e-6
_PAIRS = 1 << 25  # ray x triangle pairs held at once


def _hash32(x):
    """lowbias32 of a Python int or of int64 tensors holding uint32s."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def hash_uniforms(seed: int, ids: torch.Tensor, cols: int) -> torch.Tensor:
    """[B, cols] uniforms in [0, 1), 24 bits, keyed by (seed, id, column)."""
    key = _hash32(int(seed))
    c = torch.arange(cols, dtype=torch.int64, device=ids.device)
    h = _hash32(_hash32(ids.to(torch.int64) ^ key)[:, None] + c[None])
    return (h >> 8).to(torch.float32) / float(1 << 24)


def hammersley(n: int) -> np.ndarray:
    """[n, 2] (i / n, base-2 radical inverse of i) as float32."""
    i = np.arange(n, dtype=np.uint64)
    rev = np.zeros(n, np.uint64)
    for b in range(32):
        rev |= ((i >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return np.stack([np.arange(n) / n, rev.astype(np.float64) / 2.0**32],
                    axis=-1).astype(np.float32)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, float64."""
    v = vertices.astype(np.float64)
    tri = v[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def texel_geometry(mesh, res: int, rows: np.ndarray, cols: np.ndarray):
    """World position and unit normal at the centre of atlas texels
    (rows, cols) of a res x res atlas (row = v, v up), float64, and
    whether a triangle covers the centre.  Where several do (a shared
    edge), the last in face order."""
    uv = mesh.uvs.astype(np.float64)[mesh.uv_faces] * res - 0.5  # [F, 3, 2]
    a, b, c = uv[:, 0], uv[:, 1], uv[:, 2]
    v0, v1 = b - a, c - a
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    den = d00 * d11 - d01 * d01
    ok_den = np.abs(den) >= 1e-12
    den = np.where(ok_den, den, 1.0)
    vn = vertex_normals(mesh.vertices, mesh.faces)
    pos = mesh.vertices.astype(np.float64)
    k = len(rows)
    position = np.zeros((k, 3))
    normal = np.zeros((k, 3))
    covered = np.zeros(k, bool)
    for i in range(k):
        p = np.array([cols[i], rows[i]], np.float64)
        v2 = p[None] - a
        d20 = (v2 * v0).sum(-1)
        d21 = (v2 * v1).sum(-1)
        u = (d11 * d20 - d01 * d21) / den
        v = (d00 * d21 - d01 * d20) / den
        w = 1.0 - u - v
        inside = ok_den & (u >= -1e-6) & (v >= -1e-6) & (w >= -1e-6)
        hits = np.flatnonzero(inside)
        if not len(hits):
            continue
        f = hits[-1]
        corners = mesh.faces[f]
        bary = np.array([w[f], u[f], v[f]])
        position[i] = bary @ pos[corners]
        n = bary @ vn[corners]
        normal[i] = n / max(np.linalg.norm(n), 1e-12)
        covered[i] = True
    return position, normal, covered


def hemisphere_dirs(normal: torch.Tensor, shift: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    """[K, S, 3] uniform-hemisphere directions about unit-ish normals
    [K, 3]: the Hammersley set `base` [S, 2] shifted by [K, 2] and
    clamped to [1e-6, 1 - 1e-6]; cos theta = 1 - u1, phi = 2 pi u2 - pi,
    in the frame (n, U, V) with U = cross(a, n), V = cross(n, U), a the
    y axis where |n.x| > 0.99, else the x axis."""
    s = torch.clamp(torch.remainder(base[None] + shift[:, None], 1.0),
                    _TINY, 1.0 - _TINY)
    cos_t = 1.0 - s[..., 0]
    phi = 2.0 * math.pi * s[..., 1] - math.pi
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))

    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _TINY)

    big = torch.abs(normal[:, 0]) > 0.99
    axis = torch.zeros_like(normal)
    axis[:, 0] = (~big).to(normal.dtype)
    axis[:, 1] = big.to(normal.dtype)
    n = unit(normal)
    u = unit(torch.linalg.cross(axis, n))
    v = unit(torch.linalg.cross(n, u))
    sp = (torch.sin(phi) * sin_t)[..., None]
    cp = (-(torch.cos(phi) * sin_t))[..., None]
    return v[:, None] * sp + n[:, None] * cos_t[..., None] + u[:, None] * cp


def prefiltered_atlas(hdr: np.ndarray, factor: int = 2) -> np.ndarray:
    """[f H, f W, 3] the HDR atlas bilinearly resampled (clamped edges) at
    the centres of an f-times finer grid, then RGBE-quantized (a shared
    exponent ceil(log2 max), 8-bit mantissas, truncated), float64."""
    h, w, _ = hdr.shape
    img = hdr.astype(np.float64)
    fh, fw = factor * h, factor * w
    x = (np.arange(fw) + 0.5) / fw * w - 0.5
    y = (np.arange(fh) + 0.5) / fh * h - 0.5
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    xi0 = np.clip(x0.astype(int), 0, w - 1)
    xi1 = np.clip(x0.astype(int) + 1, 0, w - 1)
    yi0 = np.clip(y0.astype(int), 0, h - 1)
    yi1 = np.clip(y0.astype(int) + 1, 0, h - 1)
    top = img[yi0][:, xi0] * (1 - fx) + img[yi0][:, xi1] * fx
    bot = img[yi1][:, xi0] * (1 - fx) + img[yi1][:, xi1] * fx
    val = top * (1 - fy) + bot * fy
    m = val.max(axis=-1, keepdims=True)
    e = np.ceil(np.log2(np.maximum(m, 1e-32)))
    q = np.clip(np.floor(val * np.exp2(-e) * 255.0), 0, 255)
    out = q * np.exp2(e) / 255.0
    return np.where(m > 1e-30, out, 0.0)


class Scene:
    """The reference's view of a scene: its triangles, their atlas uvs and
    the radiance table, as tensors of one precision on one device."""

    def __init__(self, mesh, hdr: np.ndarray, device, dtype=torch.float32,
                 supersample: int = 2):
        tri = mesh.vertices.astype(np.float64)[mesh.faces]
        tuv = mesh.uvs.astype(np.float64)[mesh.uv_faces]

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device,
                                   dtype=torch.float32).to(dtype)

        self.p0 = t(tri[:, 0])
        self.e1 = t(tri[:, 1] - tri[:, 0])
        self.e2 = t(tri[:, 2] - tri[:, 0])
        self.uv0 = t(tuv[:, 0])
        self.duv1 = t(tuv[:, 1] - tuv[:, 0])
        self.duv2 = t(tuv[:, 2] - tuv[:, 0])
        self.table = t(prefiltered_atlas(hdr, supersample))
        self.dtype = dtype
        self.device = device

    def closest_hits(self, origin: torch.Tensor, dirs: torch.Tensor):
        """Closest hit (t > 0) of rays from one origin [3] along dirs
        [S, 3] against every triangle: (t [S], inf on a miss; atlas
        u, v [S])."""
        # Möller–Trumbore with its triple products regrouped so that each
        # is a product of the directions with a per-triangle vector:
        # det = e1.(d x e2) = d.(e2 x e1), b1 = T.(d x e2) / det
        # = d.(e2 x T) / det, b2 = d.(T x e1) / det, t = e2.(T x e1) / det
        nf = self.p0.shape[0]
        tvec = origin[None] - self.p0                       # [F, 3]
        qvec = torch.linalg.cross(tvec, self.e1)            # [F, 3]
        e2q = (self.e2 * qvec).sum(-1)                      # [F]
        nrm = torch.linalg.cross(self.e2, self.e1)          # [F, 3]
        e2t = torch.linalg.cross(self.e2, tvec)             # [F, 3]
        ts, us, vs = [], [], []
        step = max(1, _PAIRS // nf)
        for d in dirs.split(step):
            det = d @ nrm.T                                 # [s, F]
            ok = torch.abs(det) > 1e-12
            inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
            b1 = (d @ e2t.T) * inv
            b2 = (d @ qvec.T) * inv
            t = e2q[None] * inv
            hit = ok & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0)
            t = torch.where(hit, t, torch.full_like(t, float("inf")))
            t_min, f = t.min(dim=1)
            g1 = b1.gather(1, f[:, None])[:, 0]
            g2 = b2.gather(1, f[:, None])[:, 0]
            uv = (self.uv0[f] + g1[:, None] * self.duv1[f]
                  + g2[:, None] * self.duv2[f])
            ts.append(t_min)
            us.append(uv[:, 0])
            vs.append(uv[:, 1])
        return torch.cat(ts), torch.cat(us), torch.cat(vs)

    def radiance(self, t, u, v) -> torch.Tensor:
        """[S, 3] radiance of the hits: the nearest texel of the
        prefiltered table; zero on a miss or a hit nearer than 1e-4."""
        h, w, _ = self.table.shape
        u = torch.clamp(u, 0.0, 1.0)
        v = torch.clamp(v, 0.0, 1.0)
        x = torch.clamp((u.float() * w).long(), 0, w - 1)
        y = torch.clamp((v.float() * h).long(), 0, h - 1)
        rad = self.table[y, x]
        valid = torch.isfinite(t) & (t > 1e-4)
        return torch.where(valid[:, None], rad, torch.zeros_like(rad))


def irradiance(scene: Scene, mesh, res: int, spp: int, surface_eps: float,
               rows, cols, ids, seeds):
    """[K, 3] reference irradiance of atlas texels (rows, cols) baked with
    global ids `ids` under bake seeds `seeds`, and [K] whether a triangle
    covers each texel (an uncovered texel reads 0)."""
    dev, dt = scene.device, scene.dtype
    # float32 products stay float32: no TF32 on the card
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _irradiance(scene, mesh, res, spp, surface_eps, rows, cols,
                           ids, seeds)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _irradiance(scene, mesh, res, spp, surface_eps, rows, cols, ids, seeds):
    dev, dt = scene.device, scene.dtype
    pos, nrm, covered = texel_geometry(mesh, res, np.asarray(rows),
                                       np.asarray(cols))
    ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    shift = torch.zeros((len(rows), 2), device=dev)
    seeds = np.asarray(seeds, np.int64)
    for s in np.unique(seeds):
        sel = torch.as_tensor(np.flatnonzero(seeds == s), device=dev)
        shift[sel] = hash_uniforms(int(s), ids_t[sel], 2)
    base = torch.as_tensor(hammersley(spp), device=dev)
    normal = torch.as_tensor(nrm, dtype=torch.float32, device=dev).to(dt)
    dirs = hemisphere_dirs(normal, shift.to(dt), base.to(dt))  # [K, S, 3]
    origin = (torch.as_tensor(pos, dtype=torch.float32, device=dev).to(dt)
              + surface_eps * normal)
    out = torch.zeros((len(rows), 3), dtype=dt, device=dev)
    for i in range(len(rows)):
        if not covered[i]:
            continue
        t, u, v = scene.closest_hits(origin[i], dirs[i])
        rad = scene.radiance(t, u, v)
        ndl = torch.clamp((dirs[i] * normal[i][None]).sum(-1), 0.0, 1.0)
        out[i] = (rad * ndl[:, None]).sum(0) * (2.0 * math.pi / spp)
    return out.float(), covered
