"""Datasets over the reference's scan-data layout.

The port of the JAX package's `data/datasets.py` for the classes the Mat
stage, the testers and the field stages read:

    <root>/mesh/out1.obj (+hdr_texture.hdr, irt.hdr)   mesh + atlases
    <root>/info/aligned.txt                  view ids, one per line
    <root>/info/final_extrinsics.txt         header + 4 rows of 4 per view
    <root>/derived/<id>/panoImage_orig.jpg   LDR pano (or .png, with alpha)
    <root>/derived/<id>/panoImage_gray.png   semantic segmentation pano
    <root>/hdr/<id>/ccm.hdr                  HDR pano
    (synthetic) <root>/gt/albedo.hdr, roughness.hdr, info/novel.txt

  * ImageDerived — equirect HDR views + masks (reference
    datasets/dataset.py:242-349);
  * ImageCubeDerived — cube-face stacks + per-face MVPs (:352-549);
  * ImageCubeSyn — + GT materials + the held-out novel split (:669-893);
  * ImageCubeNovel — the novel-view tester's dolly trajectory (:552-666);
  * MeshPoint — uniform surface points resampled every epoch, the field
    stages' training set (:39-93);
  * ImageMeshPoint — one view's pano G-buffer, the NIrF validation set
    (:96-238).

No OpenCV: the erosion, Sobel gradient and nearest resize are scipy/numpy
with cv2's border rules (erosion: outside = the maximum value; Sobel:
BORDER_REFLECT_101, scipy's "mirror"); gray = 0.299 R + 0.587 G + 0.114 B.
A JPEG pano gives only its size (it has no alpha), so its mask is all
ones, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy import ndimage

from texir_code_tpu_torch.data import hdrio


# the novel-view dolly of the JAX package's ImageCubeNovel (its defaults)
NOVEL_START_OFFSET = np.asarray((-0.2, 0.0, -0.6), np.float32)
NOVEL_DIRECTION = np.asarray((1.0, 0.0, 0.0), np.float32)
NOVEL_DISTANCE = 6.0


def _root_from_mesh(path_mesh: str) -> str:
    """The data root is dirname(dirname(mesh)) (datasets/dataset.py:356)."""
    return os.path.dirname(os.path.dirname(path_mesh))


def read_ids(root: str) -> List[str]:
    with open(os.path.join(root, "info", "aligned.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_extrinsics(root: str) -> np.ndarray:
    """[N, 4, 4] camera-to-world matrices (header line skipped)."""
    with open(os.path.join(root, "info", "final_extrinsics.txt")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    rows = [list(map(float, ln.split())) for ln in lines[1:]]
    return np.asarray(rows, np.float32).reshape(-1, 4, 4)


class MeshPoint:
    """Uniform surface points, resampled every epoch (reference :39-93).
    numpy's `default_rng(seed)` and `Mesh.sample_surface` draw them, as in
    the JAX package: the same seed gives the same points."""

    def __init__(self, path_mesh: str, num_sample: int = 1024,
                 offset: float = 1e-2, seed: int = 666):
        from texir_code_tpu_torch.geometry import load_obj

        self.mesh = load_obj(path_mesh)
        self.num_sample = num_sample
        self.offset = offset
        self._rng = np.random.default_rng(seed)
        self.aabb = self.mesh.aabb()
        self.points = np.zeros((0, 3), np.float32)
        self.normals = np.zeros((0, 3), np.float32)
        self.change_points()

    def change_points(self) -> None:
        """Resample the point set (reference :80-81, once an epoch)."""
        pts, nrm = self.mesh.sample_surface(self.num_sample, self._rng)
        self.points = pts + self.offset * nrm
        self.normals = nrm

    def __len__(self) -> int:
        return self.num_sample

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {"points": self.points[idx], "normals": self.normals[idx]}

    def batches(self, batch_size: int):
        for s in range(0, self.num_sample, batch_size):
            sl = slice(s, s + batch_size)
            yield {"points": self.points[sl], "normals": self.normals[sl]}


class ImageMeshPoint:
    """Pano G-buffer (position + normal) of one fixed view, the NIrF
    validation set (reference :96-238 renders it with pyredner; here the
    BVH traversal casts the pano's rays at t_min 1e-5).  Pixels that hit
    nothing get zero points and normals, and `mask` False."""

    def __init__(self, path_mesh: str, env_res: Tuple[int, int] = (512, 1024),
                 view_index: int = 0, offset: float = 1e-2, device="cuda"):
        from texir_code_tpu_torch.device import resolve_device
        from texir_code_tpu_torch.geometry import build_bvh, load_obj
        from texir_code_tpu_torch.ops.gbuffer import (
            DeviceMesh,
            interpolate_attributes,
        )
        from texir_code_tpu_torch.ops.raycast import DeviceBVH, cast_rays

        dev = resolve_device(device)
        self.env_res = tuple(env_res)
        mesh = load_obj(path_mesh)
        ext = read_extrinsics(_root_from_mesh(path_mesh))[view_index]
        cam = ext[0:3, 3]
        h, w = self.env_res
        theta, phi = np.meshgrid(
            np.linspace(-np.pi, np.pi, w, dtype=np.float32),
            np.linspace(0.5 * np.pi, -0.5 * np.pi, h, dtype=np.float32),
        )
        dirs = np.stack(
            [np.cos(phi) * np.sin(theta), np.sin(phi),
             np.cos(phi) * np.cos(theta)], axis=-1,
        ).reshape(-1, 3)
        dirs = dirs @ ext[0:3, 0:3].T  # into the world by the camera basis
        origins = np.broadcast_to(cam, dirs.shape).astype(np.float32)

        bvh = DeviceBVH.from_flat(build_bvh(mesh.vertices, mesh.faces),
                                  device=dev)
        hit = cast_rays(bvh, torch.from_numpy(origins).to(dev),
                        torch.from_numpy(np.ascontiguousarray(dirs)).to(dev),
                        t_min=1e-5)
        pos, nrm, _ = interpolate_attributes(DeviceMesh.from_mesh(mesh, dev),
                                             hit)
        valid = (hit.prim >= 0).cpu().numpy()
        pos, nrm = pos.cpu().numpy(), nrm.cpu().numpy()
        self.points = (pos + offset * nrm).astype(np.float32)
        self.normals = nrm.astype(np.float32)
        self.mask = valid.reshape(h, w)
        self.points[~valid] = 0
        self.normals[~valid] = 0

    def __len__(self) -> int:
        return self.points.shape[0]

    def batches(self, batch_size: int):
        for s in range(0, len(self), batch_size):
            sl = slice(s, s + batch_size)
            yield {"points": self.points[sl], "normals": self.normals[sl]}


def _pano_mask(derived_dir: str, k: int = 5) -> np.ndarray:
    """[H, W, 1] photo mask: the LDR pano's alpha, eroded k×k as uint8
    (cv2.erode: pixels outside the image count as 255)."""
    jpg = os.path.join(derived_dir, "panoImage_orig.jpg")
    if os.path.exists(jpg):
        h, w = hdrio.jpeg_size(jpg)
        mask = np.ones((h, w), np.float32)
    else:
        ldr = hdrio.read_image(os.path.join(derived_dir, "panoImage_orig.png"))
        h, w = ldr.shape[:2]
        mask = ldr[:, :, 3] if ldr.ndim == 3 and ldr.shape[-1] == 4 else \
            np.ones((h, w), np.float32)
    mask8 = (mask * 255).astype(np.uint8)
    mask8 = ndimage.grey_erosion(mask8, size=(k, k), mode="constant", cval=255)
    return (mask8.astype(np.float32) / 255.0)[..., None]


def _gradient_magnitude(color: np.ndarray) -> np.ndarray:
    """[H, W, 1] |Sobel| of the gray image (cv2.cvtColor RGB2GRAY, 3×3
    cv2.Sobel with BORDER_REFLECT_101, cv2.magnitude)."""
    gray = (color[..., 0] * np.float32(0.299) + color[..., 1] * np.float32(0.587)
            + color[..., 2] * np.float32(0.114)).astype(np.float32)
    gx = ndimage.sobel(gray, axis=1, mode="mirror")
    gy = ndimage.sobel(gray, axis=0, mode="mirror")
    return np.sqrt(gx * gx + gy * gy)[..., None]


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(..., INTER_NEAREST): source index floor(i · src/dst)."""
    rows = np.minimum((np.arange(h) * (img.shape[0] / h)).astype(int),
                      img.shape[0] - 1)
    cols = np.minimum((np.arange(w) * (img.shape[1] / w)).astype(int),
                      img.shape[1] - 1)
    return img[rows][:, cols]


class ImageDerived:
    """Equirect HDR views + their photo masks, eroded 7×7 (reference
    :242-349)."""

    def __init__(self, path_mesh: str, hdr_exposure: float = 5.0):
        self.root = _root_from_mesh(path_mesh)
        self.hdr_exposure = hdr_exposure
        self.ids = read_ids(self.root)
        self.extrinsics = read_extrinsics(self.root)[: len(self.ids)]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        vid = self.ids[index]
        mask = _pano_mask(os.path.join(self.root, "derived", vid), k=7)
        color = hdrio.read_hdr(os.path.join(self.root, "hdr", vid, "ccm.hdr"))
        color = np.clip(color, 0.0, None) * (2.0 ** self.hdr_exposure)
        return {
            "color": color,
            "mask": mask,
            "cam_to_world": self.extrinsics[index],
            "cam_position": self.extrinsics[index][0:3, 3],
            "id": vid,
        }


class ImageCubeDerived:
    """Cube-face stacks + per-face MVPs — the Mat-stage input."""

    def __init__(self, path_mesh: str, resolution: Tuple[int, int] = (256, 512),
                 hdr_exposure: float = 5.0):
        self.root = _root_from_mesh(path_mesh)
        self.resolution = tuple(resolution)
        self.cube_res = int(resolution[1] // 4)
        self.hdr_exposure = hdr_exposure
        self.ids = read_ids(self.root)
        self.extrinsics = read_extrinsics(self.root)[: len(self.ids)]
        self._warp = None  # the pano size is known from the first image

    def __len__(self) -> int:
        return len(self.ids)

    def _get_warp(self, h: int, w: int):
        from texir_code_tpu_torch.ops.pano import PanoCubeWarp

        if self._warp is None or self._warp.pano_h != h:
            self._warp = PanoCubeWarp(h, w, self.cube_res)
        return self._warp

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from texir_code_tpu_torch.ops.gbuffer import cube_mvp

        vid = self.ids[index]
        derived = os.path.join(self.root, "derived", vid)
        mask = _pano_mask(derived)
        h, w = mask.shape[:2]

        color = hdrio.read_hdr(os.path.join(self.root, "hdr", vid, "ccm.hdr"))
        color = np.clip(color, 0.0, None) * np.float32(2.0 ** self.hdr_exposure)
        rgb_grad = _gradient_magnitude(color)

        segs = hdrio.read_gray(os.path.join(derived, "panoImage_gray.png"))
        if segs.shape != (h, w):
            segs = _resize_nearest(segs, h, w)
        segs = segs[..., None].astype(np.float32)

        # pano → 6 cube faces (nearest, like the reference :515)
        packed = np.concatenate([color, mask, segs, rgb_grad], axis=-1)
        cube = self._get_warp(h, w).to_cube(
            torch.from_numpy(np.ascontiguousarray(packed, np.float32)),
            mode="nearest").numpy()
        return {
            "color": cube[..., 0:3],
            "mask": cube[..., 3:4],
            "segs": cube[..., 4:5],
            "rgb_grad": cube[..., 5:6],
            "cam_to_world": cube_mvp(self.extrinsics[index]).numpy(),
            "cam_position": self.extrinsics[index][0:3, 3],
            "id": vid,
        }


class ImageCubeSyn(ImageCubeDerived):
    """Synthetic scenes: ImageCubeDerived + GT materials + novel split."""

    def __init__(self, path_mesh: str, resolution: Tuple[int, int] = (256, 512),
                 hdr_exposure: float = 5.0):
        super().__init__(path_mesh, resolution, hdr_exposure)
        novel_path = os.path.join(self.root, "info", "novel.txt")
        self.novel_ids: List[str] = []
        if os.path.exists(novel_path):
            with open(novel_path) as f:
                self.novel_ids = [ln.strip() for ln in f if ln.strip()]
        self.train_ids = [i for i in self.ids if i not in self.novel_ids]
        gt_dir = os.path.join(self.root, "gt")
        self.gt_albedo = None
        self.gt_roughness = None
        a = os.path.join(gt_dir, "albedo.hdr")
        r = os.path.join(gt_dir, "roughness.hdr")
        if os.path.exists(a):
            # sRGB → linear, as the reference does (:849)
            self.gt_albedo = np.power(hdrio.read_hdr(a), 2.2)
        if os.path.exists(r):
            self.gt_roughness = hdrio.read_hdr(r)[..., 0:1]


class ImageCubeNovel:
    """Synthesized dolly trajectory (reference :552-666): `num` poses from
    view `start_index`, moved by NOVEL_START_OFFSET, then along
    NOVEL_DIRECTION by NOVEL_DISTANCE / `num` a pose."""

    def __init__(self, path_mesh: str, resolution: Tuple[int, int] = (256, 512),
                 start_index: int = 2, num: int = 60):
        self.cube_res = int(resolution[1] // 4)
        base = read_extrinsics(_root_from_mesh(path_mesh))[start_index].copy()
        base[0:3, 3] += NOVEL_START_OFFSET
        step = NOVEL_DISTANCE / num
        self.extrinsics = []
        for i in range(num):
            e = base.copy()
            e[0:3, 3] = e[0:3, 3] + NOVEL_DIRECTION * step * i
            self.extrinsics.append(e)

    def __len__(self) -> int:
        return len(self.extrinsics)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from texir_code_tpu_torch.ops.gbuffer import cube_mvp

        e = self.extrinsics[index]
        return {"cam_to_world": cube_mvp(e).numpy(),
                "cam_position": e[0:3, 3]}
