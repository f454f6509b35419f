"""Datasets over the reference's scan-data layout (the Mat stage's input).

The port of the JAX package's `data/datasets.py` for the classes the Mat
stage and the testers read:

    <root>/mesh/out1.obj (+hdr_texture.hdr, irt.hdr)   mesh + atlases
    <root>/info/aligned.txt                  view ids, one per line
    <root>/info/final_extrinsics.txt         header + 4 rows of 4 per view
    <root>/derived/<id>/panoImage_orig.jpg   LDR pano (or .png, with alpha)
    <root>/derived/<id>/panoImage_gray.png   semantic segmentation pano
    <root>/hdr/<id>/ccm.hdr                  HDR pano
    (synthetic) <root>/gt/albedo.hdr, roughness.hdr, info/novel.txt

  * ImageCubeDerived — cube-face stacks + per-face MVPs (reference
    datasets/dataset.py:352-549);
  * ImageCubeSyn — + GT materials + the held-out novel split (:669-893);
  * ImageCubeNovel — the novel-view tester's dolly trajectory (:552-666).

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


def _pano_mask(derived_dir: str) -> np.ndarray:
    """[H, W, 1] photo mask: the LDR pano's alpha, eroded 5×5 as uint8
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
    mask8 = ndimage.grey_erosion(mask8, size=(5, 5), mode="constant", cval=255)
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
