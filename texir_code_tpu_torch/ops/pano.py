"""Equirectangular ↔ cubemap warps.

The port of the JAX package's `ops/pano.py` (reference utils/Cube2Pano.py,
utils/Pano2Cube.py), face order [left, front, right, back, top, bottom]:

  * pano→cube: per-face rotation grids (about y at -90/0/+90/180° for the
    four horizontal faces, about x at -90/+90° for top/bottom), turned
    into (azimuth, elevation) and sampled from the pano with grid_sample
    semantics (border padding, align_corners=False);
  * cube→pano: per-pano-pixel sphere directions projected onto each face;
    each face contributes where its axis dominates.

The grids are numpy, computed once per resolution exactly as the JAX
package computes them; `ops.texture.grid_sample` rounds nearest taps as
the JAX package does (floor(x + 0.5)), so the warped segmentation ids
land on the same pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from texir_code_tpu_torch.ops.texture import grid_sample

FACE_ORDER = ("left", "front", "right", "back", "top", "bottom")


def _rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def pano_to_cube_grids(cube_len: int) -> np.ndarray:
    """[6, L, L, 2] grid_sample grids into the pano: u = azimuth/π,
    v = -elevation/(π/2) (utils/Pano2Cube.py:36-82)."""
    angles_y = np.deg2rad([-90.0, 0.0, 90.0, 180.0])
    rotations = [_rotation_y(a) for a in angles_y]
    rotations += [_rotation_x(np.deg2rad(-90.0)),
                  _rotation_x(np.deg2rad(90.0))]

    sx, sy = np.meshgrid(
        np.linspace(-1.0, 1.0, cube_len), np.linspace(1.0, -1.0, cube_len)
    )
    r = np.sqrt(sx * sx + sy * sy + 1.0)
    x = (sx / r).astype(np.float32)
    y = (sy / r).astype(np.float32)
    z = np.sqrt(np.maximum(1.0 - x * x - y * y, 0.0)).astype(np.float32)
    xyz = np.stack([x, y, z], axis=0).reshape(3, -1)  # [3, L²]

    grids = []
    for rot in rotations:
        p = (rot @ xyz).T  # [L², 3]
        azimuth = np.arctan2(p[:, 0], p[:, 2])
        elevation = np.arcsin(np.clip(p[:, 1], -1.0, 1.0))
        u = azimuth / np.pi
        v = -elevation / (np.pi / 2.0)
        grids.append(np.stack([u, v], axis=-1).reshape(cube_len, cube_len, 2))
    return np.stack(grids, axis=0).astype(np.float32)


def cube_to_pano_grids(pano_h: int, pano_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """([6, H, W, 2] face grids, [6, H, W, 1] masks) for cube→pano
    (utils/Cube2Pano.py:57-117): θ ∈ [-π, π] over width, φ ∈ [π/2, -π/2]
    over height."""
    theta, phi = np.meshgrid(
        np.linspace(-np.pi, np.pi, pano_w, dtype=np.float32),
        np.linspace(0.5 * np.pi, -0.5 * np.pi, pano_h, dtype=np.float32),
    )
    x = np.cos(phi) * np.sin(theta)
    y = np.sin(phi)
    z = np.cos(phi) * np.cos(theta)

    def face(u, v, side):
        grid = np.stack([u, v], axis=-1)
        mask = ((u >= -1) & (u <= 1) & (v >= -1) & (v <= 1) & side)
        return grid, mask.astype(np.float32)[..., None]

    eps = 1e-12
    ax, ay, az = np.abs(x) + eps, np.abs(y) + eps, np.abs(z) + eps
    faces = [
        face(z / ax, -y / ax, x < 0),    # left
        face(x / az, -y / az, z > 0),    # front
        face(-z / ax, -y / ax, x > 0),   # right
        face(-x / az, -y / az, z < 0),   # back
        face(x / ay, z / ay, y > 0),     # top
        face(x / ay, -z / ay, y < 0),    # bottom
    ]
    grids = np.stack([f[0] for f in faces], axis=0).astype(np.float32)
    masks = np.stack([f[1] for f in faces], axis=0)
    return grids, masks


class PanoCubeWarp:
    """Bidirectional pano↔cube warp for a fixed (pano_h, pano_w, cube_len),
    with its grids on `device`."""

    def __init__(self, pano_h: int, pano_w: int, cube_len: int,
                 device="cpu"):
        self.pano_h = pano_h
        self.pano_w = pano_w
        self.cube_len = cube_len
        self._to_cube_grids = torch.from_numpy(
            pano_to_cube_grids(cube_len)).to(device)
        g, m = cube_to_pano_grids(pano_h, pano_w)
        self._to_pano_grids = torch.from_numpy(g).to(device)
        self._to_pano_masks = torch.from_numpy(m).to(device)

    def to_cube(self, pano: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
        """[H, W, C] pano → [6, L, L, C] cube faces."""
        return torch.stack([
            grid_sample(pano, self._to_cube_grids[f], mode=mode,
                        padding_mode="border")
            for f in range(6)
        ], dim=0)

    def to_pano(self, cube: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
        """[6, L, L, C] cube faces → [H, W, C] pano (masked sum of faces)."""
        acc = torch.zeros((self.pano_h, self.pano_w, cube.shape[-1]),
                          dtype=cube.dtype, device=cube.device)
        for f in range(6):
            # the grid is zeroed outside the mask, as the reference does
            # (utils/Cube2Pano.py:132-141): masked grid and masked output
            grid = self._to_pano_grids[f] * self._to_pano_masks[f]
            out = grid_sample(cube[f], grid, mode=mode, padding_mode="border")
            acc = acc + out * self._to_pano_masks[f]
        return acc
