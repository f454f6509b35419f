"""Repack pano-space images into the mesh atlas via the scan index texture.

The port of the JAX package's `tools/trans_hdr_tex.py` (a rebuild of
reference tools/trans_hdr_tex.py:16-216), without OpenCV.  The real-scan
pipeline's "index texture" `hdr_texture/0.png` stores, per atlas texel, a
*multi-view* pano lookup, in OpenCV's channel order (B, G, R of the file):

    channel 0: pano row as a fraction of height, fixed-point ×50000
    channel 1: pano col as a fraction of width,  fixed-point ×50000
    channel 2: view id — an index into info/aligned.txt (reference :27-34)

so each texel is pulled from the pano of the view that best observed it.
Texels whose three channels sum to zero are unmapped seams and stay black
(reference :56-57).  Four repack targets, matching the reference entry
points:

    hdr        hdr/<id>/ccm.hdr            → 0_hdr_ccm_upper.hdr  (:16-61)
    seg        derived/<id>/panoImage_gray.png → 0_seg_gray.png    (:64-110)
    albedo     methods/<m>/<id>/albedo.png → 0_<m>_albedo.png      (:112-163)
    roughness  methods/<m>/<id>/roughness.png → 0_<m>_roughness.png (:165-216)

The material variants apply the reference's 1/2.2 re-encode, 2048²
resize and 4×4 dilation (:152,157-159): `resize_linear` is cv2.resize's
INTER_LINEAR on 8-bit images (half-pixel centres, 11-bit fixed-point
weights; OpenCV rounds its scalar tail and some border texels otherwise,
so a value may lie one level apart), `dilate` is cv2.dilate with
np.ones((4, 4)), exactly.  Images go through the port's codecs
(data/hdrio.py); the panos' channel order is kept from read to write, as
OpenCV's round trip keeps it.

    python -m texir_code_tpu_torch.tools.trans_hdr_tex hdr --project PATH
    python -m texir_code_tpu_torch.tools.trans_hdr_tex albedo \
        --project PATH --method phyir
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Tuple

import numpy as np

PACK_SCALE = 50000.0  # the reference's fixed-point packing divisor
_COEF_BITS = 11       # OpenCV's INTER_RESIZE_COEF_BITS


def read_scan_ids(project_path: str) -> list:
    with open(os.path.join(project_path, "info", "aligned.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def decode_index_texture(
    index_img: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Index texture (OpenCV channel order) → (row_frac, col_frac, view_id,
    valid).

    row/col are fractions of the pano extent (each view's pano may have
    its own resolution — scaling happens per view, reference :50-53).
    """
    idx = np.asarray(index_img)
    if idx.ndim != 3 or idx.shape[2] < 3:
        raise ValueError("index texture must have 3 channels (row/col/view)")
    row_frac = idx[..., 0].astype(np.float64) / PACK_SCALE
    col_frac = idx[..., 1].astype(np.float64) / PACK_SCALE
    view_id = idx[..., 2].astype(np.int64)
    valid = (
        idx[..., 0].astype(np.int64)
        + idx[..., 1].astype(np.int64)
        + idx[..., 2].astype(np.int64)
    ) > 0
    return row_frac, col_frac, view_id, valid


def repack_multiview(
    index_img: np.ndarray,
    load_pano,
    view_ids: Optional[list] = None,
    dtype=np.float32,
    channels: int = 3,
) -> np.ndarray:
    """Pull each atlas texel from its view's pano.

    load_pano(view_id:int) -> [H, W, C] array (H/W may differ per view).
    Vectorized per view id — one fancy-gather per distinct view
    (the reference loops views the same way, :28-54).
    """
    row_frac, col_frac, vid, valid = decode_index_texture(index_img)
    out = np.zeros(index_img.shape[:2] + (channels,), dtype)
    present = np.unique(vid[valid]) if view_ids is None else view_ids
    for v in present:
        sel = valid & (vid == v)
        if not sel.any():
            continue
        pano = load_pano(int(v))
        h, w = pano.shape[:2]
        rows = np.clip((row_frac[sel] * h).astype(np.int64), 0, h - 1)
        cols = np.clip((col_frac[sel] * w).astype(np.int64), 0, w - 1)
        out[sel] = pano[rows, cols, :channels].astype(dtype)
    return out


def _linear_taps(n_out: int, n_in: int):
    """OpenCV's INTER_LINEAR source taps and fixed-point weights along one
    axis: half-pixel centres, the border clamped to the edge texel."""
    x = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    x0 = np.floor(x).astype(np.int64)
    f = x - x0
    lo = x0 < 0
    f[lo], x0[lo] = 0.0, 0
    hi = x0 >= n_in - 1
    f[hi], x0[hi] = 0.0, n_in - 1
    a0 = np.round((1.0 - f) * (1 << _COEF_BITS)).astype(np.int64)
    return x0, np.minimum(x0 + 1, n_in - 1), a0, (1 << _COEF_BITS) - a0


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) (INTER_LINEAR) of a uint8 [H, W(, C)] image to
    size = (width, height): 11-bit fixed-point weights, the row pass in
    int32, the column pass rounded as OpenCV's vectorised loop rounds it
    (each row term >> 4, times its weight >> 16, the sum + 2 >> 2)."""
    if img.dtype != np.uint8:
        raise ValueError("resize_linear takes uint8 images")
    w_out, h_out = size
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(w_out, w)
    y0, y1, ay0, ay1 = _linear_taps(h_out, h)
    extra = (None,) * (img.ndim - 2)
    ax = (slice(None),) + extra
    ay = (slice(None), None) + extra
    src = img.astype(np.int64)
    rows = (src[:, x0] * ax0[ax] + src[:, x1] * ax1[ax]) >> 4
    out = (((rows[y0] * ay0[ay]) >> 16) + ((rows[y1] * ay1[ay]) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def dilate(img: np.ndarray, k: int = 4) -> np.ndarray:
    """cv2.dilate(img, np.ones((k, k))): the max over the k×k window whose
    anchor is its (k//2, k//2) cell; texels outside the image are ignored."""
    h, w = img.shape[:2]
    a = k // 2
    pad = np.zeros((h + k - 1, w + k - 1) + img.shape[2:], img.dtype)
    pad[a:a + h, a:a + w] = img
    out = pad[:h, :w].copy()
    for i in range(k):
        for j in range(k):
            np.maximum(out, pad[i:i + h, j:j + w], out=out)
    return out


def _read_index(project_path: str) -> Tuple[str, np.ndarray]:
    """The index texture in OpenCV's channel order (BGR(A))."""
    from texir_code_tpu_torch.data import hdrio

    path = os.path.join(project_path, "hdr_texture", "0.png")
    if not glob.glob(path):
        raise FileNotFoundError(path)
    img = hdrio.read_png(path)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return path, img


def _gray_to_rgb(pano: np.ndarray) -> np.ndarray:
    return np.repeat(pano[:, :, None], 3, axis=-1) if pano.ndim == 2 else pano


def repack_hdr_texture(project_path: str) -> str:
    """hdr/<scanId>/ccm.hdr panos → atlas HDR (reference :16-61)."""
    from texir_code_tpu_torch.data import hdrio

    index_path, index_img = _read_index(project_path)
    scan_ids = read_scan_ids(project_path)

    def load(v):
        return hdrio.read_hdr(
            os.path.join(project_path, "hdr", scan_ids[v], "ccm.hdr"))

    out = repack_multiview(index_img, load, dtype=np.float32)
    dst = index_path.replace(".png", "_hdr_ccm_upper.hdr")
    hdrio.write_hdr(dst, out)
    return dst


def repack_seg_texture(project_path: str) -> str:
    """derived/<scanId>/panoImage_gray.png → atlas seg (reference :64-110)."""
    from texir_code_tpu_torch.data import hdrio

    index_path, index_img = _read_index(project_path)
    scan_ids = read_scan_ids(project_path)

    def load(v):
        return _gray_to_rgb(hdrio.read_png(os.path.join(
            project_path, "derived", scan_ids[v], "panoImage_gray.png")))

    out = repack_multiview(index_img, load, dtype=np.uint8)
    dst = index_path.replace(".png", "_seg_gray.png")
    hdrio.write_png(dst, out)
    return dst


def repack_material_texture(
    project_path: str,
    method: str = "phyir",
    kind: str = "albedo",
    out_res: int = 2048,
) -> str:
    """methods/<method>/<scanId>/<kind>.png → re-encoded, resized, dilated
    atlas (reference :112-216)."""
    from texir_code_tpu_torch.data import hdrio

    index_path, index_img = _read_index(project_path)
    scan_ids = read_scan_ids(project_path)

    def load(v):
        pano = _gray_to_rgb(hdrio.read_png(os.path.join(
            project_path, "methods", method, scan_ids[v], f"{kind}.png")))
        # the reference re-encodes LDR predictions: (x/255)^(1/2.2)*255
        return (
            np.power(pano[..., :3].astype(np.float64) / 255.0, 1.0 / 2.2)
            * 255.0
        )

    out = repack_multiview(index_img, load, dtype=np.uint8)
    out = dilate(resize_linear(out, (out_res, out_res)), 4)
    dst = index_path.replace(".png", f"_{method}_{kind}.png")
    hdrio.write_png(dst, out)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="repack pano-space images into the mesh atlas"
    )
    ap.add_argument(
        "target", choices=["hdr", "seg", "albedo", "roughness"],
    )
    ap.add_argument("--project", required=True, help="scan project root")
    ap.add_argument("--method", default="phyir",
                    help="method name for albedo/roughness repack")
    args = ap.parse_args(argv)
    if args.target == "hdr":
        dst = repack_hdr_texture(args.project)
    elif args.target == "seg":
        dst = repack_seg_texture(args.project)
    else:
        dst = repack_material_texture(args.project, args.method, args.target)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
