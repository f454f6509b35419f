"""Pad + denoise a baked irradiance texture (standalone tool).

Reference tools/padding_texture.py:49-87: distance-transform nearest-texel
fill of the black chart seams, then OIDN (`oidnDenoise --hdr`) via shell.
Here the denoiser is the port's à-trous kernel (ops/postprocess.py), on
`--device` (default the card) — no external binary.

    python -m texir_code_tpu_torch.tools.padding_texture in.hdr out.hdr \
        [--no-denoise] [--device cuda|cpu]
    python -m texir_code_tpu_torch.tools.padding_texture in.png out.png \
        --index

`--index` is the reference's `padding_index_texture` (:8-47) variant: a
uint16 fixed-point index texture (the ×50000 pano-coordinate packing,
tools/trans_hdr_tex.py) is nearest-filled on its zero texels with no
denoising — the packed values pass through bit-exact.  PNGs are read and
written by the port's own codec (data/hdrio.py, 8 and 16 bit).
"""

from __future__ import annotations

import argparse

import numpy as np


def pad_and_denoise(tex: np.ndarray, denoise: bool = True,
                    device="cuda") -> np.ndarray:
    import torch

    from texir_code_tpu_torch.device import resolve_device
    from texir_code_tpu_torch.ops.postprocess import (
        atrous_denoise,
        pad_texture,
    )

    valid = tex.sum(-1) > 0
    out = pad_texture(tex, valid)
    if denoise:
        t = torch.from_numpy(np.ascontiguousarray(out, np.float32))
        out = atrous_denoise(t.to(resolve_device(device))).cpu().numpy()
    return out


def pad_index_texture(img: np.ndarray) -> np.ndarray:
    """Nearest-fill zero texels of a uint16 index texture, bit-exact on the
    mapped texels (reference padding_index_texture, :8-47: the mask is
    channel-sum == 0, fill is nearest non-zero texel, values untouched)."""
    from texir_code_tpu_torch.ops.postprocess import pad_texture

    valid = img.reshape(img.shape[0], img.shape[1], -1).sum(-1) > 0
    if not valid.any():
        # distance_transform_edt with no background degenerates — the
        # "padded" output would be the broken all-zero input, silently
        raise ValueError(
            "index texture has no non-zero texel: nothing to pad from"
        )
    return pad_texture(img, valid)


def main(argv=None):
    from texir_code_tpu_torch.data import hdrio

    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--no-denoise", action="store_true")
    ap.add_argument("--index", action="store_true",
                    help="uint16 index-texture mode (no denoise, bit-exact)")
    ap.add_argument("--device", default="cuda",
                    help="where the denoiser runs (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.index:
        img = hdrio.read_png(args.input)
        out = pad_index_texture(img)
        hdrio.write_png(args.output, out.astype(img.dtype))
    else:
        tex = hdrio.read_hdr(args.input)
        out = pad_and_denoise(tex, denoise=not args.no_denoise,
                              device=args.device)
        hdrio.write_hdr(args.output, out)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
