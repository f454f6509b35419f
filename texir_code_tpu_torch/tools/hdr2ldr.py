"""γ-tonemap HDR frames to LDR PNGs (reference tools/hdr2ldr.py).

    python -m texir_code_tpu_torch.tools.hdr2ldr in1.hdr [in2.hdr ...] \
        --out-dir d
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from texir_code_tpu_torch.data import hdrio

    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.inputs:
        img = hdrio.read_hdr(path)
        ldr = hdrio.tonemap_to_ldr(img)
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        hdrio.write_png(os.path.join(args.out_dir, name), ldr)
        print(f"wrote {os.path.join(args.out_dir, name)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
