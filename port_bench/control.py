"""The control of a cell's correctness check, and the program's readings
beside it, on many seeds in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--out <file.json>]

For each seed it runs the cell's window (short), then compares with the
float32 reference both what the program produced and what the reference
computed in the nearest lower precision (bfloat16) in its place, at the
same sampled texels.  The program's readings set the lower end of each
limit, the control's the upper (PERF.md, "How correct is decided").  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def bake_readings(cell, seeds, seconds, device):
    """[(seed, program's numbers, control's numbers)] of a bake cell."""
    import torch

    from port_bench import bake
    from port_bench.reference import bake_ref

    rows = []
    keep = {}
    for seed in seeds:
        seen = {}

        def both(scene, cfg, got, rows, cols, ids, seeds, device):
            args = (cfg["atlas_res"], cfg["spp"], cfg["surface_eps"], rows,
                    cols, ids, seeds)
            ref, covered = bake_ref.irradiance(
                bake_ref.Scene(scene.mesh, scene.hdr_texture, device),
                scene.mesh, *args)
            low, _ = bake_ref.irradiance(
                bake_ref.Scene(scene.mesh, scene.hdr_texture, device,
                               dtype=torch.bfloat16), scene.mesh, *args)
            seen["control"] = bake.compare(low.cpu(), ref.cpu(), covered,
                                           cfg["limits"])
            return bake.compare(got, ref.cpu(), covered, cfg["limits"])

        _, _, checks, _, _, _ = bake.run(cell, seed, seconds, False, device,
                                         time.time(), check=both, keep=keep)
        rows.append((seed, {k: v for k, (v, _) in checks.items()},
                     {k: v for k, (v, _) in seen["control"].items()}))
        print(json.dumps({"seed": seed, "program": rows[-1][1],
                          "control": rows[-1][2]}), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from port_bench import spec

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.kind == "bake":
        rows = bake_readings(cell, seeds, args.seconds, device)
    else:
        from port_bench import mat

        rows = mat.control_readings(cell, seeds, args.seconds, device)
    summary = {}
    for side in (1, 2):
        for k in rows[0][side]:
            vals = [r[side][k] for r in rows]
            summary[f"{('program', 'control')[side - 1]}.{k}"] = [
                min(vals), max(vals)]
    print(json.dumps({"workload": args.workload, "min_max": summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "min_max": summary}, f, indent=1)


if __name__ == "__main__":
    main()
