"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  --trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics (a traced window, read by metrics/<name>.py).  The
last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, breakdown with --trace 1, checks); the numbers
compared with the reference, each beside its limit, are also the last
lines of standard error.  Exits non-zero, printing no result, without
the card(s), or if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# every cache the run writes stays at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(_HERE, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_HERE, "_cache",
                                                  "torch_ext")

FORBIDDEN = ("jax", "jaxlib", "flax", "texir_code_tpu")


def loaded_forbidden(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole: texir_code_tpu_torch is not texir_code_tpu."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                       else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, check=None, bench=None, root=None) -> dict:
    """One run of cell `name` on `device`; the result object.  `bench`
    and `root` replace BENCHMARK.json and the checkout's root (tests)."""
    import torch

    from port_bench import spec

    root = root or spec.ROOT
    cell = spec.cell(name, bench, root=root)
    if cell.kind == "bake":
        from port_bench import bake as driver
    elif cell.kind == "mat":
        from port_bench import mat as driver
    else:
        raise ValueError(f"unknown traffic kind {cell.kind!r}")
    readings, e2e, checks, attempted, failed, peak = driver.run(
        cell, seed, seconds, trace, device, t_start, check=check)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"], root).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    correct = all(v == v and v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct and failed == 0),
           "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace and readings.trace is not None:
        tr = readings.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def card_state(fields: str = "name,power.limit") -> str:
    """What nvidia-smi reads of the card (`fields`, its query names)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def bytes_written():
    """Bytes this process has written to storage (/proc/self/io), or
    None where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import texir_code_tpu_torch  # noqa: F401  (the program under test)
    from port_bench import spec

    chips = spec.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(f"port_bench: {args.workload} seed {args.seed} on "
          f"{card_state()}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, T_START)
    print("port_bench: after the run: sm clock, power, temperature "
          + card_state("clocks.sm,power.draw,temperature.gpu"),
          file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4
    written = bytes_written()
    if written is not None:
        print(f"port_bench: this process wrote {written} bytes",
              file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
