"""A/B of kernels B1 (csrc/culled_walk.cu), B2/B3 (csrc/fan_stream.cu)
and S (csrc/scatter_acc.cu) against other builds of their sources, on one
card in one process.

    python -m texir_code_tpu_torch.scripts.kernel_ab \\
        [--walk CU [CU ...]] [--fan CU [CU ...]] [--fan-same CU [CU ...]] \\
        [--scatter CU [CU ...]] [--reps 10]

Run it from the root of a checkout: its rows are chip_smoke.py's.  Keep
the other sources where git does not track them, e.g.

    mkdir -p archive_check
    git show <commit>:texir_code_tpu_torch/csrc/culled_walk.cu \\
        > archive_check/walk_old.cu

--walk: sources of B1 with this checkout's C interface (texir_culled_walk).
Each is built with the checkout's nvcc flags and run in place of the
checkout's kernel, through culled_walk_cuda, on every row that
chip_smoke.py's kernel phases check (the bake rows of phase 3, the
G-buffer and specular rows of phase 4, the building's rows of phase 7).
Its outputs must be bit-equal to the checkout's.  Each build is timed with
CUDA events over `reps` launches, in turns: this, the others, the others
reversed, this.  Prints `[walk-ab] <row>: this [ms, ms]; <file> [ms, ms]`.

--fan: sources of B2/B3 with the earlier C interface (the rows read as
they are, one thread a ray)

    int texir_fan_stream(const float* rows, int n_rows, int width,
                         const float* origins, const float* dx,
                         const float* dy, const float* dz, int t_rows,
                         int r, float t_min, int per_ray, int emit_uv,
                         float* t_out, int* prim_out, float* u_out,
                         float* v_out, void* stream)

each timed beside the checkout's fan_stream_cuda (with the scene's packed
records, as the main path calls it) on chip_smoke.py's four [fan-kernels]
rows (phase 4: the FanScene-only bake rows, one view's G-buffer and its
specular rays in both uv modes), with CUDA events over `reps` launches in
turns as above.  Every output must be bit-equal to the checkout's.  Prints
`[fan-ab] <row>: this [ms, ms]; <file> [ms, ms]`.  --fan-same: sources
with the checkout's C interface, run in place of its kernel through
fan_stream_cuda, likewise.

--scatter: sources of kernel S with the earlier C interface

    int texir_scatter_acc(const int* idx, const float* g, long long n,
                          int c, long long s, int sorted, float* out,
                          void* stream)

(int32 taps; out zero-filled by the caller), run as its wrapper ran it:
the taps cast to int32, the output from torch.zeros, then the launch.
Each is timed beside the checkout's scatter_accumulate_cuda, in both
modes (sorted on taps sorted beforehand), on sampler_bwd_variants.py's
script rows and chip_smoke.py's Mat rows, with
sampler_bwd_variants.time_ms (CUDA events after a pre-roll of the stream,
the median over `reps` fresh inputs), in turns as above.  Every result
must lie within the order bound of the plain version.  Prints
`[scatter-ab] <row> <mode>: this [ms, ms]; <file> [ms, ms]`.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Dict, List

import torch

from texir_code_tpu_torch.ops import cuda_build


def build_sources(paths: List[str], tag: str) -> Dict[str, ctypes.CDLL]:
    """Each source built with the checkout's flags (one nvcc each, all at
    once) into the build directory; file name → loaded library."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for path in paths:
        with open(path, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(cuda_build.BUILD_DIR, f"lib{tag}_ab-{digest}.so")
        procs[path] = so, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for path, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {path}:\n{text}")
        libs[os.path.basename(path)] = ctypes.CDLL(so)
    return libs


def turns(names: List[str]) -> List[str]:
    """this, the others, the others reversed, this."""
    return ["this"] + names + names[::-1] + ["this"]


def walk_rows() -> list:
    """(label, culled_walk_cuda kwargs) of every row chip_smoke.py's kernel
    phases 3, 4 and 7 check, made by those phases (their checks against
    the plain walk are left out)."""
    import chip_smoke as C
    from texir_code_tpu_torch.ops.pallas_culled import (
        culled_walk_cuda,
        walk_mode,
    )

    rows = []

    def record(torch_, label, inp, plain_reps=2, name=None):
        mode = walk_mode(inp["per_ray"], inp["emit_uv"], inp["emit_prim"],
                         inp.get("seed") is not None)
        rows.append((f"{mode} ({label})", inp))
        return {}, culled_walk_cuda(**inp)

    check = C.check_walk
    C.check_walk = record
    try:
        dev = torch.device("cuda", 0)
        syn, clusters, occ = C.bench_scene(dev)
        C.phase_kernels(torch, dev, clusters, occ, syn)
        C.phase_mat_kernels(torch, dev, syn)
        C.phase_building_kernels(torch, dev, C.building_scene(torch, dev))
    finally:
        C.check_walk = check
    return rows


def fan_rows() -> list:
    """(label, fan_stream_cuda kwargs) of chip_smoke.py's four
    [fan-kernels] rows, made by its phase 4 (its checks against the plain
    stream are left out)."""
    import chip_smoke as C
    from texir_code_tpu_torch.ops.pallas_fan import fan_stream_cuda, stream_mode

    rows = []

    def record(torch_, label, fan, origins, d, t_min, emit_uv, per_ray):
        dev = d[0].device
        inp = dict(rows=fan.device_rows(dev), origins=origins, dx=d[0],
                   dy=d[1], dz=d[2], t_min=t_min, emit_uv=emit_uv,
                   per_ray=per_ray, records=fan.device_records(dev))
        rows.append((f"{stream_mode(per_ray, emit_uv)} ({label})", inp))
        return {}, fan_stream_cuda(**inp)

    check = C.check_fan
    C.check_fan = record
    try:
        dev = torch.device("cuda", 0)
        syn, clusters, _ = C.bench_scene(dev)
        C.phase_fan_kernels(torch, dev, syn, clusters)
    finally:
        C.check_fan = check
    return rows


def _earlier_fan(lib, rows, origins, dx, dy, dz, t_min, emit_uv, per_ray,
                 records):
    """One launch of a B2/B3 build with the earlier C interface."""
    del records  # that kernel reads the rows as they are
    out = [torch.empty(dx.shape, dtype=dt, device=dx.device)
           for dt in (torch.float32, torch.int32, torch.float32, torch.float32)]
    err = lib.texir_fan_stream(
        rows.data_ptr(), rows.shape[0], rows.shape[1], origins.data_ptr(),
        dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), dx.shape[0], dx.shape[1],
        float(t_min), int(per_ray), int(emit_uv),
        *(a.data_ptr() for a in out), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fan_stream launch failed: cudaError {err}")
    return tuple(out)


def fan_ab(earlier: List[str], same: List[str], reps: int) -> None:
    from chip_smoke import cuda_ms
    from texir_code_tpu_torch.ops import pallas_fan as PF

    this = PF._fan_stream_lib()
    calls = {}
    for name, lib in {"this": this,
                      **build_sources(same, "fan_stream_same")}.items():
        lib.texir_fan_stream.restype = this.texir_fan_stream.restype
        lib.texir_fan_stream.argtypes = this.texir_fan_stream.argtypes

        def call(inp, lib=lib):
            # fan_stream_cuda loads its library through this cache
            cuda_build._loaded["fan_stream"] = lib
            return PF.fan_stream_cuda(**inp)
        calls[name] = call
    for name, lib in build_sources(earlier, "fan_stream").items():
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.texir_fan_stream.restype = ctypes.c_int
        lib.texir_fan_stream.argtypes = [p, i, i, p, p, p, p, i, i, f, i, i,
                                         p, p, p, p, p]
        calls[name] = lambda inp, lib=lib: _earlier_fan(lib, **inp)
    order = turns([k for k in calls if k != "this"])
    try:
        for label, inp in fan_rows():
            out, ms = {}, {k: [] for k in calls}
            for which in order:
                out[which] = calls[which](inp)
                ms[which].append(cuda_ms(
                    torch, lambda: calls[which](inp), reps))
            differ = [k for k in calls if not all(
                torch.equal(a, b) for a, b in zip(out["this"], out[k]))]
            print(f"[fan-ab] {label}: " + "; ".join(
                f"{k} {[round(x, 4) for x in v]} ms" for k, v in ms.items())
                + f"; not bit-equal to this: {differ}", flush=True)
            if differ:
                raise SystemExit(f"[fan-ab] {label}: the kernels disagree")
    finally:
        cuda_build._loaded["fan_stream"] = this


def walk_ab(paths: List[str], reps: int) -> None:
    from chip_smoke import cuda_ms
    from texir_code_tpu_torch.ops import pallas_culled as PC

    this = PC._culled_walk_lib()
    libs = {"this": this, **build_sources(paths, "culled_walk")}
    for lib in libs.values():
        lib.texir_culled_walk.restype = this.texir_culled_walk.restype
        lib.texir_culled_walk.argtypes = this.texir_culled_walk.argtypes
    order = turns(list(libs)[1:])
    try:
        for label, inp in walk_rows():
            out, ms = {}, {k: [] for k in libs}
            for which in order:
                # culled_walk_cuda loads its library through this cache
                cuda_build._loaded["culled_walk"] = libs[which]
                out[which] = PC.culled_walk_cuda(**inp)
                ms[which].append(cuda_ms(
                    torch, lambda: PC.culled_walk_cuda(**inp), reps))
            differ = [k for k in libs if not all(
                torch.equal(a, b) for a, b in zip(out["this"], out[k]))]
            print(f"[walk-ab] {label}: " + "; ".join(
                f"{k} {[round(x, 4) for x in v]} ms" for k, v in ms.items())
                + f"; not bit-equal to this: {differ}", flush=True)
            if differ:
                raise SystemExit(f"[walk-ab] {label}: the kernels disagree")
    finally:
        cuda_build._loaded["culled_walk"] = this


def scatter_ab(paths: List[str], reps: int) -> None:
    import chip_smoke as C
    from texir_code_tpu_torch.ops.scatter_acc import scatter_accumulate_cuda
    from texir_code_tpu_torch.scripts import sampler_bwd_variants as H

    libs = build_sources(paths, "scatter_acc")
    for lib in libs.values():
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.texir_scatter_acc.restype = ctypes.c_int
        lib.texir_scatter_acc.argtypes = [p, p, ll, i, ll, i, p, p]

    def earlier(lib, idx, g, s, presorted):
        idx32 = idx.to(torch.int32).contiguous()
        out = torch.zeros((s, g.shape[1]), dtype=torch.float32,
                          device=g.device)
        err = lib.texir_scatter_acc(
            idx32.data_ptr(), g.data_ptr(), g.shape[0], g.shape[1], s,
            int(presorted), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"scatter_acc launch failed: cudaError {err}")
        return out

    calls = {"this": lambda idx, g, s, p: scatter_accumulate_cuda(
        idx, g, s, presorted=p)}
    for name, lib in libs.items():
        calls[name] = lambda idx, g, s, p, lib=lib: earlier(lib, idx, g, s, p)
    dev = torch.device("cuda", 0)
    rows = []
    for s, c in H.SHAPES:
        rows.append((f"script S={s} C={c}", s, [
            H.make_taps(H.N_TAPS, s, c, k, dev) for k in range(reps)]))
    syn, _, _ = C.bench_scene(dev)
    _, _, view = C.bench_view(torch, dev, syn)
    for label, res, c, lod in (("albedo", C.ALBEDO_RES, 3, view["lod_a"]),
                               ("roughness", C.ROUGH_RES, 1, view["lod_r"])):
        idx, s = H.view_taps(view["uv"], lod, res, c)
        rows.append((f"Mat {label} pyramid {res}^2", s, [
            (idx, torch.rand((idx.shape[0], c), generator=torch.Generator(
                ).manual_seed(1000 + k)).to(dev)) for k in range(reps)]))
    order = turns(list(libs))
    for label, s, inputs in rows:
        for presorted in (False, True):
            inp = [H.sort_taps(*x) for x in inputs] if presorted else inputs
            ref = H.scatter_accumulate_plain(*inp[0], s)
            abs_sum, bound = H.order_bound(*inp[0], s)
            ms = {k: [] for k in calls}
            worst = 0.0
            for which in order:
                fn = lambda i, g, which=which: calls[which](i, g, s, presorted)
                worst = max(worst, H.order_error(fn(*inp[0]), ref, abs_sum,
                                                 bound)[2])
                ms[which].append(H.time_ms(fn, inp))
            mode = "sorted" if presorted else "unsorted"
            print(f"[scatter-ab] {label} {mode}: " + "; ".join(
                f"{k} {[round(x, 4) for x in v]} ms" for k, v in ms.items())
                + f"; worst error / order bound {worst:.3g}", flush=True)
            if worst > 1:
                raise SystemExit(f"[scatter-ab] {label} {mode}: a kernel "
                                 f"disagrees with the plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--walk", nargs="+", default=[], metavar="CU",
                    help="sources of kernel B1 to time beside the checkout's")
    ap.add_argument("--fan", nargs="+", default=[], metavar="CU",
                    help="sources of kernels B2/B3 (the earlier C interface)")
    ap.add_argument("--fan-same", nargs="+", default=[], metavar="CU",
                    help="sources of kernels B2/B3 (the checkout's C "
                         "interface)")
    ap.add_argument("--scatter", nargs="+", default=[], metavar="CU",
                    help="sources of kernel S (the earlier C interface)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the checkout's root
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.walk:
        walk_ab(args.walk, args.reps)
    if args.fan or args.fan_same:
        fan_ab(args.fan, args.fan_same, args.reps)
    if args.scatter:
        scatter_ab(args.scatter, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
