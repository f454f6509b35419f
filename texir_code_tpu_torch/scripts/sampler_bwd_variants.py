"""Sampler-backward harness: the scatter-accumulate variants at the JAX
harnesses' shapes and at the Mat step's, then the stage-2 step with the
sampler's segment-sum backward off and on.

    python -m texir_code_tpu_torch.scripts.sampler_bwd_variants \\
        [--device cuda] [--taps 786432] [--reps 5] [--steps 8]

The port's counterpart of the JAX package's scripts/sampler_bwd_variants.py
(the Mat-step A/B, :195-210), sampler_bwd_variants2.py (Pallas kernel S1)
and sampler_bwd_variants3.py (kernel S2).  Each computes out[S, C] = the sum
of g[n] over the taps with idx[n] = s, for N taps made from a seeded
torch.Generator as the scripts' `mk` makes them: idx = clip(floor(u^1.2 ·
S), 0, S-1) with u uniform, g uniform.  Variants:

  scatter      `index_put_(..., accumulate=True)` (autograd's gather backward)
  index_add    `index_add_`, the one-call library version
  scatter_seg  sort, then `index_add_`
  acc          kernel S in mode "unsorted" (ops.scatter_acc)
  acc_sorted   kernel S in mode "sorted" on taps sorted beforehand; the
               sort (`torch.sort` + the gather of g) is timed apart

Rows: N = 786,432 taps (8 × 98,304 pixels) at (S, C) in SHAPES, then the
Mat step's two flat pyramids (albedo 2048² × 3: 5,592,405 rows; roughness
4096² × 1: 22,369,621 rows) with the 8 exact-trilinear taps of each of
one view's 98,304 pixels (`view_taps`; standalone, the view's uv and LOD
are uniform, uv in [0, 1)² and LOD in [0, 6), as the JAX harness's
`mk_uv`).  Each row prints its median ms over `reps` calls on fresh inputs
— CUDA-event time on the card (the stream held by a spin kernel while
the call is enqueued, see `time_ms`), host time on the CPU (not a device
time) —
the error against `scatter_accumulate_plain` as a share of the row's
Σ|g| and of `order_bound` (what a different order of the additions can
explain), and bound_ms: the bytes the function must move (idx and g read
once, the output written once) over the H100's 3.35 TB/s.

The run ends with the stage-2 step rate of bench.py's Mat workload
(`mat_step_rates`: the apartment, pano 256×512, sample_light [32, 16],
albedo 2048², roughness 4096², the stochastic sampling knobs and the
occluders) with ops.texture.SEGSUM_BACKWARD off and on.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from texir_code_tpu_torch.ops import texture
from texir_code_tpu_torch.ops.scatter_acc import (
    scatter_accumulate,
    scatter_accumulate_plain,
)

N_TAPS = 786_432  # 8 taps × 98,304 pixels
# (S, C) of sampler_bwd_variants2.py:47 and sampler_bwd_variants3.py:105
SHAPES = ((16384, 3), (65536, 3), (65536, 1), (262144, 3), (22528, 3))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
VIEW_PIXELS = 6 * 128 * 128  # one view's six 128² faces (pano 256×512)
VARIANTS = ("scatter", "index_add", "scatter_seg", "acc", "acc_sorted")


def make_taps(n: int, s: int, c: int, seed: int, device) -> tuple:
    """(idx [n] int64, g [n, c] float32) on `device`, as the JAX scripts'
    `mk`: idx = clip(floor(u^1.2 · s), 0, s - 1), g uniform in [0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    idx = torch.clamp((u ** 1.2 * s).floor().to(torch.int64), 0, s - 1)
    g = torch.rand((n, c), generator=gen)
    return idx.to(device), g.to(device)


def bound_ms(n: int, s: int, c: int) -> float:
    """Least time for the function on the card: N·(4 + 4C) bytes read (int32
    taps, float32 rows) and S·C·4 written, over the HBM rate."""
    return (n * (4 + 4 * c) + s * c * 4) / PEAK_BYTES_PER_S * 1e3


def sort_taps(idx: torch.Tensor, g: torch.Tensor) -> tuple:
    """Taps sorted by row (stable, as int32), with their rows: take_segsum's
    sort."""
    idx_s, order = torch.sort(idx.to(torch.int32), stable=True)
    return idx_s, g[order]


def run_variant(name: str, idx: torch.Tensor, g: torch.Tensor,
                s: int) -> torch.Tensor:
    """One call of variant `name`; acc_sorted expects sorted taps."""
    c = g.shape[1]
    if name == "scatter":
        out = torch.zeros((s, c), device=g.device)
        return out.index_put_((idx,), g, accumulate=True)
    if name == "index_add":
        return torch.zeros((s, c), device=g.device).index_add_(0, idx, g)
    if name == "scatter_seg":
        idx_s, g_s = sort_taps(idx, g)
        return torch.zeros((s, c), device=g.device).index_add_(0, idx_s, g_s)
    if name == "acc":
        return scatter_accumulate(idx, g, s)
    if name == "acc_sorted":
        return scatter_accumulate(idx, g, s, presorted=True)
    raise ValueError(f"unknown variant {name!r}")


PREROLL_CYCLES = 2_000_000  # ~1 ms of the card's clock


def time_ms(fn, inputs: Sequence[tuple]) -> float:
    """Median ms of fn(*inp) over the inputs, after one warm-up call:
    CUDA-event time on the card, host time (perf_counter) on the CPU.  On
    the card a spin kernel (torch.cuda._sleep) holds the stream while the
    host enqueues the call, so the events time the call's kernels back to
    back and not the host's Python between them (a call of tens of µs on
    the card takes about as long to enqueue)."""
    cuda = inputs[0][0].device.type == "cuda"
    fn(*inputs[0])
    times = []
    for inp in inputs:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(PREROLL_CYCLES)
            start.record()
            fn(*inp)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*inp)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def order_bound(idx: torch.Tensor, g: torch.Tensor, s: int) -> tuple:
    """(Σ|g| of each output element's taps, the most two float32 sums of
    those taps in different orders can differ by: 2·γ(k-1)·Σ|g|, with
    γ(n) = n·u / (1 - n·u), u = 2^-24 and k the element's taps — the
    forward error bound of recursive summation, which holds for any
    order and any tree of the additions, atomics included).  [S, C]
    float64 each; an element of one tap must match exactly."""
    abs_sum = scatter_accumulate_plain(idx, g.abs().double(), s)
    k = scatter_accumulate_plain(
        idx, torch.ones((idx.shape[0], 1), dtype=torch.float64,
                        device=g.device), s)
    nu = (k - 1).clamp_min(0) * 2.0 ** -24
    return abs_sum, 2 * nu / (1 - nu) * abs_sum


def order_error(out: torch.Tensor, ref: torch.Tensor, abs_sum: torch.Tensor,
                bound: torch.Tensor) -> tuple:
    """(max |out - ref|, its largest share of an element's Σ|g|, its
    largest share of the element's order bound): a difference that the
    order of the additions explains stays within the bound (share <= 1)."""
    diff = (out.double() - ref.double()).abs()
    share = diff / abs_sum.clamp_min(1e-300)
    over = torch.where(diff > 0, diff / bound.clamp_min(1e-300),
                       torch.zeros_like(diff))
    return float(diff.max()), float(share.max()), float(over.max())


def measure_row(label: str, idx: torch.Tensor, g: torch.Tensor, s: int,
                reps: int, fresh) -> Dict:
    """Every variant on (idx, g) against scatter_accumulate_plain (and
    against one `index_add_` call), timed over `reps` fresh inputs from
    fresh(k) -> (idx, g).  Returns the row: per variant ms and errors;
    plain, sort and bound ms."""
    n, c = g.shape
    ref = scatter_accumulate_plain(idx, g, s)
    abs_sum, bound = order_bound(idx, g, s)
    sorted_inp = sort_taps(idx, g)
    inputs = [fresh(k) for k in range(reps)]
    sorted_inputs = [sort_taps(*inp) for inp in inputs]
    row = dict(label=label, taps=n, rows=s, channels=c,
               bound_ms=bound_ms(n, s, c))
    row["plain_ms"] = time_ms(
        lambda i, gg: scatter_accumulate_plain(i, gg, s), inputs)
    row["sort_ms"] = time_ms(sort_taps, inputs)
    lib = run_variant("index_add", idx, g, s)
    for name in VARIANTS:
        inp, args = ((sorted_inputs, sorted_inp) if name == "acc_sorted"
                     else (inputs, (idx, g)))
        out = run_variant(name, *args, s)
        err, share, over = order_error(out, ref, abs_sum, bound)
        _, share_lib, over_lib = order_error(out, lib, abs_sum, bound)
        row[name] = dict(
            ms=time_ms(lambda i, gg, name=name: run_variant(name, i, gg, s),
                       inp),
            max_abs_err=err, err_over_abs_sum=share,
            err_over_bound=over, err_over_abs_sum_vs_index_add=share_lib,
            err_over_bound_vs_index_add=over_lib)
    return row


def print_row(row: Dict, device) -> None:
    unit = "ms" if torch.device(device).type == "cuda" else "host ms"
    print(f"--- {row['label']}: S={row['rows']} C={row['channels']} "
          f"N={row['taps']}; bound_ms {row['bound_ms']:.4f}; plain "
          f"{row['plain_ms']:.4f} {unit}; sort {row['sort_ms']:.4f} {unit}",
          flush=True)
    for name in VARIANTS:
        v = row[name]
        print(f"{name}: {v['ms']:.4f} {unit} (max abs err {v['max_abs_err']:.3g}, "
              f"{v['err_over_abs_sum']:.3g} of the row's sum |g|, "
              f"{v['err_over_bound']:.3g} of the order bound)", flush=True)


def script_rows(device, taps: int = N_TAPS, reps: int = 5,
                shapes=SHAPES) -> list:
    """The JAX harnesses' rows: `taps` taps at each (S, C)."""
    rows = []
    for s, c in shapes:
        idx, g = make_taps(taps, s, c, 0, device)
        rows.append(measure_row(
            f"script S={s} C={c}", idx, g, s, reps,
            lambda k, s=s, c=c: make_taps(taps, s, c, 1 + k, device)))
    return rows


def view_taps(uv: torch.Tensor, lod: torch.Tensor, res: int, channels: int,
              max_mip_level: int = 13) -> tuple:
    """(taps, rows): the flat-pyramid rows that one exact trilinear
    texture_sample of a res² atlas reads at uv [B, 2] and lod [B] (8 a
    pixel: 4 corners on each of two levels, in the sampler's order), and
    the row count of the pyramid.  The taps are read off the sampler's own
    fetch (ops.texture._take_rows)."""
    pyr = texture.build_mip_pyramid(
        torch.zeros((res, res, channels), device=uv.device), max_mip_level)
    taps = []
    take = texture._take_rows

    def record(flat, idx):
        taps.append(idx)
        return take(flat, idx)

    texture._take_rows = record
    try:
        texture.texture_sample(pyr, uv, lod)
    finally:
        texture._take_rows = take
    return torch.cat(taps), sum(p.shape[0] * p.shape[1] for p in pyr)


def uniform_view(device, pixels: int = VIEW_PIXELS, seed: int = 100):
    """(uv [B, 2], lod [B]) of a stand-in view: uv uniform in [0, 1)², LOD
    uniform in [0, 6) (the JAX harness's mk_uv)."""
    gen = torch.Generator().manual_seed(seed)
    uv = torch.rand((pixels, 2), generator=gen)
    lod = torch.rand(pixels, generator=gen) * 6.0
    return uv.to(device), lod.to(device)


def mat_rows(uv: torch.Tensor, lod_a: torch.Tensor, lod_r: torch.Tensor,
             reps: int = 5, albedo_res: int = 2048,
             rough_res: int = 4096) -> list:
    """The Mat step's rows: the albedo (C = 3) and roughness (C = 1)
    pyramids' rows, the exact-trilinear taps of one view, g uniform."""
    rows = []
    for label, res, c, lod in (("albedo", albedo_res, 3, lod_a),
                               ("roughness", rough_res, 1, lod_r)):
        idx, s = view_taps(uv, lod, res, c)
        n = idx.shape[0]

        def fresh(k, n=n, c=c):
            gen = torch.Generator().manual_seed(1000 + k)
            return idx, torch.rand((n, c), generator=gen).to(idx.device)

        rows.append(measure_row(f"Mat {label} pyramid {res}^2", idx,
                                fresh(-1)[1], s, reps, fresh))
    return rows


def mat_step_rates(syn, steps: int, device="cuda", pano=(256, 512),
                   albedo_res: int = 2048, rough_res: int = 4096,
                   sample_light=(32, 16), render_knobs=None) -> Dict:
    """bench.py's stage-2 step (bench.py:142-240: one view of `syn`, IrT a
    stand-in max(hdr atlas, 0.1), gt 0.2, one seg class, Adam 3e-2 and the
    clamp) with SEGSUM_BACKWARD off, then on: {"off"/"on": it/s, ...}.
    The rate is host time over `steps` steps after one warm-up step, the
    last step ending in a copy of its loss to the host."""
    from texir_code_tpu_torch.models.losses import render_loss
    from texir_code_tpu_torch.models.material import (
        MaterialModel,
        clamp_material_params,
        init_material_params,
    )
    from texir_code_tpu_torch.ops.gbuffer import cube_mvp

    if render_knobs is None:
        render_knobs = dict(mip_stochastic=True, bilinear_stochastic=True,
                            use_occluders=True)
    irt = np.maximum(syn.hdr_texture, 0.1)
    model = MaterialModel(syn.mesh, syn.hdr_texture, irt, pano_res=pano,
                          sample_light=sample_light,
                          render_knobs=render_knobs, device=device)
    pos = syn.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = cube_mvp(ext)
    res = model.cube_res
    dev = model.device
    gt = torch.full((6, res, res, 3), 0.2, device=dev)
    seg_id = torch.zeros((6, res, res), dtype=torch.int64, device=dev)
    ones = torch.ones((6, res, res, 1), device=dev)
    rates = {}
    for on in (False, True):
        params = init_material_params(albedo_res, rough_res, device=dev)
        for p in (params.albedo, params.roughness):
            p.requires_grad_(True)
        opt = torch.optim.Adam([params.albedo, params.roughness], lr=3e-2)
        view = model.precompute_view(params, mvp, pos)

        def step(it):
            opt.zero_grad(set_to_none=True)
            out = model._forward(params, mvp, pos, 2, seed=it, view=view)
            loss, _ = render_loss(gt, out, ones, seg_id, 49, 2,
                                  seg_region=ones)
            loss.backward()
            opt.step()
            with torch.no_grad():
                c = clamp_material_params(params)
                params.albedo.copy_(c.albedo)
                params.roughness.copy_(c.roughness)
            return loss

        texture.SEGSUM_BACKWARD = on
        try:
            step(0).item()
            t0 = time.perf_counter()
            for it in range(1, steps + 1):
                loss = step(it)
            last = loss.item()
            dt = time.perf_counter() - t0
        finally:
            texture.SEGSUM_BACKWARD = False
        key = "on" if on else "off"
        rates[key] = steps / dt
        rates[f"loss_{key}"] = last
    return rates


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m texir_code_tpu_torch.scripts.sampler_bwd_variants")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--taps", type=int, default=N_TAPS,
                    help="taps of the script rows")
    ap.add_argument("--reps", type=int, default=5,
                    help="fresh inputs timed per variant (median)")
    ap.add_argument("--pixels", type=int, default=VIEW_PIXELS,
                    help="pixels of the Mat rows' view (8 taps each)")
    ap.add_argument("--albedo_res", type=int, default=2048)
    ap.add_argument("--roughness_res", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8,
                    help="timed stage-2 steps per setting; 0 skips the A/B")
    args = ap.parse_args(argv)
    from texir_code_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    else:
        print("device: cpu (host times, not device times)", flush=True)
    for row in script_rows(dev, args.taps, args.reps):
        print_row(row, dev)
    uv, lod = uniform_view(dev, args.pixels)
    for row in mat_rows(uv, lod, lod, args.reps, args.albedo_res,
                        args.roughness_res):
        print_row(row, dev)
    if args.steps:
        from texir_code_tpu_torch.data.synthetic import make_apartment_scene

        rates = mat_step_rates(make_apartment_scene(atlas_res=256, subdiv=24),
                               args.steps, dev)
        print(f"mat step scatter-add: {rates['off']:.3f} iters/s", flush=True)
        print(f"mat step segment-sum: {rates['on']:.3f} iters/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
