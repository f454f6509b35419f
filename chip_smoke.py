#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (texir_code_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

It drives the port's main path on the bench apartment
(make_apartment_scene(atlas_res=256, subdiv=24)): export the scan, bake
its IrrT, train its materials.  Phases (any failure exits non-zero;
nothing is caught):
  1. device: torch's view of the card, and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port from csrc/, one nvcc each, all
     started together;
  3. kernels: each kernel mode against its plain PyTorch version on the
     card at the shapes the main path gives it, with times and the work
     bound — the bake's wedge rows (1024 texels × 2048 spp, lb 4), and the
     Mat step's G-buffer of one view (98,304 pixel rays, lb 8) and that
     view's 1,572,864 specular rays (per-ray origins, importance
     directions at roughness 0.1, lb 8), all with occluders;
  4. export: the apartment written to the reference's dataset layout by
     the port's exporter (4 views, pano 256×512);
  5. slice: `train --trainstage IrrT` through the port's CLI on the
     exported mesh at --irt_res 1024 and 2048 spp (it writes the irt.hdr
     the Mat stage reads);
  6. mat: `train --trainstage Mat --max_epochs 1` through the port's CLI
     with the bench atlases (albedo 2048², roughness 4096²) and
     sample_light [32, 16]: seconds per step of each substage, stage
     seconds with set-up, launches per kernel mode;
  7. profile: one full bake batch under torch.profiler;
  8. mat-profile: one cached-view stage-2 step (forward, backward, Adam,
     clamp) under torch.profiler, with the sampler backward's scatter
     named apart;
  9. reference: the card's bake_batch against the CPU's;
 10. mat-reference: one stage-2 step on the card against the CPU at pano
     64×128 with full atlases and the same injected sample shifts.
Kernel launch counts are zeroed just before each main-path phase (5, 6)
and read just after; every kernel mode of that phase must have run.
Then a `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of one ray-triangle test in plane-dual form, with the
# per-row terms (n·o, s·o) amortized: three 3-dots with d (15), 1/(n·d),
# t (2), u and v (4), and the five accept tests with their selects (~8)
FLOPS_PER_TEST = 30
IRT_RES = 1024
SPP = 2048
WEDGES = 4
FAN_BLOCK = 32
EXIT_ROWS = 16
LB = 4
TOL = 1e-5  # t/u/v: the plain and CUDA walks round alike (no FMA, IEEE 1/x)
# the Mat step (bench.py's workload)
PANO = (256, 512)
VIEWS = 4
SPEC_SPP = 16
MAT_LB = 8
ALBEDO_RES, ROUGH_RES = 2048, 4096
KERNEL_SOURCE = "texir_code_tpu_torch/csrc/culled_walk.cu"
KERNEL_REPLACES = "texir_code_tpu/ops/pallas_culled.py:367"


def log(msg=""):
    print(msg, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{name} x{count}")
    log(smi)
    return name, count, smi


def phase_build():
    from texir_code_tpu_torch.ops import cuda_build

    t0 = time.time()
    cuda_build.build(["culled_walk"])
    dt = time.time() - t0
    log(f"[build] culled_walk built in {dt:.1f} s")
    for line in cuda_build.build_log("culled_walk").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def bench_scene(dev):
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.geometry.occluders import extract_occluders
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

    syn = make_apartment_scene(atlas_res=256, subdiv=24)
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    clusters = ClusterScene.from_fan(fan, lb=LB, dense=True, device=dev)
    occ = extract_occluders(syn.mesh, device=dev)
    return syn, clusters, occ


def bake_texels(syn, n, res=1024):
    """n Morton-consecutive valid texels (one bake batch's worth) from the
    middle of the atlas: points, normals [n, 3] and their global ids."""
    from texir_code_tpu_torch.models.tracer_irt import (
        bake_geometry_textures,
        morton_order,
    )

    geom = bake_geometry_textures(syn.mesh, res)
    vr, vc = np.nonzero(geom.valid)
    order = morton_order(geom.position[vr, vc])
    sel = order[len(order) // 2 : len(order) // 2 + n]
    return geom.position[vr[sel], vc[sel]], geom.normal[vr[sel], vc[sel]], sel


def walk_inputs(torch, clusters, occ, pts, nrm, ids, seed, dev):
    """The culled walk's inputs exactly as the bake builds them."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        cull_blocks,
        sort_dirs_octant,
        tile_rows,
        wedge_rows,
    )
    from texir_code_tpu_torch.ops.sampling import generate_dir_soa

    p = torch.from_numpy(pts).to(dev)
    n = torch.from_numpy(nrm).to(dev)
    nrm_s = tuple(n[:, k] for k in range(3))
    dirs = generate_dir_soa(
        nrm_s, SPP, mode="uniform", row_ids=torch.from_numpy(ids).to(dev),
        seed=seed,
    )
    ds = sort_dirs_octant(dirs)
    rows_d = tuple(wedge_rows(a, WEDGES).contiguous() for a in ds)
    rows_o = tuple(
        tile_rows(p[:, k] + 1e-2 * n[:, k], WEDGES) for k in range(3)
    )
    cand, count, dist = cull_blocks(
        clusters, rows_o, rows_o, rows_d, EXIT_ROWS, occluders=occ
    )
    g = count.numel()
    c = clusters.num_clusters
    t_cap = float(np.float32(1.05) * np.float32(clusters.diameter))
    return dict(
        count=count.reshape(g).contiguous(),
        cand=cand.reshape(g, c).contiguous(),
        dist=dist.reshape(g, c).contiguous(),
        t_cap=t_cap,
        origins=torch.stack(rows_o, dim=-1).contiguous(),
        dx=rows_d[0], dy=rows_d[1], dz=rows_d[2],
        rows3=clusters.rows3, prims3=clusters.prims3, er=EXIT_ROWS,
    )


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_hits(a, b, emit_prim):
    """(max |Δ| over t/u/v on rays hit in both, tie count, t-mismatch
    count, prim mismatches).  A tie is a ray whose t agrees but whose
    triangle (or uv) differs: two triangles at the same t."""
    ta, pa, ua, va = (x.cpu().numpy() for x in a)
    tb, pb, ub, vb = (x.cpu().numpy() for x in b)
    both = np.isfinite(ta) & np.isfinite(tb)
    t_bad = (np.isfinite(ta) != np.isfinite(tb)) | (
        both & (np.abs(np.where(both, ta - tb, 0.0)) > TOL)
    )
    duv = np.maximum(np.abs(ua - ub), np.abs(va - vb))
    prim_diff = (pa != pb) if emit_prim else np.zeros_like(t_bad)
    tie = ~t_bad & ((duv > TOL) | prim_diff)
    err = max(
        float(np.abs(np.where(both, ta - tb, 0.0)).max()),
        float(duv.max()),
    )
    return err, int(tie.sum()), int(t_bad.sum()), int(prim_diff.sum())


def check_walk(torch, label, inp):
    """culled_walk_cuda against culled_walk_plain on the same inputs: the
    agreement rule of the bake phase (t within TOL, no t mismatch, ties at
    most 1e-4 of the rays), CUDA-event times, and the bound.  Returns the
    kernel's row of the JSON line (launches filled in later)."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        culled_walk_cuda,
        culled_walk_plain,
        walk_mode,
    )

    rays = inp["dx"].numel()
    lb = inp["rows3"].shape[1]
    mode = walk_mode(inp["per_ray"], inp["emit_uv"], inp["emit_prim"])
    hk = culled_walk_cuda(**inp)
    torch.cuda.synchronize()
    hp = culled_walk_plain(**inp)
    err, ties, t_bad, prim_bad = compare_hits(hk, hp, inp["emit_prim"])
    kernel_ms = cuda_ms(torch, lambda: culled_walk_cuda(**inp), 20)
    plain_ms = cuda_ms(torch, lambda: culled_walk_plain(**inp), 2)
    # work this run's data needs: every ray must test each candidate whose
    # bound is below its final t (capped), lb*4 triangles each
    t_fin = torch.clamp_max(hp[0], inp["t_cap"])
    g = inp["count"].numel()
    need = torch.searchsorted(inp["dist"], t_fin.reshape(g, -1).contiguous())
    need = torch.minimum(need, inp["count"][:, None].long())
    visits = int(need.sum())
    tests = visits * lb * 4
    ops_ms = tests * FLOPS_PER_TEST / PEAK_FP32_FLOPS * 1e3
    nbytes = sum(
        inp[k].numel() * inp[k].element_size()
        for k in ("count", "cand", "dist", "origins", "dx", "dy", "dz",
                  "rows3")
    ) + (inp["prims3"].numel() * 4 if inp["emit_prim"] else 0) + rays * 16
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[kernels] culled_walk {mode} ({label}, lb {lb}): {rays} rays, "
        f"{visits} cluster visits needed ({visits / rays:.2f}/ray, "
        f"{tests} triangle tests)")
    log(f"[kernels]   max|dt|,|du|,|dv| = {err:.3g}; t mismatches "
        f"{t_bad}; prim mismatches {prim_bad}; ties {ties}; hit "
        f"{float(torch.isfinite(hk[0]).float().mean()):.4f}")
    log(f"[kernels]   kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.2f}  "
        f"bound_ms {bound_ms:.4f} (ops {ops_ms:.4f}, bytes "
        f"{bytes_ms:.4f}); library_ms null: no single PyTorch call "
        f"computes this walk")
    if t_bad or ties > 1e-4 * rays:
        raise SystemExit(
            f"culled_walk {mode} disagrees with its plain version: "
            f"{t_bad} t mismatches, {ties} ties"
        )
    return dict(
        name=f"culled_walk[{mode}]", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, max_abs_err=err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None,
    )


def phase_kernels(torch, dev, clusters, occ, syn):
    """The bake's shape (a), in its emit_uv mode (the bake's) and its
    emit_prim mode."""
    pts, nrm, ids = bake_texels(syn, 1024)
    inp = walk_inputs(torch, clusters, occ, pts, nrm, ids, 777, dev)
    rows = {}
    for emit_uv, emit_prim in ((True, False), (False, True)):
        row = check_walk(torch, "bake rows", dict(
            inp, emit_uv=emit_uv, emit_prim=emit_prim, per_ray=False))
        if emit_uv:  # the bake's mode is the one the JSON line reports
            rows["shared_uv"] = row
    return rows


def bench_camera(syn):
    """Camera 0 of the exported dataset: extrinsic, position, cube MVPs."""
    from texir_code_tpu_torch.ops.gbuffer import cube_mvp

    pos = syn.camera_positions(VIEWS)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    return pos, cube_mvp(ext)


def phase_mat_kernels(torch, dev, syn):
    """The Mat step's shapes (b) and (c) of one bench view at lb 8, with
    the walk inputs built exactly as render_gbuffer and query_tbl_stream
    build them."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.geometry.occluders import extract_occluders
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.gbuffer import (
        DeviceMesh,
        interpolate_attributes,
        ray_dirs_from_mvp,
    )
    from texir_code_tpu_torch.ops.pallas_culled import (
        ClusterScene,
        cull_blocks,
        culled_walk_cuda,
    )
    from texir_code_tpu_torch.ops.raycast import RayHit
    from texir_code_tpu_torch.ops.sampling import (
        TINY_NUMBER,
        generate_dir_soa,
        hammersley,
        hash_uniform,
        reflect_soa,
    )

    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    cs = ClusterScene.from_fan(fan, lb=MAT_LB, dense=True, device=dev)
    occ = extract_occluders(syn.mesh, device=dev)
    t_cap = float(np.float32(1.05) * np.float32(cs.diameter))
    pos, mvp = bench_camera(syn)
    cam = torch.as_tensor(pos, device=dev)
    res = PANO[1] // 4
    flat = ray_dirs_from_mvp(mvp.to(dev), res).reshape(-1, 3)
    n = flat.shape[0]
    rows = n // 2048
    d = tuple(flat[:, k].reshape(rows, 2048).contiguous() for k in range(3))
    o = tuple(cam[k].expand(rows).contiguous() for k in range(3))
    er = 8  # fan_block 8, exit_rows 0: one group per 8-row block
    cand, count, dist = cull_blocks(cs, o, o, d, er, occluders=occ)
    g = count.numel()
    base = dict(count=count.reshape(g).contiguous(),
                cand=cand.reshape(g, -1).contiguous(),
                dist=dist.reshape(g, -1).contiguous(), t_cap=t_cap,
                rows3=cs.rows3, prims3=cs.prims3)
    gbuf = dict(base, origins=torch.stack(o, -1).contiguous(), dx=d[0],
                dy=d[1], dz=d[2], er=er, t_min=1e-6, emit_uv=False,
                emit_prim=True, per_ray=False)
    out = {"shared_prim": check_walk(torch, "G-buffer of one view", gbuf)}

    # that view's specular rays: importance half-vectors at roughness 0.1
    t, prim, u, v = culled_walk_cuda(**gbuf)
    dm = DeviceMesh.from_mesh(syn.mesh, dev)
    hit = RayHit(*(a.reshape(-1) for a in (t, prim, u, v)))
    position, normal, _ = interpolate_attributes(dm, hit)
    pts = position + 1e-2 * normal
    view = cam[None] - pts
    view = view / view.norm(dim=-1, keepdim=True).clamp_min(1e-4)
    shift = hash_uniform(5, torch.arange(n, device=dev),
                         torch.arange(2, device=dev))
    samples = torch.clamp(
        torch.remainder(hammersley(SPEC_SPP, dev)[None] + shift[:, None], 1.0),
        TINY_NUMBER, 1.0 - TINY_NUMBER)
    nrm = tuple(normal[:, k] for k in range(3))
    half = generate_dir_soa(nrm, SPEC_SPP, mode="importance",
                            roughness=torch.full((n,), 0.1, device=dev),
                            samples=samples)
    light, _ = reflect_soa(tuple(view[:, k] for k in range(3)), half)
    r = 1024
    srows = n * SPEC_SPP // r
    so = tuple(pts[:, k:k + 1].expand(n, SPEC_SPP).reshape(srows, r)
               for k in range(3))
    sd = tuple(a.reshape(srows, r).contiguous() for a in light)
    cand, count, dist = cull_blocks(
        cs, tuple(a.amin(1) for a in so), tuple(a.amax(1) for a in so), sd, 1,
        occluders=occ)
    spec = dict(count=count.reshape(-1).contiguous(),
                cand=cand.reshape(srows, -1).contiguous(),
                dist=dist.reshape(srows, -1).contiguous(), t_cap=t_cap,
                rows3=cs.rows3, prims3=cs.prims3,
                origins=torch.stack(so, 0).contiguous(), dx=sd[0], dy=sd[1],
                dz=sd[2], er=1, t_min=0.0, emit_uv=True, emit_prim=False,
                per_ray=True)
    out["per_ray_uv"] = check_walk(torch, "specular rays of one view", spec)
    return out


def phase_export(torch, syn, tmp):
    """The bench apartment in the reference layout (4 views, pano
    256×512), written by the port's exporter on the card."""
    from texir_code_tpu_torch.data.export import export_reference_layout

    torch.cuda.synchronize()
    t0 = time.time()
    path_mesh = export_reference_layout(
        syn, os.path.join(tmp, "apartment"), n_views=VIEWS, pano_res=PANO,
        device="cuda")
    log(f"[export] {VIEWS} views at pano {PANO[0]}x{PANO[1]} in "
        f"{time.time() - t0:.2f} s: {path_mesh}")
    return path_mesh


def phase_slice(torch, syn, path_mesh, irt_res, tmp):
    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "irt_synthetic.conf")
    argv = [
        "train", "--conf", conf, "--trainstage", "IrrT",
        "--irt_res", str(irt_res), "--exps_folder", os.path.join(tmp, "exps"),
        "--set", f"train.path_mesh_open3d={path_mesh}",
        "--set", f"train.sample_light=[{SPP}, 16]",
    ]
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "irt.hdr"), flip=True)
    raw = hdrio.read_hdr(path_mesh.replace("out1.obj", "0_irr_texture.hdr"),
                         flip=True)
    from texir_code_tpu_torch.models.tracer_irt import bake_geometry_textures

    valid = bake_geometry_textures(syn.mesh, irt_res).valid
    texels = int(valid.sum())
    rays = texels * SPP
    n = launches.get("shared_uv", 0)
    log(f"[slice] IrrT via cli: {texels} texels x {SPP} spp = {rays} rays "
        f"in {dt:.2f} s (stage total, set-up included) = "
        f"{rays / dt / 1e6:.2f} Mrays/s")
    log(f"[slice] culled_walk launches: {launches} "
        f"({n / -(-texels // 4096):.2f} per 4096-texel batch)")
    log(f"[slice] irt.hdr {irt.shape} finite={np.isfinite(irt).all()} "
        f"mean={irt.mean():.5f}; raw mean over valid texels "
        f"{raw[valid].mean():.5f}")
    if n <= 0:
        raise SystemExit("culled_walk never launched on the bake path")
    if irt.shape != (irt_res, irt_res, 3) or not np.isfinite(irt).all():
        raise SystemExit("irt.hdr has the wrong shape or non-finite values")
    if not raw[valid].mean() > 0:
        raise SystemExit("the bake is black")
    return n


def _mat_conf(path_mesh, pano):
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "mat_synthetic.conf")
    return conf, [
        "--set", f"train.path_mesh_open3d={path_mesh}",
        "--set", f"train.pano_img_res=[{pano[0]}, {pano[1]}]",
        "--set", f"train.sample_light=[32, {SPEC_SPP}]",
        "--set", f"train.mat_albedo_res={ALBEDO_RES}",
        "--set", f"train.mat_roughness_res={ROUGH_RES}",
    ]


def phase_mat(torch, path_mesh, tmp):
    """`train --trainstage Mat --max_epochs 1` through the port's CLI."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    conf, sets = _mat_conf(path_mesh, PANO)
    exps = os.path.join(tmp, "exps")
    argv = ["train", "--conf", conf, "--trainstage", "Mat", "--max_epochs",
            "1", "--exps_folder", exps] + sets
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    (tpath,) = glob.glob(os.path.join(exps, "Mat-default", "*", "timings.json"))
    with open(tpath) as f:
        tm = json.load(f)
    plots = os.path.join(os.path.dirname(tpath), "plots")
    albedo = hdrio.read_hdr(os.path.join(plots, "mat_albedo_final.hdr"))
    rough = hdrio.read_hdr(os.path.join(plots, "mat_roughness_final.hdr"))
    steps = sum(tm[f"substage{k}"]["steps"] for k in range(3))
    log(f"[mat] Mat via cli: {VIEWS} views, pano {PANO[0]}x{PANO[1]}, "
        f"albedo {ALBEDO_RES}^2, roughness {ROUGH_RES}^2, sample_light "
        f"[32, {SPEC_SPP}]: stage {dt:.2f} s with set-up")
    log(f"[mat]   set-up {tm['setup_s']:.2f} s; dataset {tm['dataset_items']} "
        f"items in {tm['dataset_s']:.2f} s; masks {tm['masks_s']:.2f} s; "
        f"save {tm['save_s']:.2f} s; re-render {tm['render_calculate_s']:.2f} s")
    for k in range(3):
        sub = tm[f"substage{k}"]
        rest = (sub["step_s"] - sub["first_step_s"]) / max(1, sub["steps"] - 1)
        log(f"[mat]   substage {k}: {sub['steps']} steps in "
            f"{sub['step_s']:.3f} s = {sub['step_s'] / sub['steps']:.4f} s/step "
            f"({sub['it_per_s']:.3f} it/s; first step {sub['first_step_s']:.4f} "
            f"s, the others {rest:.4f} s/step = {1 / rest:.3f} it/s); views "
            f"prepared in {sub['views_s']:.3f} s, Adam made in "
            f"{sub['optim_s']:.3f} s; last loss {sub['last_loss']:.6f}")
    log(f"[mat]   culled_walk launches: {launches} over {steps} steps")
    m = tm["metrics"]
    log(f"[mat]   re-render mse {m['mse']:.6f} psnr {m['psnr']:.4f} ssim "
        f"{m['ssim']:.4f}; albedo mean {albedo.mean():.5f} (init 0.5), "
        f"roughness mean {rough.mean():.5f} (init 0.1)")
    for mode in ("shared_prim", "per_ray_uv"):
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"culled_walk {mode} never launched in the Mat stage")
    losses = [tm[f"substage{k}"]["last_loss"] for k in range(3)]
    if not (np.isfinite(losses).all() and np.isfinite(list(m.values())).all()
            and np.isfinite(albedo).all() and np.isfinite(rough).all()):
        raise SystemExit("the Mat stage produced non-finite values")
    if not abs(albedo.mean() - 0.5) > 1e-4:
        raise SystemExit("the Mat stage did not move the albedo")
    return launches, tm


def make_baker(torch, syn, clusters, occ, d):
    """The runner's baker configuration on device `d`."""
    import dataclasses

    from texir_code_tpu_torch.models.tbl import build_tbl
    from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker

    tbl = build_tbl(syn.mesh, syn.hdr_texture, device=d)
    cs = dataclasses.replace(
        clusters, **{k: getattr(clusters, k).to(d) for k in
                     ("rows3", "prims3", "cluster_lo", "cluster_hi")}
    )
    oc = dataclasses.replace(
        occ, p=occ.p.to(d), rect_lo=occ.rect_lo.to(d),
        rect_hi=occ.rect_hi.to(d),
    )
    baker = IrradianceTextureBaker(tbl, spp=SPP, cluster_scene=cs,
                                   wedges=WEDGES)
    baker.fan_block, baker.exit_rows, baker.occluders = (
        FAN_BLOCK, EXIT_ROWS, oc)
    return baker


def phase_profile(torch, dev, clusters, occ, syn):
    """Where one full bake batch (4096 texels x 2048 spp) spends the card's
    time: host clock around it, and kernel device time by name from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    baker = make_baker(torch, syn, clusters, occ, dev)
    pts, nrm, ids = bake_texels(syn, 4096)
    args = (torch.from_numpy(pts).to(dev), torch.from_numpy(nrm).to(dev),
            torch.from_numpy(ids).to(dev), 99)
    baker.bake_batch(*args)
    torch.cuda.synchronize()
    t0 = time.time()
    baker.bake_batch(*args)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        baker.bake_batch(*args)
        torch.cuda.synchronize()
    kern, launches = profile_kernels(prof)
    busy = sum(kern.values())
    log(f"[profile] bake_batch 4096 texels x {SPP} spp: wall {wall_ms:.2f} ms "
        f"(unprofiled); {launches} kernel launches, {busy:.2f} ms on the "
        f"card ({len(kern)} kernel names); idle share "
        + (f"{max(0.0, 1 - busy / wall_ms):.3f}" if busy else "not measured"))
    top = sorted(kern.items(), key=lambda kv: -kv[1])
    for name, ms in top[:8]:
        log(f"[profile]   {ms:9.3f} ms  {name[:90]}")
    log(f"[profile]   {sum(ms for _, ms in top[8:]):9.3f} ms  "
        f"({max(0, len(top) - 8)} other kernel names)")


def phase_reference(torch, dev, clusters, occ, syn):
    """bake_batch on the card vs the CPU (plain walk), 256 texels."""
    pts, nrm, ids = bake_texels(syn, 256)
    out = []
    for d in (dev, torch.device("cpu")):
        baker = make_baker(torch, syn, clusters, occ, d)
        e = baker.bake_batch(
            torch.from_numpy(pts).to(d), torch.from_numpy(nrm).to(d),
            torch.from_numpy(ids).to(d), 4242,
        )
        out.append(e.cpu().numpy())
    rel = np.abs(out[0] - out[1]) / np.maximum(np.abs(out[1]), 1e-3)
    log(f"[reference] bake_batch card vs cpu, 256 texels: max rel "
        f"{rel.max():.3g}, texels above 1e-4: {(rel > 1e-4).sum()}")
    # directions differ by float ulps between the card's and the CPU's
    # sin/cos, which can move a ray across a texel edge of the nearest
    # RGBE fetch: a few texels may move by one ray's share
    if (rel > 1e-4).mean() > 0.02 or rel.max() > 0.05:
        raise SystemExit("bake_batch on the card disagrees with the CPU")


def profile_kernels(prof):
    """(kernel device ms by name, kernel launches) from a profile."""
    kern, launches = {}, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        kern[e.key] = kern.get(e.key, 0.0) + us / 1e3
        launches += e.count
    return kern, launches


def phase_mat_profile(torch, path_mesh, tmp):
    """One cached-view stage-2 step (forward, backward, Adam, clamp) of the
    Mat runner on the bench view, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.train.material import (
        MatTrainRunner,
        adam_for_substage,
    )

    conf_path, sets = _mat_conf(path_mesh, PANO)
    conf = parse_file(conf_path)
    for kv in sets[1::2]:  # the values of the "--set KEY=VAL" pairs
        k, _, v = kv.partition("=")
        conf.put(k.strip(), _parse_value(v.strip()))
    runner = MatTrainRunner(conf, exps_root=os.path.join(tmp, "exps_prof"),
                            max_epochs=1)
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data([0])
    for p in (runner.params.albedo, runner.params.roughness):
        p.requires_grad_(True)
    opt, sched = adam_for_substage(runner.params, runner.lr, 20, 0.8, 1)

    def step(it):
        return runner._step(2, views[0], n_rooms, it, opt, sched)

    step(0)
    torch.cuda.synchronize()
    t0 = time.time()
    step(1)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(2)
        torch.cuda.synchronize()
    kern, launches = profile_kernels(prof)
    busy = sum(kern.values())
    scatter = {k: v for k, v in kern.items()
               if "index_put" in k or "indexing_backward" in k
               or "scatter" in k.lower()}
    walk = sum(v for k, v in kern.items() if "culled_walk" in k)
    log(f"[mat-profile] stage-2 step, 1 cached view (98,304 pixels x "
        f"{SPEC_SPP} spp): wall {wall_ms:.2f} ms (unprofiled); {launches} "
        f"kernel launches, {busy:.2f} ms on the card ({len(kern)} kernel "
        f"names); idle share "
        + (f"{max(0.0, 1 - busy / wall_ms):.3f}" if busy else "not measured"))
    log(f"[mat-profile]   culled_walk {walk:.3f} ms; sampler-backward scatter "
        f"{sum(scatter.values()):.3f} ms in {len(scatter)} kernel names")
    for name, ms in sorted(scatter.items(), key=lambda kv: -kv[1])[:3]:
        log(f"[mat-profile]     scatter {ms:9.3f} ms  {name[:80]}")
    top = sorted(kern.items(), key=lambda kv: -kv[1])
    for name, ms in top[:8]:
        log(f"[mat-profile]   {ms:9.3f} ms  {name[:90]}")
    log(f"[mat-profile]   {sum(ms for _, ms in top[8:]):9.3f} ms  "
        f"({max(0, len(top) - 8)} other kernel names)")
    return dict(wall_ms=wall_ms, busy_ms=busy, walk_ms=walk,
                scatter_ms=sum(scatter.values()), launches=launches)


def phase_mat_reference(torch, dev, syn):
    """One stage-2 step on the card against the CPU at pano 64×128 with
    the full atlases, random from a seed, and the same injected sample
    shifts: loss within rel 1e-4, gradients within relative L2 1e-3
    (atomics reorder the scatter-adds)."""
    from texir_code_tpu_torch.models.losses import render_loss
    from texir_code_tpu_torch.models.material import (
        MaterialModel,
        MaterialParams,
    )

    rng = np.random.default_rng(12)
    irt = rng.uniform(0.5, 2.0, (1024, 1024, 3)).astype(np.float32)
    albedo = rng.uniform(0.2, 0.8, (ALBEDO_RES, ALBEDO_RES, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 0.7, (ROUGH_RES, ROUGH_RES, 1)).astype(np.float32)
    pos, mvp = bench_camera(syn)
    res = 32
    b = 6 * res * res
    shift = torch.from_numpy(rng.uniform(0, 1, (b, 5)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1.5, (6, res, res, 3)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 8, (6, res, res)))
    room = torch.from_numpy(rng.integers(0, 3, (6, res, res)))
    out = {}
    for d in (dev, torch.device("cpu")):
        m = MaterialModel(
            syn.mesh, syn.hdr_texture, irt, pano_res=(64, 128),
            sample_light=(32, SPEC_SPP), device=d,
            render_knobs=dict(mip_stochastic=True, bilinear_stochastic=True,
                              use_occluders=True))
        p = MaterialParams(torch.tensor(albedo, device=d, requires_grad=True),
                           torch.tensor(rough, device=d, requires_grad=True))
        o = m._forward(p, mvp, pos, 2, spec_shift=shift)
        ones = torch.ones((6, res, res, 1), device=d)
        loss, _ = render_loss(gt.to(d), o, ones, seg.to(d), 9, 2,
                              seg_region=ones, room_id=room.to(d),
                              num_rooms=3)
        loss.backward()
        out[d.type] = (loss.item(), p.albedo.grad.cpu().numpy(),
                       p.roughness.grad.cpu().numpy())
    (lg, ag, rg), (lc, ac, rc) = out["cuda"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    ga = np.linalg.norm(ag - ac) / np.linalg.norm(ac)
    gr = np.linalg.norm(rg - rc) / np.linalg.norm(rc)
    log(f"[mat-reference] stage-2 step card vs cpu, pano 64x128, atlases "
        f"{ALBEDO_RES}^2/{ROUGH_RES}^2: loss {lg:.7f} vs {lc:.7f} (rel "
        f"{rel:.3g}); gradient rel L2 albedo {ga:.3g}, roughness {gr:.3g}")
    if not (rel <= 1e-4 and ga <= 1e-3 and gr <= 1e-3):
        raise SystemExit("the Mat step on the card disagrees with the CPU")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import texir_code_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
    name, count, _ = phase_device(torch)
    phase_build()
    syn, clusters, occ = bench_scene(dev)
    rows = phase_kernels(torch, dev, clusters, occ, syn)
    rows.update(phase_mat_kernels(torch, dev, syn))
    with tempfile.TemporaryDirectory() as tmp:
        path_mesh = phase_export(torch, syn, tmp)
        rows["shared_uv"]["launches"] = phase_slice(torch, syn, path_mesh,
                                                    IRT_RES, tmp)
        launches, _ = phase_mat(torch, path_mesh, tmp)
        for mode in ("shared_prim", "per_ray_uv"):
            rows[mode]["launches"] = launches[mode]
        phase_profile(torch, dev, clusters, occ, syn)
        phase_mat_profile(torch, path_mesh, tmp)
    phase_reference(torch, dev, clusters, occ, syn)
    phase_mat_reference(torch, dev, syn)
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in
                                  ("shared_uv", "shared_prim", "per_ray_uv")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
