#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (texir_code_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

It drives the port's main path on two scenes of the JAX package's bench:
the apartment (make_apartment_scene(atlas_res=256, subdiv=24)) and the
multi-room building (make_building_scene(atlas_res=256, subdiv=28), 104,076
triangles): export the scan, bake its IrrT, train its materials; on the
apartment also the FanScene-only configuration (no ClusterScene: every ray
against every leaf row, kernels B2/B3), the Mat step with the sampler's
segment-sum backward (kernel S), the four testers, the BVH traversal and
the quality run's path (the material-rendered export, IrrT, MatSyn), the
field stages (NIrF at full width, IRF, PIL), path-traced relighting, the
five tools, the three baseline heads (InvRender, NeILF, nvdiffrec) and
the two alternative material models (MaterialMLP, RednerMaterialModel); on
the building also its quality recipe cut to a smoke run.
Phases (any failure exits non-zero; nothing is caught):
  1. device: torch's view of the card, and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port from csrc/ (culled_walk,
     fan_stream, scatter_acc), one nvcc each, all started together;
  3. kernels: each culled-walk mode against its plain PyTorch version on
     the card at the shapes the main path gives it, with times and the
     work bound — the bake's wedge rows (1024 texels × 2048 spp, lb 4),
     and the Mat step's G-buffer of one view (98,304 pixel rays, lb 8) and
     that view's 1,572,864 specular rays (per-ray origins, importance
     directions at roughness 0.1, lb 8), all with occluders;
  4. fan-kernels: the exhaustive stream's four modes against
     fan_stream_plain — the FanScene-only bake's rows (1024 texels × 2048
     spp, emit_uv), the view's G-buffer (t_min 1e-6) and its specular
     rays (emit_uv and prim), each with its bound, its no-FMA ceiling
     and its rays per thread — and B2 against B1 on the bake rows;
  5. visits: B1's debug_emit_visits telemetry on the bake rows through
     cast_fans_culled, against the plain walk;
  6. sampler-kernels: the sampler-backward harness
     (texir_code_tpu_torch/scripts/sampler_bwd_variants.py) — kernel S's
     two modes, index_put_, index_add_ and sort + index_add_ on 786,432
     taps at the JAX harnesses' (S, C) and on the flat albedo (2048²) and
     roughness (4096²) pyramids with the exact-trilinear taps of one bench
     view — kernel S against its plain version and index_add_;
  7. building-kernels: the walk at the building's shapes — one bake
     batch's wedge rows (4096 texels, fb 16, er 8, lb 4) unseeded and
     seeded by the k-1024 occlusion proxy, its two-pass trace (cut 0.25)
     and pass-2 stragglers, and one view's G-buffer and specular rays from
     the bench camera seeded by the k-512 proxy (lb 8); seeded, unseeded,
     two-pass and single-pass hits must agree;
  8. export: the apartment written to the reference's dataset layout by
     the port's exporter (4 views, pano 256×512);
  9. slice: `train --trainstage IrrT` through the port's CLI on the
     exported mesh at --irt_res 1024 and 2048 spp (it writes the irt.hdr
     the Mat stage reads);
 10. mat: `train --trainstage Mat --max_epochs 1` through the port's CLI
     with the bench atlases (albedo 2048², roughness 4096²) and
     sample_light [32, 16]: seconds per step of each substage, stage
     seconds with set-up, launches per kernel mode;
 11. fan-slice: the apartment's FanScene-only bake at 1024² × 2048 spp
     (IrradianceTextureBaker(tbl, fan_scene=fan, max_leaves=...)), held
     against the slice's culled bake of the same seed;
 12. fan-mat: stage-2 steps of the Mat model with cluster_scene = None
     (and two with the exact specular fetch), and one step against the
     culled model's;
 13. error: `test --teststage Error` through the port's CLI on the export
     and the atlases of 10 (sample_light [1024, 256], shade_chunk 4096),
     then one view by the FanScene-only model against the culled one;
 14. testers: `test --teststage Editing` (a test.editing block), `View
     --num_frames 4` and `Relighting --relight_mode emitter` through the
     port's CLI on the same export, atlases and sample_light, with the
     scene's seg atlas as 0_seg_gray.png; an unedited Editing frame
     against the Error render (bit-equal); one relit view profiled;
 15. profile: one full bake batch under torch.profiler;
 16. mat-profile: one cached-view stage-2 step (forward, backward, Adam,
     clamp) under torch.profiler, with the sampler backward's scatter
     named apart;
 17. mat-segsum: the stage-2 step with ops.texture.SEGSUM_BACKWARD off and
     on, in exact trilinear and stochastic mode: loss bit-equal and
     gradients within relative L2 1e-5 (deterministic algorithms), step
     times, kernel S launches, the sampler backward's device time;
 18. building-export: the building with one camera per room (9 views);
 19. building-proxy: its IrrT at --irt_res 256 without and with
     train.bake_proxy_k=1024: the raw bakes must be equal;
 20. building-slice: its IrrT at --irt_res 1024 (2048 spp) with fb 16,
     er 8, train.two_pass_cut=0.25 and occluders (bench.py's big scene);
 21. building-mat: its Mat stage with the apartment's settings plus
     models.render.proxy_k=512 and spec_two_pass_cut=0.25;
 22. building-profile: one two-pass bake batch and one cached-view
     stage-2 step (knobs off, two-pass only, proxy only) under
     torch.profiler;
 23. reference: the card's bake_batch against the CPU's;
 24. mat-reference: one stage-2 step on the card against the CPU at pano
     64×128 with full atlases and the same injected sample shifts;
 25. error-reference: one view's stage-2 eval render (shade_chunk 4096)
     on the card against the CPU at pano 64×128, spp 16;
 26. relit-reference: one view's relit render on the card against the CPU
     at pano 32×64, sample_light [32, 16];
 27. building-reference: the card's two-pass + proxy bake_batch against
     the CPU's on 64 building texels;
 28. bvh (after 7): the BVH traversal (ops/raycast.py::cast_rays_soa,
     plain PyTorch) on view 0's 131,072 pano rays of the quality run's
     5-view ring, against B1 shared_prim on the same rays and against the
     CPU traversal on 8,192 of them; ms a cast, iterations, launches, host
     syncs;
 29. syn-export (after 17): export_reference_layout(gt_render="material")
     at 5 views 256×512, gt_spp 512, irt_spp 1024 (view004 held out as
     the novel view), B1 shared_uv (the GT IrT bake) and per_ray_prim (the
     photos' specular rays) required; 256 pixels of view 0 rendered on
     the card and on the CPU with the same draws;
 30. matsyn: IrrT at --irt_res 512 and `train --trainstage MatSyn
     --max_epochs 1` through the port's CLI on that export (B1
     shared_prim and per_ray_uv required): stage seconds, material and
     novel-view metrics;
 31. irrf-kernels (after 30, on the export of 8): B1 per_ray_prim on the
     NIrF trace's rays, captured from the tracer's own call — one IRRF
     training step's (16 points x 2048 hemisphere rays, one origin a row
     of 2048, lb 8) and one validation batch's (512 pixels of the
     512x1024 val pano x 2048) — against the plain walk, with times and
     the bound;
 32. irrf-reference: one IRRF train step (full-width MLP) on the card
     against the CPU from the same weights, points and draws;
 33. irrf: `train --trainstage IRRF --conf configs/irrf_synthetic.conf
     --max_epochs 2` through the port's CLI (3 epochs of 64 steps, the
     validation at 512x1024 x [32, 64]): stage seconds, ms a step, steps/s,
     the validation's seconds and val_psnr / val_ssim, B1 launched once a
     step and once a validation batch; one step under torch.profiler;
 34. irf: `--trainstage IRF --max_epochs 1`, validation at [64, 128] x
     [16, 32];
 35. pil: `--trainstage PIL --max_epochs 1`, validation at 1024 points x
     512 spp x 5 roughnesses;
 36. pathtrace (after 14): `test --teststage Relighting --relight_mode
     pathtrace` through the port's CLI at the JAX CLI's defaults (pano
     64x128, spp 16, 3 bounces, a quad light under each of the 4 cameras)
     on the export and the atlases of 10: seconds a frame, casts a view,
     rays a cast, the BVH traversal's iterations and host syncs, every
     frame finite and lit; one view at 1 bounce under torch.profiler
     (launches, idle share).  No hand-written kernel runs on this path;
 37. pathtrace-reference: one trace of a band of view 0's pixels on the
     card against the CPU from the same draws (rel L2 1e-4);
 38. tools: `relighting_varying --frames 2` on the card on the same mesh
     and atlases, and the four host tools (padding_texture, trans_hdr_tex,
     hdr2ldr, arrange_syn) on a small input, without OpenCV;
 39. heads (after 30, on its export and IrrT): `train --trainstage
     MatInvSyn | MatNeilfSyn | MatRecSyn --max_epochs 1` through the
     port's CLI at full width (configs/reference/syn_*.conf), evaluated
     at 256 specular spp: stage, step and evaluation seconds, peak memory,
     the four quality PSNRs (finite), B1 `shared_prim` at least once a
     view and `per_ray_prim` at least once a step; one step of each under
     torch.profiler; B1 on a step's captured G-buffer and specular rays
     against the plain walk;
 40. heads-reference: one step of each head (full-width networks, pano
     32x64) on the card against the CPU from the same parameters and
     draws: rgb rel L2 1e-4, loss rel 1e-4, gradients rel L2 1e-3;
 41. alt-models (after 40): the two alternative material models at the JAX
     defaults on the apartment — MaterialMLP (MatNetwork 4x512, pano
     128x256, sample_light [32, 16]) and RednerMaterialModel with
     optim_cam (a 2048² texture per object group, pano 256x512,
     sample_light [64, 64]), three forward + backward + Adam steps each:
     ms a step, launches, idle share, peak memory (no hand-written kernel:
     both trace through the BVH, as the JAX models do);
 42. alt-models-reference: one step of each on a band of 4 pano rows,
     card vs CPU from the same parameters and draws (rgb rel L2 1e-4, loss
     rel 1e-4, gradients rel L2 1e-3, Redner's pose deltas included), and
     RenderLoss and msssim_loss card vs CPU;
 43. building-matsyn (after 22): the building's quality recipe
     (texir_code_tpu_torch/scripts/building_quality.py) cut: the material
     export with one camera a room and the novel view (gt_spp 32; B1
     shared_uv and per_ray_prim required), IrrT at 256² (fb 16, er 8,
     two-pass 0.25; shared_uv and per_ray_uv), `train --trainstage MatSyn
     --max_epochs 1` through the CLI (shared_prim and per_ray_uv; the
     log's `roomseg active: n_rooms=` above 1), `train --trainstage IRRF
     --max_epochs 1` with a small validation (per_ray_prim); B1 against
     its plain version on MatSyn's first specular launch and IRRF's first
     GT-trace launch; one IRRF step of 2 points on the building card vs
     CPU.
 The multi-device paths (texir_code_tpu_torch/parallel/, one rank per
 device; after 33, on the apartment's export): two ranks share the card
 over gloo, each a process of this script (`--rank-cli` runs the port's
 CLI as one rank, `--rank-mat` the Mat steps), and a failed rank fails
 the phase;
 44. spmd-bake: `train --trainstage IrrT` at [slice]'s settings as two CLI
     processes (--coordinator, --num_processes 2, --process_id r,
     train.spmd=true): the raw and padded textures against [slice]'s (rel
     1e-6 on every value), each rank's shared_uv launches half of
     [slice]'s to within one, one experiment directory;
 45. spmd-mat: 3 data-parallel Mat stage-2 steps at [mat]'s full width
     (the stochastic knobs, occluders) on the two ranks under
     deterministic algorithms, against this process's single steps from
     the same seeds: losses rel 1e-6, the last step's gradients and the
     atlases rel L2 1e-5, the atlases bit-equal across ranks; ms a step,
     the gradient all-reduce's ms and bytes, peak memory; then the same
     steps as a one-rank NCCL group, bit-equal to the single process;
 46. atlas-tp (in 45's ranks): the atlases row-sharded (1024 / 2048 rows a
     rank), one exact-trilinear step against the replicated one: loss
     rel 1e-5, gathered gradients rtol 1e-4 / atol 1e-7; peak memory;
 47. spmd-irrf: `train --trainstage IRRF --max_epochs 1` on two ranks
     (MatNetwork 4x512, the validation at 64x128 x [16, 32]): one batch's
     GT sharded against one rank's (rel 1e-6), the networks bit-equal
     across ranks, per_ray_prim on each rank;
 48. dryrun: parallel.dryrun.dryrun_multichip(2, "cuda").
 The last unported modules (on the apartment):
 49. wedged (after 3): ops/pallas_culled.py::cast_ray_fans_wedged (octant
     sort, 4 wedges, one exit group a 32-row block, occluders) on one
     bake batch's unsorted fans (1024 texels x 2048 spp), with uv output
     (B1 shared_uv) and prim output (shared_prim): its hits against
     cast_fans_culled on the bake's own rows, B1 against its plain
     version on the wedged trace's rows;
 50. tiled (after 28): ops/tiled_raycast.py (plain PyTorch) on the bench
     view's G-buffer (98,304 rays) and one bake batch (2,097,152 rays):
     required_leaf_budget, cast_rays_tiled at it (overflow share) and
     cast_rays_exact at half of it (re-traced rays), ms beside
     cast_rays_soa's, against cast_rays_soa and B1 by [bvh]'s hit rule,
     the card against the CPU on the first tiles' rays, launches and idle
     share of each cast;
 51. azimuth-bake (after 9): the IrrT runner's 1024^2 x 2048-spp bake with
     chunk_mode "octant" (equal to [slice]'s raw texture) and "azimuth"
     (the u2-sorted Hammersley table): Mrays/s of both, the azimuth
     texels against the octant ones by the bake rule, B1 shared_uv on one
     azimuth batch against its plain version;
 52. profiling (after 16): profiling.py's trace() around two stage-2 steps
     timed by StepTimer: the trace under its logdir names B1's kernel;
     StepTimer.summary().
Kernel launch counts are zeroed just before each main-path run (5, 6, 9,
10, 11, 12, 13, each tester of 14, the switch-on steps of 17, each run of
19, 20, 21, 29, the MatSyn stage of 30, 33, 34, 35, 36, each head of 39,
each run of 43; in each rank's process, its CLI stage in 44 and 47; each
trace of 49, the casts of 50, each bake of 51, the steps of 52) and read
just after; every kernel mode of that run must have run (36, 41 and 50
run none, and 50 fails if B1 ran).
Then a `{"kernels": [...]}` line and, last, the `{"ok": true, ...}`
line.  Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
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
# the multi-room scan: bench.py's big scene and its configuration
# (bench.py:258-262), the Mat step's camera there (bench.py:289-291), and
# one camera per room (scripts/building_quality.py:41-49)
ROOMS, ROOM_SIZE = (3, 3), (5.0, 3.0, 5.0)
BUILDING_FB, BUILDING_ER = 16, 8
TWO_PASS_CUT, TWO_PASS_CAP = 0.25, 0.125
BAKE_PROXY_K, MAT_PROXY_K = 1024, 512
PROXY_IRT_RES = 256  # the proxy-on/off bakes
BUILDING_CAM = (12.0, 1.5, 7.2)
KERNEL_SOURCE = "texir_code_tpu_torch/csrc/culled_walk.cu"
KERNEL_REPLACES = "texir_code_tpu/ops/pallas_culled.py:367"
VISITS_REPLACES = "texir_code_tpu/ops/pallas_culled.py:663"
FAN_SOURCE = "texir_code_tpu_torch/csrc/fan_stream.cu"
FAN_REPLACES = "texir_code_tpu/ops/pallas_fan.py:63"
FAN_MODES = ("shared_uv", "shared_prim", "per_ray_uv", "per_ray_prim")
# the tester (configs/test_synthetic.conf: the reference's eval spp)
EVAL_SAMPLE_LIGHT = (1024, 256)
EVAL_CHUNK = 4096
FAN_MAT_STEPS = 6
# kernel S, the scatter-accumulator of the sampler's segment-sum backward
SCATTER_SOURCE = "texir_code_tpu_torch/csrc/scatter_acc.cu"
S1_REPLACES = "scripts/sampler_bwd_variants2.py:110"
S2_REPLACES = "scripts/sampler_bwd_variants3.py:52"
SEGSUM_STEPS = 8
RELIT_REF_LIGHT = (32, 16)  # the relit card-vs-CPU check (diffuse, specular)
# the card-vs-CPU checks of the relit render and the heads' steps: the
# CPU's per-pixel work is most of their time, so they compare a 32x64 pano
# (a quarter of 64x128's pixels); the paths run at full width elsewhere
REF_PANO = (32, 64)
# the quality run's export (scripts/quality_run.py): 5 views, GT photos
# rendered through the material model
QUALITY_VIEWS = 5
GT_SPP = 512
IRT_SPP = 1024
SYN_IRT_RES = 512
BVH_BAND = (128, 144)  # pano rows of view 0 traced again on the CPU
# [bvh] vs B1 on view 0's rays, through edges and vertices: at most twice
# the deterministic readings (980 ties and leaks, 491 leaks through the
# walk, 4 through the traversal)
BVH_EDGE_RAYS_MAX = 1960
BVH_WALK_LEAKS_MAX = 982
BVH_LEAKS_MAX = 8
SYN_BAND = (65_408, 65_664)  # raster pixels of view 0 rendered on the CPU
# the field stages (configs/irrf_synthetic.conf): NIrF at full width; the
# GT trace walks B1 with per-ray origins and the exact radiance fetch
IRRF_CONF = os.path.join("configs", "irrf_synthetic.conf")
IRRF_EPOCHS = 2  # --max_epochs: the IRRF runner trains epochs 0..2
IRRF_MODE = "per_ray_prim"
IRRF_VAL_BATCH = 512  # pixels a validation batch (the JAX runner's)
IRF_VAL = ("val.env_res=[64,128]", "train.val_sample_res=[16,32]")
# path-traced relighting at the JAX CLI's defaults (texir_code_tpu/cli.py:
# 177-184): pano 64x128, spp 16, 3 bounces
PT_PANO, PT_SPP, PT_BOUNCES = (64, 128), 16, 3
PT_BAND = (24, 40)  # pano rows of view 0 traced again on the CPU
PT_BAND_SPP = 2
HEAD_STAGES = {"invrender": "MatInvSyn", "neilf": "MatNeilfSyn",
               "recmlp": "MatRecSyn"}
HEAD_EVAL_SPP = 256  # the '…Syn' runners' evaluation (JAX train/heads.py)
HEAD_MODES = ("shared_prim", "per_ray_prim")  # the heads' G-buffer, specular
# the alternative material models at the JAX defaults (texir_code_tpu/
# models/material_mlp.py:36-46, material_redner.py:132-145)
MLP_PANO, MLP_LIGHT = (128, 256), (32, 16)
REDNER_TEX, REDNER_PANO, REDNER_LIGHT = 2048, (256, 512), (64, 64)
ALT_BAND = 4  # pano rows of a view held card vs CPU
# the building's quality recipe (texir_code_tpu_torch/scripts/
# building_quality.py) cut for the smoke run: gt_spp and the IrrT size
BUILDING_GT_SPP = 32
BUILDING_SYN_IRT = 256
BUILDING_IRRF_VAL = ("val.env_res=[64,128]", "train.val_sample_res=[16,32]")


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

    names = ["culled_walk", "fan_stream", "scatter_acc"]
    t0 = time.time()
    cuda_build.build(names)  # one nvcc per source, all started together
    dt = time.time() - t0
    log(f"[build] {', '.join(names)} built in {dt:.1f} s")
    for name in names:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


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


def bake_rows(torch, pts, nrm, ids, seed, dev, chunk_mode="octant"):
    """A bake batch's wedge rows (origins, directions) exactly as the baker
    builds them in its chunk_mode ("octant": sorted by octant; "azimuth":
    drawn from the u2-sorted Hammersley table)."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        sort_dirs_octant,
        tile_rows,
        wedge_rows,
    )
    from texir_code_tpu_torch.ops.sampling import (
        generate_dir_soa,
        hammersley_azimuth_sorted,
    )

    p = torch.from_numpy(pts).to(dev)
    n = torch.from_numpy(nrm).to(dev)
    nrm_s = tuple(n[:, k] for k in range(3))
    azimuth = chunk_mode == "azimuth"
    dirs = generate_dir_soa(
        nrm_s, SPP, mode="uniform", row_ids=torch.from_numpy(ids).to(dev),
        seed=seed, base=hammersley_azimuth_sorted(SPP, dev) if azimuth
        else None,
    )
    ds = dirs if azimuth else sort_dirs_octant(dirs)
    rows_d = tuple(wedge_rows(a, WEDGES).contiguous() for a in ds)
    rows_o = tuple(
        tile_rows(p[:, k] + 1e-2 * n[:, k], WEDGES) for k in range(3)
    )
    return rows_o, rows_d


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
    dt = np.abs(np.where(both, ta, 0.0) - np.where(both, tb, 0.0))
    t_bad = (np.isfinite(ta) != np.isfinite(tb)) | (dt > TOL)
    duv = np.maximum(np.abs(ua - ub), np.abs(va - vb))
    prim_diff = (pa != pb) if emit_prim else np.zeros_like(t_bad)
    tie = ~t_bad & ((duv > TOL) | prim_diff)
    err = max(float(dt.max()), float(duv.max()))
    return err, int(tie.sum()), int(t_bad.sum()), int(prim_diff.sum())


def timed_once(torch, fn):
    """(fn(), its CUDA-event ms): one run, for a slow plain walk whose
    comparison run is also its timing."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def exit_waste(torch, need):
    """The ray-visits an exit of warp granularity (32 consecutive rays of
    a group walk while one of them needs to) and of block granularity (256
    rays) walk, each as a share of the needed visits; need [G, rays of a
    group]."""
    total = max(1, int(need.sum()))
    shares = []
    for width in (32, 256):
        pad = (-need.shape[1]) % width
        w = torch.nn.functional.pad(need, (0, pad)).reshape(
            need.shape[0], -1, width)
        shares.append(int(w.amax(dim=2).sum()) * width / total)
    return tuple(shares)


def walk_bound(torch, inp, t_final):
    """The least time the card could take for a walk on these inputs:
    (bound_ms, ops_ms, bytes_ms, visits, tests, exit waste).  The work this
    run's data needs: every ray tests each candidate whose bound is below
    its final t (capped), lb*4 triangles each, at FLOPS_PER_TEST; the bytes
    read each input once and write each output once.  The exit waste:
    exit_waste of the needed visits."""
    rays = inp["dx"].numel()
    lb = inp["rows3"].shape[1]
    t_fin = torch.clamp_max(t_final, inp["t_cap"])
    g = inp["count"].numel()
    need = torch.searchsorted(inp["dist"], t_fin.reshape(g, -1).contiguous())
    need = torch.minimum(need, inp["count"][:, None].long())
    visits = int(need.sum())
    waste = exit_waste(torch, need)
    tests = visits * lb * 4
    ops_ms = tests * FLOPS_PER_TEST / PEAK_FP32_FLOPS * 1e3
    nbytes = sum(
        inp[k].numel() * inp[k].element_size()
        for k in ("count", "cand", "dist", "origins", "dx", "dy", "dz",
                  "rows3")
    ) + (inp["prims3"].numel() * 4 if inp["emit_prim"] else 0) + rays * 16
    if inp.get("seed") is not None:  # t, u, v and, with emit_prim, prim
        nbytes += rays * (16 if inp["emit_prim"] else 12)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms, visits, tests, waste


def check_walk(torch, label, inp, plain_reps=2, name=None):
    """culled_walk_cuda against culled_walk_plain on the same inputs: the
    agreement rule of the bake phase (t within TOL, no t mismatch, ties at
    most 1e-4 of the rays), CUDA-event times, and the bound.  plain_reps 0
    times the plain walk's comparison run itself.  Returns the kernel's
    row of the JSON line (launches filled in later) and its hits."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        culled_walk_cuda,
        culled_walk_plain,
        walk_mode,
    )

    rays = inp["dx"].numel()
    lb = inp["rows3"].shape[1]
    seed = inp.get("seed")
    mode = walk_mode(inp["per_ray"], inp["emit_uv"], inp["emit_prim"],
                     seed is not None)
    hk = culled_walk_cuda(**inp)
    torch.cuda.synchronize()
    if plain_reps:
        hp = culled_walk_plain(**inp)
        plain_ms = cuda_ms(torch, lambda: culled_walk_plain(**inp),
                           plain_reps)
    else:
        hp, plain_ms = timed_once(torch, lambda: culled_walk_plain(**inp))
    err, ties, t_bad, prim_bad = compare_hits(hk, hp, inp["emit_prim"])
    kernel_ms = cuda_ms(torch, lambda: culled_walk_cuda(**inp), 20)
    bound_ms, ops_ms, bytes_ms, visits, tests, waste = walk_bound(
        torch, inp, hp[0])
    log(f"[kernels] culled_walk {mode} ({label}, lb {lb}): {rays} rays, "
        f"{visits} cluster visits needed ({visits / rays:.2f}/ray, "
        f"{tests} triangle tests); an exit by warp walks {waste[0]:.3f}, "
        f"by 256-ray block {waste[1]:.3f} of the needed visits")
    log(f"[kernels]   max|dt|,|du|,|dv| = {err:.3g}; t mismatches "
        f"{t_bad}; prim mismatches {prim_bad}; ties {ties}; hit "
        f"{float(torch.isfinite(hk[0]).float().mean()):.4f}")
    log(f"[kernels]   kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.2f}  "
        f"bound_ms {bound_ms:.4f} (ops {ops_ms:.4f}, bytes "
        f"{bytes_ms:.4f}); no-FMA issue ceiling {2 * ops_ms:.4f}"
        f"{' (per-ray origin terms: x47/30)' if inp['per_ray'] else ''}; "
        f"library_ms null: no single PyTorch call computes this walk")
    if t_bad or ties > 1e-4 * rays:
        raise SystemExit(
            f"culled_walk {mode} disagrees with its plain version: "
            f"{t_bad} t mismatches, {ties} ties"
        )
    return dict(
        name=name or f"culled_walk[{mode}]", route="cuda",
        source=KERNEL_SOURCE, replaces=KERNEL_REPLACES, max_abs_err=err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None,
    ), hk


def phase_kernels(torch, dev, clusters, occ, syn):
    """The bake's shape (a), in its emit_uv mode (the bake's) and its
    emit_prim mode."""
    from texir_code_tpu_torch.ops.pallas_culled import walk_args

    pts, nrm, ids = bake_texels(syn, 1024)
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev)
    rows = {}
    for emit_uv, emit_prim in ((True, False), (False, True)):
        row, _ = check_walk(torch, "bake rows", walk_args(
            clusters, rows_o, rows_d, fan_block=FAN_BLOCK,
            exit_rows=EXIT_ROWS, emit_uv=emit_uv, emit_prim=emit_prim,
            occluders=occ))
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


def specular_rows(torch, dm, hit, cam, dev):
    """One view's specular rays from its G-buffer hits, as the Mat step
    makes them (importance half-vectors at roughness 0.1, SPEC_SPP per
    pixel): per-ray origins and directions in rows of 1024."""
    from texir_code_tpu_torch.ops.gbuffer import interpolate_attributes
    from texir_code_tpu_torch.ops.sampling import (
        TINY_NUMBER,
        generate_dir_soa,
        hammersley,
        hash_uniform,
        reflect_soa,
    )

    n = hit.t.numel()
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
    return so, sd


def phase_mat_kernels(torch, dev, syn):
    """The Mat step's shapes (b) and (c) of one bench view at lb 8, with
    the walk inputs built exactly as render_gbuffer and query_tbl_stream
    build them."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.geometry.occluders import extract_occluders
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.gbuffer import DeviceMesh, ray_dirs_from_mvp
    from texir_code_tpu_torch.ops.pallas_culled import (
        ClusterScene,
        culled_walk_cuda,
        walk_args,
    )
    from texir_code_tpu_torch.ops.raycast import RayHit

    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    cs = ClusterScene.from_fan(fan, lb=MAT_LB, dense=True, device=dev)
    occ = extract_occluders(syn.mesh, device=dev)
    pos, mvp = bench_camera(syn)
    cam = torch.as_tensor(pos, device=dev)
    res = PANO[1] // 4
    flat = ray_dirs_from_mvp(mvp.to(dev), res).reshape(-1, 3)
    rows = flat.shape[0] // 2048
    d = tuple(flat[:, k].reshape(rows, 2048).contiguous() for k in range(3))
    o = tuple(cam[k].expand(rows).contiguous() for k in range(3))
    # fan_block 8, exit_rows 0: one group per 8-row block
    gbuf = walk_args(cs, o, d, fan_block=8, exit_rows=0, emit_prim=True,
                     t_min=1e-6, occluders=occ)
    out = {"shared_prim": check_walk(torch, "G-buffer of one view", gbuf)[0]}

    # that view's specular rays: importance half-vectors at roughness 0.1
    t, prim, u, v = culled_walk_cuda(**gbuf)
    dm = DeviceMesh.from_mesh(syn.mesh, dev)
    hit = RayHit(*(a.reshape(-1) for a in (t, prim, u, v)))
    so, sd = specular_rows(torch, dm, hit, cam, dev)
    spec = walk_args(cs, so, sd, fan_block=8, exit_rows=1, per_ray=True,
                     emit_uv=True, occluders=occ)
    out["per_ray_uv"] = check_walk(torch, "specular rays of one view", spec)[0]
    # the exact specular fetch (specular_fetch = "exact"): prim + barycentrics
    spec = walk_args(cs, so, sd, fan_block=8, exit_rows=1, per_ray=True,
                     emit_uv=False, emit_prim=True, occluders=occ)
    out["per_ray_prim"] = check_walk(
        torch, "specular rays of one view, exact fetch", spec,
        plain_reps=0)[0]
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


def make_baker(torch, syn, clusters, occ, d, building=False, proxy=None):
    """The runner's baker configuration on device `d`: the apartment's, or
    with building=True the big scene's (fb 16, er 8, two-pass 0.25),
    optionally seeded by an occlusion proxy."""
    import dataclasses

    from texir_code_tpu_torch.models.tbl import build_tbl
    from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker

    def to(cs):
        return dataclasses.replace(
            cs, **{k: getattr(cs, k).to(d) for k in
                   ("rows3", "prims3", "cluster_lo", "cluster_hi")})

    tbl = build_tbl(syn.mesh, syn.hdr_texture, device=d)
    oc = dataclasses.replace(
        occ, p=occ.p.to(d), rect_lo=occ.rect_lo.to(d),
        rect_hi=occ.rect_hi.to(d),
    )
    baker = IrradianceTextureBaker(tbl, spp=SPP, cluster_scene=to(clusters),
                                   wedges=WEDGES)
    baker.fan_block, baker.exit_rows, baker.occluders = (
        FAN_BLOCK, EXIT_ROWS, oc)
    if building:
        baker.fan_block, baker.exit_rows = BUILDING_FB, BUILDING_ER
        baker.two_pass_cut, baker.two_pass_cap = TWO_PASS_CUT, TWO_PASS_CAP
    if proxy is not None:
        baker.proxy_scene = to(proxy)
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


def _raw_events(prof):
    """A profile's events as torch.profiler recorded them (kineto), the
    ones key_averages() sums: read without building its event tree, which
    costs about a third of a millisecond an event (tens of seconds for a
    profile of 100,000 launches)."""
    return prof.profiler.kineto_results.events()


def profile_kernels(prof):
    """(kernel device ms by name, kernel launches) from a profile: device
    events only, without the device spans of record_function ranges (the
    optimizer's "Optimizer.step#..." range spans kernels counted on their
    own)."""
    kern, launches = {}, 0
    for e in _raw_events(prof):
        if not str(e.device_type()).endswith("CUDA"):
            continue
        if e.is_user_annotation() or e.name().startswith("Optimizer."):
            continue
        kern[e.name()] = kern.get(e.name(), 0.0) + e.duration_ns() / 1e6
        launches += 1
    return kern, launches


def profile_cpu_ms(prof, name):
    """The host ms a profile spent in the CPU op `name`."""
    return sum(e.duration_ns() / 1e6 for e in _raw_events(prof)
               if e.name() == name
               and not str(e.device_type()).endswith("CUDA"))


def profile_once(torch, tag, label, fn, top=6):
    """Where one call of fn spends the card's time: host clock around a
    warm run, then kernel device time by name from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern, launches = profile_kernels(prof)
    busy = sum(kern.values())
    log(f"[{tag}] profile of {label}: wall {wall_ms:.2f} ms (unprofiled); "
        f"{launches} kernel launches, {busy:.2f} ms on the card; idle share "
        + (f"{max(0.0, 1 - busy / wall_ms):.3f}" if busy else "not measured"))
    for name, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[{tag}]   {ms:9.3f} ms  {name[:90]}")
    return wall_ms, kern, launches


def phase_mat_profile(torch, path_mesh, tmp):
    """One cached-view stage-2 step (forward, backward, Adam, clamp) of the
    Mat runner on the bench view, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.train.material import MatTrainRunner

    conf_path, sets = _mat_conf(path_mesh, PANO)
    conf = parse_file(conf_path)
    for kv in sets[1::2]:  # the values of the "--set KEY=VAL" pairs
        k, _, v = kv.partition("=")
        conf.put(k.strip(), _parse_value(v.strip()))
    runner = MatTrainRunner(conf, exps_root=os.path.join(tmp, "exps_prof"),
                            max_epochs=1)
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data([0])
    opt, sched = mat_adam(runner)

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
    log(f"[mat-profile]   culled_walk {walk:.3f} ms; gather-backward "
        f"scatters (the sampler's fetches and the seg prior's per-room "
        f"class means) {sum(scatter.values()):.3f} ms in {len(scatter)} "
        f"kernel names")
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


# ---------------------------------------------------------------------------
# the FanScene-only configuration: kernels B2/B3 (the exhaustive leaf
# stream), B1's visit telemetry, and the re-render error tester
# ---------------------------------------------------------------------------


def fan_scene(mesh):
    """A mesh's FanScene (uv rows), as the runners pack it."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.ops.fan_raycast import FanScene

    fb = build_bvh(mesh.vertices, mesh.faces)
    return FanScene.from_flat(fb, triangle_uvs=mesh.triangle_uvs())


def check_fan(torch, label, fan, origins, d, t_min, emit_uv, per_ray):
    """fan_stream_cuda against fan_stream_plain on the same inputs: t and
    prim bit-equal, u and v bit-equal or within 1e-6; CUDA-event times,
    the bound (every ray tests every real triangle) and the kernel's
    no-FMA issue ceiling (2 × the bound).  Returns the kernel's row of the
    JSON line (launches filled in later) and its hits."""
    from texir_code_tpu_torch.ops.pallas_fan import (
        fan_stream_cuda,
        fan_stream_plain,
        launch_plan,
        sm_count,
        stream_mode,
    )

    dev = d[0].device
    rows = fan.device_rows(dev)
    args = (rows, origins, *d)
    kw = dict(t_min=t_min, emit_uv=emit_uv, per_ray=per_ray)
    mode = stream_mode(per_ray, emit_uv)
    records = fan.device_records(dev)
    hk = fan_stream_cuda(*args, **kw, records=records)
    torch.cuda.synchronize()
    hp, plain_ms = timed_once(torch, lambda: fan_stream_plain(*args, **kw))
    t_bad = int((hk[0] != hp[0]).sum() - (torch.isnan(hk[0])
                                           & torch.isnan(hp[0])).sum())
    prim_bad = int((hk[1] != hp[1]).sum())
    duv = max(float((hk[2] - hp[2]).abs().max()),
              float((hk[3] - hp[3]).abs().max()))
    kernel_ms = cuda_ms(torch, lambda: fan_stream_cuda(
        *args, **kw, records=records), 5)
    rays = d[0].numel()
    rays_per_thread, threads = launch_plan(rays, sm_count(dev.index))
    # the closest hit needs the real triangles only: padded slots (prim
    # -1, zero normal) never hit
    slots = int((rows[:, 8:12].view(torch.int32) >= 0).sum())
    tests = rays * slots
    ops_ms = tests * FLOPS_PER_TEST / PEAK_FP32_FLOPS * 1e3
    nbytes = (rows.numel() * 4 + origins.numel() * 4 + rays * 12
              + rays * 16)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[fan-kernels] fan_stream {mode} ({label}): {rays} rays x "
        f"{slots} triangles in {rows.shape[0]} leaf rows = {tests} triangle "
        f"tests, t_min {t_min}")
    log(f"[fan-kernels]   t mismatches {t_bad}; prim mismatches {prim_bad}; "
        f"max |du|,|dv| {duv:.3g}; hit "
        f"{float(torch.isfinite(hk[0]).float().mean()):.4f}")
    log(f"[fan-kernels]   kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.2f}  "
        f"bound_ms {bound_ms:.4f} (ops {ops_ms:.4f}, bytes {bytes_ms:.4f}); "
        f"no-FMA ceiling {2 * bound_ms:.4f} ms; {rays_per_thread} rays a "
        f"thread, {threads} threads a block; library_ms null: no single "
        f"PyTorch call computes a closest hit")
    if t_bad or prim_bad or duv > 1e-6:
        raise SystemExit(f"fan_stream {mode} disagrees with its plain version")
    return dict(
        name=f"fan_stream[{mode}]", route="cuda", source=FAN_SOURCE,
        replaces=FAN_REPLACES, max_abs_err=duv, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None,
    ), hk


def phase_fan_kernels(torch, dev, syn, clusters):
    """Kernels B2 and B3 against fan_stream_plain at the apartment's path
    shapes: the FanScene-only bake's rows (1024 texels x 2048 spp, one
    shared origin each, emit_uv), one bench view's G-buffer (98,304 pixel
    rays, t_min 1e-6) and that view's specular rays (1,572,864, per-ray
    origins, emit_uv and prim); then B2 against B1 on the bake rows
    (occluders off): t bit-equal, prim equal but on exact-t ties."""
    from texir_code_tpu_torch.ops.gbuffer import DeviceMesh, ray_dirs_from_mvp
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda, walk_args
    from texir_code_tpu_torch.ops.raycast import RayHit
    from texir_code_tpu_torch.ops.sampling import generate_dir_soa

    fan = fan_scene(syn.mesh)
    out = {}
    pts, nrm, ids = bake_texels(syn, 1024)
    p = torch.from_numpy(pts).to(dev)
    n = torch.from_numpy(nrm).to(dev)
    d = tuple(a.contiguous() for a in generate_dir_soa(
        tuple(n[:, k] for k in range(3)), SPP, mode="uniform",
        row_ids=torch.from_numpy(ids).to(dev), seed=777))
    o = torch.stack([p[:, k] + 1e-2 * n[:, k] for k in range(3)], -1)
    out["shared_uv"], h2 = check_fan(torch, "FanScene-only bake rows", fan,
                                     o.contiguous(), d, 0.0, True, False)
    # B2 against B1 on the same rows: the same plane-dual test, the culled
    # walk without occluders visits every cluster that can hold the hit
    h1 = culled_walk_cuda(**walk_args(
        clusters, tuple(o[:, k] for k in range(3)), d, fan_block=FAN_BLOCK,
        exit_rows=EXIT_ROWS, emit_uv=True, emit_prim=True))
    torch.cuda.synchronize()
    t_bad = int((h1[0] != h2[0]).sum())
    ties = int(((h1[1] != h2[1]) & (h1[0] == h2[0])).sum())
    log(f"[fan-kernels] B2 vs B1 on the bake rows (occluders off): t not "
        f"bit-equal on {t_bad} of {h2[0].numel()} rays; prim ties {ties}")
    if t_bad or ties > 1e-4 * h2[0].numel():
        raise SystemExit("fan_stream and culled_walk disagree on the bake rows")

    pos, mvp = bench_camera(syn)
    cam = torch.as_tensor(pos, device=dev)
    flat = ray_dirs_from_mvp(mvp.to(dev), PANO[1] // 4).reshape(-1, 3)
    width = min(2048, flat.shape[0])  # rows as render_gbuffer cuts them
    while flat.shape[0] % width:
        width -= 128
    g_rows = flat.shape[0] // width
    gd = tuple(flat[:, k].reshape(g_rows, width).contiguous()
               for k in range(3))
    go = cam[None].expand(g_rows, 3).contiguous()
    out["shared_prim"], hg = check_fan(torch, "G-buffer of one view", fan,
                                       go, gd, 1e-6, False, False)
    dm = DeviceMesh.from_mesh(syn.mesh, dev)
    hit = RayHit(*(a.reshape(-1) for a in hg))
    so, sd = specular_rows(torch, dm, hit, cam, dev)
    so = torch.stack(so, 0).contiguous()
    sd = tuple(a.contiguous() for a in sd)
    for emit_uv in (True, False):
        row, _ = check_fan(torch, "specular rays of one view", fan, so, sd,
                           0.0, emit_uv, True)
        out["per_ray_uv" if emit_uv else "per_ray_prim"] = row
    return out


def phase_visits(torch, dev, clusters, occ, syn):
    """B1's debug_emit_visits telemetry on the apartment's bake rows,
    through cast_fans_culled (the telemetry scripts' entry point), against
    the plain walk: u (clusters each exit group visited) and v (its
    candidate count) equal exactly, t and prim too."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled,
        culled_walk_cuda,
        culled_walk_plain,
        walk_args,
        walk_mode,
    )

    pts, nrm, ids = bake_texels(syn, 1024)
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev)
    kw = dict(fan_block=FAN_BLOCK, exit_rows=EXIT_ROWS, emit_uv=True,
              occluders=occ)
    culled_walk_cuda.launches.clear()
    hk = cast_fans_culled(clusters, rows_o, rows_d, debug_emit_visits=True,
                          **kw)
    torch.cuda.synchronize()
    launches = dict(culled_walk_cuda.launches)
    mode = walk_mode(False, True, False, visits=True)
    if launches.get(mode, 0) <= 0:
        raise SystemExit(f"[visits] culled_walk {mode} never launched")
    inp = walk_args(clusters, rows_o, rows_d, **kw)
    hp, plain_ms = timed_once(
        torch, lambda: culled_walk_plain(**inp, visits=True))
    bad = [name for name, a, b in zip("t prim u v".split(),
                                      (hk.t, hk.prim, hk.u, hk.v), hp)
           if not torch.equal(a, b[:a.shape[0]])]
    kernel_ms = cuda_ms(
        torch, lambda: culled_walk_cuda(**inp, visits=True), 20)
    g = inp["count"].numel()
    visits = hk.u.reshape(g, -1)[:, 0]
    count = hk.v.reshape(g, -1)[:, 0]
    # the telemetry walk's work is the walk's (the counts are a by-product)
    bound_ms, ops_ms, bytes_ms, _, _, _ = walk_bound(torch, inp, hp[0])
    log(f"[visits] culled_walk {mode} via cast_fans_culled: {g} exit groups, "
        f"visits {float(visits.mean()):.2f} of {float(count.mean()):.2f} "
        f"candidates a group (max {int(visits.max())}); launches {launches}")
    log(f"[visits]   differs from the plain walk in: {bad or 'nothing'}; "
        f"kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.2f}  bound_ms "
        f"{bound_ms:.4f} (ops {ops_ms:.4f}, bytes {bytes_ms:.4f}: the "
        f"walk's); library_ms null: no single PyTorch call computes it")
    if bad:
        raise SystemExit(f"[visits] the telemetry disagrees in {bad}")
    return dict(
        name=f"culled_walk[{mode}]", route="cuda", source=KERNEL_SOURCE,
        replaces=VISITS_REPLACES, max_abs_err=0.0, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None, launches=launches[mode])


def _raw_quantized(tex):
    """A bake as the runner's 0_irr_texture.hdr stores it (RGBE)."""
    from texir_code_tpu_torch.data import hdrio

    return hdrio.rgbe_to_float(hdrio.float_to_rgbe(tex))


def bake_rule(label, a, b, valid):
    """PERF.md section 2's bake-correctness rule on valid texels: within
    rtol 1e-4 on at least 98%, none beyond 0.05."""
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3))[valid]
    log(f"{label}: max rel {rel.max():.3g}, texels above 1e-4: "
        f"{int((rel > 1e-4).any(-1).sum())} of {int(valid.sum())}")
    if (rel > 1e-4).any(-1).mean() > 0.02 or rel.max() > 0.05:
        raise SystemExit(f"{label}: the bakes disagree")


def phase_fan_slice(torch, path_mesh, tmp):
    """The apartment's FanScene-only bake at 1024^2 x 2048 spp, texel batch
    4096, through IrradianceTextureBaker(tbl, fan_scene=fan,
    max_leaves=fan.num_leaves) with the IrrT runner's other settings and
    seed; held against the [slice] phase's culled raw bake."""
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.geometry import load_obj
    from texir_code_tpu_torch.models.tbl import build_tbl
    from texir_code_tpu_torch.models.tracer_irt import (
        IrradianceTextureBaker,
        bake_geometry_textures,
    )
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.ops.pallas_fan import fan_stream_cuda
    from texir_code_tpu_torch.train.exp import seed_everything

    t0 = time.time()
    mesh = load_obj(path_mesh)
    tex = hdrio.read_hdr(path_mesh.replace("out1.obj", "hdr_texture.hdr"),
                         flip=True)
    tbl = build_tbl(mesh, tex, 0.0, device="cuda")
    fan = fan_scene(mesh)
    geom = bake_geometry_textures(mesh, IRT_RES)
    baker = IrradianceTextureBaker(tbl, spp=SPP, texel_batch=4096,
                                   fan_scene=fan, max_leaves=fan.num_leaves)
    gen = seed_everything(666)  # the IrrT runner's generator
    setup_s = time.time() - t0
    fan_stream_cuda.launches.clear()
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t1 = time.time()
    raw = baker.bake(geom, gen)
    torch.cuda.synchronize()
    dt = time.time() - t1
    launches = dict(fan_stream_cuda.launches)
    walked = dict(culled_walk_cuda.launches)
    texels = int(geom.valid.sum())
    rays = texels * SPP
    log(f"[fan-slice] FanScene-only bake: {fan.num_leaves} leaf rows, "
        f"{texels} texels x {SPP} spp = {rays} rays in {dt:.2f} s = "
        f"{rays / dt / 1e6:.2f} Mrays/s ({setup_s:.2f} s set-up); "
        f"fan_stream launches {launches}, culled_walk launches {walked}")
    if launches.get("shared_uv", 0) <= 0 or walked:
        raise SystemExit("[fan-slice] the bake did not run the fan stream "
                         "alone")
    culled = hdrio.read_hdr(path_mesh.replace("out1.obj", "0_irr_texture.hdr"),
                            flip=True)
    if not (np.isfinite(raw).all() and raw[geom.valid].mean() > 0):
        raise SystemExit("[fan-slice] the bake is black or non-finite")
    # the same rays (seed, texel ids), summed in another order, and the
    # culled bake's occluders: only leaking rays and rounding differ
    bake_rule("[fan-slice] raw bake vs the [slice] culled bake (both RGBE)",
              _raw_quantized(raw), culled, geom.valid)
    dev = baker.device
    pts, nrm = (torch.from_numpy(geom.position[geom.valid][:4096]).to(dev),
                torch.from_numpy(geom.normal[geom.valid][:4096]).to(dev))
    ids = torch.arange(pts.shape[0], device=dev)
    profile_once(torch, "fan-slice", "one bake batch (4096 texels x 2048 "
                 "spp)", lambda: baker.bake_batch(pts, nrm, ids, 99))
    return launches


def mat_runner(torch, path_mesh, tmp, name):
    """The Mat runner on the apartment's export at the bench settings, with
    its masks built and the view of camera 0 prepared (as [mat-profile])."""
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.train.material import MatTrainRunner

    conf_path, sets = _mat_conf(path_mesh, PANO)
    conf = parse_file(conf_path)
    for kv in sets[1::2]:  # the values of the "--set KEY=VAL" pairs
        k, _, v = kv.partition("=")
        conf.put(k.strip(), _parse_value(v.strip()))
    return MatTrainRunner(conf, exps_root=os.path.join(tmp, name),
                          max_epochs=1)


def mat_adam(runner):
    """The runner's atlases made trainable, and Adam over them with a
    20-step staircase: (optimizer, scheduler)."""
    from texir_code_tpu_torch.train.exp import adam_staircase

    atlases = [runner.params.albedo, runner.params.roughness]
    for p in atlases:
        p.requires_grad_(True)
    return adam_staircase(atlases, runner.lr, 20, 0.8, 1)


def step_loss_grads(torch, model, params, mvp, pos, shift, gt, seg, room,
                    view, seg_weight_scale=1.0):
    """One stage-2 forward on a cached view + render_loss + backward:
    (loss, albedo grad, roughness grad, rgb)."""
    from texir_code_tpu_torch.models.losses import render_loss
    from texir_code_tpu_torch.models.material import MaterialParams

    d = model.device
    p = MaterialParams(params.albedo.detach().clone().requires_grad_(True),
                       params.roughness.detach().clone().requires_grad_(True))
    o = model._forward(p, mvp, pos, 2, view=view, spec_shift=shift)
    ones = torch.ones_like(o["rgb"][..., :1])
    loss, _ = render_loss(gt.to(d), o, ones, seg.to(d), 9, 2,
                          seg_region=ones, room_id=room.to(d), num_rooms=3,
                          seg_weight_scale=seg_weight_scale)
    loss.backward()
    return loss.item(), p.albedo.grad, p.roughness.grad, o["rgb"].detach()


def phase_fan_mat(torch, dev, path_mesh, tmp, syn):
    """Stage-2 steps of the apartment's Mat model with model.cluster_scene
    = None (the G-buffer on B2, the specular trace on B3) at the bench
    atlases, through the runner's step; then its G-buffer against the
    culled model's (equal but on exact-t ties, where the two traces pick
    either triangle of a shared edge and the uv rounds apart), and one
    step on the same cached view (as the runner caches it) against the
    culled model's with the same injected shifts: loss rel <= 1e-4,
    gradient rel L2 <= 1e-3 (the Mat correctness row)."""
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.ops.pallas_fan import fan_stream_cuda

    runner = mat_runner(torch, path_mesh, tmp, "exps_fan_mat")
    model = runner.model
    clusters = model.cluster_scene
    model.cluster_scene = None
    runner.build_masks()
    opt, sched = mat_adam(runner)
    fan_stream_cuda.launches.clear()
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    views, n_rooms = runner._stack_epoch_data(list(range(VIEWS)))
    runner._step(2, views[0], n_rooms, 0, opt, sched)
    torch.cuda.synchronize()
    t1 = time.time()
    for it in range(1, FAN_MAT_STEPS + 1):
        runner._step(2, views[it % len(views)], n_rooms, it, opt, sched)
    torch.cuda.synchronize()
    dt = time.time() - t1
    # the exact specular fetch (specular_fetch = "exact"): B3 in prim mode
    model.specular_fetch = "exact"
    for it in range(FAN_MAT_STEPS + 1, FAN_MAT_STEPS + 3):
        runner._step(2, views[it % len(views)], n_rooms, it, opt, sched)
    model.specular_fetch = "prefiltered"
    torch.cuda.synchronize()
    launches = dict(fan_stream_cuda.launches)
    walked = dict(culled_walk_cuda.launches)
    it = [FAN_MAT_STEPS + 3]

    def step():
        it[0] += 1
        runner._step(2, views[0], n_rooms, it[0], opt, sched)

    profile_once(torch, "fan-mat", "one cached-view stage-2 step", step)
    log(f"[fan-mat] stage-2 steps without a ClusterScene ({VIEWS} views, "
        f"albedo {ALBEDO_RES}^2, roughness {ROUGH_RES}^2, sample_light "
        f"[32, {SPEC_SPP}]): views + first step {t1 - t0:.3f} s, then "
        f"{FAN_MAT_STEPS} steps in {dt:.3f} s = {FAN_MAT_STEPS / dt:.3f} "
        f"it/s; fan_stream launches {launches}, culled_walk launches "
        f"{walked}")
    for mode in ("shared_prim", "per_ray_uv", "per_ray_prim"):
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"[fan-mat] fan_stream {mode} never launched")
    if walked:
        raise SystemExit("[fan-mat] the culled walk ran without a ClusterScene")

    # one step against the culled model's, the same inputs
    rng = np.random.default_rng(13)
    pos, mvp = bench_camera(syn)
    res = PANO[1] // 4
    b = 6 * res * res
    shift = torch.from_numpy(rng.uniform(0, 1, (b, 5)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1.5, (6, res, res, 3)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 8, (6, res, res)))
    room = torch.from_numpy(rng.integers(0, 3, (6, res, res)))
    view_f = model.precompute_view(runner.params, mvp, pos)
    model.cluster_scene = clusters
    view_c = model.precompute_view(runner.params, mvp, pos)
    uv_off = (view_f["uv"] != view_c["uv"]).any(-1)
    dpos = (view_f["position"] - view_c["position"]).abs().amax()
    log(f"[fan-mat]   G-buffer of view 0 vs the culled model's: uv not "
        f"bit-equal on {int(uv_off.sum())} of {uv_off.numel()} pixels (max "
        f"|duv| {float((view_f['uv'] - view_c['uv']).abs().max()):.3g}), "
        f"max |dposition| {float(dpos):.3g}")
    if uv_off.float().mean() > 1e-3 or dpos > 1e-4:
        raise SystemExit("[fan-mat] the FanScene-only G-buffer disagrees")

    def both():
        """(fan, culled) results of one step on view_c."""
        out = []
        for cs in (None, clusters):
            model.cluster_scene = cs
            out.append(step_loss_grads(torch, model, runner.params, mvp, pos,
                                       shift, gt, seg, room, view_c))
        return out

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    # on the card the default algorithms sum in an order that varies from
    # run to run (index_add's atomics, as in the seg prior's class means),
    # and on the runner's near-constant roughness the prior's L1 residuals
    # sit at their kink, so the roughness gradient follows that rounding:
    # the step is compared with deterministic algorithms (an op that has
    # none raises), and the default ones' run-to-run spread is logged
    # beside it, with and without the prior
    model.cluster_scene = clusters
    spread = []
    for w in (1.0, 0.0):  # with the seg prior, and without it
        r0, r1 = (step_loss_grads(torch, model, runner.params, mvp, pos,
                                  shift, gt, seg, room, view_c, w)[2]
                  for _ in range(2))
        spread.append(rel_l2(r0, r1))
    torch.use_deterministic_algorithms(True)
    try:
        (lf, af, rf, rgb_f), (lc, ac, rc, rgb_c) = both()
    finally:
        torch.use_deterministic_algorithms(False)
    px_off = int(((rgb_f - rgb_c).abs().amax(-1) > 0).sum())
    # the culled model's exact specular fetch: B1 in per_ray_prim mode
    model.specular_fetch = "exact"
    culled_walk_cuda.launches.clear()
    for n in range(it[0] + 1, it[0] + 3):
        runner._step(2, views[n % len(views)], n_rooms, n, opt, sched)
    torch.cuda.synchronize()
    model.specular_fetch = "prefiltered"
    launches["culled:per_ray_prim"] = culled_walk_cuda.launches["per_ray_prim"]
    log(f"[fan-mat]   2 stage-2 steps of the culled model with the exact "
        f"fetch: culled_walk launches {dict(culled_walk_cuda.launches)}")
    if launches["culled:per_ray_prim"] <= 0:
        raise SystemExit("[fan-mat] culled_walk per_ray_prim never launched")
    rel = abs(lf - lc) / abs(lc)
    ga, gr = rel_l2(af, ac), rel_l2(rf, rc)
    log(f"[fan-mat]   one step on that view vs the culled model's: loss "
        f"{lf:.7f} vs "
        f"{lc:.7f} (rel {rel:.3g}); gradient rel L2 albedo {ga:.3g}, "
        f"roughness {gr:.3g} (deterministic algorithms; with the default "
        f"ones the roughness gradient of one step against another varies "
        f"by rel L2 {spread[0]:.3g}, {spread[1]:.3g} without the seg "
        f"prior); rgb not bit-equal on {px_off} pixels")
    if not (rel <= 1e-4 and ga <= 1e-3 and gr <= 1e-3):
        raise SystemExit("[fan-mat] the FanScene-only step disagrees with "
                         "the culled one")
    return launches


def phase_error(torch, path_mesh, tmp, mat_exps):
    """`test --teststage Error` through the port's CLI on the apartment's
    export and the atlases [mat] wrote (configs/test_synthetic.conf:
    sample_light [1024, 256]; 4 views, pano 256x512, shade_chunk 4096);
    then one view with the FanScene-only model under the same draw,
    against the culled model's: rgb within 1e-4 on at least 99.9% of the
    pixels."""
    import ast
    import contextlib
    import io

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.eval.runners import MatErrorRunner
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.ops.pallas_fan import fan_stream_cuda

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "test_synthetic.conf")
    sets = [f"train.path_mesh_open3d={path_mesh}",
            f"train.pano_img_res=[{PANO[0]}, {PANO[1]}]"]
    argv = ["test", "--conf", conf, "--teststage", "Error", "--exps_folder",
            mat_exps]
    for kv in sets:
        argv += ["--set", kv]
    culled_walk_cuda.launches.clear()
    fan_stream_cuda.launches.clear()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("re-rendering error:")]
    log(f"[error] test --teststage Error via cli: {VIEWS} views at pano "
        f"{PANO[0]}x{PANO[1]}, sample_light {list(EVAL_SAMPLE_LIGHT)}, "
        f"shade_chunk {EVAL_CHUNK}: {dt:.2f} s with set-up = "
        f"{dt / VIEWS:.2f} s a view; {line[-1] if line else 'no metrics'}")
    log(f"[error]   culled_walk launches {launches}; fan_stream launches "
        f"{dict(fan_stream_cuda.launches)}")
    metrics = (ast.literal_eval(line[-1].partition(":")[2].strip())
               if line else {})
    vals = [metrics.get(k, float("nan")) for k in ("mse", "psnr", "ssim")]
    if not np.isfinite(vals).all():
        raise SystemExit("[error] the tester printed no finite metrics")
    for mode in ("shared_prim", "per_ray_uv"):
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"[error] culled_walk {mode} never launched")

    c = parse_file(conf)
    for kv in sets:
        k, _, v = kv.partition("=")
        c.put(k, _parse_value(v))
    runner = MatErrorRunner(c, exps_root=mat_exps)
    item = runner._default_dataset()[0]
    torch.cuda.synchronize()
    t1 = time.time()
    culled = runner._render(item)["rgb"]
    torch.cuda.synchronize()
    t_culled = time.time() - t1
    clusters = runner.model.cluster_scene
    runner.model.cluster_scene = None
    fan_stream_cuda.launches.clear()
    t2 = time.time()
    fan = runner._render(item)["rgb"]
    torch.cuda.synchronize()
    t_fan = time.time() - t2
    fan_launches = dict(fan_stream_cuda.launches)
    diff = (fan - culled).abs().amax(dim=-1)
    n_off = int((diff > 1e-4).sum())
    log(f"[error]   view 0 rendered by the FanScene-only model in "
        f"{t_fan:.2f} s (culled {t_culled:.2f} s; fan_stream launches "
        f"{fan_launches}): rgb max |diff| {float(diff.max()):.3g}, {n_off} "
        f"of {diff.numel()} pixels beyond 1e-4")
    if n_off > 1e-3 * diff.numel():
        raise SystemExit("[error] the FanScene-only render disagrees")
    profile_once(torch, "error", "one view's render, FanScene-only",
                 lambda: runner._render(item))
    runner.model.cluster_scene = clusters
    profile_once(torch, "error", "one view's render, culled",
                 lambda: runner._render(item))
    return vals


def phase_error_reference(torch, dev, syn):
    """One view's stage-2 eval render (EvalMaterialModel, shade_chunk 4096)
    on the card against the CPU at pano 64x128 with the full atlases,
    specular spp 16 and the same injected shifts: rgb rel L2 <= 1e-4."""
    from texir_code_tpu_torch.eval.renderer import EvalMaterialModel
    from texir_code_tpu_torch.models.material import MaterialParams

    rng = np.random.default_rng(14)
    irt = rng.uniform(0.5, 2.0, (1024, 1024, 3)).astype(np.float32)
    albedo = rng.uniform(0.2, 0.8, (ALBEDO_RES, ALBEDO_RES, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 0.7, (ROUGH_RES, ROUGH_RES, 1)).astype(np.float32)
    pos, mvp = bench_camera(syn)
    b = 6 * 32 * 32
    shift = torch.from_numpy(rng.uniform(0, 1, (b, 2)).astype(np.float32))
    rgb = {}
    for d in (dev, torch.device("cpu")):
        m = EvalMaterialModel(syn.mesh, syn.hdr_texture, irt,
                              pano_res=(64, 128), sample_light=(1024, 16),
                              render_knobs=dict(use_occluders=True), device=d)
        p = MaterialParams(torch.tensor(albedo, device=d),
                           torch.tensor(rough, device=d))
        with torch.no_grad():
            rgb[d.type] = m._forward(p, mvp, pos, 2,
                                     spec_shift=shift)["rgb"].cpu()
    rel = float((rgb["cuda"] - rgb["cpu"]).norm() / rgb["cpu"].norm())
    log(f"[error-reference] stage-2 eval render card vs cpu, pano 64x128, "
        f"atlases {ALBEDO_RES}^2/{ROUGH_RES}^2, shade_chunk {EVAL_CHUNK}: "
        f"rgb rel L2 {rel:.3g}")
    if not rel <= 1e-4:
        raise SystemExit("the eval render on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# the multi-room scan: bench.py's big scene through IrrT and Mat
# ---------------------------------------------------------------------------


def building_scene(torch, dev):
    """make_building_scene(atlas_res=256, subdiv=28) with its packed
    scenes at lb 4 (bake) and lb 8 (Mat), its occlusion proxies of the
    1024 and 512 largest triangles, and its occluders, on the card."""
    from texir_code_tpu_torch.data.synthetic import make_building_scene
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.geometry.occluders import extract_occluders
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

    t0 = time.time()
    syn = make_building_scene(atlas_res=256, subdiv=28)
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    b = dict(
        syn=syn,
        scenes={lb: ClusterScene.from_fan(fan, lb=lb, dense=True, device=dev)
                for lb in (LB, MAT_LB)},
        proxies={k: ClusterScene.proxy_from_fan(fan, k=k, device=dev)
                 for k in (BAKE_PROXY_K, MAT_PROXY_K)},
        occ=extract_occluders(syn.mesh, device=dev),
    )
    log(f"[building] {syn.mesh.num_faces} triangles; clusters: "
        f"{b['scenes'][LB].num_clusters} at lb {LB}, "
        f"{b['scenes'][MAT_LB].num_clusters} at lb {MAT_LB}; proxies "
        + ", ".join(f"k {k}: {p.num_clusters} clusters"
                    for k, p in b["proxies"].items())
        + f"; {b['occ'].num_occluders} occluders; built in "
        f"{time.time() - t0:.2f} s")
    return b


def check_agree(torch, label, a, b, emit_prim, rays=None):
    """Two hit records of the same rays on the card: `a` seeded or
    two-pass, `b` the single pass.  The rule of the kernel checks
    (compare_hits: no t mismatch beyond TOL, ties at most 1e-4 of the
    rays), except that a ray which `a` hits and `b` misses counts as a
    leak, allowed on at most max(2, 1e-6 · rays) rays (the readings: 4 of
    8,388,608 bake rays, 1 of 98,304 G-buffer rays, 0 specular).  A ray
    that `a` misses and `b` hits is a mismatch.  The first rays whose t is
    not bit-equal are logged, with their origins and directions when
    `rays` (per-row origins and directions) is given.

    Why leaks: the plane-dual test can reject both triangles of a shared
    edge, so a ray through that edge passes a wall (the building's views
    hit 99.98%) or, from a bake texel inside a clutter box (a top face
    whose normal points into the box), the box.  A proven occluder
    removes what lies behind it from a candidate list when every origin
    of the exit group lies in front of it, so what a leaking ray hits
    next depends on its group's lists: the proxy's clusters, or a pass-2
    group that also holds other rays, can keep a cluster that the
    single pass's list lost.  The JAX package's single pass misses such a
    ray too (tests/test_torch_leak.py holds it on the first logged ray)."""
    def tup(h):
        return (h.t, h.prim, h.u, h.v) if hasattr(h, "t") else tuple(h)

    a, b = tup(a), tup(b)
    err, ties, t_bad, prim_bad = compare_hits(a, b, emit_prim)
    ta = a[0].cpu().numpy().reshape(-1)
    tb = b[0].cpu().numpy().reshape(-1)
    leaks = int((np.isfinite(ta) & ~np.isfinite(tb)).sum())
    diff = np.flatnonzero(ta != tb)
    log(f"[building-kernels]   {label}: t mismatches {t_bad - leaks}, "
        f"leaks {leaks}, ties {ties} of {ta.size} rays; t not bit-equal on "
        f"{diff.size} rays")
    for i in diff[:4]:
        where = ""
        if rays is not None:
            o, d = rays
            row = i // d[0].shape[1]
            where = (f" from {[round(float(x[row]), 5) for x in o]} along "
                     f"{[round(float(x.reshape(-1)[i]), 5) for x in d]}")
        log(f"[building-kernels]     ray {i}: t {ta[i]} vs {tb[i]}{where}")
    if (t_bad > leaks or leaks > max(2, 1e-6 * ta.size)
            or ties > 1e-4 * ta.size):
        raise SystemExit(f"{label}: the hits disagree")


def phase_building_kernels(torch, dev, b):
    """Kernel B1 at the building's main-path shapes: one bake batch's
    wedge rows (fb 16, er 8, lb 4) unseeded and seeded by the k-1024
    proxy, the batch's two-pass trace and its pass-2 stragglers; one
    view's G-buffer and specular rays from the bench camera, seeded by the
    k-512 proxy, at lb 8."""
    from texir_code_tpu_torch.ops.gbuffer import (
        DeviceMesh,
        cube_mvp,
        ray_dirs_from_mvp,
    )
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled,
        cast_fans_culled_twopass,
        cull_blocks,
        culled_walk_cuda,
        twopass_stragglers,
        walk_args,
    )
    from texir_code_tpu_torch.ops.raycast import RayHit

    syn, occ = b["syn"], b["occ"]
    cs = b["scenes"][LB]
    pts, nrm, ids = bake_texels(syn, 4096)
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev)
    kw = dict(fan_block=BUILDING_FB, exit_rows=BUILDING_ER, emit_uv=True,
              occluders=occ)
    rows = {}
    rows["shared_uv@building"], hu = check_walk(
        torch, "building bake batch", walk_args(cs, rows_o, rows_d, **kw),
        plain_reps=0, name="culled_walk[shared_uv] building")
    seed = cast_fans_culled(b["proxies"][BAKE_PROXY_K], rows_o, rows_d, **kw)
    rows["shared_uv_seeded"], hs = check_walk(
        torch, f"building bake batch, proxy k {BAKE_PROXY_K}",
        walk_args(cs, rows_o, rows_d, seed=seed, **kw), plain_reps=0,
        name="culled_walk[shared_uv_seeded] building")
    check_agree(torch, "bake batch seeded vs unseeded", hs, hu, False,
                rays=(rows_o, rows_d))
    h2 = cast_fans_culled_twopass(cs, rows_o, rows_d, cut_frac=TWO_PASS_CUT,
                                  cap_frac=TWO_PASS_CAP, **kw)
    check_agree(torch, "bake batch two-pass vs single pass", h2, hu, False,
                rays=(rows_o, rows_d))

    # pass 2's stragglers exactly as cast_fans_culled_twopass forms them
    tp, r = rows_d[0].shape
    cull = cull_blocks(cs, rows_o, rows_o, rows_d, BUILDING_ER, occluders=occ)
    t1 = culled_walk_cuda(**walk_args(cs, rows_o, rows_d,
                                      t_cap_frac=TWO_PASS_CUT, cull=cull,
                                      **kw))[0]
    sel, cap_rows, n = twopass_stragglers(
        cs, t1, cull[1], cull[2], TWO_PASS_CUT, TWO_PASS_CAP, tp,
        BUILDING_FB, BUILDING_ER)
    log(f"[building-kernels] two-pass at cut {TWO_PASS_CUT}: {n} stragglers "
        f"of {tp * r} rays ({n / (tp * r):.4f}); capacity {cap_rows} rows "
        f"({cap_rows * r} rays){'; OVERFLOW' if n > cap_rows * r else ''}")
    o2 = tuple(a[sel // r].reshape(cap_rows, r) for a in rows_o)
    d2 = tuple(a.reshape(-1)[sel].reshape(cap_rows, r) for a in rows_d)
    b["pass2_rows"] = (o2, d2)
    rows["per_ray_uv@building"], _ = check_walk(
        torch, "building pass-2 stragglers",
        walk_args(cs, o2, d2, per_ray=True, **kw), plain_reps=0,
        name="culled_walk[per_ray_uv] building pass 2")

    # the Mat step's shapes from the bench camera, at lb 8
    cs8, proxy = b["scenes"][MAT_LB], b["proxies"][MAT_PROXY_K]
    pos = np.float32(BUILDING_CAM)
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    res = PANO[1] // 4
    flat = ray_dirs_from_mvp(cube_mvp(ext).to(dev), res).reshape(-1, 3)
    n_pix = flat.shape[0]
    width = min(2048, n_pix)  # rows as render_gbuffer cuts them
    while n_pix % width:
        width -= 128
    g_rows = n_pix // width
    d = tuple(flat[:, k].reshape(g_rows, width).contiguous() for k in range(3))
    cam = torch.as_tensor(pos, device=dev)
    o = tuple(cam[k].expand(g_rows).contiguous() for k in range(3))
    gkw = dict(fan_block=8, exit_rows=0, emit_prim=True, t_min=1e-6,
               occluders=occ)
    seed = cast_fans_culled(proxy, o, d, **gkw)
    rows["shared_prim_seeded"], hg = check_walk(
        torch, f"G-buffer of one view, proxy k {MAT_PROXY_K}",
        walk_args(cs8, o, d, seed=seed, **gkw), plain_reps=0,
        name="culled_walk[shared_prim_seeded] building")
    check_agree(torch, "G-buffer seeded vs unseeded", hg,
                culled_walk_cuda(**walk_args(cs8, o, d, **gkw)), True)
    hit = RayHit(*(a.reshape(-1) for a in hg))
    so, sd = specular_rows(torch, DeviceMesh.from_mesh(syn.mesh, dev), hit,
                           cam, dev)
    skw = dict(fan_block=8, exit_rows=1, per_ray=True, emit_uv=True,
               occluders=occ)
    seed = cast_fans_culled(proxy, so, sd, **skw)
    rows["per_ray_uv_seeded"], hsp = check_walk(
        torch, f"specular rays of one view, proxy k {MAT_PROXY_K}",
        walk_args(cs8, so, sd, seed=seed, **skw), plain_reps=0,
        name="culled_walk[per_ray_uv_seeded] building")
    check_agree(torch, "specular seeded vs unseeded", hsp,
                culled_walk_cuda(**walk_args(cs8, so, sd, **skw)), False)
    return rows


def building_cameras():
    """One camera per room centre (scripts/building_quality.py, without
    its novel view)."""
    return np.float32([[(i + 0.5) * ROOM_SIZE[0], 1.5, (j + 0.5) * ROOM_SIZE[2]]
                       for j in range(ROOMS[1]) for i in range(ROOMS[0])])


def phase_building_export(torch, syn, tmp):
    from texir_code_tpu_torch.data.export import export_reference_layout

    torch.cuda.synchronize()
    t0 = time.time()
    cams = building_cameras()
    path_mesh = export_reference_layout(
        syn, os.path.join(tmp, "building"), pano_res=PANO, cameras=cams,
        device="cuda")
    rooms = np.unique(syn.roomseg[5])
    log(f"[building-export] {len(cams)} room-centre views at pano "
        f"{PANO[0]}x{PANO[1]}, roomseg rooms {rooms.min()}..{rooms.max()}, "
        f"in {time.time() - t0:.2f} s")
    return path_mesh


def _building_irrt_argv(path_mesh, irt_res, tmp, name, extra=()):
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "irt_synthetic.conf")
    return [
        "train", "--conf", conf, "--trainstage", "IrrT",
        "--irt_res", str(irt_res),
        "--exps_folder", os.path.join(tmp, "exps_" + name),
        "--set", f"train.path_mesh_open3d={path_mesh}",
        "--set", f"train.sample_light=[{SPP}, 16]",
        "--set", f"train.bake_fan_block={BUILDING_FB}",
        "--set", f"train.bake_exit_rows={BUILDING_ER}",
        "--set", f"train.two_pass_cut={TWO_PASS_CUT}", *extra,
    ]


def run_building_irrt(torch, syn, path_mesh, irt_res, tmp, name, extra=()):
    """One IrrT stage through the port's CLI; (seconds, launches by mode,
    two-pass counts, raw bake, rays)."""
    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.models.tracer_irt import bake_geometry_textures
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled_twopass,
        culled_walk_cuda,
    )

    argv = _building_irrt_argv(path_mesh, irt_res, tmp, name, extra)
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    counts = dict(cast_fans_culled_twopass.counts)
    raw = hdrio.read_hdr(path_mesh.replace("out1.obj", "0_irr_texture.hdr"),
                         flip=True)
    valid = bake_geometry_textures(syn.mesh, irt_res).valid
    rays = int(valid.sum()) * SPP
    log(f"[{name}] IrrT via cli at {irt_res}^2 x {SPP} spp ({rays} rays): "
        f"stage {dt:.2f} s with set-up = {rays / dt / 1e6:.2f} Mrays/s; "
        f"launches {launches}; two-pass traces {counts.get('calls', 0)}, "
        f"overflowed {counts.get('overflows', 0)}")
    if not (np.isfinite(raw).all() and raw[valid].mean() > 0):
        raise SystemExit(f"[{name}] the bake is black or non-finite")
    return dt, launches, counts, raw, rays


def _need_modes(phase, launches, modes):
    for mode in modes:
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"[{phase}] culled_walk {mode} never launched")


def phase_building_proxy(torch, syn, path_mesh, tmp):
    """The building's IrrT at --irt_res 256 without and with the occlusion
    proxy: the raw bakes must be equal (seeding is exact)."""
    _, l0, _, raw0, _ = run_building_irrt(
        torch, syn, path_mesh, PROXY_IRT_RES, tmp, "building-proxy")
    _need_modes("building-proxy", l0, ("shared_uv", "per_ray_uv"))
    _, l1, _, raw1, rays = run_building_irrt(
        torch, syn, path_mesh, PROXY_IRT_RES, tmp, "building-proxy",
        ["--set", f"train.bake_proxy_k={BAKE_PROXY_K}"])
    _need_modes("building-proxy", l1, ("shared_uv", "shared_uv_seeded",
                                       "per_ray_uv", "per_ray_uv_seeded"))
    n_diff = int((raw0 != raw1).any(axis=-1).sum())
    texels = rays // SPP
    log(f"[building-proxy] raw bakes without / with the k-{BAKE_PROXY_K} "
        f"proxy: {n_diff} of {texels} baked texels differ, max |diff| "
        f"{float(np.abs(raw0 - raw1).max()):.3g}")
    # seeding is exact; only a ray that leaks through a triangle edge
    # (check_agree) could move a texel, and the run is deterministic, so
    # no texel may differ
    if n_diff:
        raise SystemExit("[building-proxy] the proxy changed the bake")
    return l1


def phase_building_slice(torch, syn, path_mesh, tmp):
    """bench.py's big-scene bake through the port's CLI: --irt_res 1024,
    2048 spp, fb 16, er 8, two-pass 0.25, occluders on."""
    from texir_code_tpu_torch.data import hdrio

    dt, launches, counts, _, rays = run_building_irrt(
        torch, syn, path_mesh, IRT_RES, tmp, "building-slice")
    _need_modes("building-slice", launches, ("shared_uv", "per_ray_uv"))
    irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "irt.hdr"), flip=True)
    if irt.shape != (IRT_RES, IRT_RES, 3) or not np.isfinite(irt).all():
        raise SystemExit("[building-slice] irt.hdr is wrong")
    return launches, counts


def phase_building_mat(torch, path_mesh, tmp):
    """`train --trainstage Mat --max_epochs 1` on the building at the
    apartment phase's settings, with the k-512 proxy and the two-pass
    specular trace."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled_twopass,
        culled_walk_cuda,
    )

    conf, sets = _mat_conf(path_mesh, PANO)
    exps = os.path.join(tmp, "exps_building_mat")
    argv = ["train", "--conf", conf, "--trainstage", "Mat", "--max_epochs",
            "1", "--exps_folder", exps] + sets + [
        "--set", f"models.render.proxy_k={MAT_PROXY_K}",
        "--set", f"models.render.spec_two_pass_cut={TWO_PASS_CUT}"]
    culled_walk_cuda.launches.clear()
    cast_fans_culled_twopass.counts.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    counts = dict(cast_fans_culled_twopass.counts)
    (tpath,) = glob.glob(os.path.join(exps, "Mat-default", "*", "timings.json"))
    with open(tpath) as f:
        tm = json.load(f)
    log(f"[building-mat] Mat via cli: {len(building_cameras())} views, proxy "
        f"k {MAT_PROXY_K}, two-pass {TWO_PASS_CUT}: stage {dt:.2f} s with "
        f"set-up (set-up {tm['setup_s']:.2f} s, masks {tm['masks_s']:.2f} s, "
        f"save {tm['save_s']:.2f} s)")
    for k in range(3):
        sub = tm[f"substage{k}"]
        rest = (sub["step_s"] - sub["first_step_s"]) / max(1, sub["steps"] - 1)
        log(f"[building-mat]   substage {k}: {sub['steps']} steps, "
            f"{sub['it_per_s']:.3f} it/s (after the first step "
            f"{1 / rest:.3f} it/s); views {sub['views_s']:.3f} s; last loss "
            f"{sub['last_loss']:.6f}")
    log(f"[building-mat]   launches {launches}; two-pass traces "
        f"{counts.get('calls', 0)}, overflowed {counts.get('overflows', 0)}; "
        f"re-render psnr {tm['metrics']['psnr']:.4f}")
    _need_modes("building-mat", launches, (
        "shared_prim", "shared_prim_seeded", "per_ray_uv", "per_ray_uv_seeded"))
    losses = [tm[f"substage{k}"]["last_loss"] for k in range(3)]
    if not np.isfinite(losses + list(tm["metrics"].values())).all():
        raise SystemExit("[building-mat] non-finite losses or metrics")
    return launches


def phase_building_profile(torch, dev, b, path_mesh, tmp):
    """One two-pass bake batch (4096 texels) and one cached-view stage-2
    step of the building under torch.profiler; the step with the knobs
    off, with the two-pass trace only and with the proxy only."""
    from torch.profiler import ProfilerActivity, profile

    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.ops.pallas_culled import cull_blocks
    from texir_code_tpu_torch.train.material import MatTrainRunner

    def profiled(label, fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern, launches = profile_kernels(prof)
        busy = sum(kern.values())
        walk = sum(v for k, v in kern.items() if "culled_walk" in k)
        sync = profile_cpu_ms(prof, "aten::_local_scalar_dense")
        log(f"[building-profile] {label}: wall {wall_ms:.2f} ms "
            f"(unprofiled); {launches} kernel launches, {busy:.2f} ms on "
            f"the card (culled_walk {walk:.2f} ms); idle share "
            + (f"{max(0.0, 1 - busy / wall_ms):.3f}" if busy else
               "not measured")
            + f"; host waits in device-to-host reads {sync:.2f} ms")
        for name, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:4]:
            log(f"[building-profile]   {ms:9.3f} ms  {name[:90]}")
        return busy

    baker = make_baker(torch, b["syn"], b["scenes"][LB], b["occ"], dev,
                       building=True)
    pts, nrm, ids = bake_texels(b["syn"], 4096)
    args = (torch.from_numpy(pts).to(dev), torch.from_numpy(nrm).to(dev),
            torch.from_numpy(ids).to(dev), 99)
    busy = profiled("two-pass bake batch, 4096 texels x 2048 spp",
                    lambda: baker.bake_batch(*args))
    # the culling's share, measured: the batch's two cull_blocks calls
    # (pass 1 over its rows, pass 2 over the straggler capacity) profiled
    # alone at the same shapes
    cs, occ = b["scenes"][LB], b["occ"]
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 99, dev)
    o2, d2 = b["pass2_rows"]
    lo2 = tuple(a.amin(dim=1) for a in o2)
    hi2 = tuple(a.amax(dim=1) for a in o2)
    cull = profiled("cull_blocks of pass 1 and pass 2, alone", lambda: (
        cull_blocks(cs, rows_o, rows_o, rows_d, BUILDING_ER, occluders=occ),
        cull_blocks(cs, lo2, hi2, d2, BUILDING_ER, occluders=occ)))
    log(f"[building-profile] culling: {cull:.2f} of the two-pass batch's "
        f"{busy:.2f} ms on the card = {cull / busy:.3f}")

    conf_path, sets = _mat_conf(path_mesh, PANO)
    conf = parse_file(conf_path)
    for kv in sets[1::2]:
        k, _, v = kv.partition("=")
        conf.put(k.strip(), _parse_value(v.strip()))
    runner = MatTrainRunner(conf, exps_root=os.path.join(tmp, "exps_bprof"),
                            max_epochs=1)
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data([0])
    opt, sched = mat_adam(runner)
    model = runner.model
    proxy = b["proxies"][MAT_PROXY_K]
    it = [0]

    def step():
        it[0] += 1
        return runner._step(2, views[0], n_rooms, it[0], opt, sched)

    for label, cut, px in (("knobs off", None, None),
                           (f"two-pass {TWO_PASS_CUT} only", TWO_PASS_CUT,
                            None),
                           (f"proxy k {MAT_PROXY_K} only", None, proxy)):
        model.spec_two_pass_cut, model.proxy_scene = cut, px
        profiled(f"stage-2 step, 1 cached view, {label}", step)


def phase_building_reference(torch, dev, b):
    """The two-pass + proxy bake_batch on the card against the CPU on 64
    building texels (the bake tolerance of PERF.md section 2)."""
    pts, nrm, ids = bake_texels(b["syn"], 64)
    out = []
    for d in (dev, torch.device("cpu")):
        baker = make_baker(torch, b["syn"], b["scenes"][LB], b["occ"], d,
                           building=True,
                           proxy=b["proxies"][BAKE_PROXY_K])
        e = baker.bake_batch(
            torch.from_numpy(pts).to(d), torch.from_numpy(nrm).to(d),
            torch.from_numpy(ids).to(d), 4242,
        )
        out.append(e.cpu().numpy())
    rel = np.abs(out[0] - out[1]) / np.maximum(np.abs(out[1]), 1e-3)
    log(f"[building-reference] two-pass + proxy bake_batch card vs cpu, 64 "
        f"texels: max rel {rel.max():.3g}, texels above 1e-4: "
        f"{(rel > 1e-4).sum()}")
    # the apartment's rule (phase_reference)
    if (rel > 1e-4).mean() > 0.02 or rel.max() > 0.05:
        raise SystemExit("building bake_batch on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# the sampler's segment-sum backward: kernel S (the scatter-accumulator of
# the JAX harnesses S1/S2), its harness, and the Mat step with the switch;
# then the editing, novel-view and relighting testers
# ---------------------------------------------------------------------------


def _scatter_row(name, mode, replaces, row, launches):
    """The kernels-line row of kernel S in `mode` ('acc' or 'acc_sorted')
    at one harness row's shape."""
    v = row[mode]
    return dict(name=name, route="cuda", source=SCATTER_SOURCE,
                replaces=replaces, launches=launches,
                max_abs_err=v["max_abs_err"], ms=v["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by="bytes", library_ms=row["index_add"]["ms"])


def bench_view(torch, dev, syn):
    """The bench apartment's Mat model (pano 256x512, sample_light [32,
    16], lb 8, occluders), the bench atlases and camera 0's cached view."""
    from texir_code_tpu_torch.models.material import (
        MaterialModel,
        init_material_params,
    )

    model = MaterialModel(
        syn.mesh, syn.hdr_texture, np.maximum(syn.hdr_texture, 0.1),
        pano_res=PANO, sample_light=(32, SPEC_SPP), cluster_lb=MAT_LB,
        render_knobs=dict(use_occluders=True), device=dev)
    params = init_material_params(ALBEDO_RES, ROUGH_RES, device=dev)
    pos, mvp = bench_camera(syn)
    return model, params, model.precompute_view(params, mvp, pos)


def phase_sampler_kernels(torch, dev, syn):
    """The harness (texir_code_tpu_torch/scripts/sampler_bwd_variants.py)
    on the card: the JAX harnesses' rows (786,432 taps at each (S, C)) and
    the Mat rows (the flat albedo and roughness pyramids with the 8
    exact-trilinear taps of each pixel of camera 0's view).  Kernel S in
    both modes against scatter_accumulate_plain and against index_add_:
    every element within the order bound, 2·γ(k-1)·Σ|g| over its k taps
    (sampler_bwd_variants.order_bound: the most two float32 sums of the
    same taps in different orders can differ by; an element of one tap
    exactly).  A share of Σ|g| alone cannot be the limit: index_add_
    against index_add_ (the plain version) differs by 1.42e-06 of Σ|g| on
    the Mat albedo row, whose coarse-level texels take thousands of
    taps."""
    from texir_code_tpu_torch.ops.scatter_acc import scatter_accumulate_cuda
    from texir_code_tpu_torch.scripts import sampler_bwd_variants as H

    _, _, view = bench_view(torch, dev, syn)
    scatter_accumulate_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    rows = H.script_rows(dev, H.N_TAPS, reps=5)
    rows += H.mat_rows(view["uv"], view["lod_a"], view["lod_r"], reps=5,
                       albedo_res=ALBEDO_RES, rough_res=ROUGH_RES)
    torch.cuda.synchronize()
    launches = dict(scatter_accumulate_cuda.launches)
    log(f"[sampler-kernels] harness rows in {time.time() - t0:.1f} s; "
        f"scatter_acc launches {launches}")
    worst = 0.0
    for row in rows:
        log(f"[sampler-kernels] {row['label']}: S={row['rows']} "
            f"C={row['channels']} N={row['taps']}: bound_ms "
            f"{row['bound_ms']:.4f}, plain_ms {row['plain_ms']:.4f}, sort "
            f"(apart from acc_sorted) {row['sort_ms']:.4f} ms")
        for name in H.VARIANTS:
            v = row[name]
            log(f"[sampler-kernels]   {name:11s} {v['ms']:9.4f} ms  max abs "
                f"err {v['max_abs_err']:.3g}; err / row sum|g| "
                f"{v['err_over_abs_sum']:.3g} vs plain, "
                f"{v['err_over_abs_sum_vs_index_add']:.3g} vs index_add_; "
                f"err / order bound {v['err_over_bound']:.3g} vs plain, "
                f"{v['err_over_bound_vs_index_add']:.3g} vs index_add_")
        for name in ("acc", "acc_sorted"):
            worst = max(worst, row[name]["err_over_bound"],
                        row[name]["err_over_bound_vs_index_add"])
    log(f"[sampler-kernels] kernel S worst error / order bound: {worst:.3g} "
        f"(limit 1)")
    if worst > 1:
        raise SystemExit("[sampler-kernels] kernel S disagrees with its "
                         "plain version or index_add_")
    for mode in ("unsorted", "sorted"):
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"[sampler-kernels] scatter_acc {mode} never "
                             f"launched by the harness")
    # the sorted mode is deterministic: two runs on the Mat albedo row's
    # taps give the same bits
    idx, s = H.view_taps(view["uv"], view["lod_a"], ALBEDO_RES, 3)
    g = torch.from_numpy(np.random.default_rng(17).random(
        (idx.shape[0], 3), dtype=np.float32)).to(dev)
    idx_s, g_s = H.sort_taps(idx, g)
    runs = [scatter_accumulate_cuda(idx_s, g_s, s, presorted=True)
            for _ in range(2)]
    same = torch.equal(runs[0], runs[1])
    log(f"[sampler-kernels] kernel S sorted, two runs on the Mat albedo "
        f"row: bit-equal {same}")
    if not same:
        raise SystemExit("[sampler-kernels] kernel S sorted is not "
                         "deterministic")
    albedo = next(r for r in rows if r["label"].startswith("Mat albedo"))
    return {
        "unsorted": _scatter_row("scatter_acc[unsorted]", "acc", S1_REPLACES,
                                 albedo, launches["unsorted"]),
        "sorted": _scatter_row("scatter_acc[sorted]", "acc_sorted",
                               S2_REPLACES, albedo, launches["sorted"]),
    }


def _scatter_kernels_ms(kern):
    """(index_put_ ms, kernel S ms, sort ms) of a profile's kernels by
    name: every gather backward's index_put_ scatter (the sampler's with
    the switch off, and the seg prior's: its per-room class means gathered
    back to the 98,304 pixels, 27 rows), kernel S, and every sort (the
    segment-sum backward's, the culling's)."""
    index_put = sum(v for k, v in kern.items()
                    if "index_put" in k or "indexing_backward" in k)
    acc = sum(v for k, v in kern.items() if "scatter_sorted" in k
              or "scatter_unsorted" in k)
    sort = sum(v for k, v in kern.items() if "sort" in k.lower())
    return index_put, acc, sort


def phase_mat_segsum(torch, dev, path_mesh, tmp, syn):
    """The apartment's stage-2 step at the bench's width with the sampler's
    segment-sum backward off and on (ops.texture.SEGSUM_BACKWARD), in exact
    trilinear mode and with the bench's stochastic knobs: one step on
    camera 0's cached view with the same injected uniforms under
    deterministic algorithms — the loss bit-equal, the albedo and
    roughness gradients within relative L2 1e-5 (the order of the
    additions) — then timed runner steps and one profiled step each."""
    from torch.profiler import ProfilerActivity, profile

    from texir_code_tpu_torch.ops import texture
    from texir_code_tpu_torch.ops.scatter_acc import scatter_accumulate_cuda

    runner = mat_runner(torch, path_mesh, tmp, "exps_segsum")
    model = runner.model
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data([0])
    opt, sched = mat_adam(runner)
    rng = np.random.default_rng(15)
    pos, mvp = bench_camera(syn)
    res = PANO[1] // 4
    b = 6 * res * res
    shift = torch.from_numpy(rng.uniform(0, 1, (b, 5)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1.5, (6, res, res, 3)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 8, (6, res, res)))
    room = torch.from_numpy(rng.integers(0, 3, (6, res, res)))
    view = model.precompute_view(runner.params, mvp, pos)
    modes = (("exact", 2, False), ("stochastic", 5, True))

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    launches = 0
    it = 0
    for mode, cols, stochastic in modes:
        out = {}
        torch.use_deterministic_algorithms(True)
        try:
            for on in (False, True):
                texture.SEGSUM_BACKWARD = on
                try:
                    out[on] = step_loss_grads(torch, model, runner.params,
                                              mvp, pos, shift[:, :cols], gt,
                                              seg, room, view)
                finally:
                    texture.SEGSUM_BACKWARD = False
        finally:
            torch.use_deterministic_algorithms(False)
        (l0, a0, r0, _), (l1, a1, r1, _) = out[False], out[True]
        ga, gr = rel_l2(a1, a0), rel_l2(r1, r0)
        log(f"[mat-segsum] {mode}: one stage-2 step, segment-sum backward "
            f"on vs off (deterministic algorithms): loss {l1!r} vs {l0!r} "
            f"(bit-equal: {l1 == l0}); gradient rel L2 albedo {ga:.3g}, "
            f"roughness {gr:.3g}")
        if not (l1 == l0 and ga <= 1e-5 and gr <= 1e-5):
            raise SystemExit(f"[mat-segsum] {mode}: the segment-sum backward "
                             f"changes the step")
        # the runner's steps, as training runs them (default algorithms)
        model.mip_stochastic = model.bilinear_stochastic = stochastic
        for on in (False, True):
            texture.SEGSUM_BACKWARD = on
            try:
                runner._step(2, views[0], n_rooms, it, opt, sched)
                torch.cuda.synchronize()
                scatter_accumulate_cuda.launches.clear()
                t0 = time.time()
                for _ in range(SEGSUM_STEPS):
                    it += 1
                    runner._step(2, views[0], n_rooms, it, opt, sched)
                torch.cuda.synchronize()
                wall = (time.time() - t0) * 1e3 / SEGSUM_STEPS
                per_step = (sum(scatter_accumulate_cuda.launches.values())
                            / SEGSUM_STEPS)
                if on:
                    launches += sum(scatter_accumulate_cuda.launches.values())
                    if scatter_accumulate_cuda.launches["sorted"] <= 0:
                        raise SystemExit("[mat-segsum] scatter_acc sorted "
                                         "never launched")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    it += 1
                    runner._step(2, views[0], n_rooms, it, opt, sched)
                    torch.cuda.synchronize()
            finally:
                texture.SEGSUM_BACKWARD = False
            kern, n_launch = profile_kernels(prof)
            busy = sum(kern.values())
            put, acc, srt = _scatter_kernels_ms(kern)
            log(f"[mat-segsum] {mode}, segment-sum {'on ' if on else 'off'}: "
                f"step wall {wall:.2f} ms ({1e3 / wall:.2f} it/s, "
                f"{SEGSUM_STEPS} steps); profiled step: {n_launch} launches, "
                f"{busy:.2f} ms on the card (idle "
                f"{max(0.0, 1 - busy / wall):.3f}); index_put_ scatters "
                f"{put:.3f} ms, kernel S {acc:.3f} ms, sorts {srt:.3f} ms; "
                f"scatter_acc launches a step {per_step:g}")
    model.mip_stochastic = model.bilinear_stochastic = True
    return launches


def _tester_argv(stage, path_mesh, mat_exps, extra=()):
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "test_synthetic.conf")
    argv = ["test", "--conf", conf, "--teststage", stage, "--exps_folder",
            mat_exps, "--set", f"train.path_mesh_open3d={path_mesh}",
            "--set", f"train.pano_img_res=[{PANO[0]}, {PANO[1]}]"]
    return argv + list(extra)


def _run_tester(torch, stage, argv, frames, walk_modes):
    """One `test` stage through the port's CLI: seconds, B1 launches (every
    mode in walk_modes must run) and its frames (finite, not black)."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    exps = argv[argv.index("--exps_folder") + 1]
    files = sorted(glob.glob(os.path.join(exps, f"{stage}-default", "*",
                                          "plots", "*.hdr")))
    imgs = [hdrio.read_hdr(f) for f in files]
    log(f"[testers] test --teststage {stage} via cli: {len(files)} frames "
        f"in {dt:.2f} s with set-up = {dt / max(1, len(files)):.2f} s a "
        f"frame; culled_walk launches {launches}; frame means "
        f"{[round(float(i.mean()), 5) for i in imgs]}")
    if len(files) != frames:
        raise SystemExit(f"[testers] {stage} wrote {len(files)} frames, "
                         f"expected {frames}")
    if not all(np.isfinite(i).all() and i.max() > 0 for i in imgs):
        raise SystemExit(f"[testers] {stage} wrote a non-finite or black frame")
    for mode in walk_modes:
        if launches.get(mode, 0) <= 0:
            raise SystemExit(f"[testers] culled_walk {mode} never launched "
                             f"in {stage}")
    return dt, launches


def phase_testers(torch, syn, path_mesh, mat_exps):
    """The editing, novel-view and relighting testers through the port's
    CLI on the apartment's export and [mat]'s atlases, with the scene's
    seg atlas as 0_seg_gray.png (configs/test_synthetic.conf: sample_light
    [1024, 256], pano 256x512, shade_chunk 4096): Editing with a
    test.editing block (seg class 2's albedo over two keyframe segments,
    class 5's roughness over one, on view 0: 5 frames), View --num_frames
    4, Relighting --relight_mode emitter on the 4 views.  Then an unedited
    Editing frame against the Error tester's render of the same view
    (bit-equal), and one relit view under torch.profiler."""
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.eval.runners import (
        MatEditingRunner,
        MatErrorRunner,
    )

    hdrio.write_png(path_mesh.replace("out1.obj", "0_seg_gray.png"),
                    syn.seg_texture[::-1].astype(np.uint8))
    editing = ["--set", "test.editing.classes=[2, 5]",
               "--set", "test.editing.views=[0]",
               "--set", "test.editing.frames_per_segment=2",
               "--set", "test.editing.albedo_2=[[0.9, 0.1, 0.1], "
                        "[0.1, 0.9, 0.1], [0.1, 0.1, 0.9]]",
               "--set", "test.editing.roughness_5=[0.05, 0.6]"]
    out = {}
    out["Editing"] = _run_tester(
        torch, "Editing", _tester_argv("Editing", path_mesh, mat_exps,
                                       editing), 5,
        ("shared_prim", "per_ray_uv"))
    out["View"] = _run_tester(
        torch, "View", _tester_argv("View", path_mesh, mat_exps,
                                    ["--num_frames", "4"]), 4,
        ("shared_prim", "per_ray_uv"))
    out["Relighting"] = _run_tester(
        torch, "Relighting", _tester_argv("Relighting", path_mesh, mat_exps,
                                          ["--relight_mode", "emitter"]),
        VIEWS, ("shared_prim", "per_ray_prim"))

    argv = _tester_argv("Error", path_mesh, mat_exps)
    conf = parse_file(argv[argv.index("--conf") + 1])
    for kv in argv[argv.index("--set"):][1::2]:
        k, _, v = kv.partition("=")
        conf.put(k, _parse_value(v))
    ed = MatEditingRunner(conf, exps_root=mat_exps)
    (frame,) = ed.run(edits={}, num_frames=1, views=[0])
    err = MatErrorRunner(conf, exps_root=mat_exps)
    ref = err._render(err._default_dataset()[0])["rgb"].cpu().numpy()
    n_off = int((frame != ref).any(-1).sum())
    log(f"[testers] unedited Editing frame of view 0 vs the Error tester's "
        f"render (seed {err.draw_seed(0)}): {n_off} of "
        f"{frame.shape[0] * frame.shape[1] * frame.shape[2]} pixels not "
        f"bit-equal")
    if n_off:
        raise SystemExit("[testers] the unedited Editing frame differs from "
                         "the Error render")
    item = ed._default_dataset()[0]

    def relit():
        with torch.no_grad():
            return ed.model.forward_relit(ed.params, item["cam_to_world"],
                                          item["cam_position"],
                                          seed=ed.draw_seed(0))

    profile_once(torch, "testers", "one relit view (sample_light "
                 f"{list(EVAL_SAMPLE_LIGHT)})", relit)
    return out


def phase_relit_reference(torch, dev, syn):
    """One view's relit render (EvalMaterialModel.forward_relit,
    shade_chunk 4096) on the card against the CPU at pano REF_PANO with the
    full atlases, sample_light RELIT_REF_LIGHT and the same injected
    uniforms: rgb rel L2 <= 1e-4."""
    from texir_code_tpu_torch.eval.renderer import EvalMaterialModel
    from texir_code_tpu_torch.models.material import MaterialParams

    rng = np.random.default_rng(16)
    irt = rng.uniform(0.5, 2.0, (1024, 1024, 3)).astype(np.float32)
    albedo = rng.uniform(0.2, 0.8, (ALBEDO_RES, ALBEDO_RES, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 0.7, (ROUGH_RES, ROUGH_RES, 1)).astype(np.float32)
    pos, mvp = bench_camera(syn)
    res = REF_PANO[1] // 4
    shift = torch.from_numpy(rng.uniform(0, 1, (6 * res * res, 4)).astype(np.float32))
    rgb, secs = {}, {}
    for d in (dev, torch.device("cpu")):
        m = EvalMaterialModel(syn.mesh, syn.hdr_texture, irt,
                              pano_res=REF_PANO, sample_light=RELIT_REF_LIGHT,
                              render_knobs=dict(use_occluders=True), device=d)
        m.draw_relit_shift = lambda seed, b: shift
        p = MaterialParams(torch.tensor(albedo, device=d),
                           torch.tensor(rough, device=d))
        t0 = time.time()
        with torch.no_grad():
            rgb[d.type] = m.forward_relit(p, mvp, pos)["rgb"].cpu()
        secs[d.type] = time.time() - t0
    rel = float((rgb["cuda"] - rgb["cpu"]).norm() / rgb["cpu"].norm())
    log(f"[relit-reference] relit render card vs cpu, pano "
        f"{REF_PANO[0]}x{REF_PANO[1]}, "
        f"sample_light {list(RELIT_REF_LIGHT)}, atlases {ALBEDO_RES}^2/"
        f"{ROUGH_RES}^2: rgb rel L2 {rel:.3g} (card {secs['cuda']:.2f} s, "
        f"cpu {secs['cpu']:.2f} s)")
    if not rel <= 1e-4:
        raise SystemExit("the relit render on the card disagrees with the CPU")



def _kernel_counters():
    """Every hand-written kernel's launch counter (B1, B2/B3, S)."""
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.ops.pallas_fan import fan_stream_cuda
    from texir_code_tpu_torch.ops.scatter_acc import scatter_accumulate_cuda

    return {"culled_walk": culled_walk_cuda.launches,
            "fan_stream": fan_stream_cuda.launches,
            "scatter_acc": scatter_accumulate_cuda.launches}


def _mat_atlases(mat_exps):
    """The albedo and roughness atlas files of [mat]'s newest run."""
    import glob

    plots = sorted(glob.glob(os.path.join(mat_exps, "Mat-default", "*",
                                          "plots")))[-1]
    return tuple(sorted(glob.glob(os.path.join(plots, f"mat_{k}_*.hdr")))[-1]
                 for k in ("albedo", "roughness"))


def phase_pathtrace(torch, path_mesh, mat_exps):
    """`test --teststage Relighting --relight_mode pathtrace` through the
    port's CLI at the JAX CLI's defaults (pano 64x128, spp 16, 3 bounces,
    a quad light under each of the 4 cameras) on the apartment's export and
    [mat]'s atlases: seconds a frame, casts a view, rays a cast, the
    traversal's iterations and host syncs; every frame finite and lit; no
    hand-written kernel on this path (the traversal is plain PyTorch).
    Then one view at 1 bounce under torch.profiler."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.eval.path_tracer import PathTracedMaterialModel

    render_pano, views = PathTracedMaterialModel.render_pano, []

    def timed_render_pano(self, cam_position, res, seed=0, **kw):
        n0 = len(self.casts)
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_pano(self, cam_position, res, seed, **kw)
        views.append(dict(tracer=self, cam=cam_position, seed=seed,
                          s=time.time() - t0, casts=self.casts[n0:]))
        return img

    counters = _kernel_counters()
    for c in counters.values():
        c.clear()
    argv = _tester_argv("Relighting", path_mesh, mat_exps,
                        ["--relight_mode", "pathtrace"])
    PathTracedMaterialModel.render_pano = timed_render_pano
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        cli.main(argv)
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        PathTracedMaterialModel.render_pano = render_pano
    launched = {k: sum(c.values()) for k, c in counters.items()}
    files = sorted(glob.glob(os.path.join(
        mat_exps, "Relighting-default", "*", "plots", "pt_relit_*.hdr")))
    imgs = [hdrio.read_hdr(f) for f in files]
    log(f"[pathtrace] test --teststage Relighting --relight_mode pathtrace "
        f"via cli: {len(files)} frames at {PT_PANO[0]}x{PT_PANO[1]}, spp "
        f"{PT_SPP}, {PT_BOUNCES} bounces, {len(views)} lights, in {dt:.2f} s "
        f"with set-up = {dt / max(1, len(files)):.3f} s a frame; frame means "
        f"{[round(float(i.mean()), 5) for i in imgs]}")
    for i, v in enumerate(views):
        c = v["casts"]
        log(f"[pathtrace]   view {i}: {v['s']:.3f} s, {len(c)} casts of "
            f"{sorted({x['rays'] for x in c})} rays, iterations "
            f"{[x['iterations'] for x in c]}, host syncs "
            f"{[x['syncs'] for x in c]}, compactions "
            f"{[x['compactions'] for x in c]}")
    log(f"[pathtrace]   hand-written kernel launches on this path: "
        f"{launched}")
    if len(files) != VIEWS or len(views) != VIEWS:
        raise SystemExit(f"[pathtrace] {len(files)} frames and {len(views)} "
                         f"views, expected {VIEWS}")
    if not all(i.shape == PT_PANO + (3,) and np.isfinite(i).all()
               and i.max() > 0 for i in imgs):
        raise SystemExit("[pathtrace] a frame is misshapen, non-finite or "
                         "black")
    if any(len(v["casts"]) != 2 * PT_BOUNCES for v in views):
        raise SystemExit("[pathtrace] a view took other than one path and "
                         "one shadow cast a bounce")
    # the profiler's reading grows with the launches: one bounce (a path
    # and a shadow cast, a third of a view's) keeps it to seconds
    v = views[0]
    tracer = v["tracer"]
    bounces, tracer.max_bounces = tracer.max_bounces, 1
    t0 = time.time()
    try:
        profile_once(torch, "pathtrace",
                     f"one view at 1 bounce ({PT_SPP} spp in one cast)",
                     lambda: tracer.render_pano(v["cam"], PT_PANO, v["seed"]))
    finally:
        tracer.max_bounces = bounces
    log(f"[pathtrace]   profile taken and read in {time.time() - t0:.1f} s")


def phase_pathtrace_reference(torch, dev, path_mesh, mat_exps):
    """One trace of a band of view 0's pixels (rows PT_BAND of the 64x128
    pano, PT_BAND_SPP samples, 3 bounces, a light under each camera) on the
    card and on the CPU from the same draws: radiance rel L2 <= 1e-4."""
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.data.datasets import ImageCubeDerived
    from texir_code_tpu_torch.data.export import pano_dirs
    from texir_code_tpu_torch.eval.path_tracer import (
        PathTracedMaterialModel,
        light_under_camera,
    )
    from texir_code_tpu_torch.geometry import load_obj
    from texir_code_tpu_torch.train.exp import draw_seed

    ds = ImageCubeDerived(path_mesh, resolution=PANO)
    cams = [ds[i]["cam_position"] for i in range(len(ds))]
    albedo, rough = (hdrio.read_hdr(f) for f in _mat_atlases(mat_exps))
    d = pano_dirs(*PT_PANO)[PT_BAND[0]:PT_BAND[1]].reshape(-1, 3)
    d = np.tile(d, (PT_BAND_SPP, 1))
    b = d.shape[0]
    mesh = load_obj(path_mesh)
    out, secs = [], []
    for dv in (dev, torch.device("cpu")):
        tr = PathTracedMaterialModel(
            mesh, albedo, rough[..., 0:1],
            [light_under_camera(c) for c in cams], max_bounces=PT_BOUNCES,
            spp=PT_BAND_SPP, device=dv)
        draws = tr.draws(draw_seed(0), torch.arange(b))
        o = tuple(torch.full((b,), float(cams[0][k]), device=dv)
                  for k in range(3))
        dd = tuple(torch.tensor(d[:, k], device=dv) for k in range(3))
        t0 = time.time()
        out.append(tr.trace(o, dd, draws=[x.to(dv) for x in draws]).cpu())
        secs.append(time.time() - t0)
    rel = float((out[0] - out[1]).norm() / out[1].norm())
    off = ((out[0] - out[1]).abs() > 1e-5 + 1e-4 * out[1].abs()).any(-1)
    log(f"[pathtrace-reference] trace of {b} paths (view 0 rows "
        f"{PT_BAND[0]}-{PT_BAND[1]} x {PT_BAND_SPP} spp, {PT_BOUNCES} "
        f"bounces, {len(cams)} lights) card vs cpu: radiance rel L2 "
        f"{rel:.3g}, {int(off.sum())} paths beyond rtol 1e-4 / atol 1e-5 "
        f"(card {secs[0]:.2f} s, cpu {secs[1]:.2f} s); mean "
        f"{float(out[1].mean()):.5f}")
    if not (rel <= 1e-4 and float(out[1].max()) > 0):
        raise SystemExit("[pathtrace-reference] the path tracer on the card "
                         "disagrees with the CPU")


def phase_tools(torch, path_mesh, mat_exps, tmp):
    """The five tools: `relighting_varying --frames 2` on the card at its
    other defaults (pano 64x128, spp 16, 2 bounces, the colour sequence)
    on the apartment's mesh and [mat]'s atlases; then the four host tools
    on a small input written here (no OpenCV on this machine): the
    padding tool (denoise on the card, and --index on a 16-bit index
    texture), the four trans_hdr_tex repacks, hdr2ldr and arrange_syn."""
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.tools import (
        arrange_syn,
        hdr2ldr,
        padding_texture,
        relighting_varying,
        trans_hdr_tex,
    )

    albedo, rough = _mat_atlases(mat_exps)
    out = os.path.join(tmp, "relit_varying")
    torch.cuda.synchronize()
    t0 = time.time()
    relighting_varying.main(["--mesh", path_mesh, "--albedo", albedo,
                             "--roughness", rough, "--out-dir", out,
                             "--frames", "2"])
    torch.cuda.synchronize()
    dt = time.time() - t0
    frames = [hdrio.read_hdr(os.path.join(out, f))
              for f in sorted(os.listdir(out))]
    log(f"[tools] relighting_varying --frames 2 on the card: {dt:.2f} s "
        f"with set-up; frame means "
        f"{[round(float(f.mean()), 5) for f in frames]}")
    if len(frames) != 2 or not all(f.shape == PT_PANO + (3,)
                                   and np.isfinite(f).all() and f.max() > 0
                                   for f in frames):
        raise SystemExit("[tools] relighting_varying wrote wrong frames")

    rng = np.random.default_rng(60)
    root = os.path.join(tmp, "tools")
    proj = os.path.join(root, "project")
    ids = ["scanA", "scanB"]
    os.makedirs(os.path.join(proj, "info"))
    with open(os.path.join(proj, "info", "aligned.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for vid, (h, w) in zip(ids, [(16, 32), (24, 48)]):
        for sub in ("hdr", "derived", "methods/phyir"):
            os.makedirs(os.path.join(proj, sub, vid))
        hdrio.write_hdr(os.path.join(proj, "hdr", vid, "ccm.hdr"),
                        rng.uniform(0, 4, (h, w, 3)).astype(np.float32))
        hdrio.write_png(os.path.join(proj, "derived", vid,
                                     "panoImage_gray.png"),
                        rng.integers(0, 40, (h, w), dtype=np.uint8))
        for kind in ("albedo", "roughness"):
            hdrio.write_png(os.path.join(proj, "methods/phyir", vid,
                                         f"{kind}.png"),
                            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    idx = np.zeros((40, 40, 3), np.uint16)
    idx[6:, :, 2] = rng.integers(0, 50000, (34, 40))  # row (BGR order)
    idx[6:, :, 1] = rng.integers(0, 50000, (34, 40))  # col
    idx[6:, :, 0] = rng.integers(0, 2, (34, 40))      # view
    os.makedirs(os.path.join(proj, "hdr_texture"))
    hdrio.write_png(os.path.join(proj, "hdr_texture", "0.png"), idx)
    t0 = time.time()
    for target in ("hdr", "seg", "albedo", "roughness"):
        trans_hdr_tex.main([target, "--project", proj])
    tex = os.path.join(proj, "hdr_texture", "0_hdr_ccm_upper.hdr")
    padding_texture.main([tex, os.path.join(root, "padded.hdr")])
    padding_texture.main([os.path.join(proj, "hdr_texture", "0.png"),
                          os.path.join(root, "padded_index.png"), "--index"])
    hdr2ldr.main([tex, "--out-dir", os.path.join(root, "ldr")])
    arrange_syn.main(["--src", os.path.join(proj, "hdr", "scanA"), "--out",
                      os.path.join(root, "arranged"), "--mesh", path_mesh])
    padded = hdrio.read_hdr(os.path.join(root, "padded.hdr"))
    pidx = hdrio.read_png(os.path.join(root, "padded_index.png"))
    albedo_atlas = hdrio.read_png(os.path.join(proj, "hdr_texture",
                                               "0_phyir_albedo.png"))
    ok = (np.isfinite(padded).all() and (padded.sum(-1) > 0).all()
          and pidx.dtype == np.uint16 and (pidx.sum(-1) > 0).all()
          and np.array_equal(pidx[6:], idx[6:])
          and albedo_atlas.shape == (2048, 2048, 3)
          and os.path.exists(os.path.join(root, "ldr",
                                          "0_hdr_ccm_upper.png"))
          and os.path.exists(os.path.join(root, "arranged", "hdr", "view000",
                                          "ccm.hdr")))
    log(f"[tools] trans_hdr_tex (hdr, seg, albedo, roughness), "
        f"padding_texture (denoise on the card; --index), hdr2ldr and "
        f"arrange_syn on a 40x40 index texture of 2 views in "
        f"{time.time() - t0:.2f} s: outputs {'as expected' if ok else 'WRONG'}")
    if not ok:
        raise SystemExit("[tools] a host tool wrote a wrong output")

def phase_bvh(torch, dev, syn, clusters):
    """The BVH traversal (ops/raycast.py::cast_rays_soa, plain PyTorch) on
    one view's pano rays: against B1 shared_prim on the same rays (prim
    equal and t within 1e-4 relative, except on rays through a triangle
    edge or vertex, where the two formulas may pick either triangle at
    the same t (a tie) or neither (a leak), at most twice as often as the
    deterministic readings) and against the CPU traversal
    on a band of them (prim equal, t/u/v within 1e-6 relative); its ms per
    cast, iterations, launches and host syncs.  View 0's camera sits on
    the wall grid's lines, so its pole rows and the columns in the grid's
    planes run through edges and vertices."""
    from torch.profiler import ProfilerActivity, profile

    from texir_code_tpu_torch.data.export import ROW_WIDTH, pano_dirs
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.ops.pallas_culled import cast_fans_culled
    from texir_code_tpu_torch.ops.raycast import DeviceBVH, cast_rays_soa

    t0 = time.time()
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    bvh = DeviceBVH.from_flat(fb, dev)
    log(f"[bvh] BVH of {syn.mesh.num_faces} triangles: {fb.num_nodes} nodes, "
        f"built and uploaded in {time.time() - t0:.2f} s")
    cam = syn.camera_positions(QUALITY_VIEWS)[0]
    d = torch.from_numpy(pano_dirs(*PANO).reshape(-1, 3)).to(dev)
    n = d.shape[0]
    o = tuple(torch.full((n,), float(cam[k]), device=dev) for k in range(3))
    dd = tuple(d[:, k].contiguous() for k in range(3))

    def cast():
        return cast_rays_soa(bvh, o, dd, t_min=1e-5)

    hit = cast()
    stats = dict(cast_rays_soa.stats)
    ms = cuda_ms(torch, cast, 3)
    torch.cuda.synchronize()
    t0 = time.time()
    cast()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cast()
        torch.cuda.synchronize()
    kern, launches = profile_kernels(prof)
    busy = sum(kern.values())
    log(f"[bvh] cast_rays_soa on {n} pano rays of view 0: {ms:.3f} ms a cast "
        f"(CUDA events, 3 casts), wall {wall_ms:.2f} ms; "
        f"{stats['iterations']} iterations, {stats['syncs']} host syncs, "
        f"{stats['compactions']} compactions; {launches} kernel launches, "
        f"{busy:.2f} ms on the card, idle share "
        + (f"{max(0.0, 1 - busy / wall_ms):.3f}" if busy else "not measured"))

    # B1 shared_prim on the same rays, as the radiance exporter traces them
    rows = n // ROW_WIDTH
    camt = torch.as_tensor(np.asarray(cam, np.float32), device=dev)
    walk = cast_fans_culled(
        clusters, tuple(camt[k].expand(rows).contiguous() for k in range(3)),
        tuple(a.reshape(rows, ROW_WIDTH) for a in dd), t_min=1e-5,
        emit_prim=True)
    ta, pa = hit.t.cpu().numpy(), hit.prim.cpu().numpy()
    tb, pb = (walk.t.reshape(-1).cpu().numpy(),
              walk.prim.reshape(-1).cpu().numpy())

    def edge(u, v):  # barycentric distance of a hit to its triangle's edges
        u, v = u.reshape(-1).cpu().numpy(), v.reshape(-1).cpu().numpy()
        return np.minimum(np.minimum(u, v), 1.0 - u - v)

    both = np.isfinite(ta) & np.isfinite(tb)
    rel = np.zeros(n)
    rel[both] = np.abs(ta[both] - tb[both]) / tb[both]
    leak = np.isfinite(ta) != np.isfinite(tb)
    tie = both & (pa != pb) & (rel <= 1e-4)
    bad = both & (pa != pb) & (rel > 1e-4)
    near = np.where(np.isfinite(ta), edge(hit.u, hit.v),
                    edge(walk.u, walk.v))
    same = both & (pa == pb)
    rows_off = np.unique(np.flatnonzero(leak | tie) // PANO[1])
    log(f"[bvh]   vs B1 shared_prim: prim differs on {int((pa != pb).sum())} "
        f"of {n} rays: {int(tie.sum())} exact-t ties, {int(leak.sum())} "
        f"leaks ({int((leak & np.isfinite(ta)).sum())} hit by the BVH "
        f"only), {int(bad.sum())} mismatches; every tie or leak within "
        f"{float(near[leak | tie].max(initial=0.0)):.3g} (barycentric) of "
        f"a triangle edge, as {float((near[np.isfinite(ta)] <= 1e-5).mean()):.4f} "
        f"of the BVH's hits; pano rows with one: {rows_off.size} "
        f"(rows 0 and {PANO[0] - 1}: "
        f"{int(((leak | tie).reshape(PANO)[[0, -1]]).sum())}); t max rel "
        f"diff {float(rel[same].max()):.3g} where prim agrees")
    # the plane-dual walk and the Möller–Trumbore traversal round apart at
    # a shared edge or vertex: there one may take either triangle, or
    # neither (a leak); nowhere else may they differ, and no more often
    # than the readings allow
    if bad.any() or (near[leak | tie] > 1e-5).any():
        raise SystemExit("[bvh] the traversal disagrees with B1 off the "
                         "triangles' edges")
    walk_leaks = int((leak & np.isfinite(ta)).sum())
    if (int((leak | tie).sum()) > BVH_EDGE_RAYS_MAX
            or walk_leaks > BVH_WALK_LEAKS_MAX
            or int(leak.sum()) - walk_leaks > BVH_LEAKS_MAX):
        raise SystemExit("[bvh] more ties or leaks at the triangles' edges "
                         "than the deterministic readings allow")
    if float(rel[same].max()) > 1e-4:
        raise SystemExit("[bvh] t differs from B1's beyond 1e-4 relative")

    # the CPU traversal on a band of the same rays
    sl = slice(BVH_BAND[0] * PANO[1], BVH_BAND[1] * PANO[1])
    ref = cast_rays_soa(DeviceBVH.from_flat(fb, "cpu"),
                        tuple(a[sl].cpu() for a in o),
                        tuple(a[sl].cpu() for a in dd), t_min=1e-5)
    if not torch.equal(hit.prim[sl].cpu(), ref.prim):
        raise SystemExit("[bvh] the card's prims differ from the CPU's")
    errs = []
    for f in ("t", "u", "v"):
        a = getattr(hit, f)[sl].cpu().numpy()
        b = getattr(ref, f).numpy()
        fin = np.isfinite(b)
        if not np.array_equal(np.isfinite(a), fin):
            raise SystemExit(f"[bvh] the card's {f} misses differ")
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1.0)
        errs.append(float(err.max()) if err.size else 0.0)
    log(f"[bvh]   vs the CPU traversal on {sl.stop - sl.start} rays: prim "
        f"equal, t/u/v max rel diff {max(errs):.3g}")
    if max(errs) > 1e-6:
        raise SystemExit("[bvh] the card's t/u/v differ from the CPU's")
    return dict(ms=ms, launches=launches, **stats)


def phase_wedged(torch, dev, clusters, occ, syn):
    """ops/pallas_culled.py::cast_ray_fans_wedged (the one-call fan trace:
    octant sort, wedges, the walk, fans put back) on one bake batch's
    unsorted fans (1024 texels x 2048 spp, wedges 4, fb 32, occluders),
    with uv and with prim output: B1's launches in each run (shared_uv,
    shared_prim), its sorted directions against the bake's rows, its hits
    against cast_fans_culled on the rows the bake builds (exit groups of
    16 rows there, of one 32-row block here: other lists, the same
    closest hits), and B1 against its plain version on the wedged trace's
    own rows."""
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled,
        cast_ray_fans_wedged,
        culled_walk_cuda,
        unwedge_rows,
        walk_args,
        wedge_rows,
    )
    from texir_code_tpu_torch.ops.sampling import generate_dir_soa

    pts, nrm, ids = bake_texels(syn, 1024)
    p = torch.from_numpy(pts).to(dev)
    n = torch.from_numpy(nrm).to(dev)
    dirs = generate_dir_soa(
        tuple(n[:, k] for k in range(3)), SPP, mode="uniform",
        row_ids=torch.from_numpy(ids).to(dev), seed=777)
    origins = tuple(p[:, k] + 1e-2 * n[:, k] for k in range(3))
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev)
    rays = dirs[0].numel()
    out = {}
    for emit_uv in (True, False):
        mode = "shared_uv" if emit_uv else "shared_prim"
        culled_walk_cuda.launches.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        hit, ds = cast_ray_fans_wedged(
            clusters, origins, dirs, wedges=WEDGES, fan_block=FAN_BLOCK,
            emit_uv=emit_uv, occluders=occ)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
        launches = dict(culled_walk_cuda.launches)
        _need_modes("wedged", launches, [mode])
        if not all(torch.equal(wedge_rows(a, WEDGES), b)
                   for a, b in zip(ds, rows_d)):
            raise SystemExit("[wedged] the sorted directions are not the "
                             "bake's rows")
        ref = cast_fans_culled(clusters, rows_o, rows_d, fan_block=FAN_BLOCK,
                               exit_rows=EXIT_ROWS, emit_uv=emit_uv,
                               occluders=occ)
        ref = tuple(unwedge_rows(a, WEDGES) for a in
                    (ref.t, ref.prim, ref.u, ref.v))
        err, ties, t_bad, prim_bad = compare_hits(
            (hit.t, hit.prim, hit.u, hit.v), ref, not emit_uv)
        log(f"[wedged] cast_ray_fans_wedged {mode}: {rays} rays in "
            f"{wall_ms:.2f} ms wall (first call); culled_walk launches "
            f"{launches}; vs cast_fans_culled on the bake's rows (er "
            f"{EXIT_ROWS}): max|d| {err:.3g}, t mismatches {t_bad}, prim "
            f"mismatches {prim_bad}, ties {ties}")
        if t_bad or ties > 1e-4 * rays:
            raise SystemExit("[wedged] the wedged trace disagrees with "
                             "cast_fans_culled on the bake's rows")
        row, _ = check_walk(torch, "the wedged trace's rows", walk_args(
            clusters, rows_o, rows_d, fan_block=FAN_BLOCK, emit_uv=emit_uv,
            occluders=occ), plain_reps=0, name=f"culled_walk[{mode}]@wedged")
        row["launches"] = launches[mode]
        out[mode + "@wedged"] = row
    return out


def phase_azimuth_bake(torch, dev, clusters, occ, syn, path_mesh, tmp):
    """The apartment's 1024^2 x 2048-spp bake through the IrrT runner's
    baker (the [slice] settings and seed), once with chunk_mode "octant"
    and once "azimuth" (the fans drawn from the u2-sorted Hammersley
    table, wedged unsorted): Mrays/s of both; the octant bake must be
    [slice]'s (its RGBE file, value for value); the azimuth bake is held
    to the octant one by PERF.md section 2's bake rule on the float
    texels (each texel traces the same direction set, so only the order
    of the sums and the choice on exact-t ties move a texel); then B1
    shared_uv on one azimuth batch's rows against its plain version."""
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.ops.pallas_culled import (
        culled_walk_cuda,
        walk_args,
    )
    from texir_code_tpu_torch.train.exp import seed_everything
    from texir_code_tpu_torch.train.irt import IrrTextureRunner

    conf = parse_file(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "irt_synthetic.conf"))
    conf.put("train.path_mesh_open3d", path_mesh)
    conf.put("train.sample_light", _parse_value(f"[{SPP}, 16]"))
    runner = IrrTextureRunner(conf, exps_root=os.path.join(tmp, "exps_az"),
                              texture_res=IRT_RES, denoise=False)
    baker, geom = runner.baker, runner._geom
    rays = int(geom.valid.sum()) * SPP
    raws, secs, launches = {}, {}, {}
    for mode in ("octant", "azimuth"):
        baker.chunk_mode = mode
        culled_walk_cuda.launches.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        raws[mode] = baker.bake(geom, seed_everything(666))
        torch.cuda.synchronize()
        secs[mode] = time.time() - t0
        launches[mode] = dict(culled_walk_cuda.launches)
        _need_modes("azimuth-bake", launches[mode], ["shared_uv"])
    log(f"[azimuth-bake] {rays} rays: octant {secs['octant']:.2f} s = "
        f"{rays / secs['octant'] / 1e6:.2f} Mrays/s, azimuth "
        f"{secs['azimuth']:.2f} s = {rays / secs['azimuth'] / 1e6:.2f} "
        f"Mrays/s (bake only, host clock to a device sync); culled_walk "
        f"launches {launches}")
    sliced = hdrio.read_hdr(path_mesh.replace("out1.obj", "0_irr_texture.hdr"),
                            flip=True)
    if not np.array_equal(_raw_quantized(raws["octant"]), sliced):
        raise SystemExit("[azimuth-bake] the octant bake is not [slice]'s")
    a, b, valid = raws["azimuth"], raws["octant"], geom.valid
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3))[valid]
    log(f"[azimuth-bake] the octant bake equals [slice]'s 0_irr_texture.hdr; "
        f"azimuth vs octant: texels above 1e-6 rel "
        f"{int((rel > 1e-6).any(-1).sum())}, above 1e-5 "
        f"{int((rel > 1e-5).any(-1).sum())}")
    bake_rule("[azimuth-bake] azimuth vs octant float bakes", a, b, valid)
    pts, nrm, ids = bake_texels(syn, 1024)
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev, "azimuth")
    row, _ = check_walk(torch, "azimuth bake rows", walk_args(
        clusters, rows_o, rows_d, fan_block=FAN_BLOCK, exit_rows=EXIT_ROWS,
        emit_uv=True, occluders=occ), plain_reps=0,
        name="culled_walk[shared_uv]@azimuth")
    row["launches"] = launches["azimuth"]["shared_uv"]
    return row


TILE_RAYS = 1024  # the tiled caster's tile (JAX's default)


def edge_rule(tag, label, a, b):
    """[bvh]'s hit rule between two closest-hit sets of the same rays (a
    traced by Möller–Trumbore, the traversal's role in [bvh]; b the other
    trace): prim equal and t within 1e-4 relative, except on rays whose
    nearer hit lies within 1e-5 (barycentric) of a triangle edge, which
    may take either triangle at the same t (a tie) or pass through the
    edge in one trace (a leak: that trace misses, or hits a surface
    behind, where [bvh]'s closed walls leave it nothing); ties and leaks
    on at most [bvh]'s share of the rays (BVH_EDGE_RAYS_MAX of 131,072)."""
    ta, pa = a.t.reshape(-1).cpu().numpy(), a.prim.reshape(-1).cpu().numpy()
    tb, pb = b.t.reshape(-1).cpu().numpy(), b.prim.reshape(-1).cpu().numpy()
    n = ta.size

    def edge(u, v):  # barycentric distance of a hit to its triangle's edges
        u, v = u.reshape(-1).cpu().numpy(), v.reshape(-1).cpu().numpy()
        return np.minimum(np.minimum(u, v), 1.0 - u - v)

    both = np.isfinite(ta) & np.isfinite(tb)
    rel = np.zeros(n)
    rel[both] = np.abs(ta[both] - tb[both]) / tb[both]
    far = both & (pa != pb) & (rel > 1e-4)
    leak = (np.isfinite(ta) != np.isfinite(tb)) | far
    tie = both & (pa != pb) & (rel <= 1e-4)
    a_nearer = np.where(np.isfinite(ta), ta, np.inf) <= np.where(
        np.isfinite(tb), tb, np.inf)
    near = np.where(a_nearer, edge(a.u, a.v), edge(b.u, b.v))
    same = both & (pa == pb)
    cap = int(n * BVH_EDGE_RAYS_MAX / (PANO[0] * PANO[1]))
    log(f"[{tag}]   {label}: prim differs on {int((pa != pb).sum())} of {n} "
        f"rays: {int(tie.sum())} exact-t ties, {int(leak.sum())} leaks "
        f"({int((leak & a_nearer).sum())} by the second, {int(far.sum())} "
        f"of all to a surface behind; at most {cap} ties and leaks), every "
        f"tie or leak within {float(near[leak | tie].max(initial=0.0)):.3g} "
        f"of an edge; t max rel diff {float(rel[same].max(initial=0.0)):.3g}"
        f" where prim agrees")
    if (near[leak | tie] > 1e-5).any():
        raise SystemExit(f"[{tag}] {label}: the hits differ off the "
                         "triangles' edges")
    if int((leak | tie).sum()) > cap:
        raise SystemExit(f"[{tag}] {label}: more ties or leaks than [bvh]'s "
                         "rule allows")
    if float(rel[same].max(initial=0.0)) > 1e-4:
        raise SystemExit(f"[{tag}] {label}: t differs beyond 1e-4 relative")


def phase_tiled(torch, dev, clusters, occ, syn):
    """ops/tiled_raycast.py (plain PyTorch, no hand-written kernel) on two
    ray sets of the apartment: the bench view's G-buffer (98,304 primary
    rays from camera 0, t_min 1e-6) and one bake batch's wedge rows
    (1024 texels x 2048 spp = 2,097,152 rays): required_leaf_budget, then
    cast_rays_tiled at the budget (its overflow share) and cast_rays_exact
    at half of it (the rays it re-traces with the BVH); CUDA-event ms of
    each beside cast_rays_soa's; both against cast_rays_soa and B1
    shared_prim (as the Mat G-buffer traces those rays, lb 8, and as the
    bake does, lb 4; occluders) by [bvh]'s hit rule (edge_rule); the
    card against the CPU on the first tiles' rays (prim equal, t/u/v
    within 1e-6 relative); launches and idle share of each tiled cast
    under torch.profiler."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.gbuffer import ray_dirs_from_mvp
    from texir_code_tpu_torch.ops.pallas_culled import (
        ClusterScene,
        cast_fans_culled,
        culled_walk_cuda,
    )
    from texir_code_tpu_torch.ops.raycast import DeviceBVH, cast_rays_soa
    from texir_code_tpu_torch.ops.tiled_raycast import (
        TiledScene,
        cast_rays_exact,
        cast_rays_tiled,
        required_leaf_budget,
    )

    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    scene, bvh = TiledScene.from_flat(fb, dev), DeviceBVH.from_flat(fb, dev)
    scene_cpu = TiledScene.from_flat(fb, "cpu")
    bvh_cpu = DeviceBVH.from_flat(fb, "cpu")
    # the G-buffer's walk at the Mat model's cluster size (lb 8)
    gbuf_clusters = ClusterScene.from_fan(
        FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs()),
        lb=MAT_LB, dense=True, device=dev)
    pos, mvp = bench_camera(syn)
    cam = torch.as_tensor(pos, device=dev)
    flat = ray_dirs_from_mvp(mvp.to(dev), PANO[1] // 4).reshape(-1, 3)
    n = flat.shape[0]
    g_d = tuple(flat[:, k].contiguous() for k in range(3))
    g_o = tuple(cam[k].expand(n).contiguous() for k in range(3))
    rows = n // 2048
    g_rows = (tuple(cam[k].expand(rows).contiguous() for k in range(3)),
              tuple(a.reshape(rows, 2048) for a in g_d))
    walk_g = cast_fans_culled(gbuf_clusters, *g_rows, t_min=1e-6,
                              fan_block=8, emit_prim=True, occluders=occ)
    # the same rows at the bake's cluster size (lb 4), for the occluder
    # finding below
    walk_g4 = cast_fans_culled(clusters, *g_rows, t_min=1e-6, fan_block=8,
                               emit_prim=True, occluders=occ)
    pts, nrm, ids = bake_texels(syn, 1024)
    rows_o, rows_d = bake_rows(torch, pts, nrm, ids, 777, dev)
    r = rows_d[0].shape[1]
    b_o = tuple(a[:, None].expand(-1, r).reshape(-1) for a in rows_o)
    b_d = tuple(a.reshape(-1) for a in rows_d)
    walk_b = cast_fans_culled(clusters, rows_o, rows_d, fan_block=FAN_BLOCK,
                              exit_rows=EXIT_ROWS, emit_prim=True,
                              occluders=occ)
    sets = (("the bench view's G-buffer", g_o, g_d, 1e-6, walk_g, 8),
            ("one bake batch's wedge rows", b_o, b_d, 0.0, walk_b, 2))
    for label, o, d, t_min, walk, cpu_tiles in sets:
        n = o[0].numel()
        t0 = time.time()
        budget = required_leaf_budget(scene, o, d, tile_size=TILE_RAYS)
        budget_s = time.time() - t0
        culled_walk_cuda.launches.clear()
        (hit, over), tiled_ms = timed_once(torch, lambda: cast_rays_tiled(
            scene, o, d, t_min=t_min, tile_size=TILE_RAYS, max_leaves=budget,
            return_overflow=True))
        stats = dict(cast_rays_tiled.stats)
        exact, exact_ms = timed_once(torch, lambda: cast_rays_exact(
            scene, bvh, o, d, t_min=t_min, tile_size=TILE_RAYS,
            max_leaves=budget // 2))
        retraced = cast_rays_exact.stats["retraced"]
        if culled_walk_cuda.launches:
            raise SystemExit("[tiled] the tiled caster launched B1")
        trav, bvh_ms = timed_once(torch, lambda: cast_rays_soa(
            bvh, o, d, t_min=t_min))
        over_share = float(over.float().mean())
        log(f"[tiled] {label}: {n} rays, {stats['tiles']} tiles of "
            f"{TILE_RAYS}, {scene.num_leaves} leaves; required_leaf_budget "
            f"{budget} ({budget_s:.2f} s on the host); cast_rays_tiled at "
            f"the budget {tiled_ms:.2f} ms ({stats['steps']} leaf steps), "
            f"overflow share {over_share:.4g}; cast_rays_exact at "
            f"{budget // 2} {exact_ms:.2f} ms, {retraced} rays re-traced "
            f"({retraced / n:.4g}); cast_rays_soa {bvh_ms:.2f} ms (CUDA "
            f"events, one call each)")
        if over_share:
            log(f"[tiled]   the budget misses {over_share:.4g} of the "
                f"cast's rays (its host sort is numpy's unstable argsort): "
                f"those rays are held through cast_rays_exact only")
        else:
            edge_rule("tiled", "tiled vs cast_rays_soa", hit, trav)
            edge_rule("tiled", "tiled vs B1 shared_prim", hit, walk)
        edge_rule("tiled", "exact vs cast_rays_soa", exact, trav)
        edge_rule("tiled", "exact vs B1 shared_prim", exact, walk)
        if walk is walk_g:
            # a property of the reference: its occluder culling (ported
            # as it is) drops a cluster some G-buffer rows see at lb 4
            t4 = walk_g4.t.reshape(-1)
            u, v = exact.u, exact.v
            off = (torch.isfinite(exact.t) & ~torch.isfinite(t4)
                   & (torch.minimum(torch.minimum(u, v), 1 - u - v) > 1e-5))
            log(f"[tiled]   B1 shared_prim at lb 4 with occluders on the "
                f"same rows: {int(off.sum())} rays missed off any edge "
                f"(hit by the exact trace; lb {MAT_LB}, the G-buffer's: "
                f"none)")
        m = cpu_tiles * TILE_RAYS
        sub = [tuple(a[:m].contiguous() for a in x) for x in (o, d)]
        card = cast_rays_exact(scene, bvh, *sub, t_min=t_min,
                               tile_size=TILE_RAYS, max_leaves=budget // 2)
        ref = cast_rays_exact(scene_cpu, bvh_cpu,
                              *[tuple(a.cpu() for a in x) for x in sub],
                              t_min=t_min, tile_size=TILE_RAYS,
                              max_leaves=budget // 2)
        if not torch.equal(card.prim.cpu(), ref.prim):
            raise SystemExit("[tiled] the card's prims differ from the CPU's")
        errs = []
        for f in ("t", "u", "v"):
            x, y = getattr(card, f).cpu().numpy(), getattr(ref, f).numpy()
            fin = np.isfinite(y)
            if not np.array_equal(np.isfinite(x), fin):
                raise SystemExit(f"[tiled] the card's {f} misses differ")
            e = np.abs(x[fin] - y[fin]) / np.maximum(np.abs(y[fin]), 1.0)
            errs.append(float(e.max()) if e.size else 0.0)
        log(f"[tiled]   card vs CPU (cast_rays_exact) on the first {m} "
            f"rays: prim equal, t/u/v max rel diff {max(errs):.3g}")
        if max(errs) > 1e-6:
            raise SystemExit("[tiled] the card's t/u/v differ from the CPU's")
        profile_once(torch, "tiled", f"cast_rays_tiled of {label} at the "
                     f"budget", lambda: cast_rays_tiled(
                         scene, o, d, t_min=t_min, tile_size=TILE_RAYS,
                         max_leaves=budget), top=4)


def phase_profiling(torch, path_mesh, tmp):
    """profiling.py on the card: trace() around two Mat stage-2 steps of
    the apartment's runner (camera 0's cached view, the bench width), each
    timed by StepTimer and ended in a device sync: the trace written under
    its logdir must name B1's kernel (the steps' specular walk,
    per_ray_uv); prints StepTimer.summary()."""
    import glob

    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.profiling import StepTimer, trace

    runner = mat_runner(torch, path_mesh, tmp, "exps_trace")
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data([0])
    opt, sched = mat_adam(runner)
    runner._step(2, views[0], n_rooms, 0, opt, sched)
    torch.cuda.synchronize()
    timer = StepTimer()
    logdir = os.path.join(tmp, "trace")
    pixels = 6 * (PANO[1] // 4) ** 2
    culled_walk_cuda.launches.clear()
    with trace(logdir) as prof:
        for it in (1, 2):
            with timer.measure(pixels=pixels):
                runner._step(2, views[0], n_rooms, it, opt, sched)
                torch.cuda.synchronize()
    launches = dict(culled_walk_cuda.launches)
    _need_modes("profiling", launches, ["per_ray_uv"])
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise SystemExit(f"[profiling] trace() wrote {files}")
    with open(files[0]) as f:
        named = "culled_walk" in f.read()
    kern, n_launch = profile_kernels(prof)
    walk = sum(v for k, v in kern.items() if "culled_walk" in k)
    log(f"[profiling] trace() of two stage-2 steps: {files[0]} "
        f"({os.path.getsize(files[0])} bytes), B1 named: {named}; "
        f"{n_launch} kernel launches, {sum(kern.values()):.2f} ms on the "
        f"card, culled_walk {walk:.3f} ms; culled_walk launches {launches}")
    log(f"[profiling] StepTimer.summary(): {json.dumps(timer.summary())}")
    if not named or walk <= 0:
        raise SystemExit("[profiling] the trace does not name B1's kernel")


def phase_syn_export(torch, syn, tmp):
    """The quality run's export: export_reference_layout(gt_render=
    "material") at 5 views 256×512, gt_spp 512, irt_spp 1024, with B1
    launched in the GT IrT bake (shared_uv) and the photos' specular rays
    (per_ray_prim: the exporter fetches radiance from prim + barycentrics,
    as the JAX exporter does); then a band of view 0 rendered on the card
    and on the CPU with the same draws, relative L2 1e-4."""
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.data.export import (
        export_reference_layout,
        render_pano_material,
    )
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import (
        ClusterScene,
        culled_walk_cuda,
    )

    out = os.path.join(tmp, "syn")
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    path_mesh = export_reference_layout(
        syn, out, n_views=QUALITY_VIEWS, pano_res=PANO, gt_render="material",
        gt_spp=GT_SPP, irt_spp=IRT_SPP, device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    tm = export_reference_layout.timings
    with open(os.path.join(out, "info", "novel.txt"), "w") as f:
        f.write(f"view{QUALITY_VIEWS - 1:03d}\n")
    photos = [hdrio.read_hdr(os.path.join(out, "hdr", f"view{i:03d}",
                                          "ccm.hdr"))
              for i in range(QUALITY_VIEWS)]
    log(f"[syn-export] material export: {QUALITY_VIEWS} views at pano "
        f"{PANO[0]}x{PANO[1]}, gt_spp {GT_SPP}, irt_spp {IRT_SPP}: "
        f"{dt:.2f} s; GT IrT bake {tm['bake_s']:.2f} s; views "
        f"{', '.join(f'{t:.2f}' for t in tm['views_s'])} s; culled_walk "
        f"launches {launches}; photo means "
        f"{[round(float(p.mean()), 5) for p in photos]}")
    _need_modes("syn-export", launches, ("shared_uv", "per_ray_prim"))
    if not all(p.shape == PANO + (3,) and np.isfinite(p).all()
               and p.max() > 0 for p in photos):
        raise SystemExit("[syn-export] a photo is malformed, non-finite or "
                         "black")

    # card vs CPU on a band of view 0, the same draws (seed 0)
    irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "gt_irt.hdr"),
                         flip=True)
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    cam = syn.camera_positions(QUALITY_VIEWS)[0]
    bands = {}
    for d in ("cuda", "cpu"):
        tbl = build_tbl_from_flat(fb, syn.mesh, syn.hdr_texture, device=d)
        cl = ClusterScene.from_fan(fan, lb=4, dense=True, device=d)
        t0 = time.time()
        bands[d] = render_pano_material(
            syn.mesh, tbl, irt, syn.gt_albedo, syn.gt_roughness, cam, PANO,
            spp=GT_SPP, seed=0, cluster_scene=cl, pixels=SYN_BAND)
        bands[d + "_s"] = time.time() - t0
    a, b = bands["cuda"], bands["cpu"]
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    log(f"[syn-export]   view 0 pixels {SYN_BAND[0]}..{SYN_BAND[1] - 1} "
        f"({a.shape[0]} pixels x {GT_SPP} spp): card "
        f"{bands['cuda_s']:.2f} s, CPU {bands['cpu_s']:.2f} s; rel L2 "
        f"{rel:.3g}, max |d| {float(np.abs(a - b).max()):.3g}")
    if not rel <= 1e-4:
        raise SystemExit("[syn-export] the card's render differs from the "
                         "CPU's")
    return path_mesh, launches, tm


def phase_matsyn(torch, path_mesh, tmp):
    """IrrT (--irt_res 512, the quality recipe) and `train --trainstage
    MatSyn --max_epochs 1` through the port's CLI on the material export:
    the stage seconds, the material and novel-view metrics, B1's modes."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    exps = os.path.join(tmp, "syn-exps")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    cli.main(["train", "--conf", os.path.join(here, "configs",
                                              "irt_synthetic.conf"),
              "--trainstage", "IrrT", "--irt_res", str(SYN_IRT_RES),
              "--exps_folder", exps,
              "--set", f"train.path_mesh_open3d={path_mesh}"])
    torch.cuda.synchronize()
    log(f"[matsyn] IrrT via cli at --irt_res {SYN_IRT_RES}: "
        f"{time.time() - t0:.2f} s with set-up")
    conf, sets = _mat_conf(path_mesh, PANO)
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(["train", "--conf", conf, "--trainstage", "MatSyn",
              "--max_epochs", "1", "--exps_folder", exps] + sets)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    (tpath,) = glob.glob(os.path.join(exps, "Mat-default", "*",
                                      "timings.json"))
    with open(tpath) as f:
        tm = json.load(f)
    mm, nm, m = tm["material_metrics"], tm["novel_metrics"], tm["metrics"]
    steps = sum(tm[f"substage{k}"]["steps"] for k in range(3))
    log(f"[matsyn] MatSyn via cli, --max_epochs 1: {dt:.2f} s with set-up "
        f"({steps} steps on {QUALITY_VIEWS - 1} training views; set-up "
        f"{tm['setup_s']:.2f} s, masks {tm['masks_s']:.2f} s, re-render "
        f"{tm['render_calculate_s']:.2f} s, material eval "
        f"{tm['evaluate_materials_s']:.2f} s, novel eval "
        f"{tm['evaluate_novel_views_s']:.2f} s); culled_walk launches "
        f"{launches}")
    log(f"[matsyn]   re-render psnr {m['psnr']:.4f}; novel psnr "
        f"{nm['novel_psnr']:.4f}; mapped albedo psnr "
        f"{mm['albedo_psnr_mapped']:.4f}, mapped roughness psnr "
        f"{mm['roughness_psnr_mapped']:.4f} (1 epoch, not converged)")
    _need_modes("matsyn", launches, ("shared_prim", "per_ray_uv"))
    vals = list(m.values()) + list(nm.values()) + list(mm.values())
    if not np.isfinite(vals).all():
        raise SystemExit("[matsyn] non-finite metrics")
    return launches


# ---------------------------------------------------------------------------
# the field stages: NIrF (IRRF) at full width, IRF and PIL
# ---------------------------------------------------------------------------


def irrf_conf(path_mesh):
    """configs/irrf_synthetic.conf on the export."""
    from texir_code_tpu_torch.config import parse_file

    here = os.path.dirname(os.path.abspath(__file__))
    conf = parse_file(os.path.join(here, IRRF_CONF))
    conf.put("train.path_mesh_open3d", path_mesh)
    return conf


def field_runner(cls, path_mesh, exps, device="cuda"):
    """A field-stage runner with configs/irrf_synthetic.conf on the
    export."""
    return cls(irrf_conf(path_mesh), exps_root=exps, device=device)


_WALK_ARGS = ("count", "cand", "dist", "t_cap", "origins", "dx", "dy", "dz",
              "rows3", "prims3", "er", "t_min", "emit_uv", "emit_prim",
              "per_ray", "seed")


def capture_walks(torch, fn, first_per_mode=False):
    """The culled-walk arguments of every launch fn() makes (with
    first_per_mode, of the first launch of each mode only), as the dicts
    check_walk takes (the launches themselves run as usual)."""
    from texir_code_tpu_torch.ops import pallas_culled

    launch = pallas_culled.culled_walk_cuda
    seen = []

    def record(*args):
        inp = dict(zip(_WALK_ARGS, args))
        if not (first_per_mode and walk_mode_of(inp) in map(walk_mode_of,
                                                             seen)):
            seen.append(inp)
        return launch(*args)

    record.launches = launch.launches  # the wrapper counts by its name
    pallas_culled.culled_walk_cuda = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        pallas_culled.culled_walk_cuda = launch
    return seen


def irrf_batch(torch, runner, points, normals, start, n):
    """Points, normals and global ids [start, start + n) on the runner's
    device."""
    pts = runner._tensor(points[start:start + n])
    return (pts, runner._tensor(normals[start:start + n]),
            torch.arange(start, start + len(pts), device=runner.device))


def phase_irrf_kernels(torch, path_mesh, tmp):
    """B1 on the IRRF trace's rays exactly as the runner builds them: one
    training step's (16 points x 2048 directions, each point's rays one
    row of 2048 with one origin) and one validation batch's (512 pixels of
    the val pano x val_sample_res), captured from the tracer's own call
    and held against the plain walk."""
    from texir_code_tpu_torch.data.datasets import ImageMeshPoint
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner, step_seed

    r = field_runner(IRRFTrainRunner, path_mesh,
                     os.path.join(tmp, "irrf-kernels"))
    ds = r.train_dataset
    pts, nrm, ids = irrf_batch(torch, r, ds.points, ds.normals, 0,
                               r.batch_size)
    rows = {}
    (inp,) = capture_walks(torch, lambda: r.model.trace_gt(
        pts, nrm, r.env_res, step_seed(0), ids))
    rows["irrf-step"], _ = check_walk(
        torch, f"IRRF step, {r.batch_size} points x "
        f"{r.env_res[0] * r.env_res[1]}", inp,
        name=f"culled_walk[{IRRF_MODE}]@irrf-step")
    t0 = time.time()
    val = ImageMeshPoint(path_mesh, env_res=r.val_res, device="cuda")
    log(f"[irrf-kernels] val pano G-buffer {r.val_res[0]}x{r.val_res[1]} "
        f"(BVH) in {time.time() - t0:.2f} s, {val.mask.mean():.4f} hit")
    j = len(val) // IRRF_VAL_BATCH // 2  # a batch from the pano's middle
    pts, nrm, ids = irrf_batch(torch, r, val.points, val.normals,
                               j * IRRF_VAL_BATCH, IRRF_VAL_BATCH)
    (inp,) = capture_walks(torch, lambda: r.model.trace_gt(
        pts, nrm, r.val_sample_res, step_seed(j), ids))
    rows["irrf-val"], _ = check_walk(
        torch, f"IRRF validation batch {j}, {IRRF_VAL_BATCH} pixels x "
        f"{r.val_sample_res[0] * r.val_sample_res[1]}", inp, plain_reps=0,
        name=f"culled_walk[{IRRF_MODE}]@irrf-val")
    for row in rows.values():
        if not row["name"].startswith(f"culled_walk[{IRRF_MODE}]"):
            raise SystemExit(f"[irrf-kernels] unexpected mode {row['name']}")
    return rows


def phase_irrf_reference(torch, path_mesh, tmp, tag="irrf-reference",
                         points=None):
    """One IRRF train step (GT trace, MLP, loss, backward) on the card
    against the CPU from the same weights, points and draws: GT within rel
    1e-4, loss within rel 1e-5, each parameter's gradient within relative
    L2 1e-4.  points: the step's first `points` points (default: a whole
    batch)."""
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner, step_seed

    out = {}
    state = None
    for dev in ("cuda", "cpu"):
        r = field_runner(IRRFTrainRunner, path_mesh,
                         os.path.join(tmp, f"{tag}-{dev}"), device=dev)
        if state is None:
            state = {k: v.cpu() for k, v in
                     r.model.network.state_dict().items()}
        else:
            r.model.network.load_state_dict(state)
        ds = r.train_dataset
        pts, nrm, ids = irrf_batch(torch, r, ds.points, ds.normals, 0,
                                   points or r.batch_size)
        gt = r.model.trace_gt(pts, nrm, r.env_res, step_seed(0), ids)
        loss = r._loss(pts, nrm, step_seed(0), ids)
        loss.backward()
        out[dev] = (gt.cpu().numpy(), float(loss.detach()), {
            k: p.grad.cpu().numpy()
            for k, p in r.model.network.named_parameters()})
    (gg, lg, dg), (gc, lc, dc) = out["cuda"], out["cpu"]
    gt_rel = float(np.max(np.abs(gg - gc) / np.maximum(np.abs(gc), 1e-6)))
    rel = abs(lg - lc) / abs(lc)
    grad = max(np.linalg.norm(dg[k] - dc[k]) / np.linalg.norm(dc[k])
               for k in dc)
    log(f"[{tag}] IRRF step card vs cpu ({len(gg)} points, "
        f"{IRRF_MODE} walk vs plain walk): GT max rel {gt_rel:.3g}; loss "
        f"{lg:.7f} vs {lc:.7f} (rel {rel:.3g}); gradient rel L2 max over "
        f"{len(dc)} tensors {grad:.3g}")
    if not (gt_rel <= 1e-4 and rel <= 1e-5 and grad <= 1e-4):
        raise SystemExit(f"[{tag}] the IRRF step on the card disagrees with "
                         f"the CPU")


def _field_timings(exps, stage):
    import glob

    (path,) = glob.glob(os.path.join(exps, f"{stage}-default", "*",
                                     "timings.json"))
    with open(path) as f:
        return json.load(f)


def run_field_cli(torch, stage, path_mesh, exps, epochs, sets=()):
    """`train --trainstage <stage>` through the port's CLI on the export:
    (wall seconds, timings.json, culled-walk launches)."""
    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["train", "--conf", os.path.join(here, IRRF_CONF),
            "--trainstage", stage, "--max_epochs", str(epochs),
            "--exps_folder", exps, "--set",
            f"train.path_mesh_open3d={path_mesh}"]
    for kv in sets:
        argv += ["--set", kv]
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    tm = _field_timings(exps, stage)
    log(f"[{stage.lower()}] {stage} via cli, --max_epochs {epochs}: "
        f"{dt:.2f} s with set-up (set-up {tm['setup_s']:.2f} s); "
        f"{tm['steps']} steps in {tm['train_s']:.2f} s = "
        f"{tm['ms_per_step']:.3f} ms a step, {tm['steps_per_s']:.2f} "
        f"steps/s; last loss {tm['last_loss']:.6f}; culled_walk launches "
        f"{launches}")
    vals = [tm["last_loss"]] + list(tm["val_metrics"].values())
    if not np.isfinite(vals).all() or "val_psnr" not in tm["val_metrics"]:
        raise SystemExit(f"[{stage.lower()}] non-finite loss or missing "
                         f"val metrics: {tm}")
    _need_modes(stage.lower(), launches, (IRRF_MODE,))
    return dt, tm, launches


def profile_irrf_step(torch, path_mesh, tmp):
    """One IRRF train step under torch.profiler: its launches, B1's and
    the MLP's device ms, the idle share."""
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner

    r = field_runner(IRRFTrainRunner, path_mesh,
                     os.path.join(tmp, "irrf-profile"))
    ds = r.train_dataset
    pts, nrm, ids = irrf_batch(torch, r, ds.points, ds.normals, 0,
                               r.batch_size)
    it = iter(range(10 ** 6))
    wall, kern, launches = profile_once(
        torch, "irrf", "one IRRF train step (16 points x 2048 rays)",
        lambda: r.train_step(pts, nrm, next(it), ids), top=8)
    walk = sum(ms for k, ms in kern.items() if "culled_walk" in k)
    mlp = sum(ms for k, ms in kern.items() if "gemm" in k.lower())
    busy = sum(kern.values())
    log(f"[irrf]   step: {launches} launches, B1 {walk:.4f} ms, the MLP's "
        f"matrix products {mlp:.4f} ms, the rest {busy - walk - mlp:.4f} ms "
        f"on the card; idle share {max(0.0, 1 - busy / wall):.3f} of "
        f"{wall:.3f} ms")
    if walk <= 0:
        raise SystemExit("[irrf] the profiled step ran no culled walk")


def phase_fields(torch, path_mesh, tmp):
    """[irrf] the NIrF stage through the CLI at full width with its
    validation, one profiled step; [irf] and [pil] for an epoch each.
    Returns the IRRF run's B1 launches: (training steps, validation)."""
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner

    # the validation's launches on their own: the counter across the
    # first call of val_gt (the one that traces; later calls reuse it)
    val_gt, val_launches = IRRFTrainRunner.val_gt, []

    def counted_val_gt(runner):
        first = runner._val_gt is None
        before = culled_walk_cuda.launches[IRRF_MODE]
        out = val_gt(runner)
        if first:
            val_launches.append(culled_walk_cuda.launches[IRRF_MODE]
                                - before)
        return out

    exps = os.path.join(tmp, "field-exps")
    IRRFTrainRunner.val_gt = counted_val_gt
    try:
        _, tm, launches = run_field_cli(torch, "IRRF", path_mesh, exps,
                                        IRRF_EPOCHS)
    finally:
        IRRFTrainRunner.val_gt = val_gt
    vm = tm["val_metrics"]
    conf = irrf_conf(path_mesh)
    h, w = conf.get_list("val.env_res")
    sh, sw = conf.get_list("train.val_sample_res")
    val_batches = -(-h * w // IRRF_VAL_BATCH)
    log(f"[irrf]   validation at {h}x{w} x [{sh}, {sw}]: pano G-buffer "
        f"{tm['val_dataset_s']:.2f} s, GT trace {tm['val_gt_s']:.2f} s "
        f"({val_batches} batches of {IRRF_VAL_BATCH * sh * sw} rays), "
        f"prediction + metrics {tm['val_s']:.2f} s; val_psnr "
        f"{vm['val_psnr']:.4f}, val_ssim {vm['val_ssim']:.4f} "
        f"({IRRF_EPOCHS + 1} epochs, not converged)")
    if len(val_launches) != 1:
        raise SystemExit(f"[irrf] the validation GT was traced "
                         f"{len(val_launches)} times, expected once")
    val_n = val_launches[0]
    step_n = launches[IRRF_MODE] - val_n
    log(f"[irrf]   {IRRF_MODE} launches: {step_n} in training, {val_n} in "
        f"the validation's GT trace")
    if step_n != tm["steps"] or val_n != val_batches:
        raise SystemExit(
            f"[irrf] {step_n} + {val_n} {IRRF_MODE} launches (training + "
            f"validation), expected one a step and one a validation batch "
            f"({tm['steps']} + {val_batches})")
    profile_irrf_step(torch, path_mesh, tmp)
    run_field_cli(torch, "IRF", path_mesh, exps, 1, IRF_VAL)
    run_field_cli(torch, "PIL", path_mesh, exps, 1)
    return step_n, val_n


# ---------------------------------------------------------------------------
# the baseline heads: InvRender, NeILF, nvdiffrec
# ---------------------------------------------------------------------------


def head_conf(head):
    name = {"invrender": "syn_invrender", "neilf": "syn_neilf",
            "recmlp": "syn_rec"}[head]
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "reference", f"{name}.conf")


def head_runner(head, path_mesh, exps, device="cuda", sets=()):
    """A head's synthetic-GT runner on the export, with its reference conf
    and `sets` (KEY=VAL) on top."""
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.train.heads import BaselineHeadSynRunner

    conf = parse_file(head_conf(head))
    conf.put("train.path_mesh_open3d", path_mesh)
    for kv in sets:
        k, _, v = kv.partition("=")
        conf.put(k, _parse_value(v))
    return BaselineHeadSynRunner(conf, head, exps_root=exps, device=device)


def phase_heads(torch, path_mesh, tmp):
    """[heads]: `train --trainstage MatInvSyn | MatNeilfSyn | MatRecSyn
    --max_epochs 1` through the port's CLI at full width on the material
    export (IrrT of [matsyn]), evaluated at HEAD_EVAL_SPP: stage seconds,
    ms a step, the evaluation's seconds, peak memory, the four quality
    PSNRs (finite), B1 launches by mode (shared_prim at least once a view,
    per_ray_prim at least once a step).  Then per head one step under
    torch.profiler, and B1 on a step's own G-buffer and specular rays
    (captured) against the plain walk.  Returns the two kernel rows, their
    launches those of the three CLI runs."""
    import glob

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.train.exp import draw_seed

    exps = os.path.join(tmp, "head-exps")
    total, rows = {}, {}
    for head, stage in HEAD_STAGES.items():
        culled_walk_cuda.launches.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        cli.main(["train", "--conf", head_conf(head),
                  "--trainstage", stage, "--max_epochs", "1",
                  "--exps_folder", exps,
                  "--set", f"train.path_mesh_open3d={path_mesh}"])
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = dict(culled_walk_cuda.launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        (tpath,) = glob.glob(os.path.join(exps, f"{stage}-default", "*",
                                          "timings.json"))
        with open(tpath) as f:
            tm = json.load(f)
        m = tm["metrics"]
        log(f"[heads] {stage} via cli, --max_epochs 1: {dt:.2f} s with "
            f"set-up (set-up {tm['setup_s']:.2f} s, views "
            f"{tm['views_s']:.2f} s; {tm['steps']} steps in "
            f"{tm['step_s']:.3f} s = {tm['ms_per_step']:.3f} ms a step, the "
            f"first {tm['first_step_s']:.3f} s; evaluation at "
            f"{HEAD_EVAL_SPP} spp {tm['eval_s']:.2f} s); peak memory "
            f"{tm['max_memory_allocated'] / 2**30:.3f} GiB; culled_walk "
            f"launches {launches}")
        log(f"[heads]   re-render psnr {m['rerender_psnr']:.4f}; novel psnr "
            f"{m['novel_psnr']:.4f}; mapped albedo psnr "
            f"{m['albedo_psnr_mapped']:.4f}, mapped roughness psnr "
            f"{m['roughness_psnr_mapped']:.4f} (1 epoch, not converged)")
        if not np.isfinite(list(m.values())).all():
            raise SystemExit(f"[heads] {stage}: non-finite metrics {m}")
        views = QUALITY_VIEWS - 1
        if launches.get("shared_prim", 0) < views:
            raise SystemExit(f"[heads] {stage}: B1 shared_prim launched "
                             f"{launches.get('shared_prim', 0)} times, "
                             f"under once a view")
        if launches.get("per_ray_prim", 0) < tm["steps"]:
            raise SystemExit(f"[heads] {stage}: B1 per_ray_prim launched "
                             f"{launches.get('per_ray_prim', 0)} times, "
                             f"under once a step")

        r = head_runner(head, path_mesh, os.path.join(tmp, "head-profile"))
        (v,) = r.prepare_views([0])
        it = iter(range(10 ** 6))
        torch.cuda.reset_peak_memory_stats()
        wall, kern, n = profile_once(
            torch, "heads", f"one {stage} step (full width)",
            lambda: r.step(v, next(it)), top=5)
        walk = sum(ms for k, ms in kern.items() if "culled_walk" in k)
        busy = sum(kern.values())
        log(f"[heads]   {stage} step: {n} launches, {busy:.3f} ms on the "
            f"card (B1 {walk:.4f}), idle share "
            f"{max(0.0, 1 - busy / wall):.3f} of {wall:.3f} ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if not rows:  # B1 on a step's own rays (the heads share them)
            walks = capture_walks(torch, lambda: r.model._forward(
                r.params, v["mvp"], v["pos"], seed=draw_seed(0)))
            for inp in walks:
                mode = "per_ray_prim" if inp["per_ray"] else "shared_prim"
                if mode in rows:
                    continue
                rows[mode], _ = check_walk(
                    torch, f"a {stage} step's "
                    + ("specular rays" if inp["per_ray"] else "G-buffer"),
                    inp, name=f"culled_walk[{mode}]@heads")
        del r, v
        torch.cuda.empty_cache()
    if set(rows) != set(HEAD_MODES):
        raise SystemExit(f"[heads] captured modes {sorted(rows)}, expected "
                         f"{HEAD_MODES}")
    for mode in HEAD_MODES:
        rows[mode]["launches"] = total[mode]
    return rows


def phase_heads_reference(torch, path_mesh, tmp):
    """[heads-reference]: per head, one training step (full-width networks,
    pano REF_PANO) on the card against the same step on the CPU, from the
    same initial parameters (one seed) and the card's draws: rgb relative
    L2 1e-4, loss rel 1e-4, gradients relative L2 1e-3."""
    from texir_code_tpu_torch.train.exp import draw_seed

    for head, stage in HEAD_STAGES.items():
        res = {}
        draws = None
        for d in ("cuda", "cpu"):
            r = head_runner(head, path_mesh,
                            os.path.join(tmp, "head-ref-" + d), device=d,
                            sets=("train.pano_img_res=[{},{}]".format(
                                *REF_PANO),))
            (v,) = r.prepare_views([0])
            b = v["view"][0].numel() // 3
            if draws is None:
                draws = {k: x.cpu() for k, x in
                         r.model.draw(draw_seed(0), b).items()}
            t0 = time.time()
            out = r.model._forward(r.params, v["mvp"], v["pos"],
                                   view=v["view"], draws=draws)
            loss = r.loss(out, v, 0)
            loss.backward()
            res[d] = (out["rgb"].detach().cpu().numpy(), float(loss.detach()),
                      {k: p.grad.cpu().numpy()
                       for k, p in r.params.named_parameters()},
                      time.time() - t0)
        (rg, lg, gg, tg), (rc, lc, gc, tc) = res["cuda"], res["cpu"]
        rgb = float(np.linalg.norm(rg - rc) / np.linalg.norm(rc))
        rel = abs(lg - lc) / abs(lc)
        grad = max(float(np.linalg.norm(gg[k] - gc[k])
                         / max(np.linalg.norm(gc[k]), 1e-30)) for k in gc)
        log(f"[heads-reference] {stage} step card vs cpu (pano "
            f"{REF_PANO[0]}x{REF_PANO[1]}, "
            f"{b} pixels, full-width networks): rgb rel L2 {rgb:.3g}; loss "
            f"{lg:.7f} vs {lc:.7f} (rel {rel:.3g}); gradient rel L2 max "
            f"over {len(gc)} tensors {grad:.3g}; card {tg:.2f} s, CPU "
            f"{tc:.2f} s")
        if not (rgb <= 1e-4 and rel <= 1e-4 and grad <= 1e-3):
            raise SystemExit(f"[heads-reference] the {stage} step on the "
                             f"card disagrees with the CPU")


# ---------------------------------------------------------------------------
# the alternative material models: MaterialMLP and RednerMaterialModel
# ---------------------------------------------------------------------------


def alt_model(kind, syn, device):
    """MaterialMLP, or RednerMaterialModel with optim_cam over the export's
    camera ring, at the JAX defaults on the apartment, on `device`."""
    if kind == "mlp":
        from texir_code_tpu_torch.models.material_mlp import MaterialMLP

        return MaterialMLP(syn.mesh, syn.hdr_texture, pano_res=MLP_PANO,
                           sample_light=MLP_LIGHT, device=device)
    from texir_code_tpu_torch.models.material_redner import (
        RednerMaterialModel,
    )

    exts = []
    for pos in syn.camera_positions(VIEWS):
        e = np.eye(4, dtype=np.float32)
        e[0:3, 3] = pos
        exts.append(e)
    return RednerMaterialModel(
        syn.mesh, syn.hdr_texture, ids=[f"view{i:03d}" for i in range(VIEWS)],
        extrinsics=exts, optim_cam=True, texture_res=REDNER_TEX,
        pano_res=REDNER_PANO, sample_light=REDNER_LIGHT, device=device)


def alt_params(torch, kind, model):
    """The same parameters on any device, from one seed drawn on the CPU:
    the MLP's initialisation; Redner's textures U(0.1, 0.9) (a constant
    texture gives the pose no gradient) and its pose deltas at zero."""
    g = torch.Generator().manual_seed(5)
    if kind == "mlp":
        return model.init_params(g)
    p = model.init_params()
    with torch.no_grad():
        for k in ("albedo", "roughness"):
            p[k].copy_(torch.rand(p[k].shape, generator=g) * 0.8 + 0.1)
    return p


def alt_named(kind, params):
    return (dict(params.named_parameters()) if kind == "mlp"
            else dict(params))


def alt_step_loss(torch, kind, syn, model, params, view, target, seed=0,
                  draws=None):
    """A forward of `view` and the L1 of its log-domain colour to target."""
    from texir_code_tpu_torch.ops.shading import hdr_scale

    if kind == "mlp":
        out = model.forward(params, syn.camera_positions(VIEWS)[view],
                            seed=seed, draws=draws)
    else:
        out = model.forward(params, view, seed=seed, draws=draws)
    return (hdr_scale(out["rgb"]) - hdr_scale(target)).abs().mean(), out


def phase_alt_models(torch, syn):
    """[alt-models]: a few forward + backward + Adam steps of each model at
    the JAX defaults on the card (the steps of profile_once: a warm one, a
    timed one, a profiled one): ms a step, launches, idle share, peak
    memory, the BVH traversal's iterations and host syncs of the last
    cast; every loss finite and every parameter moved."""
    from texir_code_tpu_torch.ops.raycast import cast_rays_soa

    labels = {
        "mlp": f"MaterialMLP (MatNetwork 4x512, pano {MLP_PANO[0]}x"
               f"{MLP_PANO[1]}, sample_light {list(MLP_LIGHT)})",
        "redner": f"RednerMaterialModel (optim_cam, texture {REDNER_TEX}^2,"
                  f" pano {REDNER_PANO[0]}x{REDNER_PANO[1]}, sample_light "
                  f"{list(REDNER_LIGHT)})"}
    for kind, label in labels.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        model = alt_model(kind, syn, "cuda")
        params = alt_params(torch, kind, model)
        named = alt_named(kind, params)
        if kind == "mlp":
            opt = torch.optim.Adam(params.parameters(), lr=5e-4)
        else:  # the pose at 0.1x the textures' rate, as the reference
            opt = torch.optim.Adam([
                {"params": [named["albedo"], named["roughness"]], "lr": 1e-2},
                {"params": [named["cam_rot"], named["cam_trans"]],
                 "lr": 1e-3}])
        before = {k: v.detach().clone() for k, v in named.items()}
        h, w = model.pano_res
        target = (torch.rand((h, w, 3), generator=torch.Generator()
                             .manual_seed(6)) * 2).cuda()
        setup = time.time() - t0
        losses, it = [], iter(range(10 ** 6))

        def step():
            i = next(it)
            opt.zero_grad(set_to_none=True)
            loss, _ = alt_step_loss(torch, kind, syn, model, params,
                                    i % VIEWS, target, seed=i)
            loss.backward()
            opt.step()
            losses.append(loss.detach())

        wall, kern, n = profile_once(torch, "alt-models", f"one {label} "
                                     f"step", step, top=5)
        busy = sum(kern.values())
        stats = dict(cast_rays_soa.stats)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = [float(x) for x in losses]
        moved = {k: float((v.detach() - before[k]).abs().max())
                 for k, v in named.items()}
        log(f"[alt-models] {label}: set-up {setup:.2f} s; {len(vals)} steps, "
            f"a step {wall:.2f} ms wall, {n} launches, {busy:.2f} ms on the "
            f"card, idle share {max(0.0, 1 - busy / wall):.3f}; peak memory "
            f"{peak:.3f} GiB; the last BVH cast {stats}; losses "
            + ", ".join(f"{v:.6f}" for v in vals))
        if not np.isfinite(vals).all():
            raise SystemExit(f"[alt-models] {kind}: non-finite loss {vals}")
        still = [k for k, m in moved.items() if not m > 0]
        if still:
            raise SystemExit(f"[alt-models] {kind}: {still} did not move")
        del model, params, named, opt, before
        torch.cuda.empty_cache()


def band_rows(kind, model, rows):
    """Restrict a model to the pano rows `rows` of its views (their
    directions only; the draws are sliced alike)."""
    h, w = model.pano_res
    if kind == "mlp":
        model._pano_dirs = tuple(d.reshape(h, w)[rows].reshape(-1)
                                 .contiguous() for d in model._pano_dirs)
    else:
        model._cam_dirs = model._cam_dirs.reshape(h, w, 3)[rows].reshape(
            -1, 3).contiguous()
    model.pano_res = (rows.stop - rows.start, w)


def phase_alt_models_reference(torch, syn):
    """[alt-models-reference]: one step of each model on a band of ALT_BAND
    pano rows of view 1, on the card and on the CPU, from the same
    parameters and draws (the card's hash of the full view, sliced): rgb
    relative L2 1e-4, loss rel 1e-4, gradients relative L2 1e-3 (Redner's
    pose deltas included); then RenderLoss (stages 0 and 2) and
    msssim_loss on Mat-sized inputs, rel 1e-4."""
    from texir_code_tpu_torch.models.losses import RenderLoss, msssim_loss

    view = 1
    for kind in ("mlp", "redner"):
        res, draws = {}, None
        for d in ("cuda", "cpu"):
            model = alt_model(kind, syn, d)
            h, w = model.pano_res
            rows = slice(h // 2, h // 2 + ALT_BAND)
            if draws is None:
                draws = {k: v.reshape(h, w, -1)[rows].reshape(-1, 2).cpu()
                         for k, v in model.draw(11, h * w).items()}
            band_rows(kind, model, rows)
            params = alt_params(torch, kind, model)
            target = torch.rand((ALT_BAND, w, 3), generator=torch.Generator()
                                .manual_seed(7)) * 2
            t0 = time.time()
            loss, out = alt_step_loss(torch, kind, syn, model, params, view,
                                      target.to(d), draws=draws)
            loss.backward()
            res[d] = (out["rgb"].detach().cpu().numpy(), float(loss.detach()),
                      {k: p.grad.cpu().numpy()
                       for k, p in alt_named(kind, params).items()},
                      time.time() - t0)
            del model, params
        (rg, lg, gg, tg), (rc, lc, gc, tc) = res["cuda"], res["cpu"]
        rgb = float(np.linalg.norm(rg - rc) / np.linalg.norm(rc))
        rel = abs(lg - lc) / abs(lc)
        grads = {k: float(np.linalg.norm(gg[k] - gc[k])
                          / max(np.linalg.norm(gc[k]), 1e-30)) for k in gc}
        log(f"[alt-models-reference] {kind} step card vs cpu ({ALT_BAND} pano "
            f"rows x {rc.shape[1]}, view {view}): rgb rel L2 {rgb:.3g}; loss "
            f"{lg:.7f} vs {lc:.7f} (rel {rel:.3g}); gradient rel L2 "
            + ", ".join(f"{k} {v:.3g}" for k, v in grads.items())
            + f"; card {tg:.2f} s, CPU {tc:.2f} s")
        zero = [k for k in gc if not np.abs(gc[k]).max() > 0]
        if zero:
            raise SystemExit(f"[alt-models-reference] {kind}: no gradient "
                             f"for {zero}")
        if not (rgb <= 1e-4 and rel <= 1e-4 and max(grads.values()) <= 1e-3):
            raise SystemExit(f"[alt-models-reference] the {kind} step on the "
                             f"card disagrees with the CPU")
    rng = np.random.default_rng(8)
    f, h, w = 6, PANO[1] // 4, PANO[1] // 4
    arrays = dict(
        rgb=rng.uniform(0, 2, (f, h, w, 3)),
        albedo=rng.uniform(0, 1, (f, h, w, 3)),
        roughness=rng.uniform(0, 1, (f, h, w, 1)),
        empty_mask=rng.uniform(0, 1, (f, h, w, 1)) > 0.05,
        gt=rng.uniform(0, 2, (f, h, w, 3)),
        mask=rng.uniform(0, 1, (f, h, w, 1)) > 0.05,
        seg=rng.integers(0, 9, (f, h, w)),
        room=rng.integers(0, 3, (f, h, w)),
        a=rng.uniform(0, 1, (1,) + PANO + (3,)),
    )
    arrays["b"] = np.clip(arrays["a"] + rng.normal(0, 0.1, arrays["a"].shape),
                          0, 1)
    vals = {}
    for d in ("cuda", "cpu"):
        x = {k: torch.from_numpy(np.asarray(
            v, np.int64 if k in ("seg", "room") else np.float32)).to(d)
            for k, v in arrays.items()}
        preds = {k: x[k] for k in ("rgb", "albedo", "roughness",
                                   "empty_mask")}
        region = (x["seg"] > 0).float()[..., None]
        vals[d] = [
            float(RenderLoss()(x["gt"], preds, x["mask"], x["seg"], 9, 0)[0]),
            float(RenderLoss()(x["gt"], preds, x["mask"], x["seg"], 9, 2,
                               seg_region=region, room_id=x["room"],
                               num_rooms=3)[0]),
            float(msssim_loss(x["a"], x["b"]))]
    rels = [abs(a - b) / abs(b) for a, b in zip(vals["cuda"], vals["cpu"])]
    log(f"[alt-models-reference] RenderLoss stage 0 / 2 ({f} faces "
        f"{h}x{w}) and msssim_loss (pano {PANO[0]}x{PANO[1]}) card vs cpu: "
        + ", ".join(f"{a:.7f} vs {b:.7f}" for a, b in
                    zip(vals["cuda"], vals["cpu"]))
        + f"; rel {max(rels):.3g}")
    if not max(rels) <= 1e-4:
        raise SystemExit("[alt-models-reference] the losses on the card "
                         "disagree with the CPU")


# ---------------------------------------------------------------------------
# the building's quality recipe, cut: material export, IrrT, MatSyn, IRRF
# ---------------------------------------------------------------------------


def walk_mode_of(inp):
    from texir_code_tpu_torch.ops.pallas_culled import walk_mode

    return walk_mode(inp["per_ray"], inp["emit_uv"], inp["emit_prim"],
                     inp["seed"] is not None)


def cli_logged(argv):
    """cli.main(argv) with its standard output passed through and kept."""
    import contextlib
    import io

    from texir_code_tpu_torch import cli

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            sys.__stdout__.flush()
            return super().write(text)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_building_matsyn(torch, syn, tmp):
    """[building-matsyn]: the building's quality recipe
    (scripts/building_quality.py) cut to a smoke run: the material export
    with one camera a room and the novel view (gt_spp BUILDING_GT_SPP),
    IrrT at BUILDING_SYN_IRT² (fb 16, er 8, two-pass 0.25) and `train
    --trainstage MatSyn --max_epochs 1` through the port's CLI, the log's
    `roomseg active: n_rooms=` above 1; `train --trainstage IRRF
    --max_epochs 1` (a small validation); B1's launches by mode in each;
    B1 against its plain version on the first specular launch of MatSyn
    and the first GT-trace launch of IRRF; then one IRRF step card vs CPU
    ([irrf-reference]'s limits).  Returns the two kernel rows."""
    import glob
    import re

    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.scripts.building_quality import (
        Recipe,
        building_cameras,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    recipe = Recipe()
    cams = building_cameras(ROOMS)
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    path_mesh = export_reference_layout(
        syn, os.path.join(tmp, "building-syn"), pano_res=PANO,
        gt_render="material", gt_spp=BUILDING_GT_SPP, irt_spp=IRT_SPP,
        cameras=cams, device="cuda")
    torch.cuda.synchronize()
    root = os.path.dirname(os.path.dirname(path_mesh))
    with open(os.path.join(root, "info", "novel.txt"), "w") as f:
        f.write(f"view{len(cams) - 1:03d}\n")
    launches = dict(culled_walk_cuda.launches)
    log(f"[building-matsyn] material export: {len(cams)} views (one a room "
        f"and the novel view{len(cams) - 1:03d}) at {PANO[0]}x{PANO[1]}, "
        f"gt_spp {BUILDING_GT_SPP}, irt_spp {IRT_SPP}: "
        f"{time.time() - t0:.2f} s; culled_walk launches {launches}")
    _need_modes("building-matsyn", launches, ("shared_uv", "per_ray_prim"))

    exps = os.path.join(tmp, "building-syn-exps")
    sets = ["--set", f"train.path_mesh_open3d={path_mesh}"]
    culled_walk_cuda.launches.clear()
    t0 = time.time()
    cli_logged(["train", "--conf", os.path.join(here, "configs",
                                                "irt_synthetic.conf"),
                "--trainstage", "IrrT", "--irt_res", str(BUILDING_SYN_IRT),
                "--exps_folder", exps] + sets
               + [x for kv in recipe.irrt_sets for x in ("--set", kv)])
    torch.cuda.synchronize()
    launches = dict(culled_walk_cuda.launches)
    log(f"[building-matsyn] IrrT via cli at {BUILDING_SYN_IRT}^2 (fb 16, er "
        f"8, two-pass 0.25): {time.time() - t0:.2f} s with set-up; "
        f"culled_walk launches {launches}")
    _need_modes("building-matsyn", launches, ("shared_uv", "per_ray_uv"))

    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    log_text = []
    first = {walk_mode_of(inp): inp for inp in capture_walks(
        torch, lambda: log_text.append(cli_logged(
            ["train", "--conf", os.path.join(here, "configs",
                                             "mat_synthetic.conf"),
             "--trainstage", "MatSyn", "--max_epochs", "1", "--exps_folder",
             exps] + sets)), first_per_mode=True)}
    dt = time.time() - t0
    mat_launches = dict(culled_walk_cuda.launches)
    rooms = [int(x) for x in re.findall(r"roomseg active: n_rooms=(\d+)",
                                        log_text[0])]
    (tpath,) = glob.glob(os.path.join(exps, "Mat-default", "*",
                                      "timings.json"))
    with open(tpath) as f:
        tm = json.load(f)
    mm, nm, m = tm["material_metrics"], tm["novel_metrics"], tm["metrics"]
    steps = sum(tm[f"substage{k}"]["steps"] for k in range(3))
    log(f"[building-matsyn] MatSyn via cli, --max_epochs 1: {dt:.2f} s with "
        f"set-up ({steps} steps on {len(cams) - 1} training views, "
        + ", ".join(f"substage {k} "
                    f"{1e3 * tm[f'substage{k}']['step_s'] / tm[f'substage{k}']['steps']:.2f} ms a step"
                    for k in range(3))
        + f"); n_rooms {rooms}; culled_walk launches {mat_launches}")
    log(f"[building-matsyn]   re-render psnr {m['psnr']:.4f}; novel psnr "
        f"{nm['novel_psnr']:.4f}; mapped albedo psnr "
        f"{mm['albedo_psnr_mapped']:.4f}, mapped roughness psnr "
        f"{mm['roughness_psnr_mapped']:.4f} (1 epoch, not converged)")
    if not rooms or max(rooms) <= 1:
        raise SystemExit(f"[building-matsyn] the MatSyn log shows n_rooms "
                         f"{rooms}, not above 1")
    _need_modes("building-matsyn", mat_launches, ("shared_prim",
                                                  "per_ray_uv"))
    vals = list(m.values()) + list(nm.values()) + list(mm.values())
    if not np.isfinite(vals).all():
        raise SystemExit("[building-matsyn] non-finite metrics")
    rows = {}
    rows["per_ray_uv@building-matsyn"], _ = check_walk(
        torch, "the building's MatSyn specular rays",
        first["per_ray_uv"], plain_reps=0,
        name="culled_walk[per_ray_uv]@building-matsyn")
    rows["per_ray_uv@building-matsyn"]["launches"] = mat_launches.get(
        "per_ray_uv", 0)

    irrf_exps = os.path.join(tmp, "building-irrf")
    argv = ["train", "--conf", os.path.join(here, IRRF_CONF),
            "--trainstage", "IRRF", "--max_epochs", "1", "--exps_folder",
            irrf_exps] + sets
    for kv in BUILDING_IRRF_VAL:
        argv += ["--set", kv]
    culled_walk_cuda.launches.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    first = {walk_mode_of(inp): inp for inp in capture_walks(
        torch, lambda: cli_logged(argv), first_per_mode=True)}
    dt = time.time() - t0
    launches = dict(culled_walk_cuda.launches)
    tm = _field_timings(irrf_exps, "IRRF")
    log(f"[building-matsyn] IRRF via cli, --max_epochs 1 (validation "
        f"{', '.join(BUILDING_IRRF_VAL)}): {dt:.2f} s with set-up; "
        f"{tm['steps']} steps, {tm['ms_per_step']:.3f} ms a step; val_psnr "
        f"{tm['val_metrics']['val_psnr']:.4f}; culled_walk launches "
        f"{launches}")
    _need_modes("building-matsyn", launches, (IRRF_MODE,))
    if not np.isfinite([tm["last_loss"], tm["val_metrics"]["val_psnr"]]).all():
        raise SystemExit("[building-matsyn] IRRF: non-finite loss or "
                         "val_psnr")
    rows["per_ray_prim@building-irrf"], _ = check_walk(
        torch, "the building's IRRF step, 16 points x 2048", first[IRRF_MODE],
        plain_reps=0, name=f"culled_walk[{IRRF_MODE}]@building-irrf")
    rows["per_ray_prim@building-irrf"]["launches"] = launches.get(IRRF_MODE,
                                                                  0)
    # 2 points: the building's GT trace walks ~2,900 clusters a ray, and
    # the CPU's plain walk pays for every one
    phase_irrf_reference(torch, path_mesh, tmp, tag="building-matsyn",
                         points=2)
    return rows


# ---------------------------------------------------------------------------
# the multi-device paths: ranks that share the card (gloo), one NCCL rank
# ---------------------------------------------------------------------------


def rank_cmd(*args):
    """The command that runs this script as one rank (`--rank-*` modes)."""
    return [sys.executable, os.path.abspath(__file__), *map(str, args)]


def spawn_ranks(torch, phase, cmds, timeout):
    """Run the ranks' commands (parallel.dryrun.run_ranks: a failed rank
    ends the others and fails the phase); returns their outputs."""
    from texir_code_tpu_torch.parallel.dryrun import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    try:
        return run_ranks(cmds, timeout, env=dict(os.environ,
                                                 OMP_NUM_THREADS="4"),
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    except RuntimeError as e:
        raise SystemExit(f"[{phase}] {e}")


def rank_json(path):
    with open(path) as f:
        return json.load(f)


def params_digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_cli_main(out_path, argv):
    """(a rank) `cli.main(argv)` with the B1 launch counts and the
    collectives zeroed just before it and read just after; with a field
    stage under spmd, also its GT trace of one batch sharded against one
    rank's and a digest of the trained network.  Writes JSON."""
    import torch

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.parallel import mesh as pmesh
    from texir_code_tpu_torch.train.exp import draw_seed
    from texir_code_tpu_torch.train.irrf import FieldRunner

    seen = {}
    run = FieldRunner.run

    def run_and_check(self):
        out = run(self)
        torch.cuda.synchronize()
        seen["launches"] = dict(culled_walk_cuda.launches)
        seen["params_sha256"] = params_digest(self.model.network.parameters())
        mesh = self.model.spmd_mesh
        if mesh is not None:
            ds = self.train_dataset
            pts, nrm, ids = irrf_batch(torch, self, ds.points, ds.normals, 0,
                                       self.batch_size)
            gt = self.model.trace_gt(pts, nrm, self.env_res,
                                     draw_seed(10 ** 6), ids)
            self.model.spmd_mesh = None
            try:
                one = self.model.trace_gt(pts, nrm, self.env_res,
                                          draw_seed(10 ** 6), ids)
            finally:
                self.model.spmd_mesh = mesh
            seen["gt_rel"] = float((gt - one).abs().max() / one.abs().max())
            seen["gt_bit_equal"] = bool(torch.equal(gt, one))
        return out

    FieldRunner.run = run_and_check
    culled_walk_cuda.launches.clear()
    pmesh.COUNTS.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    res = dict(seconds=time.time() - t0,
               launches=dict(culled_walk_cuda.launches),
               collectives=dict(pmesh.COUNTS),
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    res.update(seen)
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def multi_cli(torch, phase, argv, n, out_dir, timeout=600):
    """`argv` through the port's CLI as n processes (--coordinator,
    --num_processes n, --process_id r) sharing the card: each rank's JSON
    (rank_cli_main) and its output."""
    from texir_code_tpu_torch.parallel.dryrun import free_port

    coord = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(out_dir, f"{phase}-rank{r}.json") for r in range(n)]
    logs = spawn_ranks(torch, phase, [
        rank_cmd("--rank-cli", outs[r], *argv, "--coordinator", coord,
                 "--num_processes", n, "--process_id", r)
        for r in range(n)], timeout)
    for r, text in enumerate(logs):
        line = next((l for l in text.splitlines()
                     if l.startswith("multihost:")), None)
        log(f"[{phase}]   rank {r}: {line}")
        if line is None:
            raise SystemExit(f"[{phase}] rank {r} printed no multihost line")
    return [rank_json(p) for p in outs], logs


def phase_spmd_bake(torch, path_mesh, tmp, slice_ref, slice_launches):
    """[spmd-bake]: `train --trainstage IrrT` at [slice]'s settings as two
    CLI processes (train.spmd=true) that share the card over gloo; the
    texture against [slice]'s single-process one, each rank's shared_uv
    launches against half of [slice]'s, one experiment directory."""
    from texir_code_tpu_torch.data import hdrio

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "irt_synthetic.conf")
    exps = os.path.join(tmp, "exps-spmd-bake")
    argv = ["train", "--conf", conf, "--trainstage", "IrrT", "--irt_res",
            IRT_RES, "--exps_folder", exps, "--set",
            f"train.path_mesh_open3d={path_mesh}", "--set",
            f"train.sample_light=[{SPP}, 16]", "--set", "train.spmd=true"]
    t0 = time.time()
    ranks, _ = multi_cli(torch, "spmd-bake", argv, 2, tmp)
    dt = time.time() - t0
    got = {k: hdrio.read_hdr(path_mesh.replace("out1.obj", k), flip=True)
           for k in ("0_irr_texture.hdr", "irt.hdr")}
    # later phases read [slice]'s texture: put it back
    for name, path in slice_ref.items():
        with open(path, "rb") as src, open(
                path_mesh.replace("out1.obj", name), "wb") as dst:
            dst.write(src.read())
    for name, tex in got.items():
        ref = hdrio.read_hdr(slice_ref[name], flip=True)
        diff = np.abs(tex - ref)
        rel = float((diff / np.maximum(np.abs(ref), 1e-30)).max())
        n_off = int((diff > 0).sum())
        log(f"[spmd-bake]   {name}: {n_off} of {tex.size} values differ "
            f"from [slice]'s (largest |d| {float(diff.max()):.3g}, largest "
            f"relative {rel:.3g})")
        if not rel <= 1e-6:
            raise SystemExit(f"[spmd-bake] {name} differs from the "
                             f"single-process bake")
    stamps = os.listdir(os.path.join(exps, "IrrT-default"))
    per_rank = [r["launches"].get("shared_uv", 0) for r in ranks]
    log(f"[spmd-bake] IrrT via cli on 2 ranks sharing the card (gloo): "
        f"{dt:.2f} s with start-up and set-up (ranks' stage "
        f"{', '.join(f'{r['seconds']:.2f}' for r in ranks)} s); shared_uv "
        f"launches a rank {per_rank} against [slice]'s {slice_launches}; "
        f"all-reduce {ranks[0]['collectives'].get('all_reduce_bytes', 0)} "
        f"bytes; peak {', '.join(f'{r['peak_mib']:.0f}' for r in ranks)} "
        f"MiB; experiment directories {stamps}")
    if len(stamps) != 1:
        raise SystemExit(f"[spmd-bake] {len(stamps)} experiment directories")
    if sum(per_rank) != slice_launches or any(
            abs(n - slice_launches / 2) > 1 for n in per_rank):
        raise SystemExit("[spmd-bake] the ranks' shared_uv launches are not "
                         "half of [slice]'s each")
    return per_rank


MAT_DP_STEPS = 3


def mat_runner_sets(torch, path_mesh, tmp, name, sets=()):
    """mat_runner with extra conf overrides."""
    from texir_code_tpu_torch.config import _parse_value, parse_file
    from texir_code_tpu_torch.train.material import MatTrainRunner

    conf_path, base = _mat_conf(path_mesh, PANO)
    conf = parse_file(conf_path)
    for kv in list(base[1::2]) + list(sets):
        k, _, v = kv.partition("=")
        conf.put(k.strip(), _parse_value(v.strip()))
    return MatTrainRunner(conf, exps_root=os.path.join(tmp, name),
                          max_epochs=1)


def mat_views(runner):
    runner.build_masks()
    views, n_rooms = runner._stack_epoch_data(list(range(VIEWS)))
    runner.check_view_order(views)
    return views, n_rooms


def mat_dp_steps(torch, runner, views, n_rooms):
    """MAT_DP_STEPS stage-2 steps through the runner (views 0, 1, ...):
    (losses, ms a step, the all-reduce's ms a step, the last step's
    gradients)."""
    mesh = runner.model.spmd_mesh
    reduce_ms = []
    if mesh is not None:
        reduce = mesh.all_reduce_grads

        def timed(tensors):
            torch.cuda.synchronize()
            t0 = time.time()
            reduce(tensors)
            torch.cuda.synchronize()
            reduce_ms.append(1e3 * (time.time() - t0))

        mesh.all_reduce_grads = timed
    opt, sched = mat_adam(runner)
    losses, step_ms = [], []
    for it in range(MAT_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, _ = runner._step(2, views[it % len(views)], n_rooms, it, opt,
                               sched)
        losses.append(loss.item())
        step_ms.append(1e3 * (time.time() - t0))
    p = runner.params
    return losses, step_ms, reduce_ms, (p.albedo.grad, p.roughness.grad)


def mat_tp_loss_grads(torch, runner, views, n_rooms):
    """One stage-2 loss and backward on view 0 (exact trilinear): (loss,
    albedo grad, roughness grad), this rank's rows under atlas TP."""
    p = runner.params
    for t in (p.albedo, p.roughness):
        t.requires_grad_(True)
        t.grad = None
    loss, _ = runner._loss_backward(2, views[0], n_rooms, 7)
    grads = (p.albedo.grad.clone(), p.roughness.grad.clone())
    for t in (p.albedo, p.roughness):
        t.requires_grad_(False)
        t.grad = None
    return loss.item(), grads


EXACT_SETS = ("models.render.mip_stochastic=false",
              "models.render.bilinear_stochastic=false")


def rank_mat_main(rank, world, coord, backend, path_mesh, tmp, out, modes):
    """(a rank) the data-parallel Mat steps ("spmd") and the atlas-TP
    step ("tp") at full width under deterministic algorithms; writes JSON
    and, from rank 0 (or each rank for "tp"), the tensors as .npy."""
    import torch

    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
    from texir_code_tpu_torch.parallel import mesh as pmesh
    from texir_code_tpu_torch.parallel.multihost import (
        initialize_multihost,
        shutdown_multihost,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    rank, world = int(rank), int(world)
    initialize_multihost(coord, world, rank, backend=backend)
    res = {"backend": backend}
    try:
        if "spmd" in modes:
            culled_walk_cuda.launches.clear()
            t0 = time.time()
            base = torch.cuda.memory_allocated()
            runner = mat_runner_sets(torch, path_mesh, tmp,
                                     f"exps-{out}-spmd", ("train.spmd=true",))
            views, n_rooms = mat_views(runner)
            torch.cuda.reset_peak_memory_stats()
            pmesh.COUNTS.clear()
            losses, step_ms, reduce_ms, grads = mat_dp_steps(
                torch, runner, views, n_rooms)
            p = runner.params
            res["spmd"] = dict(
                losses=losses, step_ms=step_ms, reduce_ms=reduce_ms,
                reduce_bytes=pmesh.COUNTS["all_reduce_bytes"] // MAT_DP_STEPS,
                seconds=time.time() - t0, base_mib=base / 2**20,
                peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                atlas_sha256=params_digest([p.albedo, p.roughness]),
                launches=dict(culled_walk_cuda.launches),
                shares=[[s.start, s.stop] for s in runner.model.pixel_shares(
                    views[0]["view"]["uv"].shape[0])[0]])
            if rank == 0:
                for name, t in (("grad_albedo", grads[0]),
                                ("grad_roughness", grads[1]),
                                ("albedo", p.albedo), ("roughness",
                                                       p.roughness)):
                    np.save(os.path.join(tmp, f"{out}-spmd-{name}.npy"),
                            t.detach().cpu().numpy())
            del runner, views
            torch.cuda.empty_cache()
        if "tp" in modes:
            culled_walk_cuda.launches.clear()
            t0 = time.time()
            base = torch.cuda.memory_allocated()
            runner = mat_runner_sets(torch, path_mesh, tmp, f"exps-{out}-tp",
                                     ("train.atlas_tp=true",) + EXACT_SETS)
            views, n_rooms = mat_views(runner)
            torch.cuda.reset_peak_memory_stats()
            loss, grads = mat_tp_loss_grads(torch, runner, views, n_rooms)
            res["tp"] = dict(
                loss=loss, seconds=time.time() - t0,
                rows=[runner.params.albedo.shape[0],
                      runner.params.roughness.shape[0]],
                launches=dict(culled_walk_cuda.launches), base_mib=base / 2**20,
                peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
            for name, t in zip(("albedo", "roughness"), grads):
                np.save(os.path.join(tmp, f"{out}-tp-r{rank}-{name}.npy"),
                        t.cpu().numpy())
    finally:
        shutdown_multihost()
    with open(os.path.join(tmp, f"{out}-r{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def rel_l2_np(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_spmd_mat(torch, path_mesh, tmp):
    """[spmd-mat] the data-parallel Mat stage-2 step at the apartment's
    full width (4 views, pano 256×512, albedo 2048², roughness 4096²,
    sample_light [32, 16], the stochastic knobs and occluders) on two
    ranks that share the card over gloo, MAT_DP_STEPS steps, deterministic
    algorithms, against this process's single steps from the same seeds;
    then the same as a one-rank NCCL group (bit-equal).  [atlas-tp] in the
    same two ranks: the atlases row-sharded, one exact-trilinear step
    against the replicated one.  The single-process references run here
    first and the ranks after them, so no timing shares the card with this
    process's work; the two ranks share it with each other (a rank's step
    and all-reduce are read while its sibling runs the same).  Peak memory:
    a process's high-water over the steps, less what it held before it
    built its runner (the runner's tensors included); that base is
    printed beside it."""
    from texir_code_tpu_torch.parallel.dryrun import free_port

    def ranks_cmds(out, world, backend, modes):
        coord = f"127.0.0.1:{free_port()}"
        return [rank_cmd("--rank-mat", r, world, coord, backend, path_mesh,
                         tmp, out, modes) for r in range(world)]

    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        base = torch.cuda.memory_allocated()
        runner = mat_runner_sets(torch, path_mesh, tmp, "exps-dp-one",
                                 ("train.spmd=false",))
        views, n_rooms = mat_views(runner)
        torch.cuda.reset_peak_memory_stats()
        m = runner.model
        m.mip_stochastic = m.bilinear_stochastic = False
        tp_loss, tp_grads = mat_tp_loss_grads(torch, runner, views, n_rooms)
        tp_grads = [g.cpu().numpy() for g in tp_grads]
        tp_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        one_base = base / 2**20
        m.mip_stochastic = m.bilinear_stochastic = True
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, _, grads = mat_dp_steps(torch, runner, views,
                                                 n_rooms)
        one = dict(losses=losses, step_ms=step_ms,
                   peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                   grads=[g.cpu().numpy() for g in grads],
                   atlases=[runner.params.albedo.detach().cpu().numpy(),
                            runner.params.roughness.detach().cpu().numpy()])
        del runner, views, m
    finally:
        torch.use_deterministic_algorithms(False)
    t_ref = time.time() - t0
    t1 = time.time()
    spawn_ranks(torch, "spmd-mat", ranks_cmds("dp", 2, "gloo", "spmd,tp"),
                900)
    t_ranks = time.time() - t1
    ranks = [rank_json(os.path.join(tmp, f"dp-r{r}.json")) for r in (0, 1)]
    log(f"[spmd-mat] the single-process references {t_ref:.2f} s; the two "
        f"gloo ranks {t_ranks:.2f} s with start-up and set-up (spmd part "
        f"{', '.join(f'{r['spmd']['seconds']:.2f}' for r in ranks)} s)")

    def check_dp(tag, rs, out, exact):
        sp = [r["spmd"] for r in rs]
        ga = np.load(os.path.join(tmp, f"{out}-spmd-grad_albedo.npy"))
        gr = np.load(os.path.join(tmp, f"{out}-spmd-grad_roughness.npy"))
        al = np.load(os.path.join(tmp, f"{out}-spmd-albedo.npy"))
        ro = np.load(os.path.join(tmp, f"{out}-spmd-roughness.npy"))
        loss_rel = max(abs(a - b) / abs(b) for s in sp
                       for a, b in zip(s["losses"], one["losses"]))
        g_rel = (rel_l2_np(ga, one["grads"][0]), rel_l2_np(gr, one["grads"][1]))
        a_rel = (rel_l2_np(al, one["atlases"][0]),
                 rel_l2_np(ro, one["atlases"][1]))
        same = len({s["atlas_sha256"] for s in sp}) == 1
        for r, s in enumerate(sp):
            log(f"[{tag}]   rank {r}: ms a step "
                f"{', '.join(f'{x:.2f}' for x in s['step_ms'])} (the first "
                f"sets up), the gradient all-reduce "
                f"{', '.join(f'{x:.2f}' for x in s['reduce_ms'])} ms a step "
                f"for {s['reduce_bytes']} bytes, peak {s['peak_mib']:.0f} "
                f"MiB over {s['base_mib']:.0f} held before, pixels "
                f"{s['shares']}; culled_walk launches (masks, "
                f"views, steps) {s['launches']}")
            _need_modes(tag, s["launches"], ("shared_prim", "per_ray_uv"))
        log(f"[{tag}]   single process: ms a step "
            f"{', '.join(f'{x:.2f}' for x in one['step_ms'])}, peak "
            f"{one['peak_mib']:.0f} MiB over {one_base:.0f} held before; "
            f"losses {sp[0]['losses']} vs "
            f"{one['losses']}: largest rel {loss_rel:.3g}; last step's "
            f"gradient rel L2 albedo {g_rel[0]:.3g}, roughness "
            f"{g_rel[1]:.3g}; atlases after {MAT_DP_STEPS} steps rel L2 "
            f"{a_rel[0]:.3g}, {a_rel[1]:.3g}; bit-equal across ranks: {same}")
        if not same:
            raise SystemExit(f"[{tag}] the atlases differ across ranks")
        if exact:
            bit = (loss_rel == 0 and np.array_equal(ga, one["grads"][0])
                   and np.array_equal(gr, one["grads"][1])
                   and np.array_equal(al, one["atlases"][0])
                   and np.array_equal(ro, one["atlases"][1]))
            if not bit:
                raise SystemExit(f"[{tag}] the one-rank group is not "
                                 f"bit-equal to the single process")
        elif not (loss_rel <= 1e-6 and max(g_rel) <= 1e-5
                  and max(a_rel) <= 1e-5):
            raise SystemExit(f"[{tag}] the data-parallel steps disagree "
                             f"with the single process's")

    check_dp("spmd-mat", ranks, "dp", exact=False)

    # [atlas-tp], from the same two ranks
    tp = [r["tp"] for r in ranks]
    got = [np.concatenate([np.load(os.path.join(
        tmp, f"dp-tp-r{r}-{name}.npy")) for r in (0, 1)])
        for name in ("albedo", "roughness")]
    loss_rel = max(abs(t["loss"] - tp_loss) / abs(tp_loss) for t in tp)
    err = [float(np.max(np.abs(g - ref) / (1e-7 + 1e-4 * np.abs(ref))))
           for g, ref in zip(got, tp_grads)]
    log(f"[atlas-tp] one exact-trilinear stage-2 step with the atlases "
        f"row-sharded ({tp[0]['rows']} rows a rank): losses "
        f"{[t['loss'] for t in tp]} vs replicated {tp_loss} (rel "
        f"{loss_rel:.3g}); gathered gradients' largest |d| / (1e-7 + 1e-4 "
        f"|ref|): albedo {err[0]:.3g}, roughness {err[1]:.3g}; rel L2 "
        f"{rel_l2_np(got[0], tp_grads[0]):.3g}, "
        f"{rel_l2_np(got[1], tp_grads[1]):.3g}; peak "
        f"{', '.join(f'{t['peak_mib']:.0f}' for t in tp)} MiB a rank over "
        f"{', '.join(f'{t['base_mib']:.0f}' for t in tp)} held before, vs "
        f"{tp_peak:.0f} replicated over {one_base:.0f}; {', '.join(f'{t['seconds']:.2f}' for t in tp)}"
        f" s a rank with set-up; culled_walk launches a rank (masks, views, "
        f"the step) {[t['launches'] for t in tp]}")
    for t in tp:
        _need_modes("atlas-tp", t["launches"], ("shared_prim", "per_ray_uv"))
    if not (loss_rel <= 1e-5 and max(err) <= 1.0):
        raise SystemExit("[atlas-tp] the row-sharded step disagrees with "
                         "the replicated one")

    # the same data-parallel steps as a one-rank NCCL group
    t1 = time.time()
    cmds = ranks_cmds("nccl", 1, "nccl", "spmd")
    spawn_ranks(torch, "spmd-mat", cmds, 600)
    nccl = [rank_json(os.path.join(tmp, "nccl-r0.json"))]
    log(f"[spmd-mat] one-rank NCCL group ({nccl[0]['backend']}): "
        f"{time.time() - t1:.2f} s with start-up and set-up")
    check_dp("spmd-mat", nccl, "nccl", exact=True)
    return time.time() - t0


def phase_spmd_irrf(torch, path_mesh, tmp):
    """[spmd-irrf] `train --trainstage IRRF --max_epochs 1` on two ranks
    sharing the card (MatNetwork 4×512; the validation cut to 64×128 ×
    [16, 32]): each rank traces half of each step's GT (B1 per_ray_prim);
    one batch's GT sharded against one rank's; the networks bit-equal
    across ranks after the run."""
    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["train", "--conf", os.path.join(here, IRRF_CONF),
            "--trainstage", "IRRF", "--max_epochs", "1", "--exps_folder",
            os.path.join(tmp, "exps-spmd-irrf"), "--set",
            f"train.path_mesh_open3d={path_mesh}", "--set",
            "train.spmd=true"]
    for kv in IRF_VAL:
        argv += ["--set", kv]
    t0 = time.time()
    ranks, _ = multi_cli(torch, "spmd-irrf", argv, 2, tmp)
    dt = time.time() - t0
    for r, res in enumerate(ranks):
        log(f"[spmd-irrf]   rank {r}: stage {res['seconds']:.2f} s, "
            f"culled_walk launches {res['launches']}, all_gather "
            f"{res['collectives'].get('all_gather', 0)} calls "
            f"{res['collectives'].get('all_gather_bytes', 0)} bytes; one "
            f"batch's GT vs one rank's: rel {res['gt_rel']:.3g} (bit-equal "
            f"{res['gt_bit_equal']}); peak {res['peak_mib']:.0f} MiB")
    same = len({r["params_sha256"] for r in ranks}) == 1
    log(f"[spmd-irrf] IRRF via cli on 2 ranks: {dt:.2f} s with start-up; "
        f"networks bit-equal across ranks: {same}")
    for r in ranks:
        _need_modes("spmd-irrf", r["launches"], (IRRF_MODE,))
    if not same or any(r["gt_rel"] > 1e-6 for r in ranks):
        raise SystemExit("[spmd-irrf] the sharded GT or the networks "
                         "disagree")
    return [r["launches"].get(IRRF_MODE, 0) for r in ranks]


def phase_dryrun(torch):
    """[dryrun] parallel.dryrun.dryrun_multichip(2, "cuda")."""
    from texir_code_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.time()
    try:
        res = dryrun_multichip(2, "cuda")
    except RuntimeError as e:
        raise SystemExit(f"[dryrun] {e}")
    log(f"[dryrun] dryrun_multichip(2, 'cuda'): {res} in "
        f"{time.time() - t0:.2f} s")


def rank_main(argv):
    """The `--rank-*` modes: this script as one rank of a phase."""
    if argv[0] == "--rank-cli":
        return rank_cli_main(argv[1], argv[2:])
    if argv[0] == "--rank-mat":
        return rank_mat_main(*argv[1:8], modes=argv[8].split(","))
    raise SystemExit(f"unknown mode {argv[0]!r}")


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
    if len(sys.argv) > 1 and sys.argv[1].startswith("--rank-"):
        return rank_main(sys.argv[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
    last = [t_start]

    def mark(label):  # a phase's seconds, for the time budget
        now = time.time()
        log(f"[time] {label} {now - last[0]:.1f} s (at {now - t_start:.1f} s)")
        last[0] = now

    name, count, _ = phase_device(torch)
    phase_build()
    syn, clusters, occ = bench_scene(dev)
    rows = phase_kernels(torch, dev, clusters, occ, syn)
    mark("[build] and [kernels]")
    rows.update(phase_wedged(torch, dev, clusters, occ, syn))
    mark("[wedged]")
    rows.update(phase_mat_kernels(torch, dev, syn))
    fan_rows = phase_fan_kernels(torch, dev, syn, clusters)
    rows["shared_uv_visits"] = phase_visits(torch, dev, clusters, occ, syn)
    s_rows = phase_sampler_kernels(torch, dev, syn)
    b = building_scene(torch, dev)
    rows.update(phase_building_kernels(torch, dev, b))
    phase_bvh(torch, dev, syn, clusters)
    mark("[mat-kernels] to [bvh]")
    phase_tiled(torch, dev, clusters, occ, syn)
    mark("[tiled]")
    with tempfile.TemporaryDirectory() as tmp:
        path_mesh = phase_export(torch, syn, tmp)
        rows["shared_uv"]["launches"] = phase_slice(torch, syn, path_mesh,
                                                    IRT_RES, tmp)
        # [slice]'s textures, for [spmd-bake]
        slice_ref = {}
        for tex in ("0_irr_texture.hdr", "irt.hdr"):
            slice_ref[tex] = os.path.join(tmp, "slice-" + tex)
            with open(path_mesh.replace("out1.obj", tex), "rb") as src, \
                    open(slice_ref[tex], "wb") as dst:
                dst.write(src.read())
        mark("[export] and [slice]")
        rows["shared_uv@azimuth"] = phase_azimuth_bake(
            torch, dev, clusters, occ, syn, path_mesh, tmp)
        mark("[azimuth-bake]")
        launches, _ = phase_mat(torch, path_mesh, tmp)
        for mode in ("shared_prim", "per_ray_uv"):
            rows[mode]["launches"] = launches[mode]
        fan_launches = phase_fan_slice(torch, path_mesh, tmp)
        fan_launches.update({
            k: v for k, v in phase_fan_mat(torch, dev, path_mesh, tmp,
                                           syn).items() if k != "shared_uv"})
        for mode in FAN_MODES:
            fan_rows[mode]["launches"] = fan_launches[mode]
        rows["per_ray_prim"]["launches"] = fan_launches["culled:per_ray_prim"]
        mark("[mat] to [fan-mat]")
        phase_error(torch, path_mesh, tmp, os.path.join(tmp, "exps"))
        mark("[error]")
        phase_testers(torch, syn, path_mesh, os.path.join(tmp, "exps"))
        mark("[testers]")
        phase_pathtrace(torch, path_mesh, os.path.join(tmp, "exps"))
        phase_pathtrace_reference(torch, dev, path_mesh,
                                  os.path.join(tmp, "exps"))
        phase_tools(torch, path_mesh, os.path.join(tmp, "exps"), tmp)
        mark("[pathtrace] to [tools]")
        phase_profile(torch, dev, clusters, occ, syn)
        phase_mat_profile(torch, path_mesh, tmp)
        mark("[profile] and [mat-profile]")
        phase_profiling(torch, path_mesh, tmp)
        mark("[profiling]")
        s_rows["sorted"]["launches"] = phase_mat_segsum(torch, dev, path_mesh,
                                                        tmp, syn)
        mark("[mat-segsum]")
        syn_path, _, _ = phase_syn_export(torch, syn, tmp)
        phase_matsyn(torch, syn_path, tmp)
        mark("[syn-export] and [matsyn]")
        head_rows = phase_heads(torch, syn_path, tmp)
        phase_heads_reference(torch, syn_path, tmp)
        mark("[heads] and [heads-reference]")
        phase_alt_models(torch, syn)
        mark("[alt-models]")
        phase_alt_models_reference(torch, syn)
        mark("[alt-models-reference]")
        irrf_rows = phase_irrf_kernels(torch, path_mesh, tmp)
        phase_irrf_reference(torch, path_mesh, tmp)
        mark("[irrf-kernels] and [irrf-reference]")
        (irrf_rows["irrf-step"]["launches"],
         irrf_rows["irrf-val"]["launches"]) = phase_fields(torch, path_mesh,
                                                           tmp)
        mark("[irrf], [irf] and [pil]")
        t_phase = time.time()
        phase_spmd_bake(torch, path_mesh, tmp, slice_ref,
                        rows["shared_uv"]["launches"])
        log(f"[time] [spmd-bake] {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        phase_spmd_mat(torch, path_mesh, tmp)
        log(f"[time] [spmd-mat] and [atlas-tp] {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        phase_spmd_irrf(torch, path_mesh, tmp)
        log(f"[time] [spmd-irrf] {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        phase_dryrun(torch)
        log(f"[time] [dryrun] {time.time() - t_phase:.1f} s")
        mark("the multi-rank phases")
        bpath = phase_building_export(torch, b["syn"], tmp)
        launches = phase_building_proxy(torch, b["syn"], bpath, tmp)
        mark("[building-export] and [building-proxy]")
        rows["shared_uv_seeded"]["launches"] = launches["shared_uv_seeded"]
        launches, _ = phase_building_slice(torch, b["syn"], bpath, tmp)
        mark("[building-slice]")
        for mode in ("shared_uv", "per_ray_uv"):
            rows[mode + "@building"]["launches"] = launches[mode]
        launches = phase_building_mat(torch, bpath, tmp)
        mark("[building-mat]")
        for mode in ("shared_prim_seeded", "per_ray_uv_seeded"):
            rows[mode]["launches"] = launches[mode]
        phase_building_profile(torch, dev, b, bpath, tmp)
        mark("[building-profile]")
        rows.update(phase_building_matsyn(torch, b["syn"], tmp))
        mark("[building-matsyn]")
    phase_reference(torch, dev, clusters, occ, syn)
    phase_mat_reference(torch, dev, syn)
    phase_error_reference(torch, dev, syn)
    phase_relit_reference(torch, dev, syn)
    phase_building_reference(torch, dev, b)
    mark("the card-vs-CPU references")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[k] for k in (
        "shared_uv", "shared_prim", "per_ray_uv", "shared_uv@building",
        "shared_uv_seeded", "per_ray_uv@building", "shared_prim_seeded",
        "per_ray_uv_seeded", "per_ray_prim", "shared_uv_visits")]
        + [fan_rows[m] for m in FAN_MODES]
        + [s_rows["unsorted"], s_rows["sorted"]]
        + [irrf_rows["irrf-step"], irrf_rows["irrf-val"]]
        + [head_rows[m] for m in HEAD_MODES]
        + [rows["per_ray_prim@building-irrf"],
           rows["per_ray_uv@building-matsyn"]]
        + [rows[k] for k in ("shared_uv@azimuth", "shared_uv@wedged",
                             "shared_prim@wedged")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
