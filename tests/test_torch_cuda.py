"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions.  Every test here is marked `cuda` and skips without a card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with the card and no jax; there the repository's conftest (which
imports jax) is bypassed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from texir_code_tpu_torch.data.synthetic import make_apartment_scene
from texir_code_tpu_torch.geometry.bvh import build_bvh
from texir_code_tpu_torch.geometry.occluders import extract_occluders
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.fan_raycast import FanScene
from texir_code_tpu_torch.ops.raycast import RayHit
from texir_code_tpu_torch.ops.sampling import generate_dir_soa

torch.set_num_threads(2)  # six test workers share the host's cores

TEXELS, SPP, WEDGES, FAN_BLOCK, EXIT_ROWS = 64, 512, 4, 32, 16
TOL = 1e-5  # the CUDA and plain walks round alike (no FMA, IEEE 1/x)


@pytest.fixture(scope="module")
def walk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    scene = T.ClusterScene.from_fan(fan, lb=4, dense=True, device="cpu")
    occ = extract_occluders(syn.mesh, device="cpu")
    rng = np.random.default_rng(2)
    centers = rng.uniform(0.5, 2.5, (TEXELS // 16, 3)).astype(np.float32)
    pts = np.repeat(centers, 16, axis=0) + rng.uniform(-0.1, 0.1, (TEXELS, 3))
    nrm = rng.standard_normal((TEXELS, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    n = torch.from_numpy(nrm.astype(np.float32))
    dirs = generate_dir_soa(tuple(n[:, k] for k in range(3)), SPP,
                            row_ids=torch.arange(TEXELS), seed=3)
    rows_d = tuple(T.wedge_rows(a, WEDGES).contiguous()
                   for a in T.sort_dirs_octant(dirs))
    p = torch.from_numpy(pts.astype(np.float32))
    rows_o = tuple(T.tile_rows(p[:, k], WEDGES) for k in range(3))
    cand, count, dist = T.cull_blocks(scene, rows_o, rows_o, rows_d,
                                      EXIT_ROWS, occluders=occ)
    g = count.numel()
    args = dict(
        count=count.reshape(g), cand=cand.reshape(g, -1).contiguous(),
        dist=dist.reshape(g, -1).contiguous(),
        t_cap=float(np.float32(1.05) * np.float32(scene.diameter)),
        origins=torch.stack(rows_o, -1).contiguous(),
        dx=rows_d[0], dy=rows_d[1], dz=rows_d[2],
        rows3=scene.rows3, prims3=scene.prims3, er=EXIT_ROWS,
    )
    return dict(scene=scene, occ=occ, rows_o=rows_o, rows_d=rows_d,
                args=args)


def _cuda(args):
    return {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in args.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("emit_uv,emit_prim", [(True, False), (False, True),
                                               (True, True), (False, False)])
def test_kernel_matches_plain(walk, emit_uv, emit_prim):
    ref = T.culled_walk_plain(**walk["args"], emit_uv=emit_uv,
                              emit_prim=emit_prim)
    before = sum(T.culled_walk_cuda.launches.values())
    got = T.culled_walk_cuda(**_cuda(walk["args"]), emit_uv=emit_uv,
                             emit_prim=emit_prim)
    torch.cuda.synchronize()
    assert sum(T.culled_walk_cuda.launches.values()) == before + 1
    t0, p0, u0, v0 = (a.numpy() for a in ref)
    t1, p1, u1, v1 = (a.cpu().numpy() for a in got)
    assert np.array_equal(np.isfinite(t0), np.isfinite(t1))
    fin = np.isfinite(t0)
    assert np.abs(np.where(fin, t0 - t1, 0.0)).max() <= TOL
    tie = p0 != p1  # a t-tie: another triangle at the same t won
    assert tie.mean() < 1e-3
    assert np.abs(np.where(tie, 0.0, u0 - u1)).max() <= TOL
    assert np.abs(np.where(tie, 0.0, v0 - v1)).max() <= TOL
    if not emit_prim:
        assert (p1 == -1).all()


@pytest.mark.cuda
def test_cast_fans_culled_dispatches_on_device(walk):
    dev = torch.device("cuda")
    scene = walk["scene"]
    cs = T.ClusterScene(
        rows3=scene.rows3.to(dev), prims3=scene.prims3.to(dev),
        cluster_lo=scene.cluster_lo.to(dev),
        cluster_hi=scene.cluster_hi.to(dev), diameter=scene.diameter,
        lb=scene.lb, has_uv=scene.has_uv)
    occ = walk["occ"]
    occ_d = type(occ)(occ.axis, occ.p.to(dev), occ.rect_lo.to(dev),
                      occ.rect_hi.to(dev), occ.sep_margin)
    before = T.culled_walk_cuda.launches["shared_uv"]
    hd = T.cast_fans_culled(cs, tuple(a.to(dev) for a in walk["rows_o"]),
                            tuple(a.to(dev) for a in walk["rows_d"]),
                            fan_block=FAN_BLOCK, exit_rows=EXIT_ROWS,
                            emit_uv=True, occluders=occ_d)
    hc = T.cast_fans_culled(scene, walk["rows_o"], walk["rows_d"],
                            fan_block=FAN_BLOCK, exit_rows=EXIT_ROWS,
                            emit_uv=True, occluders=occ)
    assert T.culled_walk_cuda.launches["shared_uv"] == before + 1
    for a, b in ((hd.t, hc.t), (hd.u, hc.u), (hd.v, hc.v)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=TOL)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(walk):
    args = _cuda(walk["args"])
    with pytest.raises(TypeError):
        T.culled_walk_cuda(**dict(args, dist=args["dist"].double()))
    with pytest.raises(ValueError):
        T.culled_walk_cuda(**dict(args, dx=args["dx"][:, :-1]))
    with pytest.raises(ValueError):
        T.culled_walk_cuda(**dict(args, count=args["count"].cpu()))


# ---------------------------------------------------------------------------
# the Mat step's shapes: per-ray origins (specular) and the G-buffer, lb 4/8
# ---------------------------------------------------------------------------


def _scene_lb(lb):
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    return (syn, T.ClusterScene.from_fan(fan, lb=lb, dense=True, device="cpu"),
            extract_occluders(syn.mesh, device="cpu"))


def _to(scene, occ, dev):
    cs = T.ClusterScene(
        rows3=scene.rows3.to(dev), prims3=scene.prims3.to(dev),
        cluster_lo=scene.cluster_lo.to(dev),
        cluster_hi=scene.cluster_hi.to(dev), diameter=scene.diameter,
        lb=scene.lb, has_uv=scene.has_uv)
    oc = type(occ)(occ.axis, occ.p.to(dev), occ.rect_lo.to(dev),
                   occ.rect_hi.to(dev), occ.sep_margin)
    return cs, oc


def _rays(shape, rows, r, seed):
    """Per-ray rows (specular: tight origin clusters, random directions) or
    shared-origin rows (G-buffer: one camera, coherent cones)."""
    rng = np.random.default_rng(seed)
    size = np.array([8.0, 3.0, 5.0], np.float32)
    if shape == "per_ray":
        c = rng.uniform(0.3, 1.0, (rows, 1, 3)) * (size - 0.6) + 0.3
        o = (c + rng.uniform(-0.05, 0.05, (rows, r, 3))).astype(np.float32)
        d = rng.standard_normal((rows, r, 3))
        origins = tuple(torch.from_numpy(np.ascontiguousarray(o[..., k]))
                        for k in range(3))
    else:
        axis = rng.standard_normal((rows, 1, 3))
        d = axis + 0.3 * rng.standard_normal((rows, r, 3))
        origins = tuple(torch.full((rows,), float(x)) for x in size / 2)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dirs = tuple(torch.from_numpy(np.ascontiguousarray(d[..., k]))
                 for k in range(3))
    return origins, dirs


SHAPES = {
    # the specular trace: per-ray origins, one exit group per row, emit_uv
    "per_ray": dict(per_ray=True, fan_block=8, exit_rows=1, emit_uv=True),
    # the G-buffer: shared origin, one group per 8-row block, prim + bary
    "gbuffer": dict(fan_block=8, exit_rows=0, emit_prim=True, t_min=1e-6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("occluders", [False, True])
@pytest.mark.parametrize("lb", [4, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mat_shapes_match_plain(shape, lb, occluders):
    """cast_fans_culled on the card (the CUDA walk, per-ray exit) against
    the CPU (the plain walk, group exit) at the Mat step's two shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    _, scene, occ = _scene_lb(lb)
    rows, r = (24, 1024) if shape == "per_ray" else (12, 2048)
    o, d = _rays(shape, rows, r, seed=lb)
    dev = torch.device("cuda")
    cs, oc = _to(scene, occ, dev)
    kw = dict(SHAPES[shape])
    mode = T.walk_mode(shape == "per_ray", kw.get("emit_uv", False),
                       kw.get("emit_prim", not kw.get("emit_uv", False)))
    before = T.culled_walk_cuda.launches[mode]
    hd = T.cast_fans_culled(cs, tuple(a.to(dev) for a in o),
                            tuple(a.to(dev) for a in d),
                            occluders=oc if occluders else None, **kw)
    torch.cuda.synchronize()
    assert T.culled_walk_cuda.launches[mode] == before + 1
    hc = T.cast_fans_culled(scene, o, d, occluders=occ if occluders else None,
                            **kw)
    t0, p0, u0, v0 = (a.numpy() for a in (hc.t, hc.prim, hc.u, hc.v))
    t1, p1, u1, v1 = (a.cpu().numpy() for a in (hd.t, hd.prim, hd.u, hd.v))
    assert np.isfinite(t0).mean() > 0.99
    assert np.array_equal(np.isfinite(t0), np.isfinite(t1))
    fin = np.isfinite(t0)
    assert np.abs(np.where(fin, t0 - t1, 0.0)).max() <= TOL
    tie = p0 != p1
    assert tie.mean() < 1e-3
    assert np.abs(np.where(tie, 0.0, u0 - u1)).max() <= TOL
    assert np.abs(np.where(tie, 0.0, v0 - v1)).max() <= TOL


@pytest.mark.cuda
def test_per_ray_wrapper_names_origin_layout():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    _, scene, _ = _scene_lb(8)
    o, d = _rays("per_ray", 8, 128, seed=1)
    dev = torch.device("cuda")
    cs, _ = _to(scene, _scene_lb(8)[2], dev)
    cand, count, dist = T.cull_blocks(
        cs, tuple(a.amin(1).to(dev) for a in o),
        tuple(a.amax(1).to(dev) for a in o), tuple(a.to(dev) for a in d), 1)
    g = count.numel()
    args = dict(count=count.reshape(g), cand=cand.reshape(g, -1).contiguous(),
                dist=dist.reshape(g, -1).contiguous(), t_cap=10.0,
                dx=d[0].to(dev), dy=d[1].to(dev), dz=d[2].to(dev),
                rows3=cs.rows3, prims3=cs.prims3, er=1, per_ray=True)
    with pytest.raises(ValueError, match=r"per_ray: \[3, rows, R\]"):
        T.culled_walk_cuda(origins=torch.stack(o, -1).to(dev), **args)


# ---------------------------------------------------------------------------
# the Mat step on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_material_step_card_matches_cpu():
    """One stage-2 forward + loss + backward on the card against the CPU
    with the same injected sample shifts: loss within rel 1e-4, gradients
    within relative L2 1e-3 (atomics reorder the scatter-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    from texir_code_tpu_torch.data.synthetic import make_scene
    from texir_code_tpu_torch.models.losses import render_loss
    from texir_code_tpu_torch.models.material import MaterialModel, MaterialParams
    from texir_code_tpu_torch.ops.gbuffer import cube_mvp

    torch.backends.cudnn.allow_tf32 = False
    scene = make_scene(atlas_res=48)
    rng = np.random.default_rng(5)
    irt = rng.uniform(0.5, 2.0, (64, 64, 3)).astype(np.float32)
    albedo = rng.uniform(0.2, 0.8, (64, 64, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (128, 128, 1)).astype(np.float32)
    pos = scene.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = cube_mvp(ext)
    res = 32
    shift = rng.uniform(0, 1, (6 * res * res, 5)).astype(np.float32)
    gt = rng.uniform(0, 1.5, (6, res, res, 3)).astype(np.float32)
    seg = rng.integers(0, 6, (6, res, res))
    out = {}
    for dev in ("cuda", "cpu"):
        m = MaterialModel(scene.mesh, scene.hdr_texture, irt, pano_res=(64, 128),
                          sample_light=(32, 16), device=dev,
                          render_knobs=dict(mip_stochastic=True,
                                            bilinear_stochastic=True,
                                            use_occluders=True))
        p = MaterialParams(torch.tensor(albedo, device=dev, requires_grad=True),
                           torch.tensor(rough, device=dev, requires_grad=True))
        o = m._forward(p, mvp, pos, 2, spec_shift=torch.from_numpy(shift))
        ones = torch.ones((6, res, res, 1), device=dev)
        loss, _ = render_loss(torch.from_numpy(gt).to(dev), o, ones,
                              torch.from_numpy(seg).to(dev), 7, 2,
                              seg_region=ones)
        loss.backward()
        out[dev] = (loss.item(), p.albedo.grad.cpu().numpy(),
                    p.roughness.grad.cpu().numpy())
    (lg, ag, rg), (lc, ac, rc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for a, b in ((ag, ac), (rg, rc)):
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)


@pytest.mark.cuda
def test_mat_cli_on_card(tmp_path):
    """The Mat stage through the CLI on the card at a small size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    import json
    import os

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio

    out = str(tmp_path / "data")
    cli.main(["demo", "--out", out, "--views", "2", "--atlas_res", "48"])
    path = os.path.join(out, "mesh", "out1.obj")
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    np.full((64, 64, 3), 1.5, np.float32), flip=True)
    T.culled_walk_cuda.launches.clear()
    conf = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "mat_synthetic.conf")
    assert cli.main([
        "train", "--conf", conf, "--trainstage", "Mat", "--max_epochs", "1",
        "--exps_folder", str(tmp_path / "exps"),
        "--set", f"train.path_mesh_open3d={path}",
        "--set", "train.pano_img_res=[64,128]",
        "--set", "train.mat_albedo_res=64", "--set", "train.mat_roughness_res=64",
    ]) == 0
    assert T.culled_walk_cuda.launches["shared_prim"] > 0
    assert T.culled_walk_cuda.launches["per_ray_uv"] > 0
    (root,) = [r for r, _, f in os.walk(tmp_path / "exps") if "timings.json" in f]
    with open(os.path.join(root, "timings.json")) as f:
        assert np.isfinite(json.load(f)["metrics"]["psnr"])


# ---------------------------------------------------------------------------
# the multi-room path: the seeded modes and the two-pass trace
# ---------------------------------------------------------------------------


def _building(lb):
    from texir_code_tpu_torch.data.synthetic import make_building_scene

    syn = make_building_scene(atlas_res=32, rooms=(2, 2), subdiv=3,
                              clutter_per_room=1)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    return (T.ClusterScene.from_fan(fan, lb=lb, dense=True, device="cpu"),
            T.ClusterScene.proxy_from_fan(fan, k=64, device="cpu"),
            extract_occluders(syn.mesh, device="cpu"))


def _building_rays(mode, rows, r, seed):
    """Bake rows (shared origins, full-sphere directions, octant-sorted),
    G-buffer rows (one camera, coherent cones) or specular rows (per-ray
    origins) inside the 10 m × 10 m building."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.4, 0.3, 0.4]), np.array([9.6, 2.7, 9.6])
    if mode == "per_ray_uv":
        o = (rng.uniform(lo, hi, (rows, 1, 3))
             + rng.uniform(-0.05, 0.05, (rows, r, 3))).astype(np.float32)
        d = rng.standard_normal((rows, r, 3))
        origins = tuple(torch.from_numpy(np.ascontiguousarray(o[..., k]))
                        for k in range(3))
    elif mode == "shared_prim":
        d = (rng.standard_normal((rows, 1, 3))
             + 0.3 * rng.standard_normal((rows, r, 3)))
        origins = tuple(torch.full((rows,), c) for c in (2.5, 1.5, 2.5))
    else:
        d = rng.standard_normal((rows, r, 3))
        p = np.repeat(rng.uniform(lo, hi, (rows // 4, 3)), 4, 0)
        origins = tuple(torch.from_numpy(p[:, k].astype(np.float32))
                        for k in range(3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dirs = tuple(torch.from_numpy(np.ascontiguousarray(d[..., k]))
                 for k in range(3))
    if mode == "shared_uv":
        dirs = T.sort_dirs_octant(dirs)
    return origins, dirs


BUILDING_MODES = {
    "shared_uv": (dict(fan_block=16, exit_rows=8, emit_uv=True), 4),
    "shared_prim": (dict(fan_block=8, exit_rows=0, emit_prim=True,
                         t_min=1e-6), 8),
    "per_ray_uv": (dict(fan_block=8, exit_rows=1, per_ray=True,
                        emit_uv=True), 8),
}


def _assert_hits_match(hc, hd):
    t0, p0, u0, v0 = (a.numpy() for a in (hc.t, hc.prim, hc.u, hc.v))
    t1, p1, u1, v1 = (a.cpu().numpy() for a in (hd.t, hd.prim, hd.u, hd.v))
    assert np.array_equal(np.isfinite(t0), np.isfinite(t1))
    fin = np.isfinite(t0)
    assert np.abs(np.where(fin, t0 - t1, 0.0)).max() <= TOL
    tie = (p0 != p1) | (np.abs(u0 - u1) > TOL) | (np.abs(v0 - v1) > TOL)
    assert tie.mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(BUILDING_MODES))
def test_seeded_modes_match_plain(mode):
    """The seeded walk on the card (the proxy's hits as the seed) against
    the plain walk on the CPU, and against the card's unseeded walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    kw, lb = BUILDING_MODES[mode]
    scene, proxy, occ = _building(lb)
    o, d = _building_rays(mode, 32, 512, seed=lb)
    dev = torch.device("cuda")
    cs, oc = _to(scene, occ, dev)
    ps, _ = _to(proxy, occ, dev)
    od, dd = tuple(a.to(dev) for a in o), tuple(a.to(dev) for a in d)
    before = T.culled_walk_cuda.launches[mode + "_seeded"]
    hd = T.cast_fans_culled(cs, od, dd, proxy=ps, occluders=oc, **kw)
    torch.cuda.synchronize()
    assert T.culled_walk_cuda.launches[mode + "_seeded"] == before + 1
    hc = T.cast_fans_culled(scene, o, d, proxy=proxy, occluders=occ, **kw)
    _assert_hits_match(hc, hd)
    hu = T.cast_fans_culled(cs, od, dd, occluders=oc, **kw)
    _assert_hits_match(hc, hu)


@pytest.mark.cuda
def test_seed_wrapper_checks_layout():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    kw, lb = BUILDING_MODES["shared_uv"]
    scene, proxy, occ = _building(lb)
    o, d = _building_rays("shared_uv", 16, 128, seed=1)
    dev = torch.device("cuda")
    cs, oc = _to(scene, occ, dev)
    od, dd = tuple(a.to(dev) for a in o), tuple(a.to(dev) for a in d)
    seed = T.cast_fans_culled(cs, od, dd, occluders=oc, **kw)
    bad = RayHit(t=seed.t.double(), prim=seed.prim, u=seed.u, v=seed.v)
    with pytest.raises(TypeError, match="seed t"):
        T.cast_fans_culled(cs, od, dd, seed=bad, occluders=oc, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("proxy", [False, True])
def test_twopass_batch_matches_plain(proxy):
    """One two-pass bake batch (fan_block 16, exit_rows 8, cut 0.25) on the
    card against the CPU, and against the card's single pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    kw, lb = BUILDING_MODES["shared_uv"]
    scene, px, occ = _building(lb)
    o, d = _building_rays("shared_uv", 64, 512, seed=7)
    dev = torch.device("cuda")
    cs, oc = _to(scene, occ, dev)
    ps, _ = _to(px, occ, dev)
    od, dd = tuple(a.to(dev) for a in o), tuple(a.to(dev) for a in d)
    tp = dict(kw, cut_frac=0.25, cap_frac=0.5)
    T.cast_fans_culled_twopass.counts.clear()
    T.culled_walk_cuda.launches.clear()
    hd = T.cast_fans_culled_twopass(cs, od, dd, occluders=oc,
                                    proxy=ps if proxy else None, **tp)
    torch.cuda.synchronize()
    assert T.cast_fans_culled_twopass.counts == {"calls": 1}
    pass2 = "per_ray_uv_seeded" if proxy else "per_ray_uv"
    assert T.culled_walk_cuda.launches[pass2] == 1
    hc = T.cast_fans_culled_twopass(scene, o, d, occluders=occ,
                                    proxy=px if proxy else None, **tp)
    _assert_hits_match(hc, hd)
    _assert_hits_match(hc, T.cast_fans_culled(cs, od, dd, occluders=oc, **kw))


# ---------------------------------------------------------------------------
# B1 (e): the visit telemetry; B2/B3: the exhaustive leaf stream
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
def test_visit_telemetry_matches_plain(walk, seeded):
    """The kernel's visits (the maximum of its rays' stop indices) equal
    the plain walk's group-wide count, and the counts equal; t and prim
    are the hits."""
    args = dict(walk["args"], emit_uv=True, emit_prim=False)
    if seeded:
        # the walk's own hits, coarsened: valid upper bounds on t
        t, prim, u, v = T.culled_walk_plain(**args)
        seed = (torch.where(torch.isfinite(t), t * 1.5, t), prim, u, v)
        g = args["count"].numel()
        args["seed"] = seed
        args["count"] = T.seed_counts(args["dist"], seed[0], args["t_cap"])
        assert args["count"].shape == (g,)
    ref = T.culled_walk_plain(**args, visits=True)
    cargs = _cuda(args)
    if seeded:
        cargs["seed"] = tuple(a.cuda() for a in args["seed"])
    before = T.culled_walk_cuda.launches.copy()
    got = T.culled_walk_cuda(**cargs, visits=True)
    torch.cuda.synchronize()
    mode = "shared_uv_seeded_visits" if seeded else "shared_uv_visits"
    assert T.culled_walk_cuda.launches[mode] == before[mode] + 1
    for a, b in zip(ref, got):
        assert torch.equal(a, b.cpu())
    assert (ref[2] >= 1).any()


# ---------------------------------------------------------------------------
# B1's warp-granular walk: warps across rows, empty lists, t_cap, seeds
# ---------------------------------------------------------------------------

ODD_ROWS, ODD_R, ODD_ER = 18, 100, 3  # 300 rays a group: warps span rows
ODD_MODES = {
    "shared_uv": dict(emit_uv=True),
    "shared_prim": dict(emit_prim=True, t_min=1e-6),
    "per_ray_uv": dict(per_ray=True, emit_uv=True),
}


def _odd_walk(mode, lb, seed=5, pixels=False):
    """culled_walk inputs on the card for ODD_ROWS rows of ODD_R rays
    (exit groups of ODD_ER rows): shared origins differ row by row, per-ray
    origins ray by ray (with pixels, they repeat over 16 consecutive rays
    of a group, as a pixel's specular samples do); every fifth group's
    list is empty."""
    _, scene, occ = _scene_lb(lb)
    dev = torch.device("cuda")
    cs, oc = _to(scene, occ, dev)
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0.4, 0.3, 0.4]), np.array([7.6, 2.7, 4.6])
    shape = (ODD_ROWS, ODD_R)
    d = rng.standard_normal(shape + (3,))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dirs = tuple(torch.from_numpy(np.ascontiguousarray(d[..., k])).to(dev)
                 for k in range(3))
    kw = dict(ODD_MODES[mode])
    if kw.get("per_ray"):  # origins scattered about a point of each row
        o = (rng.uniform(lo, hi, (ODD_ROWS, 1, 3))
             + rng.uniform(-0.05, 0.05, shape + (3,))).astype(np.float32)
        if pixels:
            per_group = o.reshape(-1, ODD_ER * ODD_R, 3)
            first = np.arange(ODD_ER * ODD_R) // 16 * 16
            o = np.ascontiguousarray(per_group[:, first].reshape(o.shape))
    else:
        o = rng.uniform(lo, hi, (ODD_ROWS, 3)).astype(np.float32)
    origins = tuple(torch.from_numpy(np.ascontiguousarray(o[..., k])).to(dev)
                    for k in range(3))
    args = T.walk_args(cs, origins, dirs, fan_block=ODD_ER,
                       exit_rows=ODD_ER, occluders=oc, **kw)
    args["count"] = args["count"].clone()
    args["count"][::5] = 0
    return args


def _hits_equal(a, b):
    """t bit-equal; prim, u, v bit-equal but for t-ties (at most 1e-3)."""
    assert torch.equal(a[0], b[0])
    tie = (a[1] != b[1]) | (a[2] != b[2]) | (a[3] != b[3])
    assert float(tie.float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [False, True])
@pytest.mark.parametrize("lb", [4, 8])
@pytest.mark.parametrize("mode", sorted(ODD_MODES))
def test_walk_odd_rows_match_plain(mode, lb, cap):
    """Rows of 100 rays (warps that span two rows take the per-ray origin
    path), empty candidate lists and, with cap, a t_cap that cuts the
    lists (the median positive bound): the kernel against the plain walk,
    both on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    args = _odd_walk(mode, lb)
    if cap:
        listed = torch.arange(args["dist"].shape[1], device="cuda")
        bounds = args["dist"][listed[None] < args["count"][:, None]]
        args["t_cap"] = float(bounds[bounds > 0].median())
    before = T.culled_walk_cuda.launches[mode]
    got = T.culled_walk_cuda(**args)
    torch.cuda.synchronize()
    assert T.culled_walk_cuda.launches[mode] == before + 1
    ref = T.culled_walk_plain(**args)
    _hits_equal(got, ref)
    empty = (args["count"] == 0).repeat_interleave(ODD_ER)
    assert torch.isinf(got[0][empty]).all() and (got[1][empty] == -1).all()
    if cap:  # the cap cut the walks short
        walked = T.culled_walk_plain(**args, visits=True)[2]
        full = T.culled_walk_plain(**dict(args, t_cap=1e3), visits=True)[2]
        assert walked.sum() < full.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("lb", [4, 8])
def test_walk_pixel_origins_match_plain(lb):
    """Per-ray origins that repeat over 16 rays (each half-warp shares
    one: its origin terms are formed once) against the plain walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    args = _odd_walk("per_ray_uv", lb, seed=8, pixels=True)
    got = T.culled_walk_cuda(**args)
    torch.cuda.synchronize()
    _hits_equal(got, T.culled_walk_plain(**args))
    assert torch.isfinite(got[0]).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("lb", [4, 8])
@pytest.mark.parametrize("mode", sorted(ODD_MODES))
def test_walk_seed_beats_every_candidate(mode, lb):
    """Seeds at t = 0, which no candidate can beat (its bound is >= 0 and
    the test t < t_best strict): no ray is ever live, no group visits a
    cluster, and every output is its seed (prim -1 without emit_prim)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    args = _odd_walk(mode, lb, seed=6)
    shape = args["dx"].shape
    dev = args["dx"].device
    gen = torch.Generator(device="cpu").manual_seed(1)
    seed = (torch.zeros(shape, device=dev),
            torch.randint(0, 99, shape, generator=gen).to(torch.int32).to(dev),
            torch.rand(shape, generator=gen).to(dev),
            torch.rand(shape, generator=gen).to(dev))
    assert (args["count"] > 0).any()
    got = T.culled_walk_cuda(**dict(args, seed=seed))
    ref = T.culled_walk_plain(**dict(args, seed=seed))
    torch.cuda.synchronize()
    _hits_equal(got, ref)
    assert torch.equal(got[0], seed[0])
    assert torch.equal(got[2], seed[2]) and torch.equal(got[3], seed[3])
    prim = seed[1] if args["emit_prim"] else torch.full_like(seed[1], -1)
    assert torch.equal(got[1], prim)
    visits = T.culled_walk_cuda(**dict(args, seed=seed), visits=True)[2]
    assert not visits.any()


@pytest.mark.cuda
@pytest.mark.parametrize("lb", [4, 8])
@pytest.mark.parametrize("mode", sorted(ODD_MODES))
def test_walk_odd_rows_visits_match_plain(mode, lb):
    """The visit telemetry with warps across rows and empty lists: the
    kernel's per-group visits and counts equal the plain walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    args = _odd_walk(mode, lb, seed=7)
    got = T.culled_walk_cuda(**args, visits=True)
    ref = T.culled_walk_plain(**args, visits=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[2] >= 1).any()


def _fan_setup():
    from texir_code_tpu_torch.ops.fan_raycast import FanScene

    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    fan = FanScene.from_flat(build_bvh(syn.mesh.vertices, syn.mesh.faces),
                             triangle_uvs=syn.mesh.triangle_uvs())
    rng = np.random.default_rng(4)
    o = rng.uniform(0.5, 2.5, (12, 256, 3)).astype(np.float32)
    d = rng.standard_normal((12, 256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return syn, fan, o, d


@pytest.mark.cuda
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("emit_uv", [True, False])
@pytest.mark.parametrize("t_min", [0.0, 1e-6])
def test_fan_stream_matches_plain(per_ray, emit_uv, t_min):
    """B2 (shared origins) and B3 (per-ray origins) against the plain
    stream: every output bit-equal (the same operations in the same order,
    no multiply-add contraction, IEEE division)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    from texir_code_tpu_torch.ops import pallas_fan as F

    _, fan, o, d = _fan_setup()
    rows = torch.from_numpy(fan.rows)
    if per_ray:
        origins = torch.from_numpy(np.ascontiguousarray(o.transpose(2, 0, 1)))
    else:
        origins = torch.from_numpy(np.ascontiguousarray(o[:, 0]))
    dirs = [torch.from_numpy(np.ascontiguousarray(d[..., k]))
            for k in range(3)]
    ref = F.fan_stream_plain(rows, origins, *dirs, t_min=t_min,
                             emit_uv=emit_uv, per_ray=per_ray)
    mode = F.stream_mode(per_ray, emit_uv)
    before = F.fan_stream_cuda.launches[mode]
    got = F.fan_stream_cuda(rows.cuda(), origins.cuda(),
                            *(a.cuda() for a in dirs), t_min=t_min,
                            emit_uv=emit_uv, per_ray=per_ray)
    torch.cuda.synchronize()
    assert F.fan_stream_cuda.launches[mode] == before + 1
    for a, b in zip(ref, got):
        assert torch.equal(a, b.cpu())
    assert torch.isfinite(ref[0]).float().mean() > 0.99


def _fan_equal_on_card(rows, origins, dirs, t_min=0.0, emit_uv=True,
                       per_ray=False):
    """fan_stream_cuda (the scene's packed records) against
    fan_stream_plain on the same CPU inputs: every output bit-equal.
    Returns the plain hits."""
    from texir_code_tpu_torch.ops import pallas_fan as F

    kw = dict(t_min=t_min, emit_uv=emit_uv, per_ray=per_ray)
    ref = F.fan_stream_plain(rows, origins, *dirs, **kw)
    got = F.fan_stream_cuda(rows.cuda(), origins.cuda(),
                            *(a.cuda() for a in dirs), **kw)
    torch.cuda.synchronize()
    for name, a, b in zip("t prim u v".split(), ref, got):
        assert torch.equal(a, b.cpu()), name
    return ref


def _fan_rows_with_records(fan, n_rec):
    """The first rows of a FanScene holding n_rec packed records: slots
    past the n_rec-th real one get a zero normal (no record)."""
    rows = fan.rows.copy()
    real = np.nonzero((rows[:, 12:72].reshape(-1, 15)[:, 0:3] != 0).any(1))[0]
    for slot in real[n_rec:]:
        rows[slot // 4, 12 + 15 * (slot % 4):15 + 15 * (slot % 4)] = 0.0
    return torch.from_numpy(rows[: real[n_rec - 1] // 4 + 1].copy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_rec", [1, 127, 129, 385])
@pytest.mark.parametrize("per_ray", [False, True])
def test_fan_stream_record_counts(n_rec, per_ray):
    """Scenes of 1 record, one short of a 128-record tile, one past it and
    one past three tiles (the ring wraps) against the plain stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    from texir_code_tpu_torch.ops.fan_raycast import pack_records

    _, fan, o, d = _fan_setup()
    rows = _fan_rows_with_records(fan, n_rec)
    assert pack_records(rows)[0].shape[0] == n_rec
    origins = (torch.from_numpy(np.ascontiguousarray(o.transpose(2, 0, 1)))
               if per_ray else torch.from_numpy(np.ascontiguousarray(o[:, 0])))
    dirs = [torch.from_numpy(np.ascontiguousarray(d[..., k]))
            for k in range(3)]
    _fan_equal_on_card(rows, origins, dirs, per_ray=per_ray)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [100, 130])
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_fan_stream_ragged_rows(r, per_ray, big):
    """Rows of r rays, no multiple of the rays a thread or of a block, so
    blocks and threads span rows of different origins; `big` launches
    enough rays for 4 rays a thread (launch_plan), else 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    from texir_code_tpu_torch.ops import pallas_fan as F

    _, fan, _, _ = _fan_setup()
    sms = F.sm_count(torch.cuda.current_device())
    t = 2 * sms * 1024 // r + 1 if big else 7
    assert F.launch_plan(t * r, sms)[0] == (4 if big else 2)
    rng = np.random.default_rng(r)
    o = rng.uniform(0.5, 2.5, (t, 3)).astype(np.float32)
    d = rng.standard_normal((t, r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if per_ray:  # each row's origin repeated over its rays, one moved
        full = np.repeat(o[:, None], r, axis=1)
        full[1, 3] = np.nextafter(full[1, 3], np.float32(9))
        origins = torch.from_numpy(np.ascontiguousarray(full.transpose(2, 0, 1)))
    else:
        origins = torch.from_numpy(o)
    dirs = [torch.from_numpy(np.ascontiguousarray(d[..., k]))
            for k in range(3)]
    _fan_equal_on_card(torch.from_numpy(fan.rows), origins, dirs,
                       per_ray=per_ray)


@pytest.mark.cuda
@pytest.mark.parametrize("origins", ["runs", "runs_one_moved", "distinct"])
@pytest.mark.parametrize("emit_uv", [True, False])
def test_fan_stream_pixel_origins(origins, emit_uv):
    """Per-ray origins as the specular trace makes them (each pixel's
    origin repeated over its 16 rays), with one ray of a run moved by one
    ulp, and all distinct, against the plain stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    _, fan, _, _ = _fan_setup()
    rng = np.random.default_rng(6)
    pix = rng.uniform(0.5, 2.5, (8 * 1024 // 16, 3)).astype(np.float32)
    o = np.repeat(pix, 16, axis=0).reshape(8, 1024, 3)
    if origins == "runs_one_moved":
        o[2, 37, 1] = np.nextafter(o[2, 37, 1], np.float32(-9))
    elif origins == "distinct":
        o = rng.uniform(0.5, 2.5, (8, 1024, 3)).astype(np.float32)
    d = rng.standard_normal((8, 1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _fan_equal_on_card(
        torch.from_numpy(fan.rows),
        torch.from_numpy(np.ascontiguousarray(o.transpose(2, 0, 1))),
        [torch.from_numpy(np.ascontiguousarray(d[..., k])) for k in range(3)],
        emit_uv=emit_uv, per_ray=True)


def _rays_at_row(fan, row, n_rays, seed):
    """Shared-origin rows of n_rays rays, one per real triangle of leaf row
    `row`: each starts 0.5 off its triangle's centroid along the normal and
    aims at points inside it (corners from the plane-dual s1, s2, n)."""
    rng = np.random.default_rng(seed)
    tri = fan.rows[row, 12:72].reshape(4, 15).astype(np.float64)
    origins, dirs = [], []
    for k in range(4):
        n = tri[k, 0:3]
        if not n.any():
            continue
        n = n / np.linalg.norm(n)
        e = np.linalg.inv(np.stack([tri[k, 4:7], tri[k, 8:11], n]))
        p0 = tri[k, 12:15]
        uv = rng.uniform(0.05, 0.45, (n_rays, 2))
        pts = p0 + uv[:, :1] * e[:, 0] + uv[:, 1:] * e[:, 1]
        o = p0 + (e[:, 0] + e[:, 1]) / 3 + 0.5 * n
        d = pts - o
        origins.append(o)
        dirs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    d = np.array(dirs, np.float32)
    return (torch.from_numpy(np.array(origins, np.float32)),
            [torch.from_numpy(np.ascontiguousarray(d[..., j]))
             for j in range(3)])


@pytest.mark.cuda
@pytest.mark.parametrize("emit_uv", [True, False])
@pytest.mark.parametrize("t_min", [0.0, 1e-6])
def test_fan_stream_duplicate_triangle_tie(emit_uv, t_min):
    """A FanScene whose row 5 is repeated at its end under other prim ids:
    rays at its triangles meet both copies at the same t, and the first in
    row order (the original) wins, on the card as in the plain stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    _, fan, _, _ = _fan_setup()
    rows = torch.from_numpy(fan.rows.copy())
    dup = rows[5].clone()
    pids = dup[8:12].view(torch.int32)
    pids[pids >= 0] += 1_000_000
    rows = torch.cat([rows, dup[None]]).contiguous()
    origins, dirs = _rays_at_row(fan, 5, 256, seed=7)
    ref = _fan_equal_on_card(rows, origins, dirs, t_min=t_min,
                             emit_uv=emit_uv)
    own = torch.from_numpy(fan.rows[5, 8:12].copy()).view(torch.int32)
    prims = ref[1].reshape(-1)
    assert torch.isin(prims, own[own >= 0]).float().mean() > 0.5
    assert not (prims >= 1_000_000).any()


@pytest.mark.cuda
def test_fan_scene_only_paths_on_card():
    """The FanScene-only bake batch and Mat forward on the card against
    the CPU: the same rays, the same hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stream kernel has no CPU mode)")
    from texir_code_tpu_torch.models.material import (
        MaterialModel,
        MaterialParams,
    )
    from texir_code_tpu_torch.models.tbl import build_tbl
    from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker
    from texir_code_tpu_torch.ops import pallas_fan as F
    from texir_code_tpu_torch.ops.gbuffer import cube_mvp

    syn, fan, o, _ = _fan_setup()
    pts = torch.from_numpy(o[:, 0])
    rng = np.random.default_rng(5)
    nrm = rng.standard_normal((12, 3)).astype(np.float32)
    nrm = torch.from_numpy(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    out = {}
    for dev in ("cuda", "cpu"):
        baker = IrradianceTextureBaker(
            build_tbl(syn.mesh, syn.hdr_texture, device=dev), spp=256,
            fan_scene=fan, max_leaves=fan.num_leaves)
        out[dev] = baker.bake_batch(pts.to(dev), nrm.to(dev),
                                    torch.arange(12, device=dev), 3).cpu()
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-4, atol=1e-6)
    pos = syn.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    shift = torch.from_numpy(rng.uniform(0, 1, (6 * 64, 2)).astype(np.float32))
    rgb = {}
    F.fan_stream_cuda.launches.clear()
    for dev in ("cuda", "cpu"):
        m = MaterialModel(syn.mesh, syn.hdr_texture,
                          np.ones((32, 32, 3), np.float32), pano_res=(16, 32),
                          sample_light=(8, 4), device=dev)
        m.cluster_scene = None
        p = MaterialParams(torch.full((32, 32, 3), 0.5, device=dev),
                           torch.full((32, 32, 1), 0.3, device=dev))
        rgb[dev] = m._forward(p, cube_mvp(ext), pos, 2,
                              spec_shift=shift)["rgb"].cpu()
    assert F.fan_stream_cuda.launches["shared_prim"] == 1
    assert F.fan_stream_cuda.launches["per_ray_uv"] == 1
    np.testing.assert_allclose(rgb["cuda"].numpy(), rgb["cpu"].numpy(),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel S: the scatter-accumulator (csrc/scatter_acc.cu)
# ---------------------------------------------------------------------------


def _scatter_taps(n, s, c, seed):
    rng = np.random.default_rng(seed)
    idx = np.clip((rng.random(n) ** 1.2 * s).astype(np.int64), 0, s - 1)
    return (torch.from_numpy(idx).cuda(),
            torch.from_numpy(rng.random((n, c)).astype(np.float32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("s,c,n", [(16384, 3, 786432), (65536, 1, 786432),
                                   (37, 2, 1000), (300, 3, 257)])
def test_scatter_acc_matches_plain(s, c, n, presorted):
    """Kernel S in both modes against scatter_accumulate_plain on the card:
    each element within the order bound (the most two orders of the
    additions can differ by), and one launch counted per call."""
    from texir_code_tpu_torch.ops import scatter_acc as S
    from texir_code_tpu_torch.scripts.sampler_bwd_variants import (
        order_bound,
        order_error,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    idx, g = _scatter_taps(n, s, c, s + c)
    if presorted:
        idx, order = torch.sort(idx, stable=True)
        g = g[order]
    ref = S.scatter_accumulate_plain(idx, g, s)
    abs_sum, bound = order_bound(idx, g, s)
    mode = S.scatter_mode(presorted)
    before = S.scatter_accumulate_cuda.launches[mode]
    got = S.scatter_accumulate(idx, g, s, presorted=presorted)
    torch.cuda.synchronize()
    assert S.scatter_accumulate_cuda.launches[mode] == before + 1
    assert got.shape == (s, c) and got.dtype == torch.float32
    assert order_error(got, ref, abs_sum, bound)[2] <= 1


@pytest.mark.cuda
def test_scatter_acc_unsorted_taps_in_sorted_mode():
    """The sorted mode's contract is ascending taps (the docstrings say
    so): taps in any order are sorted first, as take_segsum does, and then
    give the plain version's sums; int32 taps are taken as they are, and
    the wrapper checks the type of g and the row count.  Taps out of order
    in the sorted mode give an undefined result but stay memory-safe."""
    from texir_code_tpu_torch.ops import scatter_acc as S

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    assert "ascending" in S.scatter_accumulate.__doc__
    assert "ascending" in S.scatter_accumulate_cuda.__doc__
    idx, g = _scatter_taps(5000, 64, 3, 7)
    ref = S.scatter_accumulate_plain(idx, g, 64)
    idx_s, order = torch.sort(idx.to(torch.int32), stable=True)
    got = S.scatter_accumulate(idx_s, g[order], 64, presorted=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    junk = S.scatter_accumulate(idx.to(torch.int32), g, 64, presorted=True)
    torch.cuda.synchronize()
    assert junk.shape == (64, 3)
    with pytest.raises(TypeError):
        S.scatter_accumulate_cuda(idx, g.double(), 64)
    with pytest.raises(ValueError):
        S.scatter_accumulate_cuda(idx, g, 2 ** 31)


def _sorted_case(case, c, dtype):
    """(idx ascending, g, S) of a named layout of taps."""
    rng = np.random.default_rng(len(case) + c)
    if case == "one_row":  # one row takes every tap (one run over blocks)
        s, idx = 5, np.full(300_000, 3)
    elif case == "gaps":  # empty rows between runs
        s = 50_000
        idx = np.repeat(np.arange(0, s, 7), rng.integers(1, 5, (s + 6) // 7))
    elif case == "long_runs":  # runs longer than a block, one on its edge
        s = 9000
        idx = np.concatenate([np.full(5000, 2), np.arange(3, 2040),
                              np.full(7000, 2047), np.arange(2048, 8999, 3),
                              np.full(4100, 8999)])
    elif case == "ragged":  # S not a multiple of the block's rows
        s = 2048 * 5 + 77
        idx = np.sort(rng.integers(0, s, 20_000))
    else:  # no taps
        s, idx = 3000, np.zeros(0, np.int64)
    g = rng.random((len(idx), c), dtype=np.float32)
    return (torch.from_numpy(np.sort(idx).astype(dtype)).cuda(),
            torch.from_numpy(g).cuda(), s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("c", [1, 3, 4, 6])
@pytest.mark.parametrize("case", ["one_row", "gaps", "long_runs", "ragged",
                                  "empty"])
def test_scatter_acc_layouts(case, c, dtype):
    """Both modes on the layouts the sorted mode's blocks must get right:
    every element within the order bound of the plain version (an
    element of one tap, or of none, exactly), and the sorted mode
    bit-equal across two runs."""
    from texir_code_tpu_torch.ops import scatter_acc as S
    from texir_code_tpu_torch.scripts.sampler_bwd_variants import (
        order_bound,
        order_error,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    idx, g, s = _sorted_case(case, c, dtype)
    ref = S.scatter_accumulate_plain(idx, g, s)
    abs_sum, bound = order_bound(idx, g, s)
    a = S.scatter_accumulate(idx, g, s, presorted=True)
    b = S.scatter_accumulate(idx, g, s, presorted=True)
    u = S.scatter_accumulate(idx, g, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for got in (a, u):
        assert got.shape == (s, c)
        assert order_error(got, ref, abs_sum, bound)[2] <= 1


@pytest.mark.cuda
def test_scatter_acc_sorted_on_two_streams():
    """The sorted mode's hand-off scratch is per stream: launches on two
    streams at once each give the bits of a launch alone."""
    from texir_code_tpu_torch.ops import scatter_acc as S

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    idx, g, s = _sorted_case("long_runs", 3, np.int32)
    ref = S.scatter_accumulate(idx, g, s, presorted=True)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs += [S.scatter_accumulate(idx, g, s, presorted=True)
                     for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in outs)
    assert {(idx.device, st.cuda_stream) for st in streams} <= set(S._scratch)


@pytest.mark.cuda
def test_scatter_acc_graph_capture():
    """Under CUDA graph capture the sorted mode refuses (a replay would
    reuse its launch's tags); the unsorted mode is captured and its replay
    gives the plain version's sums within the order bound."""
    from texir_code_tpu_torch.ops import scatter_acc as S
    from texir_code_tpu_torch.scripts.sampler_bwd_variants import (
        order_bound,
        order_error,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    idx, g, s = _sorted_case("gaps", 3, np.int64)
    ref = S.scatter_accumulate_plain(idx, g, s)
    abs_sum, bound = order_bound(idx, g, s)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.scatter_accumulate(idx, g, s)  # loads the library before capture
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="CUDA graph"):
                S.scatter_accumulate(idx, g, s, presorted=True)
            out = S.scatter_accumulate(idx, g, s)
        finally:
            graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    assert order_error(out, ref, abs_sum, bound)[2] <= 1


@pytest.mark.cuda
def test_scatter_acc_mat_pyramid_sorted():
    """The Mat roughness pyramid (4096², 22,369,621 rows) with one view's
    worth of taps bunched on the coarse levels: sorted within the order
    bound, bit-equal across runs, and rows without taps exactly 0."""
    from texir_code_tpu_torch.ops import scatter_acc as S
    from texir_code_tpu_torch.scripts.sampler_bwd_variants import (
        order_bound,
        order_error,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    s = sum(4 ** k for k in range(13))  # 4096² ... 1²
    rng = np.random.default_rng(9)
    idx = np.concatenate([rng.integers(0, s, 600_000),
                          rng.integers(s - 1365, s, 186_432)])
    idx, g = np.sort(idx), rng.random((len(idx), 1), dtype=np.float32)
    idx, g = torch.from_numpy(idx).cuda(), torch.from_numpy(g).cuda()
    ref = S.scatter_accumulate_plain(idx, g, s)
    abs_sum, bound = order_bound(idx, g, s)
    a = S.scatter_accumulate(idx, g, s, presorted=True)
    b = S.scatter_accumulate(idx, g, s, presorted=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert order_error(a, ref, abs_sum, bound)[2] <= 1
    assert (a[abs_sum == 0] == 0).all()


@pytest.mark.cuda
def test_take_segsum_backward_on_card():
    """The sampler's gradient with SEGSUM_BACKWARD on the card (kernel S,
    sorted mode, 8 launches for the 8 trilinear fetches) against the same
    gradient on the CPU."""
    from texir_code_tpu_torch.ops import scatter_acc as S
    from texir_code_tpu_torch.ops import texture as TT

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel S has no CPU mode)")
    rng = np.random.default_rng(3)
    tex = rng.random((64, 64, 3)).astype(np.float32)
    uv = torch.from_numpy((rng.random((4096, 2)) * 0.3).astype(np.float32))
    lod = torch.from_numpy((rng.random(4096) * 4).astype(np.float32))
    grads = {}
    S.scatter_accumulate_cuda.launches.clear()
    TT.SEGSUM_BACKWARD = True
    try:
        for dev in ("cuda", "cpu"):
            t = torch.tensor(tex, device=dev, requires_grad=True)
            out = TT.texture_sample(TT.build_mip_pyramid(t), uv.to(dev),
                                    lod.to(dev))
            (out ** 2).sum().backward()
            grads[dev] = t.grad.cpu()
    finally:
        TT.SEGSUM_BACKWARD = False
    assert S.scatter_accumulate_cuda.launches == {"sorted": 8}
    rel = (grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()
    assert rel <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
def test_bvh_traversal_on_card_matches_brute(compact):
    """ops/raycast.py::cast_rays_soa (plain PyTorch, no kernel of its own)
    on the card against the brute-force oracle and against itself on the
    CPU: prim equal but on exact-t ties (t within 1e-6 relative there),
    t within 1e-5 relative of the oracle's; card and CPU traversals equal
    in prim and within 1e-6 in t, u, v.  Rays from inside the rooms and
    from outside the scene, with zero direction components."""
    from texir_code_tpu_torch.ops.raycast import (
        DeviceBVH,
        cast_rays,
        cast_rays_brute,
        cast_rays_soa,
        to_soa,
    )

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    syn = make_apartment_scene(atlas_res=32, subdiv=4)
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    rng = np.random.default_rng(9)
    n = 3000
    o = rng.uniform((0.3, 0.3, 0.3), (7.7, 2.7, 4.7), (n, 3))
    o[::3] = rng.uniform(-2.0, 10.0, (len(o[::3]), 3))  # outside, too
    o = o.astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    d[::11, 0] = 0.0
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    card = cast_rays_soa(DeviceBVH.from_flat(fb, "cuda"), to_soa(o_t.cuda()),
                         to_soa(d_t.cuda()), compact=compact)
    cpu = cast_rays(DeviceBVH.from_flat(fb, "cpu"), o_t, d_t)
    brute = cast_rays_brute(torch.from_numpy(syn.mesh.vertices).float(),
                            torch.from_numpy(syn.mesh.faces), o_t, d_t)
    assert torch.equal(card.prim.cpu(), cpu.prim)
    for f in ("t", "u", "v"):
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert ((a[fin] - b[fin]).abs()
                <= 1e-6 * b[fin].abs().clamp_min(1.0)).all()
    t, tb = card.t.cpu(), brute.t
    assert torch.equal(torch.isfinite(t), torch.isfinite(tb))
    hit = torch.isfinite(tb)
    assert hit.float().mean() > 0.5
    rel = (t[hit] - tb[hit]).abs() / tb[hit]
    assert rel.max() <= 1e-5
    tie = card.prim.cpu() != brute.prim
    assert (rel[tie[hit]] <= 1e-6).all()
    assert tie.float().mean() <= 1e-2


# ---------------------------------------------------------------------------
# the field stages: the NIrF trace goes through B1 per_ray_prim on the card
# ---------------------------------------------------------------------------

IRRF_CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                         "irrf_synthetic.conf")
FIELD_SETS = {"train.samples_point_mesh": 64, "train.env_res": [8, 16],
              "val.env_res": [16, 32], "train.val_sample_res": [4, 8],
              "val.pil_points": 64, "val.pil_spp": 32}


@pytest.fixture(scope="module")
def field_scan(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernel has no CPU mode)")
    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.data.synthetic import make_scene

    out = str(tmp_path_factory.mktemp("field_scan"))
    return export_reference_layout(make_scene(atlas_res=48), out, n_views=1,
                                   pano_res=(32, 64), device="cpu")


@pytest.mark.cuda
def test_irrf_step_card_matches_cpu(field_scan, tmp_path):
    """One IRRF step (full-width network) on the card against the CPU from
    the same weights, points and draws: GT within rel 1e-4, loss within
    rel 1e-5, gradients within relative L2 1e-4; the card's trace is one
    B1 per_ray_prim launch."""
    from texir_code_tpu_torch.config import parse_file
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner, step_seed

    conf = parse_file(IRRF_CONF)
    conf.put("train.path_mesh_open3d", field_scan)
    out, state = {}, None
    for dev in ("cuda", "cpu"):
        r = IRRFTrainRunner(conf, exps_root=str(tmp_path / dev), device=dev)
        if state is None:
            state = {k: v.cpu() for k, v in
                     r.model.network.state_dict().items()}
        else:
            r.model.network.load_state_dict(state)
        pts = r._tensor(r.train_dataset.points[:16])
        nrm = r._tensor(r.train_dataset.normals[:16])
        ids = torch.arange(16, device=r.device)
        before = T.culled_walk_cuda.launches["per_ray_prim"]
        gt = r.model.trace_gt(pts, nrm, r.env_res, step_seed(0), ids)
        if dev == "cuda":
            assert T.culled_walk_cuda.launches["per_ray_prim"] == before + 1
        loss = r._loss(pts, nrm, step_seed(0), ids)
        loss.backward()
        out[dev] = (gt.cpu().numpy(), float(loss.detach()), [
            p.grad.cpu().numpy() for p in r.model.network.parameters()])
    (gg, lg, dg), (gc, lc, dc) = out["cuda"], out["cpu"]
    assert (np.abs(gg - gc) <= 1e-4 * np.maximum(np.abs(gc), 1e-6)).all()
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(dg, dc):
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["IRRF", "IRF", "PIL"])
def test_field_stage_cli_on_card(field_scan, tmp_path, stage):
    """Each field stage through the CLI on the card (no --device) at a
    small size: finite loss, its val metrics, B1 per_ray_prim launched."""
    import json

    from texir_code_tpu_torch import cli

    argv = ["train", "--conf", IRRF_CONF, "--trainstage", stage,
            "--max_epochs", "1", "--exps_folder", str(tmp_path), "--set",
            f"train.path_mesh_open3d={field_scan}"]
    for k, v in FIELD_SETS.items():
        argv += ["--set", f"{k}={v}"]
    T.culled_walk_cuda.launches.clear()
    assert cli.main(argv) == 0
    assert T.culled_walk_cuda.launches["per_ray_prim"] > 0
    (root,) = [r for r, _, f in os.walk(tmp_path) if "timings.json" in f]
    with open(os.path.join(root, "timings.json")) as f:
        tm = json.load(f)
    assert np.isfinite(tm["last_loss"]) and tm["steps"] > 0
    assert np.isfinite(tm["val_metrics"]["val_psnr"])


@pytest.fixture(scope="module")
def alt_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_apartment_scene(atlas_res=64, subdiv=6)


def _alt_step(kind, syn, device):
    """One step of an alternative material model at a small size on
    `device`, from parameters drawn on the CPU and the same hashed draws:
    (rgb, loss, gradients)."""
    from texir_code_tpu_torch.models.material_mlp import MaterialMLP
    from texir_code_tpu_torch.models.material_redner import (
        RednerMaterialModel,
    )
    from texir_code_tpu_torch.ops.shading import hdr_scale

    pos = syn.camera_positions(2)
    g = torch.Generator().manual_seed(3)
    if kind == "mlp":
        model = MaterialMLP(syn.mesh, syn.hdr_texture, pano_res=(32, 64),
                            sample_light=(8, 4), device=device)
        params = model.init_params(g)
        out = model.forward(params, pos[1], seed=5)
        named = dict(params.named_parameters())
    else:
        exts = [np.eye(4, dtype=np.float32) for _ in pos]
        for e, p in zip(exts, pos):
            e[0:3, 3] = p
        model = RednerMaterialModel(
            syn.mesh, syn.hdr_texture, ids=["a", "b"], extrinsics=exts,
            optim_cam=True, texture_res=128, pano_res=(32, 64),
            sample_light=(8, 8), device=device)
        named = model.init_params()
        with torch.no_grad():
            for k in ("albedo", "roughness"):
                named[k].copy_(torch.rand(named[k].shape, generator=g))
        out = model.forward(named, 1, seed=5)
    target = torch.rand((32, 64, 3), generator=g).to(device)
    loss = (hdr_scale(out["rgb"]) - hdr_scale(target)).abs().mean()
    loss.backward()
    return (out["rgb"].detach().cpu().numpy(), float(loss.detach()),
            {k: p.grad.cpu().numpy() for k, p in named.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp", "redner"])
def test_alt_model_card_matches_cpu(alt_scene, kind):
    """MaterialMLP / RednerMaterialModel (optim_cam) on the card against
    the CPU: rgb relative L2 1e-4, loss rel 1e-4, every gradient (the pose
    deltas included) relative L2 1e-3."""
    (rg, lg, gg), (rc, lc, gc) = (_alt_step(kind, alt_scene, d)
                                  for d in ("cuda", "cpu"))
    assert np.linalg.norm(rg - rc) <= 1e-4 * np.linalg.norm(rc)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in gc:
        assert np.abs(gc[k]).max() > 0, k
        assert np.linalg.norm(gg[k] - gc[k]) <= 1e-3 * np.linalg.norm(gc[k]), k


@pytest.mark.cuda
def test_cli_prints_memory_high_water_on_card(monkeypatch, capsys):
    """With TEXIR_PRINT_MEMORY set, a stage on the card ends by printing
    torch.cuda.max_memory_allocated in MiB; --debug_nans runs it under
    anomaly detection."""
    from texir_code_tpu_torch import cli

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seen = []

    def probe(conf, args):
        seen.append(torch.is_anomaly_enabled())
        torch.ones(1 << 20, device="cuda")

    monkeypatch.setitem(cli.TRAIN_STAGES, "Probe", probe)
    monkeypatch.setenv("TEXIR_PRINT_MEMORY", "1")
    conf = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "mat_synthetic.conf")
    assert cli.main(["train", "--conf", conf, "--trainstage", "Probe",
                     "--debug_nans"]) == 0
    assert seen == [True]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("device memory high-water: ")]
    assert len(lines) == 1 and lines[0].endswith(" MiB")
    assert int(lines[0].split()[3]) >= 4
