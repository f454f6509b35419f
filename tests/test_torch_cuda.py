"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions.  Every test here is marked `cuda` and skips without a card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with the card and no jax; there the repository's conftest (which
imports jax) is bypassed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from texir_code_tpu_torch.data.synthetic import make_apartment_scene
from texir_code_tpu_torch.geometry.bvh import build_bvh
from texir_code_tpu_torch.geometry.occluders import extract_occluders
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.fan_raycast import FanScene
from texir_code_tpu_torch.ops.sampling import generate_dir_soa

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
