"""The port's multi-device paths (texir_code_tpu_torch/parallel/, one rank
per device) on the CPU: two gloo ranks against one rank and against the
JAX package's 2-device mesh.

One module-scoped pair of ranks (`ranks`) runs every multi-rank case and
writes its results to npz; the tests compare:

  * the collectives that carry a gradient: a replicated loss gives each
    rank its own gradient, not world-size times it;
  * the sharded IrT bake (make_scene(32), 12², spp 8, batch 16, the culled
    walk) bit-equal to one rank's;
  * the data-parallel stage-2 step against one rank's (loss rel 1e-6,
    gradients rtol 1e-4 / atol 1e-5 of the largest and rel L2 1e-5, the
    atlases after Adam bit-equal on both ranks) and against JAX's
    `spmd_mesh` step on 2 devices from JAX's own draws (loss rel 1e-5,
    gradients rtol 1e-4: the Mat correctness limits);
  * `tp_sample_materials` against JAX's on 2 devices (forward atol 2e-6,
    gradient atol 2e-5: tests/test_atlas_tp.py's limits);
  * the atlas-TP stage-2 step against the port's replicated step (loss
    rel 1e-5, gradients rtol 1e-4 / atol 1e-7);
  * the sharded GT traces of the three field tracers bit-equal to one
    rank's;
  * the runners end to end: MatTrainSynRunner with the atlases
    row-sharded (its substages, the save, the MatSyn metrics, then an
    --is_continue restore) against the runner in one process, and an
    epoch of each field stage (IRRF, IRF, PIL) with its GT traces split,
    bit-equal to one process's.

The scene of the Mat cases is tests/test_torch_gbuffer_material.py's
(make_scene(48), pano 32×64, 8 specular samples, the exact fetch).  The
ranks run at one thread each and import no JAX.  One more case runs
`train --trainstage IrrT` through the CLI as two processes.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models.material import MaterialModel as JMat
from texir_code_tpu.models.material import MaterialParams as JParams
from texir_code_tpu.ops import gbuffer as JG
from texir_code_tpu.parallel import atlas_tp as JTP
from texir_code_tpu.parallel import mesh as JM
from texir_code_tpu.parallel.multihost import process_local_slice as j_pls
from texir_code_tpu_torch.parallel import atlas_tp as TTP
from texir_code_tpu_torch.parallel import mesh as TM
from texir_code_tpu_torch.parallel.dryrun import free_port, run_ranks
from texir_code_tpu_torch.parallel.multihost import process_local_slice

torch.set_num_threads(2)  # six test workers share the host's cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANO = (32, 64)
SPEC_SPP = 8
NUM_CLASSES = 7
FIELD_POINTS, FIELD_RES = 16, (32, 64)

WORKER = textwrap.dedent('''
    import sys
    sys.path.insert(0, sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from texir_code_tpu_torch import convert
    from texir_code_tpu_torch.parallel import mesh as TM
    from texir_code_tpu_torch.parallel.multihost import (
        initialize_multihost, shutdown_multihost)

    coord, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert initialize_multihost(coord, 2, rank, backend="gloo") == (rank, 2)
    inp = dict(np.load(f"{d}/inputs.npz"))
    mesh = TM.make_device_mesh(device="cpu")
    out = {}

    # -- collectives that carry a gradient --------------------------------
    x = torch.ones(3, requires_grad=True)
    TM.psum_replicated(x * (rank + 1.0), mesh).sum().backward()
    out["psum_grad"] = x.grad.numpy()
    y = torch.full((2, 3), rank + 1.0, requires_grad=True)
    w = torch.arange(12.0).reshape(4, 3)
    g = TM.all_gather_rows(y, mesh, [2, 2])
    (w * g).sum().backward()
    out["gather_value"] = g.detach().numpy()
    out["gather_grad"] = y.grad.numpy()

    # -- the sharded bake --------------------------------------------------
    from texir_code_tpu_torch.data.synthetic import make_scene
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
    from texir_code_tpu_torch.models.tracer_irt import (
        IrradianceTextureBaker, bake_geometry_textures)
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import ClusterScene
    from texir_code_tpu_torch.parallel.bake import ShardedIrradianceBaker

    scene = make_scene(atlas_res=32)
    flat = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    tbl = build_tbl_from_flat(flat, scene.mesh, scene.hdr_texture,
                              device="cpu")
    fan = FanScene.from_flat(flat, triangle_uvs=scene.mesh.triangle_uvs())
    cl = ClusterScene.from_fan(fan, lb=4, dense=True, device="cpu")
    geom = bake_geometry_textures(scene.mesh, 12)
    kw = dict(spp=8, texel_batch=16, cluster_scene=cl, wedges=2)
    out["bake"] = ShardedIrradianceBaker(tbl, mesh=mesh, **kw).bake(
        geom, torch.Generator().manual_seed(3))
    if rank == 0:
        out["bake_single"] = IrradianceTextureBaker(tbl, **kw).bake(
            geom, torch.Generator().manual_seed(3))

    # -- the Mat stage-2 step: data parallel, atlas TP, one rank ----------
    from texir_code_tpu_torch.models import losses as TL
    from texir_code_tpu_torch.models.material import (
        MaterialModel, clamp_material_params)
    from texir_code_tpu_torch.parallel.atlas_tp import (
        shard_atlas, tp_sample_materials)
    from texir_code_tpu_torch.train.exp import adam_staircase

    tmesh = convert.mesh_from_numpy(inp["vertices"], inp["faces"],
                                    inp["uvs"], inp["uv_faces"],
                                    inp["vertex_normals"])
    t = torch.from_numpy

    def model(**kw):
        m = MaterialModel(tmesh, inp["hdr"], inp["irt"], pano_res=(32, 64),
                          sample_light=(32, 8), device="cpu", **kw)
        m.specular_fetch = "exact"
        return m

    def step(m, albedo, rough, adam=False):
        p = convert.material_params_from_numpy(albedo, rough, device="cpu",
                                               requires_grad=True)
        o = m._forward(p, inp["mvp"], inp["pos"], 2, spec_shift=inp["shift"])
        ones = torch.ones_like(o["rgb"][..., :1])
        loss = TL.render_loss(
            t(inp["gt"]), o, ones, t(inp["seg"]).long(), 7, 2,
            highlight=t(inp["highlight"]), seg_region=ones,
            room_id=t(inp["room"]).long(), num_rooms=2)[0]
        loss.backward()
        if m.spmd_mesh is not None:
            m.spmd_mesh.all_reduce_grads([p.albedo, p.roughness])
        res = dict(loss=loss.item(), ga=p.albedo.grad.numpy().copy(),
                   gr=p.roughness.grad.numpy().copy())
        if adam:
            opt, _ = adam_staircase([p.albedo, p.roughness], 3e-2, 20, 0.8, 1)
            opt.step()
            with torch.no_grad():
                c = clamp_material_params(p)
            res["albedo"], res["rough"] = c.albedo.numpy(), c.roughness.numpy()
        return res

    for k, v in step(model(spmd_mesh=mesh), inp["albedo"], inp["rough"],
                     adam=True).items():
        out["dp_" + k] = v
    for k, v in step(model(), inp["albedo"], inp["rough"]).items():
        out["one_" + k] = v
    amesh = mesh  # the world: the atlas mesh of parallel_meshes_from_conf
    for k, v in step(model(atlas_mesh=amesh),
                     shard_atlas(amesh, t(inp["albedo"])).numpy(),
                     shard_atlas(amesh, t(inp["rough"])).numpy()).items():
        out["tp_" + k] = v

    # -- tp_sample_materials -----------------------------------------------
    alb = shard_atlas(amesh, t(inp["tp_alb"])).requires_grad_(True)
    rgh = shard_atlas(amesh, t(inp["tp_rgh"])).requires_grad_(True)
    a, r, womip = tp_sample_materials(amesh, alb, rgh, t(inp["tp_uv"]),
                                      t(inp["tp_la"]), t(inp["tp_lr"]))
    ((t(inp["tp_wa"]) * a).sum() + (t(inp["tp_wr"]) * r).sum()
     + (t(inp["tp_wr"]) * womip).sum()).backward()
    out.update(tps_a=a.detach().numpy(), tps_r=r.detach().numpy(),
               tps_w=womip.detach().numpy(), tps_ga=alb.grad.numpy(),
               tps_gr=rgh.grad.numpy())

    # -- the field stages' sharded GT traces ------------------------------
    from texir_code_tpu_torch.models.tracer_irf import TracerIRF
    from texir_code_tpu_torch.models.tracer_irrf import TracerIRRF
    from texir_code_tpu_torch.models.tracer_pil import TracerPIL

    flat = build_bvh(tmesh.vertices, tmesh.faces)
    ftbl = build_tbl_from_flat(flat, tmesh, inp["hdr"], device="cpu")
    ffan = FanScene.from_flat(flat, triangle_uvs=tmesh.triangle_uvs())
    fcl = ClusterScene.from_fan(ffan, lb=8, dense=True, device="cpu")
    pts, nrm = t(inp["field_pts"]), t(inp["field_nrm"])
    res = tuple(int(v) for v in inp["field_res"])
    for tag, sm in (("field", mesh), ("field_one", None)):
        if sm is None and rank:
            break
        out[tag + "_irrf"] = TracerIRRF(ftbl, cluster_scene=fcl,
                                        spmd_mesh=sm).trace_gt(
            pts, nrm, res, seed=5).numpy()
        dirs, rad = TracerIRF(ftbl, cluster_scene=fcl,
                              spmd_mesh=sm).trace_gt(pts, nrm, res, seed=6)
        out[tag + "_irf"] = rad.numpy()
        out[tag + "_irf_dirs"] = dirs.numpy()
        out[tag + "_pil"] = np.concatenate([a.numpy() for a in TracerPIL(
            ftbl, cluster_scene=fcl, spmd_mesh=sm).trace_gt(
                pts, nrm, res[0] * res[1], seed=7)], axis=-1)

    # -- the runners: MatSyn under atlas TP (a run, then a restore), the
    # field stages under spmd (an epoch each) ------------------------------
    import json

    from texir_code_tpu_torch.config import parse_file
    from texir_code_tpu_torch.train.irf_pil import (
        IRFTrainRunner, PILTrainRunner)
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner
    from texir_code_tpu_torch.train.material_syn import MatTrainSynRunner

    with open(f"{d}/runs.json") as f:
        runs = json.load(f)

    def conf_of(kind):
        c = parse_file(runs[kind + "_conf"])
        for k, v in runs[kind + "_sets"].items():
            c.put(k, v)
        return c

    kw = dict(exps_root=f"{d}/exps-tp", max_epochs=1, device="cpu")
    r = MatTrainSynRunner(conf_of("mat"), **kw)
    assert r.model.atlas_mesh is not None and r.model.spmd_mesh is None
    r.run()
    out["run_tp_albedo"], out["run_tp_rough"] = r.atlases()
    r = MatTrainSynRunner(conf_of("mat"), is_continue=True, **kw)
    out["run_tp_restored_albedo"], out["run_tp_restored_rough"] = r.atlases()
    out["run_tp_rows_albedo"] = r.params.albedo.numpy()
    out["run_tp_rows_rough"] = r.params.roughness.numpy()
    for name, cls in (("irrf", IRRFTrainRunner), ("irf", IRFTrainRunner),
                      ("pil", PILTrainRunner)):
        r = cls(conf_of("irrf" if name == "irrf" else "field"), exps_root=f"{d}/exps-{name}", max_epochs=1,
                device="cpu")
        assert r.model.spmd_mesh.size == 2
        out["run_" + name] = np.concatenate([
            p.detach().reshape(-1).numpy() for p in r.run().parameters()])

    np.savez(f"{d}/rank{rank}.npz", **out)
    shutdown_multihost()
''')


def _field_points(scene, rng):
    """FIELD_POINTS random points of random triangles, just off their
    faces along the interpolated vertex normals."""
    m = scene.mesh
    f = m.faces[rng.integers(0, len(m.faces), FIELD_POINTS)]
    w = rng.dirichlet(np.ones(3), FIELD_POINTS)[..., None]
    n = (m.vertex_normals[f] * w).sum(1)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = (m.vertices[f] * w).sum(1) + 1e-3 * n
    return p.astype(np.float32), n.astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs, the two gloo ranks' results and JAX's 2-device results."""
    d = tmp_path_factory.mktemp("ranks")
    scene = make_scene(atlas_res=48)
    m = scene.mesh
    rng = np.random.default_rng(21)
    irt = rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32)
    pos = np.asarray(scene.camera_positions(1)[0], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = np.array(JG.cube_mvp(jnp.asarray(ext)))
    res = PANO[1] // 4
    b = 6 * res * res
    key = jax.random.PRNGKey(7)
    # the JAX model's own draw (texir_code_tpu/models/material.py:585-597)
    row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(b, dtype=jnp.int32))
    shift = np.array(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(row_keys))
    pts, nrm = _field_points(scene, rng)
    inp = dict(
        vertices=m.vertices, faces=m.faces, uvs=m.uvs, uv_faces=m.uv_faces,
        vertex_normals=m.vertex_normals, hdr=scene.hdr_texture, irt=irt,
        mvp=mvp, pos=pos, shift=shift,
        albedo=rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32),
        rough=rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32),
        gt=rng.uniform(0.0, 1.5, (6, res, res, 3)).astype(np.float32),
        seg=rng.integers(0, NUM_CLASSES - 1, (6, res, res)).astype(np.int32),
        highlight=(rng.random((6, res, res, 1)) < 0.3).astype(np.float32),
        room=rng.integers(0, 2, (6, res, res)).astype(np.int32),
        tp_alb=rng.uniform(0, 1, (64, 64, 3)).astype(np.float32),
        tp_rgh=rng.uniform(0, 1, (128, 128, 1)).astype(np.float32),
        tp_uv=rng.uniform(0, 1, (200, 2)).astype(np.float32),
        tp_la=rng.uniform(0, 6, (200,)).astype(np.float32),
        tp_lr=rng.uniform(0, 7, (200,)).astype(np.float32),
        tp_wa=rng.standard_normal((200, 3)).astype(np.float32),
        tp_wr=rng.standard_normal((200, 1)).astype(np.float32),
        field_pts=pts, field_nrm=nrm, field_res=np.asarray(FIELD_RES),
    )
    np.savez(d / "inputs.npz", **inp)
    runs = _runner_scans(d)
    worker = d / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(r), str(d), ROOT],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    try:
        # while the ranks run
        jax_out = _jax_results(scene, inp)
        one_runs = _one_process_runs(runs, d)
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return dict(inp=inp, jax=jax_out, one_runs=one_runs,
                r=[dict(np.load(d / f"rank{r}.npz")) for r in (0, 1)])


def _runner_scans(d):
    """The runner cases' scans and confs, written to d/runs.json: a MatSyn
    scan of the small apartment (3 views, the last held out; 32² atlases,
    pano 32×64, atlas_tp, the stochastic knobs off) and a field scan of
    make_scene(48)."""
    import json

    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene
    from texir_code_tpu_torch.data.synthetic import make_scene as t_scene

    mat = export_reference_layout(
        make_apartment_scene(atlas_res=32, subdiv=2, clutter=0),
        str(d / "mat-scan"), n_views=3, pano_res=(32, 64),
        gt_render="material", gt_spp=8, irt_spp=32, device="cpu")
    with open(str(d / "mat-scan" / "info" / "novel.txt"), "w") as f:
        f.write("view002\n")
    hdrio.write_hdr(mat.replace("out1.obj", "irt.hdr"), hdrio.read_hdr(
        mat.replace("out1.obj", "gt_irt.hdr"), flip=True), flip=True)
    field = export_reference_layout(t_scene(atlas_res=48),
                                    str(d / "field-scan"), n_views=2,
                                    pano_res=(32, 64), device="cpu")
    field_sets = {"train.path_mesh_open3d": field,
                  "train.samples_point_mesh": 64, "train.env_res": [4, 8],
                  "val.env_res": [16, 32], "train.val_sample_res": [4, 8],
                  "val.pil_points": 64, "val.pil_spp": 32}
    runs = dict(
        mat_conf=os.path.join(ROOT, "configs", "mat_synthetic.conf"),
        mat_sets={"train.path_mesh_open3d": mat,
                  "train.pano_img_res": [32, 64],
                  "train.mat_albedo_res": 32, "train.mat_roughness_res": 32,
                  "train.sample_light": [32, 4], "train.plot_freq": 0,
                  "train.atlas_tp": True,
                  # the TP lookups are exact trilinear: the replicated
                  # run samples the same way
                  "models.render.mip_stochastic": False,
                  "models.render.bilinear_stochastic": False},
        field_conf=os.path.join(ROOT, "configs", "irrf_synthetic.conf"),
        field_sets=field_sets,
        irrf_conf=os.path.join(ROOT, "configs", "irrf_synthetic.conf"),
        irrf_sets=dict(field_sets, **{"models.irrf_network.dims": [64, 64]}))
    with open(d / "runs.json", "w") as f:
        json.dump(runs, f)
    return runs


def _one_process_runs(runs, d):
    """The runner cases in this process alone: the MatSyn atlases
    (train.atlas_tp asks for nothing with one rank: replicated) and each
    field stage's parameters after its epoch."""
    from texir_code_tpu_torch.config import parse_file
    from texir_code_tpu_torch.train.irf_pil import (
        IRFTrainRunner,
        PILTrainRunner,
    )
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner
    from texir_code_tpu_torch.train.material_syn import MatTrainSynRunner

    def conf_of(kind):
        c = parse_file(runs[kind + "_conf"])
        for k, v in runs[kind + "_sets"].items():
            c.put(k, v)
        return c

    r = MatTrainSynRunner(conf_of("mat"), exps_root=str(d / "one-tp"),
                          max_epochs=1, device="cpu")
    assert r.model.atlas_mesh is None
    r.run()
    out = dict(zip(("albedo", "rough"), r.atlases()))
    for name, cls in (("irrf", IRRFTrainRunner), ("irf", IRFTrainRunner),
                      ("pil", PILTrainRunner)):
        r = cls(conf_of("irrf" if name == "irrf" else "field"),
                exps_root=str(d / f"one-{name}"), max_epochs=1,
                device="cpu")
        out[name] = np.concatenate([p.detach().reshape(-1).numpy()
                                    for p in r.run().parameters()])
    return out


def _jax_results(scene, inp):
    """JAX's 2-device results: the spmd stage-2 step's loss and gradients,
    and tp_sample_materials' outputs and gradients."""
    res = PANO[1] // 4
    mesh = JM.make_device_mesh(2)
    jm = JMat(scene.mesh, scene.hdr_texture, inp["irt"], pano_res=PANO,
              sample_light=(32, SPEC_SPP), spmd_mesh=mesh)
    assert not jm.use_pallas  # the JAX CPU path (BVH, exact fetch)
    ones = jnp.ones((6, res, res, 1))

    def loss(p):
        out = jm._forward(p, jnp.asarray(inp["mvp"]), jnp.asarray(inp["pos"]),
                          jax.random.PRNGKey(7), stage=2)
        return JL.render_loss(
            jnp.asarray(inp["gt"]), out, ones, jnp.asarray(inp["seg"]),
            NUM_CLASSES, 2, highlight=jnp.asarray(inp["highlight"]),
            seg_region=ones, room_id=jnp.asarray(inp["room"]),
            num_rooms=2)[0]

    lj, gj = jax.jit(jax.value_and_grad(loss))(JParams(
        albedo=jnp.asarray(inp["albedo"]), roughness=jnp.asarray(inp["rough"])))
    amesh = JTP.make_atlas_mesh(2)
    args = [jnp.asarray(inp[k]) for k in ("tp_uv", "tp_la", "tp_lr")]

    def tp(alb, rgh):
        return JTP.tp_sample_materials(amesh, alb, rgh, *args)

    def tp_loss(alb, rgh):
        a, r, w = tp(alb, rgh)
        return (jnp.sum(inp["tp_wa"] * a) + jnp.sum(inp["tp_wr"] * r)
                + jnp.sum(inp["tp_wr"] * w))

    alb, rgh = jnp.asarray(inp["tp_alb"]), jnp.asarray(inp["tp_rgh"])
    ga, gr = jax.jit(jax.grad(tp_loss, argnums=(0, 1)))(alb, rgh)
    return dict(loss=float(lj), ga=np.asarray(gj.albedo),
                gr=np.asarray(gj.roughness),
                tps=[np.asarray(x) for x in jax.jit(tp)(alb, rgh)],
                tps_ga=np.asarray(ga), tps_gr=np.asarray(gr))


def _close_grads(got, ref, rtol=1e-4, atol_frac=1e-5, rel_l2=1e-5):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_frac * np.abs(ref).max())
    assert np.linalg.norm(got - ref) <= rel_l2 * np.linalg.norm(ref)


# ---------------------------------------------------------------------------
# host-side helpers, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,count", [(10, 2), (7, 3), (1, 2), (0, 4),
                                     (4096, 8), (5, 5)])
def test_process_local_slice_matches_jax(n, count):
    got = [process_local_slice(n, r, count) for r in range(count)]
    assert got == [j_pls(n, r, count) for r in range(count)]
    assert sum(s.stop - s.start for s in got) == n


@pytest.mark.parametrize("n,m", [(10, 4), (8, 4), (0, 3), (1, 1)])
def test_pad_to_multiple_matches_jax(n, m):
    assert TM.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)


@pytest.mark.parametrize("h,w,d,levels", [
    (64, 64, 8, None), (64, 48, 2, None), (2048, 2048, 2, 13),
    (4096, 4096, 2, 13), (128, 64, 4, 3), (32, 32, 1, None), (48, 32, 2, 0)])
def test_atlas_tp_spec_matches_jax(h, w, d, levels):
    assert TTP.AtlasTPSpec.build(h, w, d, levels).__dict__ == \
        JTP.AtlasTPSpec.build(h, w, d, levels).__dict__


def test_atlas_tp_spec_refuses_uneven_rows():
    with pytest.raises(ValueError):
        TTP.AtlasTPSpec.build(100, 100, 8)


def test_mesh_shares_cut_at_units():
    mesh = TM.DeviceMesh(None, 0, 3, torch.device("cpu"))
    # 13 units of 8: 5, 5 and 3 units
    assert mesh.shares(100, 8) == [slice(0, 40), slice(40, 80),
                                   slice(80, 100)]
    assert mesh.shares(5, 8) == [slice(0, 5), slice(5, 5), slice(5, 5)]


def test_one_rank_mesh_collectives_are_identities():
    mesh = TM.make_device_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None
    x = torch.arange(6.0).reshape(3, 2)
    assert TM.psum_replicated(x, mesh) is x
    assert TM.all_gather_rows(x, mesh, [3]) is x
    assert mesh.all_reduce_(x.clone()).equal(x)
    assert TM.shard_along(mesh, x).equal(x) and TM.replicated(mesh, x) is x
    assert mesh.broadcast_(x.clone()).equal(x)


@pytest.mark.parametrize("entry", ["rank_device", "make_device_mesh",
                                   "dryrun_multichip", "make_atlas_mesh"])
def test_entry_points_need_a_card_unless_cpu(entry):
    """The meshes and the dry run default to the card: without one they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    from texir_code_tpu_torch.parallel import dryrun

    fn = {"rank_device": TM.rank_device,
          "make_device_mesh": TM.make_device_mesh,
          "dryrun_multichip": dryrun.dryrun_multichip,
          "make_atlas_mesh": TTP.make_atlas_mesh}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


def test_make_atlas_mesh_on_the_cpu():
    """JAX's make_atlas_mesh name over make_device_mesh: one process
    without a group is a one-rank mesh; a count that is not the world's
    raises."""
    mesh = TTP.make_atlas_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None
    assert mesh.device == torch.device("cpu")
    assert TTP.make_atlas_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError):
        TTP.make_atlas_mesh(2, device="cpu")


def test_parallel_meshes_from_conf_one_rank():
    from texir_code_tpu_torch.config import parse_string

    conf = parse_string("train { spmd = true }")
    spmd, atlas = TM.parallel_meshes_from_conf(conf, "cpu")
    assert atlas is None and spmd.size == 1
    for text in ("train { spmd = auto }", "train { atlas_tp = true }", ""):
        assert TM.parallel_meshes_from_conf(parse_string(text), "cpu") == (
            None, None)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def test_replicated_loss_gives_the_single_rank_gradient(ranks):
    for r, out in enumerate(ranks["r"]):
        # d/dx of sum over ranks of (r+1)·x: (r+1), not world size × it
        np.testing.assert_array_equal(out["psum_grad"], np.full(3, r + 1.0))
        np.testing.assert_array_equal(
            out["gather_value"], np.repeat([[1.0] * 3, [2.0] * 3], 2, 0))
        w = np.arange(12.0).reshape(4, 3)
        np.testing.assert_array_equal(out["gather_grad"], w[2 * r:2 * r + 2])


def test_sharded_bake_bit_equal_to_one_rank(ranks):
    r0, r1 = ranks["r"]
    assert r0["bake_single"].any()
    np.testing.assert_array_equal(r0["bake"], r0["bake_single"])
    np.testing.assert_array_equal(r1["bake"], r0["bake_single"])


def test_data_parallel_step_matches_one_rank(ranks):
    r0, r1 = ranks["r"]
    for out in (r0, r1):
        assert abs(out["dp_loss"] - r0["one_loss"]) <= 1e-6 * abs(
            r0["one_loss"])
        _close_grads(out["dp_ga"], r0["one_ga"])
        _close_grads(out["dp_gr"], r0["one_gr"])
    # Adam and the clamp keep the atlases replicated
    np.testing.assert_array_equal(r0["dp_albedo"], r1["dp_albedo"])
    np.testing.assert_array_equal(r0["dp_rough"], r1["dp_rough"])
    assert not np.array_equal(r0["dp_albedo"], ranks["inp"]["albedo"])


def test_data_parallel_step_matches_jax_spmd(ranks):
    j = ranks["jax"]
    for out in ranks["r"]:
        np.testing.assert_allclose(out["dp_loss"], j["loss"], rtol=1e-5)
        for name in ("ga", "gr"):
            assert np.abs(j[name]).max() > 0
            np.testing.assert_allclose(out["dp_" + name], j[name], rtol=1e-4,
                                       atol=1e-6)


def test_tp_sample_materials_matches_jax(ranks):
    j = ranks["jax"]
    for out in ranks["r"]:
        for k, ref in zip(("tps_a", "tps_r", "tps_w"), j["tps"]):
            np.testing.assert_allclose(out[k], ref, atol=2e-6)
    for k in ("tps_ga", "tps_gr"):
        got = np.concatenate([out[k] for out in ranks["r"]])
        assert np.abs(j[k]).max() > 0
        np.testing.assert_allclose(got, j[k], atol=2e-5)


def test_atlas_tp_step_matches_replicated_step(ranks):
    r0, r1 = ranks["r"]
    for out in (r0, r1):
        np.testing.assert_allclose(out["tp_loss"], r0["one_loss"], rtol=1e-5)
    for k in ("ga", "gr"):
        got = np.concatenate([r0["tp_" + k], r1["tp_" + k]])
        np.testing.assert_allclose(got, r0["one_" + k], rtol=1e-4, atol=1e-7)
        assert np.abs(got).max() > 0


@pytest.mark.parametrize("tracer", ["irrf", "irf", "irf_dirs", "pil"])
def test_sharded_trace_gt_bit_equal_to_one_rank(ranks, tracer):
    r0, r1 = ranks["r"]
    one = r0["field_one_" + tracer]
    assert np.isfinite(one).all() and one.any()
    np.testing.assert_array_equal(r0["field_" + tracer], one)
    np.testing.assert_array_equal(r1["field_" + tracer], one)


def test_atlas_tp_matsyn_run_matches_one_process(ranks):
    """Three substages, the save and the MatSyn metrics through
    MatTrainSynRunner on two ranks with the atlases row-sharded: the
    gathered atlases equal on both ranks and against the runner in one
    process (replicated) within relative 1e-5, elementwise and in L2 (the
    TP fetch's backward scatters into the local rows, and those sums round
    apart from the whole atlas's by an ulp)."""
    r0, r1 = ranks["r"]
    one = ranks["one_runs"]
    for k in ("albedo", "rough"):
        got = r0["run_tp_" + k]
        np.testing.assert_array_equal(got, r1["run_tp_" + k])
        assert got.shape == one[k].shape
        assert not np.array_equal(got, np.full_like(got, got.flat[0]))
        np.testing.assert_allclose(got, one[k], rtol=1e-5, atol=0)
        assert np.linalg.norm(got - one[k]) <= 1e-5 * np.linalg.norm(one[k])


def test_atlas_tp_matsyn_restore_gives_each_rank_its_rows(ranks):
    """--is_continue: rank 0 reads the checkpoint and each rank keeps its
    rows of what the run saved."""
    for r, out in enumerate(ranks["r"]):
        for k in ("albedo", "rough"):
            saved = out["run_tp_" + k]
            np.testing.assert_array_equal(out["run_tp_restored_" + k], saved)
            h = saved.shape[0] // 2
            np.testing.assert_array_equal(out["run_tp_rows_" + k],
                                          saved[r * h:(r + 1) * h])


@pytest.mark.parametrize("stage", ["irrf", "irf", "pil"])
def test_field_runner_two_ranks_match_one_process(ranks, stage):
    """An epoch of the field stage with its GT traces split over two ranks:
    the parameters bit-equal on both ranks and to the run in one
    process."""
    r0, r1 = ranks["r"]
    one = ranks["one_runs"][stage]
    np.testing.assert_array_equal(r0["run_" + stage], one)
    np.testing.assert_array_equal(r1["run_" + stage], one)


# ---------------------------------------------------------------------------
# the CLI as two processes
# ---------------------------------------------------------------------------


def test_cli_irrt_two_processes_match_one(tmp_path):
    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.data.synthetic import make_scene as t_scene
    from texir_code_tpu_torch.geometry.obj import save_obj

    mesh_dir = tmp_path / "scan" / "mesh"
    mesh_dir.mkdir(parents=True)
    path = str(mesh_dir / "out1.obj")
    scene = t_scene(atlas_res=32)
    save_obj(path, scene.mesh)
    hdrio.write_hdr(str(mesh_dir / "hdr_texture.hdr"), scene.hdr_texture,
                    flip=True)
    conf = os.path.join(ROOT, "configs", "irt_synthetic.conf")

    def argv(exps):
        return ["train", "--conf", conf, "--trainstage", "IrrT",
                "--irt_res", "16", "--exps_folder", str(exps),
                "--device", "cpu", "--set", f"train.path_mesh_open3d={path}",
                "--set", "train.sample_light=[64, 16]",
                "--set", "train.texel_batch=64"]

    coord = f"127.0.0.1:{free_port()}"
    out = run_ranks(
        [[sys.executable, "-m", "texir_code_tpu_torch.cli"]
         + argv(tmp_path / "exps2") + ["--coordinator", coord,
                                       "--num_processes", "2",
                                       "--process_id", str(r)]
         for r in (0, 1)],
        timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=ROOT)
    assert "multihost: process 1/2 (gloo)" in out[1]
    two = hdrio.read_hdr(path.replace("out1.obj", "irt.hdr"), flip=True)
    assert len(os.listdir(tmp_path / "exps2" / "IrrT-default")) == 1
    assert cli.main(argv(tmp_path / "exps1")) == 0
    one = hdrio.read_hdr(path.replace("out1.obj", "irt.hdr"), flip=True)
    assert one.any()
    np.testing.assert_array_equal(two, one)
