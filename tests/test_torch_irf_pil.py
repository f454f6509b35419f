"""Port vs JAX: the IRF and PIL stages and the field datasets on a small
synthetic scan (`make_scene(atlas_res=48)`, 2 views) on the CPU.

  * `MeshPoint`: the same points for the same seed; `ImageMeshPoint` at
    env_res (16, 32): the same mask, points and normals within 1e-6.
  * `TracerIRF.forward` and `TracerPIL.forward` from the same weights
    (`convert.field_params_from_flax`), points and JAX's own draws
    injected, through the BVH route (JAX's CPU route): the stage loss
    (the hdr_scale-domain L1) within rel 1e-5; through the culled walk
    (the runners' route) within rel 1e-4.
  * `split_sum_lut` at res 16 with JAX's samples injected: within 1e-5.
  * `train --trainstage IRF` and `--trainstage PIL` through the port's CLI
    on the CPU: finite losses and the val metrics in `timings.json`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data import datasets as JD
from texir_code_tpu.geometry import load_obj as j_load_obj
from texir_code_tpu.models.fields import IRNetwork as JIR
from texir_code_tpu.models.fields import PILNetwork as JPIL
from texir_code_tpu.models.tbl import build_tbl as j_build_tbl
from texir_code_tpu.models.tracer_irf import TracerIRF as JIRF
from texir_code_tpu.models.tracer_pil import TracerPIL as JPILT
from texir_code_tpu.models.tracer_pil import split_sum_lut as j_lut
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu.ops.shading import hdr_scale as j_hdr_scale
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.data import datasets as TD
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.export import export_reference_layout
from texir_code_tpu_torch.data.synthetic import make_scene
from texir_code_tpu_torch.geometry import build_bvh, load_obj
from texir_code_tpu_torch.models.fields import IRNetwork, PILNetwork
from texir_code_tpu_torch.models.tbl import build_tbl
from texir_code_tpu_torch.models.tracer_irf import TracerIRF
from texir_code_tpu_torch.models.tracer_pil import TracerPIL, split_sum_lut
from texir_code_tpu_torch.ops.fan_raycast import FanScene
from texir_code_tpu_torch.ops.pallas_culled import ClusterScene
from texir_code_tpu_torch.ops.shading import hdr_scale

torch.set_num_threads(2)  # six test workers share the host's cores

CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "irrf_synthetic.conf")
RES = (8, 16)
VAL_RES = (16, 32)
B = 32


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rows(key, b):
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("irf_pil_data"))
    return export_reference_layout(make_scene(atlas_res=48), out, n_views=2,
                                   pano_res=(32, 64), device="cpu")


@pytest.fixture(scope="module")
def scenes(data):
    """(JAX TBL, port TBL, port ClusterScene lb 8, points, normals)."""
    tex = hdrio.read_hdr(data.replace("out1.obj", "hdr_texture.hdr"),
                         flip=True)
    mesh = load_obj(data)
    fan = FanScene.from_flat(build_bvh(mesh.vertices, mesh.faces),
                             triangle_uvs=mesh.triangle_uvs())
    pts = TD.MeshPoint(data, num_sample=B, seed=8)
    return (j_build_tbl(j_load_obj(data), tex),
            build_tbl(mesh, tex, device="cpu"),
            ClusterScene.from_fan(fan, lb=8, dense=True, device="cpu"),
            pts.points, pts.normals)


def test_mesh_point_matches_jax(data):
    a = JD.MeshPoint(data, num_sample=100, seed=5)
    b = TD.MeshPoint(data, num_sample=100, seed=5)
    for _ in range(2):
        np.testing.assert_array_equal(b.points, a.points)
        np.testing.assert_array_equal(b.normals, a.normals)
        assert len(b) == 100 and b[3]["points"].shape == (3,)
        a.change_points()
        b.change_points()
    assert [x["points"].shape[0] for x in b.batches(32)] == [32, 32, 32, 4]


def test_image_mesh_point_matches_jax(data):
    a = JD.ImageMeshPoint(data, env_res=VAL_RES)
    b = TD.ImageMeshPoint(data, env_res=VAL_RES, device="cpu")
    np.testing.assert_array_equal(b.mask, a.mask)
    assert b.mask.mean() > 0.9
    np.testing.assert_allclose(b.points, a.points, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.normals, a.normals, rtol=0, atol=1e-6)
    assert len(b) == VAL_RES[0] * VAL_RES[1]


def _port(tracer_cls, net, params, ttbl, clusters):
    tracer = tracer_cls(ttbl, net, cluster_scene=clusters)
    net.load_state_dict(convert.field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), net))
    return tracer


def _loss(out):
    return float((hdr_scale(out["gt"]) - out["pred"]).abs().mean().detach())


def _j_loss(out):
    return float(jnp.mean(jnp.abs(j_hdr_scale(out["gt"]) - out["pred"])))


@pytest.mark.parametrize("stage", ["IRF", "PIL"])
def test_forward_loss_matches_jax(scenes, stage):
    jtbl, ttbl, clusters, pts, nrm = scenes
    key = jax.random.PRNGKey(21)
    rows = _rows(key, B)
    s = RES[0] * RES[1]
    if stage == "IRF":
        jt, jnet, tcls, tnet = JIRF(jtbl, JIR()), JIR(), TracerIRF, IRNetwork()
        params = jnet.init(key, jnp.zeros((1, 3)), jnp.zeros((1, 3)))
        samples = torch.from_numpy(np.asarray(
            stratified_samples(key, B, s, row_keys=rows)))

        def inject(tracer):
            tracer.draw_samples = lambda seed, ids, n: samples
    else:
        jt, jnet, tcls, tnet = (JPILT(jtbl, JPIL()), JPIL(), TracerPIL,
                                PILNetwork())
        params = jnet.init(key, jnp.zeros((1, 3)), jnp.zeros((1, 3)),
                           jnp.zeros((1, 1)))

        def fold(k):
            return jax.vmap(lambda r: jax.random.fold_in(r, k))(rows)

        rough = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1,)))(
            fold(1)))
        half = np.asarray(stratified_samples(None, B, s, row_keys=fold(2)))
        wo = np.asarray(stratified_samples(None, B, 1, "independent",
                                           row_keys=fold(3)))

        def inject(tracer):
            tracer.draw = lambda seed, ids, n: (_t(rough), _t(half), _t(wo))
    jout = jt.forward(params, jnp.asarray(pts), jnp.asarray(nrm), RES, key)
    want = _j_loss(jout)
    for clusters_, rtol in ((None, 1e-5), (clusters, 1e-4)):
        tracer = _port(tcls, tnet, params, ttbl, clusters_)
        inject(tracer)
        out = tracer.forward(_t(pts), _t(nrm), RES, seed=3)
        assert abs(_loss(out) - want) <= rtol * abs(want), (clusters_, rtol)
        assert out["pred"].requires_grad and not out["gt"].requires_grad
    if stage == "PIL":
        np.testing.assert_allclose(out["roughness"].numpy(), rough)
        np.testing.assert_allclose(out["wo"].numpy(), np.asarray(jout["wo"]),
                                   atol=1e-6)


def test_split_sum_lut_matches_jax():
    samples = np.array(stratified_samples(jax.random.PRNGKey(0), 1, 1024))
    a = j_lut(res=16)
    b = split_sum_lut(res=16, samples=samples)
    assert b.shape == (16, 16, 2)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    # the port's own draw: the same table within its sampling noise
    c = split_sum_lut(res=16)
    assert np.abs(c - a).max() < 0.05 and (c >= 0).all()


@pytest.mark.parametrize("stage", ["IRF", "PIL"])
def test_stage_cli_cpu(data, tmp_path, stage):
    exps = str(tmp_path / "exps")
    argv = ["train", "--conf", CONF, "--trainstage", stage, "--device",
            "cpu", "--max_epochs", "1", "--exps_folder", exps]
    for kv in (f"train.path_mesh_open3d={data}", "train.samples_point_mesh=64",
               "train.env_res=[4,8]", "val.env_res=[16,32]",
               "train.val_sample_res=[4,8]", "val.pil_points=64",
               "val.pil_spp=32"):
        argv += ["--set", kv]
    assert cli.main(argv) == 0
    (root,) = [r for r, _, f in os.walk(exps) if "timings.json" in f]
    assert os.path.basename(os.path.dirname(root)) == f"{stage}-default"
    with open(os.path.join(root, "timings.json")) as f:
        tm = json.load(f)
    assert tm["steps"] == 4
    metrics = tm["val_metrics"]
    assert np.isfinite(list(metrics.values())).all()
    want = {"val_psnr", "val_ssim"} if stage == "IRF" else {
        "val_psnr", "val_psnr_r0.1", "val_psnr_r0.9"}
    assert want <= set(metrics)
    with open(os.path.join(root, "scalars.tsv")) as f:
        losses = [float(ln.split("\t")[2]) for ln in f
                  if ln.startswith(f"{stage}_loss\t")]
    assert losses and np.isfinite(losses).all()
