"""Port vs JAX: the NIrF stage (IRRF) on a small synthetic scan
(`make_scene(atlas_res=48)`, 2 views) on the CPU.

  * `TracerIRRF.trace_gt` with JAX's directions injected: within rtol
    1e-5 through the BVH route (`cluster_scene=None`, JAX's own CPU
    route); through the culled walk (the route the runner takes) within
    rtol 1e-4 on all but one value in 1000.
  * One IRRF step from the same weights (`convert.field_params_from_flax`),
    points and draws: the loss within rel 1e-5, each layer's gradient
    within relative L2 1e-4.
  * The runners for two epochs at env_res [4, 8] (network 2×64) with
    JAX's draws and initial weights: every step's loss within rel 1e-3, the
    final val PSNR (an 8×16 pano) within rel 1e-3.
  * A furnace (a closed box of constant radiance 2): the GT is 2π through
    both routes, and Adam steps halve the loss (JAX's
    tests/test_tracers.py::test_irrf_trains_toward_gt).
  * `train --trainstage IRRF` through the port's CLI on the CPU, and a run
    that continues from its checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.geometry import load_obj as j_load_obj
from texir_code_tpu.models.fields import MatNetwork as JMat
from texir_code_tpu.models.losses import irf_loss as j_irf_loss
from texir_code_tpu.models.tbl import build_tbl as j_build_tbl
from texir_code_tpu.models.tracer_irrf import TracerIRRF as JTracer
from texir_code_tpu.ops.sampling import generate_dir as j_generate_dir
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu.train.irrf import IRRFTrainRunner as JRunner
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.config import _parse_value, parse_file
from texir_code_tpu_torch.data import datasets as TD
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.export import export_reference_layout
from texir_code_tpu_torch.data.synthetic import make_scene
from texir_code_tpu_torch.geometry import build_bvh, load_obj
from texir_code_tpu_torch.models.fields import MatNetwork
from texir_code_tpu_torch.models.losses import irf_loss
from texir_code_tpu_torch.models.tbl import build_tbl
from texir_code_tpu_torch.models.tracer_irrf import TracerIRRF
from texir_code_tpu_torch.ops.fan_raycast import FanScene
from texir_code_tpu_torch.ops.pallas_culled import ClusterScene
from texir_code_tpu_torch.train.irrf import IRRFTrainRunner, step_seed

torch.set_num_threads(2)  # six test workers share the host's cores

CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "irrf_synthetic.conf")
RES = (16, 32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def jax_samples(key, b, s):
    """[B, S, 2] JAX's uniform-mode samples of a trace keyed by `key`
    (rows keyed by fold_in(key, i), TracerIRRF.trace_gt)."""
    rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
    return stratified_samples(key, b, s, row_keys=rows), rows


def jax_draw(seed, row_ids, s):
    """The JAX runner's samples for its keyed call n = seed - step_seed(0),
    rows numbered from the batch's first."""
    key = jax.random.fold_in(jax.random.PRNGKey(666), seed - step_seed(0))
    return torch.from_numpy(np.array(jax_samples(key, len(row_ids), s)[0]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("irrf_data"))
    return export_reference_layout(make_scene(atlas_res=48), out, n_views=2,
                                   pano_res=(32, 64), device="cpu")


@pytest.fixture(scope="module")
def scenes(data):
    """(JAX TBL, port TBL, port ClusterScene lb 8, surface points/normals)."""
    tex = hdrio.read_hdr(data.replace("out1.obj", "hdr_texture.hdr"),
                         flip=True)
    mesh = load_obj(data)
    ttbl = build_tbl(mesh, tex, device="cpu")
    fan = FanScene.from_flat(build_bvh(mesh.vertices, mesh.faces),
                             triangle_uvs=mesh.triangle_uvs())
    clusters = ClusterScene.from_fan(fan, lb=8, dense=True, device="cpu")
    pts = TD.MeshPoint(data, num_sample=64, seed=3)
    return (j_build_tbl(j_load_obj(data), tex), ttbl, clusters,
            pts.points, pts.normals)


@pytest.fixture(scope="module")
def jax_gt(scenes):
    """JAX's GT irradiance of the 64 points at RES, its directions and
    samples (one compile of its trace for the tests below)."""
    jtbl, _, _, pts, nrm = scenes
    key = jax.random.PRNGKey(11)
    s = RES[0] * RES[1]
    samples, rows = jax_samples(key, pts.shape[0], s)
    dirs = j_generate_dir(jnp.asarray(nrm), s, rows[0], mode="uniform",
                          row_keys=rows)
    gt = JTracer(jtbl, JMat(dims=(8,))).trace_gt(
        jnp.asarray(pts), jnp.asarray(nrm), RES, key)
    return np.asarray(gt), np.asarray(dirs), np.array(samples)


def test_trace_gt_matches_jax(scenes, jax_gt):
    _, ttbl, clusters, pts, nrm = scenes
    gt, dirs, samples = jax_gt
    assert gt.shape == (64, 3) and gt.min() >= 0 and gt.max() > 0
    bvh = TracerIRRF(ttbl, MatNetwork(dims=(8,)))
    got = bvh.trace_gt(_t(pts), _t(nrm), RES, dirs=_t(dirs)).numpy()
    np.testing.assert_allclose(got, gt, rtol=1e-5, atol=1e-6)
    # the port's own directions from the same samples are JAX's
    bvh.draw_samples = lambda seed, ids, s: torch.from_numpy(samples)
    np.testing.assert_allclose(
        bvh.trace_gt(_t(pts), _t(nrm), RES).numpy(), gt, rtol=1e-5,
        atol=1e-6)
    walk = TracerIRRF(ttbl, MatNetwork(dims=(8,)), cluster_scene=clusters)
    got = walk.trace_gt(_t(pts), _t(nrm), RES, dirs=_t(dirs)).numpy()
    bad = ~np.isclose(got, gt, rtol=1e-4, atol=1e-5)
    assert bad.sum() <= max(1, gt.size // 1000), bad.sum()


def test_irrf_step_matches_jax(scenes, jax_gt):
    """One step's loss and gradients, full-width network, BVH route."""
    _, ttbl, _, pts, nrm = scenes
    pts, nrm = pts[:16], nrm[:16]
    gt, dirs = jax_gt[0][:16], jax_gt[1][:16]
    key = jax.random.PRNGKey(5)
    jnet = JMat()
    params = jnet.init(key, jnp.zeros((1, 3)))

    def jloss(p):
        return j_irf_loss(jnp.asarray(gt), jnet.apply(p, jnp.asarray(pts)))

    jl, jg = jax.value_and_grad(jloss)(params)
    tracer = TracerIRRF(ttbl, MatNetwork())
    tracer.network.load_state_dict(convert.field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tracer.network))
    tgt = tracer.trace_gt(_t(pts), _t(nrm), RES, dirs=_t(dirs))
    loss = irf_loss(tgt, tracer.network(_t(pts)))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for i, layer in enumerate(tracer.network.layers):
        want = np.asarray(jg["params"][f"Dense_{i}"]["kernel"]).T
        got = layer.weight.grad.numpy()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), i
    out = tracer.forward(_t(pts), _t(nrm), RES)
    assert set(out) == {"gt", "pred", "pred_jit"}
    assert not out["gt"].requires_grad and out["pred_jit"].shape == (16, 3)
    assert "gt" not in tracer.forward(_t(pts), _t(nrm), RES, trace=False)


def _sets(data):
    return {
        "train.path_mesh_open3d": data,
        "train.samples_point_mesh": 64,
        "train.env_res": [4, 8],
        "val.env_res": [8, 16],
        "train.val_sample_res": [4, 8],
        "models.irrf_network.dims": [64, 64],
    }


def test_runner_losses_follow_jax(data, tmp_path):
    jconf, tconf = ConfigFactory.parse_file(CONF), parse_file(CONF)
    for k, v in _sets(data).items():
        jconf.put(k, v)
        tconf.put(k, v)
    jr = JRunner(jconf, exps_root=str(tmp_path / "j"), max_epochs=1)
    tr = IRRFTrainRunner(tconf, exps_root=str(tmp_path / "t"), max_epochs=1,
                         device="cpu")
    tr.model.network.load_state_dict(convert.field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params), tr.model.network))
    tr.model.draw_samples = jax_draw
    jlosses = []
    epoch_fn = jr._train_epoch

    def record(*args):
        out = epoch_fn(*args)
        jlosses.append(np.asarray(out[2]))
        return out

    jr._train_epoch = record
    jr.run()
    tr.run()
    a, b = np.concatenate(jlosses), np.concatenate(tr.epoch_losses)
    assert len(a) == len(b) == 8  # epochs 0 and 1, 4 steps each
    np.testing.assert_allclose(b, a, rtol=1e-3)
    assert b[-1] < b[0]
    np.testing.assert_allclose(tr.val_metrics["val_psnr"],
                               jr.val_metrics["val_psnr"], rtol=1e-3)


def test_furnace_trains_toward_gt():
    """A closed box of constant radiance 2: irradiance 2π everywhere
    inside, through the BVH and the walk; 50 Adam steps halve the loss."""
    from tests.test_gbuffer import make_box_mesh

    jm = make_box_mesh()
    mesh = convert.mesh_from_numpy(jm.vertices, jm.faces, jm.uvs,
                                   jm.uv_faces, jm.vertex_normals)
    tbl = build_tbl(mesh, np.full((8, 8, 3), 2.0, np.float32), device="cpu")
    fan = FanScene.from_flat(build_bvh(mesh.vertices, mesh.faces),
                             triangle_uvs=mesh.triangle_uvs())
    rng = np.random.default_rng(0)
    pts = _t(rng.random((16, 3)) * 0.8 + 0.1)
    nrm = _t(np.tile([[0, 0, 1.0]], (16, 1)))
    gts = []
    for clusters in (None, ClusterScene.from_fan(fan, lb=8, dense=True,
                                                 device="cpu")):
        tracer = TracerIRRF(tbl, MatNetwork(
            dims=(64, 64), generator=torch.Generator().manual_seed(1)),
            cluster_scene=clusters)
        gts.append(tracer.trace_gt(pts, nrm, RES, seed=1))
        np.testing.assert_allclose(gts[-1].numpy(), 2 * np.pi, rtol=0.1)
    np.testing.assert_allclose(gts[1].numpy(), gts[0].numpy(), rtol=1e-5)
    opt = torch.optim.Adam(tracer.network.parameters(), lr=1e-3)

    def loss():
        return irf_loss(gts[1], tracer.network(pts))

    l0 = float(loss().detach())
    for _ in range(50):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert float(loss().detach()) < 0.5 * l0


def _argv(data, exps):
    argv = ["train", "--conf", CONF, "--trainstage", "IRRF", "--device",
            "cpu", "--max_epochs", "1", "--exps_folder", exps]
    for k, v in _sets(data).items():
        argv += ["--set", f"{k}={v}"]
    return argv


def test_irrf_cli_cpu_and_continue(data, tmp_path):
    exps = str(tmp_path / "exps")
    assert cli.main(_argv(data, exps)) == 0
    (root,) = [r for r, _, f in os.walk(exps) if "timings.json" in f]
    with open(os.path.join(root, "timings.json")) as f:
        tm = json.load(f)
    assert tm["steps"] == 8 and tm["ms_per_step"] > 0
    assert np.isfinite(tm["val_metrics"]["val_psnr"])
    assert os.path.exists(os.path.join(root, "plots", "irrf_1.hdr"))
    with open(os.path.join(root, "scalars.tsv")) as f:
        assert any(ln.startswith("irf_loss\t0\t") for ln in f)
    conf = parse_file(CONF)
    for kv in _argv(data, exps)[12::2]:  # the --set values
        k, _, v = kv.partition("=")
        conf.put(k, _parse_value(v))
    r = IRRFTrainRunner(conf, exps_root=exps, is_continue=True, device="cpu",
                        max_epochs=2)
    assert r.exp.root == root and r.start_epoch == 2
    assert r.scheduler.last_epoch == 8  # the optimizer's steps so far
    r.run()
    assert sum(len(x) for x in r.epoch_losses) == 4  # epoch 2 only
