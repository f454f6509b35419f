"""Port vs JAX: the MatSyn stage — `train/material_syn.py` (`scale_compute`,
`postprocessing_materials`, `MatTrainSynRunner.evaluate_materials`), the
Mat runner's training-view filter (`_train_indices`, which keeps
info/novel.txt's views out of training), and `train --trainstage MatSyn`
through the port's CLI on the CPU.

evaluate_materials runs on both sides on the same optimized atlases
(random, at other resolutions than the GT and than each other, so both
resample), the same GT atlases and the same emitter atlas file; metrics
within relative 1e-5.  (The GT atlases share a resolution: the emitter
mask of both packages' postprocessing is taken at the albedo's.)
"""

import os
import types

import numpy as np
import pytest
import torch

from texir_code_tpu.config import Config as JConfig
from texir_code_tpu.data.datasets import ImageCubeSyn as JSynData
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_apartment_scene as j_make
from texir_code_tpu.train import material_syn as JM
from texir_code_tpu_torch import cli
from texir_code_tpu_torch.config import Config as TConfig
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.datasets import ImageCubeSyn as TSynData
from texir_code_tpu_torch.data.export import export_reference_layout
from texir_code_tpu_torch.data.synthetic import make_apartment_scene
from texir_code_tpu_torch.train import material_syn as TM

torch.set_num_threads(2)  # six test workers share the host's cores

SMALL = dict(atlas_res=32, subdiv=2, clutter=0)
CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mat_synthetic.conf")


def test_scale_compute_and_postprocessing_match_jax():
    rng = np.random.default_rng(11)
    gt = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    pred = (gt * 0.7 + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    s = TM.scale_compute(gt, pred)
    assert s == pytest.approx(JM.scale_compute(gt, pred), rel=1e-12)
    assert 1.2 < s < 1.6
    assert TM.scale_compute(gt, np.zeros_like(gt)) == 1.0
    gt_r = rng.uniform(0, 1, (16, 16, 1)).astype(np.float32)
    r = rng.uniform(0, 1, (16, 16, 1)).astype(np.float32)
    mask = (rng.uniform(0, 1, (16, 16)) > 0.8).astype(np.float32)
    got = TM.postprocessing_materials(pred, r, gt, gt_r, mask)
    ref = JM.postprocessing_materials(pred, r, gt, gt_r, mask)
    for a, b in zip(got, ref):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(got[0][mask > 0], gt[mask > 0])


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A JAX-exported scan (2 views, the second held out) of the small
    apartment."""
    root = str(tmp_path_factory.mktemp("matsyn") / "scan")
    path = j_export(j_make(**SMALL), root, n_views=3, pano_res=(16, 32))
    with open(os.path.join(root, "info", "novel.txt"), "w") as f:
        f.write("view001\n")
    return path


def _stub(cls, conf, params, dataset, mesh, **extra):
    """A runner object with only the state evaluate_materials reads."""
    r = object.__new__(cls)
    r.conf, r.params, r.dataset = conf, params, dataset
    r.model = types.SimpleNamespace(mesh=mesh)
    r._valid_cache = {}
    for k, v in extra.items():
        setattr(r, k, v)
    return r


def test_evaluate_materials_matches_jax(scan):
    jsyn, tsyn = j_make(**SMALL), make_apartment_scene(**SMALL)
    gt_a = tsyn.gt_albedo.astype(np.float32)
    gt_r = tsyn.gt_roughness.astype(np.float32)
    # a trained atlas's likeness: the GT, upsampled, scaled and noisy
    rng = np.random.default_rng(12)
    up = np.arange(48) * 32 // 48
    albedo = (gt_a[up][:, up] * 0.85
              + rng.normal(0, 0.03, (48, 48, 3))).astype(np.float32)
    up = np.arange(96) // 3
    rough = np.clip(gt_r[up][:, up] + rng.normal(0, 0.05, (96, 96, 1)),
                    0.01, 0.8).astype(np.float32)
    data = types.SimpleNamespace(gt_albedo=gt_a, gt_roughness=gt_r)
    conf = {"train": {"path_mesh_open3d": scan}}
    j = _stub(JM.MatTrainSynRunner, JConfig(conf),
              types.SimpleNamespace(albedo=albedo, roughness=rough), data,
              jsyn.mesh)
    t = _stub(TM.MatTrainSynRunner, TConfig(conf),
              types.SimpleNamespace(albedo=torch.from_numpy(albedo),
                                    roughness=torch.from_numpy(rough)),
              data, tsyn.mesh, device=torch.device("cpu"))
    ref = j.evaluate_materials()
    got = t.evaluate_materials()
    assert sorted(got) == sorted(ref)
    assert "roughness_psnr_mapped" in got and 0 < got["mapped_fraction"] < 1
    assert sorted(t._valid_cache) == [32]
    for k in ref:
        assert got[k] == pytest.approx(float(ref[k]), rel=1e-5), k


def test_training_view_filter_matches_jax(scan):
    """The held-out view stays out of training on both sides; a dataset
    without a novel split trains on every view."""
    jd = JSynData(scan, resolution=(16, 32))
    td = TSynData(scan, resolution=(16, 32))
    assert td.novel_ids == jd.novel_ids == ["view001"]
    j = object.__new__(JM.MatTrainSynRunner)
    j.dataset = jd
    t = object.__new__(TM.MatTrainSynRunner)
    t.dataset = td
    assert t._train_indices() == j._train_indices() == [0, 2]
    t.dataset = ["a", "b"]  # no train_ids: every view
    assert t._train_indices() == [0, 1]


def test_cli_matsyn_end_to_end_cpu(tmp_path, capsys):
    """export (material photos) → `train --trainstage MatSyn --max_epochs 1
    --device cpu` at 32² atlases: the metrics land in timings.json, the
    novel view is scored and never trained on."""
    import glob
    import json

    scene = make_apartment_scene(**SMALL)
    root = str(tmp_path / "scan")
    path = export_reference_layout(scene, root, n_views=3, pano_res=(32, 64),
                                   gt_render="material", gt_spp=8,
                                   irt_spp=32, device="cpu")
    with open(os.path.join(root, "info", "novel.txt"), "w") as f:
        f.write("view002\n")
    irt = hdrio.read_hdr(path.replace("out1.obj", "gt_irt.hdr"), flip=True)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"), irt, flip=True)
    exps = str(tmp_path / "exps")
    capsys.readouterr()
    assert cli.main([
        "train", "--conf", CONF, "--trainstage", "MatSyn", "--max_epochs",
        "1", "--device", "cpu", "--exps_folder", exps,
        "--set", f"train.path_mesh_open3d={path}",
        "--set", "train.pano_img_res=[32, 64]",
        "--set", "train.mat_albedo_res=32",
        "--set", "train.mat_roughness_res=32",
        "--set", "train.sample_light=[32, 4]",
        "--set", "train.plot_freq=0",
    ]) == 0
    out = capsys.readouterr().out
    steps = [ln for ln in out.splitlines() if "batch cost time" in ln]
    assert len(steps) == 3 * 2  # 3 substages × the 2 training views
    assert not any("id = view002" in ln for ln in steps)
    (tpath,) = glob.glob(os.path.join(exps, "Mat-default", "*",
                                      "timings.json"))
    with open(tpath) as f:
        tm = json.load(f)
    mm, nm = tm["material_metrics"], tm["novel_metrics"]
    assert set(nm) == {"novel_mse", "novel_psnr", "novel_ssim"}
    vals = [mm[k] for k in ("albedo_psnr_mapped", "roughness_psnr_mapped",
                            "albedo_psnr", "roughness_ssim")]
    assert np.isfinite(vals + list(nm.values())).all()
    assert 0 < mm["mapped_fraction"] < 1
    assert tm["evaluate_materials_s"] > 0


def test_cli_matsyn_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the stage would run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--conf", CONF, "--trainstage", "MatSyn",
                  "--exps_folder", str(tmp_path)])
