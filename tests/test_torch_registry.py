"""The port's class registry, the CLI's leftovers, the small data pieces and
the building's quality script, on the CPU.

  * `registry.py`: every alias of the JAX registry names the port
    counterpart of the JAX target (the same module path and class under
    texir_code_tpu_torch); every conf in configs/ and configs/reference/
    resolves through the port's registry to a port class of the JAX class's
    name;
  * the CLI: `--debug_nans` (train and test) runs the stage under torch's
    anomaly detection and leaves it off after; TEXIR_PRINT_MEMORY prints
    nothing for a CPU stage (the JAX CLI prints only where its device keeps
    memory statistics);
  * `scripts/building_quality.py` end to end on a tiny building (rooms
    (2, 2), subdiv 3, pano 32×64, IRRF 2 epochs, IrrT 16², MatSyn 1 epoch):
    the mode-2 seg prior sees more than one room, and the summary's metrics
    are finite;
  * `data/datasets.py::ImageDerived` on that export (its LDR panos written
    as JPEG, as the JAX exporter writes them) item by item equal to the JAX
    class's; `data/hdrio.py::plot_gbuffer` equal to the JAX dump.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from texir_code_tpu import registry as JR
from texir_code_tpu.config import ConfigFactory
from texir_code_tpu_torch import cli
from texir_code_tpu_torch import registry as TR

torch.set_num_threads(2)  # six test workers share the host's cores

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.conf"))
               + glob.glob(os.path.join(ROOT, "configs", "reference",
                                        "*.conf")))
CLASS_KEYS = ("dataset_class", "model_class", "irf_loss_class")


def test_aliases_name_the_port_counterparts():
    assert set(TR._ALIASES) == set(JR._ALIASES)
    for name, target in JR._ALIASES.items():
        assert target.startswith("texir_code_tpu.")
        assert TR._ALIASES[name] == target.replace(
            "texir_code_tpu.", "texir_code_tpu_torch.", 1), name


@pytest.mark.parametrize("path", CONFS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_conf_resolves_to_port_class(path):
    conf = ConfigFactory.parse_file(path)
    block = "train" if conf.get("train", default=None) else "test"
    for key in CLASS_KEYS:
        dotted = conf.get_string(f"{block}.{key}")
        ours, theirs = TR.get_class(dotted), JR.get_class(dotted)
        assert callable(ours), (dotted, ours)
        assert ours.__module__.startswith("texir_code_tpu_torch."), dotted
        assert ours.__name__ == theirs.__name__, dotted
        assert (ours.__module__.replace("texir_code_tpu_torch.", "")
                == theirs.__module__.replace("texir_code_tpu.", "")), dotted


def test_conf_set_is_whole():
    assert len(CONFS) >= 17  # 3 synthetic + 14 reference-parity


def test_register_and_dotted_paths():
    obj = object()
    assert TR.register("a_short_name", obj) is obj
    assert TR.get_class("a_short_name") is obj
    from texir_code_tpu_torch.models.material_mlp import MaterialMLP

    assert TR.get_class(
        "texir_code_tpu_torch.models.material_mlp.MaterialMLP") is MaterialMLP
    with pytest.raises(ImportError):
        TR.get_class("NoDots")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("command", ["train", "test"])
@pytest.mark.parametrize("flag", [True, False], ids=["debug_nans", "plain"])
def test_debug_nans_runs_the_stage_under_anomaly_detection(
        monkeypatch, capsys, command, flag):
    seen = []
    stages = cli.TRAIN_STAGES if command == "train" else cli.TEST_STAGES
    monkeypatch.setitem(stages, "Probe",
                        lambda conf, args: seen.append(
                            torch.is_anomaly_enabled()))
    monkeypatch.setenv("TEXIR_PRINT_MEMORY", "1")
    stage_flag = "--trainstage" if command == "train" else "--teststage"
    argv = [command, "--conf", os.path.join(ROOT, "configs",
                                            "mat_synthetic.conf"),
            stage_flag, "Probe", "--device", "cpu"]
    assert cli.main(argv + (["--debug_nans"] if flag else [])) == 0
    assert seen == [flag]
    assert not torch.is_anomaly_enabled()
    assert "memory high-water" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the building's quality script, tiny
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def building_run(tmp_path_factory):
    from texir_code_tpu_torch.scripts import building_quality as bq

    out = tmp_path_factory.mktemp("bq")
    tiny = bq.Recipe(
        scene_kw=dict(atlas_res=32, subdiv=3, clutter_per_room=1),
        rooms=(2, 2), pano_res=(32, 64), gt_spp=8, irt_spp=32, irt_res=16,
        irrf_sets=("train.samples_point_mesh=32", "train.env_res=[4,8]",
                   "val.env_res=[16,32]", "train.val_sample_res=[4,8]"),
        irrt_sets=bq.Recipe().irrt_sets + ("train.sample_light=[256,16]",
                                           "train.texel_batch=256"),
        mat_sets=("train.pano_img_res=[32,64]", "train.mat_albedo_res=32",
                  "train.mat_roughness_res=32", "train.sample_light=[8,4]"))
    summary = out / "summary.json"
    old = bq.ROOT, os.environ.get("OMP_NUM_THREADS")
    bq.ROOT = ROOT  # the stages read configs/ from the checkout's root
    os.environ["OMP_NUM_THREADS"] = "2"  # each stage's process, as this one
    try:
        assert bq.main(["--irrf-epochs", "1", "--mat-epochs", "1",
                        "--device", "cpu", "--data", str(out / "data"),
                        "--exps", str(out / "exps"),
                        "--summary", str(summary)], recipe=tiny) == 0
    finally:
        bq.ROOT = old[0]
        if old[1] is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old[1]
    with open(summary) as f:
        return str(out / "data"), json.load(f)


def test_building_script_runs_the_recipe(building_run):
    data, s = building_run
    assert s["n_rooms"] == 5  # 4 rooms and the outside (id 0)
    for k in ("rerender_psnr", "novel_psnr", "albedo_psnr_mapped",
              "roughness_psnr_mapped", "irrf_val_psnr"):
        assert np.isfinite(s[k]) and s[k] > 0, k
    assert set(s["seconds"]) == {"export", "IRRF", "IrrT", "MatSyn"}
    assert set(s["peak_mib"].values()) == {None}  # the CPU keeps none
    assert all(np.isfinite(v) for v in s["mat_step_ms"].values())
    with open(os.path.join(data, "info", "novel.txt")) as f:
        assert f.read().strip() == "view004"


def test_image_derived_matches_jax(building_run):
    """On the export, with its LDR panos as JPEG (the JAX exporter's
    format; the JAX class reads it with OpenCV, the port only its size)."""
    import cv2

    from texir_code_tpu.data.datasets import ImageDerived as JImageDerived
    from texir_code_tpu_torch.data import hdrio
    from texir_code_tpu_torch.data.datasets import ImageDerived

    data, _ = building_run
    for png in glob.glob(os.path.join(data, "derived", "*",
                                      "panoImage_orig.png")):
        img = (hdrio.read_image(png)[..., :3] * 255).round().astype(np.uint8)
        assert cv2.imwrite(png.replace(".png", ".jpg"), img[..., ::-1])
    path_mesh = os.path.join(data, "mesh", "out1.obj")
    for exposure in (0.0, 5.0):
        ours = ImageDerived(path_mesh, hdr_exposure=exposure)
        theirs = JImageDerived(path_mesh, hdr_exposure=exposure)
        assert len(ours) == len(theirs) == 5
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert set(a) == set(b)
            assert a["id"] == b["id"]
            for k in ("color", "mask", "cam_to_world", "cam_position"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["mask"].shape == (32, 64, 1) and a["mask"].min() == 1


def test_plot_gbuffer_matches_jax(tmp_path):
    from texir_code_tpu.data import hdrio as jio
    from texir_code_tpu_torch.data import hdrio

    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 5, (8, 16, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (8, 16, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    hdrio.plot_gbuffer(str(tmp_path / "ours.hdr"), pos, nrm)
    jio.plot_gbuffer(str(tmp_path / "theirs.hdr"), pos, nrm)
    ours = hdrio.read_hdr(str(tmp_path / "ours.hdr"))
    assert ours.shape == (16, 16, 3)
    np.testing.assert_array_equal(ours,
                                  hdrio.read_hdr(str(tmp_path / "theirs.hdr")))
