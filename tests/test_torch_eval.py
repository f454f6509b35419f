"""Port vs JAX: the re-render error tester — `eval/renderer.py`
(`load_optimized_materials`, `EvalMaterialModel` with pixel-chunked
shading) and `eval/runners.py::MatErrorRunner` — and the port CLI's
`test` command in its four stages (the editing, novel-view and
relighting testers are held to JAX's in tests/test_torch_testers.py).

The data is a small synthetic scan the JAX exporter writes
(`make_scene(atlas_res=48)`, 2 views, pano 32×64) with random IrT and
optimized atlases (32²) in a Mat run's plots dir.  Both testers render
at sample_light [32, 8] with shade_chunk 4096 (one chunk) or 1000 (two,
the second padded), fetch radiance exactly (`models.render.specular_fetch
= "exact"`, the JAX CPU path) and draw the JAX tester's own per-pixel
uniforms (injected into the port through `draw_spec_shift`).  The JAX side
traces with its BVH traversal, the port with its culled walk: the same
closest hits, t/u/v apart by float rounding of two intersection formulas.
Tolerances: the stage-2 render within rtol 1e-4 (atol 1e-5), the metrics
within 1e-4 relative; atlases load bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.data import hdrio as j_hdrio
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.eval import renderer as JR
from texir_code_tpu.eval.runners import MatErrorRunner as JRunner
from texir_code_tpu_torch import cli
from texir_code_tpu_torch.config import parse_file
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.eval import renderer as TR
from texir_code_tpu_torch.eval.runners import MatErrorRunner as TRunner

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (32, 64)
CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "test_synthetic.conf")


def _write_atlases(plots, rng, tag="final"):
    os.makedirs(plots, exist_ok=True)
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    hdrio.write_hdr(os.path.join(plots, f"mat_albedo_{tag}.hdr"), albedo)
    hdrio.write_hdr(os.path.join(plots, f"mat_roughness_{tag}.hdr"),
                    np.repeat(rough, 3, axis=-1))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A JAX-exported scan, its IrT, and a Mat run's optimized atlases."""
    root = tmp_path_factory.mktemp("eval")
    path = j_export(make_scene(atlas_res=48), str(root / "scan"), n_views=2,
                    pano_res=PANO)
    rng = np.random.default_rng(8)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32),
                    flip=True)
    exps = str(root / "exps")
    # an older dump and the newest one: the testers read the newest
    _write_atlases(os.path.join(exps, "Mat-default", "2026_01_01_00_00_00",
                                "plots"), rng, "0001")
    _write_atlases(os.path.join(exps, "Mat-default", "2026_01_02_00_00_00",
                                "plots"), rng, "0001")
    _write_atlases(os.path.join(exps, "Mat-default", "2026_01_02_00_00_00",
                                "plots"), rng, "final")
    sets = {"train.path_mesh_open3d": path,
            "train.pano_img_res": list(PANO),
            "train.sample_light": [32, 8],
            "models.render.specular_fetch": "exact"}
    jconf, tconf = ConfigFactory.parse_file(CONF), parse_file(CONF)
    for k, v in sets.items():
        jconf.put(k, v)
        tconf.put(k, v)
    return dict(path=path, exps=exps, jconf=jconf, tconf=tconf,
                plots=os.path.join(exps, "Mat-default", "2026_01_02_00_00_00",
                                   "plots"))


@pytest.fixture(scope="module")
def testers(data):
    jr = JRunner(data["jconf"], exps_root=data["exps"])
    tr = TRunner(data["tconf"], exps_root=data["exps"], device="cpu")
    key = jax.random.fold_in(jr.key, 0)  # the JAX tester's render key

    def jax_draw(seed, b):
        assert seed == TRunner.draw_seed(0)
        rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(b, dtype=jnp.int32))
        return torch.tensor(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, (2,)))(rows)))

    tr.model.draw_spec_shift = jax_draw
    return dict(jax=jr, port=tr, key=key)


def test_load_optimized_materials_matches_jax(data):
    a = JR.load_optimized_materials(data["plots"])
    b = TR.load_optimized_materials(data["plots"], device="cpu")
    assert np.array_equal(np.asarray(a.albedo), b.albedo.numpy())
    assert np.array_equal(np.asarray(a.roughness), b.roughness.numpy())
    assert b.roughness.shape == (32, 32, 1)
    # the newest dump of the run: "final" sorts after "0001"
    want = hdrio.read_hdr(os.path.join(data["plots"], "mat_albedo_final.hdr"))
    assert np.array_equal(b.albedo.numpy(), want)


@pytest.mark.parametrize("chunk", [4096, 1000])
def test_eval_model_stage2_forward_matches_jax(testers, chunk):
    """EvalMaterialModel's stage-2 render of view 0 (6 faces of 16² =
    1,536 pixels) in pixel chunks, against the JAX eval model's."""
    jr, tr = testers["jax"], testers["port"]
    item = jr._default_dataset()[0]
    ref = jr._render(item)
    assert jr.model.shade_chunk == 4096
    assert isinstance(tr.model, TR.EvalMaterialModel)
    assert tr.model.shade_chunk == 4096 and tr.model.occluders is not None
    tr.model.shade_chunk = chunk
    try:
        out = tr._render(item)
    finally:
        tr.model.shade_chunk = 4096
    for k in ("rgb", "albedo", "roughness", "normal", "empty_mask"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert np.asarray(ref["rgb"]).max() > 0


def test_error_runner_metrics_match_jax(testers, capsys):
    a = testers["jax"].run()
    b = testers["port"].run()
    assert set(b) == {"mse", "psnr", "ssim"}
    for k in a:
        assert np.isfinite(b[k])
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=k)
    assert "re-rendering error:" in capsys.readouterr().out


def test_cli_test_error_end_to_end_cpu(tmp_path, capsys):
    """`demo`, then `test --teststage Error --device cpu` through the
    port's CLI on the demo scan and the newest atlases of a Mat run."""
    out = str(tmp_path / "demo")
    assert cli.main(["demo", "--out", out, "--views", "2", "--atlas_res",
                     "48", "--device", "cpu"]) == 0
    path = os.path.join(out, "mesh", "out1.obj")
    rng = np.random.default_rng(9)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32),
                    flip=True)
    exps = str(tmp_path / "exps")
    _write_atlases(os.path.join(exps, "Mat-demo", "2026_01_02_00_00_00",
                                "plots"), rng)
    capsys.readouterr()
    assert cli.main([
        "test", "--conf", CONF, "--teststage", "Error", "--expname", "demo",
        "--exps_folder", exps, "--device", "cpu",
        "--set", f"train.path_mesh_open3d={path}",
        "--set", f"train.pano_img_res=[{PANO[0]}, {PANO[1]}]",
        "--set", "train.sample_light=[32, 4]",
    ]) == 0
    text = capsys.readouterr().out
    line = [ln for ln in text.splitlines() if ln.startswith("re-rendering")]
    assert len(line) == 1 and "nan" not in line[0]
    assert os.path.isdir(os.path.join(exps, "Error-demo"))


@pytest.fixture(scope="module")
def cli_scan(tmp_path_factory):
    """The port CLI's demo scan with an IrT, the scene's seg atlas and a
    Mat run's atlases: the argv prefix of a `test` command on it."""
    from texir_code_tpu_torch.data.synthetic import make_scene as t_scene

    root = tmp_path_factory.mktemp("cli_testers")
    out = str(root / "demo")
    assert cli.main(["demo", "--out", out, "--views", "2", "--atlas_res",
                     "48", "--device", "cpu"]) == 0
    path = os.path.join(out, "mesh", "out1.obj")
    rng = np.random.default_rng(19)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32),
                    flip=True)
    hdrio.write_png(path.replace("out1.obj", "0_seg_gray.png"),
                    t_scene(atlas_res=48).seg_texture[::-1].astype(np.uint8))
    exps = str(root / "exps")
    _write_atlases(os.path.join(exps, "Mat-demo", "2026_01_02_00_00_00",
                                "plots"), rng)
    argv = ["test", "--conf", CONF, "--expname", "demo", "--exps_folder",
            exps, "--device", "cpu",
            "--set", f"train.path_mesh_open3d={path}",
            "--set", f"train.pano_img_res=[{PANO[0]}, {PANO[1]}]",
            "--set", "train.sample_light=[16, 4]"]
    return argv, exps


def _hdr_outputs(exps, stage):
    (run,) = os.listdir(os.path.join(exps, f"{stage}-demo"))
    plots = os.path.join(exps, f"{stage}-demo", run, "plots")
    return {f: hdrio.read_hdr(os.path.join(plots, f))
            for f in sorted(os.listdir(plots)) if f.endswith(".hdr")}


@pytest.mark.parametrize("stage,extra,files", [
    ("View", ["--num_frames", "2"], ["novel_000.hdr", "novel_001.hdr"]),
    ("Editing", ["--set", "test.editing.classes=[1, 2]",
                 "--set", "test.editing.views=[1]",
                 "--set", "test.editing.frames_per_segment=2",
                 "--set", "test.editing.albedo_1=[[1.0, 0.0, 0.0], "
                          "[0.0, 0.0, 1.0]]",
                 "--set", "test.editing.roughness_2=[0.05, 0.5]"],
     ["edit_000_v1.hdr", "edit_001_v1.hdr", "edit_002_v1.hdr"]),
    ("Relighting", ["--relight_mode", "emitter"],
     ["relit_000.hdr", "relit_001.hdr"]),
])
def test_cli_testers_end_to_end_cpu(cli_scan, stage, extra, files):
    """`test --teststage Editing | View | Relighting --device cpu` through
    the port's CLI on the demo scan: each writes its frames (6 faces of
    16² side by side; an editing frame stacks the render over the GT),
    finite and not black."""
    argv, exps = cli_scan
    assert cli.main(argv + ["--teststage", stage] + extra) == 0
    out = _hdr_outputs(exps, stage)
    assert sorted(out) == files
    rows = 32 if stage == "Editing" else 16
    for name, img in out.items():
        assert img.shape == (rows, 96, 3), name
        assert np.isfinite(img).all() and img.max() > 0, name


def test_jax_hdr_reader_reads_port_atlases(data):
    """The atlases this test writes with the port's .hdr writer read back
    the same through the JAX package's reader (the testers' shared
    input)."""
    name = os.path.join(data["plots"], "mat_roughness_final.hdr")
    assert np.array_equal(j_hdrio.read_hdr(name), hdrio.read_hdr(name))
