"""Port vs JAX: the baseline heads' runners and their CLI stages on the CPU.

On a JAX export of `make_scene(atlas_res=48)` (3 views at pano 32×64,
view002 held out as the novel view, a random irt.hdr):

  * two epochs of `BaselineHeadSynRunner` (InvRender and NeILF, their
    networks narrowed as in tests/test_material_heads.py, sample_light
    (8, 4)) from the JAX runner's initial parameters and with the JAX
    runner's own draws injected (`model.draw`): the losses of every step
    within rel 1e-3;
  * InvRender's evaluation (eval_spp 8) gives the JAX runner's metric
    keys, all finite;
  * `train --trainstage <name> --device cpu --max_epochs 1` through the
    port's CLI at the reference confs' full widths for one name of each
    head (MatInvSyn, Neilf, RecMLP): the runner's timings.json, a
    checkpoint and finite losses.
"""

import contextlib
import glob
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.data import hdrio as JH
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.geometry import load_obj as j_load_obj
from texir_code_tpu.models import fields as JF
from texir_code_tpu.models.material_heads import (
    InvRenderMaterialModel,
    NeILFMaterialModel,
)
from texir_code_tpu.train.heads import BaselineHeadSynRunner as JSyn
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.config import parse_file
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.geometry import load_obj
from texir_code_tpu_torch.models import material_heads as TH
from texir_code_tpu_torch.train.exp import draw_seed
from texir_code_tpu_torch.train.heads import BaselineHeadSynRunner as TSyn
from test_torch_heads import jax_draws

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (32, 64)
LIGHT = (8, 4)
ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = dict(brdf_encoder_dims=(64, 64), brdf_decoder_dims=(32,))


def _conf(name):
    return os.path.join(ROOT, "configs", "reference", f"{name}.conf")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("heads_export"))
    path = j_export(make_scene(atlas_res=48), out, n_views=3, pano_res=PANO)
    irt = np.random.default_rng(1).uniform(0.5, 2.0, (32, 32, 3)).astype(
        np.float32)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"), irt, flip=True)
    with open(os.path.join(out, "info", "novel.txt"), "w") as f:
        f.write("view002\n")
    return path


def _sets(path):
    return {"train.path_mesh_open3d": path,
            "train.pano_img_res": list(PANO),
            "train.sample_light": list(LIGHT)}


# head: (conf, the JAX head's class and network kwargs, the port's kwargs)
NARROW = {
    "invrender": ("syn_invrender", InvRenderMaterialModel,
                  dict(network=JF.EnvmapMaterialNetwork(**SMALL)),
                  dict(network_kw=SMALL)),
    "neilf": ("syn_neilf", NeILFMaterialModel,
              dict(brdf_network=JF.BRDFMLP(dims=(64,) * 8),
                   light_network=JF.NeILFMLP(dims=(64,) * 8)),
              dict(brdf_kw=dict(dims=(64,) * 8),
                   light_kw=dict(dims=(64,) * 8))),
}
_RUNS = {}


def runs(data, tmp_path_factory, head):
    """The JAX and the port Syn runners of `head` from the same initial
    parameters, each trained two epochs (the port with the JAX draws) and
    evaluated: (JAX losses, JAX metrics, port runner, port metrics)."""
    if head in _RUNS:
        return _RUNS[head]
    name, jcls, jkw, tkw = NARROW[head]
    tmp = tmp_path_factory.mktemp("head_runs")
    jconf = ConfigFactory.parse_file(_conf(name))
    tconf = parse_file(_conf(name))
    for k, v in _sets(data).items():
        jconf.put(k, v)
        tconf.put(k, v)
    hdr = data.replace("out1.obj", "hdr_texture.hdr")
    irt = data.replace("out1.obj", "irt.hdr")
    jm = jcls(j_load_obj(data), JH.read_hdr(hdr, flip=True),
              JH.read_hdr(irt, flip=True), pano_res=PANO, sample_light=LIGHT,
              **jkw)
    jr = JSyn(jconf, head, exps_root=str(tmp / "j"), max_epochs=2,
              eval_spp=8, model=jm)
    p0 = jax.tree_util.tree_map(np.asarray, jr.params)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jr._run_epochs(jr._train_indices(), "loss")
        jmetrics = jr.evaluate() if head == "invrender" else None
    jlosses = [float(x) for x in re.findall(r"loss = ([0-9.eE+-]+)",
                                            buf.getvalue())]

    tm = TH.HEADS[head](
        load_obj(data), hdrio.read_hdr(hdr, flip=True),
        hdrio.read_hdr(irt, flip=True), pano_res=PANO, sample_light=LIGHT,
        device="cpu", **tkw)
    tr = TSyn(tconf, head, exps_root=str(tmp / "t"), max_epochs=2,
              eval_spp=8, model=tm, device="cpu")
    tr.params.load_state_dict(convert.field_params_from_flax(p0, tr.params))

    def draw(seed, b):  # the JAX runner's key of global step seed - base
        key = jax.random.fold_in(jax.random.PRNGKey(666),
                                 seed - draw_seed(0))
        return jax_draws(head, key, b)

    tm.draw = draw
    tr._run_epochs(tr._train_indices(), "loss")
    del tm.draw  # the evaluation draws its own
    tmetrics = tr.evaluate() if head == "invrender" else None
    _RUNS[head] = (jlosses, jmetrics, tr, tmetrics)
    return _RUNS[head]


@pytest.mark.parametrize("head", sorted(NARROW))
def test_head_runner_two_epochs_follow_jax(data, tmp_path_factory, head):
    jlosses, _, tr, _ = runs(data, tmp_path_factory, head)
    assert tr.losses.shape == (2, 2) and len(jlosses) == 4
    np.testing.assert_allclose(tr.losses.reshape(-1), jlosses, rtol=1e-3)
    assert tr.losses[1].mean() < tr.losses[0].mean()  # it trains


def test_head_syn_runner_metric_keys_follow_jax(data, tmp_path_factory):
    _, jmetrics, _, tmetrics = runs(data, tmp_path_factory, "invrender")
    assert set(tmetrics) == set(jmetrics)
    assert {"rerender_psnr", "novel_psnr", "albedo_psnr_mapped",
            "roughness_psnr_mapped"} <= set(tmetrics)
    assert np.isfinite(list(tmetrics.values())).all()
    assert np.isfinite(list(jmetrics.values())).all()


@pytest.mark.parametrize("stage,conf,head", [
    ("MatInvSyn", "syn_invrender", "invrender"),
    ("Neilf", "syn_neilf", "neilf"),
    ("RecMLP", "syn_rec", "recmlp"),
])
def test_head_cli_end_to_end_cpu(data, tmp_path, stage, conf, head):
    exps = str(tmp_path / "exps")
    argv = ["train", "--conf", _conf(conf), "--trainstage", stage,
            "--device", "cpu", "--max_epochs", "1", "--exps_folder", exps]
    for k, v in _sets(data).items():
        argv += ["--set", f"{k}={v}"]
    assert cli.main(argv) == 0
    (path,) = glob.glob(os.path.join(exps, "*", "*", "timings.json"))
    syn = stage.endswith("Syn")
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == (
        TSyn.SYN_STAGE_NAMES[head] if syn
        else TSyn.STAGE_NAMES[head]) + "-default"
    with open(path) as f:
        tm = json.load(f)
    assert tm["steps"] == (2 if syn else 3) and np.isfinite(tm["last_loss"])
    if syn:
        assert np.isfinite(list(tm["metrics"].values())).all()
    ckpts = os.path.join(os.path.dirname(path), "checkpoints",
                         "ModelParameters")
    assert os.path.exists(os.path.join(ckpts, "LATEST"))
