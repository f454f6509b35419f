"""Port vs JAX: the editing, novel-view and relighting testers —
`eval/runners.py` (`expand_keyframes`, `parse_editing_conf`,
`MatEditingRunner`, `NovelViewRunner`, `RelightingRunner` in its emitter
mode), `eval/renderer.py` (`edited_params`, `relit_tbl`, `forward_relit`)
and `data/datasets.py::ImageCubeNovel`.

The data is the small synthetic scan of tests/test_torch_eval.py (the JAX
exporter's `make_scene(atlas_res=48)`, 2 views, pano 32×64) with random
IrT and optimized atlases (32²) in a Mat run's plots dir, plus the scene's
seg atlas written as `0_seg_gray.png` by the port's PNG writer.  Both
sides render at sample_light [32, 8] with the exact radiance fetch and
draw the JAX testers' own per-pixel uniforms (injected into the port
through `draw_spec_shift` and `draw_relit_shift`).  The JAX side traces
with its BVH traversal, the port with its culled walk: the same closest
hits, t/u/v apart by float rounding of two intersection formulas.
Tolerances: renders within rtol 1e-4 (atol 1e-5), as the error tester's,
on all but one pixel in 1000, and each frame within relative L2 1e-4.  The
exception is a pixel seen at a grazing angle whose specular sample at the
edited roughness 0.05 lands on an emitter's edge: there the two formulas'
barycentrics, 6e-8 apart, move the ray's radiance by 1.9e-5 (rel 8e-6),
and the estimator's weight turns that into 7e-5 on a pixel of 0.1 (frame 0
of the editing block, one of 1,536 pixels).  Keyframes, the edited
atlases, the relit TBL and the trajectory are bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.data.datasets import ImageCubeNovel as JNovel
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.eval import runners as JR
from texir_code_tpu_torch.config import parse_file
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.datasets import ImageCubeNovel as TNovel
from texir_code_tpu_torch.eval import runners as TR
from texir_code_tpu_torch.models.material import MaterialParams

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (32, 64)
CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "test_synthetic.conf")
EDITING = {
    "test.editing.classes": [1, 2],
    "test.editing.views": [0],
    "test.editing.frames_per_segment": 2,
    "test.editing.albedo_1": [[1.0, 0.0, 0.0], [0.0, 0.2, 1.0]],
    "test.editing.roughness_2": [0.05, 0.6, 0.3],
}


def _write_atlases(plots, rng):
    os.makedirs(plots, exist_ok=True)
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    hdrio.write_hdr(os.path.join(plots, "mat_albedo_final.hdr"), albedo)
    hdrio.write_hdr(os.path.join(plots, "mat_roughness_final.hdr"),
                    np.repeat(rough, 3, axis=-1))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A JAX-exported scan with its seg atlas, IrT and a Mat run's
    atlases; the JAX and port confs with the editing block."""
    root = tmp_path_factory.mktemp("testers")
    scene = make_scene(atlas_res=48)
    path = j_export(scene, str(root / "scan"), n_views=2, pano_res=PANO)
    hdrio.write_png(path.replace("out1.obj", "0_seg_gray.png"),
                    scene.seg_texture[::-1].astype(np.uint8))
    rng = np.random.default_rng(18)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32),
                    flip=True)
    exps = str(root / "exps")
    _write_atlases(os.path.join(exps, "Mat-default", "2026_01_02_00_00_00",
                                "plots"), rng)
    sets = {"train.path_mesh_open3d": path,
            "train.pano_img_res": list(PANO),
            "train.sample_light": [32, 8],
            "models.render.specular_fetch": "exact", **EDITING}
    jconf, tconf = ConfigFactory.parse_file(CONF), parse_file(CONF)
    for k, v in sets.items():
        jconf.put(k, v)
        tconf.put(k, v)
    return dict(path=path, exps=exps, jconf=jconf, tconf=tconf, scene=scene)


def _jax_uniforms(key, n, b):
    """[b, n] uniforms of a JAX tester render with `key`: the pixel id
    folded into the key (models/material.py, eval/renderer.py:164-167)."""
    rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(b, dtype=jnp.int32))
    return torch.tensor(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, (n,)))(rows)))


def _runners(data, cls_j, cls_t):
    """A JAX tester and its port, the port drawing the JAX uniforms: the
    port's draw seed (SEED << 24) + n is the JAX key fold_in(key, n)."""
    jr = cls_j(data["jconf"], exps_root=data["exps"])
    tr = cls_t(data["tconf"], exps_root=data["exps"], device="cpu")

    def key_of(seed):
        return jax.random.fold_in(jr.key, seed - TR._TesterBase.draw_seed(0))

    tr.model.draw_spec_shift = lambda seed, b: _jax_uniforms(key_of(seed), 2, b)
    tr.model.draw_relit_shift = lambda seed, b: _jax_uniforms(key_of(seed), 4, b)
    return jr, tr


def _close(a, b, what):
    """Each port frame against the JAX one: every pixel within rtol 1e-4,
    atol 1e-5, but at most one pixel in 1000 (see the module docstring),
    and the frame within relative L2 1e-4."""
    assert len(a) == len(b), what
    for k, (x, y) in enumerate(zip(a, b)):
        x = np.asarray(x)
        off = (np.abs(y - x) > 1e-5 + 1e-4 * np.abs(x)).any(-1)
        rel = np.linalg.norm(y - x) / np.linalg.norm(x)
        assert off.sum() <= 1e-3 * off.size, (what, k, off.sum())
        assert rel <= 1e-4, (what, k, rel)


@pytest.mark.parametrize("kfs,fps", [
    ([[1.0, 0.0, 0.0], [0.0, 0.2, 1.0]], 2),
    ([[0.05], [0.6], [0.3]], 3),
    ([[0.5, 0.5, 0.5]], 4),
])
def test_expand_keyframes_matches_jax(kfs, fps):
    a = JR.expand_keyframes(kfs, fps)
    b = TR.expand_keyframes(kfs, fps)
    assert len(a) == len(b) == 1 + (len(kfs) - 1) * fps
    for x, y in zip(a, b):
        assert y.dtype == np.float32 and np.array_equal(x, y)


def test_parse_editing_conf_matches_jax(data):
    a = JR.parse_editing_conf(data["jconf"])
    b = TR.parse_editing_conf(data["tconf"])
    assert a == b
    assert b[0] == {1: {"albedo": EDITING["test.editing.albedo_1"]},
                    2: {"roughness": [[0.05], [0.6], [0.3]]}}
    assert b[1:] == ([0], 2)
    assert TR.parse_editing_conf(parse_file(CONF)) is None


def test_image_cube_novel_matches_jax(data):
    kw = dict(resolution=PANO, start_index=1, num=5)
    a, b = JNovel(data["path"], **kw), TNovel(data["path"], **kw)
    assert len(a) == len(b) == 5
    for i in range(5):
        x, y = a[i], b[i]
        assert np.array_equal(x["cam_position"], y["cam_position"])
        np.testing.assert_allclose(y["cam_to_world"], x["cam_to_world"],
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def editing(data):
    return _runners(data, JR.MatEditingRunner, TR.MatEditingRunner)


def test_edited_params_match_jax(editing):
    """The texture-space seg edits at both atlas resolutions, bit-equal:
    the seg atlas (48²) resampled to the 32² atlases."""
    jr, tr = editing
    edits = {1: {"albedo": (0.9, 0.1, 0.3)},
             2: {"roughness": np.asarray([0.25], np.float32)},
             4: {"albedo": [0.0, 1.0, 0.0], "roughness": [0.7]}}
    a = jr.model.edited_params(jr.params, edits)
    b = tr.model.edited_params(tr.params, edits)
    assert np.array_equal(np.asarray(a.albedo), b.albedo.numpy())
    assert np.array_equal(np.asarray(a.roughness), b.roughness.numpy())
    assert not np.array_equal(b.albedo.numpy(), tr.params.albedo.numpy())
    assert np.array_equal(np.asarray(jr.model._seg_mask_for(32)),
                          tr.model._seg_mask_for(32).numpy())


def test_editing_frames_match_jax(editing):
    """`run_from_conf` over the conf's editing block: 1 + 2·2 frames of
    view 0, each with its own draw, against the JAX tester's."""
    jr, tr = editing
    a = jr.run_from_conf()
    b = tr.run_from_conf()
    assert len(b) == 5
    _close(a, b, "editing")
    assert np.abs(b[0] - b[2]).max() > 1e-4  # the edits change the render
    assert os.path.exists(os.path.join(tr.exp.plots_dir, "edit_004_v0.hdr"))


def test_unedited_editing_frame_equals_error_render(data, editing):
    """An unedited Editing frame (draw seed 0) is the Error tester's render
    of the same view, bit for bit."""
    _, tr = editing
    (frame,) = tr.run(edits={}, num_frames=1, views=[1])
    err = TR.MatErrorRunner(data["tconf"], exps_root=data["exps"],
                            device="cpu")
    err.model.draw_spec_shift = tr.model.draw_spec_shift
    ref = err._render(err._default_dataset()[1])["rgb"].numpy()
    assert np.array_equal(frame, ref)


def test_novel_view_frames_match_jax(data):
    jr, tr = _runners(data, JR.NovelViewRunner, TR.NovelViewRunner)
    a = jr.run(num=3)
    b = tr.run(num=3)
    assert len(b) == 3 and b[0].shape == (6, 16, 16, 3)
    _close(a, b, "novel view")
    assert os.path.exists(os.path.join(tr.exp.plots_dir, "novel_002.hdr"))


@pytest.fixture(scope="module")
def relighting(data):
    return _runners(data, JR.RelightingRunner, TR.RelightingRunner)


def test_relit_tbl_matches_jax(relighting):
    jr, tr = relighting
    a = np.asarray(jr.model.relit_tbl((0.2, 0.4, 1.0)).texture)
    b = torch.stack(tr.model.relit_tbl((0.2, 0.4, 1.0)).planes, -1).numpy()
    assert np.array_equal(a, b)
    base = torch.stack(tr.model.tbl.planes, -1).numpy()
    assert 0 < (b != base).any(-1).sum() < b.shape[0] * b.shape[1]


def test_relighting_frames_match_jax(relighting):
    """Emitter relighting of both views: live MC diffuse (32 rays a pixel)
    over the relit TBL plus the specular trace, against the JAX tester."""
    jr, tr = relighting
    a = jr.run(mode="emitter")
    b = tr.run(mode="emitter")
    assert len(b) == 2
    _close(a, b, "relighting")
    assert np.abs(b[0]).max() > 0
    assert os.path.exists(os.path.join(tr.exp.plots_dir, "relit_001.hdr"))


def test_forward_relit_chunks_match(relighting):
    """forward_relit in pixel chunks of 1000 (the last one padded) equals
    the one-chunk render; the material fetches equal the stage-2 render's."""
    _, tr = relighting
    item = tr._default_dataset()[0]
    args = (tr.params, item["cam_to_world"], item["cam_position"])
    with torch.no_grad():
        one = tr.model.forward_relit(*args, seed=tr.draw_seed(5))
        tr.model.shade_chunk = 1000
        try:
            chunked = tr.model.forward_relit(*args, seed=tr.draw_seed(5))
        finally:
            tr.model.shade_chunk = 4096
        stage2 = tr._render(item)
    np.testing.assert_allclose(chunked["rgb"].numpy(), one["rgb"].numpy(),
                               rtol=1e-6, atol=1e-7)
    for k in ("albedo", "roughness", "normal", "empty_mask"):
        assert torch.equal(one[k], stage2[k]), k


def test_edited_params_needs_seg_atlas(editing):
    _, tr = editing
    seg = tr.model.seg_texture
    tr.model.seg_texture = None
    try:
        with pytest.raises(ValueError, match="no seg texture"):
            tr.model.edited_params(tr.params, {1: {"albedo": (1, 0, 0)}})
    finally:
        tr.model.seg_texture = seg
    assert isinstance(tr.params, MaterialParams)
