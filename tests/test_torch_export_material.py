"""Port vs JAX: the material-rendered export — `data/export.py::
render_pano_material` and `export_reference_layout(gt_render="material")`.

The scene is the JAX tests' material-export apartment
(`make_apartment_scene(atlas_res=32, subdiv=2, clutter=0)`, one view at
16×32, tests/test_datasets.py's export sizes), with a random IrT atlas.
Both sides render with the JAX exporter's own GGX uniforms (its chunk's
`fold_in(PRNGKey(seed), 0)` key), injected into the port through
`samples=`.  The JAX side runs on the CPU, where its primary hits and its
specular rays go through its BVH traversal.

Tolerances: through the port's BVH (no cluster scene) every pixel within
rtol 1e-4 (atol 1e-5): the same traversal, the same shading.  Through the
culled walk (the route the exporter takes), the testers' rule (ROADMAP.md
queue C): all but one pixel in 1000 within rtol 1e-4 / atol 1e-5 and the
frame within relative L2 1e-4, since the walk's plane-dual barycentrics
round apart from the traversal's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from texir_code_tpu.data import export as JE
from texir_code_tpu.data.synthetic import make_apartment_scene as j_make
from texir_code_tpu.models.tbl import build_tbl as j_build_tbl
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.data import export as TE
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.synthetic import make_apartment_scene
from texir_code_tpu_torch.geometry.bvh import build_bvh
from texir_code_tpu_torch.ops.fan_raycast import FanScene
from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

torch.set_num_threads(2)  # six test workers share the host's cores

RES, SPP, SEED = (16, 32), 16, 3
SMALL = dict(atlas_res=32, subdiv=2, clutter=0)


@pytest.fixture(scope="module")
def render():
    """JAX's render of view 0, its uniforms, and the port's inputs."""
    jsyn = j_make(**SMALL)
    jt = j_build_tbl(jsyn.mesh, jsyn.hdr_texture)
    irt = np.random.default_rng(4).uniform(0.5, 2.0, (32, 32, 3)).astype(
        np.float32)
    cam = jsyn.camera_positions(1)[0]
    ref = JE.render_pano_material(jsyn.mesh, jt, irt, jsyn.gt_albedo,
                                  jsyn.gt_roughness, cam, RES, spp=SPP,
                                  seed=SEED)
    n = RES[0] * RES[1]  # one chunk, already a multiple of 128
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    samples = np.array(stratified_samples(key, n, SPP, "independent"))
    syn = make_apartment_scene(**SMALL)
    tt = convert.tbl_from_numpy(
        np.asarray(jt.uv_u), np.asarray(jt.uv_v),
        [np.asarray(p) for p in jt.planes], device="cpu",
        packed=np.asarray(jt.bvh.packed))
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    clusters = ClusterScene.from_fan(
        FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs()), lb=4,
        dense=True, device="cpu")
    return dict(ref=ref, samples=torch.from_numpy(samples), syn=syn, tt=tt,
                irt=irt, cam=cam, clusters=clusters)


def _port(r, **kw):
    syn = r["syn"]
    return TE.render_pano_material(syn.mesh, r["tt"], r["irt"],
                                   syn.gt_albedo, syn.gt_roughness, r["cam"],
                                   RES, spp=SPP, seed=SEED, **kw)


def test_render_pano_material_bvh_route_matches_jax(render):
    got = _port(render, samples=render["samples"])
    ref = render["ref"]
    assert got.shape == RES + (3,) and ref.mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_render_pano_material_walk_route_matches_jax(render):
    """The specular rays through the culled walk with per-ray origins
    (its plain version here), the exporter's route."""
    from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda

    before = dict(culled_walk_cuda.launches)
    got = _port(render, samples=render["samples"],
                cluster_scene=render["clusters"])
    assert culled_walk_cuda.launches == before  # CPU: the plain walk
    ref = render["ref"]
    ok = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert (~ok).sum() <= max(1, ok.size // 1000)
    assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)


def test_render_pano_material_draws_keyed_by_pixel(render):
    """The port's own draws depend on (seed, pixel id) only: chunking and
    a band of pixels change no value; another seed changes the photo."""
    full = _port(render)
    assert np.array_equal(_port(render, chunk=100), full)
    band = _port(render, pixels=(40, 200))
    assert np.array_equal(band, full.reshape(-1, 3)[40:200])
    syn = render["syn"]
    other = TE.render_pano_material(
        syn.mesh, render["tt"], render["irt"], syn.gt_albedo,
        syn.gt_roughness, render["cam"], RES, spp=SPP, seed=SEED + 1)
    assert not np.array_equal(other, full)
    np.testing.assert_allclose(other.mean(), full.mean(), rtol=0.2)


def test_export_layout_material_mode(tmp_path):
    """As the JAX package's tests/test_datasets.py::
    test_export_layout_material_mode: gt_irt.hdr is written and the
    material photos differ from plain radiance panos."""
    scene = make_apartment_scene(**SMALL)
    out = str(tmp_path / "mat_scan")
    path_mesh = TE.export_reference_layout(
        scene, out, n_views=1, pano_res=RES, gt_render="material",
        gt_spp=8, irt_spp=32, device="cpu")
    assert os.path.exists(path_mesh)
    irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "gt_irt.hdr"),
                         flip=True)
    assert irt.shape == (32, 32, 3) and (irt > 0).all()  # gutters padded
    col = hdrio.read_hdr(os.path.join(out, "hdr", "view000", "ccm.hdr"))
    assert col.shape == RES + (3,) and np.isfinite(col).all()
    tm = TE.export_reference_layout.timings
    assert tm["bake_s"] > 0 and len(tm["views_s"]) == 1
    rad_dir = str(tmp_path / "rad_scan")
    TE.export_reference_layout(scene, rad_dir, n_views=1, pano_res=RES,
                               device="cpu")
    rad = hdrio.read_hdr(os.path.join(rad_dir, "hdr", "view000", "ccm.hdr"))
    assert float(np.abs(col - rad).mean()) > 1e-3
    with pytest.raises(ValueError, match="gt_render"):
        TE.export_reference_layout(scene, rad_dir, gt_render="photo",
                                   device="cpu")
