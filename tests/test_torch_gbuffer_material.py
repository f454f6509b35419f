"""Port vs JAX: the cube-face G-buffer, the MaterialModel forward pass in
stages -1/0/1/2, the Mat loss with its albedo/roughness gradients, and the
Adam + clamp update, on `make_scene(atlas_res=48)` at pano 32×64 (cube
faces of 16²) with 32² atlases.

The JAX side runs its CPU path: primary and specular rays through its BVH
traversal, radiance by exact bilinear fetch.  The port traces the same
rays with its culled walk (plain version) and its exact fetch
(`specular_fetch = "exact"`).  Both find the same closest hits; t, u, v
differ by float rounding of two intersection formulas (~1e-6), hence
position/normal/uv atol 1e-5 and rgb rtol 1e-4.  The port's default
prefiltered fetch snaps radiance to half-texels and is held to the bound
the JAX package holds its own prefiltered path to (max rel 0.15, mean rel
5e-3 of the image peak).

Random numbers: the JAX model draws its per-pixel sample shift from a
threefry key; the test draws the same numbers exactly as
`models/material.py:585-597` does and passes them to the port as
`spec_shift`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models.material import MaterialModel as JMat
from texir_code_tpu.models.material import MaterialParams as JParams
from texir_code_tpu.models.material import clamp_material_params as j_clamp
from texir_code_tpu.ops import gbuffer as JG
from texir_code_tpu.ops.raycast import DeviceBVH
from texir_code_tpu.geometry.bvh import build_bvh as j_build_bvh
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.models.material import MaterialModel as TMat
from texir_code_tpu_torch.models.material import clamp_material_params as t_clamp
from texir_code_tpu_torch.ops import gbuffer as TG
from texir_code_tpu_torch.train.exp import adam_staircase

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (32, 64)
SPEC_SPP = 8
NUM_CLASSES = 7


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(atlas_res=48)
    m = scene.mesh
    tmesh = convert.mesh_from_numpy(m.vertices, m.faces, m.uvs, m.uv_faces,
                                    m.vertex_normals)
    rng = np.random.default_rng(21)
    irt = rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32)
    jm = JMat(m, scene.hdr_texture, irt, pano_res=PANO,
              sample_light=(32, SPEC_SPP))
    assert not jm.use_pallas  # the JAX CPU path (BVH, exact fetch)
    tm = TMat(tmesh, scene.hdr_texture, irt, pano_res=PANO,
              sample_light=(32, SPEC_SPP), device="cpu")
    tm.specular_fetch = "exact"
    pos = scene.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = np.array(JG.cube_mvp(jnp.asarray(ext)))
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    b = 6 * jm.cube_res ** 2
    key = jax.random.PRNGKey(7)
    # the JAX model's own draw (models/material.py:585-597)
    row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(b, dtype=jnp.int32))
    shift = np.array(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(row_keys))
    res = jm.cube_res
    gt = rng.uniform(0.0, 1.5, (6, res, res, 3)).astype(np.float32)
    seg = rng.integers(0, NUM_CLASSES - 1, (6, res, res)).astype(np.int32)
    highlight = (rng.random((6, res, res, 1)) < 0.3).astype(np.float32)
    room = rng.integers(0, 2, (6, res, res)).astype(np.int32)
    return dict(scene=scene, tmesh=tmesh, jm=jm, tm=tm, mvp=mvp, pos=pos,
                ext=ext, albedo=albedo, rough=rough, key=key, shift=shift,
                gt=gt, seg=seg, highlight=highlight, room=room, cache={})


def _jparams(s):
    return JParams(albedo=jnp.asarray(s["albedo"]),
                   roughness=jnp.asarray(s["rough"]))


def _tparams(s, grad=False):
    return convert.material_params_from_numpy(s["albedo"], s["rough"],
                                              device="cpu",
                                              requires_grad=grad)


def _jax_out(s, stage):
    if stage not in s["cache"]:
        fn = jax.jit(lambda p: s["jm"]._forward(
            p, jnp.asarray(s["mvp"]), jnp.asarray(s["pos"]), s["key"],
            stage=stage))
        s["cache"][stage] = {k: np.asarray(v) for k, v in fn(_jparams(s)).items()}
    return s["cache"][stage]


# ---------------------------------------------------------------------------
# cameras and the G-buffer
# ---------------------------------------------------------------------------


def test_cube_mvp_and_projection(setup):
    s = setup
    np.testing.assert_allclose(TG.cube_mvp(s["ext"]).numpy(), s["mvp"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(TG.gl_projection(70.0).numpy(),
                               np.asarray(JG.gl_projection(70.0)), atol=1e-6)
    np.testing.assert_allclose(
        TG.cube_face_w2c(torch.from_numpy(s["ext"])).numpy(),
        np.asarray(JG.cube_face_w2c(jnp.asarray(s["ext"]))), atol=1e-6)


def test_ray_dirs_from_mvp(setup):
    s = setup
    a = np.asarray(JG.ray_dirs_from_mvp(jnp.asarray(s["mvp"]), None, 16))
    b = TG.ray_dirs_from_mvp(torch.tensor(s["mvp"]), 16).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6)
    x, y = TG.pixel_ndc_grid(16)
    xj, yj = JG.pixel_ndc_grid(16)
    assert np.array_equal(x.numpy(), np.asarray(xj))
    assert np.array_equal(y.numpy(), np.asarray(yj))


def test_render_gbuffer(setup):
    s = setup
    m = s["scene"].mesh
    dm = JG.DeviceMesh.from_mesh(m)
    bvh = DeviceBVH.from_flat(j_build_bvh(m.vertices, m.faces))
    gj = JG.render_gbuffer(dm, bvh, jnp.asarray(s["mvp"]),
                           jnp.asarray(s["pos"]), 16)
    tm = s["tm"]
    gt = TG.render_gbuffer(tm.device_mesh, torch.from_numpy(s["mvp"]),
                           torch.from_numpy(s["pos"]), 16, tm.cluster_scene)
    pj, pt = np.asarray(gj.prim), gt.prim.numpy()
    assert (pt >= 0).all()  # closed room: every pixel hits
    tie = pj != pt
    assert tie.mean() < 2e-3
    for name in ("position", "normal", "uv"):
        a, b = np.asarray(getattr(gj, name)), getattr(gt, name).numpy()
        assert np.abs(a - b)[~tie].max() <= 1e-5, name
    np.testing.assert_allclose(gt.t.numpy(), np.asarray(gj.t), rtol=1e-5)
    assert np.array_equal(gt.mask.numpy(), np.asarray(gj.mask))


def test_interpolate_attributes_background(setup):
    from texir_code_tpu_torch.ops.raycast import RayHit

    tm = setup["tm"]
    hit = RayHit(t=torch.tensor([1.0, float("inf")]),
                 prim=torch.tensor([0, -1], dtype=torch.int32),
                 u=torch.tensor([0.25, 0.0]), v=torch.tensor([0.5, 0.0]))
    pos, nrm, uv = TG.interpolate_attributes(tm.device_mesh, hit)
    v = tm.device_mesh.vertices[tm.device_mesh.faces[0]]
    np.testing.assert_allclose(
        pos[0].numpy(), (0.25 * v[0] + 0.25 * v[1] + 0.5 * v[2]).numpy(),
        atol=1e-6)
    np.testing.assert_allclose(nrm.norm(dim=-1).numpy(), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", [-1, 0, 1, 2])
def test_forward_matches_jax(setup, stage):
    s = setup
    ref = _jax_out(s, stage)
    out = s["tm"]._forward(_tparams(s), s["mvp"], s["pos"], stage,
                           spec_shift=s["shift"])
    for k in ("rgb", "albedo", "roughness", "roughness_womipmap", "normal",
              "position", "empty_mask"):
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert np.isfinite(ref["rgb"]).all()
    if stage == -1:  # a pure specular image of the lamp
        assert out["rgb"].max() > 0


def test_prefiltered_fetch_bounded(setup):
    """The default fetch (one nearest RGBE word of the 2×-prefiltered
    atlas) against the JAX CPU path's exact bilinear fetch."""
    s = setup
    tm = s["tm"]
    tm.specular_fetch = "prefiltered"
    try:
        out = tm._forward(_tparams(s), s["mvp"], s["pos"], 2,
                          spec_shift=s["shift"])["rgb"].detach().numpy()
    finally:
        tm.specular_fetch = "exact"
    ref = _jax_out(s, 2)["rgb"]
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < 0.15
    assert np.abs(out - ref).mean() / scale < 0.005


def test_draw_spec_shift_is_per_pixel(setup):
    tm = setup["tm"]
    a = tm.draw_spec_shift(3, 100)
    b = tm.draw_spec_shift(3, 60)
    assert a.shape == (100, 2)
    assert torch.equal(a[:60], b)  # a pixel's draw ignores the batch size
    assert not torch.equal(a, tm.draw_spec_shift(4, 100))
    assert ((a >= 0) & (a < 1)).all()


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def _loss_kwargs(s, stage, lib):
    conv = jnp.asarray if lib is JL else torch.from_numpy
    res = s["jm"].cube_res
    ones = np.ones((6, res, res, 1), np.float32)
    return dict(
        gt_img=conv(s["gt"]), gt_mask=conv(ones), seg_id=conv(s["seg"]),
        num_classes=NUM_CLASSES, stage=stage,
        highlight=conv(s["highlight"]), seg_region=conv(ones),
        room_id=conv(s["room"]), num_rooms=2,
    )


@pytest.mark.parametrize("stage", [0, 2])
def test_loss_and_gradients_match_jax(setup, stage):
    s = setup

    def jloss(p):
        out = s["jm"]._forward(p, jnp.asarray(s["mvp"]), jnp.asarray(s["pos"]),
                               s["key"], stage=stage)
        kw = _loss_kwargs(s, stage, JL)
        return JL.render_loss(kw.pop("gt_img"), out, **kw)[0]

    lj, gj = jax.value_and_grad(jloss)(_jparams(s))
    p = _tparams(s, grad=True)
    out = s["tm"]._forward(p, s["mvp"], s["pos"], stage, spec_shift=s["shift"])
    kw = _loss_kwargs(s, stage, TL)
    lt = TL.render_loss(kw.pop("gt_img"), out, **kw)[0]
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for name in ("albedo", "roughness"):
        a = np.asarray(getattr(gj, name))
        g = getattr(p, name).grad
        if stage == 0 and name == "roughness":  # stage 0 shades no roughness
            assert np.abs(a).max() == 0 and g is None
            continue
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_adam_and_clamp_match_optax(setup):
    """Three Adam + clamp steps from the same parameters and gradients:
    torch.optim.Adam with the staircase schedule against optax."""
    s = setup
    rng = np.random.default_rng(3)
    grads = [(rng.standard_normal(s["albedo"].shape).astype(np.float32),
              rng.standard_normal(s["rough"].shape).astype(np.float32))
             for _ in range(3)]
    lr, steps_per_epoch, sched_step, factor = 3e-2, 1, 2, 0.5
    sched = optax.exponential_decay(lr, transition_steps=sched_step * steps_per_epoch,
                                    decay_rate=factor, staircase=True)
    opt = optax.adam(sched)
    pj = _jparams(s)
    state = opt.init(pj)
    pt = _tparams(s, grad=True)
    topt, tsched = adam_staircase([pt.albedo, pt.roughness], lr, sched_step,
                                  factor, steps_per_epoch)
    for ga, gr in grads:
        upd, state = opt.update(JParams(jnp.asarray(ga), jnp.asarray(gr)),
                                state)
        pj = j_clamp(optax.apply_updates(pj, upd))
        pt.albedo.grad = torch.from_numpy(ga)
        pt.roughness.grad = torch.from_numpy(gr)
        topt.step()
        tsched.step()
        with torch.no_grad():
            c = t_clamp(pt)
            pt.albedo.copy_(c.albedo)
            pt.roughness.copy_(c.roughness)
    np.testing.assert_allclose(pt.albedo.detach().numpy(),
                               np.asarray(pj.albedo), atol=1e-6)
    np.testing.assert_allclose(pt.roughness.detach().numpy(),
                               np.asarray(pj.roughness), atol=1e-6)


# ---------------------------------------------------------------------------
# the TBL pieces the forward pass reads, and the conf knobs
# ---------------------------------------------------------------------------


def test_tbl_radiance_vhl_and_auto_query(setup):
    from texir_code_tpu.models import tbl as JT
    from texir_code_tpu.ops.raycast import RayHit as JHit
    from texir_code_tpu_torch.models import tbl as TT
    from texir_code_tpu_torch.ops.raycast import RayHit as THit

    s = setup
    jt, tt = s["jm"].tbl, s["tm"].tbl
    for a, b in zip(JT.vhl_texture(jt.texture, 0.0).transpose(2, 0, 1),
                    s["tm"].tbl_vhl.planes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(6)
    n = 300
    t = rng.uniform(-1e-4, 3.0, n).astype(np.float32)
    t[::7] = np.inf
    prim = rng.integers(-1, s["scene"].mesh.num_faces, n).astype(np.int32)
    u = rng.uniform(-0.1, 0.7, n).astype(np.float32)
    v = rng.uniform(-0.1, 0.5, n).astype(np.float32)
    a = JT.radiance_from_hit(jt, JHit(*(jnp.asarray(x) for x in (t, prim, u, v))))
    b = TT.radiance_from_hit(tt, THit(*(torch.from_numpy(x) for x in (t, prim, u, v))))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=1e-7)
    # any ray count: the auto query pads to 128 and drops the padding
    o = tuple(torch.full((3, 50), float(c)) for c in s["pos"])
    d = torch.from_numpy(rng.standard_normal((3, 3, 50)).astype(np.float32))
    d = tuple(d[k] / d.norm(dim=0) for k in range(3))
    got = TT.query_tbl_auto(tt, o, d, s["tm"].cluster_scene)

    def pad(x):  # 150 rays → 256
        return torch.nn.functional.pad(x.reshape(-1), (0, 106))

    ref = TT.query_tbl_stream(tt, tuple(map(pad, o)), tuple(map(pad, d)),
                              s["tm"].cluster_scene)
    for x, y in zip(got, ref):
        assert x.shape == (3, 50)
        np.testing.assert_array_equal(x.reshape(-1).numpy(), y[:150].numpy())
    assert float(sum(x.sum() for x in got)) > 0


def test_render_knobs_from_conf():
    from texir_code_tpu.config import ConfigFactory
    from texir_code_tpu.models.material import render_knobs_from_conf as jk
    from texir_code_tpu_torch.config import parse_string
    from texir_code_tpu_torch.models.material import render_knobs_from_conf as tk

    text = ("models { render { spec_row_width = 512\n use_occluders = true\n"
            " cluster_lb = 4\n specular_fetch = exact } }")
    assert tk(parse_string(text)) == jk(ConfigFactory.parse_string(text))
