"""Port vs JAX: the two alternative material models and the small pieces
beside them.

  * `models/material_redner.py` — `axis_angle_to_matrix` (values and
    gradient, at the zero init where every run starts and at a generic
    angle), `moller_trumbore_soa` (a near-zero determinant included) and
    `sample_object_textures`, each with its gradients; `RednerMaterialModel`
    with optim_cam at the JAX tests' sizes (`tests/test_material_redner.py`:
    texture 32, pano 16×32, sample_light (4, 4), two object groups, two
    views) from JAX's draws: the forward within rtol 1e-4 / atol 1e-5 at a
    pose moved off its extrinsic and at the zero init, a step's loss within
    rel 1e-5 and every gradient, the pose deltas included, within rtol 1e-4
    (atol 1e-5 of the tensor's largest); its IRF-network lighting
    (`irf_apply` with a `fields.IRNetwork` from the flax weights) forward
    alike;
  * `models/material_mlp.py::MaterialMLP` (narrowed network, pano 16×32,
    sample_light (4, 4)) from the flax weights and JAX's draws: forward and
    gradients as above;
  * `fields.IRSGNetwork` from the flax weights within rtol 1e-5;
  * `ops/shading.py` `diffuse_estimator` (uniform, cosine) and
    `specular_estimator`, and `models/losses.py` `ms_ssim`,
    `gradient_loss`, `psnr_loss`, `ssim_loss`, `msssim_loss` and
    `RenderLoss`, within rtol 1e-5.

Both packages trace the pano rays through their BVH on the CPU.  Each JAX
model compiles once (a module-level cache).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models import fields as JF
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models import material_redner as JR
from texir_code_tpu.models.material_mlp import MaterialMLP as JMaterialMLP
from texir_code_tpu.ops import shading as JS
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import fields as TF
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.models import material_redner as TR
from texir_code_tpu_torch.models.material_mlp import MaterialMLP
from texir_code_tpu_torch.ops import shading as TS

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (16, 32)
LIGHT = (4, 4)
TEX = 32


def t(x):
    return torch.from_numpy(np.array(x))


def assert_grads(got, ref, name):
    """rtol 1e-4 with an atol of 1e-5 of the tensor's largest entry."""
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0, name
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max(), err_msg=name)


def jax_draws(key, b):
    """The JAX models' draws from their key, as the port's `draws`."""
    k_d, k_s = jax.random.split(key)
    return {"diff_shift": t(jax.random.uniform(k_d, (b, 1, 2))).reshape(b, 2),
            "spec_shift": t(jax.random.uniform(k_s, (b, 1, 2))).reshape(b, 2)}


@pytest.fixture(scope="module")
def scene():
    from texir_code_tpu_torch.convert import mesh_from_numpy

    s = make_scene(atlas_res=64)
    m = s.mesh
    ids = np.zeros(m.num_faces, np.int32)
    ids[m.num_faces // 2:] = 1  # two "objects", as the JAX tests split them
    m.material_ids = ids
    tm = mesh_from_numpy(m.vertices, m.faces, m.uvs, m.uv_faces,
                         m.vertex_normals)
    tm.material_ids = ids
    return s, tm


# ---------------------------------------------------------------------------
# Redner's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [(0.0, 0.0, 0.0), (0.3, -0.2, 0.5),
                               (2e-7, 0.0, -1e-7)],
                         ids=["zero", "generic", "first-order"])
def test_axis_angle_matches_jax(w):
    wj = jnp.asarray(w, jnp.float32)
    weights = np.arange(9, dtype=np.float32).reshape(3, 3) - 4.0
    gj = jax.grad(lambda x: jnp.sum(JR.axis_angle_to_matrix(x) * weights))(wj)
    wt = torch.tensor(w, dtype=torch.float32, requires_grad=True)
    r = TR.axis_angle_to_matrix(wt)
    (r * t(weights)).sum().backward()
    np.testing.assert_allclose(r.detach().numpy(),
                               np.asarray(JR.axis_angle_to_matrix(wj)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(wt.grad.numpy()).all()


def test_moller_trumbore_and_textures_match_jax():
    """The pinned-triangle solve (one triangle degenerate: its determinant
    0 takes the 1e-12 branch) and the per-object bilinear sample, values
    and gradients."""
    rng = np.random.default_rng(5)
    b = 64
    o = rng.normal(0, 1, (3, b)).astype(np.float32)
    d = rng.normal(0, 1, (3, b)).astype(np.float32)
    v = rng.normal(0, 1, (3, 3, b)).astype(np.float32)
    v[2, :, 0] = v[0, :, 0]  # degenerate: e2 = 0, det = 0
    tex = rng.uniform(0, 1, (3, 8, 8, 2)).astype(np.float32)
    obj = rng.integers(0, 3, b).astype(np.int32)
    wts = rng.normal(0, 1, (5, b)).astype(np.float32)

    def jf(o, d, v, tex):
        tt, u, vv = JR.moller_trumbore_soa(tuple(o), tuple(d), tuple(v[0]),
                                           tuple(v[1]), tuple(v[2]))
        uv = (jnp.clip(u, 0, 1), jnp.clip(vv, 0, 1))
        s = JR.sample_object_textures(tex, jnp.asarray(obj), uv)
        outs = (jnp.tanh(tt * 1e-3), u, vv, s[:, 0], s[:, 1])
        return sum(jnp.sum(x * w) for x, w in zip(outs, wts)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True))(o, d, v, tex)
    ot, dt, vt, tt = (t(x).requires_grad_() for x in (o, d, v, tex))
    tv, u, vv = TR.moller_trumbore_soa(tuple(ot), tuple(dt), tuple(vt[0]),
                                       tuple(vt[1]), tuple(vt[2]))
    s = TR.sample_object_textures(
        tt, t(obj), (torch.clamp(u, 0, 1), torch.clamp(vv, 0, 1)))
    mine = (torch.tanh(tv * 1e-3), u, vv, s[:, 0], s[:, 1])
    sum((x * t(w)).sum() for x, w in zip(mine, wts)).backward()
    for name, a, ref in zip(("t", "u", "v", "s0", "s1"), mine, outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name, a, ref in zip("odvT", (ot, dt, vt, tt), grads):
        assert_grads(a.grad.numpy(), ref, name)


# ---------------------------------------------------------------------------
# RednerMaterialModel
# ---------------------------------------------------------------------------


def _extrinsics(mesh):
    center = mesh.aabb().mean(axis=0)
    exts = []
    for dx in (0.0, 0.3):
        e = np.eye(4, dtype=np.float32)
        e[:3, 3] = center + np.array([dx, 0.0, 0.0])
        exts.append(e)
    return exts


def redner_params(model):
    """The JAX init with textures of spatial structure (so the pose
    gradient through d(texture)/d(uv) is well above rounding) and, for
    view 1, a pose moved off its extrinsic; view 0 stays at the zero init."""
    rng = np.random.default_rng(7)
    p = {k: np.array(v) for k, v in model.init_params().items()}
    p["albedo"] = rng.uniform(0.1, 0.9, p["albedo"].shape).astype(np.float32)
    p["roughness"] = rng.uniform(0.2, 0.8,
                                 p["roughness"].shape).astype(np.float32)
    p["cam_rot"][1] = (0.01, -0.02, 0.015)
    p["cam_trans"][1] = (0.02, 0.0, -0.01)
    return p


_REDNER = {}


def redner_case(scene):
    """The JAX model's outputs, loss and gradients for both views (one
    compile), and the port model."""
    if _REDNER:
        return _REDNER
    s, tm = scene
    kw = dict(ids=["v0", "v1"], extrinsics=_extrinsics(s.mesh),
              optim_cam=True, texture_res=TEX, pano_res=PANO,
              sample_light=LIGHT)
    jm = JR.RednerMaterialModel(s.mesh, s.hdr_texture, **kw)
    port = TR.RednerMaterialModel(tm, s.hdr_texture, device="cpu", **kw)
    params = redner_params(jm)
    key = jax.random.PRNGKey(4)
    gt = np.random.default_rng(3).uniform(0, 1.5, PANO + (3,)).astype(
        np.float32)

    def lf(p, view):
        o = jm._forward(p, view, key)
        loss = jnp.mean(jnp.abs(JS.hdr_scale(o["rgb"]) - JS.hdr_scale(gt)))
        return loss, o

    step = jax.jit(jax.value_and_grad(lf, has_aux=True))
    views = {}
    for view in (0, 1):
        (loss, out), g = step(params, jnp.int32(view))
        views[view] = dict(out={k: np.asarray(x) for k, x in out.items()},
                           loss=float(loss),
                           grads={k: np.asarray(x) for k, x in g.items()})
    _REDNER.update(jm=jm, port=port, params=params, gt=gt, views=views,
                   draws=jax_draws(key, PANO[0] * PANO[1]), key=key)
    return _REDNER


def port_redner_step(c, view):
    p = {k: t(v).requires_grad_() for k, v in c["params"].items()}
    out = c["port"].forward(p, view, draws=c["draws"])
    loss = (TS.hdr_scale(out["rgb"]) - TS.hdr_scale(t(c["gt"]))).abs().mean()
    loss.backward()
    return out, loss, p


@pytest.mark.parametrize("view", [0, 1], ids=["zero-init", "moved"])
def test_redner_forward_matches_jax(scene, view):
    c = redner_case(scene)
    out, _, _ = port_redner_step(c, view)
    ref = c["views"][view]["out"]
    assert set(out) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(out[k].detach().numpy(), r, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert ref["empty_mask"].mean() > 0.9 and np.abs(ref["rgb"]).max() > 0.1


@pytest.mark.parametrize("view", [0, 1], ids=["zero-init", "moved"])
def test_redner_step_gradients_match_jax(scene, view):
    """A step's loss within rel 1e-5; the gradients of both object
    textures and of the pose deltas within rtol 1e-4."""
    c = redner_case(scene)
    _, loss, p = port_redner_step(c, view)
    ref = c["views"][view]
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    assert set(p) == set(ref["grads"]) == {"albedo", "roughness", "cam_rot",
                                           "cam_trans"}
    for k, g in ref["grads"].items():
        if k.startswith("cam_"):
            # only the rendered view's row moves
            assert not np.any(g[1 - view]) and not np.any(
                p[k].grad.numpy()[1 - view]), k
            assert_grads(p[k].grad.numpy()[view], g[view], k)
        else:
            assert_grads(p[k].grad.numpy(), g, k)


def test_redner_irf_lighting_matches_jax(scene):
    """irf_apply with the port's IRNetwork against the JAX model with the
    flax IRNetwork of the same weights: the forward of view 1.  The network
    encodes points at PE(4): XLA contracts the jitted model's products into
    FMAs, so its hit positions differ from the port's in the last ulp, and
    PE(10)'s 2^9 band turns that into ~1e-3 of the radiance (read 1.0e-2
    on the smallest entries; 2.4e-4 with the JAX model run eagerly)."""
    s, tm = scene
    c = redner_case(scene)
    net = JF.IRNetwork(points_multires=4)
    fparams = net.init(jax.random.PRNGKey(9), jnp.zeros((1, 3)),
                       jnp.zeros((1, 3)))
    tnet = TF.IRNetwork(points_multires=4)
    tnet.load_state_dict(convert.field_params_from_flax(fparams, tnet))
    kw = dict(ids=["v0", "v1"], extrinsics=_extrinsics(s.mesh),
              optim_cam=True, texture_res=TEX, pano_res=PANO,
              sample_light=LIGHT)
    jm = JR.RednerMaterialModel(s.mesh, s.hdr_texture, **kw,
                                irf_apply=lambda p, d: net.apply(fparams, p, d))
    port = TR.RednerMaterialModel(tm, s.hdr_texture, device="cpu", **kw,
                                  irf_apply=tnet)
    ref = jm.forward(c["params"], 1, c["key"])
    with torch.no_grad():
        out = port.forward({k: t(v) for k, v in c["params"].items()}, 1,
                           draws=c["draws"])
    for k in ("rgb", "albedo", "roughness", "empty_mask"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    tbl_rgb = c["views"][1]["out"]["rgb"]
    assert np.abs(np.asarray(ref["rgb"]) - tbl_rgb).max() > 1e-3


# ---------------------------------------------------------------------------
# MaterialMLP
# ---------------------------------------------------------------------------


def test_material_mlp_matches_jax(scene):
    """Forward and one step's gradients from the flax weights (biases
    drawn, so each carries a gradient) and JAX's draws.  The network
    encodes points at PE(4), as the IRF test's does: PE(10)'s 2^9 band
    turns the last-ulp differences of the jitted JAX model's hit positions
    (XLA's FMAs) into 1.6e-3 of a few pixels."""
    s, tm = scene
    net_kw = dict(points_multires=4, dims=(32, 32), p_out_dim=4)
    jm = JMaterialMLP(s.mesh, s.hdr_texture, pano_res=PANO,
                      sample_light=LIGHT, network=JF.MatNetwork(**net_kw))
    port = MaterialMLP(tm, s.hdr_texture, pano_res=PANO, sample_light=LIGHT,
                       network_kw=net_kw, device="cpu")
    key = jax.random.PRNGKey(6)
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, x.shape).astype(
            np.float32), jm.init_params(key))
    cam = np.asarray(s.camera_positions(1)[0], np.float32)
    gt = rng.uniform(0, 1.5, PANO + (3,)).astype(np.float32)

    def lf(p):
        o = jm._forward(p, jnp.asarray(cam), key)
        return jnp.mean(jnp.abs(JS.hdr_scale(o["rgb"])
                                - JS.hdr_scale(gt))), o

    (loss, ref), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    tp = port.init_params()
    tp.load_state_dict(convert.field_params_from_flax(params, tp))
    out = port.forward(tp, cam, draws=jax_draws(key, PANO[0] * PANO[1]))
    mine = (TS.hdr_scale(out["rgb"]) - TS.hdr_scale(t(gt))).abs().mean()
    mine.backward()
    for k, r in ref.items():
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert np.asarray(ref["empty_mask"]).mean() > 0.9
    np.testing.assert_allclose(float(mine.detach()), float(loss), rtol=1e-5)
    grads = convert.field_params_from_flax(
        jax.tree_util.tree_map(np.asarray, g), tp)
    for k, p in tp.named_parameters():
        assert_grads(p.grad.numpy(), grads[k].numpy(), k)


def test_draws_keyed_by_pixel(scene):
    """A pixel's draws are a function of (seed, pixel id)."""
    s, tm = scene
    port = MaterialMLP(tm, s.hdr_texture, pano_res=PANO, sample_light=LIGHT,
                       network_kw=dict(dims=(8,)), device="cpu")
    a, b = port.draw(3, 100), port.draw(3, 300)
    assert set(a) == {"diff_shift", "spec_shift"}
    for k in a:
        assert torch.equal(a[k], b[k][:100]) and a[k].shape == (100, 2)
    assert not torch.equal(port.draw(4, 100)["diff_shift"], a["diff_shift"])


# ---------------------------------------------------------------------------
# IRSGNetwork, the AoS estimators, the losses
# ---------------------------------------------------------------------------


def test_irsg_network_matches_jax():
    net = JF.IRSGNetwork()
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 3)).astype(np.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(2), jnp.zeros((1, 3)))
    ref = np.asarray(jax.jit(net.apply)(params, x))
    tnet = TF.IRSGNetwork()
    tnet.load_state_dict(convert.field_params_from_flax(params, tnet))
    with torch.no_grad():
        out = tnet(t(x)).numpy()
    assert out.shape == ref.shape == (2, 5, 24, 7)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_estimators_match_jax():
    rng = np.random.default_rng(4)
    b, s = 64, 8

    def unit(*shape):
        x = rng.normal(0, 1, shape + (3,)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    light = rng.uniform(0, 2, (b, s, 3)).astype(np.float32)
    dirs, half, n, v = unit(b, s), unit(b, s), unit(b), unit(b)
    albedo = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1, (b, 1)).astype(np.float32)
    for mode in ("uniform", "cosine"):
        np.testing.assert_allclose(
            TS.diffuse_estimator(t(light), t(dirs), t(n), t(albedo),
                                 mode).numpy(),
            np.asarray(JS.diffuse_estimator(light, dirs, n, albedo, mode)),
            rtol=1e-5, err_msg=mode)
    np.testing.assert_allclose(
        TS.specular_estimator(t(light), t(half), t(n), t(v), t(dirs),
                              t(rough)).numpy(),
        np.asarray(JS.specular_estimator(light, half, n, v, dirs, rough)),
        rtol=1e-5, atol=1e-7)


LOSSES = ("ms_ssim", "gradient_loss", "psnr_loss", "ssim_loss",
          "msssim_loss")


@pytest.mark.parametrize("size", [(2, 24, 40, 3), (1, 96, 112, 3)],
                         ids=["two-scales", "four-scales"])
def test_image_losses_match_jax(size):
    """ms_ssim at sizes where JAX keeps two and four of its five scales,
    and the losses built on it and beside it, within rtol 1e-5; a loss
    1 - s (ssim_loss, msssim_loss) within 1e-5 of s, as its cancellation
    leaves s's own rounding (ms_ssim read 1.6e-6 apart)."""
    rng = np.random.default_rng(size[1])
    a = rng.uniform(0, 1, size).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size), 0, 1).astype(np.float32)
    refs = jax.jit(lambda a, b: [getattr(JL, n)(a, b) for n in LOSSES])(a, b)
    for name, ref in zip(LOSSES, refs):
        got = float(getattr(TL, name)(t(a), t(b)))
        atol = 1e-5 if name in ("ssim_loss", "msssim_loss") else 0.0
        np.testing.assert_allclose(got, float(ref), rtol=1e-5, atol=atol,
                                   err_msg=name)


def test_render_loss_class_matches_jax():
    rng = np.random.default_rng(9)
    f, h, w = 2, 12, 12
    preds = {"rgb": rng.uniform(0, 2, (f, h, w, 3)),
             "albedo": rng.uniform(0, 1, (f, h, w, 3)),
             "roughness": rng.uniform(0, 1, (f, h, w, 1)),
             "empty_mask": (rng.uniform(0, 1, (f, h, w, 1)) > 0.1)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    gt = rng.uniform(0, 2, (f, h, w, 3)).astype(np.float32)
    mask = np.ones((f, h, w, 1), np.float32)
    seg = rng.integers(0, 3, (f, h, w)).astype(np.int32)
    region = (seg > 0).astype(np.float32)[..., None]
    for stage, kw in ((0, {}), (2, {"seg_region": region})):
        for lt in ("L1", "L2"):
            ref = jax.jit(lambda *a: JL.RenderLoss(loss_type=lt)(
                *a, 3, stage, **kw))(gt, preds, mask, seg)
            got = TL.RenderLoss(loss_type=lt)(
                t(gt), {k: t(v) for k, v in preds.items()}, t(mask),
                t(seg).long(), 3, stage,
                **{k: t(v) for k, v in kw.items()})
            for x, y in zip(got, ref):
                np.testing.assert_allclose(float(x), float(y), rtol=1e-5,
                                           atol=1e-8, err_msg=(stage, lt))
