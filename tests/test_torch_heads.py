"""Port vs JAX: the three baseline heads' forward pass and training step.

On `make_scene(atlas_res=48)` at pano (16, 32) and sample_light (8, 4), as
`tests/test_material_heads.py` sets the JAX heads up (InvRender's and
NeILF's networks narrowed as there, nvdiffrec's at full width), from the
same parameters (the JAX initialisation with its zero output layers and
its hash table drawn at random, carried across by
`convert.field_params_from_flax`), the JAX
head's camera constants (`precompute_view`) and the JAX head's own draws:

  * `_forward`: rgb, albedo, roughness, the head's extra keys (brdf_grad,
    kd_grad, the latents) and the rest within rtol 1e-4 / atol 1e-5;
  * one training step: the loss within rel 1e-5; every parameter's
    gradient (NeILF's through the roughness gradient's double backward)
    within rtol 1e-4 elementwise, with an atol of 1e-5 of the tensor's
    largest entry (float32 sums over the pixels cancel in entries near
    zero, and the hash table's gradient adds 256 scatters in another
    order: read 1.2e-5 of the largest at most, nvdiffrec's table), and
    within relative L2 1e-5 (read at most 4.1e-6);
  * the port's own camera constants (the culled walk's G-buffer, the mip
    sampler's IrT) against the JAX head's (its BVH) within rtol 1e-4 /
    atol 1e-5;
  * the port's draws: a pixel's draws do not depend on the batch, the
    normals are standard normals.

The JAX head traces its specular rays through its BVH on the CPU, the port
through the plain culled walk: both find the exact closest hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models import fields as JF
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models import material_heads as JH
from texir_code_tpu.ops.gbuffer import cube_mvp
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.models import material_heads as TH

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (16, 32)
LIGHT = (8, 4)
HEADS = {
    # head: (JAX class, its kwargs, the port's kwargs)
    "invrender": (JH.InvRenderMaterialModel,
                  dict(network=JF.EnvmapMaterialNetwork(
                      brdf_encoder_dims=(64, 64), brdf_decoder_dims=(32,))),
                  dict(network_kw=dict(brdf_encoder_dims=(64, 64),
                                       brdf_decoder_dims=(32,)))),
    "neilf": (JH.NeILFMaterialModel,
              dict(brdf_network=JF.BRDFMLP(dims=(64,) * 8),
                   light_network=JF.NeILFMLP(dims=(64,) * 8)),
              dict(brdf_kw=dict(dims=(64,) * 8),
                   light_kw=dict(dims=(64,) * 8))),
    "recmlp": (JH.NvDiffRecMaterialModel, {}, {}),
}


def jax_draws(head, key, b):
    """The JAX head's draws from its step key, as the port's `draws`."""
    k1, k2 = jax.random.split(key)
    d = {"spec_shift": np.asarray(jax.random.uniform(k2, (b, 1, 2)))
         .reshape(b, 2)}
    if head == "invrender":
        d["latent_noise"] = np.asarray(jax.random.normal(k1, (b, 32)))
    elif head == "neilf":
        d["diff_shift"] = np.asarray(jax.random.uniform(k1, (b, 1, 2))
                                     ).reshape(b, 2)
    else:
        d["jitter"] = np.asarray(jax.random.normal(k1, (b, 3)))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def jax_loss(head, out, gt, rgb_grad, it):
    if head == "invrender":
        return JL.inv_loss(out, gt, out["latent_pre_sigmoid"])["loss"]
    if head == "neilf":
        return JL.neilf_loss(out, gt, rgb_grad)
    return JL.nvdiffrec_loss(out, gt, jnp.asarray(float(it)))


def port_loss(head, out, gt, rgb_grad, it):
    if head == "invrender":
        return TL.inv_loss(out, gt, out["latent_pre_sigmoid"])["loss"]
    if head == "neilf":
        return TL.neilf_loss(out, gt, rgb_grad)
    return TL.nvdiffrec_loss(out, gt, it)


def randomised(params):
    """The JAX initialisation with its zero layers (and biases) drawn at
    random and the hash table (U(±1e-4)) in U(±0.05), so that every
    parameter carries a gradient well above its rounding.  (At U(±1e-4)
    the jittered resample differs from the sample by rounding, and the
    sign of its L1 is noise; at U(±0.5) the finest level, res 4095, turns
    an ulp of a position into 1e-4 of a feature.)"""
    rng = np.random.default_rng(11)

    def f(path, x):
        x = np.asarray(x)
        if path[-1].key == "table":
            return rng.uniform(-0.05, 0.05, x.shape).astype(x.dtype)
        if path[-1].key == "bias" or not np.any(x):
            return (x + rng.normal(0, 0.3, x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def env():
    scene = make_scene(atlas_res=48)
    irt = np.random.default_rng(1).uniform(0.5, 2.0, (16, 16, 3)).astype(
        np.float32)
    pos = scene.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    m = scene.mesh
    tmesh = convert.mesh_from_numpy(m.vertices, m.faces, m.uvs, m.uv_faces,
                                    m.vertex_normals)
    return scene, irt, pos, cube_mvp(jnp.asarray(ext)), tmesh


_CASES = {}


def case(env, head):
    """The JAX head's view, draws, outputs, loss and gradients of one step
    (one compile), and the port head with the same parameters."""
    if head in _CASES:
        return _CASES[head]
    scene, irt, pos, mvp, tmesh = env
    jcls, jkw, tkw = HEADS[head]
    kw = dict(pano_res=PANO, sample_light=LIGHT)
    jm = jcls(scene.mesh, scene.hdr_texture, irt, **kw, **jkw)
    tm = TH.HEADS[head](tmesh, scene.hdr_texture, irt, device="cpu", **kw,
                        **tkw)
    key = jax.random.PRNGKey(3)
    params = randomised(jm.init_params(key))
    view = jax.jit(jm.precompute_view)(mvp, jnp.asarray(pos))
    r = jm.cube_res
    rng = np.random.default_rng(2)
    gt = rng.uniform(0, 1.5, (6, r, r, 3)).astype(np.float32)
    grad = rng.uniform(0, 1, (6, r, r, 1)).astype(np.float32)

    def lf(p):
        o = jm._forward(p, mvp, jnp.asarray(pos), key, view=view)
        return jax_loss(head, o, jnp.asarray(gt), jnp.asarray(grad), 50), o

    (loss, out), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    tp = tm.init_params()
    tp.load_state_dict(convert.field_params_from_flax(params, tp))
    _CASES[head] = dict(
        jm=jm, tm=tm, tp=tp, params=params, mvp=np.asarray(mvp), pos=pos,
        view=tuple(torch.from_numpy(np.array(x)) for x in view),
        jview=view, draws=jax_draws(head, key, 6 * r * r),
        out={k: np.asarray(v) for k, v in out.items()}, loss=float(loss),
        grads=convert.field_params_from_flax(
            jax.tree_util.tree_map(np.asarray, g), tp),
        gt=torch.from_numpy(gt), grad=torch.from_numpy(grad))
    return _CASES[head]


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_forward_matches_jax(env, head):
    c = case(env, head)
    with torch.no_grad():
        out = c["tm"]._forward(c["tp"], c["mvp"], c["pos"], view=c["view"],
                               draws=c["draws"])
    assert set(out) == set(c["out"])
    extra = {"invrender": "latent_pre_sigmoid", "neilf": "brdf_grad",
             "recmlp": "kd_grad"}[head]
    assert extra in out
    for k, ref in c["out"].items():
        got = out[k].numpy()
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert np.abs(c["out"]["rgb"]).max() > 0.1  # lit, not trivially equal


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_step_matches_jax(env, head):
    """One step's loss within rel 1e-5 and every parameter's gradient
    within rtol 1e-4."""
    c = case(env, head)
    tp = c["tp"]
    tp.zero_grad(set_to_none=True)
    out = c["tm"]._forward(tp, c["mvp"], c["pos"], view=c["view"],
                           draws=c["draws"])
    loss = port_loss(head, out, c["gt"], c["grad"], 50)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), c["loss"], rtol=1e-5)
    grads = dict(tp.named_parameters())
    assert set(grads) == set(c["grads"])
    for k, ref in c["grads"].items():
        ref = ref.numpy()
        assert np.abs(ref).max() > 0, k
        got = grads[k].grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), k


def test_head_view_matches_jax(env):
    """The port's own camera constants against the JAX head's: position,
    normal and mask from the culled walk's G-buffer, the IrT irradiance
    from the mip sampler."""
    c = case(env, "invrender")
    ours = c["tm"].precompute_view(c["mvp"], c["pos"])
    for name, a, b in zip(("position", "normal", "irradiance", "mask"),
                          ours, c["jview"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(ours[3].mean()) > 0.9


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_draws_keyed_by_pixel(env, head):
    """A pixel's draws are a function of (seed, pixel id): a longer batch
    starts with the same rows; the normals are standard normals."""
    tm = case(env, head)["tm"]
    a, b = tm.draw(7, 384), tm.draw(7, 1000)
    assert set(a) == set(b) == set(case(env, head)["draws"])
    for k in a:
        assert torch.equal(a[k], b[k][:384]), k
        assert a[k].shape[1] == {"spec_shift": 2, "diff_shift": 2,
                                 "latent_noise": 32, "jitter": 3}[k]
    assert not torch.equal(tm.draw(8, 384)["spec_shift"], a["spec_shift"])
    for k in ("latent_noise", "jitter"):
        if k in b:
            x = tm.draw(3, 20000)[k]
            assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1) < 0.02
