"""Port vs JAX: the baseline heads' networks, losses and schedule on the CPU.

  * `models/fields.py`: BRDFMLP, NeILFMLP, EnvmapMaterialNetwork (with its
    jittered decode) and MLPTexture3D at their default widths, with the
    flax weights carried across by `convert.field_params_from_flax` (the
    zero-initialised output layers and the hash table drawn at random
    first, so that every layer matters): outputs within rtol 1e-5 / atol
    1e-6 and parameter gradients within rtol 1e-4, both packages in
    float64; in float32 outputs within atol 1e-5.  The port's
    initialisation draws from the JAX package's distributions.
  * HashGridEncoding at x01 on 0, on 1 and inside, over its dense levels
    (0-4) and its hashed ones (5-15): within 1e-6; its table's gradient
    at a 2^14 table (levels 0-1 dense), which JAX forms quickly (the
    MLPTexture3D case holds the 2^19 table fixed in its gradient check).
  * kl_divergence, inv_loss, neilf_loss, nvdiffrec_loss (below and past
    its ramp) and the aliases InvLoss / NeILFLoss / NvDiffRecLoss: rel 1e-6.
  * make_lr_schedule (and the Adam it drives) against the optax schedule
    of the JAX runner at every step, for a scalar period and for
    milestone lists with a duplicate ([1, 1] within 3 epochs, [20, 20]).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.models import fields as JF
from texir_code_tpu.models import losses as JL
from texir_code_tpu.train.heads import make_lr_schedule as j_schedule
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import fields as TF
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.train.heads import head_adam, make_lr_schedule

torch.set_num_threads(2)  # six test workers share the host's cores

B = 64
AABB = np.array([[-1.0, -0.5, -1.5], [2.0, 1.5, 0.5]], np.float32)


def _points(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(AABB[0] - 0.2, AABB[1] + 0.2, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pts, d


NETWORKS = {
    # name: (flax module, port module, input)
    "BRDFMLP": (JF.BRDFMLP, TF.BRDFMLP, lambda p, d: p),
    "NeILFMLP": (JF.NeILFMLP, TF.NeILFMLP,
                 lambda p, d: np.concatenate([p, d], -1)),
    "EnvmapMaterialNetwork": (JF.EnvmapMaterialNetwork,
                              TF.EnvmapMaterialNetwork, lambda p, d: p),
    "MLPTexture3D": (lambda: JF.MLPTexture3D(aabb=AABB),
                     lambda: TF.MLPTexture3D(AABB), lambda p, d: p),
}


def _randomised(params):
    """The flax tree with its zero output layers and tiny hash table drawn
    at random (the same arrays go to both packages)."""
    rng = np.random.default_rng(11)

    def f(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name == "table":
            return rng.uniform(-1, 1, x.shape).astype(x.dtype)
        if not np.any(x) or name == "bias":
            return (x + rng.normal(0, 0.3, x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, params)


def _flax_params(name, jnet, x, jargs):
    """The network's flax params, randomised; MLPTexture3D's tree is laid
    out by hand (flax's init runs a 2^19-table forward eagerly)."""
    if name == "MLPTexture3D":
        rng = np.random.default_rng(12)
        dense = {f"Dense_{i}": {"kernel": rng.uniform(-0.5, 0.5, shp).astype(
            np.float32)} for i, shp in enumerate(((32, 32), (32, 32),
                                                  (32, 4)))}
        return {"params": dict(dense, HashGridEncoding_0={
            "table": rng.uniform(-1, 1, (16, 2 ** 19, 2)).astype(
                np.float32)})}
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, x.shape[1])),
                       *jargs)
    return _randomised(params)


_PARAMS = {}  # name → randomised float32 flax params, shared by the tests


def _same_weights(name, dtype):
    """(flax module, its params, the port module with the same weights,
    the flax call's extra arguments, the port call's keyword arguments,
    the input), all in `dtype`."""
    jmk, tmk, inp = NETWORKS[name]
    jnet, tnet = jmk(), tmk()
    x = inp(*_points()).astype(dtype)
    jargs, tkw = (), {}
    if name == "EnvmapMaterialNetwork":
        # the jittered decode: JAX draws from the key, the port takes them
        key = jax.random.PRNGKey(5)
        jargs = (key,)
        tkw = {"noise": torch.from_numpy(np.array(
            jax.random.normal(key, (B, 32)), dtype))}
    if name not in _PARAMS:
        _PARAMS[name] = _flax_params(name, jnet, x, jargs)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                    _PARAMS[name])
    tnet.load_state_dict(convert.field_params_from_flax(params, tnet))
    tnet = tnet.to(torch.float64 if dtype == np.float64 else torch.float32)
    return jnet, params, tnet, jargs, tkw, x


def _flat(out):
    """A network's output(s) as one [B, C] array, dict keys sorted."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)
                if k not in ("latent_pre_sigmoid",)]
    return [out]


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_head_network_matches_flax(name):
    """The same function: outputs within rtol 1e-5 / atol 1e-6 and every
    parameter's gradient within rtol 1e-4, both packages in float64."""
    with jax.enable_x64(True):
        jnet, params, tnet, jargs, tkw, x = _same_weights(name, np.float64)
        out = jnet.apply(params, jnp.asarray(x), *jargs)
        ws = [np.random.default_rng(i).normal(size=np.shape(o))
              for i, o in enumerate(_flat(out))]

        tree = params["params"]
        # MLPTexture3D's table gradient (128 MiB in float64) is slow for
        # JAX to form on the CPU: it is held fixed here and its gradient
        # checked by test_hash_grid_gradient_matches_jax
        fixed = {k: v for k, v in tree.items() if k == "HashGridEncoding_0"}

        def jloss(p):
            p = {"params": {**p, **fixed}}
            o = _flat(jnet.apply(p, jnp.asarray(x), *jargs))
            return sum(jnp.sum(a * w) for a, w in zip(o, ws))

        a = [np.asarray(o) for o in _flat(out)]
        grad = jax.grad(jloss)
        if not fixed:  # one compile beats eager dispatch, but for the
            grad = jax.jit(grad)  # hash grid's 128 gathers
        jg = grad({k: v for k, v in tree.items() if k not in fixed})
        jg = {"params": {**jax.tree_util.tree_map(np.asarray, jg),
                         **jax.tree_util.tree_map(np.zeros_like, fixed)}}
    tout = _flat(tnet(torch.from_numpy(x), **tkw))
    assert len(tout) == len(a) and a[0].dtype == np.float64
    for o, r in zip(tout, a):
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=1e-5,
                                   atol=1e-6)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(tout, ws)).backward()
    # the flax gradients laid out as the port's state dict (in float32,
    # far inside rtol 1e-4)
    want = convert.field_params_from_flax(jg, tnet)
    grads = dict(tnet.named_parameters())
    assert set(grads) == set(want)
    for k, ref in want.items():
        if k == "encoding.table":
            continue
        ref = ref.numpy()
        np.testing.assert_allclose(grads[k].grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_head_network_matches_flax_fp32(name):
    """In float32, as the heads run: outputs within atol 1e-5."""
    jnet, params, tnet, jargs, tkw, x = _same_weights(name, np.float32)
    a = _flat(jnet.apply(params, jnp.asarray(x), *jargs))
    b = _flat(tnet(torch.from_numpy(x), **tkw))
    for o, r in zip(b, a):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


def test_head_network_init_follows_jax():
    """The JAX package's initialisations: SIREN U(±ω/in) on a first layer
    without PE and U(±√(3/in)) on the others (every sine layer with the
    default PE), zero output layers (NeILFMLP's bias ln 1.5), the hash
    table in U(±1e-4), MLPTexture3D's bias-free kaiming layers."""
    g = torch.Generator().manual_seed(0)
    brdf = TF.BRDFMLP(generator=g)
    assert [l.linear.in_features for l in brdf.layers[:-1]] == \
        [39, 512, 512, 512, 512, 512, 512, 512]
    assert brdf.layers[3].linear.out_features == 512 - 39  # the skip
    for l in brdf.layers[:-1]:
        w = l.linear.weight
        bound = math.sqrt(3.0 / w.shape[1])
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
        assert not l.linear.bias.any()
    assert not brdf.layers[-1].weight.any() and not brdf.layers[-1].bias.any()
    first = TF.BRDFMLP(multires_view=0, generator=g).layers[0].linear.weight
    assert first.abs().max() <= 30.0 / 3 and first.abs().max() > 9.0
    light = TF.NeILFMLP(generator=g)
    assert light.layers[3].linear.out_features == 128 - 39 - 3
    assert light.layers[4].linear.in_features == 128
    assert not light.layers[-1].weight.any()
    np.testing.assert_allclose(light.layers[-1].bias.detach().numpy(),
                               math.log(1.5), rtol=1e-7)
    tex = TF.MLPTexture3D(AABB, generator=g)
    t = tex.encoding.table
    assert tuple(t.shape) == (16, 2 ** 19, 2)
    assert t.abs().max() <= 1e-4 and t.abs().max() > 0.99e-4
    for l in tex.layers:
        assert l.bias is None
        bound = math.sqrt(6.0 / l.weight.shape[1])
        assert l.weight.abs().max() <= bound
    env = TF.EnvmapMaterialNetwork(generator=g)
    assert [l.in_features for l in env.encoder_layers] == [63, 512, 512,
                                                           512, 512]
    assert env.decoder_layers[-1].out_features == 4
    std = env.encoder_layers[1].weight.std().item()
    assert abs(std - math.sqrt(1 / 512)) < 0.05 * math.sqrt(1 / 512)


def test_hash_grid_matches_jax():
    """x01 on 0, on 1 and inside: every level, dense (0-4) and hashed
    (5-15), within 1e-6 of the JAX encoding from the same table."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.uniform(0, 1, (40, 3)),
        [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1], [0.5, 1, 0]],
        np.clip(rng.uniform(0, 1, (15, 3)).round(1), 0, 1),
    ]).astype(np.float32)
    tnet = TF.HashGridEncoding()
    j = JF.HashGridEncoding()
    table = rng.uniform(-1, 1, (16, 2 ** 19, 2)).astype(np.float32)
    with torch.no_grad():
        tnet.table.copy_(torch.from_numpy(table))
    a = np.asarray(j.apply({"params": {"table": table}}, jnp.asarray(x)))
    b = tnet(torch.from_numpy(x)).detach().numpy()
    assert b.shape == (len(x), 32)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    res = tnet.resolutions
    assert res[0] == 16 and res[-1] == 4095
    dense = [(r + 1) ** 3 <= 2 ** 19 for r in res]
    assert dense == [True] * 5 + [False] * 11


def test_hash_grid_gradient_matches_jax():
    """The table's gradient (the scatter-add of 16 levels × 8 corners) at
    a 2^14 table, so that JAX forms it quickly: levels 0-1 dense, 2-15
    hashed; output and gradient in float64 within rtol 1e-5 / 1e-4."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.uniform(0, 1, (60, 3)),
                        [[0, 0, 0], [1, 1, 1], [0, 1, 0.25],
                         [1, 0.5, 0]]]).astype(np.float64)
    table = rng.uniform(-1, 1, (16, 2 ** 14, 2))
    w = rng.normal(size=(len(x), 32))
    j = JF.HashGridEncoding(log2_hashmap_size=14)
    with jax.enable_x64(True):
        def jloss(t):
            return jnp.sum(j.apply({"params": {"table": t}},
                                   jnp.asarray(x)) * w)

        a = np.asarray(j.apply({"params": {"table": jnp.asarray(table)}},
                               jnp.asarray(x)))
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tnet = TF.HashGridEncoding(log2_hashmap_size=14).double()
    with torch.no_grad():
        tnet.table.copy_(torch.from_numpy(table))
    b = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(b.detach().numpy(), a, rtol=1e-5, atol=1e-6)
    (b * torch.from_numpy(w)).sum().backward()
    assert np.count_nonzero(jg) > 1000
    np.testing.assert_allclose(tnet.table.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-6 * np.abs(jg).max())
    res = tnet.resolutions
    assert [(r + 1) ** 3 <= 2 ** 14 for r in res] == [True] * 2 + [False] * 14


def _loss_inputs():
    rng = np.random.default_rng(4)
    shp = (6, 4, 4)
    out = {
        "rgb": rng.uniform(0, 3, shp + (3,)),
        "diffuse_albedo": rng.uniform(0, 1, shp + (3,)),
        "random_xi_diffuse_albedo": rng.uniform(0, 1, shp + (3,)),
        "roughness": rng.uniform(0.09, 0.99, shp + (1,)),
        "random_xi_roughness": rng.uniform(0.09, 0.99, shp + (1,)),
        "brdf_grad": rng.normal(size=shp + (3,)),
        "kd_grad": rng.uniform(0, 0.1, shp + (1,)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["brdf_grad"][0, 0, 0] = 0.0  # the norm's zero (the 1e-12)
    gt = rng.uniform(0, 3, shp + (3,)).astype(np.float32)
    grad = rng.uniform(0, 2, shp + (1,)).astype(np.float32)
    latent = rng.normal(0, 2, (96, 32)).astype(np.float32)
    return out, gt, grad, latent


def _tt(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _jj(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_head_losses_match_jax():
    out, gt, grad, latent = _loss_inputs()
    t_out, j_out = _tt(out), _jj(out)
    tgt, jgt = torch.from_numpy(gt), jnp.asarray(gt)
    pairs = [(TL.kl_divergence(0.05, torch.from_numpy(latent)),
              JL.kl_divergence(0.05, jnp.asarray(latent)))]
    for kw in ({}, {"kl_weight": 0.5, "latent_smooth_weight": 0.2,
                    "loss_type": "L2"}):
        a = TL.inv_loss(t_out, tgt, torch.from_numpy(latent), **kw)
        b = JL.inv_loss(j_out, jgt, jnp.asarray(latent), **kw)
        assert set(a) == set(b)
        pairs += [(a[k], b[k]) for k in sorted(a)]
    pairs.append((TL.neilf_loss(t_out, tgt, torch.from_numpy(grad)),
                  JL.neilf_loss(j_out, jgt, jnp.asarray(grad))))
    for it in (0, 37, 100, 250):
        pairs.append((TL.nvdiffrec_loss(t_out, tgt, it),
                      JL.nvdiffrec_loss(j_out, jgt, jnp.asarray(float(it)))))
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    # the NeILF norm's gradient stays finite at a zero gradient
    bg = t_out["brdf_grad"].clone().requires_grad_(True)
    TL.neilf_loss(dict(t_out, brdf_grad=bg), tgt,
                  torch.from_numpy(grad)).backward()
    assert torch.isfinite(bg.grad).all()


def test_head_loss_aliases():
    out, gt, grad, latent = _loss_inputs()
    t_out, tgt = _tt(out), torch.from_numpy(gt)
    assert TL.InvLoss is TL.inv_loss and TL.NeILFLoss is TL.neilf_loss
    assert TL.NvDiffRecLoss is TL.nvdiffrec_loss
    a = TL.InvLoss(t_out, tgt, torch.from_numpy(latent))["loss"]
    b = JL.InvLoss(_jj(out), jnp.asarray(gt), jnp.asarray(latent))["loss"]
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    a = TL.NeILFLoss(t_out, tgt, torch.from_numpy(grad))
    b = JL.NeILFLoss(_jj(out), jnp.asarray(gt), jnp.asarray(grad))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    a = TL.NvDiffRecLoss(t_out, tgt, 60)
    b = JL.NvDiffRecLoss(_jj(out), jnp.asarray(gt), jnp.asarray(60.0))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("sched,epochs", [(1, 3), (2, 3), ([1, 1], 3),
                                          ([20, 20], 22), ([1, 2], 3)])
def test_lr_schedule_matches_optax(sched, epochs):
    """Every optimizer step's learning rate equals the JAX runner's optax
    schedule, and the Adam of head_adam steps at it.  optax forms the rate
    in float32 and the port in float64, so "equal" is to float32 rounding:
    within two float32 ulps (2^-22 relative); a step at the wrong epoch's
    rate would be off by the factor."""
    lr, factor, spe = 2e-3, 0.2, 4
    js = j_schedule(lr, sched, factor, spe)
    ts = make_lr_schedule(lr, sched, factor, spe)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sch = head_adam([p], lr, sched, factor, spe)
    for k in range(epochs * spe):
        want = float(np.float32(js(k)))
        np.testing.assert_allclose(ts(k), want, rtol=2.0 ** -22,
                                   err_msg=str(k))
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want,
                                   rtol=2.0 ** -22, err_msg=str(k))
        opt.step()
        sch.step()
    if sched == [20, 20]:  # the duplicate milestone compounds: 0.04
        np.testing.assert_allclose(ts(20 * spe), lr * 0.04, rtol=1e-12)
        assert ts(20 * spe - 1) == lr


def test_converter_rejects_mismatched_trees():
    tnet = TF.BRDFMLP(dims=(64,) * 8)
    params = JF.BRDFMLP(dims=(64,) * 8).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tnet.load_state_dict(convert.field_params_from_flax(params, tnet))
    with pytest.raises(ValueError):
        convert.field_params_from_flax(params, TF.BRDFMLP(dims=(64,) * 7))
    pair = torch.nn.ModuleDict({"brdf": tnet, "light": TF.NeILFMLP(
        dims=(64,) * 8)})
    with pytest.raises(ValueError, match="expected"):
        convert.field_params_from_flax({"brdf": params}, pair)
