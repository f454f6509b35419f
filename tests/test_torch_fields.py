"""Port vs JAX: the field stages' networks and math on the CPU.

  * `models/fields.py`: the positional encodings, and MatNetwork,
    IRNetwork and PILNetwork at their default widths, with the flax
    weights carried across by `convert.field_params_from_flax`: outputs
    within rtol 1e-5 / atol 1e-6, parameter gradients within rtol 1e-4
    (both packages in float64); in float32 outputs within rtol 1e-5 /
    atol 1e-5; the port's initialisation draws from flax's distributions,
    biases 0.
  * `train.exp.adam_staircase` over a MatNetwork's parameters against
    optax.adam with the staircase decay: six steps, weights within 1e-6.
  * The AoS sampling helpers (`normalize`, `build_onb`, `generate_dir` with
    injected samples in every mode, `reflect`), `irradiance_estimator`,
    `hdr_recover` and `irf_loss` / `IRFLoss`: within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.models import fields as JF
from texir_code_tpu.models import losses as JL
from texir_code_tpu.ops import sampling as JS
from texir_code_tpu.ops import shading as JSh
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import fields as TF
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.ops import sampling as TS
from texir_code_tpu_torch.ops import shading as TSh

torch.set_num_threads(2)  # six test workers share the host's cores

B = 64


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _inputs(n_args, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 2.5, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rough = rng.uniform(0.05, 0.95, (B, 1)).astype(np.float32)
    return [pts, d, rough][:n_args]


NETWORKS = {
    # name: (flax module, port module, number of inputs)
    "MatNetwork": (JF.MatNetwork, TF.MatNetwork, 1),
    "IRNetwork": (JF.IRNetwork, TF.IRNetwork, 2),
    "PILNetwork": (JF.PILNetwork, TF.PILNetwork, 3),
}


@pytest.mark.parametrize("num_freqs,include", [(10, True), (4, True),
                                               (6, False)])
def test_positional_encoding_matches_jax(num_freqs, include):
    x = _inputs(1)[0]
    a = np.asarray(JF.positional_encoding(jnp.asarray(x), num_freqs, include))
    b = TF.positional_encoding(_t(x), num_freqs, include).numpy()
    assert b.shape[-1] == TF.pe_dim(3, num_freqs, include) == \
        JF.pe_dim(3, num_freqs, include)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    if not include:
        np.testing.assert_array_equal(
            TF.frequency_encoding(_t(x), num_freqs).numpy(), b)


def _same_weights(name, dtype):
    """(flax module, its params, the port module with the same weights,
    the inputs), all in `dtype`."""
    jcls, tcls, n = NETWORKS[name]
    jnet, tnet = jcls(), tcls()
    args = [a.astype(dtype) for a in _inputs(n)]
    params = jnet.init(jax.random.PRNGKey(3),
                       *[jnp.zeros((1, a.shape[1])) for a in args])
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), params)
    tnet.load_state_dict(convert.field_params_from_flax(params, tnet))
    return jnet, params, tnet.to(torch.float64 if dtype == np.float64
                                 else torch.float32), args


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_flax(name):
    """The same function: outputs within rtol 1e-5 / atol 1e-6 and
    parameter gradients within rtol 1e-4, both packages in float64 (in
    float32 each package's own rounding is larger: see the next test)."""
    with jax.enable_x64(True):
        jnet, params, tnet, args = _same_weights(name, np.float64)
        w = np.random.default_rng(1).normal(size=(B, 3))

        def jloss(p):
            return jnp.sum(jnet.apply(p, *map(jnp.asarray, args)) * w)

        a = np.asarray(jnet.apply(params, *map(jnp.asarray, args)))
        jg = jax.grad(jloss)(params)["params"]
    assert a.dtype == np.float64
    out = tnet(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.detach().numpy(), a, rtol=1e-5, atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    for i, layer in enumerate(tnet.layers):
        g = jg[f"Dense_{i}"]
        np.testing.assert_allclose(layer.weight.grad.numpy(),
                                   np.asarray(g["kernel"]).T, rtol=1e-4,
                                   atol=1e-6 * np.abs(g["kernel"]).max(),
                                   err_msg=f"Dense_{i} kernel")
        np.testing.assert_allclose(layer.bias.grad.numpy(),
                                   np.asarray(g["bias"]), rtol=1e-4,
                                   atol=1e-6 * np.abs(g["bias"]).max(),
                                   err_msg=f"Dense_{i} bias")


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_flax_fp32(name):
    """In float32, as the stages run: outputs within rtol 1e-5 / atol
    1e-5.  On MatNetwork (4×512) each package's float32 output sits
    1.8e-6 (port) and 2.9e-6 (flax) from the float64 one; the two differ
    by 2.3e-6, beyond an atol of 1e-6."""
    jnet, params, tnet, args = _same_weights(name, np.float32)
    a = np.asarray(jnet.apply(params, *map(jnp.asarray, args)))
    out = tnet(*map(torch.from_numpy, args)).detach().numpy()
    np.testing.assert_allclose(out, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_init_follows_flax(name):
    """Each layer's weights from flax's distribution (Kaiming-uniform
    for MatNetwork, the truncated lecun-normal otherwise), biases zero."""
    jcls, tcls, n = NETWORKS[name]
    args = _inputs(n)
    params = jcls().init(jax.random.PRNGKey(0),
                         *[jnp.zeros((1, a.shape[1])) for a in args])
    tnet = tcls(generator=torch.Generator().manual_seed(0))
    for i, layer in enumerate(tnet.layers):
        k = np.asarray(params["params"][f"Dense_{i}"]["kernel"])
        w = layer.weight.detach().numpy()
        fan_in = k.shape[0]
        assert w.shape == k.T.shape
        assert not layer.bias.detach().any()
        if name == "MatNetwork":  # uniform on ±sqrt(6 / fan_in)
            bound = np.sqrt(6.0 / fan_in)
            assert np.abs(w).max() <= bound and np.abs(k).max() <= bound
        else:  # truncated at two deviations of the underlying normal
            bound = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert np.abs(w).max() <= bound * (1 + 1e-6)
            assert np.abs(k).max() <= bound * (1 + 1e-6)
        # the standard deviations agree within the sampling error
        np.testing.assert_allclose(w.std(), k.std(),
                                   rtol=6 / np.sqrt(min(w.size, 4096)))


def test_field_params_from_flax_checks_shapes():
    params = JF.MatNetwork(dims=(8, 8)).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 3)))
    params = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="shape"):
        convert.field_params_from_flax(params, TF.MatNetwork(dims=(8, 16)))
    with pytest.raises(ValueError, match="Dense_0"):
        convert.field_params_from_flax(params, TF.MatNetwork(dims=(8, 8, 8)))
    net = TF.MatNetwork(dims=(8, 8))
    net.load_state_dict(convert.field_params_from_flax(params["params"], net))


def test_adam_staircase_matches_optax_on_network():
    """`train.exp.adam_staircase` over a field network's parameters
    against the JAX runners' optax.adam with the staircase decay: six steps
    from the same weights and gradients, across two decays."""
    import optax

    from texir_code_tpu_torch.train.exp import adam_staircase

    rng = np.random.default_rng(4)
    net = TF.MatNetwork(points_multires=2, dims=(16, 16))
    params = {f"Dense_{i}": {  # a flax params tree of the network's shapes
        "kernel": rng.standard_normal(layer.weight.T.shape, np.float32),
        "bias": rng.standard_normal(layer.bias.shape, np.float32)}
        for i, layer in enumerate(net.layers)}
    net.load_state_dict(convert.field_params_from_flax(params, net))
    lr, sched_step, factor, steps_per_epoch = 1e-2, 1, 0.5, 2
    opt = optax.adam(optax.exponential_decay(
        lr, transition_steps=sched_step * steps_per_epoch,
        decay_rate=factor, staircase=True))

    @jax.jit
    def jstep(p, s, g):
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s

    state = opt.init(params)
    topt, tsched = adam_staircase(net.parameters(), lr, sched_step, factor,
                                  steps_per_epoch)
    for _ in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            params)
        params, state = jstep(params, state, grads)
        params = jax.tree_util.tree_map(np.asarray, params)
        for name, g in convert.field_params_from_flax(grads, net).items():
            net.get_parameter(name).grad = g
        topt.step()
        tsched.step()
    for name, want in convert.field_params_from_flax(params, net).items():
        np.testing.assert_allclose(net.get_parameter(name).detach().numpy(),
                                   want.numpy(), atol=1e-6)


def test_aos_helpers_match_jax():
    pts, d, _ = _inputs(3)
    x = pts * 3
    np.testing.assert_allclose(TS.normalize(_t(x)).numpy(),
                               np.asarray(JS.normalize(jnp.asarray(x))),
                               atol=1e-6)
    d[:4] = [[1, 0, 0], [-1, 0, 0], [0.995, 0.0998, 0], [0, 1, 0]]
    for a, b in zip(TS.build_onb(_t(d)), JS.build_onb(jnp.asarray(d))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    half = np.random.default_rng(5).normal(size=(B, 7, 3)).astype(np.float32)
    for a, b in zip(TS.reflect(_t(d), _t(half)),
                    JS.reflect(jnp.asarray(d), jnp.asarray(half))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("mode", ["uniform", "cosine", "importance"])
def test_generate_dir_with_injected_samples(mode):
    _, nrm, rough = _inputs(3)
    s = 33
    key = jax.random.PRNGKey(7)
    row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B))
    samples = np.asarray(JS.stratified_samples(key, B, s, row_keys=row_keys))
    a = np.asarray(JS.generate_dir(
        jnp.asarray(nrm), s, key, mode=mode, roughness=jnp.asarray(rough),
        row_keys=row_keys))
    b = TS.generate_dir(_t(nrm), s, mode=mode, roughness=_t(rough),
                        samples=_t(samples)).numpy()
    assert b.shape == (B, s, 3)
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_estimator_and_losses_match_jax():
    rng = np.random.default_rng(9)
    _, nrm, _ = _inputs(3)
    light = rng.uniform(0, 4, (B, 32, 3)).astype(np.float32)
    dirs = rng.normal(size=(B, 32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = np.asarray(JSh.irradiance_estimator(
        jnp.asarray(light), jnp.asarray(dirs), jnp.asarray(nrm), 32))
    np.testing.assert_allclose(
        TSh.irradiance_estimator(_t(light), _t(dirs), _t(nrm), 32).numpy(),
        a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TSh.irradiance_estimator(_t(light), _t(dirs), _t(nrm)).numpy(),
        a, rtol=1e-6, atol=1e-6)
    x = rng.uniform(-0.5, 3.0, (B, 3)).astype(np.float32)
    np.testing.assert_allclose(TSh.hdr_recover(_t(x)).numpy(),
                               np.asarray(JSh.hdr_recover(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    gt = rng.uniform(0, 5, (B, 3)).astype(np.float32)
    for lt in ("L1", "L2"):
        a = float(JL.irf_loss(jnp.asarray(gt), jnp.asarray(x), lt))
        b = float(TL.irf_loss(_t(gt), _t(x), lt))
        assert abs(b - a) <= 1e-6 * max(1.0, abs(a)), lt
        c = float(TL.IRFLoss(lt)({"gt": _t(gt), "pred": _t(x)}))
        assert c == b
