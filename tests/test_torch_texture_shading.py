"""Port vs JAX: the mip sampler (`ops/texture.py`), the shading functions
(`ops/shading.py`), `reflect_soa` and importance sampling with a
per-pixel roughness and injected samples (`ops/sampling.py`).

Inputs are numpy from a seed; the stochastic modes get the same injected
uniforms on both sides.  Tolerances: rtol 1e-5, atol 1e-6 for values and
for the gradient with respect to the texture (a gather's backward is a
scatter-add on both sides; the order of the sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.ops import sampling as JS
from texir_code_tpu.ops import shading as JH
from texir_code_tpu.ops import texture as JT
from texir_code_tpu_torch.ops import sampling as TS
from texir_code_tpu_torch.ops import shading as TH
from texir_code_tpu_torch.ops import texture as TT

RTOL, ATOL = 1e-5, 1e-6
B = 500


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        b.detach().numpy() if torch.is_tensor(b) else b,
        np.asarray(a), rtol=rtol, atol=atol,
    )


@pytest.fixture(scope="module")
def tex():
    rng = np.random.default_rng(4)
    return dict(
        tex=rng.uniform(0, 1, (32, 64, 3)).astype(np.float32),
        uv=rng.uniform(-0.1, 1.1, (B, 2)).astype(np.float32),
        lod=rng.uniform(-0.5, 7.5, B).astype(np.float32),
        rng3=rng.uniform(0, 1, (B, 3)).astype(np.float32),
        uv_img=rng.uniform(0, 1, (2, 8, 8, 2)).astype(np.float32),
        cot=rng.standard_normal((B, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("boundary", ["wrap", "clamp", "zero"])
def test_bilinear_sample(tex, boundary):
    a = JT.bilinear_sample(jnp.asarray(tex["tex"]), jnp.asarray(tex["uv"]),
                           boundary)
    b = TT.bilinear_sample(torch.from_numpy(tex["tex"]),
                           torch.from_numpy(tex["uv"]), boundary)
    _close(a, b)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample(tex, mode, padding):
    grid = tex["uv"] * 2.4 - 1.2
    a = JT.grid_sample(jnp.asarray(tex["tex"]), jnp.asarray(grid), mode=mode,
                       padding_mode=padding)
    b = TT.grid_sample(torch.from_numpy(tex["tex"]), torch.from_numpy(grid),
                       mode=mode, padding_mode=padding)
    _close(a, b)


def test_grid_sample_nearest_rounds_halves_up():
    """A tap exactly between two texels takes the upper one, as JAX's
    floor(x + 0.5): a one-pixel shift here moves segmentation edges."""
    t = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1)
    # x = ((g+1)·4 - 1)/2 = 1.5 at g = 0: between texels 1 and 2
    g = torch.tensor([[0.0, 0.0], [-0.5, 0.0]])
    out = TT.grid_sample(t, g, mode="nearest")
    ref = JT.grid_sample(jnp.asarray(t.numpy()), jnp.asarray(g.numpy()),
                         mode="nearest")
    assert out[:, 0].tolist() == [2.0, 1.0]
    _close(ref, out, rtol=0, atol=0)


def test_mip_pyramid_and_lod(tex):
    a = JT.build_mip_pyramid(jnp.asarray(tex["tex"]), 3)
    b = TT.build_mip_pyramid(torch.from_numpy(tex["tex"]), 3)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        _close(x, y)
    assert len(TT.build_mip_pyramid(torch.zeros(32, 64, 1))) == 6
    la = JT.compute_lod(jnp.asarray(tex["uv_img"]), 64, 128)
    lb = TT.compute_lod(torch.from_numpy(tex["uv_img"]), 64, 128)
    _close(la, lb)


MODES = {
    "exact": None,
    "stochastic_lod": lambda r: r[:, 0],
    "stochastic_bilinear": lambda r: r,
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_texture_sample_and_gradient(tex, mode):
    """texture_sample in its three modes, forward and the gradient of
    <out, cotangent> with respect to the base texture."""
    pick = MODES[mode]
    rng = None if pick is None else pick(tex["rng3"])

    def jf(t):
        pyr = JT.build_mip_pyramid(t, 13)
        out = JT.texture_sample(pyr, jnp.asarray(tex["uv"]),
                                jnp.asarray(tex["lod"]),
                                rng=None if rng is None else jnp.asarray(rng))
        return jnp.sum(out * tex["cot"]), out

    (_, out_j), g_j = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(tex["tex"]))
    t = torch.tensor(tex["tex"], requires_grad=True)
    pyr = TT.build_mip_pyramid(t, 13)
    out_t = TT.texture_sample(pyr, torch.from_numpy(tex["uv"]),
                              torch.from_numpy(tex["lod"]),
                              rng=None if rng is None else torch.from_numpy(rng))
    (out_t * torch.from_numpy(tex["cot"])).sum().backward()
    _close(out_j, out_t)
    _close(g_j, t.grad)
    assert float(t.grad.abs().sum()) > 0


def test_texture_sample_rejects_bad_rng(tex):
    pyr = TT.build_mip_pyramid(torch.from_numpy(tex["tex"]))
    with pytest.raises(ValueError, match="rng"):
        TT.texture_sample(pyr, torch.from_numpy(tex["uv"]),
                          torch.from_numpy(tex["lod"]),
                          rng=torch.zeros(B, 2))


# ---------------------------------------------------------------------------
# shading and sampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shade():
    rng = np.random.default_rng(8)
    s = 16

    def unit(*shape):
        v = rng.standard_normal(shape + (3,)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    n = unit(B)
    # views within ~60° of the normal, roughness ≥ 0.3 and u1 in
    # [0.05, 0.95]: no clamp of the estimator sits within float rounding
    # of its edge, where the two sides' gradients could legitimately part
    view = n + 0.5 * unit(B)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return dict(
        n=n, view=view, rough=rng.uniform(0.3, 0.9, B).astype(np.float32),
        samples=rng.uniform(0.05, 0.95, (B, s, 2)).astype(np.float32),
        light=rng.uniform(0, 3, (3, B, s)).astype(np.float32),
        x=rng.uniform(0, 1, (B, 3)).astype(np.float32),
        vdh=rng.uniform(0, 1, (B, s)).astype(np.float32), s=s,
    )


def _soa(a, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return tuple(conv(np.ascontiguousarray(a[..., k])) for k in range(3))


def test_hdr_helpers(shade):
    x = shade["x"] * 5
    xt = torch.from_numpy(x)
    _close(JH.hdr_scale(x), TH.hdr_scale(xt))
    _close(JH.hdr_scale(x, 2.0), TH.hdr_scale(xt, 2.0))
    _close(JH.tonemap(x - 1), TH.tonemap(xt - 1))
    _close(JH.rgb_to_intensity(x), TH.rgb_to_intensity(xt))
    _close(JH.mse_to_psnr(jnp.asarray(0.0123)),
           TH.mse_to_psnr(torch.tensor(0.0123)))
    for n in (1, 6, 8192, 12288):
        assert TH.get_mip_level(n) == JH.get_mip_level(n)


def test_brdf_terms(shade):
    vdh, r = shade["vdh"], shade["rough"][:, None]
    vt, rt = torch.from_numpy(vdh), torch.from_numpy(r)
    _close(JH.fresnel_schlick_ue4(vdh), TH.fresnel_schlick_ue4(vt))
    _close(JH.smith_g(vdh, 1 - vdh, r), TH.smith_g(vt, 1 - vt, rt))
    _close(JH.ggx_d(vdh, r), TH.ggx_d(vt, rt))
    x = shade["x"]
    _close(JH.lambertian_diffuse(x, x[::-1]),
           TH.lambertian_diffuse(torch.from_numpy(x),
                                 torch.from_numpy(x[::-1].copy())))


def test_importance_sampling_reflect_and_specular(shade):
    """GGX half-vectors from a per-pixel roughness and injected samples,
    the reflection, and the specular estimator (with its roughness
    gradient, which flows through the half-vectors)."""
    s = shade
    n_j, n_t = _soa(s["n"], "jax"), _soa(s["n"], "torch")
    v_j, v_t = _soa(s["view"], "jax"), _soa(s["view"], "torch")

    def jf(rough):
        half = JS.generate_dir_soa(n_j, s["s"], jax.random.PRNGKey(0),
                                   mode="importance", roughness=rough,
                                   samples=jnp.asarray(s["samples"]))
        light, vdh = JS.reflect_soa(v_j, half)
        spec = JH.specular_estimator_soa(
            tuple(jnp.asarray(a) for a in s["light"]), half, n_j, v_j,
            light, rough)
        return jnp.sum(jnp.stack(spec)), (half, light, vdh, spec)

    (_, (half_j, light_j, vdh_j, spec_j)), g_j = jax.value_and_grad(
        jf, has_aux=True)(jnp.asarray(s["rough"]))
    rough_t = torch.tensor(s["rough"], requires_grad=True)
    half_t = TS.generate_dir_soa(n_t, s["s"], mode="importance",
                                 roughness=rough_t,
                                 samples=torch.from_numpy(s["samples"]))
    light_t, vdh_t = TS.reflect_soa(v_t, half_t)
    spec_t = TH.specular_estimator_soa(
        tuple(torch.from_numpy(a) for a in s["light"]), half_t, n_t, v_t,
        light_t, rough_t)
    torch.stack(spec_t).sum().backward()
    # directions: sin θ = sqrt(1 - cos²θ) turns a one-ulp difference of
    # cos θ (the two sides' sqrt/sin/cos round differently) into up to
    # ~3e-6 near the pole, hence atol 1e-5 on the unit vectors
    for a, b in zip(half_j + light_j + (vdh_j,), half_t + light_t + (vdh_t,)):
        _close(a, b, atol=1e-5)
    for a, b in zip(spec_j, spec_t):
        _close(a, b)
    _close(g_j, rough_t.grad)


def test_irradiance_estimator(shade):
    s = shade
    d_j = JS.generate_dir_soa(_soa(s["n"], "jax"), s["s"],
                              jax.random.PRNGKey(0),
                              samples=jnp.asarray(s["samples"]))
    d_t = TS.generate_dir_soa(_soa(s["n"], "torch"), s["s"],
                              samples=torch.from_numpy(s["samples"]))
    a = JH.irradiance_estimator_soa(tuple(jnp.asarray(x) for x in s["light"]),
                                    d_j, _soa(s["n"], "jax"), s["s"])
    b = TH.irradiance_estimator_soa(tuple(torch.from_numpy(x) for x in s["light"]),
                                    d_t, _soa(s["n"], "torch"), s["s"])
    for x, y in zip(a, b):
        _close(x, y)


# ---------------------------------------------------------------------------
# pano ↔ cube warps
# ---------------------------------------------------------------------------


def test_pano_cube_warp_sharp_edges():
    """A pano of class ids with sharp edges: the nearest warp puts every id
    on the same cube pixel as JAX's (its rounding of ties included), and
    the bilinear warps agree in both directions."""
    from texir_code_tpu.ops.pano import PanoCubeWarp as JW
    from texir_code_tpu_torch.ops.pano import PanoCubeWarp as TW

    rng = np.random.default_rng(12)
    h, w, cube = 32, 64, 16
    ids = np.repeat(np.repeat(rng.integers(0, 9, (8, 16)), 4, 0), 4, 1)
    pano = np.concatenate(
        [ids[..., None].astype(np.float32),
         rng.uniform(0, 1, (h, w, 2)).astype(np.float32)], -1)
    jw, tw = JW(h, w, cube), TW(h, w, cube)
    for mode in ("nearest", "bilinear"):
        a = np.asarray(jw.to_cube(jnp.asarray(pano), mode=mode))
        b = tw.to_cube(torch.from_numpy(pano), mode=mode).numpy()
        if mode == "nearest":
            assert np.array_equal(a, b)
        _close(a, b)
    faces = rng.uniform(0, 1, (6, cube, cube, 3)).astype(np.float32)
    _close(jw.to_pano(jnp.asarray(faces)),
           tw.to_pano(torch.from_numpy(faces)))
