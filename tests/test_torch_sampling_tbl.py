"""Port vs JAX: sampling, direction wedges, RGBE atlas fetches, the
irradiance estimator and the Morton order.

Integer and bit-level work (Hammersley, sorting, wedges, RGBE packing and
fetch indices, Morton codes) is compared exactly.  Floating chains that
call sin/cos or reduce sums are held to a few float32 ulps: XLA's and
PyTorch's transcendental kernels may differ in the last bit, and sums may
be taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.models import tbl as JT
from texir_code_tpu.models.tracer_irt import morton_order as j_morton
from texir_code_tpu.ops import pallas_culled as JC
from texir_code_tpu.ops import sampling as JS
from texir_code_tpu.ops.shading import irradiance_estimator_soa as j_irr
from texir_code_tpu_torch.models import tbl as TT
from texir_code_tpu_torch.models.tracer_irt import morton_order as t_morton
from texir_code_tpu_torch.ops import pallas_culled as TC
from texir_code_tpu_torch.ops import sampling as TS
from texir_code_tpu_torch.ops.shading import irradiance_estimator_soa as t_irr

torch.set_num_threads(2)  # six test workers share the host's cores


def _normals(rng, b):
    n = rng.standard_normal((b, 3)).astype(np.float32)
    n[0] = [1.0, 0.0, 0.0]  # exercises the |n.x| > 0.99 helper axis
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _j3(a):
    return tuple(jnp.asarray(a[..., k]) for k in range(3))


def _t3(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[..., k]))
                 for k in range(3))


@pytest.mark.parametrize("mode", ["uniform", "cosine", "importance"])
def test_generate_dir_soa_matches_jax(rng, mode):
    nrm = _normals(rng, 40)
    samples = rng.random((40, 256, 2)).astype(np.float32)
    rough = rng.random(40).astype(np.float32)
    a = JS.generate_dir_soa(_j3(nrm), 256, jax.random.PRNGKey(0), mode=mode,
                            roughness=jnp.asarray(rough),
                            samples=jnp.asarray(samples))
    b = TS.generate_dir_soa(_t3(nrm), 256, mode=mode,
                            roughness=torch.from_numpy(rough),
                            samples=torch.from_numpy(samples))
    # sin/cos/sqrt may differ by an ulp or two between the libraries; near
    # the pole (GGX importance at low roughness) sinθ = sqrt(1 - cos²θ)
    # amplifies one ulp of cosθ about 40-fold
    atol = 5e-6 if mode == "importance" else 1e-6
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=atol)


def test_onb_and_hammersley_match_jax(rng):
    nrm = _normals(rng, 64)
    for x, y in zip(JS.build_onb_soa(_j3(nrm)), TS.build_onb_soa(_t3(nrm))):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(JS.hammersley(512)),
                                  TS.hammersley(512).numpy())


@pytest.mark.parametrize("n", [512, 2048, 1000])
def test_hammersley_tables_bit_equal_jax(n):
    i = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
    np.testing.assert_array_equal(JS.radical_inverse_np(i),
                                  TS.radical_inverse_np(i))
    np.testing.assert_array_equal(JS.hammersley_np(n), TS.hammersley_np(n))
    az = TS.hammersley_azimuth_sorted(n, "cpu")
    assert az.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(JS.hammersley_azimuth_sorted(n)),
                                  az.numpy())
    # the same sample set as hammersley (ordered by u2), whose values the
    # port's device table keeps
    np.testing.assert_array_equal(TS.hammersley(n).numpy(),
                                  TS.hammersley_np(n))
    assert (np.diff(az[:, 1].numpy()) >= 0).all()


def test_row_keyed_samples_do_not_depend_on_batching():
    ids = torch.arange(1000, 1064)
    whole = TS.stratified_samples(64, 128, row_ids=ids, seed=7)
    parts = torch.cat([
        TS.stratified_samples(16, 128, row_ids=ids[i:i + 16], seed=7)
        for i in range(0, 64, 16)
    ])
    assert torch.equal(whole, parts)
    assert not torch.equal(
        whole, TS.stratified_samples(64, 128, row_ids=ids, seed=8))
    ind = TS.stratified_samples(64, 128, "independent", row_ids=ids, seed=7)
    assert ind.shape == (64, 128, 2)
    # the shift is uniform: mean ~0.5 over many rows
    many = TS.stratified_samples(4096, 1, row_ids=torch.arange(4096), seed=3)
    assert abs(float(many.mean()) - 0.5) < 0.02
    # without row ids the draws come from the caller's generator
    a = TS.stratified_samples(8, 64, generator=torch.Generator().manual_seed(1))
    b = TS.stratified_samples(8, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (8, 64, 2)


def test_sort_dirs_octant_matches_jax(rng):
    d = rng.standard_normal((12, 512, 3)).astype(np.float32)
    d[:, ::7, 0] = 0.0  # zero components sort with the positive side
    a = JC.sort_dirs_octant(_j3(d))
    b = TC.sort_dirs_octant(_t3(d))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_wedge_tile_rows_match_jax():
    x = np.arange(6 * 512, dtype=np.float32).reshape(6, 512)
    w = TC.wedge_rows(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(np.asarray(JC.wedge_rows(jnp.asarray(x), 4)),
                                  w.numpy())
    np.testing.assert_array_equal(TC.unwedge_rows(w, 4).numpy(), x)
    t = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(JC.tile_rows(jnp.asarray(t), 4)),
                                  TC.tile_rows(torch.from_numpy(t), 4).numpy())


@pytest.fixture
def atlas(rng):
    tex = (rng.random((32, 48, 3)) ** 3 * 30).astype(np.float32)
    tex[0, 0] = 0.0
    tex[1, 1] = [4.0, 2.0, 1.0]     # exact powers of two
    tex[2, 2] = [0.5, 0.25, 1e-3]
    return tex


def test_rgbe_pack_decode_match_jax(atlas):
    a = np.asarray(JT.rgbe_pack(jnp.asarray(atlas)))
    b = TT.rgbe_pack(torch.from_numpy(atlas)).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b)
    for x, y in zip(JT.rgbe_decode(jnp.asarray(a)),
                    TT.rgbe_decode(torch.from_numpy(b))):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_rgbe_prefilter_and_fetches_match_jax(atlas, rng):
    planes = tuple(np.ascontiguousarray(atlas[..., k]) for k in range(3))
    a = np.asarray(JT.rgbe_prefilter(tuple(map(jnp.asarray, planes)), 2))
    b = TT.rgbe_prefilter(tuple(map(torch.from_numpy, planes)), 2)
    np.testing.assert_array_equal(a.view(np.int32), b.numpy())
    u = rng.random(2000).astype(np.float32)
    v = rng.random(2000).astype(np.float32)
    u[:2], v[:2] = (0.0, 1.0), (1.0, 0.0)
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), torch.from_numpy(u), \
        torch.from_numpy(v)
    packed = np.asarray(JT.rgbe_pack(jnp.asarray(atlas)))
    pairs = [
        (JT.nearest_rgbe(jnp.asarray(a), ju, jv),
         TT.nearest_rgbe(b, tu, tv)),
        (JT.bilinear_rgbe(jnp.asarray(packed), ju, jv),
         TT.bilinear_rgbe(torch.from_numpy(packed.view(np.int32).copy()), tu,
                         tv)),
        (JT._bilinear_planes(tuple(map(jnp.asarray, planes)), ju, jv),
         TT._bilinear_planes(tuple(map(torch.from_numpy, planes)), tu, tv)),
    ]
    for ja, tb in pairs:
        for x, y in zip(ja, tb):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_irradiance_estimator_matches_jax(rng):
    nrm = _normals(rng, 40)
    light = rng.random((40, 256, 3)).astype(np.float32)
    dirs = rng.standard_normal((40, 256, 3)).astype(np.float32)
    a = j_irr(_j3(light), _j3(dirs), _j3(nrm), 256)
    b = t_irr(_t3(light), _t3(dirs), _t3(nrm), 256)
    for x, y in zip(a, b):
        # a 256-term float32 sum, reduced in another order
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=1e-5)


def test_morton_order_matches_jax(rng):
    pts = rng.random((5000, 3)).astype(np.float32) * [8.0, 3.0, 5.0]
    pts[100:200] = pts[100]  # ties keep their order (stable)
    np.testing.assert_array_equal(j_morton(pts), t_morton(pts))
