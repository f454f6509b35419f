"""The plain references against themselves and against hand-worked
values, at a size a CPU test holds."""

import math

import numpy as np
import pytest
import torch

from port_bench.reference import bake_ref, mat_ref
from port_bench.tests import tiny


def test_hash_uniforms_lowbias32():
    # lowbias32 worked by hand in Python ints
    def h(x):
        x &= 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, ids = 1234567, [0, 5, 2**31 + 3]
    got = bake_ref.hash_uniforms(seed, torch.tensor(ids), 3)
    for i, idv in enumerate(ids):
        for c in range(3):
            want = (h(h(idv ^ h(seed)) + c) >> 8) / float(1 << 24)
            assert got[i, c].item() == pytest.approx(want, abs=0)


def test_hammersley():
    h = bake_ref.hammersley(8)
    assert np.allclose(h[:, 0], np.arange(8) / 8)
    assert np.allclose(h[:4, 1], [0.0, 0.5, 0.25, 0.75])


def test_prefiltered_constant_atlas():
    hdr = np.full((4, 4, 3), 0.3, np.float32)
    t = bake_ref.prefiltered_atlas(hdr, 2)
    assert t.shape == (8, 8, 3)
    # 0.3 in [0.25, 0.5): exponent -1, mantissa floor(0.3 * 2 * 255) = 153
    assert np.allclose(t, 153 * 0.5 / 255)


def test_closest_hit_of_a_known_triangle():
    class M:
        vertices = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1],
                             [0, 0, 2], [1, 0, 2], [0, 1, 2]], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        uvs = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
        uv_faces = np.array([[0, 1, 2], [0, 1, 2]], np.int32)

    s = bake_ref.Scene(M, np.ones((2, 2, 3), np.float32), "cpu")
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    t, u, v = s.closest_hits(torch.tensor([0.25, 0.25, 0.0]), d)
    assert t[0].item() == pytest.approx(1.0)
    assert math.isinf(t[1].item())
    assert (u[0].item(), v[0].item()) == pytest.approx((0.25, 0.25))
    geo = mat_ref.Geometry(M, "cpu", torch.float32)
    t2, f2, b1, b2 = geo.closest_hits(
        torch.tensor([[0.25, 0.25, 0.0], [0.25, 0.25, 1.5]]), d, 0.0,
        np.zeros(3))
    assert t2[0].item() == pytest.approx(1.0) and f2.tolist() == [0, 0]
    assert t2[1].item() == pytest.approx(0.5)


def test_cube_rays():
    r = mat_ref.cube_rays(np.zeros(3), 4)
    assert np.allclose(np.linalg.norm(r, axis=-1), 1.0)
    # the centre of the front face looks along +z, of the top along +y;
    # row 0 is the top of a face
    assert r[1, 1:3, 1:3, 2].min() > 0.8
    assert r[4, 1:3, 1:3, 1].min() > 0.8
    assert r[1, 0, :, 1].min() > 0 > r[1, -1, :, 1].max()


def test_bake_reference_repeats(tmp_path):
    from port_bench import scenes

    root, bench = tiny.make_root(tmp_path)
    import json

    with open(f"{root}/port_bench/configs/apartment.json") as f:
        cfg = json.load(f)
    sc = scenes.make(cfg)
    s = bake_ref.Scene(sc.mesh, sc.hdr_texture, "cpu")
    args = (sc.mesh, 48, 64, 0.01, [10, 20, 30], [12, 14, 16], [0, 1, 2],
            [5, 5, 6])
    a, cov = bake_ref.irradiance(s, *args)
    b, _ = bake_ref.irradiance(s, *args)
    assert torch.equal(a, b)
    assert (a >= 0).all() and a.sum() > 0


@pytest.mark.parametrize("cell", ["apartment-bake", "building-bake",
                                  "building-mat"])
def test_program_agrees_with_the_reference(tmp_path, cell):
    root, bench = tiny.make_root(tmp_path)
    out = tiny.run(root, bench, cell, seed=2**31 + 99)
    assert out["correct"], out["checks"]
