"""Port vs JAX: the skip-link BVH traversal (`ops/raycast.py::
cast_rays_soa`, `DeviceBVH`), the BVH queries of `models/tbl.py`
(`query_tbl_soa`, `query_tbl`, `query_tbl_multi`, and `query_tbl_auto`
with no scene), the leaf-budgeted fan trace (`ops/fan_raycast.py::
cast_ray_fans`, `cast_ray_fans_exact`) and the baker's traversal and
leaf-budgeted branches (`models/tracer_irt.py`).

The scene is the JAX tests' small apartment (`make_apartment_scene(
atlas_res=64, subdiv=6)`), its BVH built by the JAX package and handed to
the port as the same supernode table.  The JAX side runs on the CPU, where
its queries and baker take the BVH route (XLA, no Pallas kernel).

Tolerances: prim equal except on exact-t ties (two triangles at one t, at
most 1e-2 of the rays; t then within 1e-6); t, u and v within 1e-6
relative (u/v: of max(1, |v|)) — the two packages run the same operations
in the same order, and XLA contracts a multiply-add that the port rounds
twice.  The fan trace's own hits (the plane-dual formula) hold u/v within
1e-5, as tests/test_torch_fan.py says why.  Radiance: the port's fetch of
JAX's hit records within rtol 1e-5 on every ray; end to end within rtol
1e-5 on all but 10 of the 2048 rays (7 and 5 here), within 1e-3 on those,
and within relative L2 1e-5 overall: the hits' u/v round apart by ~1e-7,
and across a texel of this 64² HDR atlas next to an emitter such a step
moves a bilinear fetch by up to 5e-4.  Bake texels within rtol 1e-5 on JAX's own
uniforms (PERF.md §2, "Bake correctness").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.export import pano_dirs
from texir_code_tpu.data.synthetic import make_apartment_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.models import tbl as JT
from texir_code_tpu.models.tracer_irt import IrradianceTextureBaker as JBaker
from texir_code_tpu.models.tracer_irt import bake_geometry_textures, morton_order
from texir_code_tpu.ops import fan_raycast as JF
from texir_code_tpu.ops import raycast as JR
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.geometry.bvh import FlatBVH
from texir_code_tpu_torch.models import tbl as TT
from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker as TBaker
from texir_code_tpu_torch.ops import fan_raycast as TF
from texir_code_tpu_torch.ops import raycast as TR

torch.set_num_threads(2)  # six test workers share the host's cores

N_RAYS = 2048
TEXELS, SPP, SEED = 12, 128, 41
TIE_FRAC = 1e-2
RAD_OFF_MAX = 10  # of the 2048 rays of each radiance query (read: 7 and 5)


@pytest.fixture(scope="module")
def scene():
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    fb = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    jt = JT.build_tbl_from_flat(fb, syn.mesh, syn.hdr_texture)
    tfb = FlatBVH(**{f: getattr(fb, f) for f in (
        "aabb_min", "aabb_max", "miss", "leaf_start", "leaf_count", "tri_p0",
        "tri_e1", "tri_e2", "tri_prim", "leaf_width")})
    tt = convert.tbl_from_numpy(
        np.asarray(jt.uv_u), np.asarray(jt.uv_v),
        [np.asarray(p) for p in jt.planes], device="cpu",
        packed=np.asarray(jt.bvh.packed))
    fan = JF.FanScene.from_flat(fb, triangle_uvs=syn.mesh.triangle_uvs())
    tfan = TF.FanScene(rows=np.array(fan.rows),
                       diameter=float(fan.diameter_np))
    rng = np.random.default_rng(5)
    lo, hi = syn.mesh.vertices.min(0), syn.mesh.vertices.max(0)
    o = rng.uniform(lo + 0.2, hi - 0.2, (N_RAYS, 3)).astype(np.float32)
    o[::4] = rng.uniform(lo - 2, hi + 2, (N_RAYS // 4, 3))  # outside, too
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d[::9, 2] = 0.0  # zero components: the slab test's huge inverse
    cam = syn.camera_positions(1)[0]
    pd = pano_dirs(32, 64).reshape(-1, 3)
    rays = {
        "random": (o, d),
        "pano": (np.broadcast_to(cam, pd.shape).astype(np.float32), pd),
    }
    return dict(syn=syn, fb=fb, tfb=tfb, jt=jt, tt=tt, fan=fan, tfan=tfan,
                rays=rays)


def _agree(got, ref, uv_tol=1e-6):
    """The port's RayHit against JAX's (numpy arrays t, prim, u, v)."""
    t, prim, u, v = (getattr(got, f).numpy() for f in ("t", "prim", "u", "v"))
    rt, rp, ru, rv = (np.asarray(getattr(ref, f))
                      for f in ("t", "prim", "u", "v"))
    fin = np.isfinite(rt)
    assert np.array_equal(np.isfinite(t), fin)
    assert (np.abs(t[fin] - rt[fin]) <= 1e-6 * np.abs(rt[fin])).all()
    tie = prim != rp
    assert tie.mean() <= TIE_FRAC
    assert fin[tie].all()
    for a, b in ((u, ru), (v, rv)):
        assert (np.abs(a - b)[~tie]
                <= uv_tol * np.maximum(np.abs(b), 1.0)[~tie]).all()
    return fin.mean()


def _soa(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[..., k]))
                 for k in range(3))


def test_device_bvh_packs_the_jax_table(scene):
    port = TR.DeviceBVH.from_flat(scene["tfb"], device="cpu")
    assert port.leaf_width == scene["jt"].bvh.leaf_width == 4
    assert np.array_equal(port.packed.numpy().view(np.int32),
                          np.asarray(scene["jt"].bvh.packed).view(np.int32))


@pytest.mark.parametrize("kind", ["random", "pano"])
def test_cast_rays_soa_matches_jax(scene, kind):
    o, d = scene["rays"][kind]
    ref = JR.cast_rays(scene["jt"].bvh, jnp.asarray(o), jnp.asarray(d),
                       t_min=1e-5)
    got = TR.cast_rays(scene["tt"].bvh, torch.from_numpy(o),
                       torch.from_numpy(d), t_min=1e-5)
    assert _agree(got, ref) > 0.5


@pytest.mark.parametrize("max_iters", [1, 7, 40])
def test_max_iters_bound_matches_jax(scene, max_iters):
    o, d = scene["rays"]["random"]
    ref = JR.cast_rays(scene["jt"].bvh, jnp.asarray(o), jnp.asarray(d),
                       max_iters=max_iters)
    got = TR.cast_rays_soa(scene["tt"].bvh, _soa(o), _soa(d),
                           max_iters=max_iters, check_every=3)
    assert TR.cast_rays_soa.stats["iterations"] <= max_iters
    _agree(got, ref)


def test_cast_rays_soa_matches_brute_force(scene):
    o, d = scene["rays"]["random"]
    syn = scene["syn"]
    got = TR.cast_rays(scene["tt"].bvh, torch.from_numpy(o),
                       torch.from_numpy(d))
    ref = TR.cast_rays_brute(torch.from_numpy(syn.mesh.vertices).float(),
                             torch.from_numpy(syn.mesh.faces),
                             torch.from_numpy(o), torch.from_numpy(d))
    fin = torch.isfinite(ref.t)
    assert torch.equal(torch.isfinite(got.t), fin)
    rel = (got.t[fin] - ref.t[fin]).abs() / ref.t[fin]
    assert rel.max() <= 1e-5
    tie = (got.prim != ref.prim)[fin]
    assert tie.float().mean() <= TIE_FRAC
    assert (rel[tie] <= 1e-6).all()


def test_sync_interval_and_compaction_change_no_hit(scene):
    """The host reads the loop condition every check_every iterations and
    drops finished rays from the working set: every hit bit-equal to a
    check after each iteration with no compaction."""
    o, d = scene["rays"]["random"]
    bvh = scene["tt"].bvh
    base = TR.cast_rays_soa(bvh, _soa(o), _soa(d), check_every=1,
                            compact=False)
    iters = TR.cast_rays_soa.stats["iterations"]
    for every, compact in ((8, True), (5, False), (1, True)):
        got = TR.cast_rays_soa(bvh, _soa(o), _soa(d), check_every=every,
                               compact=compact)
        stats = TR.cast_rays_soa.stats
        assert iters <= stats["iterations"] < iters + every
        assert stats["syncs"] == -(-stats["iterations"] // every)
        assert (stats["compactions"] > 0) == compact
        for f in ("t", "prim", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(base, f)), f


def _radiance_agrees(got, ref):
    """End-to-end radiance: rtol 1e-5 (atol 1e-6) on all but RAD_OFF_MAX
    rays, 1e-3 on those, relative L2 1e-5 overall."""
    ok = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(axis=-1)
    assert int((~ok).sum()) <= RAD_OFF_MAX
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


def test_query_tbl_soa_multi_and_auto_match_jax(scene):
    o, d = scene["rays"]["random"]
    ref = np.asarray(JT.query_tbl(scene["jt"], jnp.asarray(o),
                                  jnp.asarray(d)))
    got = TT.query_tbl(scene["tt"], torch.from_numpy(o), torch.from_numpy(d))
    assert (ref > 0).mean() > 0.3
    _radiance_agrees(got.numpy(), ref)
    ref_hit = JR.cast_rays(scene["jt"].bvh, jnp.asarray(o), jnp.asarray(d))
    # the fetch itself, on JAX's own hit records
    fetched = TT.radiance_from_hit(scene["tt"], TR.RayHit(*(
        torch.from_numpy(np.array(getattr(ref_hit, f)))
        for f in ("t", "prim", "u", "v"))))
    np.testing.assert_allclose(torch.stack(fetched, dim=-1).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    auto = TT.query_tbl_auto(scene["tt"], _soa(o), _soa(d), None)
    assert torch.equal(torch.stack(auto, dim=-1), got)

    pts, dm = o[:256], d[:256 * 8].reshape(256, 8, 3)
    ref = np.asarray(JT.query_tbl_multi(scene["jt"], jnp.asarray(pts),
                                        jnp.asarray(dm)))
    got = TT.query_tbl_multi(scene["tt"], torch.from_numpy(pts),
                             torch.from_numpy(dm))
    assert got.shape == (256, 8, 3)
    _radiance_agrees(got.numpy(), ref)


@pytest.fixture(scope="module")
def bake(scene):
    """One bake batch of texels and JAX's own uniforms for them."""
    syn = scene["syn"]
    geom = bake_geometry_textures(syn.mesh, 32)
    vr, vc = np.nonzero(geom.valid)
    order = morton_order(geom.position[vr, vc])
    sel = order[:: len(order) // TEXELS][:TEXELS]
    pts = geom.position[vr[sel], vc[sel]]
    nrm = geom.normal[vr[sel], vc[sel]]
    ids = np.arange(500, 500 + TEXELS, dtype=np.int32)
    row_keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    )(jnp.asarray(ids))
    samples = np.array(stratified_samples(
        jax.random.PRNGKey(SEED), TEXELS, SPP, "hammersley", row_keys))
    jb = JBaker(scene["jt"], spp=SPP, texel_batch=TEXELS)
    nrm_j = tuple(jnp.asarray(nrm[:, k]) for k in range(3))
    dirs = jb._fan_dirs(nrm_j, jnp.asarray(ids), jnp.int32(SEED))
    origins = tuple(jnp.asarray(pts[:, k] + 1e-2 * nrm[:, k])
                    for k in range(3))
    return dict(pts=pts, nrm=nrm, ids=ids, samples=samples, dirs=dirs,
                origins=origins, nrm_j=nrm_j)


def _bake_both(scene, b, jkw, tkw):
    ref = np.asarray(JBaker(scene["jt"], spp=SPP, texel_batch=TEXELS,
                            **jkw).bake_batch(
        jnp.asarray(b["pts"]), jnp.asarray(b["nrm"]), jnp.asarray(b["ids"]),
        jnp.int32(SEED)))
    got = TBaker(scene["tt"], spp=SPP, texel_batch=TEXELS, **tkw).bake_batch(
        torch.from_numpy(b["pts"]), torch.from_numpy(b["nrm"]),
        torch.from_numpy(b["ids"]), SEED,
        samples=torch.from_numpy(b["samples"])).numpy()
    assert got.shape == (TEXELS, 3) and ref.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_traversal_bake_matches_jax(scene, bake):
    """No ClusterScene and no FanScene: every ray through the BVH
    (bake_irradiance_soa)."""
    _bake_both(scene, bake, {}, {})


def test_leaf_budgeted_fan_bake_matches_jax(scene, bake):
    """A FanScene with a leaf budget below its leaf count: at 100, 9 of the
    12 fans overflow and are re-traced by the BVH, 3 keep their budgeted
    trace (tests/test_torch_fan.py holds the budget of 8, where every fan
    overflows)."""
    _bake_both(scene, bake, dict(fan_scene=scene["fan"], max_leaves=100),
               dict(fan_scene=scene["tfan"], max_leaves=100))


@pytest.mark.parametrize("max_leaves", [4, 100, 4096])
def test_cast_ray_fans_overflow_flags_match_jax(scene, bake, max_leaves):
    """Overflow flags equal to JAX's; the hits of the budgeted trace (every
    fan over its first K leaves, overflowing or not) agree as the fan
    stream's do (u/v within 1e-5)."""
    ref, ref_over = JF.cast_ray_fans(
        scene["fan"], bake["origins"], bake["dirs"], max_leaves=max_leaves,
        return_overflow=True, fan_normals=bake["nrm_j"])
    got, over = TF.cast_ray_fans(
        scene["tfan"], tuple(torch.from_numpy(np.array(a))
                             for a in bake["origins"]),
        tuple(torch.from_numpy(np.array(a)) for a in bake["dirs"]),
        max_leaves=max_leaves, return_overflow=True,
        fan_normals=tuple(torch.from_numpy(np.array(a))
                          for a in bake["nrm_j"]))
    assert np.array_equal(over.numpy(), np.asarray(ref_over))
    assert over.shape == (TEXELS, SPP)
    n_over = int(over[:, 0].sum())
    assert n_over == {4: TEXELS, 100: 9, 4096: 0}[max_leaves]
    _agree(got, ref, uv_tol=1e-5)
