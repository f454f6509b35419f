"""Port vs JAX: kernels B2 and B3, the exhaustive leaf stream
(`ops/pallas_fan.py`), its plain version against the brute-force oracle,
and the FanScene-only bake and G-buffer.

The scene is the JAX tests' small apartment (`make_apartment_scene(
atlas_res=64, subdiv=6)`, 151 leaf rows: no multiple of a leaf block).  The
JAX side runs in interpret mode.  Its compile time grows steeply with the
leaf block (lb 32, the bake's, compiles for minutes on a CPU), and the
leaf block changes no output, so every JAX call here runs at lb 2: the
JAX dispatch sites (the baker, `render_gbuffer`) are wrapped to pass it,
and each mode compiles once, its kernel call shared by the tests that read
it.  Row counts are no multiple of the fan block (8).

Tolerances: t bit-equal to JAX (both divide in IEEE and multiply once);
u, v within 1e-5 (XLA contracts a multiply-add in the barycentric terms,
the port rounds each product, as the CUDA kernel does, and the terms
o·s − p0·s and t·(d·s) reach ~10 here, an ulp of 1e-6); prim equal except
on exact-t ties (two triangles at the same t, where the first in row order
wins, and the bary tests of the two packages, rounded apart, can pick
either), at most 1e-2 of the rays; a tied pixel's G-buffer position is the
same point (within 1e-4).  Against the brute-force oracle (a
Möller–Trumbore formula, not the plane-dual one): t within 1e-4 relative,
prim equal but on ties.  Bake texels within rtol 1e-5 of JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_apartment_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.models.tbl import build_tbl
from texir_code_tpu.models.tracer_irt import IrradianceTextureBaker as JBaker
from texir_code_tpu.models.tracer_irt import bake_geometry_textures, morton_order
from texir_code_tpu.ops import gbuffer as JG
from texir_code_tpu.ops import pallas_fan as JF
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu.ops.raycast import DeviceBVH
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker as TBaker
from texir_code_tpu_torch.ops import gbuffer as TG
from texir_code_tpu_torch.ops import pallas_fan as TF
from texir_code_tpu_torch.ops.fan_raycast import FanScene as TFan
from texir_code_tpu_torch.ops.raycast import cast_rays_brute

torch.set_num_threads(2)  # six test workers share the host's cores

LB = 2                    # the JAX kernels' leaf block in these tests
TEXELS, SPP, SEED = 12, 256, 99
ROWS, R = 10, 128         # per-ray rows
UV_TOL, TIE_FRAC = 1e-5, 1e-2


def _leaf_block(fn):
    """A JAX dispatch function that runs at leaf block LB."""
    @functools.wraps(fn)
    def call(*args, **kw):
        kw["leaf_block"] = LB
        return fn(*args, **kw)
    return call


@pytest.fixture(scope="module")
def setup():
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    fan72 = FanScene.from_flat(bvh)
    assert fan.num_leaves % LB and fan.num_leaves % 32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "cast_ray_fans_pallas",
                   _leaf_block(JF.cast_ray_fans_pallas))
        mp.setattr(JF, "FORCE_INTERPRET", True)
        yield dict(
            syn=syn, bvh=bvh, fan=fan, fan72=fan72,
            tfan=TFan(rows=np.array(fan.rows), diameter=fan.diameter),
            tfan72=TFan(rows=np.array(fan72.rows), diameter=fan72.diameter),
            rng=np.random.default_rng(17),
        )


def _t(x):
    return tuple(torch.from_numpy(np.array(a)) for a in x)


def _np(h):
    return [np.asarray(a) for a in (h.t, h.prim, h.u, h.v)]


def _agree(got, ref, uv_tol=UV_TOL):
    """The port's hits against JAX's: t bit-equal, u/v within uv_tol,
    prim equal except on exact-t ties (at most TIE_FRAC of the rays)."""
    t, prim, u, v = got
    assert np.array_equal(t, ref[0])
    tie = prim != ref[1]
    assert tie.mean() <= TIE_FRAC
    assert np.isfinite(ref[0][tie]).all()
    assert np.abs(u - ref[2])[~tie].max() <= uv_tol
    assert np.abs(v - ref[3])[~tie].max() <= uv_tol


# ---------------------------------------------------------------------------
# the FanScene-only bake (B2, shared origins, emit_uv)
# ---------------------------------------------------------------------------


def _bake_inputs(s):
    syn = s["syn"]
    geom = bake_geometry_textures(syn.mesh, 32)
    vr, vc = np.nonzero(geom.valid)
    order = morton_order(geom.position[vr, vc])
    sel = order[:: len(order) // TEXELS][:TEXELS]
    pts = geom.position[vr[sel], vc[sel]]
    nrm = geom.normal[vr[sel], vc[sel]]
    ids = np.arange(300, 300 + TEXELS, dtype=np.int32)
    return pts, nrm, ids


@pytest.fixture(scope="module")
def bake(setup):
    """JAX's FanScene-only baker on one batch (its exhaustive branch,
    tracer_irt.py:520-545) and the rays it traces."""
    s = setup
    pts, nrm, ids = _bake_inputs(s)
    jt = build_tbl(s["syn"].mesh, s["syn"].hdr_texture)
    jb = JBaker(jt, spp=SPP, texel_batch=TEXELS, fan_scene=s["fan"],
                max_leaves=s["fan"].num_leaves, pallas_interpret=True)
    ref = np.asarray(jb.bake_batch(jnp.asarray(pts), jnp.asarray(nrm),
                                   jnp.asarray(ids), jnp.int32(SEED)))
    nrm_j = tuple(jnp.asarray(nrm[:, k]) for k in range(3))
    dirs = jb._fan_dirs(nrm_j, jnp.asarray(ids), jnp.int32(SEED))
    origins = tuple(jnp.asarray(pts[:, k] + 1e-2 * nrm[:, k]) for k in range(3))
    # the baker's own kernel call (cached: the same compiled kernel)
    hit = JF.cast_ray_fans_pallas(s["fan"], origins, dirs, t_min=0.0,
                                  fan_block=8, leaf_block=32, emit_uv=True,
                                  interpret=True)
    row_keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    )(jnp.asarray(ids))
    samples = np.array(stratified_samples(
        jax.random.PRNGKey(SEED), TEXELS, SPP, "hammersley", row_keys))
    return dict(jt=jt, ref=ref, pts=pts, nrm=nrm, ids=ids, samples=samples,
                origins=origins, dirs=dirs, hit=_np(hit))


def test_fan_bake_batch_matches_jax(setup, bake):
    s, b = setup, bake
    tt = convert.tbl_from_numpy(
        np.asarray(b["jt"].uv_u), np.asarray(b["jt"].uv_v),
        [np.asarray(p) for p in b["jt"].planes], device="cpu")
    tb = TBaker(tt, spp=SPP, texel_batch=TEXELS, fan_scene=s["tfan"],
                max_leaves=s["tfan"].num_leaves)
    before = dict(TF.fan_stream_cuda.launches)
    got = tb.bake_batch(torch.from_numpy(b["pts"]), torch.from_numpy(b["nrm"]),
                        torch.from_numpy(b["ids"]), SEED,
                        samples=torch.from_numpy(b["samples"])).numpy()
    assert TF.fan_stream_cuda.launches == before  # CPU: the plain stream
    assert got.shape == (TEXELS, 3) and b["ref"].mean() > 0.1
    np.testing.assert_allclose(got, b["ref"], rtol=1e-5, atol=1e-6)


def test_fan_bake_without_uv_rows_uses_prim_hits(setup, bake):
    """Rows without uv columns: prim + barycentrics into radiance_from_hit
    (the JAX baker's `_fan_estimate`), which reads the float atlas; the uv
    path reads the RGBE-packed one (8-bit mantissas, a relative step of
    2^-8), so the two bakes agree within rtol 1e-2."""
    s, b = setup, bake
    tt = convert.tbl_from_numpy(
        np.asarray(b["jt"].uv_u), np.asarray(b["jt"].uv_v),
        [np.asarray(p) for p in b["jt"].planes], device="cpu")
    args = (torch.from_numpy(b["pts"]), torch.from_numpy(b["nrm"]),
            torch.from_numpy(b["ids"]), SEED)
    kw = dict(samples=torch.from_numpy(b["samples"]))
    prim = TBaker(tt, spp=SPP, fan_scene=s["tfan72"],
                  max_leaves=s["tfan72"].num_leaves).bake_batch(*args, **kw)
    uv = TBaker(tt, spp=SPP, fan_scene=s["tfan"],
                max_leaves=s["tfan"].num_leaves)
    uv.rgbe_supersample = 0  # the exact 4-fetch bilinear atlas
    np.testing.assert_allclose(prim.numpy(), uv.bake_batch(*args, **kw).numpy(),
                               rtol=1e-2, atol=1e-4)


def test_fan_bake_budget_below_leaf_count_raises(setup, bake):
    """A leaf budget below the scene's leaf count: the JAX baker's
    cast_ray_fans_exact branch (tracer_irt.py:540-543), each fan traced
    over its first 8 culled leaves, the overflowing fans again by the BVH,
    radiance from prim + barycentrics.  Texels within rtol 1e-5 of JAX's
    on its own uniforms (this test once held that the branch raised)."""
    s, b = setup, bake
    jt = b["jt"]
    tt = convert.tbl_from_numpy(
        np.asarray(jt.uv_u), np.asarray(jt.uv_v),
        [np.asarray(p) for p in jt.planes], device="cpu",
        packed=np.asarray(jt.bvh.packed))
    ref = np.asarray(JBaker(jt, spp=SPP, texel_batch=TEXELS,
                            fan_scene=s["fan"], max_leaves=8).bake_batch(
        jnp.asarray(b["pts"]), jnp.asarray(b["nrm"]), jnp.asarray(b["ids"]),
        jnp.int32(SEED)))
    tb = TBaker(tt, spp=SPP, fan_scene=s["tfan"], max_leaves=8)
    before = dict(TF.fan_stream_cuda.launches)
    got = tb.bake_batch(torch.from_numpy(b["pts"]), torch.from_numpy(b["nrm"]),
                        torch.from_numpy(b["ids"]), SEED,
                        samples=torch.from_numpy(b["samples"])).numpy()
    assert TF.fan_stream_cuda.launches == before  # no exhaustive stream
    assert got.shape == (TEXELS, 3) and ref.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_shared_uv_matches_jax(setup, bake):
    """B2 on the bake's rays (12 texel fans × 256 spp, t_min 0, emit_uv)."""
    s, b = setup, bake
    h = TF.cast_ray_fans_pallas(s["tfan"], _t(b["origins"]), _t(b["dirs"]),
                                emit_uv=True)
    got = [a.numpy() for a in (h.t, h.prim, h.u, h.v)]
    _agree(got, b["hit"])
    assert np.isfinite(got[0]).mean() > 0.99
    # emit_uv: (u, v) are atlas coordinates of the hit
    assert (got[2] >= -1e-6).all() and (got[2] <= 1 + 1e-6).all()


# ---------------------------------------------------------------------------
# the FanScene-only G-buffer (B2, shared origin, prim + barycentrics)
# ---------------------------------------------------------------------------


def _gbuffer_rays(s, res=8):
    """One camera's 6 faces of res² pixel rays, cut as render_gbuffer cuts
    them (one row of 384 here)."""
    pos = s["syn"].camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = np.array(JG.cube_mvp(jnp.asarray(ext)))
    flat = np.array(JG.ray_dirs_from_mvp(jnp.asarray(mvp), None, res)
                    ).reshape(1, -1, 3)
    return pos, mvp, flat


@pytest.fixture(scope="module")
def gbuffer(setup):
    """JAX's FanScene-only G-buffer (gbuffer.py:230-252): one camera's 6
    faces of 8² pixels in one row of 384, t_min 1e-6; and the port's."""
    s = setup
    syn, res = s["syn"], 8
    pos, mvp, flat = _gbuffer_rays(s, res)
    gj = JG.render_gbuffer(
        JG.DeviceMesh.from_mesh(syn.mesh), DeviceBVH.from_flat(s["bvh"]),
        jnp.asarray(mvp), jnp.asarray(pos), res, fan_scene=s["fan"])
    tmesh = convert.mesh_from_numpy(syn.mesh.vertices, syn.mesh.faces,
                                    syn.mesh.uvs, syn.mesh.uv_faces,
                                    syn.mesh.vertex_normals)
    gt = TG.render_gbuffer(TG.DeviceMesh.from_mesh(tmesh, "cpu"),
                           torch.from_numpy(mvp), torch.from_numpy(pos), res,
                           None, fan_scene=s["tfan"])
    return dict(pos=pos, flat=flat, jax=gj, port=gt)


def test_fan_gbuffer_matches_jax(gbuffer):
    gj, gt = gbuffer["jax"], gbuffer["port"]
    pj, pt = np.asarray(gj.prim), gt.prim.numpy()
    assert (pt >= 0).all()  # a closed room: every pixel hits
    tie = pj != pt
    assert tie.mean() <= TIE_FRAC
    for name in ("position", "normal", "uv"):
        a, b = np.asarray(getattr(gj, name)), getattr(gt, name).numpy()
        assert np.abs(a - b)[~tie].max() <= 1e-5, name
    assert np.abs(gt.position.numpy() - np.asarray(gj.position)).max() <= 1e-4
    assert np.array_equal(gt.mask.numpy(), np.asarray(gj.mask))


def test_shared_prim_matches_jax_and_brute_force(setup, gbuffer):
    """B2 with prim + barycentrics and t_min 1e-6 (the G-buffer's mode) on
    the G-buffer's pixel rays: t and prim against the JAX kernel's (the
    G-buffer keeps them), t, prim, u and v against the brute-force
    oracle (ties, where the two formulas pick either triangle of a shared
    edge, at most 2e-2 of these grazing seams)."""
    s, g = setup, gbuffer
    pos, flat = g["pos"], g["flat"]
    h = TF.cast_ray_fans_pallas(
        s["tfan"], tuple(torch.full((1,), float(pos[k])) for k in range(3)),
        tuple(torch.from_numpy(np.ascontiguousarray(flat[..., k]))
              for k in range(3)), t_min=1e-6)
    t, prim = h.t.numpy().reshape(-1), h.prim.numpy().reshape(-1)
    assert np.array_equal(t, np.asarray(g["jax"].t).reshape(-1))
    assert (prim != np.asarray(g["jax"].prim).reshape(-1)).mean() <= TIE_FRAC
    m = s["syn"].mesh
    bf = cast_rays_brute(
        torch.from_numpy(m.vertices.astype(np.float32)),
        torch.from_numpy(m.faces.astype(np.int32)),
        torch.from_numpy(np.repeat(pos[None], flat.shape[1], 0)),
        torch.from_numpy(flat.reshape(-1, 3)), t_min=1e-6)
    np.testing.assert_allclose(t, bf.t.numpy(), rtol=1e-4)
    tie = prim != bf.prim.numpy()
    assert tie.mean() <= 2e-2
    for a, b in ((h.u, bf.u), (h.v, bf.v)):
        assert np.abs(a.numpy().reshape(-1) - b.numpy())[~tie].max() <= 1e-4


def test_plain_stream_leaf_blocks_keep_row_order(setup):
    """The plain version tests a block of rows at once; on an exact-t tie
    the first triangle in row order must win, as in the sequential
    stream: a copy of row 3 placed right after it (the same block, the
    same t, other prim ids) never takes a hit."""
    s = setup
    rows = s["tfan"].rows
    prim3 = rows[3, 8:12].view(np.int32)
    dup = rows[3:4].copy()
    dup[:, 8:12] = (prim3 + 90000).view(np.float32)
    rows2 = np.concatenate([rows[:4], dup, rows[4:]])
    # rays from a room point at the centroids of row 3's triangles
    m = s["syn"].mesh
    tri = m.vertices[m.faces[prim3[prim3 >= 0]]].mean(axis=1)
    o = np.float32([2.0, 1.2, 2.0])
    d = np.repeat(tri - o, 32, axis=0).reshape(-1, 128, 3)
    d = (d + np.random.default_rng(2).normal(0, 1e-3, d.shape)).astype(
        np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (torch.from_numpy(np.repeat(o[None], len(d), 0)),
            *(torch.from_numpy(np.ascontiguousarray(d[..., k]))
              for k in range(3)))
    a = TF.fan_stream_plain(torch.from_numpy(rows), *args)
    b = TF.fan_stream_plain(torch.from_numpy(rows2), *args)
    assert np.isin(a[1].numpy(), prim3).mean() > 0.5
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_emit_uv_needs_uv_rows(setup):
    s = setup
    o = tuple(torch.zeros(2) for _ in range(3))
    d = tuple(torch.ones(2, 128) for _ in range(3))
    with pytest.raises(ValueError, match="triangle_uvs"):
        TF.cast_ray_fans_pallas(s["tfan72"], o, d, emit_uv=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        TF.cast_ray_fans_pallas(s["tfan"], o, tuple(a[:, :64] for a in d))


def test_device_rows_uploaded_once(setup):
    s = setup
    a = s["tfan"].device_rows("cpu")
    assert a is s["tfan"].device_rows(torch.device("cpu"))
    assert a.dtype == torch.float32 and a.shape == s["tfan"].rows.shape


def test_device_records_pack_row_columns_once(setup):
    """The CUDA stream's packed records (FanScene.device_records): each is
    the 12 tested words of the rows' slot it names, in row order, every
    slot with a nonzero normal is there and no other; cached per device."""
    s = setup
    rows = s["tfan"].rows
    rec, slots = s["tfan"].device_records("cpu")
    assert rec is s["tfan"].device_records(torch.device("cpu"))[0]
    assert rec.dtype == torch.float32 and slots.dtype == torch.int32
    slots = slots.numpy()
    assert (np.diff(slots) > 0).all()
    row, tri = slots // 4, slots % 4
    base = 12 + 15 * tri
    want = rows[row[:, None], base[:, None] + np.arange(12)[None]]
    np.testing.assert_array_equal(rec.numpy(), want)
    normals = rows[:, 12:72].reshape(-1, 15)[:, 0:3]
    np.testing.assert_array_equal(np.sort(slots),
                                  np.nonzero((normals != 0).any(1))[0])
    assert len(slots) < 4 * len(rows)  # the scene has padded slots


def test_fan_launch_plan_fills_the_card():
    """4 rays a thread in blocks of 256 on the bake's and the specular
    trace's launches, 2 a thread in smaller blocks on a G-buffer's, and
    always at least two blocks an SM where the rays allow it."""
    assert TF.launch_plan(2_097_152, 132) == (4, 256)
    assert TF.launch_plan(1_572_864, 132) == (4, 256)
    assert TF.launch_plan(98_304, 132) == (2, 128)
    assert TF.launch_plan(1000, 132) == (2, 64)
    for n in (98_304, 270_336, 300_000, 2_097_152):
        rays, threads = TF.launch_plan(n, 132)
        assert -(-n // (rays * threads)) >= 264
