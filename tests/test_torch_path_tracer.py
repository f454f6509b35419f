"""Port vs JAX: the path tracer (`eval/path_tracer.py`: `QuadLight`,
`light_under_camera`, `PathTracedMaterialModel`), the relighting tester's
path-traced mode (`RelightingRunner.run(mode="pathtrace")`) and the CLI's
`--relight_mode pathtrace`.

The scene is the JAX package's `make_scene(atlas_res=32)` box and its port
copy, with random albedo / roughness atlases (32²) and two quad lights
(one under each of two ring cameras): the shadow rays of both lights go
through one cast.  Both sides trace with their BVH traversal; the port
draws JAX's own uniforms (`trace(draws=)`: per bounce the key splits of
`path_tracer.py:153-155` and `:209`, and `stratified_samples(...,
"independent")` for the bounce).  Tolerance: rtol 1e-4 / atol 1e-5 on
every pixel.  The port's own draws are keyed by (sample, pixel), so a
view rendered in one cast equals it rendered a sample at a time, bit for
bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_scene as j_scene
from texir_code_tpu.eval import path_tracer as JP
from texir_code_tpu.eval import runners as JR
from texir_code_tpu.ops.sampling import TINY_NUMBER
from texir_code_tpu_torch import cli
from texir_code_tpu_torch.config import parse_file
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.synthetic import make_scene as t_scene
from texir_code_tpu_torch.eval import path_tracer as TP
from texir_code_tpu_torch.eval import runners as TR
from texir_code_tpu_torch.ops.raycast import RayHit

torch.set_num_threads(2)  # six test workers share the host's cores

RES = (16, 32)
SPP = 2
BOUNCES = 3
CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "test_synthetic.conf")


def jax_draws(key, b, n_lights, max_bounces):
    """The uniforms JAX's `trace(o, d, key)` draws on b paths, as the
    port's per-bounce [b, 2·lights + 2] tensors: (su, sv) of every light,
    then the cosine bounce's (u1, u2)."""
    out = []
    for _ in range(max_bounces):
        key, k_nee, k_b = jax.random.split(key, 3)
        cols = []
        for _ in range(n_lights):
            k1, k2, k_nee = jax.random.split(k_nee, 3)
            cols += [jax.random.uniform(k1, (b,)),
                     jax.random.uniform(k2, (b,))]
        s = jnp.clip(jax.random.uniform(k_b, (b, 1, 2)), TINY_NUMBER,
                     1.0 - TINY_NUMBER)
        cols += [s[:, 0, 0], s[:, 0, 1]]
        out.append(torch.tensor(np.stack([np.asarray(c) for c in cols], -1)))
    return out


def jax_pano_draws(key_of_seed, pixels):
    """A `draws(seed, ids)` for the port tracer that returns JAX's
    render_pano uniforms: sample s of the view keyed fold_in(key, s)."""
    def draws(self, seed, ids):
        key = key_of_seed(seed)
        samples = ids.reshape(-1, pixels)[:, 0] // pixels
        per = [jax_draws(jax.random.fold_in(key, int(s)), pixels,
                         len(self.lights), self.max_bounces)
               for s in samples]
        return [torch.cat([p[b] for p in per]) for b in
                range(self.max_bounces)]
    return draws


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=what)


@pytest.fixture(scope="module")
def tracers():
    """The JAX tracer and its port on the box, two lights, spp 2."""
    js, ts = j_scene(atlas_res=32), t_scene(atlas_res=32)
    rng = np.random.default_rng(31)
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    cams = js.camera_positions(2)
    jl = [JP.light_under_camera(c) for c in cams]
    tl = [TP.light_under_camera(c) for c in cams]
    jt = JP.PathTracedMaterialModel(js.mesh, albedo, rough, jl,
                                    max_bounces=BOUNCES, spp=SPP)
    tt = TP.PathTracedMaterialModel(ts.mesh, albedo, rough, tl,
                                    max_bounces=BOUNCES, spp=SPP,
                                    device="cpu")
    return dict(jt=jt, tt=tt, cam=cams[0])


def _pano_rays(cam):
    from texir_code_tpu_torch.data.export import pano_dirs

    d = pano_dirs(*RES).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(cam, np.float32), d.shape)
    return o, d


@pytest.mark.parametrize("kw", [
    dict(cam_position=[2.0, 1.5, 2.5]),
    dict(cam_position=[0.3, -1.0, 7.25], size=0.5, drop=0.1),
    dict(cam_position=[1.0, 2.0, 3.0], radiance=(5.0, 10.0, 2.5)),
])
def test_light_under_camera_matches_jax(kw):
    a, b = JP.light_under_camera(**kw), TP.light_under_camera(**kw)
    for f in ("corner", "edge_u", "edge_v", "radiance"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.area == b.area
    assert np.array_equal(a.normal, b.normal)


def test_quad_light_properties_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(4):
        e = [rng.normal(size=3).astype(np.float32) for _ in range(4)]
        a, b = JP.QuadLight(*e), TP.QuadLight(*e)
        assert a.area == b.area
        assert np.array_equal(a.normal, b.normal)


def test_tracer_buffers_match_jax(tracers):
    jt, tt = tracers["jt"], tracers["tt"]
    assert np.array_equal(np.asarray(jt.uv_u), tt.uv_u.numpy())
    assert np.array_equal(np.asarray(jt.uv_v), tt.uv_v.numpy())
    for k in range(3):
        for c in range(3):
            assert np.array_equal(np.asarray(jt.nrm_corners[k][c]),
                                  tt.nrm_corners[k][c].numpy())
    for name in ("_l_corner", "_l_eu", "_l_ev", "_l_rad", "_l_area",
                 "_l_nrm"):
        assert np.array_equal(np.asarray(getattr(jt, name)),
                              getattr(tt, name).numpy()), name
    assert tt.draws_per_bounce == 6


def test_surface_matches_jax(tracers):
    """`_surface` on JAX's own hits of the view's pano rays: the uv-sampled
    albedo and roughness, the interpolated shading normal, the mask."""
    from texir_code_tpu.ops.raycast import cast_rays_soa

    jt, tt = tracers["jt"], tracers["tt"]
    o, d = _pano_rays(tracers["cam"])
    hit = cast_rays_soa(jt.bvh, tuple(jnp.asarray(o[:, k]) for k in range(3)),
                        tuple(jnp.asarray(d[:, k]) for k in range(3)),
                        t_min=1e-4)
    a = jt._surface(hit)
    b = tt._surface(RayHit(*(torch.tensor(np.asarray(x)) for x in
                             (hit.t, hit.prim, hit.u, hit.v))))
    assert np.array_equal(np.asarray(a[3]), b[3].numpy())
    assert b[3].all()  # inside the box every ray hits
    _close(a[0], b[0].numpy(), "albedo")
    _close(a[1], b[1].numpy(), "roughness")
    for k in range(3):
        _close(a[2][k], b[2][k].numpy(), f"normal {k}")


def test_trace_matches_jax(tracers):
    """One trace of the view's 512 pano rays (3 bounces, both lights) from
    JAX's draws."""
    jt, tt = tracers["jt"], tracers["tt"]
    o, d = _pano_rays(tracers["cam"])
    key = jax.random.PRNGKey(7)
    ref = jt.trace(tuple(jnp.asarray(o[:, k]) for k in range(3)),
                   tuple(jnp.asarray(d[:, k]) for k in range(3)), key)
    tt.casts.clear()
    out = tt.trace(tuple(torch.tensor(o[:, k]) for k in range(3)),
                   tuple(torch.tensor(d[:, k]) for k in range(3)),
                   draws=jax_draws(key, o.shape[0], 2, BOUNCES))
    _close(ref, out.numpy(), "trace")
    assert out.min() >= 0 and out.max() > 0
    # one path cast and one shadow cast (both lights) a bounce
    assert [c["rays"] for c in tt.casts] == [512, 1024] * BOUNCES


def test_render_pano_matches_jax(tracers, monkeypatch):
    """render_pano (both samples in one cast) from JAX's per-sample keys."""
    jt, tt = tracers["jt"], tracers["tt"]
    key = jax.random.PRNGKey(11)
    ref = jt.render_pano(tracers["cam"], RES, key)
    monkeypatch.setattr(TP.PathTracedMaterialModel, "draws", jax_pano_draws(
        lambda seed: key, RES[0] * RES[1]))
    out = tt.render_pano(tracers["cam"], RES, 0)
    assert out.shape == RES + (3,) and out.dtype == np.float32
    _close(ref, out, "render_pano")


@pytest.mark.parametrize("per_cast", [1, 3])
def test_render_pano_batched_equals_sample_by_sample(tracers, per_cast):
    """The port's draws are keyed by (sample, pixel): 4 samples in one
    cast, one a cast, or 3 + 1 give the same image bit for bit."""
    tt = tracers["tt"]
    spp = tt.spp
    tt.spp = 4
    try:
        tt.casts.clear()
        one = tt.render_pano(tracers["cam"], RES, 5)
        assert len(tt.casts) == 2 * BOUNCES
        split = tt.render_pano(tracers["cam"], RES, 5,
                               samples_per_cast=per_cast)
        other = tt.render_pano(tracers["cam"], RES, 6)
    finally:
        tt.spp = spp
    assert np.array_equal(one, split)
    assert np.isfinite(one).all() and one.max() > 0
    assert not np.array_equal(one, other)


def test_draws_keyed_by_path_id(tracers):
    tt = tracers["tt"]
    ids = torch.arange(100, 164)
    full = tt.draws(9, ids)
    part = tt.draws(9, ids[17:40])
    assert len(full) == BOUNCES
    for b in range(BOUNCES):
        assert full[b].shape == (64, 6)
        assert torch.equal(full[b][17:40], part[b])
    assert not torch.equal(full[0], full[1])


def test_set_lights_swaps_lights(tracers):
    tt = tracers["tt"]
    lights = tt.lights
    try:
        tt.set_lights([TP.light_under_camera([1.0, 1.0, 1.0])])
        assert tt.draws_per_bounce == 4
        assert tt._l_corner.shape == (1, 3)
    finally:
        tt.set_lights(lights)
    assert tt.draws_per_bounce == 6


# ----------------------------------------------------------------------
# the relighting tester's path-traced mode and the CLI


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """A JAX-exported scan (make_scene(atlas_res=48), 2 views, pano 32x64)
    with an IrT and a Mat run's atlases; the JAX and port confs."""
    root = tmp_path_factory.mktemp("pathtrace")
    path = j_export(j_scene(atlas_res=48), str(root / "scan"), n_views=2,
                    pano_res=(32, 64))
    rng = np.random.default_rng(41)
    hdrio.write_hdr(path.replace("out1.obj", "irt.hdr"),
                    rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32),
                    flip=True)
    exps = str(root / "exps")
    plots = os.path.join(exps, "Mat-default", "2026_01_02_00_00_00", "plots")
    os.makedirs(plots)
    hdrio.write_hdr(os.path.join(plots, "mat_albedo_final.hdr"),
                    rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32))
    hdrio.write_hdr(os.path.join(plots, "mat_roughness_final.hdr"),
                    np.repeat(rng.uniform(0.1, 0.6, (32, 32, 1)), 3,
                              axis=-1).astype(np.float32))
    sets = {"train.path_mesh_open3d": path, "train.pano_img_res": [32, 64],
            "train.sample_light": [16, 4]}
    jconf, tconf = ConfigFactory.parse_file(CONF), parse_file(CONF)
    for k, v in sets.items():
        jconf.put(k, v)
        tconf.put(k, v)
    return dict(path=path, exps=exps, jconf=jconf, tconf=tconf, sets=sets)


def test_runner_pathtrace_matches_jax(scan, monkeypatch):
    """Both views of the JAX tester's pathtrace mode (a light under each
    camera, 16x32, spp 2, 2 bounces) from JAX's draws: the port's draw
    seed (SEED << 24) + i is the JAX key fold_in(key, i)."""
    jr = JR.RelightingRunner(scan["jconf"], exps_root=scan["exps"])
    tr = TR.RelightingRunner(scan["tconf"], exps_root=scan["exps"],
                             device="cpu")
    kw = dict(mode="pathtrace", pano_res=RES, spp=2, max_bounces=2)
    a = jr.run(**kw)
    monkeypatch.setattr(TP.PathTracedMaterialModel, "draws", jax_pano_draws(
        lambda seed: jax.random.fold_in(jr.key, seed - tr.draw_seed(0)),
        RES[0] * RES[1]))
    b = tr.run(**kw)
    assert len(a) == len(b) == 2
    for k, (x, y) in enumerate(zip(a, b)):
        _close(x, y, f"view {k}")


def test_runner_pathtrace_frames_are_render_pano(scan):
    """Frame i is the tracer's render_pano of view i with draw seed i,
    written as pt_relit_{i:03d}.hdr."""
    tr = TR.RelightingRunner(scan["tconf"], exps_root=scan["exps"],
                             device="cpu")
    frames = tr.run(mode="pathtrace", pano_res=RES, spp=2, max_bounces=2)
    ds = tr._default_dataset()
    tracer = TP.PathTracedMaterialModel(
        tr.model.mesh, tr.params.albedo, tr.params.roughness,
        [TP.light_under_camera(ds[i]["cam_position"]) for i in range(2)],
        max_bounces=2, spp=2, device="cpu")
    for i, img in enumerate(frames):
        ref = tracer.render_pano(ds[i]["cam_position"], RES, tr.draw_seed(i))
        assert np.array_equal(img, ref)
        assert np.isfinite(img).all() and img.max() > 0
        disk = hdrio.read_hdr(os.path.join(tr.exp.plots_dir,
                                           f"pt_relit_{i:03d}.hdr"))
        assert np.array_equal(disk, hdrio.rgbe_to_float(
            hdrio.float_to_rgbe(img)))
    assert not np.array_equal(frames[0], frames[1])


def test_runner_rejects_unknown_mode(scan):
    tr = TR.RelightingRunner(scan["tconf"], exps_root=scan["exps"],
                             device="cpu")
    with pytest.raises(ValueError, match="unknown relight mode"):
        tr.run(mode="raster")


def test_cli_relight_pathtrace_cpu(scan, tmp_path):
    """`test --teststage Relighting --relight_mode pathtrace --device cpu`
    at the JAX CLI's defaults (64x128, spp 16, 3 bounces): one finite, lit
    64x128 frame a view."""
    import shutil

    exps = str(tmp_path / "exps")
    shutil.copytree(os.path.join(scan["exps"], "Mat-default"),
                    os.path.join(exps, "Mat-default"))
    argv = ["test", "--conf", CONF, "--exps_folder", exps,
            "--device", "cpu", "--teststage", "Relighting",
            "--relight_mode", "pathtrace"]
    for k, v in scan["sets"].items():
        argv += ["--set", f"{k}={v}"]
    assert cli.main(argv) == 0
    (run,) = os.listdir(os.path.join(exps, "Relighting-default"))
    plots = os.path.join(exps, "Relighting-default", run, "plots")
    assert sorted(os.listdir(plots)) == ["pt_relit_000.hdr",
                                         "pt_relit_001.hdr"]
    for f in os.listdir(plots):
        img = hdrio.read_hdr(os.path.join(plots, f))
        assert img.shape == (64, 128, 3), f
        assert np.isfinite(img).all() and img.max() > 0, f
