"""Port vs JAX: the texture sampler's segment-sum backward — the
scatter-accumulate function of kernel S (`ops/scatter_acc.py`, the port of
the Pallas harness kernels S1/S2), `ops/texture.py::take_segsum` behind
the module switch `SEGSUM_BACKWARD`, and the harness
`scripts/sampler_bwd_variants.py`.

On the CPU `scatter_accumulate` runs its plain version (zeros +
`index_add_` in tap order); the CUDA kernel is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py).  References: JAX's
`jnp.zeros((S, C)).at[idx].add(g)`; kernel S2 itself
(`scripts/sampler_bwd_variants3.py::make_acc`, Pallas interpret mode,
which returns the output's sum); the JAX sampler's gradients with its own
`SEGSUM_BACKWARD = True`; and a small Mat stage-2 step (the scene of
tests/test_torch_gbuffer_material.py) with the switch on in both
packages.  Tolerances: sums of the same taps in another order — 1e-6
(and, in the harness, the summation-order bound `order_bound`); the Mat
step at the Mat row's loss rel 1e-5 and gradient rtol 1e-4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models.material import MaterialModel as JMat
from texir_code_tpu.models.material import MaterialParams as JParams
from texir_code_tpu.ops import gbuffer as JG
from texir_code_tpu.ops import texture as JT
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.models.material import MaterialModel as TMat
from texir_code_tpu_torch.ops import texture as TT
from texir_code_tpu_torch.ops.scatter_acc import (
    scatter_accumulate,
    scatter_accumulate_cuda,
    scatter_accumulate_plain,
)
from texir_code_tpu_torch.scripts import sampler_bwd_variants as H

torch.set_num_threads(2)  # six test workers share the host's cores

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _taps(rng, n, s, c):
    """Clustered taps (many duplicates, every row hit at most ~n/s·3
    times) and uniform rows."""
    idx = np.clip((rng.random(n) ** 1.2 * s).astype(np.int32), 0, s - 1)
    return idx, rng.random((n, c)).astype(np.float32)


@pytest.mark.parametrize("s,c,n", [(16, 3, 200), (64, 1, 500), (5, 2, 64)])
def test_scatter_accumulate_plain_matches_jax(s, c, n):
    rng = np.random.default_rng(s + c)
    idx, g = _taps(rng, n, s, c)
    ref = np.asarray(jnp.zeros((s, c)).at[jnp.asarray(idx)].add(
        jnp.asarray(g)))
    assert len(np.unique(idx)) < n  # duplicate taps
    for presorted, (i, gg) in ((False, (idx, g)),
                               (True, (np.sort(idx, kind="stable"),
                                       g[np.argsort(idx, kind="stable")]))):
        got = scatter_accumulate(torch.from_numpy(i), torch.from_numpy(gg), s,
                                 presorted=presorted)
        assert got.shape == (s, c) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    plain64 = scatter_accumulate_plain(torch.from_numpy(idx).long(),
                                       torch.from_numpy(g), s)
    np.testing.assert_array_equal(plain64.numpy(), ref)


def _s2_module():
    path = os.path.join(ROOT, "scripts", "sampler_bwd_variants3.py")
    spec = importlib.util.spec_from_file_location("sampler_bwd_variants3",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("p", [1, 4])
def test_scatter_accumulate_matches_pallas_s2(p):
    """Kernel S2 (`make_acc`, P phase accumulators, interpret mode) at
    S = 32, C = 3, N = 256, CH = 64 returns the sum of its output; the
    port's output sums to it, sorted or not (as S2's acc1s sorts)."""
    s, c, n = 32, 3, 256
    rng = np.random.default_rng(30 + p)
    idx, g = _taps(rng, n, s, c)
    run = _s2_module().make_acc(s, c, n, p, CH=64, interpret=True)
    ref = float(run(jnp.asarray(idx), jnp.asarray(g)))
    order = np.argsort(idx, kind="stable")
    for presorted, (i, gg) in ((False, (idx, g)),
                               (True, (idx[order], g[order]))):
        got = scatter_accumulate(torch.from_numpy(i), torch.from_numpy(gg), s,
                                 presorted=presorted)
        np.testing.assert_allclose(float(got.sum()), ref, rtol=1e-6)


def test_scatter_accumulate_cuda_needs_cuda_tensors():
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_accumulate_cuda(idx, torch.ones(4, 3), 8)


# ---------------------------------------------------------------------------
# take_segsum and the switch, against the JAX sampler
# ---------------------------------------------------------------------------


def _sampler_inputs(mode):
    rng = np.random.default_rng(40)
    tex = rng.random((16, 16, 3)).astype(np.float32)
    # clustered uvs force duplicate texel indices across samples
    uv = (rng.random((64, 2)) * 0.2 + 0.4).astype(np.float32)
    lod = (rng.random(64) * 3).astype(np.float32)
    w = rng.random((64, 3)).astype(np.float32)
    shape = {"trilinear": None, "mip_stochastic": (64,),
             "bilinear_stochastic": (64, 3)}[mode]
    r = None if shape is None else rng.random(shape).astype(np.float32)
    return tex, uv, lod, w, r


def _jax_grad(tex, uv, lod, w, r, segsum):
    def loss(t):
        pyr = JT.build_mip_pyramid(t)
        out = JT.texture_sample(pyr, jnp.asarray(uv), jnp.asarray(lod),
                                rng=None if r is None else jnp.asarray(r))
        return (out * jnp.asarray(w)).sum()

    JT.SEGSUM_BACKWARD = segsum
    try:
        return np.asarray(jax.grad(loss)(jnp.asarray(tex)))
    finally:
        JT.SEGSUM_BACKWARD = False


def _port_grad(tex, uv, lod, w, r, segsum):
    t = torch.tensor(tex, requires_grad=True)
    TT.SEGSUM_BACKWARD = segsum
    try:
        pyr = TT.build_mip_pyramid(t)
        out = TT.texture_sample(pyr, torch.from_numpy(uv),
                                torch.from_numpy(lod),
                                rng=None if r is None else torch.from_numpy(r))
        (out * torch.from_numpy(w)).sum().backward()
    finally:
        TT.SEGSUM_BACKWARD = False
    return t.grad.numpy()


@pytest.mark.parametrize("mode", ["trilinear", "mip_stochastic",
                                  "bilinear_stochastic"])
def test_take_segsum_gradients_match_jax(mode):
    """The port's segment-sum backward against the JAX package's, and
    against the port with the switch off (tests/test_texture.py:184-205)."""
    inp = _sampler_inputs(mode)
    ref = _jax_grad(*inp, segsum=True)
    on = _port_grad(*inp, segsum=True)
    off = _port_grad(*inp, segsum=False)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(on, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(on, off, rtol=1e-6, atol=1e-6)


def test_take_segsum_forward_and_switch():
    """take_segsum's forward is the gather; the switch routes the sampler's
    fetch through it, and it is off by default, as in JAX."""
    assert TT.SEGSUM_BACKWARD is False and JT.SEGSUM_BACKWARD is False
    flat = torch.arange(12.0).reshape(6, 2).requires_grad_(True)
    idx = torch.tensor([5, 0, 5, 2, 5])
    out = TT.take_segsum(flat, idx)
    assert torch.equal(out, flat.detach()[idx])
    out.sum().backward()
    assert flat.grad[:, 0].tolist() == [1.0, 0.0, 1.0, 0.0, 0.0, 3.0]
    calls = []
    take = TT.take_segsum
    TT.take_segsum = lambda f, i: calls.append(i.numel()) or take(f, i)
    try:
        inp = _sampler_inputs("trilinear")
        _port_grad(*inp, segsum=False)
        assert calls == []
        _port_grad(*inp, segsum=True)
        assert calls == [64] * 8  # 4 corners on 2 levels
    finally:
        TT.take_segsum = take


def test_take_segsum_sorts_int32_keys():
    """take_segsum's backward sorts the taps as int32 keys (stable), hands
    kernel S's sorted mode ascending int32 taps with their rows in tap
    order, and its gradient equals the gather's own backward bit for bit
    (one tap a row) or within rounding; the harness sorts alike."""
    seen = []
    acc = TT.scatter_accumulate

    def record(idx, g, num_rows, presorted=False):
        seen.append((idx.clone(), g.clone(), presorted))
        return acc(idx, g, num_rows, presorted)

    rng = np.random.default_rng(41)
    flat = torch.tensor(rng.random((50, 3), dtype=np.float32),
                        requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, 50, 400))
    w = torch.from_numpy(rng.random((400, 3), dtype=np.float32))
    TT.scatter_accumulate = record
    try:
        (TT.take_segsum(flat, idx) * w).sum().backward()
    finally:
        TT.scatter_accumulate = acc
    ((idx_s, g_s, presorted),) = seen
    assert presorted and idx_s.dtype == torch.int32
    assert bool((idx_s[1:] >= idx_s[:-1]).all())
    order = np.argsort(idx.numpy(), kind="stable")
    assert torch.equal(idx_s.long(), idx[order])
    assert torch.equal(g_s, w[order])
    ref = torch.zeros(50, 3).index_put_((idx,), w, accumulate=True)
    torch.testing.assert_close(flat.grad, ref, rtol=1e-6, atol=1e-6)
    h_idx, h_g = H.sort_taps(idx, w)
    assert torch.equal(h_idx, idx_s) and torch.equal(h_g, g_s)


# ---------------------------------------------------------------------------
# a Mat stage-2 step with the switch on, port vs JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mat():
    scene = make_scene(atlas_res=48)
    m = scene.mesh
    tmesh = convert.mesh_from_numpy(m.vertices, m.faces, m.uvs, m.uv_faces,
                                    m.vertex_normals)
    rng = np.random.default_rng(41)
    irt = rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32)
    jm = JMat(m, scene.hdr_texture, irt, pano_res=(32, 64),
              sample_light=(32, 8))
    tm = TMat(tmesh, scene.hdr_texture, irt, pano_res=(32, 64),
              sample_light=(32, 8), device="cpu")
    tm.specular_fetch = "exact"  # the JAX CPU path's fetch
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = scene.camera_positions(1)[0]
    res = jm.cube_res
    b = 6 * res * res
    key = jax.random.PRNGKey(9)
    rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(b, dtype=jnp.int32))
    return dict(
        jm=jm, tm=tm, mvp=np.array(JG.cube_mvp(jnp.asarray(ext))),
        pos=ext[0:3, 3], key=key,
        shift=np.array(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(rows)),
        albedo=rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32),
        rough=rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32),
        gt=rng.uniform(0.0, 1.5, (6, res, res, 3)).astype(np.float32),
        seg=rng.integers(0, 6, (6, res, res)).astype(np.int32),
    )


def test_mat_step_segsum_matches_jax(mat):
    """Stage-2 loss and albedo/roughness gradients with SEGSUM_BACKWARD on
    in both packages (exact trilinear fetches: 8 take_segsum backwards per
    atlas)."""
    s = mat
    ones = np.ones(s["gt"].shape[:-1] + (1,), np.float32)

    def jloss(p):
        out = s["jm"]._forward(p, jnp.asarray(s["mvp"]), jnp.asarray(s["pos"]),
                               s["key"], stage=2)
        return JL.render_loss(jnp.asarray(s["gt"]), out, jnp.asarray(ones),
                              jnp.asarray(s["seg"]), 7, 2,
                              seg_region=jnp.asarray(ones))[0]

    JT.SEGSUM_BACKWARD = True
    try:
        lj, gj = jax.value_and_grad(jloss)(
            JParams(albedo=jnp.asarray(s["albedo"]),
                    roughness=jnp.asarray(s["rough"])))
    finally:
        JT.SEGSUM_BACKWARD = False
    p = convert.material_params_from_numpy(s["albedo"], s["rough"],
                                           device="cpu", requires_grad=True)
    TT.SEGSUM_BACKWARD = True
    try:
        out = s["tm"]._forward(p, s["mvp"], s["pos"], 2, spec_shift=s["shift"])
        lt = TL.render_loss(torch.from_numpy(s["gt"]), out,
                            torch.from_numpy(ones), torch.from_numpy(s["seg"]),
                            7, 2, seg_region=torch.from_numpy(ones))[0]
        lt.backward()
    finally:
        TT.SEGSUM_BACKWARD = False
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for name in ("albedo", "roughness"):
        a = np.asarray(getattr(gj, name))
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(getattr(p, name).grad.numpy(), a,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def test_harness_rows_cpu():
    """The harness's rows at a tiny size on the CPU: every variant equals
    the plain version, the taps follow the scripts' mk, and the Mat rows
    read 8 taps a pixel from the whole pyramid."""
    idx, g = H.make_taps(4096, 512, 3, 0, "cpu")
    assert idx.dtype == torch.int64 and g.shape == (4096, 3)
    assert int(idx.min()) >= 0 and int(idx.max()) < 512
    assert (idx < 256).float().mean() > 0.5  # u^1.2 clusters low rows
    (row,) = H.script_rows("cpu", taps=4096, reps=2, shapes=((512, 3),))
    for name in H.VARIANTS:
        assert row[name]["err_over_bound"] <= 1, name
        assert row[name]["err_over_abs_sum"] <= 1e-6, name
    assert row["bound_ms"] == pytest.approx(
        (4096 * 16 + 512 * 12) / 3.35e12 * 1e3)
    uv, lod = H.uniform_view("cpu", pixels=100)
    taps, rows = H.view_taps(uv, lod, 16, 3)
    assert rows == 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1
    assert taps.shape == (800,) and int(taps.max()) < rows
    mat_rows = H.mat_rows(uv, lod, lod, reps=1, albedo_res=16, rough_res=32)
    assert [r["rows"] for r in mat_rows] == [341, 1365]
    assert [r["channels"] for r in mat_rows] == [3, 1]


def test_order_bound():
    """The order bound: 2·γ(k-1)·Σ|g| per element, 0 for one tap, and a
    sum in another order stays within it."""
    idx = torch.tensor([0, 2, 2, 2, 3, 3])
    g = torch.tensor([[1.0], [-2.0], [0.5], [4.0], [1e8], [1.0]])
    abs_sum, bound = H.order_bound(idx, g, 5)
    u = 2.0 ** -24
    want = [0.0, 0.0, 2 * 2 * u / (1 - 2 * u) * 6.5,
            2 * u / (1 - u) * (1e8 + 1), 0.0]
    np.testing.assert_allclose(bound[:, 0].numpy(), want, rtol=1e-12)
    assert abs_sum[:, 0].tolist() == [1.0, 0.0, 6.5, 1e8 + 1, 0.0]
    ref = scatter_accumulate_plain(idx, g, 5)
    rev = scatter_accumulate_plain(idx.flip(0), g.flip(0), 5)
    assert H.order_error(rev, ref, abs_sum, bound)[2] <= 1


def test_harness_step_rates_cpu():
    """The step A/B on a small scene on the CPU: both settings run and,
    summing in the same per-texel order here, reach the same loss."""
    from texir_code_tpu_torch.data.synthetic import make_scene as t_scene

    rates = H.mat_step_rates(t_scene(atlas_res=48), steps=1, device="cpu",
                             pano=(32, 64), albedo_res=32, rough_res=32)
    assert rates["off"] > 0 and rates["on"] > 0
    assert np.isfinite(rates["loss_off"])
    np.testing.assert_allclose(rates["loss_on"], rates["loss_off"],
                               rtol=1e-6)
    assert TT.SEGSUM_BACKWARD is False
