"""The program's spans and counters (`texir_code_tpu_torch/profiling.py`)
on the bake path, on a tiny building (`make_building_scene(atlas_res=32,
rooms=(2, 2), subdiv=3)`, cluster size 4, occluders on):

  * under torch.profiler a culled bake batch and a two-pass batch open
    their `texir.*` ranges, nested under `texir.bake.batch`, inside the
    profiler's window, on the host clock (Unix-epoch ns);
  * without a profiler no range is opened and no device value is held;
  * the held device values stay few and are reduced when `trace()` ends;
  * the counters equal what the traced functions return themselves;
  * the modules' old counter names are the registry's objects.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.data.synthetic import make_building_scene
from texir_code_tpu_torch.geometry.bvh import build_bvh
from texir_code_tpu_torch.geometry.mesh import Mesh
from texir_code_tpu_torch.geometry.occluders import extract_occluders
from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
from texir_code_tpu_torch.models.tracer_irt import (
    IrradianceTextureBaker,
    bake_geometry_textures,
    morton_order,
)
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.fan_raycast import FanScene

torch.set_num_threads(2)  # six test workers share the host's cores

TEXELS, SPP, WEDGES = 48, 64, 4
PACK = ("bvh", "tbl", "fan", "clusters", "occluders", "texels")
BAKE_SPANS = {"bake.batch", "bake.dirs", "cull", "walk", "bake.estimate"}
TWOPASS_SPANS = BAKE_SPANS | {"twopass.sync", "twopass.retrace"}


@pytest.fixture(scope="module")
def scene():
    profiling.reset_counters()
    syn = make_building_scene(atlas_res=32, rooms=(2, 2), subdiv=3)
    m = syn.mesh
    mesh = Mesh(vertices=m.vertices.copy(), faces=m.faces.copy(),
                uvs=m.uvs.copy(), uv_faces=m.uv_faces.copy())
    mesh.compute_vertex_normals()
    flat = build_bvh(mesh.vertices, mesh.faces)
    tbl = build_tbl_from_flat(flat, mesh, syn.hdr_texture, device="cpu")
    fan = FanScene.from_flat(flat, triangle_uvs=mesh.triangle_uvs())
    clusters = T.ClusterScene.from_fan(fan, lb=4, dense=True, device="cpu")
    occ = extract_occluders(mesh, device="cpu")
    geom = bake_geometry_textures(mesh, 48)
    vr, vc = np.nonzero(geom.valid)
    order = morton_order(geom.position[vr, vc])[:TEXELS]
    pack = {k: profiling.counters().get("pack." + k, 0.0) for k in PACK}
    return dict(
        tbl=tbl, clusters=clusters, occ=occ, pack=pack,
        pts=torch.from_numpy(geom.position[vr, vc][order]),
        nrm=torch.from_numpy(geom.normal[vr, vc][order]),
        ids=torch.arange(TEXELS, dtype=torch.int64))


def _baker(s, twopass):
    b = IrradianceTextureBaker(s["tbl"], spp=SPP, texel_batch=TEXELS,
                               cluster_scene=s["clusters"], wedges=WEDGES)
    b.fan_block, b.exit_rows, b.occluders = 16, 8, s["occ"]
    if twopass:
        # a capacity of every row: the stragglers never overflow it
        b.two_pass_cut, b.two_pass_cap = 0.25, 1.0
    return b


def _batch(s, baker, seed=5):
    return baker.bake_batch(s["pts"], s["nrm"], s["ids"], seed)


def _texir_ranges(prof):
    """(name without the prefix, start ns, end ns) of each texir.* range."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.SPAN_PREFIX):
            start = e.start_ns()
            out.append((e.name()[len(profiling.SPAN_PREFIX):], start,
                        start + e.duration_ns()))
    return out


@pytest.mark.parametrize("twopass", [False, True], ids=["culled", "twopass"])
def test_spans_nest_under_the_batch(scene, twopass):
    baker = _baker(scene, twopass)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _batch(scene, baker)
    t1 = time.time_ns()
    ranges = _texir_ranges(prof)
    names = {n for n, _, _ in ranges}
    assert names == (TWOPASS_SPANS if twopass else BAKE_SPANS)
    (batch,) = [(a, b) for n, a, b in ranges if n == "bake.batch"]
    # the spans are the profiler's own ranges, on the host's epoch clock
    assert t0 <= batch[0] <= batch[1] <= t1
    for n, a, b in ranges:
        assert batch[0] <= a <= b <= batch[1], n
    culls = [(a, b) for n, a, b in ranges if n == "cull"]
    if twopass:
        # pass 2's cull and walk lie inside the re-trace, after the sync
        (retrace,) = [(a, b) for n, a, b in ranges if n == "twopass.retrace"]
        (sync,) = [(a, b) for n, a, b in ranges if n == "twopass.sync"]
        assert sync[1] <= retrace[0]
        inside = [c for c in culls if retrace[0] <= c[0] <= c[1]
                  <= retrace[1]]
        assert len(culls) == 2 and len(inside) == 1
    else:
        assert len(culls) == 1


def test_no_profiler_no_span(scene, monkeypatch):
    opened = []

    def record(name):
        opened.append(name)
        raise AssertionError(f"range {name} opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record)
    profiling.reset_counters()
    out = _batch(scene, _baker(scene, True))
    assert opened == [] and profiling._HELD == []
    c = profiling.counters()
    # the window's counts stay out; calls count all the same
    assert "cull.pairs" not in c and "cull.candidates" not in c
    assert "twopass.rays.pass1" not in c and "twopass.rays.stragglers" not in c
    assert c["twopass.calls"] == 1
    assert torch.isfinite(out).all()


def test_stragglers_are_the_trace_own_count(scene, monkeypatch):
    seen = []
    stragglers = T.twopass_stragglers

    def spy(*args, **kwargs):
        out = stragglers(*args, **kwargs)
        seen.append(out[2])
        return out

    monkeypatch.setattr(T, "twopass_stragglers", spy)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _batch(scene, _baker(scene, True))
    c = profiling.counters()
    assert len(seen) == 1 and seen[0] > 0
    assert c["twopass.rays.stragglers"] == seen[0]
    assert c["twopass.rays.pass1"] == TEXELS * WEDGES * (SPP // WEDGES)
    assert c.get("twopass.overflows", 0) == 0


def test_candidates_are_the_cull_own_count(scene):
    s = scene
    rng = np.random.default_rng(3)
    rows, r, er = 32, 16, 8
    o = tuple(torch.from_numpy(rng.uniform(0.5, 9.5, rows).astype(np.float32))
              for _ in range(3))
    d = torch.from_numpy(rng.standard_normal((rows, r, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    dirs = tuple(d[..., k].contiguous() for k in range(3))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _, count, _ = T.cull_blocks(s["clusters"], o, o, dirs, er,
                                    occluders=s["occ"])
        assert len(profiling._HELD) == 1  # a reference, not a reduction
    c = profiling.counters()
    assert profiling._HELD == []
    assert c["cull.candidates"] == int(count.sum()) > 0
    assert c["cull.pairs"] == rows // er * s["clusters"].num_clusters


def test_pack_counters_time_the_packing(scene):
    assert all(scene["pack"][k] > 0 for k in PACK), scene["pack"]
    # bake() orders its texels itself: that is not set-up packing
    before = profiling.counters().get("pack.texels", 0.0)
    morton_order(scene["pts"].numpy())
    assert profiling.counters().get("pack.texels", 0.0) == before


def test_held_values_stay_bounded_and_fold_when_trace_ends(tmp_path):
    profiling.reset_counters()
    n = 3 * profiling._HELD_MAX
    with profiling.trace(str(tmp_path)):
        for i in range(n):
            profiling.hold("held", "k", torch.full((4,), i, dtype=torch.int32))
            assert len(profiling._HELD) <= profiling._HELD_MAX + 1
    assert profiling._HELD == []
    assert profiling.counter("held")["k"] == 4 * n * (n - 1) // 2
    profiling.reset_counters()


def test_old_names_are_the_registry(scene):
    from texir_code_tpu_torch.ops import pallas_fan, scatter_acc
    from texir_code_tpu_torch.parallel import mesh

    assert T.culled_walk_cuda.launches is profiling.counter(
        "culled_walk.launches")
    assert T.cast_fans_culled_twopass.counts is profiling.counter("twopass")
    assert pallas_fan.fan_stream_cuda.launches is profiling.counter(
        "fan_stream.launches")
    assert scatter_acc.scatter_accumulate_cuda.launches is (
        profiling.counter("scatter_acc.launches"))
    assert mesh.COUNTS is profiling.counter("collectives")
    profiling.counter("collectives")["all_reduce"] += 2
    assert profiling.counters()["collectives.all_reduce"] == 2
    profiling.reset_counters()
    assert mesh.COUNTS == {} and profiling.counters() == {}
