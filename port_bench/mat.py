"""The Mat cell: stage-2 steps of `MatTrainRunner._step` (render, loss,
backward, Adam, clamp), one view a step, driven as the runner drives
them.

Set-up builds the configuration's scene (port_bench.scenes) and the
program's MaterialModel over it, draws the IrT atlas, the photographs,
the seg classes, highlights and room ids of the training views from
--seed on the device, traces each view's G-buffer once (as the runner
caches it a substage), and runs one whole epoch over the views as the
warm-up: those first steps are the steps the reference follows.  The
window then runs whole epochs: each is enqueued with no host sync, its
losses are read at its end, and the window's last epoch ends in that
read.  mat_steps_per_s is every step over the window's wall time; CUDA
events between the steps give each step's interval.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from port_bench import scenes
from port_bench.readings import Readings, WalkWork
from port_bench.trace import patched, span, spanned, traced_window

STAGE = 2


class Program:
    """The program's Mat step over a configuration, on `device`."""

    def __init__(self, scene, cfg: dict, device, seed: int):
        from texir_code_tpu_torch.geometry.mesh import Mesh
        from texir_code_tpu_torch.models.material import (
            MaterialModel,
            init_material_params,
        )
        from texir_code_tpu_torch.ops.gbuffer import cube_mvp
        from texir_code_tpu_torch.train.exp import adam_staircase
        from texir_code_tpu_torch.train.material import MatTrainRunner

        m = scene.mesh
        mesh = Mesh(vertices=m.vertices.copy(), faces=m.faces.copy(),
                    uvs=m.uvs.copy(), uv_faces=m.uv_faces.copy())
        mesh.compute_vertex_normals()
        gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
        ir = cfg["irt_res"]
        self.irt = torch.rand((ir, ir, 3), generator=gen, device=device) * 2
        model = MaterialModel(
            mesh, scene.hdr_texture, self.irt.cpu().numpy(),
            pano_res=tuple(cfg["pano_res"]),
            sample_light=tuple(cfg["sample_light"]),
            render_knobs=dict(cfg["render_knobs"]), device=device)
        params = init_material_params(cfg["albedo_res"],
                                      cfg["roughness_res"], device=device)
        res = model.cube_res
        c, rooms = cfg["num_classes"], cfg["n_rooms"]
        self.views = []
        for k, pos in enumerate(cfg["cameras"]):
            e = np.eye(4, dtype=np.float32)
            e[0:3, 3] = pos
            shp = (6, res, res)
            seg = torch.randint(0, c, shp, generator=gen, device=device)
            v = dict(
                id=k, index=k, position=np.asarray(pos, np.float64),
                mvp=cube_mvp(e).to(device),
                pos=torch.tensor(pos, dtype=torch.float32, device=device),
                gt=torch.rand(shp + (3,), generator=gen, device=device) * 2,
                mask=torch.ones(shp + (1,), device=device),
                seg=seg,
                hl=(torch.rand(shp, generator=gen, device=device)
                    < 0.5).float(),
                region=(seg < c - 1).float()[..., None],
                room=torch.randint(0, rooms, shp, generator=gen,
                                   device=device),
            )
            v["view"] = model.precompute_view(params, v["mvp"], v["pos"])
            self.views.append(v)
        runner = MatTrainRunner.__new__(MatTrainRunner)
        runner.model = model
        runner.params = params
        runner.loss_type = "L1"
        runner.seg_weight_scale = cfg["seg_weight_scale"]
        for p in (params.albedo, params.roughness):
            p.requires_grad_(True)
        self.optimizer, self.scheduler = adam_staircase(
            [params.albedo, params.roughness], cfg["lr"], cfg["sched_step"],
            cfg["sched_factor"], len(self.views))
        self.runner = runner
        self.params = params
        self.scene_mesh = scene.mesh
        self.n_rooms = rooms
        self.it = 0

    def step(self):
        """One step on the next view; (total, seg) loss tensors."""
        v = self.views[self.it % len(self.views)]
        out = self.runner._step(STAGE, v, self.n_rooms, self.it,
                                self.optimizer, self.scheduler)
        self.it += 1
        return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, check=None):
    """One run of the Mat cell.  Returns (Readings, e2e values, checks,
    attempted, failed, memory peak).  `check` replaces the comparison
    with the reference (the control's and the tests' hook)."""
    cfg = cell.config["mat"]
    traffic = cell.traffic
    t0 = time.time()
    scene = scenes.make(cell.config)
    prog = Program(scene, cfg, device, seed)
    sync(device)
    pack_s = time.time() - t0

    # warm-up: the first epoch; the reference follows its first steps
    follow = traffic["check_steps"]
    nv = len(prog.views)
    opt_state = prog.optimizer.state
    first_losses, first_grads = [], None
    for k in range(nv):
        first_losses.append(prog.step()[0])
        if k == 0:
            # Adam's first moment after one step is (1 - beta1) g
            b1 = prog.optimizer.param_groups[0]["betas"][0]
            first_grads = [
                opt_state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                .detach() / (1 - b1)
                for p in (prog.params.albedo, prog.params.roughness)]
        if k == follow - 1:
            after = [p.detach().clone() for p in (prog.params.albedo,
                                                  prog.params.roughness)]
    first_losses = [float(x) for x in first_losses[:follow]]
    sync(device)
    setup_s = time.time() - t_start

    events, epoch_ends, attempted, failed = [], [], 0, 0
    enqueue_ms = []  # host ms to enqueue each step (no sync)
    tw = time.perf_counter()
    while True:
        losses = []
        for _ in range(nv):
            events.append(_event(device))
            h0 = time.perf_counter()
            losses.append(torch.stack(prog.step()))
            enqueue_ms.append((time.perf_counter() - h0) * 1e3)
        epoch_ends.append((len(events), _event(device)))
        vals = torch.stack(losses).cpu()  # the epoch's end: a host sync
        attempted += nv
        failed += int((~torch.isfinite(vals).all(dim=1)).sum())
        if time.perf_counter() - tw >= seconds:
            break
    window_s = time.perf_counter() - tw
    step_ms = []
    if device.type == "cuda":
        marks = dict(epoch_ends)
        for i, ev in enumerate(events):
            nxt = marks.get(i + 1)
            if nxt is None:
                nxt = events[i + 1]
            step_ms.append(ev.elapsed_time(nxt))

    holder, rows = None, []
    if trace:
        holder, rows = _traced_steps(prog, traffic["trace_steps"], device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    walk = _walk_work(prog, rows, device) if trace else None
    got = dict(losses=first_losses,
               grads=[g.double().norm().item() for g in first_grads],
               change=[(a.double() - init).norm().item() for a, init in
                       zip(after, (cfg["albedo_init"],
                                   cfg["roughness_init"]))])
    inputs = [dict(index=v["index"], position=v["position"], gt=v["gt"],
                   seg=v["seg"], room=v["room"], region=v["region"])
              for v in prog.views[:follow]]
    irt = prog.irt
    del prog, first_grads, after
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if check is None:
        check = reference_check
    checks = check(scene=scene, cfg=cfg, got=got, inputs=inputs, irt=irt,
                   device=device)
    host = {"pack_s": pack_s, "step_ms": step_ms, "enqueue_ms": enqueue_ms}
    readings = Readings(kind="mat", units=traffic["trace_steps"],
                        trace=holder.trace if holder else None, host=host,
                        walk=walk)
    e2e = {"mat_steps_per_s": attempted / window_s, "setup_s": setup_s}
    return readings, e2e, checks, attempted, failed, memory_peak


def _traced_steps(prog, n: int, device):
    """n steps under the profiler, with spans around the culling and the
    optimizer; returns the trace's holder and the specular walks' rows,
    kept for the frozen count."""
    from texir_code_tpu_torch.models import material
    from texir_code_tpu_torch.ops import pallas_culled

    rows = []
    orig_cast = pallas_culled.cast_fans_culled

    def keep_rows(scene, origins, dirs, **kw):
        if kw.get("per_ray"):
            rows.append((tuple(origins), tuple(dirs), kw.get("fan_block", 8),
                         kw.get("exit_rows", 0)))
        return orig_cast(scene, origins, dirs, **kw)

    opt = prog.optimizer
    orig_step = opt.step
    opt.step = spanned(orig_step, "optim")
    try:
        with patched(pallas_culled, "cull_blocks", "cull"), \
                patched(material, "clamp_material_params", "optim"):
            pallas_culled.cast_fans_culled = keep_rows
            try:
                with traced_window(device) as holder:
                    losses = []
                    for _ in range(n):
                        with span("step"):
                            losses.append(torch.stack(prog.step()))
                    torch.stack(losses).cpu()
            finally:
                pallas_culled.cast_fans_culled = orig_cast
    finally:
        opt.step = orig_step
    return holder, rows


def _walk_work(prog, rows, device):
    from port_bench import roofline

    model = prog.runner.model
    fs = roofline.FrozenScene(prog.scene_mesh, model.cluster_scene.lb,
                              model.occluders is not None, device)
    total = WalkWork(tests=0, nbytes=0)
    for o, d, fb, er in rows:
        w = roofline.walk_work(fs, o, d, fb, er, per_ray=True)
        total = WalkWork(tests=total.tests + w.tests,
                         nbytes=total.nbytes + w.nbytes)
    return total


def reference_check(scene, cfg, got, inputs, irt, device,
                    dtype=torch.float32):
    """The warm-up's first steps against the plain reference's."""
    from port_bench.reference.mat_ref import MatReference

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = MatReference(scene.mesh, scene.hdr_texture, irt, cfg, device,
                           dtype=dtype)
        losses, grads, change = ref.train(inputs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = dict(losses=losses,
                grads=[g.double().norm().item() for g in grads],
                change=[c.double().norm().item() for c in change])
    return compare(got, want, cfg["limits"])


def compare(got: dict, want: dict, limits: dict):
    """The numbers a Mat run is judged by, each with its limit:
    loss_rel: the worst of the followed steps' |loss - ref| / |ref|;
    grad1_gap / change_gap: the worst leaf's gap between the norms of the
    first gradient / of the atlases' change over the followed steps, over
    the larger of the reference's norm of that leaf and of the median
    leaf."""

    def gap(a, b):
        med = statistics.median(b)
        return max(abs(x - y) / max(y, med, 1e-30) for x, y in zip(a, b))

    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], want["losses"]))
    vals = {"loss_rel": loss_rel,
            "grad1_gap": gap(got["grads"], want["grads"]),
            "change_gap": gap(got["change"], want["change"])}
    vals = {k: (v if math.isfinite(v) else float("inf"))
            for k, v in vals.items()}
    return {k: (v, float(limits[k])) for k, v in vals.items()}


def control_readings(cell, seeds, seconds, device):
    """[(seed, program's numbers, control's numbers)]: the program's
    followed steps and the reference's in bfloat16, each against the
    float32 reference."""
    rows = []
    for seed in seeds:
        seen = {}

        def both(scene, cfg, got, inputs, irt, device):
            from port_bench.reference.mat_ref import MatReference

            want = {}
            for name, dt in (("ref", torch.float32), ("low", torch.bfloat16)):
                ref = MatReference(scene.mesh, scene.hdr_texture, irt, cfg,
                                   device, dtype=dt)
                losses, grads, change = ref.train(inputs)
                want[name] = dict(
                    losses=losses,
                    grads=[g.double().norm().item() for g in grads],
                    change=[c.double().norm().item() for c in change])
                del ref
            seen["control"] = compare(want["low"], want["ref"],
                                      cfg["limits"])
            return compare(got, want["ref"], cfg["limits"])

        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            _, _, checks, _, _, _ = run(cell, seed, seconds, False, device,
                                        time.time(), check=both)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        rows.append((seed, {k: v for k, (v, _) in checks.items()},
                     {k: v for k, (v, _) in seen["control"].items()}))
        import json

        print(json.dumps({"seed": seed, "program": rows[-1][1],
                          "control": rows[-1][2]}), flush=True)
    return rows
