"""Multi-rank dry run: one data-parallel Mat stage-2 step on tiny shapes.

The counterpart of the JAX package's `__graft_entry__.py::dryrun_multichip`
on torch.distributed:

    python -m texir_code_tpu_torch.parallel.dryrun [--ranks 2] [--device cpu]

spawns `--ranks` processes, on the card unless --device cpu asks for the
CPU, that join one process group (gloo on the CPU
and for ranks that share a card, NCCL when each has its own) and run one
stage-2 step of the MaterialModel on JAX's tiny setup (make_scene(24),
pano 16×32, spec 4, 16² atlases) with the pixels split over the ranks,
the full loss on the gathered outputs, the atlas-gradient all-reduce,
Adam and the clamp.  Each rank checks that its loss is within 1e-5
(relative) of the single-process step's, that the all-reduce ran
(parallel.mesh.COUNTS), and that the atlases after the step are bit-equal
on every rank.  `run_ranks` is the launcher: a rank that fails ends the
others.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cmds: Sequence[Sequence[str]], timeout: float,
              env: Optional[dict] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run one process per command (the ranks of one group) and return
    their outputs (stdout and stderr together).  When a rank exits
    non-zero, or `timeout` seconds pass, every other rank is killed and a
    RuntimeError carries the outputs."""
    env = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(len(cmds))]
        procs = [subprocess.Popen(list(c), stdout=f, stderr=subprocess.STDOUT,
                                  env=env, cwd=cwd)
                 for c, f in zip(cmds, logs)]

        def outputs():
            out = []
            for f in logs:
                f.flush()
                f.seek(0)
                out.append(f.read())
            return out

        try:
            t_end = time.time() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if time.time() > t_end:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        out = outputs()
        for f in logs:
            f.close()
    if failed is not None:
        for r, o in enumerate(out):
            print(f"--- rank {r} (exit {procs[r].returncode}) ---\n{o}",
                  flush=True)
        what = ("timed out" if failed == "timeout"
                else f"rank {failed} exited {procs[failed].returncode}")
        raise RuntimeError(f"run_ranks: {what}")
    return out


def _tiny_setup(device, spmd_mesh=None):
    """The JAX dry run's tiny setup (__graft_entry__.py:14-33):
    (model, params, mvp, cam_position)."""
    from texir_code_tpu_torch.data.synthetic import make_scene
    from texir_code_tpu_torch.models.material import (
        MaterialModel,
        init_material_params,
    )
    from texir_code_tpu_torch.ops.gbuffer import cube_mvp

    scene = make_scene(atlas_res=24)
    irt = np.full((16, 16, 3), 1.0, np.float32)
    model = MaterialModel(scene.mesh, scene.hdr_texture, irt,
                          pano_res=(16, 32), sample_light=(8, 4),
                          spmd_mesh=spmd_mesh, device=device)
    pos = np.asarray(scene.camera_positions(1)[0], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    return model, init_material_params(16, 16, device=device), cube_mvp(ext), pos


def _step(model, params, mvp, pos, mesh=None):
    """One stage-2 step (render, loss, backward, the gradient all-reduce
    under `mesh`, Adam, clamp): (loss, the new MaterialParams)."""
    from texir_code_tpu_torch.models.losses import render_loss
    from texir_code_tpu_torch.models.material import (
        MaterialParams,
        clamp_material_params,
    )

    p = MaterialParams(params.albedo.clone().requires_grad_(True),
                       params.roughness.clone().requires_grad_(True))
    opt = torch.optim.Adam([p.albedo, p.roughness], lr=3e-2)
    out = model._forward(p, mvp, pos, 2, seed=0)
    ones = torch.ones_like(out["rgb"][..., :1])
    gt = torch.full_like(out["rgb"], 0.2)
    seg = torch.zeros(ones.shape[:-1], dtype=torch.int64, device=ones.device)
    loss, _ = render_loss(gt, out, ones, seg, 6, 2, seg_region=ones)
    loss.backward()
    if mesh is not None:
        mesh.all_reduce_grads([p.albedo, p.roughness])
    opt.step()
    with torch.no_grad():
        return loss.item(), clamp_material_params(p)


def dryrun_rank(device) -> dict:
    """This rank's part of the dry run (a process group is up); raises on
    a failed check."""
    from texir_code_tpu_torch.parallel.mesh import COUNTS, make_device_mesh

    mesh = make_device_mesh(device=device)
    model, params, mvp, pos = _tiny_setup(device, spmd_mesh=mesh)
    single, _, _, _ = _tiny_setup(device)
    COUNTS.clear()
    loss, p = _step(model, params, mvp, pos, mesh)
    reduces, nbytes = COUNTS["all_reduce"], COUNTS["all_reduce_bytes"]
    loss_1, _ = _step(single, params, mvp, pos)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if not abs(loss - loss_1) <= 1e-5 * max(1.0, abs(loss_1)):
        raise RuntimeError(f"sharded loss {loss} != single-process {loss_1}")
    if reduces < 2:
        raise RuntimeError(f"the gradient all-reduce did not run ({reduces})")
    for name in ("albedo", "roughness"):
        t = getattr(p, name).reshape(1, -1).contiguous()
        every = mesh.all_gather_rows(t, [1] * mesh.size)
        if not all(torch.equal(every[0], row) for row in every):
            raise RuntimeError(f"the {name} atlas differs across ranks")
    return dict(rank=mesh.rank, ranks=mesh.size, loss=loss,
                loss_single=loss_1, all_reduces=reduces,
                all_reduce_bytes=nbytes)


def dryrun_multichip(n_ranks: int = 2, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Spawn n_ranks processes that run `dryrun_rank` in one group on
    `device` (the card unless the caller asks for the CPU) and return rank
    0's summary; raises if a rank fails."""
    from texir_code_tpu_torch.device import resolve_device

    device = resolve_device(device).type
    coord = f"127.0.0.1:{free_port()}"
    cmds = [[sys.executable, "-m", "texir_code_tpu_torch.parallel.dryrun",
             "--rank", str(r), "--ranks", str(n_ranks), "--coordinator",
             coord, "--device", device] for r in range(n_ranks)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = run_ranks(cmds, timeout, env=env, cwd=REPO_ROOT)
    lines = [l for l in out[0].splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="texir_code_tpu_torch.parallel.dryrun")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, default=None,
                        help="(internal) run as this rank")
    parser.add_argument("--coordinator", default=None)
    args = parser.parse_args(argv)
    if args.rank is None:
        print(json.dumps(dryrun_multichip(args.ranks, args.device)))
        return 0
    from texir_code_tpu_torch.parallel.multihost import (
        initialize_multihost,
        shutdown_multihost,
    )

    torch.set_num_threads(1)
    initialize_multihost(args.coordinator, args.ranks, args.rank,
                         device=args.device)
    try:
        device = args.device
        if device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        print(json.dumps(dryrun_rank(device)), flush=True)
    finally:
        shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
