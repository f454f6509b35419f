"""IrrT stage runner — one-shot irradiance-texture bake.

Rebuild of reference trainer/generate_ir_texture.py:31-82 plus the offline
padding/denoise tool (tools/padding_texture.py:49-87), fused into one runner:
bake → seam padding (distance transform) → denoise (à-trous) → write both
`0_irr_texture.hdr` (raw, next to the mesh, like the reference) and `irt.hdr`
(the padded/denoised texture the Mat stage loads,
models/mat_nvdiffrast.py:73).

The port of the JAX package's `train/irt.py`.  With more than one rank
(train.spmd "auto", the default) or train.spmd = true the texel batches
are split over the ranks (IrradianceTextureBaker's mesh, parallel.bake)
and every rank ends with the whole texture; rank 0 writes it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.config import Config
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.train.exp import (
    ExperimentDir,
    is_writer,
    seed_everything,
)


class IrrTextureRunner:
    def __init__(
        self,
        conf: Config,
        expname: str = "default",
        exps_root: str = "exps",
        is_continue: bool = False,
        timestamp: Optional[str] = None,
        conf_path: Optional[str] = None,
        texture_res: int = 1024,
        denoise: bool = True,
        device="cuda",
    ):
        from texir_code_tpu_torch.geometry import load_obj
        from texir_code_tpu_torch.geometry.bvh import build_bvh
        from texir_code_tpu_torch.geometry.occluders import extract_occluders
        from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
        from texir_code_tpu_torch.models.tracer_irt import (
            IrradianceTextureBaker,
            bake_geometry_textures,
        )
        from texir_code_tpu_torch.ops.fan_raycast import FanScene
        from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

        from texir_code_tpu_torch.parallel.multihost import global_mesh

        self.device = resolve_device(device)
        self.conf = conf
        self.exp = ExperimentDir(
            exps_root, "IrrT", expname, is_continue, timestamp, conf_path
        )
        self.generator = seed_everything(666)
        self.denoise = denoise

        self.path_mesh = conf.get_string("train.path_mesh_open3d")
        hdr_exposure = conf.get_float("train.hdr_exposure", default=0.0)
        self.mesh = load_obj(self.path_mesh)
        tex = hdrio.read_hdr(
            self.path_mesh.replace("out1.obj", "hdr_texture.hdr"), flip=True
        )
        fb = build_bvh(self.mesh.vertices, self.mesh.faces)
        self.tbl = build_tbl_from_flat(fb, self.mesh, tex, hdr_exposure,
                                       device=self.device)

        spp = conf.get_list("train.sample_light", default=[2048, 16])[0]
        # conf-tunable kernel-shape knobs with the JAX runner's defaults
        # (the apartment optimum there: lb=4 / fan_block=32 / exit_rows=16)
        lb = conf.get_int("train.bake_cluster_lb", default=4)
        fan_block = conf.get_int("train.bake_fan_block", default=32)
        exit_rows = conf.get_int("train.bake_exit_rows", default=16)
        texel_batch = conf.get_int("train.texel_batch", default=4096)
        kd = conf.get_int("train.bake_batches_per_dispatch", default=0)
        wedges = conf.get_int("train.bake_wedges", default=4)
        # multi-room scans: fan_block 16 + two_pass_cut ~0.25 (the JAX
        # package's bench); the 3-pass ladder adds two_pass_cut2
        two_pass_cut = conf.get("train.two_pass_cut", None)
        two_pass_cap = conf.get_float("train.two_pass_cap", default=0.125)
        two_pass_cut2 = conf.get("train.two_pass_cut2", None)
        two_pass_cap2 = conf.get_float("train.two_pass_cap2", default=0.25)
        # occlusion proxy: a pre-trace against the scene's k largest
        # triangles seeds per-ray t bounds (exact)
        proxy_k = conf.get_int("train.bake_proxy_k", default=0)

        fan = FanScene.from_flat(fb, triangle_uvs=self.mesh.triangle_uvs())
        clusters = ClusterScene.from_fan(
            fan, lb=lb, dense=True, device=self.device
        )
        # the JAX runner's rule (texir_code_tpu/train/irt.py:99-103), with
        # ranks in place of devices
        world = global_mesh(self.device)
        spmd = conf.get("train.spmd", "auto")
        sharded = spmd is True or (spmd == "auto" and world.size > 1)
        self.baker = IrradianceTextureBaker(
            self.tbl, spp=int(spp), texel_batch=texel_batch,
            cluster_scene=clusters, wedges=wedges,
            mesh=world if sharded else None)
        if kd > 0:
            self.baker.batches_per_dispatch = kd
        self.baker.fan_block = fan_block
        self.baker.exit_rows = exit_rows
        self.baker.two_pass_cut = two_pass_cut
        self.baker.two_pass_cap = two_pass_cap
        self.baker.two_pass_cut2 = two_pass_cut2
        self.baker.two_pass_cap2 = two_pass_cap2
        if proxy_k:
            self.baker.proxy_scene = ClusterScene.proxy_from_fan(
                fan, k=proxy_k, device=self.device
            )
        # proven rectangular occluders (geometry/occluders.py): exact
        # host-precomputed PVS; conf train.bake_occluders
        if conf.get("train.bake_occluders", True):
            self.baker.occluders = extract_occluders(
                self.mesh, device=self.device
            )
        self.texture_res = texture_res
        self._geom = bake_geometry_textures(self.mesh, texture_res)

    def run(self) -> np.ndarray:
        from texir_code_tpu_torch.ops.postprocess import atrous_denoise, pad_texture

        twopass = profiling.counter("twopass")
        twopass.clear()
        t0 = time.time()
        tex = self.baker.bake(self._geom, self.generator, progress=True)
        texels = int(self._geom.valid.sum())
        rays = texels * self.baker.spp
        dt = time.time() - t0
        if rays >= 10**6:
            print(
                f"IrT bake: {rays/1e6:.1f} Mrays in {dt:.1f}s "
                f"({rays/dt/1e6:.2f} Mrays/s)"
            )
        else:
            print(
                f"IrT bake: {texels} texels x {self.baker.spp} spp "
                f"({rays} rays) in {dt:.1f}s"
            )
        if self.baker.two_pass_cut is not None:
            print(f"IrT two-pass: {twopass['overflows']} of "
                  f"{twopass['calls']} traces overflowed the straggler "
                  f"capacity (traced in full): batches "
                  f"{self.baker.overflowed_batches} of "
                  f"{-(-texels // self.baker.texel_batch)}")
        # raw bake next to the mesh, as the reference writes it (:78-82)
        raw_path = self.path_mesh.replace("out1.obj", "0_irr_texture.hdr")
        padded = pad_texture(tex, self._geom.valid)
        if self.denoise:
            padded = atrous_denoise(
                torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
            ).cpu().numpy()
        out_path = self.path_mesh.replace("out1.obj", "irt.hdr")
        if is_writer():
            hdrio.write_hdr(raw_path, tex, flip=True)
            hdrio.write_hdr(out_path, padded, flip=True)
            print(f"IrT written: {raw_path} and {out_path}")
        return padded
