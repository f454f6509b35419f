"""Turn the JAX package's arrays (as numpy) into the port's objects.

The bake's state is the packed scene; the Mat stage's is the mesh and two
learned atlases; a field stage's or a baseline head's is its networks'
weights.  These converters let a caller hand the very arrays the
JAX package built (after `np.asarray`) to the port, so both packages run
on the same scene and weights; the port's own packing is checked
separately for equality with the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.geometry.mesh import Mesh
from texir_code_tpu_torch.geometry.occluders import OccluderSet
from texir_code_tpu_torch.models.material import MaterialParams
from texir_code_tpu_torch.models.tbl import TBL
from texir_code_tpu_torch.ops.raycast import DeviceBVH
from texir_code_tpu_torch.ops.pallas_culled import ClusterScene


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)


def cluster_scene_from_numpy(
    rows3, prims3, cluster_lo, cluster_hi, diameter, lb: int, has_uv: bool,
    device="cuda",
) -> ClusterScene:
    """ClusterScene from the arrays of a JAX `ClusterScene`."""
    dev = resolve_device(device)
    return ClusterScene(
        rows3=_t(rows3, np.float32, dev),
        prims3=_t(prims3, np.int32, dev),
        cluster_lo=_t(cluster_lo, np.float32, dev),
        cluster_hi=_t(cluster_hi, np.float32, dev),
        diameter=float(np.float32(diameter)),
        lb=int(lb),
        has_uv=bool(has_uv),
    )


def tbl_from_numpy(uv_u, uv_v, planes, device="cuda", packed=None) -> TBL:
    """TBL from a JAX `TBL`'s per-corner uvs and three atlas planes, and
    optionally its DeviceBVH's supernode table (`packed`, [N, 8 + 10·lw])."""
    dev = resolve_device(device)
    bvh = (None if packed is None else DeviceBVH(
        _t(packed, np.float32, dev), (np.shape(packed)[1] - 8) // 10))
    return TBL(
        uv_u=_t(uv_u, np.float32, dev),
        uv_v=_t(uv_v, np.float32, dev),
        planes=tuple(_t(p, np.float32, dev) for p in planes),
        bvh=bvh,
    )


def occluders_from_numpy(
    axis, p, rect_lo, rect_hi, sep_margin, device="cuda"
) -> OccluderSet:
    """OccluderSet from a JAX `OccluderSet`'s fields."""
    dev = resolve_device(device)
    return OccluderSet(
        axis=tuple(int(a) for a in axis),
        p=_t(p, np.float32, dev),
        rect_lo=_t(rect_lo, np.float32, dev),
        rect_hi=_t(rect_hi, np.float32, dev),
        sep_margin=float(np.float32(sep_margin)),
    )


def material_params_from_numpy(albedo, roughness, device="cuda",
                               requires_grad: bool = False) -> MaterialParams:
    """MaterialParams from a JAX `MaterialParams`' albedo [Ra, Ra, 3] and
    roughness [Rr, Rr, 1] atlases."""
    dev = resolve_device(device)
    return MaterialParams(
        albedo=_t(albedo, np.float32, dev).requires_grad_(requires_grad),
        roughness=_t(roughness, np.float32, dev).requires_grad_(requires_grad),
    )


def mesh_from_numpy(vertices, faces, uvs=None, uv_faces=None,
                    vertex_normals=None) -> Mesh:
    """The port's Mesh from a JAX-side mesh's arrays, so the port's
    MaterialModel builds its scene tensors (TBL, cluster scene, G-buffer
    attributes) from the same mesh as the JAX model."""
    def arr(x, dtype):
        return None if x is None else np.array(x, dtype=dtype)

    return Mesh(
        vertices=arr(vertices, np.float32), faces=arr(faces, np.int32),
        uvs=arr(uvs, np.float32), uv_faces=arr(uv_faces, np.int32),
        vertex_normals=arr(vertex_normals, np.float32),
    )


def _flax_leaves(tree, path=()):
    """(path, array) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def field_params_from_flax(params, module: torch.nn.Module) -> dict:
    """The state dict of a `models.fields` network from a flax params tree
    (numpy arrays, with or without its top "params" level).  A flax Dense
    {kernel [in, out], bias [out]} becomes an `nn.Linear` {weight [out,
    in], bias [out]}: `Dense_i` is `layers.i` (the field networks,
    IRSGNetwork among them), or the module names each
    state-dict prefix's flax path in `flax_names()` (the heads' networks;
    a path that ends in a parameter, as the hash grid's `table`, is copied
    as it is).  An `nn.ModuleDict` (the NeILF head's {"brdf", "light"})
    takes a dict of such trees.  Every flax leaf must land on a state-dict
    entry of the same shape and every entry must be filled; load the
    result with `module.load_state_dict`."""
    tree = params.get("params", params)
    if isinstance(module, torch.nn.ModuleDict):
        if set(tree) != set(module.keys()):
            raise ValueError(f"expected {sorted(module.keys())}, got "
                             f"{sorted(tree)}")
        return {f"{name}.{k}": v for name, sub in module.items()
                for k, v in field_params_from_flax(tree[name], sub).items()}
    want = module.state_dict()
    names = (module.flax_names() if hasattr(module, "flax_names") else
             {f"layers.{i}": (f"Dense_{i}",)
              for i in range(len(module.layers))})
    pairs = {}  # state-dict key → flax leaf path
    for prefix, path in names.items():
        if prefix in want:
            pairs[prefix] = path
            continue
        pairs[f"{prefix}.weight"] = path + ("kernel",)
        if f"{prefix}.bias" in want:
            pairs[f"{prefix}.bias"] = path + ("bias",)
    leaves = dict(_flax_leaves(tree))
    if set(pairs.values()) != set(leaves) or set(pairs) != set(want):
        raise ValueError(
            f"the flax tree {sorted('/'.join(p) for p in leaves)} does not "
            f"map onto the module's {sorted(want)}")
    out = {}
    for key, path in pairs.items():
        val = np.asarray(leaves[path])
        if path[-1] == "kernel":
            val = val.T
        ref = want[key]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape}, the "
                             f"module's {key} has {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(val, np.float32)).to(ref.device)
    return out
