"""Sharded IrT baking: texel batches split over the ranks.

The port of the JAX package's `parallel/bake.py`.  The bake is
embarrassingly parallel over texels, so the sharding lives in
`IrradianceTextureBaker` itself (its `mesh` argument): rank r takes the
contiguous share `process_local_slice(nb, r, world)` of the Morton-ordered
batches and runs the single baker's own batch path on each (the culled
walk, kernel B1 `shared_uv`, with the multi-room knobs), and one
all-reduce (SUM) of the [n + pad, 3] output merges the disjoint rows.
The scene (TBL, cluster rows, atlas) is replicated.

`ShardedIrradianceBaker` is the JAX package's name for that baker over
the world's ranks.
"""

from __future__ import annotations

from typing import Optional

from texir_code_tpu_torch.models.tracer_irt import IrradianceTextureBaker
from texir_code_tpu_torch.parallel.mesh import DeviceMesh
from texir_code_tpu_torch.parallel.multihost import global_mesh


class ShardedIrradianceBaker(IrradianceTextureBaker):
    """IrradianceTextureBaker whose mesh defaults to the world's; `bake`
    returns the whole texture on every rank."""

    def __init__(self, tbl, mesh: Optional[DeviceMesh] = None, **kw):
        super().__init__(tbl, mesh=mesh or global_mesh(tbl.planes[0].device),
                         **kw)
