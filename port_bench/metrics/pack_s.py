"""pack_s: host seconds of set-up spent building the scene and packing it
for the card (BVH, TBL, leaf rows, cluster scene, occluders; the atlas'
texels for a bake, the views' G-buffers for a Mat step)."""

UNIT = "s"
MOVES = "setup_s"


def read(r):
    return r.host.get("pack_s")
