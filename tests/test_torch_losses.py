"""Port vs JAX: the Mat-stage losses (`models/losses.py`) on the same numpy
inputs from a seed, rtol 1e-5 (the segment sums run in another order).

The quantile test puts many equal values in one class, so the two
packages' (class, value) lexsorts must agree on ties; the stage-2 and
seg-mode-2 tests use per-pixel room ids as the Mat runner reads them from
a roomseg image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.models import losses as JL
from texir_code_tpu_torch.models import losses as TL

RTOL = 1e-5
NC = 9  # classes, the last one the runner's ignore bucket


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    f, h, w = 6, 12, 12
    seg = rng.integers(0, NC - 1, (f, h, w)).astype(np.int32)
    seg[0, :6] = NC - 1
    return dict(
        f=f, h=h, w=w, seg=seg,
        img=rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32),
        rough=rng.uniform(0.01, 0.8, (f, h, w, 1)).astype(np.float32),
        womip=rng.uniform(0.01, 0.8, (f, h, w, 1)).astype(np.float32),
        hl=(rng.random((f, h, w, 1)) < 0.4).astype(np.float32),
        valid=(rng.random((f, h, w, 1)) < 0.9).astype(np.float32),
        room=rng.integers(0, 3, (f, h, w)).astype(np.int32),
        gt=rng.uniform(0, 2, (f, h, w, 3)).astype(np.float32),
        rgb=rng.uniform(0, 2, (f, h, w, 3)).astype(np.float32),
        mask=(rng.random((f, h, w, 1)) < 0.95).astype(np.float32),
        region=(seg < NC - 1).astype(np.float32)[..., None],
    )


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol)


def test_masked_quantile_per_class_with_ties():
    rng = np.random.default_rng(2)
    p, nc = 400, 7
    vals = rng.integers(0, 5, p).astype(np.float32) * 0.25  # many ties
    seg = rng.integers(0, nc, p).astype(np.int32)
    mask = (rng.random(p) < 0.6).astype(np.float32)
    seg[seg == 3] = 4  # class 3 empty
    q = rng.uniform(0, 1, nc).astype(np.float32)
    qa, ca = JL.masked_quantile_per_class(_j(vals), _j(seg), _j(mask), nc, _j(q))
    qb, cb = TL.masked_quantile_per_class(_t(vals), _t(seg), _t(mask), nc, _t(q))
    _close(ca, cb.numpy())
    _close(qa, qb.numpy())
    assert float(qb[3]) == 0.0
    # against torch.quantile per class
    for c in range(nc):
        sel = (seg == c) & (mask > 0)
        if sel.any():
            ref = torch.quantile(_t(vals[sel]), float(q[c]))
            np.testing.assert_allclose(float(qb[c]), float(ref), rtol=1e-6)


def test_segment_mean(data):
    v = data["img"].reshape(-1, 3)
    seg = data["seg"].reshape(-1)
    wgt = data["valid"].reshape(-1)
    a = JL._segment_mean(_j(v), _j(seg), NC, _j(wgt))
    b = TL._segment_mean(_t(v), _t(seg), NC, _t(wgt))
    for x, y in zip(a, b):
        _close(x, y.numpy())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_seg_loss_modes(data, mode):
    d = data
    kw_j, kw_t = {}, {}
    if mode == 1:
        for kw, conv in ((kw_j, _j), (kw_t, _t)):
            kw.update(img_womipmap=conv(d["womip"]), highlight=conv(d["hl"]),
                      valid_mask=conv(d["valid"]), override_class=3)
    if mode == 2:
        kw_j.update(room_id=_j(d["room"]), num_rooms=3)
        kw_t.update(room_id=_t(d["room"]), num_rooms=3)
    img = d["rough"] if mode else d["img"]
    a = JL.seg_loss(_j(img), _j(d["seg"]), NC, mode, **kw_j)
    b = TL.seg_loss(_t(img), _t(d["seg"]), NC, mode, **kw_t)
    _close(a, b.item())
    assert b.item() > 0


def test_erode_and_tv_loss(data):
    m = data["valid"][..., 0]
    _close(JL._erode(_j(m)), TL._erode(_t(m)).numpy())
    _close(JL.tv_loss(_j(data["img"]), _j(data["seg"]), NC),
           TL.tv_loss(_t(data["img"]), _t(data["seg"]), NC).item())


def test_ssim(data):
    a, b = data["img"], np.clip(data["img"] + 0.1 * data["rgb"] - 0.1, 0, 1)
    _close(JL.ssim(_j(a), _j(b)), TL.ssim(_t(a), _t(b)).item())
    assert TL.ssim(_t(a), _t(a)).item() == pytest.approx(1.0, abs=1e-6)
    assert TL.ssim(_t(a), _t(b)).item() <= 1.0


def test_l1_l2(data):
    _close(JL.l1(_j(data["gt"]), _j(data["rgb"])),
           TL.l1(_t(data["gt"]), _t(data["rgb"])).item())
    _close(JL.l2(_j(data["gt"]), _j(data["rgb"])),
           TL.l2(_t(data["gt"]), _t(data["rgb"])).item())


@pytest.mark.parametrize("loss_type", ["L1", "L2"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_render_loss(data, stage, loss_type):
    d = data

    def preds(conv):
        return dict(rgb=conv(d["rgb"]), empty_mask=conv(d["mask"]),
                    albedo=conv(d["img"]), roughness=conv(d["rough"]),
                    roughness_womipmap=conv(d["womip"]))

    def call(lib, conv):
        return lib.render_loss(
            conv(d["gt"]), preds(conv), conv(d["mask"]), conv(d["seg"]), NC,
            stage, highlight=conv(d["hl"]), seg_region=conv(d["region"]),
            room_id=conv(d["room"]), num_rooms=3, loss_type=loss_type,
            seg_weight_scale=0.5,
        )

    ta, sa = call(JL, _j)
    tb, sb = call(TL, _t)
    _close(ta, tb.item())
    _close(sa, sb.item())
