"""A run with its timed path broken underneath comes out not correct,
for each fault the cell can have, and so does the control: the reference
in bfloat16 in the program's place (the chip's readings of both are in
PERF.md; port_bench/control.py takes them at the cells' sizes).  The
runs skip the harness's look for a card and run on the CPU."""

import pytest
import torch

from port_bench import bake, mat
from port_bench.tests import tiny


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _bake_fault(monkeypatch, kind):
    from texir_code_tpu_torch.models import tracer_irt

    baker = tracer_irt.IrradianceTextureBaker
    orig = baker.bake_batch
    if kind == "unchanged":
        # a batch that leaves the texture as it was
        monkeypatch.setattr(baker, "bake_batch",
                            lambda self, p, *a, **k: torch.zeros_like(p))
    elif kind == "half":
        # half of each texel's rays left out, the mean over the rest
        est = tracer_irt.irradiance_estimator_soa

        def half(lighting, dirs, normal, n):
            h = dirs[0].shape[1] // 2
            return est(tuple(x[:, :h] for x in lighting),
                       tuple(x[:, :h] for x in dirs), normal, n // 2)

        monkeypatch.setattr(tracer_irt, "irradiance_estimator_soa", half)
    elif kind == "altered":
        # every fourth texel's answer altered where it is produced
        def altered(self, *a, **k):
            out = orig(self, *a, **k).clone()
            out[::4] *= 1.05
            return out

        monkeypatch.setattr(baker, "bake_batch", altered)


@pytest.mark.parametrize("cell", ["apartment-bake", "building-bake"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_bake_fault_is_caught(root, monkeypatch, cell, kind):
    r, bench = root
    _bake_fault(monkeypatch, kind)
    out = tiny.run(r, bench, cell)
    assert out["correct"] is False, out["checks"]


def _mat_fault(monkeypatch, kind):
    from texir_code_tpu_torch.models import losses, material

    if kind == "unchanged":
        # a step that leaves the atlases as they were
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        monkeypatch.setattr(material, "clamp_material_params",
                            lambda p, *a, **k: p)
    elif kind == "half":
        # half of the view's pixels left out, the mean over the rest
        orig = losses.render_loss

        def half(gt, preds, mask, seg, *a, **k):
            cut = {n: (v[:3] if torch.is_tensor(v) and v.dim() >= 3 else v)
                   for n, v in k.items()}
            return orig(gt[:3], {n: v[:3] for n, v in preds.items()},
                        mask[:3], seg[:3], *a, **cut)

        monkeypatch.setattr(losses, "render_loss", half)
    elif kind == "altered":
        # every fourth pixel's rendered colour altered where it is made
        orig = material.MaterialModel._forward

        def altered(self, *a, **k):
            out = dict(orig(self, *a, **k))
            rgb = out["rgb"].clone()
            rgb.view(-1, 3)[::4] *= 1.05
            out["rgb"] = rgb
            return out

        monkeypatch.setattr(material.MaterialModel, "_forward", altered)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_mat_fault_is_caught(root, monkeypatch, kind):
    r, bench = root
    _mat_fault(monkeypatch, kind)
    out = tiny.run(r, bench, "building-mat")
    assert out["correct"] is False, out["checks"]


def test_bake_control_is_caught(root):
    from port_bench.reference import bake_ref

    def control(scene, cfg, got, rows, cols, ids, seeds, device):
        args = (scene.mesh, cfg["atlas_res"], cfg["spp"],
                cfg["surface_eps"], rows, cols, ids, seeds)
        low, _ = bake_ref.irradiance(bake_ref.Scene(
            scene.mesh, scene.hdr_texture, device, dtype=torch.bfloat16),
            *args)
        return bake.reference_check(scene, cfg, low.cpu(), rows, cols, ids,
                                    seeds, device)

    r, bench = root
    for cell in ("apartment-bake", "building-bake"):
        out = tiny.run(r, bench, cell, check=control)
        assert out["correct"] is False, out["checks"]


def test_mat_control_is_caught(root):
    from port_bench.reference.mat_ref import MatReference

    def control(scene, cfg, got, inputs, irt, device):
        low = MatReference(scene.mesh, scene.hdr_texture, irt, cfg, device,
                           dtype=torch.bfloat16)
        losses, grads, change = low.train(inputs)
        got = dict(losses=losses,
                   grads=[g.double().norm().item() for g in grads],
                   change=[c.double().norm().item() for c in change])
        return mat.reference_check(scene, cfg, got, inputs, irt, device)

    r, bench = root
    out = tiny.run(r, bench, "building-mat", check=control)
    assert out["correct"] is False, out["checks"]
