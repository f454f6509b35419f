"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the program."""

import os
import subprocess
import sys

from port_bench.run import loaded_forbidden
from port_bench.tests import tiny


def test_names_compare_whole():
    assert loaded_forbidden(["texir_code_tpu_torch.ops.texture",
                             "numpy"]) == []
    assert loaded_forbidden(["texir_code_tpu.ops", "jaxlib.xla_client",
                             "texir_code_tpu_torch"]) == [
        "jaxlib", "texir_code_tpu"]
    assert loaded_forbidden(["flax.linen", "jax"]) == ["flax", "jax"]
    assert loaded_forbidden(["jaxtyping", "flaxen"]) == []


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=tiny.ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600, check=True).stdout


def test_a_run_loads_no_jax(tmp_path):
    out = _python(
        "import sys\n"
        "from port_bench.tests import tiny\n"
        "from port_bench.run import loaded_forbidden\n"
        f"root, bench = tiny.make_root({str(tmp_path)!r})\n"
        "for cell in ('apartment-bake', 'building-mat'):\n"
        "    tiny.run(root, bench, cell, trace=True)\n"
        "import port_bench.control\n"
        "print('FOUND', loaded_forbidden())\n")
    assert "FOUND []" in out


def test_the_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import port_bench.reference.bake_ref, port_bench.reference.mat_ref\n"
        "import port_bench.scenes, port_bench.roofline\n"
        "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = out.split("TOP", 1)[1]
    for name in ("texir_code_tpu_torch", "texir_code_tpu", "jax"):
        assert f"'{name}'" not in top
