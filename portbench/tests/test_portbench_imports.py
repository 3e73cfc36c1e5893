"""What the benchmark loads: no JAX and no JAX package in the measuring
process, top-level names compared whole, and nothing of the program in
the reference."""

from __future__ import annotations

import subprocess
import sys

from portbench.lib.common import ROOT, forbidden_modules


def test_top_level_names_compared_whole():
    loaded = ["cips3dpp_torch", "cips3dpp_torch.serving", "jaxtyping", "flaxen",
              "cips3dpp_tpu_notes", "torch.jax_shim"]
    assert forbidden_modules(loaded) == []
    assert forbidden_modules(loaded + ["jax", "jaxlib.xla", "flax.linen", "cips3dpp_tpu.core"]) \
        == ["cips3dpp_tpu.core", "flax.linen", "jax", "jaxlib.xla"]


def _loaded_after(code: str) -> set[str]:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_after("import portbench.reference.serve, portbench.reference.train, "
                         "portbench.work.flops, portbench.work.roofline")
    assert not tops & {"cips3dpp_torch", "cips3dpp_tpu", "jax", "jaxlib", "flax"}


def test_the_measured_path_loads_no_jax():
    tops = _loaded_after(
        "from portbench.lib import harness, common\n"
        "bench = harness.benchmark()\n"
        "for c in bench['workloads']:\n"
        "    cfg = common.load_named('configs', c['config'])\n"
        "    common.load_named('systems', cfg['system'], '.py')\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    common.load_named('metrics', m['name'], '.py')\n"
        "import cips3dpp_torch.serving, cips3dpp_torch.train.train_loop\n"
        "import cips3dpp_torch.io.dataset, cips3dpp_torch.models.discriminator_pose")
    assert "cips3dpp_torch" in tops
    assert not tops & {"cips3dpp_tpu", "jax", "jaxlib", "flax"}
