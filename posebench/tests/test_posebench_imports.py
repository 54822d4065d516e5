"""What a run loads: neither JAX nor the JAX package (top-level names
compared whole), and the reference loads nothing of the measured program."""
import subprocess
import sys

from posebench import harness

REHEARSAL = """
import sys
sys.path.insert(0, {root!r})
from posebench.tests.tiny import run_tiny
result, _ = run_tiny("hr18_lmo.serve_b512", seed=5, traced=True)
assert result["correct"]
from posebench import harness
print("BANNED", harness.banned_modules())
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import posebench.reference.model, posebench.reference.poses, posebench.reference.train
import posebench.flops, posebench.weights, posebench.inputs
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] == "checkerpose_tpu_torch"))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_nor_the_jax_package():
    assert "BANNED []" in _run(REHEARSAL)


def test_banned_names_are_compared_whole():
    sys.modules.setdefault("checkerpose_tpu_torch_probe", sys)
    try:
        assert "checkerpose_tpu_torch_probe" not in harness.banned_modules()
    finally:
        del sys.modules["checkerpose_tpu_torch_probe"]


def test_the_reference_loads_nothing_of_the_program():
    assert "LOADED []" in _run(REFERENCE)
