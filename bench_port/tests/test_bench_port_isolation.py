"""What the harness loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `cvaegan_tpu` (compared whole: `cvaegan_tpu_torch`
is the program), and the reference nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import glob, importlib.util, json, os, sys
sys.path.insert(0, {root!r})
import bench_port.run, bench_port.worker, bench_port.control
from bench_port.harness import spec
for kind in ("drivers", "metrics", "counts"):
    for path in sorted(glob.glob(os.path.join({root!r}, "bench_port", kind, "*.py"))):
        spec.load_module(__import__("pathlib").Path(path), "probe_" + os.path.basename(path))
import bench_port.harness.program, bench_port.harness.trace
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(top))
"""

REFERENCE_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import bench_port.reference.nets, bench_port.reference.train, bench_port.reference.generate
import bench_port.data.car_hacking, bench_port.harness.compare, bench_port.harness.weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    top = _top_level(PROBE)
    assert not top & {"jax", "jaxlib", "flax", "cvaegan_tpu"}, top


def test_the_reference_loads_nothing_of_the_program():
    top = _top_level(REFERENCE_PROBE)
    assert not top & {"jax", "jaxlib", "flax", "cvaegan_tpu", "cvaegan_tpu_torch"}, top
