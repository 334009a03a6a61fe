"""Nothing the benchmark loads is JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the program."""
import json
import os
import subprocess
import sys

from perfbench import spec

ALL = """
import glob, json, os, sys
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
from perfbench import harness, spec, trace, control, program, inputs
for sub in ("traffic", "metrics", "tables", "laws/kernels", "probes"):
    for f in sorted(glob.glob(os.path.join(spec.PKG, sub, "*.py"))):
        spec.load_module(sub, os.path.basename(f)[:-3], [spec.PKG])
import perfbench.laws.roofline, perfbench.laws.embedder
import repro_torch.core.platform, repro_torch.serve.engine
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, os, sys
sys.path[:0] = [{root!r}]
import perfbench.reference.bruteforce, perfbench.reference.embedder
import perfbench.reference.controls, perfbench.inputs
import perfbench.laws.roofline, perfbench.laws.embedder
from perfbench import spec
spec.found("laws/kernels", [spec.PKG])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c",
                        code.format(root=spec.ROOT)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(ALL)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_whole_top_level_names():
    from perfbench.harness import forbidden_modules
    loaded = ["jax", "jax._src.core", "jaxlib.xla_client", "flax",
              "repro", "repro.core.engine", "repro_torch",
              "repro_torch.core.engine", "jaxtyping", "reprolib"]
    assert forbidden_modules(loaded) == sorted(
        ["jax", "jax._src.core", "jaxlib.xla_client", "flax", "repro",
         "repro.core.engine"])
