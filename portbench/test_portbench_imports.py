"""Nothing the benchmark loads brings in JAX or the JAX package
``repro``, and the plain reference brings in nothing of the program
``repro_torch`` either.  Modules are compared by their top-level name,
whole: ``repro_torch`` begins with ``repro`` and is not it."""

import json
import subprocess
import sys

import pb_spec

PROBE = """
import json, sys
sys.path[:0] = [{here!r}, {src!r}]
{imports}
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = PROBE.format(here=str(pb_spec.HERE), src=str(pb_spec.ROOT / "src"), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in pb_spec.benchmark()[s]]
    imports = "\n".join(["import pb_spec, pb_harness, pb_trace, run, calibrate"]
                        + [f"pb_spec.reader({n!r})" for n in names])
    top = _top_level(imports)
    assert "repro_torch" in top  # the system under test is loaded
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    top = _top_level("import pb_reference, pb_weights, pb_traffic, pb_roofline")
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
