"""Nothing the harness loads is JAX or the JAX package: each loaded
module's top-level name, the part before the first dot, compared whole
(the port's name begins with the JAX package's)."""

import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vamb_tpu"}

PROBE = """
import sys, glob
sys.path.insert(0, {root!r})
import portbench.run as entry
from portbench.lib import harness
from portbench.tests import readings
for path in sorted(glob.glob({root!r} + "/portbench/windows/*.py") + glob.glob({root!r} + "/portbench/metrics/*.py")):
    harness.load_module(path, "probe_" + path.rsplit("/", 1)[1].replace(".", "_"))
import portbench.reference.vae_steps, portbench.reference.cluster_check
import vamb_torch, vamb_torch.cluster, vamb_torch.models.vae, vamb_torch.kernels
print(sorted({{m.split(".")[0] for m in list(sys.modules)}}))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "vamb_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_the_runs_check_compares_whole_names():
    import portbench.run as entry

    saved = dict(sys.modules)
    try:
        sys.modules["vamb_tpu_like"] = sys.modules["sys"]
        sys.modules.pop("vamb_tpu", None)
        assert "vamb_tpu" not in entry.forbidden_modules() or "vamb_tpu" in saved
        sys.modules["vamb_tpu.cluster"] = sys.modules["sys"]
        assert "vamb_tpu" in entry.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_source_imports_the_jax_package_or_the_old_harnesses():
    import re

    banned = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|vamb_tpu|chip_smoke|bench|benchmark)\b",
                        re.M)
    hits = [str(p) for p in (ROOT / "portbench").rglob("*.py") if banned.search(p.read_text())]
    assert not hits
