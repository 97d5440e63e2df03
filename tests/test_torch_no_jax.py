"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``, and no module of
the port imports ``msgpack`` (the card's machine lacks it; the port's
request journal writes JSON)."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(names), bad)
"""

# The modules of each slice, which must be among those imported.
SLICE_MODULES = {
    "repro_torch.kernels.flash_decode", "repro_torch.serve.engine",
    "repro_torch.launch.serve",
    "repro_torch.kernels.wire_hop", "repro_torch.dist.fedcomm",
    "repro_torch.train.fed_trainer", "repro_torch.train.trainer",
    "repro_torch.core.fedtime", "repro_torch.core.client",
    "repro_torch.core.clustering", "repro_torch.core.comm",
    "repro_torch.core.lora", "repro_torch.core.quant",
    "repro_torch.core.revin", "repro_torch.core.patching",
    "repro_torch.core.server", "repro_torch.optim.adamw",
    "repro_torch.optim.fedadam", "repro_torch.data.timeseries",
    "repro_torch.data.federated", "repro_torch.fault.guard",
    "repro_torch.models.losses", "repro_torch.tree",
    "repro_torch.kernels.ops", "repro_torch.kernels.qlora_matmul",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.rmsnorm",
    "repro_torch.fault.clock", "repro_torch.fault.plan", "repro_torch.obs",
    "repro_torch.obs.trace", "repro_torch.obs.sketch",
    "repro_torch.obs.flight", "repro_torch.obs.devmem",
    "repro_torch.serve.journal",
}


def test_importing_every_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().split(" ", 1)
    missing = SLICE_MODULES - set(names.split(","))
    assert not missing, missing                 # every module was imported
    assert bad == "[]", bad


def test_no_source_line_imports_jax_or_repro():
    """Also the imports inside functions, which the probe above never
    runs."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


_MSGPACK_PROBE = """
import importlib, os, pkgutil, sys, tempfile
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
from repro_torch.serve.journal import RequestJournal, replay_journal
from repro_torch.serve.request import Request
path = os.path.join(tempfile.mkdtemp(), "j.jrnl")
with RequestJournal(path) as j:
    j.log_submit(Request(id="a", prompt=[1, 2], max_new_tokens=2))
    j.log_token("a", 3)
assert replay_journal(path).tokens == {{"a": [3]}}
print(sorted(m for m in sys.modules if m.split(".")[0] == "msgpack"))
"""


def test_no_module_imports_msgpack():
    """Neither an import line nor a run of the journal loads msgpack."""
    pat = re.compile(r"^\s*(import|from)\s+msgpack(\.|\s|$)")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c",
         _MSGPACK_PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
