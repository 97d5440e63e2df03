"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``, and no module of
the port imports ``msgpack`` or ``zstandard`` (the card's machine lacks
both; the port's request journal writes JSON, its checkpoints their own
format).  Every entry point of the port runs on the card unless its
caller asks for the CPU."""

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
    "repro_torch.core.secure_agg", "repro_torch.fault.snapshot",
    "repro_torch.train.checkpoint", "repro_torch.obs.fleet",
    "repro_torch.optim.schedules", "repro_torch.baselines.dlinear",
    "repro_torch.baselines.patchtst", "repro_torch.baselines.fslstm",
    "repro_torch.launch.mesh", "repro_torch.dist.collectives",
    "repro_torch.dist.sharding", "repro_torch.kernels.ring_allreduce",
    "repro_torch.dist.fed", "repro_torch.dist.decode",
    "repro_torch.launch.steps", "repro_torch.models.transformer",
    "repro_torch.models.layers.attention",
    "repro_torch.launch.train", "repro_torch.data.tokens",
    "repro_torch.models.registry", "repro_torch.configs.smollm_360m",
    "repro_torch.launch.dryrun", "repro_torch.launch.specs",
    "repro_torch.launch.hlo_cost", "repro_torch.configs.base",
    "repro_torch.configs.registry", "repro_torch.obs.cost",
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
import numpy as np, torch
from repro_torch.fault import load_round_state, save_round_state
snap = os.path.join(os.path.dirname(path), "s.ckpt")
save_round_state(snap, {{"w": torch.ones(3)}},
                 {{"rng": np.random.default_rng(0).bit_generator.state}})
assert torch.equal(load_round_state(snap, "cpu")[1]["w"], torch.ones(3))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("msgpack", "zstandard")))
"""


def test_no_module_imports_msgpack():
    """Neither an import line nor a run of the journal or of a round-state
    snapshot loads msgpack or zstandard."""
    pat = re.compile(r"^\s*(import|from)\s+(msgpack|zstandard)(\.|\s|$)")
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


_DEVICE_PROBE = """
import importlib, inspect, pkgutil, sys
sys.path[:0] = [{src!r}]
import repro_torch
out = []
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    mod = importlib.import_module(m.name)
    for obj in vars(mod).values():
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        fns = ([v for v in vars(obj).values() if inspect.isfunction(v)]
               if inspect.isclass(obj) else [obj])
        for fn in fns:
            if not inspect.isfunction(fn):
                continue
            for name, p in inspect.signature(fn).parameters.items():
                if name in ("device", "device_type") and \
                        isinstance(p.default, str):
                    out.append((m.name, fn.__qualname__, p.default))
print(sorted({{d for *_, d in out}}), len(out))
print([o for o in out if o[2] != "cuda"])
"""


def test_entry_points_default_to_the_card():
    """Every function of the port with a ``device`` or ``device_type``
    keyword defaults it to ``"cuda"``: the CPU is the caller's explicit
    choice."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _DEVICE_PROBE.format(src=str(SRC))],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    kinds, cpu = out.stdout.strip().splitlines()
    assert kinds.startswith("['cuda'] ") and int(kinds.split()[-1]) > 10, \
        kinds
    assert cpu == "[]", cpu
