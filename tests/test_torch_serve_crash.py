"""kill -9 mid-trace: the port's journal replay in real processes, as the
reference's ``tests/test_serving_chaos.py::
test_kill9_mid_trace_journal_replay_bit_identical``.

A child process serves qwen3-0.6b's smoke config on the CPU (2 slots, a
48-slot cache, 6 requests) with a request journal and SIGKILLs itself at
engine step 3.  A fresh process replays the journal with
``repro_torch.serve.journal`` and finishes every unfinished request; a
third runs the trace uninterrupted.  Nothing may be lost or duplicated,
and every request's tokens must equal the uninterrupted run's bit for bit.
"""

import os
import signal
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import os, signal, sys
import numpy as np, torch
sys.path.insert(0, os.path.join({repo!r}, "src"))
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.journal import replay_journal
from repro_torch.serve.request import Request

mode, out = sys.argv[1], sys.argv[2]
cfg = get_smoke_config("qwen3-0.6b")
params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
rng = np.random.default_rng(21)
lens, gens = [6, 9, 7, 11, 6, 8], [5, 3, 6, 4, 5, 4]
prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
           for n in lens]
jrnl = os.path.join(out, "req.jrnl")
kw = dict(num_slots=2, cache_len=48, device="cpu")

if mode == "full":
    eng = ForecastEngine(cfg, params, **kw)
    for i in range(6):
        eng.submit(Request(id=f"r{{i}}", prompt=prompts[i],
                           max_new_tokens=gens[i]))
    done = eng.run(max_steps=300)
    np.savez(os.path.join(out, "full.npz"),
             **{{r: done[r].tokens for r in done}})
elif mode == "crash":
    eng = ForecastEngine(cfg, params, journal=jrnl, **kw)
    for i in range(6):
        eng.submit(Request(id=f"r{{i}}", prompt=prompts[i],
                           max_new_tokens=gens[i]))
    while eng.scheduler.pending or eng.active_requests:
        eng.step()
        if eng.step_count == 3:   # kill -9 mid-trace, journal mid-history
            os.kill(os.getpid(), signal.SIGKILL)
elif mode == "resume":
    st = replay_journal(jrnl)
    assert st.finished and st.unfinished_ids   # the crash was mid-trace
    eng = ForecastEngine(cfg, params, journal=jrnl, **kw)
    for r in st.unfinished_requests():
        assert eng.submit(r).ok
    done = eng.run(max_steps=300)
    # nothing lost, nothing duplicated across the crash
    assert set(done) == set(st.unfinished_ids)
    assert not set(done) & set(st.finished)
    merged = {{r: np.asarray(st.tokens[r], np.int32) for r in st.finished}}
    merged.update({{r: done[r].tokens for r in done}})
    assert len(merged) == 6
    np.savez(os.path.join(out, "resume.npz"), **merged)
"""


def test_kill9_mid_trace_journal_replay_bit_identical(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO))
    env = {**os.environ, "REPRO_TRACE": "0"}

    def run(mode):
        return subprocess.run([sys.executable, str(script), mode,
                               str(tmp_path)], env=env, timeout=300)

    crashed = run("crash")
    assert crashed.returncode == -signal.SIGKILL   # really kill -9'd
    assert (tmp_path / "req.jrnl").exists()
    assert run("resume").returncode == 0
    assert run("full").returncode == 0

    a = np.load(tmp_path / "resume.npz")
    b = np.load(tmp_path / "full.npz")
    assert set(a.files) == set(b.files) == {f"r{i}" for i in range(6)}
    for k in b.files:
        assert np.array_equal(a[k], b[k]), k
