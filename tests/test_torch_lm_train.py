"""The training half of the launch slice against the JAX package:
``data.tokens``, ``losses.chunked_ce``, ``transformer.forward`` (with and
without per-block recompute), the registry's ``loss`` and batch shapes,
``launch.steps.make_train_step`` / ``make_fed_train_step`` and the
``launch.train`` launcher, on the smoke configs in f32 with the reference's
weights carried over by the bridge and the same numpy batches fed to both.

Tolerances, and why:
  * ``markov_tokens`` / ``lm_batches``: bit for bit (the same numpy code).
  * ``chunked_ce``: within 1e-6 relative (an f32 log-sum-exp a token, sums
    in another order).
  * ``forward``: within 1e-5 of the largest magnitude (f32, matmuls in
    another order); remat on and off within 1e-6 of each other.
  * ``loss`` gradients: each leaf within 1e-5 of its largest magnitude.
  * 3 train steps: losses within 1e-5 relative; parameters, each leaf
    within 1e-5 of its largest magnitude, save one set of elements (below);
    moments within 1e-4, since steps 2-3 take their gradients at
    parameters that already differ at those elements (read: up to 3.0e-5
    of a leaf's largest).  AdamW divides each moment by its own root, so an f32
    difference in a gradient moves a weight by a small fraction of one
    step; but its first step moves an element by g / (|g| + eps), and
    a gradient small beside its leaf's largest is mostly the f32 rounding
    noise of sums that large, which the two sides round differently.
    Where |g| is a few eps (1e-8) that noise shows in the step in full
    (read: first gradients of -3.9e-10 and -2.2e-10 for one element,
    moving it by 0.04 and 0.02 of a step; -1.03e-7 and -6.0e-8 for
    another with accum 2, 0.91 and 0.86 of a step).  Elements whose first
    gradient on the reference's side is under 1e-4 of its leaf's largest
    (the noise is ~1e-6 of it, so above that the step moves by less than
    1e-4 of lr) are held within 2 lr a step, the most two AdamW steps can
    differ.  With ``REPRO_GRAD_DTYPE=bf16`` the gradient carry is rounded to
    bf16 on both sides after each microbatch's add, and a sum that lands
    on the other side of a bf16 step differs by 2**-8 of the partial sum,
    which may be far larger than the gradient left after cancellation, at
    any step.  There the moments are held within 2**-7 of their leaf's
    largest magnitude (one bf16 step each side; read: up to 5.9e-3 of it,
    at up to 2.5% of a leaf's elements), and at most 0.1% of a leaf's
    parameters may leave the 1e-5 bound (read: up to 0.0076%), each
    within 2 lr a step; and the run must differ from the f32 carry's by
    more than that bound (the switch is live).
  * the federated step: base leaves bit for bit unchanged (the same
    tensors); adapters and both moments as the train steps' parameters and
    moments.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import lora as jlora
from repro.data import tokens as jtokens
from repro.launch import steps as jsteps
from repro.models import losses as jlosses
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import lora
from repro_torch.data import tokens
from repro_torch.launch import hlo_cost, steps, train
from repro_torch.models import losses, registry, transformer
from repro_torch.optim.adamw import adamw_init

ARCHS = ("qwen3-0.6b", "fedtime-llama2-7b")      # tied table; lm_head
B, S = 4, 24
LR, FED_LR = 1e-4, 1e-3              # the steps' defaults


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    """|got - want| <= tol x max(max |want|, 1e-30)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got.detach().float()), want,
        atol=tol * max(float(np.abs(want).max()), 1e-30), rtol=0)


def _paths(tree, path=()):
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _paths(tree[k], path + (k,))]


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    jcfg = jax_smoke_config(arch)
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jregistry.get_model(jcfg).init(jcfg, k))(
            jax.random.PRNGKey(0)))


def _model(arch, softcap=0.0):
    """(reference cfg, port cfg, reference params as numpy, port params)."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    if softcap:
        jcfg = jcfg.replace(final_logit_softcap=softcap)
        cfg = cfg.replace(final_logit_softcap=softcap)
    jp = _reference_init(arch)
    return jcfg, cfg, jp, bridge.params_from_jax(jp, cfg, device="cpu")


def _batch(vocab, seed=0, b=B, s=S, masked=()):
    """Numpy tokens and labels; ``masked`` rows get -1 labels on every
    third position."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    for r in masked:
        labels[r, ::3] = -1
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data.tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,branching,vocab", [(0, 8, 512), (3, 2, 97),
                                                  (11, 16, 151_936)])
def test_markov_tokens_and_batches_bit_for_bit(seed, branching, vocab):
    want = jtokens.markov_tokens(5000, vocab, seed=seed, branching=branching)
    got = tokens.markov_tokens(5000, vocab, seed=seed, branching=branching)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    wit = jtokens.lm_batches(want, 3, 17, seed=seed)
    git = tokens.lm_batches(got, 3, 17, seed=seed)
    for _ in range(4):
        w, g = next(wit), next(git)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            assert np.array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# chunked_ce, forward, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["divides", "ragged_chunk", "masked",
                                  "all_masked", "softcap"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_ce_matches_reference(arch, case):
    jcfg, cfg, jp, p = _model(arch, softcap=30.0 if case == "softcap"
                              else 0.0)
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = _batch(cfg.vocab_size, masked=(0, 2) if case == "masked"
                    else ())["labels"]
    if case == "all_masked":
        labels[:] = -1
    chunk = 10 if case == "ragged_chunk" else 8         # 10 -> 8 of S 24
    want = float(jlosses.chunked_ce(jnp.asarray(hidden), jp, jcfg,
                                    jnp.asarray(labels), chunk=chunk))
    got = float(losses.chunked_ce(torch.from_numpy(hidden), p, cfg,
                                  torch.from_numpy(labels), chunk=chunk))
    if case == "all_masked":
        assert got == want == 0.0
    else:
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    tot, cnt = losses.chunked_ce_sum(torch.from_numpy(hidden), p, cfg,
                                     torch.from_numpy(labels), chunk=chunk)
    assert int(cnt) == int((labels >= 0).sum())


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, remat):
    jcfg, cfg, jp, p = _model(arch)
    toks = _batch(cfg.vocab_size)["tokens"]
    want = np.asarray(jtransformer.forward(jp, jcfg, jnp.asarray(toks)))
    got = transformer.forward(p, cfg, torch.from_numpy(toks), remat=remat)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_gradient(arch):
    """Per-block checkpointing changes what the backward pass keeps, not
    what it computes; and the forward's default recomputes."""
    _, cfg, _, p = _model(arch)
    batch = _t(_batch(cfg.vocab_size, masked=(1,)))
    grads = {}
    for remat in (True, False):
        leaves = [x.clone().requires_grad_(True)
                  for x in tree_util.leaves(p)]
        tree = tree_util.unflatten(p, leaves)
        h = transformer.forward(tree, cfg, batch["tokens"], remat=remat)
        loss = losses.chunked_ce(h, tree, cfg, batch["labels"])
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[True], grads[False]):
        _close(a, b.numpy(), 1e-6)
    import inspect
    assert inspect.signature(transformer.forward).parameters[
        "remat"].default is True
    assert inspect.signature(transformer.forward_hidden).parameters[
        "remat"].default is False


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_reference(arch):
    jcfg, cfg, jp, p = _model(arch)
    nb = _batch(cfg.vocab_size, masked=(0, 3))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q, b: jregistry.get_model(jcfg).loss(q, jcfg, b)))(
            jax.tree.map(jnp.asarray, jp), jb)
    api = registry.get_model(cfg)
    leaves = [x.clone().requires_grad_(True) for x in tree_util.leaves(p)]
    loss = api.loss(tree_util.unflatten(p, leaves), cfg, _t(nb))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        1e-5 * abs(float(jloss))
    want = _paths(jax.tree.map(np.asarray, jgrads))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        assert tuple(g.shape) == w.shape, path
        _close(g, w, 1e-5)
    tot, cnt, stats = api.loss_parts(p, cfg, _t(nb))
    assert stats is None
    assert int(cnt) == int((nb["labels"] >= 0).sum())
    assert abs(float(tot / cnt) - float(loss)) <= 1e-6 * float(loss)


def test_batch_shapes_match_reference():
    """The dense, MoE, ssm, hybrid and encdec families' batch shapes are
    the reference's (zamba2-2.7b's and seamless-m4t-medium's at full width
    too; seamless's ``frames`` in bf16); a family still unported (``vlm``)
    raises."""
    for arch in ARCHS + ("mixtral-8x7b", "xlstm-350m", "zamba2-2.7b",
                         "seamless-m4t-medium"):
        jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
        want = jregistry.train_batch_shapes(jcfg, 3, 40)
        got = registry.train_batch_shapes(cfg, 3, 40)
        assert {k: s for k, (s, _) in got.items()} == \
            {k: s for k, (s, _) in want.items()}
        assert all(dt == (torch.bfloat16 if k == "frames" else torch.int32)
                   for k, (_, dt) in got.items())
        want = jregistry.decode_batch_shapes(jcfg, 5)
        got = registry.decode_batch_shapes(cfg, 5)
        assert {k: s for k, (s, _) in got.items()} == \
            {k: s for k, (s, _) in want.items()}
    for arch in ("zamba2-2.7b", "seamless-m4t-medium"):
        jcfg, cfg = jax_config(arch), get_config(arch)
        for fn, jfn, args in ((registry.train_batch_shapes,
                               jregistry.train_batch_shapes, (256, 4096)),
                              (registry.decode_batch_shapes,
                               jregistry.decode_batch_shapes, (128,))):
            assert {k: s for k, (s, _) in fn(cfg, *args).items()} == \
                {k: s for k, (s, _) in jfn(jcfg, *args).items()}
    assert registry.train_batch_shapes(
        get_config("seamless-m4t-medium"), 2, 8192)["frames"] == (
            (2, 4096, 1024), torch.bfloat16)
    vlm = get_smoke_config("qwen3-0.6b").replace(family="vlm")
    for fn, args in ((registry.train_batch_shapes, (2, 8)),
                     (registry.decode_batch_shapes, (2,)),
                     (registry.get_model, ())):
        with pytest.raises(NotImplementedError):
            fn(vlm, *args)


def test_smollm_config_equals_reference():
    for get, jget in ((get_config, jax_config),
                      (get_smoke_config, jax_smoke_config)):
        got, want = get("smollm-360m"), jget("smollm-360m")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_xlstm_config_equals_reference():
    for get, jget in ((get_config, jax_config),
                      (get_smoke_config, jax_smoke_config)):
        got, want = get("xlstm-350m"), jget("xlstm-350m")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def _run_reference(step_fn, params, opt, batches):
    """(params, moments, losses, the elements whose first gradient is
    under 1e-4 of its leaf's largest: see the module's docstring)."""
    losses_, step_fn = [], jax.jit(step_fn)
    for i, nb in enumerate(batches):
        params, opt, loss = step_fn(params, opt, {
            k: jnp.asarray(v) for k, v in nb.items()}, jnp.asarray(i))
        losses_.append(float(loss))
        if i == 0:          # the first moment is 0.1 x the first gradient
            noise = jax.tree.map(
                lambda mu: np.abs(mu) < 1e-4 * np.abs(mu).max(), opt["mu"])
    return jax.tree.map(np.asarray, params), \
        jax.tree.map(np.asarray, opt), losses_, noise


def _run_port(step_fn, params, opt, batches):
    losses_ = []
    for i, nb in enumerate(batches):
        params, opt, loss = step_fn(params, opt, _t(nb), i)
        losses_.append(float(loss))
    return params, opt, losses_


def _hold(got, want, tol=1e-5, noise=None, slack=0.0, share=0.0):
    """Each leaf of ``got`` within ``tol`` of the largest magnitude of
    ``want``'s; where ``noise`` (a tree of bools) is set, and at up to
    ``share`` of a leaf's other elements, within ``slack`` instead."""
    want = _paths(want)
    got = tree_util.leaves(got)
    noise = [None] * len(want) if noise is None else [
        m for _, m in _paths(noise)]
    assert len(got) == len(want) == len(noise)
    for (path, w), g, m in zip(want, got, noise):
        assert tuple(g.shape) == w.shape, path
        g = g.detach().float().numpy()
        lim = np.full(w.shape, tol * max(float(np.abs(w).max()), 1e-30),
                      np.float32)
        if m is not None:
            lim[m] = max(slack, float(lim.flat[0]))
        over = np.abs(g - w) > lim
        assert over.sum() <= share * over.size, (
            path, int(over.sum()), float(np.abs(g - w)[over].max()))
        assert np.all(np.abs(g - w) <= np.maximum(lim, slack)), path


def _train_batches(vocab, n=3, accum=1):
    """-1 labels in the first microbatch only (rows 0-1 of 4)."""
    return [_batch(vocab, seed=10 + i, masked=(0,) if accum > 1 else (0, 2))
            for i in range(n)]


@pytest.mark.parametrize("accum,grad_dtype", [(1, "f32"), (2, "f32"),
                                               (2, "bf16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, accum, grad_dtype, monkeypatch):
    """(The gradient carry, and so ``REPRO_GRAD_DTYPE``, exists only with
    accum > 1.)"""
    if grad_dtype == "bf16":
        monkeypatch.setenv("REPRO_GRAD_DTYPE", "bf16")
    else:
        monkeypatch.delenv("REPRO_GRAD_DTYPE", raising=False)
    jcfg, cfg, jp, p = _model(arch)
    batches = _train_batches(cfg.vocab_size, accum=accum)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstep = jsteps.make_train_step(jcfg, lr=LR, accum=accum)
    wp, wopt, wl, noise = _run_reference(jstep, jparams,
                                         jadamw_init(jparams), batches)
    gp, gopt, gl = _run_port(steps.make_train_step(cfg, lr=LR,
                                                   accum=accum),
                             p, adamw_init(p), batches)
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=0)
    bf16 = grad_dtype == "bf16"
    _hold(gp, wp, noise=noise, slack=2 * LR * len(batches),
          share=1e-3 if bf16 else 0.0)
    _hold(gopt["mu"], wopt["mu"], tol=2.0 ** -7 if bf16 else 1e-4)
    _hold(gopt["nu"], wopt["nu"], tol=2.0 ** -7 if bf16 else 1e-4)
    if bf16:
        monkeypatch.delenv("REPRO_GRAD_DTYPE")
        f32, _, _ = _run_port(steps.make_train_step(cfg, lr=LR, accum=2),
                              p, adamw_init(p), batches)
        assert any(float((a - b).abs().max()) > 1e-5 * float(b.abs().max())
                   for a, b in zip(tree_util.leaves(gp),
                                   tree_util.leaves(f32)))
    assert not any(x.requires_grad for x in tree_util.leaves(gp))


def _with_adapters(jcfg, jp):
    """The reference's adapters on its params, LoRA B drawn at 0.01 so that
    both adapter leaves get gradients from the first step."""
    jparams = jlora.attach_lora(jax.tree.map(jnp.asarray, jp),
                                jax.random.PRNGKey(1), rank=4, alpha=8.0,
                                targets=jlora.FAMILY_TARGETS[jcfg.family])
    rng = np.random.default_rng(5)

    def draw_b(path, x):
        if path and getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                               * 0.01)
        return x
    return jax.tree_util.tree_map_with_path(draw_b, jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_fed_train_step_matches_reference(arch):
    jcfg, cfg, jp, _ = _model(arch)
    jparams = _with_adapters(jcfg, jp)
    npar = jax.tree.map(np.asarray, jparams)
    p = bridge.tree_to_torch(npar, "cpu")
    batches = _train_batches(cfg.vocab_size)
    jstep = jsteps.make_fed_train_step(jcfg, lr=FED_LR)
    jopt = jadamw_init(jlora.lora_tree(jparams))
    wp, wopt, wl, noise = _run_reference(jstep, jparams, jopt, batches)
    gp, gopt, gl = _run_port(steps.make_fed_train_step(cfg, lr=FED_LR), p,
                             adamw_init(lora.lora_tree(p)), batches)
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=0)
    adapters = lora.lora_tree(gp)
    _hold(adapters, jlora.lora_tree(wp), noise=noise,
          slack=2 * FED_LR * len(batches))
    _hold(gopt["mu"], wopt["mu"], tol=1e-4)
    _hold(gopt["nu"], wopt["nu"], tol=1e-4)
    moved = 0
    for (path, before), after, base in zip(
            _paths(p), tree_util.leaves(gp), _paths(lora.lora_mask(p))):
        if base[1]:
            moved += not torch.equal(before, after)
        else:                       # base leaves: the same tensors
            assert after is before and not after.requires_grad, path
    assert moved == len(tree_util.leaves(adapters))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fed", [False, True], ids=["full", "fed"])
def test_launcher_main_on_cpu(fed, tmp_path, monkeypatch, capsys):
    from repro_torch import obs
    monkeypatch.setenv("REPRO_TRACE", "1")
    obs.reset()
    out = tmp_path / "trace.json"
    argv = ["--device", "cpu", "--steps", "5", "--batch", "4", "--seq",
            "32", "--trace-out", str(out)] + (["--fed"] if fed else [])
    try:
        train.main(argv)
    finally:
        trace = json.loads(out.read_text())
        obs.reset()
    text = capsys.readouterr().out
    lines = [l for l in text.splitlines() if l.startswith("step ")]
    got = [float(l.split("loss=")[1].split()[0]) for l in lines]
    assert [l.split()[1] for l in lines] == ["1/5", "2/5", "3/5", "5/5"]
    assert all(np.isfinite(got)) and "smollm-360m-smoke" in text
    spans = [e for e in trace["traceEvents"]
             if e["name"] == "train.step" and e["ph"] == "X"]
    assert [e["args"]["step"] for e in spans] == list(range(5))
    gauges = trace["metadata"]["summary"]["gauges"]
    assert np.isfinite(gauges["train.loss"])
    assert round(gauges["train.loss"], 4) == got[-1]
    assert trace["metadata"]["provenance"]["fed"] is fed


def test_launcher_run_moments_and_refusals(capsys):
    args = train.parse_args(["--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16", "--fed", "--arch",
                             "qwen3-0.6b"])
    out = train.run(args)
    assert len(out.losses) == 2 and all(np.isfinite(out.losses))
    assert out.mesh_shape is None
    ad = lora.lora_tree(out.params)
    for m in ("mu", "nu"):          # moments of the adapter tree only
        assert [tuple(x.shape) for x in tree_util.leaves(out.opt_state[m])] \
            == [tuple(x.shape) for x in tree_util.leaves(ad)]
    capsys.readouterr()
    # --scope-costs prints one step's per-scope table (counted on fakes of
    # the run's own trees), then trains
    train.main(["--device", "cpu", "--scope-costs", "--steps", "2",
                "--batch", "2", "--seq", "16"])
    text = capsys.readouterr().out
    head, rest = text.split("per-scope cost attribution (one step, counted "
                            "on fakes):\n")
    row = rest.splitlines()[0]
    assert row.split()[0] == "(unscoped)" and "(100.0%)" in row
    assert "step 2/2" in rest and text.rstrip().endswith("done")
    # the table's numbers are those of the same step on real tensors
    cfg = get_smoke_config("smollm-360m")
    params, opt, step_fn = train.setup(cfg, fed=False, lr=3e-4,
                                       device="cpu")
    costs = train.print_scope_costs(cfg, params, opt, step_fn, batch=2,
                                    seq=16, log=lambda _: None)
    it = tokens.lm_batches(tokens.markov_tokens(1000, cfg.vocab_size,
                                                seed=0), 2, 17, seed=0)
    batch = train.synth_batch(cfg, 2, 16, it, "cpu")
    _, counter = hlo_cost.count(step_fn, params, opt, batch, 0)
    assert costs == counter.scopes
    assert float(row.split("flops=")[1].split()[0]) == pytest.approx(
        costs["(unscoped)"]["flops"], rel=1e-3)
