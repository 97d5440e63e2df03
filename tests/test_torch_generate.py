"""The port's ``serve.sampling.sample`` and ``generate`` against the JAX
package's, on the CPU.

``sample`` draws from a ``torch.Generator`` and the reference from
``jax.random`` keys, so their tokens are not compared one by one:

  * the support each keeps (top-k clamped to the vocab, the nucleus cut,
    none at top_p >= 1) is the set of tokens 2000 draws reach, equal on
    both sides (every kept token has probability >= 1.5% here, so each is
    drawn with probability > 1 - 1e-13);
  * temperature <= 0 is the argmax;
  * the port's draw frequencies pass a chi-square test against the
    softmax of the masked logits (the 0.999 quantile: a correct sampler
    fails one seed in a thousand; the seeds are fixed).

Every temperature drawn here is 0 or well above f32's smallest normal: a
positive temperature that rounds to 0 in f32 divides the reference's
logits by 0.

``generate`` at temperature 0 is greedy on both sides, so its tokens are
held to the reference's bit for bit at both served smoke configs in f32,
from the same prefill (weights carried over by the bridge).  Sampled
``generate`` repeats with one seed and keeps every token in its row's
top-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import get_model as jax_get_model
from repro.serve.sampling import generate as jax_generate
from repro.serve.sampling import sample as jax_sample
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import get_model
from repro_torch.serve.sampling import generate, masked_logits, sample

V, N = 16, 2000
MASK_CASES = [(1.0, 5, 0.0), (1.0, 0, 0.6), (0.7, 10, 0.8), (1.0, 40, 1.0),
              (1.3, 0, 1.5)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(seed=3):
    logits = np.linspace(-1.0, 1.0, V).astype(np.float32)
    np.random.default_rng(seed).shuffle(logits)
    return logits


@pytest.mark.parametrize("temperature,top_k,top_p", MASK_CASES)
def test_sample_support_equals_reference(temperature, top_k, top_p):
    tiled = np.tile(_row(), (N, 1))
    want = jax_sample(jax.random.PRNGKey(0), jnp.asarray(tiled),
                      temperature=temperature, top_k=top_k, top_p=top_p)
    got = sample(torch.from_numpy(tiled), temperature=temperature,
                 top_k=top_k, top_p=top_p,
                 generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.int32 and got.shape == (N,)
    assert set(got.tolist()) == set(np.asarray(want).tolist())


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_sample_greedy_is_argmax(temperature):
    logits = np.random.default_rng(1).standard_normal((5, V)).astype(
        np.float32)
    got = sample(torch.from_numpy(logits), temperature=temperature,
                 top_k=3, top_p=0.5)
    want = jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                      temperature=temperature, top_k=3, top_p=0.5)
    assert got.tolist() == np.asarray(want).tolist() == \
        logits.argmax(-1).tolist()


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.7, 0, 0.0), (0.7, 6, 0.9), (1.0, 99, 1.0)])
def test_sample_frequencies_match_softmax(temperature, top_k, top_p):
    logits = np.linspace(-1.5, 1.5, V).astype(np.float32)
    toks = sample(torch.from_numpy(np.tile(logits, (N, 1))),
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  generator=torch.Generator().manual_seed(1)).numpy()
    lg = masked_logits(torch.from_numpy(logits[None]),
                       temperature=[temperature], top_k=[top_k],
                       top_p=[top_p])[0]
    p = torch.softmax(lg, -1).numpy()
    kept = p > 0
    assert set(np.unique(toks)) <= set(np.nonzero(kept)[0])
    counts = np.bincount(toks, minlength=V)[kept]
    expected = N * p[kept]
    stat = ((counts - expected) ** 2 / expected).sum()
    df = kept.sum() - 1
    z999 = 3.0902                            # standard normal 0.999 quantile
    bound = df * (1 - 2 / (9 * df) + z999 * np.sqrt(2 / (9 * df))) ** 3
    assert df >= 3 and stat < bound, (stat, bound)


def test_sample_top_k_over_vocab_is_clamped():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, V)).astype(np.float32))
    big = sample(logits, temperature=1.0, top_k=999,
                 generator=torch.Generator().manual_seed(4))
    exact = sample(logits, temperature=1.0, top_k=V,
                   generator=torch.Generator().manual_seed(4))
    assert big.tolist() == exact.tolist()


@pytest.fixture(scope="module", params=["qwen3-0.6b", "fedtime-llama2-7b"])
def served(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10))
    return jcfg, japi, jparams, cfg, get_model(cfg), params, tokens


def test_generate_greedy_equals_reference(served):
    jcfg, japi, jparams, cfg, api, params, tokens = served
    jcache, jlg = japi.prefill(jparams, jcfg,
                               {"tokens": jnp.asarray(tokens, jnp.int32)},
                               cache_len=24)
    jfirst = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
    want, _ = jax_generate(japi, jparams, jcfg, jcache, jfirst, steps=8,
                           start_pos=10)
    cache, lg = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                            cache_len=24)
    first = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert first.tolist() == np.asarray(jfirst).tolist()
    got, cache = generate(api, params, cfg, cache, first, steps=8,
                          start_pos=10)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    assert got.tolist() == np.asarray(want).tolist()
    assert int(cache["kv_pos"].max()) == 17          # the last step's slot


def test_generate_sampled_repeats_and_stays_in_top_k(served):
    _, _, _, cfg, api, params, tokens = served

    def run():
        cache, lg = api.prefill(params, cfg,
                                {"tokens": torch.from_numpy(tokens)},
                                cache_len=24)
        first = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out, _ = generate(api, params, cfg, cache, first, steps=6,
                          start_pos=10, temperature=0.8, top_k=5,
                          generator=torch.Generator().manual_seed(7))
        return first, out

    first, a = run()
    _, b = run()
    assert a.tolist() == b.tolist()
    # teacher-force the sampled tokens: each lies in the top 5 of the
    # logits it was drawn from
    cache, _ = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                           cache_len=24)
    fed = torch.cat([first, a[:, :-1]], 1)
    for i in range(6):
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": fed[:, i:i + 1],
                                     "pos": 10 + i})
        top = lg[:, -1].topk(5, dim=-1).indices
        assert all(int(a[r, i]) in top[r].tolist() for r in range(2))
