"""The port's next-token rule against the reference's, and its own draws.

- `_next_token_lanes` and `_next_token` give the reference's tokens when
  fed the reference's Gumbel noise: jax.random.categorical(key, x) is
  argmax(jax.random.gumbel(key, x.shape) + x), so the noise of the
  reference's per-row subkeys goes into the port's `noise` argument.
  Tokens must be equal on every row except nucleus-boundary rows: a row
  whose mass before some token lies within 1e-6 of top_p can fall on
  either side, because torch's and XLA's softmax and cumsum may sum in
  other orders. Those rows are excluded and counted (at most 2 of 64).
- The port's own sampler (noise from a torch.Generator): 20,000 draws
  never leave the truncated support, and their frequencies match the
  truncated softmax by a chi-square test (p > 1e-3).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch.serve import (_next_token, _next_token_lanes,  # noqa: E402
                                      greedy_generate, gumbel_noise)

jax.config.update("jax_platform_name", "cpu")

B, V = 64, 256
BOUNDARY = 1e-6                 # |mass before - top_p| counted as a tie
MAX_BOUNDARY_ROWS = 2

# (temperature, top_k, top_p) per row group; top_p in {0, 1, 0.5, 0.95}
KNOBS = {
    "greedy": (0.0, 0, 0.0),
    "greedy-knobs-ignored": (0.0, 5, 0.5),
    "negative-temperature": (-1.0, 20, 0.95),
    "temperature": (0.7, 0, 0.0),
    "top-k": (1.0, 5, 0.0),
    "top-k-1": (0.8, 1, 0.0),
    "top-p-0.5": (1.0, 0, 0.5),
    "top-p-0.95": (0.9, 0, 0.95),
    "top-p-1-off": (1.0, 0, 1.0),
    "top-k-top-p": (0.8, 10, 0.5),
    "top-k-top-p-0.95": (1.2, 50, 0.95),
    "top-k-ge-V": (1.0, V, 0.0),
    "top-k-past-V": (1.0, V + 7, 0.95),
}


def _logits(seed, b=B, v=V):
    return (np.random.default_rng(seed).standard_normal((b, v))
            * 3.0).astype(np.float32)


def _boundary_rows(logits, temperature, top_k, top_p):
    """Rows whose nucleus cut has a token with |mass before - top_p| <
    BOUNDARY (f64 over the top-k-truncated, descending row)."""
    out = np.zeros(len(logits), bool)
    for i, row in enumerate(logits.astype(np.float64)):
        t, k, p = temperature[i], top_k[i], top_p[i]
        if t <= 0 or not 0 < p < 1:
            continue
        sl = np.sort(row)[::-1]
        if k > 0:
            sl = sl[:min(k, len(sl))]
        q = np.exp((sl - sl[0]) / t)
        q /= q.sum()
        out[i] = bool((np.abs(np.cumsum(q) - q - p) < BOUNDARY).any())
    return out


def _mixed_knobs(case, b=B):
    """Every row on `case`'s knobs, except every fourth row greedy."""
    t, k, p = KNOBS[case]
    temperature = np.full(b, t, np.float32)
    temperature[::4] = 0.0
    return (temperature, np.full(b, k, np.int32),
            np.full(b, p, np.float32))


@pytest.mark.parametrize("case", list(KNOBS))
def test_next_token_lanes_matches_reference(case):
    logits = _logits(1)
    temperature, top_k, top_p = _mixed_knobs(case)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = np.asarray(jserve._next_token_lanes(
        jnp.asarray(logits), keys, jnp.asarray(temperature),
        jnp.asarray(top_k), jnp.asarray(top_p)))
    noise = np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
    got = _next_token_lanes(
        torch.as_tensor(logits), torch.as_tensor(noise),
        torch.as_tensor(temperature), torch.as_tensor(top_k),
        torch.as_tensor(top_p)).numpy()
    edge = _boundary_rows(logits, temperature, top_k, top_p)
    assert edge.sum() <= MAX_BOUNDARY_ROWS, edge.sum()
    np.testing.assert_array_equal(got[~edge], want[~edge])
    greedy = temperature <= 0
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))


@pytest.mark.parametrize("case", [c for c in KNOBS
                                  if KNOBS[c][1] <= V])
def test_next_token_matches_reference(case):
    """The scalar-knob rule: one key for the whole [B, V] batch."""
    t, k, p = KNOBS[case]
    logits = _logits(2)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jserve._next_token(jnp.asarray(logits), key, t, k, p))
    noise = np.array(jax.random.gumbel(key, (B, V), jnp.float32))
    got = _next_token(torch.as_tensor(logits), torch.as_tensor(noise),
                      t, k, p).numpy()
    edge = _boundary_rows(logits, np.full(B, t), np.full(B, k),
                          np.full(B, p))
    assert edge.sum() <= MAX_BOUNDARY_ROWS, edge.sum()
    np.testing.assert_array_equal(got[~edge], want[~edge])


def _truncated_softmax(row, t, k, p):
    """(support mask, probabilities) of the rule's truncated distribution,
    in f64."""
    row = row.astype(np.float64)
    order = np.argsort(-row, kind="stable")
    sl = row[order]
    keep = np.ones(len(sl), bool)
    if k > 0:
        keep[min(k, len(sl)):] = False
    if 0 < p < 1:
        q = np.exp((sl - sl[0]) / t) * keep
        q /= q.sum()
        keep &= (np.cumsum(q) - q) < p
    support = np.zeros(len(row), bool)
    support[order[keep]] = True
    w = np.where(support, np.exp((row - row.max()) / t), 0.0)
    return support, w / w.sum()


@pytest.mark.parametrize("t,k,p", [(0.8, 0, 0.0), (1.0, 6, 0.0),
                                   (1.0, 0, 0.9), (0.7, 8, 0.95)])
def test_sampler_draws_match_truncated_softmax(t, k, p):
    v, n = 16, 20_000
    row = np.linspace(2.0, -2.5, v).astype(np.float32)
    np.random.default_rng(0).shuffle(row)
    gen = torch.Generator().manual_seed(11)
    noise = gumbel_noise([gen] * n, v, "cpu")
    assert torch.isfinite(noise).all()
    full = lambda x, dt: torch.full((n,), x, dtype=dt)  # noqa: E731
    draws = _next_token_lanes(
        torch.as_tensor(row).expand(n, v), noise,
        full(t, torch.float32), full(k, torch.long),
        full(p, torch.float32)).numpy()
    support, probs = _truncated_softmax(row, t, k, p)
    assert support[draws].all()                       # never outside
    counts = np.bincount(draws, minlength=v)[support]
    expected = probs[support] / probs[support].sum() * counts.sum()
    assert stats.chisquare(counts, expected).pvalue > 1e-3


def test_greedy_generate_samples_through_next_token():
    """`greedy_generate` with a temperature draws through `_next_token`:
    a seed fixes the stream, and temperature 0 is the greedy stream
    whatever the generator."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import baselines
    from repro_torch.models.transformer import Model
    model = Model(reduced(get_config("granite-3-2b")),
                  baselines.unicaim(heavy=24, reserve=8, select_k=8),
                  device="cpu")
    params = model.init(0)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, model.cfg.vocab_size, (2, 16)))}

    def run(temperature, seed):
        gen = torch.Generator().manual_seed(seed)
        return greedy_generate(model, params, batch, 6, temperature, gen,
                               top_k=8, device="cpu")[0].tolist()

    greedy = greedy_generate(model, params, batch, 6, device="cpu")[0]
    assert run(0.0, 1) == run(0.0, 2) == greedy.tolist()
    assert run(1.0, 1) == run(1.0, 1)
    assert run(1.0, 1) != greedy.tolist()
