"""The port's serving loop: each request's token stream equals the port's
`greedy_generate` on that prompt alone (bucketed, as the loop admits it),
through grouped admission, lane recycling, budgets and EOS."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core import baselines
from repro_torch.launch.serve import (Request, ServeLoop, bucket_length,
                                      greedy_generate, main, pad_to_bucket)
from repro_torch.models.transformer import Model

PRUNE = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2, recent_window=8)
LENS = [20, 9, 33, 17, 12, 40, 30]
BUDGETS = [6, 10, 4, 9, 3, 7, 5]


def _model(kv="bf16", fused=True):
    cfg = reduced(get_config("granite-3-2b"))
    model = Model(cfg, baselines.unicaim(kv_dtype=kv, fused=fused, **PRUNE),
                  device="cpu")
    return model, model.init(0)


def _alone(model, params, prompt, steps):
    padded, n = pad_to_bucket(prompt)
    toks, _ = greedy_generate(model, params,
                              {"tokens": torch.as_tensor(padded[None]),
                               "length": torch.as_tensor([n])},
                              steps, device="cpu")
    return toks[0].tolist()


@pytest.mark.parametrize("kv,fused", [("bf16", True), ("int8", False)])
def test_serve_streams_equal_greedy_generate_alone(kv, fused):
    model, params = _model(kv, fused)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in LENS]
    loop = ServeLoop(model, params, lanes=3, block=4, device="cpu")
    handles = [loop.submit(Request(prompt=p, max_new=m))
               for p, m in zip(prompts, BUDGETS)]
    stats = loop.run()
    assert len(stats) == len(prompts) and all(h.done for h in handles)
    for h, p, m in zip(handles, prompts, BUDGETS):
        assert h.tokens == _alone(model, params, p, m), h.rid
    c = loop.counters
    assert c["grouped_requests"] >= 2            # some admissions shared
    assert c["prefill_dispatches"] < len(prompts)
    assert c["decode_steps"] == 4 * c["decode_blocks"]
    assert c["nonfinite_lanes"] == 0
    agg = loop.aggregate()
    assert agg["tokens"] == sum(BUDGETS)


def test_serve_stops_at_eos_without_emitting_it():
    model, params = _model()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, model.cfg.vocab_size, 21)
    ref = _alone(model, params, prompt, 12)
    eos = ref[4]
    loop = ServeLoop(model, params, lanes=2, block=3, eos=eos, device="cpu")
    h = loop.submit(Request(prompt=prompt, max_new=12))
    other = loop.submit(Request(prompt=prompt[:13], max_new=5))
    loop.run()
    assert h.tokens == ref[:ref.index(eos)]
    assert len(other.tokens) <= 5


def test_bucket_helpers_match_reference():
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    for t in (1, 15, 16, 17, 100, 2041, 2048):
        assert bucket_length(t) == jserve.bucket_length(t)
        assert bucket_length(t, (8, 64)) == jserve.bucket_length(t, (8, 64))
    p = np.arange(1, 21)
    for a, b in zip(pad_to_bucket(p), jserve.pad_to_bucket(p)):
        np.testing.assert_array_equal(a, b)


def test_cli_serves_on_cpu(capsys):
    main(["--reduced", "--batch", "2", "--prompt-len", "24",
          "--new-tokens", "4", "--fused", "--serve", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 4 reqs on 2 lanes" in out
    main(["--reduced", "--batch", "2", "--prompt-len", "24",
          "--new-tokens", "3", "--no-scan", "--device", "cpu"])
    assert "generated (2, 3)" in capsys.readouterr().out


def _cli_streams(monkeypatch, argv):
    """Serve through the CLI; → every request's token stream, by rid."""
    runs = []
    run = ServeLoop.run

    def recording_run(self):
        stats = run(self)
        runs.append({s.rid: s.tokens for s in stats})
        return stats

    with monkeypatch.context() as m:
        m.setattr(ServeLoop, "run", recording_run)
        main(["--reduced", "--batch", "2", "--prompt-len", "24",
              "--new-tokens", "6", "--fused", "--serve", "--device", "cpu",
              *argv])
    (streams,) = runs
    return streams


def test_cli_serves_with_sampling_flags(monkeypatch, capsys):
    streams = _cli_streams(monkeypatch, ["--temperature", "0.7",
                                         "--top-k", "20", "--top-p", "0.9"])
    assert "served 4 reqs on 2 lanes" in capsys.readouterr().out
    assert [len(streams[r]) for r in range(4)] == [6, 3, 6, 3]
    greedy = _cli_streams(monkeypatch, [])
    assert streams != greedy                  # the knobs reached the lanes


def test_cli_greedy_output_unchanged_by_top_k(monkeypatch, capsys):
    """Temperature 0 is greedy whatever top-k says: the same streams."""
    assert (_cli_streams(monkeypatch, ["--top-k", "5"])
            == _cli_streams(monkeypatch, []))
    out = capsys.readouterr().out
    assert out.count("served 4 reqs on 2 lanes") == 2


def test_serve_streams_equal_reference_serve_loop():
    """The same arrival trace and weights through the reference's
    ServeLoop: every request's greedy stream is identical."""
    pytest.importorskip("jax")
    from repro.launch.serve import Request as JaxRequest
    from repro.launch.serve import ServeLoop as JaxServeLoop
    from torch_parity import model_pair
    jm, jp, tm, tp = model_pair("longchat-7b", fused=True, **PRUNE)
    rng = np.random.default_rng(4)
    trace = [(rng.integers(0, tm.cfg.vocab_size, n), m)
             for n, m in zip(LENS, BUDGETS)]
    jloop = JaxServeLoop(jm, jp, lanes=3, block=4)
    tloop = ServeLoop(tm, tp, lanes=3, block=4, device="cpu")
    jh = [jloop.submit(JaxRequest(prompt=p, max_new=m)) for p, m in trace]
    th = [tloop.submit(Request(prompt=p, max_new=m)) for p, m in trace]
    jloop.run()
    tloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert (tloop.counters["prefill_dispatches"]
            == jloop.counters["prefill_dispatches"])
