"""Shared test fixtures + a no-op `hypothesis` fallback.

`hypothesis` is a declared (requirements.txt) but optional dependency:
when it is missing, property tests are skipped instead of breaking
collection of the whole module.
"""
import pytest


def given(*_args, **_kwargs):
    def deco(fn):
        return pytest.mark.skip(reason="hypothesis not installed")(fn)
    return deco


def settings(*_args, **_kwargs):
    def deco(fn):
        return fn
    return deco


class _Strategies:
    """Stand-in for `hypothesis.strategies`: every strategy builder returns
    None; the tests it feeds are skipped by the `given` stub anyway."""

    def __getattr__(self, name):
        return lambda *a, **k: None


st = _Strategies()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card of compute capability >= 9.0; "
        "skips elsewhere (run on the card: python -m pytest -m gpu)")
