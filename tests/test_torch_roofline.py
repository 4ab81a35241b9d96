"""The port's roofline (`launch/roofline.py`), report (`launch/report.py`)
and small tooling helpers against the reference's, on the CPU.

- `SHAPES` field for field; `model_flops` for every arch x shape;
- `roofline_terms` and `summarize`, with the port's constants set to the
  reference's TPU values, on records that each term dominates; a record
  with `collective_bytes=None` summarizes without that term;
- the H100 constants and `bound()`;
- the report's tables on records that carry every reference field, text
  for text, and `n/a` for the port's own null fields;
- `memory_footprint_bytes` for every policy of `baselines`;
- `fused_auto_decision` on the CPU and `_fused_enabled` beside it.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.core import baselines as jax_baselines
from repro.core.pruning import memory_footprint_bytes as jax_footprint
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro_torch.configs.base import SHAPES, SHAPES_BY_NAME, get_config
from repro_torch.core import attention, baselines
from repro_torch.core.pruning import memory_footprint_bytes
from repro_torch.launch import dryrun, report, roofline

ARCHS = dryrun.ALL_ARCHS


def test_shapes_equal_the_reference():
    assert [dataclasses.asdict(s) for s in SHAPES] == [
        dataclasses.asdict(s) for s in JAX_SHAPES]
    assert list(SHAPES_BY_NAME) == [s.name for s in JAX_SHAPES]
    for s in SHAPES:
        s.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for s, js in zip(SHAPES, JAX_SHAPES):
        assert roofline.model_flops(cfg, s) == jroof.model_flops(jcfg, js)


def test_h100_constants_and_bound():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW_PER_DIRECTION == 450e9
    assert roofline.PEAK_INT8_OPS == 1979e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    ms, by = roofline.bound(3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0, rel=1e-12)
    ms, by = roofline.bound(1.0, bf16_flops=989e9, f32_flops=67e9)
    assert by == "operations" and ms == pytest.approx(2.0, rel=1e-12)
    ms, by = roofline.bound(0.0, int8_ops=1979e9)
    assert by == "operations" and ms == pytest.approx(1.0, rel=1e-12)


@pytest.fixture
def reference_rates(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW_PER_DIRECTION", jroof.ICI_BW)


# one record for each dominant term, and one of equal terms
TERMS = {"compute": (4e14, 1e9, 1e8), "memory": (1e10, 5e11, 1e8),
         "collective": (1e10, 1e9, 2e11), "tie": (197e12, 819e9, 50e9)}


@pytest.mark.parametrize("case", list(TERMS))
def test_terms_and_summary_equal_the_reference(reference_rates, case):
    flops, nbytes, coll = TERMS[case]
    assert roofline.roofline_terms(flops, nbytes, coll) == \
        jroof.roofline_terms(flops, nbytes, coll)
    cell = {"flops": flops, "bytes_accessed": nbytes,
            "collective_bytes": coll, "n_devices": 256,
            "model_flops": flops * 200.0, "arch": "x"}
    got, want = roofline.summarize(cell), jroof.summarize(cell)
    assert got == want
    if case != "tie":
        assert got["dominant"] == f"{case}_s"


def test_summary_without_collective_bytes():
    cell = {"flops": 1e10, "bytes_accessed": 1e9, "collective_bytes": None,
            "n_devices": 4, "model_flops": 4e10}
    row = roofline.summarize(cell)
    assert row["collective_s"] is None
    assert row["dominant"] == "memory_s"
    assert row["step_time_bound_s"] == 1e9 / roofline.HBM_BW
    assert row["mfu_bound"] == (1e10 / roofline.PEAK_FLOPS
                                / row["step_time_bound_s"])
    cell["bytes_accessed"] = 0.0
    assert roofline.summarize(cell)["dominant"] == "compute_s"


def _full_records():
    """Port dry-run records of five archs on both meshes, with the fields
    the compiler gives the reference filled in, summarized by the
    reference's `summarize`."""
    recs = {}
    for i, arch in enumerate(["whisper-base", "deepseek-v3-671b",
                              "zamba2-7b", "mamba2-1.3b",
                              "llava-next-mistral-7b"]):
        for shape in ("train_4k", "decode_32k", "long_500k"):
            for mp in (False, True):
                r = dryrun.run_cell(arch, shape, mp)
                coll = {"all-reduce": 3e8 * (i + 1), "all-gather": 0.0,
                        "reduce-scatter": 2e6, "all-to-all": 5e3 * i,
                        "collective-permute": 0.0}
                coll["total"] = sum(coll.values())
                r.update(collectives=coll, collective_bytes=coll["total"],
                         peak_bytes_per_dev=r["arg_bytes_per_dev"] * 1.5,
                         temp_bytes_per_dev=12345, output_bytes_per_dev=0,
                         compile_s=17.4 + i, probe_s=3.0,
                         flops=r["flops"] * 1.25)
                for k in ("useful_flops_ratio", "compute_s", "memory_s",
                          "collective_s", "dominant", "step_time_bound_s",
                          "mfu_bound", "roofline_fraction_compute"):
                    r.pop(k)
                r.update({k: v for k, v in jroof.summarize(r).items()
                          if k not in r})
                recs[(arch, shape, r["mesh"], "unicaim")] = r
    return recs


def test_report_tables_equal_the_reference():
    recs = _full_records()
    for mesh in ("16x16", "2x16x16"):
        assert report.dryrun_table(recs, mesh) == \
            jreport.dryrun_table(recs, mesh)
        assert report.roofline_table(recs, mesh) == \
            jreport.roofline_table(recs, mesh)
        assert len(report.roofline_table(recs, mesh).splitlines()) == 2 + 15
    assert report.notes_list(recs) == jreport.notes_list(recs)
    assert "UniCAIM inapplicable" in report.notes_list(recs)
    for x in (0, 999, 1234, 5.6e6, 7.8e9):
        assert report.fmt_b(x) == jreport.fmt_b(x)
    for x in (2e-7, 3e-4, 0.25, 7.5):
        assert report.fmt_t(x) == jreport.fmt_t(x)


def test_report_prints_na_for_null_fields():
    r = dryrun.run_cell("granite-3-2b", "decode_32k", False)
    recs = {("granite-3-2b", "decode_32k", "16x16", "unicaim"): r}
    row = report.dryrun_table(recs).splitlines()[-1]
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[:2] == ["granite-3-2b", "decode_32k"]
    assert cells[2] == cells[6] == cells[7] == cells[8] == "n/a"
    assert cells[3].endswith("GiB") and cells[4] != "n/a"
    roof = report.roofline_table(recs).splitlines()[-1]
    cells = [c.strip() for c in roof.strip("|").split("|")]
    assert cells[4] == cells[8] == "n/a"
    assert cells[5] == "**memory**" and cells[9].endswith("%")


def _policies():
    return {"dense": dict(max_seq=4096), "streaming": dict(budget=512),
            "h2o": dict(heavy=448, reserve=64),
            "snapkv": dict(heavy=448, reserve=64),
            "unicaim": dict(heavy=960, reserve=64, select_k=128)}


@pytest.mark.parametrize("policy", list(_policies()))
def test_memory_footprint_equals_the_reference(policy):
    for bits in (1, 2, 3, 4, 5, 8):
        kw = dict(_policies()[policy])
        if policy == "unicaim":
            kw["score_bits"] = bits
        tp = getattr(baselines, policy)(**kw)
        jp = getattr(jax_baselines, policy)(**kw)
        for n in (1, 100, 1024, 1 << 15):
            for hk, d in ((1, 64), (8, 128), (32, 112), (1, 576)):
                for kv_bytes in (1, 2):
                    assert memory_footprint_bytes(n, hk, d, tp, kv_bytes) \
                        == jax_footprint(n, hk, d, jp, kv_bytes)


def test_fused_auto_decision_on_the_cpu():
    got = attention.fused_auto_decision(torch.device("cpu"))
    assert set(got) == {"engine", "backend", "reason"}
    assert got["engine"] == "composed" and got["backend"] == "cpu"
    assert "sm_90a" in got["reason"]
    assert attention.fused_auto_decision("meta")["engine"] == "composed"
    for fused, want in (("auto", False), (True, True), (False, False)):
        prune = baselines.unicaim(heavy=24, reserve=8, select_k=8,
                                  fused=fused)
        assert attention._fused_enabled(prune, torch.device("cpu")) is want

