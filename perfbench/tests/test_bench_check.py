"""The comparison that decides ``correct``, at test sizes on the CPU: a
sound run passes; the control (the reference in float8 in the program's
place) and each fault planted in the program's timed path fail.

The limits here are set for these sizes from their own readings (sound
gaps over six seeds: loss <= 1.6e-4, grad1 <= 3.1e-3, delta <= 2.7e-3;
the control on three: loss >= 6.8e-4, grad1 >= 9.7e-3), as the cells'
are set from theirs at full size on the card (PERF.md)."""
import time

import pytest

from conftest import tiny_cell
from harness import check, faults, roofline, run
from reference.step import follow

LIMITS = {"loss": 4e-4, "grad1": 6e-3, "delta": 6e-3, "levels": None}
SEED = 2 ** 31 + 17


def _run(kind, mode, fault=None):
    cell = tiny_cell(kind, mode, {k: v for k, v in LIMITS.items()
                                  if mode != "fp32" or k != "levels"})
    return run.run_cell(cell, SEED, 0.2, False, "cpu", roofline.H100,
                        time.perf_counter(), fault=fault)


@pytest.mark.parametrize("mode", ["all_gather", "fp32", "two_phase"])
@pytest.mark.parametrize("kind", ["attn", "rwkv"])
def test_sound_run_is_correct(kind, mode):
    res = _run(kind, mode)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("mode", ["all_gather", "fp32", "two_phase"])
def test_fault_in_the_timed_path_is_caught(fault, mode):
    res = _run("attn", mode, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("mode", ["all_gather", "fp32", "two_phase"])
@pytest.mark.parametrize("kind", ["attn", "rwkv"])
def test_control_in_float8_is_caught(kind, mode):
    cell = tiny_cell(kind, mode)
    want = follow(cell.model, cell.traffic, 5, 3, "cpu")
    got = follow(cell.model, cell.traffic, 5, 3, "cpu", fp8=True)
    limits = {k: v for k, v in LIMITS.items() if k in ("loss", "grad1")}
    ok, table = check.judge(check.numbers(got, want), limits)
    assert not ok, table


def test_judge_refuses_nan_and_unknown_limits():
    ok, _ = check.judge({"loss": float("nan")}, {"loss": 1.0})
    assert not ok
    ok, table = check.judge({"loss": 0.5, "levels": 9.0},
                            {"loss": 1.0, "levels": None})
    assert ok and table["levels"] == {"value": 9.0, "limit": None}
    with pytest.raises(ValueError):
        check.judge({"loss": 0.5}, {"grad1": 1.0})
