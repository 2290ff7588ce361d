"""Every cell of BENCHMARK.json resolves by name to its files, and the
file keeps to the benchmark's contract."""
import json
import re

import pytest

from conftest import BENCH, ROOT, TINY
from harness import cells, shapes, system

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "checks" / f"{name}.json").is_file()
    assert cell.chips == 1
    assert {"tokens_per_s", "setup_s"} <= {m.name for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)
    # the limits name numbers that the comparison computes
    assert set(cell.limits) <= {"loss", "grad1", "delta", "levels",
                                "grad1_median", "delta_median"}


def test_contract_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    used = {w["config"] for w in SPEC["workloads"]}
    assert set(names) == used
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    every = names + CELLS + [m["name"] for m in metrics]
    assert len(set(every)) == len(every)
    for n in every + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] == "tokens_per_s"
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert layers
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + sorted(TINY))
def test_layout_is_the_programs(name):
    """The benchmark's own leaf layout (which the reference and the
    per-leaf readings use) is the port's flat layout, leaf for leaf, in
    the port's groups of slots; a leaf of the plain draws is drawn as the
    port's init code says (normal at the code's fan-in, ones, zeros),
    and the parameters a token touches are the port's count."""
    from repro_torch.models.transformer import param_layout
    m = (TINY[name] if name in TINY else json.loads(
        (ROOT / next(c["file"] for c in SPEC["configs"]
                     if c["name"] == name)).read_text())["model"])
    cfg = system.model_config(m)
    assert shapes.group_size(m) == cfg.group_size
    assert [(n, tuple(s)) for n, s, _ in param_layout(cfg)] == [
        (lf.name, lf.shape) for lf in shapes.leaves(m)]
    for (_, _, code), lf in zip(param_layout(cfg), shapes.leaves(m)):
        plain = {shapes.NORMAL: lf.fan_in, shapes.ONES: -1, shapes.ZEROS: 0}
        assert plain.get(lf.draw, code) == code, lf
    assert cfg.active_param_count() == shapes.param_count(m)


def test_coordinates_as_stated():
    d = {c: shapes.coordinates(cells.resolve(c).model) for c in CELLS}
    assert d["qwen3-0.6b.alq3-allgather"] == 751_632_384
    assert d["rwkv6-7b-2l.alq3-allgather"] == 1_058_099_200
