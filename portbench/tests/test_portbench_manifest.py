"""BENCHMARK.json keeps to its contract, and every name in it resolves to
the files of its own that the harness reads."""

import json
import re

import pytest

from tiny import ROOT, entry

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_resolves_by_name(workload):
    c = entry.cell(BENCH, workload)
    assert c.window_path.is_file()
    assert c.config["name"] == c.workload["config"]
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert hasattr(entry.reader(m["name"]), "read")
    # each per-layer metric moves an end-to-end metric this cell reports
    assert all(m["moves"] in e2e for m in c.per_layer)


def test_configs_state_what_they_reduce():
    for c in entry.with_held(BENCH)["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg.get("published", {})


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)


@pytest.mark.parametrize("held", sorted((ROOT / "portbench" / "held").glob("*.json")),
                         ids=lambda p: p.stem)
def test_a_held_cell_resolves_and_would_keep_the_contract(held):
    """A cell held out of the benchmark resolves by name as a benchmarked
    one does, and its entries would join BENCHMARK.json as they stand."""
    entries = json.loads(held.read_text())
    (w,) = entries["workloads"]
    assert w["name"] == held.stem and w["name"] not in WORKLOADS
    assert w["config"] in {c["name"] for c in BENCH["configs"] + entries.get("configs", [])}
    c = entry.cell(entry.with_held(BENCH), w["name"])
    assert c.window_path.is_file() and set(c.limits)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in entries["end_to_end"] + entries["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert hasattr(entry.reader(m["name"]), "read")
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert all(0.01 <= m["bound"] <= 0.25 for m in entries["end_to_end"])
