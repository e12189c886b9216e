"""The benchmark's files: every cell, configuration, mix, check and metric is
found by its name, and BENCHMARK.json keeps to the contract's shapes."""
import json
import re

import pytest

import harness

SPEC = harness.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["servebench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    entry, c, mix, check = harness.cell_files(cell)
    assert entry["chips"] in (1, 4)
    assert c["name"] == entry["config"]
    assert mix["loop"] in ("open", "closed")
    assert check is not None and check["limit"] > 0
    assert harness.family(c).param_groups(c)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_and_bounds():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_its_cells_report(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert reports(cell, moved)
    assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert [m for m in SPEC["per_layer"] if reports(cell, m)]


def test_each_kernel_roofline_has_an_mfu_moving_the_same_metric():
    mfu_moves = {m["moves"] for m in SPEC["per_layer"] if "mfu" in m["name"].split(".")[0]}
    for m in SPEC["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%" and m["moves"] in mfu_moves


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_it_cut(entry):
    c = harness.load_json(harness.ROOT / entry["file"])
    assert sorted(c["reduced"]) == sorted(entry["reduced"])
    assert c["source"].startswith("https://") and entry["source"] in c["source"]
    assert c["deployment"] and c["departures"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_served_context_fits_the_stated_positions(cell):
    _, c, mix, _ = harness.cell_files(cell)
    longest = (mix["prompt"]["max"] if "prompt" in mix else
               mix["documents"]["length"] + mix["question"]["max"]) + mix["output"]["max"]
    assert longest <= mix["plan"]["max_seq_len"] <= c["max_position_embeddings"]


def test_a_suffixed_metric_reads_its_base_file_unless_it_has_its_own():
    assert harness.reader("mfu.batch").__module__ == "metric_mfu.batch"
    assert harness.reader("mfu.batch").__code__.co_filename.endswith("/mfu.py")
    assert harness.reader("mfu.open_decode").__code__.co_filename.endswith("/mfu.open_decode.py")
