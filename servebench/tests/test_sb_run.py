"""A whole run on the CPU at cut-down widths, past the look for a card: it
prints the contract's keys, and with a token altered where the program
produces it, ``correct`` comes out false."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import harness
import run
import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", ["mixtral.chat", "minicpm3.docqa"])
def test_a_run_on_the_cpu_reports_every_key(cell):
    result, lines = run.execute(cell, tiny.SEED, tiny.SECONDS, False, "cpu", tiny.overrides(cell))
    assert list(result) == KEYS
    e2e = [m["name"] for m in harness.bench()["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert sorted(result["metrics"]) == sorted(e2e)
    assert result["attempted"] > 0 and result["failed"] == 0
    number = harness.cell_files(cell)[3]["number"]
    assert lines[-1].startswith(f"check {number} ")
    assert result["check"][number]["value"] is not None


@pytest.mark.parametrize("cell", ["mixtral.chat", "minicpm3.docqa"])
def test_an_altered_token_is_not_correct(cell, monkeypatch):
    from repro_torch.models import lm
    paged_step = lm.paged_step

    def altered(*args, **kwargs):
        logits, cache = paged_step(*args, **kwargs)
        logits = logits.clone()
        logits[..., 5] += 1e4               # the token produced is always 5
        return logits, cache

    monkeypatch.setattr(lm, "paged_step", altered)
    result, _ = run.execute(cell, tiny.SEED, tiny.SECONDS, False, "cpu", tiny.overrides(cell))
    [(number, check)] = result["check"].items()
    assert result["correct"] is False and check["value"] > check["limit"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mixtral.chat", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's folder has no
    program to serve: the run fails before it prints anything."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; sys.argv = ['run.py', '--workload', "
            "'mixtral.chat', '--seed', '1', '--seconds', '1']; "
            "sys.path.insert(0, 'servebench'); import run; sys.exit(run.main())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "repro_torch" in p.stderr
