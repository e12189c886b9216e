"""Benchmark of the PyTorch/CUDA serving port (``src/repro_torch``).

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it is started on: draws the
weights on the card from the seed, warms the cell's own shapes up, serves the
cell's traffic through the program's plan-driven pool for ``--seconds``,
checks a sample of what it served against the plain float32 reference, and
prints one JSON line.  With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (the profiler
traces a centred slice of the window).  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache the program or PyTorch may write stays at a fixed path inside
# the checkout, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "servebench" / sub)
sys.path[:0] = [str(HERE), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # top-level module names, whole


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metric_names(spec: dict, cell: str, key: str) -> list:
    return [m for m in spec[key] if cell in m.get("workloads", [cell])]


def breakdown(run) -> dict:
    """The traced slice's ten costliest device operations, and its ten
    longest idle gaps labelled by what the host was doing."""
    import devtrace
    ev = run.events or []
    ops = sorted(devtrace.seconds_by_name(ev).items(), key=lambda kv: -kv[1])[:10]
    steps = run.traced_steps()
    gaps = []
    if ev and steps:
        offset = ev[0][0] - steps[0].t0          # device clock minus host clock
        for a, b in devtrace.idle_gaps(ev):
            h = (a + b) / 2 - offset
            step = next((s for s in steps if s.t0 <= h <= s.t1), None)
            what = ("between steps: harness and pool" if step is None else
                    "admission step" if step.admitted else "decode step")
            gaps.append([what, b - a])
        gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": gaps}


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            overrides: dict = None, t_start: float = None):
    """Run one cell; returns (result dict, stderr lines).  ``overrides``
    (tests only) replaces the configuration or parts of the mix;
    ``t_start`` (tests only) where set-up starts, else the process start."""
    import torch

    import devtrace
    import harness
    import judge
    import readers
    import traffic
    pct = traffic.percentile

    spec = harness.bench()
    run, check = harness.measure(workload, seed, seconds, trace, device,
                                 T_START if t_start is None else t_start, overrides)
    picked = run.picked
    t_ref = time.monotonic()
    number = check["number"] if check else "widest_logit_gap"
    value = (judge.NUMBERS[number](judge.served_gaps(
        judge.reference_logits(run.c, seed, picked, device), picked)) if picked else None)
    ref_s = time.monotonic() - t_ref
    limit = check["limit"] if check else None

    metrics = {}
    for m in metric_names(spec, workload, "per_layer" if trace else "end_to_end"):
        v = harness.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    if trace:
        dev["busy_s"] = devtrace.busy_s(run.events or [])
        dev["window_s"] = run.trace_t1 - run.trace_t0
    due = list(run.reqs.values())
    finished = [r for r in due if r.done]
    ttft, gaps = readers.ttft_ms(run), sorted(readers.gaps_ms(run))
    correct = value is not None and limit is not None and value <= limit
    result = {"correct": correct, "attempted": len(due), "failed": run.refused + run.shed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown(run)
    result["check"] = {number: {"value": value, "limit": limit}}
    lines = [
        f"requests sent {len(due)}, finished {len(finished)}, refused {run.refused}, "
        f"shed {run.shed}, failed {run.refused + run.shed}",
        f"window {harness.window_s(run):.3f} s, setup {run.setup_s:.3f} s, "
        f"output tokens {harness.tokens_in_window(run)}, steps {len(run.steps)}",
        f"ttft p50 {pct(ttft, 0.5):.3f} p90 {pct(ttft, 0.9):.3f} p95 {pct(ttft, 0.95):.3f} "
        f"mean {sum(ttft) / max(len(ttft), 1):.3f} ms over {len(ttft)} requests",
        f"token gap p50 {pct(gaps, 0.5):.3f} p95 {pct(gaps, 0.95):.3f} p99 {pct(gaps, 0.99):.3f} "
        f"mean of the longest 5% {readers.top_mean(gaps, 0.05) or float('nan'):.3f} ms "
        f"over {len(gaps)} gaps, "
        f"{sum(g > 5 * pct(gaps, 0.5) for g in gaps)} over 5x the median",
        f"generator lateness p50 {traffic.percentile(run.lateness, 0.5) * 1e3:.3f} ms, "
        f"p95 {traffic.percentile(run.lateness, 0.95) * 1e3:.3f} ms, "
        f"max {max(run.lateness, default=float('nan')) * 1e3:.3f} ms",
        f"reference over {len(picked)} requests, "
        f"{sum(len(s.tokens) for s in picked)} served tokens, {ref_s:.3f} s",
        f"check {number} {value} limit {limit}",
    ]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    cell = harness.cell_files(args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"servebench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"servebench: the process loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
