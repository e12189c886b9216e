"""Rate sweep of an open-loop cell, to find its knee once.

    python3 servebench/sweep.py --workload mixtral.chat --rates 1.5,2,2.5 \
        --seconds 51 --seed 7

Builds the cell once, then serves its traffic at each rate in turn for
``--seconds`` (the engine drained between rates).  For each rate it prints
the requests due and finished, the TTFT p50 / p95 / mean, the token gap
p95 / p99, and the requests due but not yet started at a third, two thirds
and the end of the window: a queue that keeps growing means the rate is
past the knee.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def backlog_at(run, t: float) -> int:
    """Requests due by ``t`` whose first token came later, or never."""
    return sum(1 for r in run.reqs.values()
               if r.due <= t and (not r.times or r.times[0] > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    import harness
    import traffic
    _, c, mix, _ = harness.cell_files(args.workload)
    backend = harness.build(c, mix, args.seed, torch.device("cuda", 0))
    warm = harness.new_run(c, mix, 0)
    harness.prepare(harness.Stepper(backend, warm), warm, args.seed, False)
    for rate in [float(r) for r in args.rates.split(",")]:
        run = harness.new_run(c, {**mix, "rate_per_s": rate}, args.seconds)
        drv = harness.Stepper(backend, run)
        harness.serve(drv, run, args.seed, False, time.monotonic())
        while drv.busy():
            drv.round()
        due = list(run.reqs.values())
        ttft = [((r.times[0] if r.times else run.t_close) - r.due) * 1e3 for r in due]
        itl = [(b - a) * 1e3 for r in due for a, b in zip(r.times, r.times[1:])
               if b <= run.t_close]
        T = run.seconds
        print(json.dumps({
            "rate": rate, "due": len(due), "finished_in_window": sum(
                1 for r in due if r.done and r.times[-1] <= run.t_close),
            "ttft_p50_ms": traffic.percentile(ttft, 0.5),
            "ttft_p95_ms": traffic.percentile(ttft, 0.95),
            "ttft_mean_ms": sum(ttft) / max(len(ttft), 1),
            "itl_p95_ms": traffic.percentile(itl, 0.95),
            "itl_p99_ms": traffic.percentile(itl, 0.99),
            "backlog_third": backlog_at(run, run.t_open + T / 3),
            "backlog_two_thirds": backlog_at(run, run.t_open + 2 * T / 3),
            "backlog_end": backlog_at(run, run.t_close)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
