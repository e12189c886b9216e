"""Readings that set a cell's correctness limit (``servebench/checks/<cell>.json``).

    python3 servebench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2 --seconds 30

In one process, for each seed: the program serves the cell's traffic at the
cell's own load for ``--seconds`` (no profiler), the sample the benchmark
would judge is drawn, the program is freed, and the plain float32 reference
gives the program's widest logit gap; for the control seeds, the float8
control is run on the same prompts and tokens and its widest gap read the
same way.  One JSON line per seed, then the largest program reading and the
smallest control reading.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def readings(workload: str, seed: int, seconds: float, control: bool, device,
             overrides: dict = None) -> dict:
    import harness
    import judge
    run, _ = harness.measure(workload, seed, seconds, False, device, time.monotonic(),
                             overrides)
    c, picked = run.c, run.picked
    out = {"seed": seed, "requests": len(picked),
           "served_tokens": sum(len(s.tokens) for s in picked)}
    if not picked:
        return out
    ref = judge.reference_logits(c, seed, picked, device)
    out["program"] = judge.served_gaps(ref, picked).tolist()
    if control:
        ctrl = judge.reference_logits(c, seed, picked, device, control=True)
        out["control"] = judge.control_gaps(ref, ctrl).tolist()
    if c["model_type"] == "mixtral":
        out["program_vs_bf16_router"] = judge.served_gaps(bf16_router_logits(
            c, seed, picked, device), picked).tolist()
    return out


def bf16_router_logits(c, seed, picked, device):
    """The look at where the program's widest gaps come from: the reference
    with only its router's product rounded as the program's is (bf16
    operands and result), so that the top-2 choice flips where the
    program's can."""
    import torch

    import judge
    from reference import mixtral as ref
    from reference.common import swiglu
    plain = ref.moe

    def rounded(h, W, p, top_k):
        logits = (h.bfloat16() @ W[p + "ffn.router"].bfloat16()).float()
        top_p, top_i = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(logits.shape[-1]):
            tok, slot = (top_i == e).nonzero(as_tuple=True)
            if tok.numel():
                y = swiglu(h[tok], W[p + "ffn.w_gate"][e], W[p + "ffn.w_up"][e],
                           W[p + "ffn.w_down"][e])
                out.index_add_(0, tok, y * top_p[tok, slot][:, None])
        return out

    ref.moe = rounded
    try:
        return judge.reference_logits(c, seed, picked, device)
    finally:
        ref.moe = plain


def summary(g: list) -> dict:
    """Statistics of one run's gaps: widest, 99th and 95th percentile, mean,
    and the share of positions whose token is not the reference's best."""
    import torch
    t = torch.tensor(g)
    return {"max": float(t.max()), "p99": float(t.quantile(0.99)), "p95": float(t.quantile(0.95)),
            "mean": float(t.mean()), "off_best": float((t > 0).float().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default="", help="file for every position's gaps")
    args = ap.parse_args(argv)
    import torch

    import harness
    import judge
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(ctrl - {int(s) for s in args.seeds.split(",")})
    rows = []
    for seed in seeds:
        t0 = time.monotonic()
        row = readings(args.workload, seed, args.seconds, seed in ctrl, torch.device("cuda", 0))
        row["seconds"] = time.monotonic() - t0
        rows.append(row)
        print(json.dumps({k: (summary(v) if isinstance(v, list) else v)
                          for k, v in row.items()}), flush=True)
    if args.dump:
        Path(args.dump).write_text(json.dumps(rows))
    _, _, _, check = harness.cell_files(args.workload)
    stat = judge.NUMBERS[check["number"] if check else "widest_logit_gap"]
    prog = [stat(torch.tensor(r["program"])) for r in rows if "program" in r]
    ctl = [stat(torch.tensor(r["control"])) for r in rows if "control" in r]
    print(json.dumps({"workload": args.workload, "program_max": max(prog, default=None),
                      "control_min": min(ctl, default=None), "program": prog, "control": ctl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
