#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: ``python3 chip_smoke.py`` from the
repo root on a machine with one CUDA card (an H100; the kernels target
sm_90a).

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device: CUDA present, card name and power limit (nvidia-smi);
  2. build: the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, in
     parallel) and the Triton RMSNorm;
  3. each kernel against its plain PyTorch version at the main path's
     full-width shapes (bf16 to 2e-2, f32 to 2e-5), with the kernel's, the
     plain version's and one PyTorch library call's times (CUDA events, L2
     cold for the attention kernels) and the kernel's bound;
  4. the main path at full width: qwen2-1.5b (28 layers, bf16, seeded random
     weights) served through ``TorchBackend`` by 2 replicas × 8 slots,
     with a shared-prefix wave, a drain resize to half the batch, and the
     kernels' launch counters checked against the dispatches;
  5. the port on the card (bf16, kernels) against the port on the CPU (f32,
     plain versions) for one prefill chunk and 8 decode steps, 2 layers;
  6. the kernels' JSON line, the card line, and the final JSON line.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """(kernel<type[,D]>, registers, spill line) per entry in an nvcc
    ``-Xptxas=-v`` log."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(decode_split_kernel|decode_combine_kernel|"
                             r"flash_attention_kernel)", mangled)
            dtype = "bf16" if "nv_bfloat16" in mangled else "f32"
            d = re.search(r"Li(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + f"<{dtype}" + (
                f", D={d.group(1)}>" if d else ">")
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((name, int(regs), spills))
    return out


# --------------------------------------------------------------------------- #
# timing / comparison helpers
# --------------------------------------------------------------------------- #
def time_ms(torch, fn, n_inputs: int, iters: int = 40, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)``; the input index cycles over
    ``n_inputs`` copies so a working set larger than L2 arrives cold."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want, dtype: str) -> float:
    """Max |got − want|; raises if any element exceeds atol + rtol·|want|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TOL[dtype]
    bad = int((diff > tol + tol * w.abs()).sum())
    need(bad == 0 and bool(torch.isfinite(g).all()),
         f"{bad} elements beyond tolerance {tol} (max err {float(diff.max())})")
    return float(diff.max())


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
# phase 3: kernels vs plain versions
# --------------------------------------------------------------------------- #
def check_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_k, ref as fa_r
    from repro_torch.kernels.flash_decode import kernel as fd_k, ref as fd_r
    from repro_torch.kernels.rmsnorm import kernel as rms_k, ref as rms_r

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    dt_of = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    B, H, Hkv, D, PAGE, NPT = 8, 12, 2, 128, 16, 128
    S = NPT * PAGE
    COPIES = 8                      # 8 copies of the attention inputs > 50 MB L2
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, device=dev, generator=gen).to(dt_of[dt])

    # --- paged flash-decode ------------------------------------------------
    kv_spread = [0, 1, 17, 300, 777, 1024, 1500, 2048]
    n_pages = B * NPT + 1
    errs = []
    for dt in ("bfloat16", "float32"):
        for window in (None, 512):
            q = randn((B, H, D), dt)
            kp, vp = randn((n_pages, PAGE, Hkv, D), dt), randn((n_pages, PAGE, Hkv, D), dt)
            ptab = (torch.randperm(n_pages - 1, device=dev, generator=gen)[:B * NPT]
                    + 1).reshape(B, NPT).int()
            kl = torch.tensor(kv_spread, device=dev, dtype=torch.int32)
            e = max_err(torch, fd_k.paged_flash_decode(q, kp, vp, ptab, kl, window),
                        fd_r.paged_flash_decode_ref(q, kp, vp, ptab, kl, window), dt)
            print(f"[kernels] paged_flash_decode {dt} B={B} H={H} Hkv={Hkv} "
                  f"D={D} page={PAGE} kv_len={kv_spread} window={window} "
                  f"max_abs_err={e:.3e} (tol {TOL[dt]})")
            if dt == "bfloat16":
                errs.append(e)
    sets = []
    for _ in range(COPIES):
        sets.append((randn((B, H, D), "bfloat16"),
                     randn((n_pages, PAGE, Hkv, D), "bfloat16"),
                     randn((n_pages, PAGE, Hkv, D), "bfloat16"),
                     (torch.randperm(n_pages - 1, device=dev, generator=gen)[:B * NPT]
                      + 1).reshape(B, NPT).int()))
    kl = torch.tensor(kv_spread, device=dev, dtype=torch.int32)
    ms = time_ms(torch, lambda i: fd_k.paged_flash_decode(*sets[i], kl), COPIES)
    plain = time_ms(torch, lambda i: fd_r.paged_flash_decode_ref(*sets[i], kl),
                    COPIES, iters=10)
    dense = []
    for q, kp, vp, pt in sets:          # pre-gathered K/V for the library call
        kk = kp[pt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
        vv = vp[pt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
        dense.append((q[:, :, None], kk, vv))
    mask = (torch.arange(S, device=dev)[None, :] < kl[:, None].long())[:, None, None, :]
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        *dense[i], attn_mask=mask, enable_gqa=True), COPIES)
    live = sum(kv_spread)
    nbytes = (2 * B * H * D * 2 + B * NPT * 4 + B * 4 + live * Hkv * D * 2 * 2)
    b_ms, b_by = bound(nbytes, 4.0 * live * H * D, "bfloat16")
    rows["paged_flash_decode"] = dict(
        route="cuda", source="src/repro_torch/csrc/paged_flash_decode.cu",
        replaces="src/repro/kernels/flash_decode/kernel.py:164",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)
    print(f"[kernels] paged_flash_decode bf16 timed at kv_len={kv_spread}: "
          f"{ms:.4f} ms (plain {plain:.4f} ms, SDPA on pre-gathered K/V "
          f"{lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}); blocks "
          f"{B * Hkv}×{fd_k.split_plan(B * Hkv, NPT, torch.cuda.get_device_properties(dev).multi_processor_count)}")

    # --- flash attention ----------------------------------------------------
    def fa_case(Sq, kvl, causal, window, cap, dt):
        q = randn((B, Sq, H, D), dt)
        k, v = randn((B, S, Hkv, D), dt), randn((B, S, Hkv, D), dt)
        klt = None if kvl is None else torch.tensor(kvl, device=dev, dtype=torch.int32)
        return q, k, v, klt

    errs = []
    cases = [(64, [64, 65, 100, 513, 1024, 1500, 2000, 2048], True, None, None),
             (16, [16, 17, 40, 100, 999, 1024, 2000, 2048], True, None, None),
             (64, [64, 300, 700, 1100, 1300, 1700, 1900, 2048], True, 256, None),
             (64, None, True, None, 30.0)]
    for dt in ("bfloat16", "float32"):
        for Sq, kvl, causal, window, cap in cases:
            q, k, v, klt = fa_case(Sq, kvl, causal, window, cap, dt)
            e = max_err(torch, fa_k.flash_attention(q, k, v, causal, window, cap, klt),
                        fa_r.flash_attention_ref(q, k, v, causal, window, cap, klt), dt)
            print(f"[kernels] flash_attention {dt} B={B} Sq={Sq} Sk={S} H={H} "
                  f"Hkv={Hkv} D={D} kv_len={kvl or 'Sk'} causal={causal} "
                  f"window={window} softcap={cap} max_abs_err={e:.3e} (tol {TOL[dt]})")
            if dt == "bfloat16":
                errs.append(e)
    Sq, kvl = 64, cases[0][1]
    sets = [fa_case(Sq, kvl, True, None, None, "bfloat16") for _ in range(COPIES)]
    ms = time_ms(torch, lambda i: fa_k.flash_attention(*sets[i][:3], True, None,
                                                        None, sets[i][3]), COPIES)
    plain = time_ms(torch, lambda i: fa_r.flash_attention_ref(
        *sets[i][:3], True, None, None, sets[i][3]), COPIES, iters=10)
    klt = sets[0][3].long()
    qpos = klt[:, None] - Sq + torch.arange(Sq, device=dev)[None]
    kpos = torch.arange(S, device=dev)
    fmask = ((kpos[None, None] <= qpos[:, :, None])
             & (kpos[None, None] < klt[:, None, None]))[:, None]
    dense = [(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
              v.transpose(1, 2).contiguous()) for q, k, v, _ in sets]
    lib = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        *dense[i], attn_mask=fmask, enable_gqa=True), COPIES)
    pairs = int(fmask.sum())
    nbytes = 2 * B * Sq * H * D * 2 + B * 4 + sum(kvl) * Hkv * D * 2 * 2
    b_ms, b_by = bound(nbytes, 4.0 * pairs * H * D, "bfloat16")
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:83",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)
    print(f"[kernels] flash_attention bf16 timed at Sq={Sq} kv_len={kvl}: "
          f"{ms:.4f} ms (plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}; {pairs} visible (q,k) pairs per head)")

    # --- rmsnorm ------------------------------------------------------------
    errs = []
    for dt in ("bfloat16", "float32"):
        for shape in [(8, 1536), (512, 1536), (2, 3, 130), (7, 130)]:
            x, s = randn(shape, dt), randn((shape[-1],), "float32") * 0.1
            e = max_err(torch, rms_k.rmsnorm(x, s), rms_r.rmsnorm_ref(x, s), dt)
            print(f"[kernels] rmsnorm {dt} shape={shape} max_abs_err={e:.3e} "
                  f"(tol {TOL[dt]})")
            if dt == "bfloat16":
                errs.append(e)
    x, s = randn((8, 1536), "bfloat16"), randn((1536,), "float32") * 0.1
    ms = time_ms(torch, lambda i: rms_k.rmsnorm(x, s), 1, iters=200)
    plain = time_ms(torch, lambda i: rms_r.rmsnorm_ref(x, s), 1, iters=200)
    w = (1.0 + s).to(torch.bfloat16)
    lib = time_ms(torch, lambda i: F.rms_norm(x, (1536,), w, 1e-6), 1, iters=200)
    b_ms, b_by = bound(2 * x.numel() * 2 + 1536 * 4, 4.0 * x.numel(), "bfloat16")
    rows["rmsnorm"] = dict(
        route="triton", source="src/repro_torch/kernels/rmsnorm/kernel.py",
        replaces="src/repro/kernels/rmsnorm/kernel.py:23",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)
    print(f"[kernels] rmsnorm bf16 timed at (8, 1536): {ms:.4f} ms (plain "
          f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms, bound {b_ms:.6f} ms by {b_by})")
    return rows


# --------------------------------------------------------------------------- #
# phase 4: main path at full width
# --------------------------------------------------------------------------- #
def profile_steps(torch, eng, n: int, prepare=None):
    """Host wall of ``n`` engine steps (no profiler), then the device kernels
    of ``n`` more such steps under ``torch.profiler``: busy time (union of
    kernel intervals) and time by kernel group.  ``prepare`` runs before
    each of the two runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if prepare is not None:
        prepare()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d0 = eng.dispatches
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dispatches = eng.dispatches - d0
    if prepare is not None:
        prepare()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    groups = {}
    for s_, e_, name in spans:
        low = name.lower()
        g = ("paged_flash_decode" if "decode_" in low else
             "flash_attention" if "flash_attention" in low else
             "rmsnorm" if "rmsnorm" in low else
             "matmul" if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90")) else
             "other")
        groups[g] = groups.get(g, 0.0) + (e_ - s_)
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    return wall, dispatches, pwall, busy / 1e6, {k: v / 1e6 for k, v in groups.items()}

def serve_main_path(torch, card: str):
    import numpy as np
    from repro_torch.core.plan import Plan, ReplicaGroup
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_decode import kernel as fd_k
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.serving.backend import (make_torch_backend,
                                             measured_interval_metrics)
    from repro_torch.serving.engine import Request

    t0 = time.monotonic()
    backend = make_torch_backend("qwen2-1.5b", seed=0, reduced=False,
                                 max_seq_len=2048, slots_cap=8,
                                 max_replicas_per_group=2, page_size=16)
    cfg = backend.cfg
    L, V, MAX_NEW = cfg.n_layers, cfg.vocab_size, 32
    model = cfg.name
    plan = Plan((ReplicaGroup(model, "H100-80G", tp=1, batch=8, count=2),))
    rep = backend.apply_plan(plan, None)
    engines = list(backend.pool.engines)
    need(len(engines) == 2 and all(e.n_slots == 8 for e in engines),
         "plan did not build 2 replicas × 8 slots")
    pool_mb = sum(t.numel() * t.element_size() for t in engines[0].cache.values()) / 2**20
    print(f"[main] {model}: L={L} d={cfg.d_model} V={V} {cfg.dtype}, "
          f"{sum(p.numel() for p in backend.params.parameters()) / 1e9:.3f}B params; "
          f"2 replicas × 8 slots, max_seq_len=2048, page 16, KV pool "
          f"{pool_mb:.1f} MiB per engine; built in {time.monotonic() - t0:.2f}s "
          f"(apply_plan {rep.wall_s * 1e3:.1f} ms)")

    rng = np.random.default_rng(0)
    prefix = rng.integers(2, V, size=256).tolist()

    def prompt(shared: bool):
        n = int(rng.integers(128, 1025))
        if shared:
            return prefix + rng.integers(2, V, size=max(n - 256, 1)).tolist()
        return rng.integers(2, V, size=n).tolist()

    def wave(rids, shared_mask, dup=None):
        reqs = []
        for rid, sh in zip(rids, shared_mask):
            p = prompt(sh)
            if dup is not None and rid == dup[1]:
                p = list(reqs[-1].prompt)         # same prompt as dup[0]
            reqs.append(Request(rid=rid, prompt=p, max_new_tokens=MAX_NEW,
                                arrival_time=time.monotonic()))
        for r in reqs:
            need(backend.pool.submit(model, r), f"request {r.rid} not routed")
        return reqs

    # warm-up (cuBLAS handles, allocator): one request, not measured or counted
    backend.pool.submit(model, Request(rid=-1, prompt=list(range(2, 200)),
                                       max_new_tokens=4))
    backend.pool.run_until_drained()
    backend.pool.finished.clear()
    d0 = backend.pool.total_dispatches
    rms_k.launches = fd_k.launches = fa_k.launches = 0

    torch.cuda.synchronize()
    t1 = time.monotonic()
    wave(range(0, 8), [True, True, True, True, False, False, False, False],
         dup=(4, 5))
    done = backend.pool.run_until_drained()
    wave(range(8, 16), [True, True, True, True, False, False, False, False])
    done += backend.pool.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    met = measured_interval_metrics(done, wall)
    disp = backend.pool.total_dispatches - d0
    print(f"[main] served {met.requests} requests / {met.tokens} tokens in "
          f"{wall:.3f}s: {met.tokens_per_s:.1f} tok/s, TTFT p50 "
          f"{met.ttft_p50_s * 1e3:.1f} ms p95 {met.ttft_p95_s * 1e3:.1f} ms, "
          f"TPOT {met.tpot_s * 1e3:.2f} ms, {disp} dispatches "
          f"[{card}; 128-1024-token prompts, 32 new tokens, half sharing a "
          f"256-token prefix]")
    by_rid = {d.request.rid: d for d in done}
    need(sorted(by_rid) == list(range(16)), f"finished {sorted(by_rid)}")
    need(all(len(d.generated) == MAX_NEW for d in done),
         "a request finished short of its token budget")
    need(by_rid[4].generated == by_rid[5].generated,
         "the same request served twice gave different tokens")
    hits = sum(e.prefix_hits for e in engines)
    need(hits > 0, "no prefix hit")

    # where a step's time goes: one engine, 8 lanes of 256-token prompts
    eng = engines[0]

    def admit8():
        eng.run_until_drained()
        for _ in range(8):
            eng.submit(Request(rid=100, prompt=rng.integers(2, V, size=256).tolist(),
                               max_new_tokens=24, arrival_time=time.monotonic()))

    for label, n, prep in (("admission step (8 prefills of 4×64-token chunks "
                            "+ 1 decode)", 1, admit8),
                           ("decode steps (8 active lanes)", 8, None)):
        wall, disp_n, pwall, busy, groups = profile_steps(torch, eng, n, prep)
        gtxt = ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in
                         sorted(groups.items(), key=lambda kv: -kv[1]))
        print(f"[main] {label}: {wall * 1e3 / disp_n:.2f} ms per dispatch "
              f"({disp_n} dispatches, host wall); profiled repeat: device busy "
              f"{busy * 1e3:.2f} ms of {pwall * 1e3:.2f} ms wall "
              f"(idle {100 * (1 - busy / pwall):.1f}%); kernels: {gtxt or 'none traced'}")
    backend.pool.run_until_drained()

    # --resize-style drain to half the batch, with 4 requests in flight
    in_flight = wave(range(16, 20), [False] * 4)
    for e in backend.pool.engines:
        e.step()
    t2 = time.monotonic()
    rep2 = backend.apply_plan(Plan((ReplicaGroup(model, "H100-80G", tp=1,
                                                 batch=4, count=2),)), None)
    resize_s = time.monotonic() - t2
    need(rep2.drained_requests == 4 and len(rep2.removed) == 1,
         f"resize drained {rep2.drained_requests}, removed {len(rep2.removed)}")
    after = wave(range(20, 24), [True, False, True, False])
    done2 = backend.pool.run_until_drained()
    finished = {d.request.rid for d in backend.pool.finished} | {d.request.rid for d in done2}
    need({r.rid for r in in_flight + after} <= finished, "requests lost in resize")
    new_engines = backend.pool.engines
    need(all(e.n_slots == 4 for e in new_engines), "resize did not halve the batch")
    print(f"[main] resize to 2 × 4 slots: drained {rep2.drained_requests} in "
          f"{resize_s:.3f}s (drain {rep2.drain_wall_s:.3f}s), then served "
          f"{len(done2)} more")

    total = backend.pool.total_dispatches - d0
    leaks = [e.release_all_pages() for e in engines + new_engines]
    need(all(n == 0 for n in leaks), f"leaked pages {leaks}")
    hits = sum(e.prefix_hits for e in engines + new_engines)
    counts = {"rmsnorm": rms_k.launches, "paged_flash_decode": fd_k.launches,
              "flash_attention": fa_k.launches}
    print(f"[main] launches {counts} over {total} dispatches (L={L}); "
          f"prefix hits {hits}; leaked pages {leaks}")
    need(counts["rmsnorm"] == (2 * L + 1) * total, "rmsnorm launches != (2L+1)·dispatches")
    need(counts["paged_flash_decode"] > 0 and counts["paged_flash_decode"] % L == 0,
         "decode launches not L per decode dispatch")
    need(counts["flash_attention"] > 0 and counts["flash_attention"] % L == 0,
         "flash-attention launches not L per prefill chunk")
    need(counts["paged_flash_decode"] + counts["flash_attention"] == L * total,
         "attention launches != L per dispatch")
    main = dict(tokens_per_s=met.tokens_per_s, ttft_p50_ms=met.ttft_p50_s * 1e3,
                ttft_p95_ms=met.ttft_p95_s * 1e3, tpot_ms=met.tpot_s * 1e3,
                requests=met.requests, dispatches=disp, prefix_hits=hits)
    del backend, engines, new_engines
    torch.cuda.empty_cache()
    return counts, main


# --------------------------------------------------------------------------- #
# phase 5: port on the card vs port on the CPU
# --------------------------------------------------------------------------- #
def card_vs_cpu(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg_gpu = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2)
    cfg_cpu = dataclasses.replace(cfg_gpu, dtype="float32")
    m_cpu = lm.init_params(cfg_cpu, torch.Generator().manual_seed(7), "cpu")
    m_gpu = lm.PagedLM(cfg_gpu, "cuda")
    with torch.no_grad():        # the same weight values on both sides:
        for (n, pg), (n2, pc) in zip(m_gpu.named_parameters(), m_cpu.named_parameters()):
            need(n == n2, f"parameter order {n} != {n2}")
            pg.copy_(pc)            # bf16 on the card ...
            pc.copy_(pg.float().cpu())   # ... and those bf16 values in f32 here
    B, C, PAGE, NPT, STEPS = 4, 64, 16, 5, 8
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(3)
    ptab = (1 + np.arange(B * NPT)).reshape(B, NPT).astype(np.int32)
    ptab[~active] = 0
    caches = {"cpu": lm.init_paged_cache(cfg_cpu, 1 + B * NPT, PAGE, device="cpu"),
              "cuda": lm.init_paged_cache(cfg_gpu, 1 + B * NPT, PAGE, device="cuda")}
    tokens = rng.integers(2, cfg_gpu.vocab_size, size=(B, C)).astype(np.int32)
    pos2 = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    worst, agree, near, total = 0.0, 0, 0, 0
    tol = TOL["bfloat16"]
    for step in range(STEPS + 1):
        out = {}
        for dev, cfg, m in (("cpu", cfg_cpu, m_cpu), ("cuda", cfg_gpu, m_gpu)):
            with torch.inference_mode():
                logits, _ = lm.paged_step(
                    m, cfg, caches[dev], torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(pos2).to(dev), torch.from_numpy(ptab).to(dev),
                    torch.from_numpy(active).to(dev), page_size=PAGE)
            out[dev] = logits.float().cpu()
        a = torch.from_numpy(active)
        want, got = out["cpu"][a], out["cuda"][a]
        worst = max(worst, max_err(torch, got, want, "bfloat16"))
        top_c = want.argmax(-1)
        top_g = got.argmax(-1)
        same = top_c == top_g
        # a differing argmax must be a tie at the stated tolerance: the CPU
        # logit of the card's choice within tol of the CPU maximum
        gap = want.max(-1).values - want.gather(-1, top_g[..., None])[..., 0]
        need(bool((same | (gap <= tol)).all()),
             f"step {step}: argmax differs beyond a {tol} tie (gap {float(gap.max())})")
        agree += int(same.sum())
        near += int((~same).sum())
        total += same.numel()
        tokens = out["cpu"][:, -1].argmax(-1).numpy()[:, None].astype(np.int32)
        pos2 = (pos2[:, -1:] + 1).astype(np.int32)
    print(f"[card-vs-cpu] qwen2-1.5b width, 2 layers, 1 prefill chunk of {C} + "
          f"{STEPS} decode steps, {B} lanes (1 inactive): max |logit diff| "
          f"{worst:.4e} (tol {tol} abs + rel); argmax equal at {agree}/{total} "
          f"active positions, {near} within-tolerance ties")
    return worst


def main() -> int:
    import torch
    # phase 1: device
    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    need((ROOT / "src" / "repro_torch").is_dir(),
         "src/repro_torch is missing: run chip_smoke.py from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    t0 = time.monotonic()
    build.build(["paged_flash_decode", "flash_attention"])
    t_nvcc = time.monotonic() - t0
    x = torch.ones((2, 1536), device="cuda", dtype=torch.bfloat16)
    rms_k.rmsnorm(x, torch.zeros(1536, device="cuda"))
    torch.cuda.synchronize()
    print(f"[build] nvcc (2 sources in parallel) {t_nvcc:.2f}s; Triton rmsnorm "
          f"first compile+launch {time.monotonic() - t0 - t_nvcc:.2f}s")
    for src in ("paged_flash_decode", "flash_attention"):
        for kernel, regs, spills in ptxas_summary(build.build_log(src)):
            print(f"[build] {src}: {kernel} {regs} registers, {spills}")

    # phase 3
    rows = check_kernels(torch)
    # phase 4
    counts, main_metrics = serve_main_path(torch, card)
    # phase 5
    card_vs_cpu(torch)

    # phase 6
    kernels = [dict(name=k, **{key: rows[k][key] for key in (
        "route", "source", "replaces")}, launches=counts[k],
        **{key: rows[k][key] for key in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")})
        for k in ("paged_flash_decode", "flash_attention", "rmsnorm")]
    print(json.dumps({"main_path": main_metrics, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
