"""Sharded-execution parity driver (port of ``src/repro/launch/sharded_check.py``).

Runs in process on a set of logical devices (8 on ``--device``; the
reference forces 8 XLA host devices instead, which the port does not need).
Every check is token-identical in float32 against a plain single-device
engine, the reference's checks one for one:

  1. dense Megatron-TP replicas (qwen2-1.5b, tp 2 and dp 2 × tp 2);
  2. expert parallel (mixtral-8x7b, tp 2 → EP over 2 experts per shard);
  3. live migration of an in-flight request between replicas of different
     TP degree (tp 2 → tp 4 and tp 2 → unsharded) mid-decode;
  4. pool failover where salvage lands on a survivor of another TP degree;
  5. the pipeline ladder: pp 2, pp 2 × tp 2 on stage submeshes, a
     mid-decode re-cut pp 2 → pp 4, and pp → tp through the same wire format;
  6. fragment tolerance: a (1, 4) alloc across two 2-device islands, and a
     pp 2 × tp 2 replica built across them;
  7. the sharded paged ladder: tp 2 head-sharded paged decode against the
     contiguous cache, and tp 4 (KV heads 2 do not divide) with the recorded
     ``paged_kernel`` fallback;
  8. per-stage page pools: prefix hits under pp 2 with zero leaked pages,
     and paged migration tp 2 → tp 4 and pp 2 → plain, leak-free.

    PYTHONPATH=src python -m repro_torch.launch.sharded_check --device cpu

runs them at ``.reduced()`` size; ``--device cuda`` on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core.plan import Plan, ReplicaGroup, default_stage_cuts
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import logical_devices
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.pool import EnginePool
from repro_torch.serving.sharded import (PipelinedEngine, ShardedEngine,
                                         SubmeshAllocator, engine_for_group)

MAX_SEQ = 64
NEW_TOKENS = 8
N_DEVICES = 8


class Checks:
    """The checks over one device; ``alloc()`` is a fresh allocator over
    :data:`N_DEVICES` logical devices of it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._models: Dict[str, tuple] = {}

    def alloc(self) -> SubmeshAllocator:
        return SubmeshAllocator(logical_devices(N_DEVICES, self.device))

    def setup(self, arch: str):
        if arch not in self._models:
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
            gen = torch.Generator(device=self.device).manual_seed(0)
            self._models[arch] = (cfg, lm.init_params(cfg, gen, self.device))
        return self._models[arch]

    def engine(self, arch: str, **kw) -> Engine:
        cfg, model = self.setup(arch)
        return Engine(cfg, model, device=self.device, **kw)


def _prompts(cfg, n: int = 3, length: int = 12) -> List[List[int]]:
    v = cfg.vocab_size
    return [[(17 * i + 3 * j) % (v - 1) + 1 for j in range(length)] for i in range(n)]


def _drain(eng: Engine, prompts: Sequence[Sequence[int]]) -> Dict[int, List[int]]:
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=NEW_TOKENS))
    return {d.request.rid: list(d.generated) for d in eng.run_until_drained()}


def _equal(got, ref, what: str) -> None:
    assert got == ref, f"{what}: tokens diverge\nref={ref}\ngot={got}"


def check_parity(c: Checks, arch: str, shape=(1, 2)) -> None:
    cfg, model = c.setup(arch)
    prompts = _prompts(cfg)
    ref = _drain(c.engine(arch, n_slots=2, max_seq_len=MAX_SEQ), prompts)
    alloc = c.alloc()
    eng = ShardedEngine(cfg, model, alloc.alloc(shape), allocator=alloc,
                        n_slots=2, max_seq_len=MAX_SEQ)
    if cfg.n_experts:
        assert eng.sharding_policy.ep, "moe config should pick expert parallel"
    _equal(_drain(eng, prompts), ref, f"{arch} {shape}")
    eng.release_devices()
    assert alloc.free_devices == alloc.total_devices, "submesh leaked"
    print(f"PASS parity {arch} submesh={shape}")


def _head_then_rest(src: Engine, dst_fn, prompt, ref, what: str) -> None:
    """Prefill + a few decode steps on ``src``, export mid-flight, install
    into ``dst_fn()``, finish: the whole sequence must equal ``ref``."""
    src.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=NEW_TOKENS))
    for _ in range(3):
        src.step()
    assert src.active, "request finished before the migration point"
    (slot,) = src.active
    head = list(src.active[slot].generated)
    export = src.export_slot(slot)
    assert src.release_all_pages() == 0, "source leaked pages"
    src.release_devices()
    dst = dst_fn()
    assert dst.install_active(export), "install_active refused the slot"
    full = list(dst.run_until_drained()[0].generated)
    assert full[:len(head)] == head and full == ref, (
        f"{what}: tokens diverge\nref={ref}\ngot={full}")
    assert dst.release_all_pages() == 0, "destination leaked pages"
    dst.release_devices()


def check_cross_tp_migration(c: Checks, arch: str) -> None:
    cfg, model = c.setup(arch)
    prompt = _prompts(cfg, n=1, length=10)[0]
    ref = _drain(c.engine(arch, n_slots=1, max_seq_len=MAX_SEQ), [prompt])[0]
    for dst_kind in ("sharded", "plain"):
        alloc = c.alloc()
        src = ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc,
                            n_slots=1, max_seq_len=MAX_SEQ)
        dst_fn = ((lambda: ShardedEngine(cfg, model, alloc.alloc((1, 4)), allocator=alloc,
                                         n_slots=1, max_seq_len=MAX_SEQ))
                  if dst_kind == "sharded" else
                  (lambda: c.engine(arch, n_slots=1, max_seq_len=MAX_SEQ)))
        _head_then_rest(src, dst_fn, prompt, ref, f"{arch} migration ->{dst_kind}")
        assert alloc.free_devices == alloc.total_devices, "submesh leaked"
        print(f"PASS migration {arch} (1, 2)->{'(1, 4)' if dst_kind == 'sharded' else 'unsharded'}")


def check_pool_failover(c: Checks, arch: str) -> None:
    """Killing the tp 2 replica of a mixed pool frees its submesh and
    salvages the in-flight request onto the tp 1 survivor."""
    cfg, model = c.setup(arch)
    alloc = c.alloc()
    pool = EnginePool(lambda g: engine_for_group(cfg, model, g, alloc, n_slots=2,
                                                 max_seq_len=MAX_SEQ, device=c.device),
                      max_replicas_per_group=1)
    g_tp2 = ReplicaGroup("m", "H100-80G", 2, 2, 1)
    g_tp1 = ReplicaGroup("m", "H100-80G", 1, 2, 1)
    pool.reconfigure(Plan((g_tp2, g_tp1)))
    (victim,) = pool._replicas[g_tp2]
    assert isinstance(victim, ShardedEngine), "tp=2 group should shard"
    free_before = alloc.free_devices
    prompt = _prompts(cfg, n=1, length=10)[0]
    ref = _drain(c.engine(arch, n_slots=1, max_seq_len=MAX_SEQ), [prompt])[0]
    victim.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=NEW_TOKENS))
    for _ in range(3):
        victim.step()
    head = list(victim.active[min(victim.active)].generated)
    report = pool.fail(victim, reason="injected")
    assert report.salvaged == 1, f"expected salvage, got {report}"
    assert alloc.free_devices == free_before + 2, "dead replica's submesh was not freed"
    full = list(pool.run_until_drained()[-1].generated)
    assert full[:len(head)] == head and full == ref, (
        f"failover tokens diverge\nref={ref}\ngot={full}")
    print(f"PASS pool failover {arch} (tp=2 death -> tp=1 salvage)")


def check_pipeline_parity(c: Checks, arch: str, pp: int = 2, tp: int = 1) -> None:
    cfg, model = c.setup(arch)
    prompts = _prompts(cfg)
    ref = _drain(c.engine(arch, n_slots=2, max_seq_len=MAX_SEQ), prompts)
    alloc = c.alloc()
    eng = PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, pp),
                          stage_meshes=alloc.alloc_stages(pp, (1, tp)), allocator=alloc,
                          n_slots=2, max_seq_len=MAX_SEQ)
    _equal(_drain(eng, prompts), ref, f"{arch} pp={pp} tp={tp}")
    eng.release_devices()
    assert alloc.free_devices == alloc.total_devices, "stage submesh leaked"
    print(f"PASS pipeline parity {arch} pp={pp} tp={tp}")


def check_stage_recut(c: Checks, arch: str) -> None:
    """A request decoding on pp 2 resumes on pp 4 (re-cut) and on tp 2."""
    cfg, model = c.setup(arch)
    prompt = _prompts(cfg, n=1, length=10)[0]
    ref = _drain(c.engine(arch, n_slots=1, max_seq_len=MAX_SEQ), [prompt])[0]
    for dst_kind in ("recut", "tp"):
        alloc = c.alloc()
        src = PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, 2),
                              stage_meshes=alloc.alloc_stages(2, (1, 2)),
                              allocator=alloc, n_slots=1, max_seq_len=MAX_SEQ)
        dst_fn = ((lambda: PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, 4),
                                           stage_meshes=alloc.alloc_stages(4, (1, 2)),
                                           allocator=alloc, n_slots=1, max_seq_len=MAX_SEQ))
                  if dst_kind == "recut" else
                  (lambda: ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc,
                                         n_slots=1, max_seq_len=MAX_SEQ)))
        _head_then_rest(src, dst_fn, prompt, ref, f"{arch} {dst_kind}")
        assert alloc.free_devices == alloc.total_devices, "submesh leaked"
        print(f"PASS stage re-cut {arch} pp=2->{'pp=4' if dst_kind == 'recut' else 'tp=2'}")


def check_fragmented_alloc(c: Checks, arch: str) -> None:
    cfg, model = c.setup(arch)
    prompts = _prompts(cfg)
    ref = _drain(c.engine(arch, n_slots=2, max_seq_len=MAX_SEQ), prompts)
    alloc = c.alloc()
    holds = [alloc.alloc((1, 2)) for _ in range(4)]
    alloc.release(holds[1])
    alloc.release(holds[3])
    frags = [len(f) for f in alloc.fragments()]
    assert frags == [2, 2], f"expected two 2-device islands, got {frags}"
    span = alloc.try_alloc((1, 4))
    assert span is not None, "spurious SubmeshOversubscribed on fragments"
    alloc.release(span)
    meshes = alloc.try_alloc_stages(2, (1, 2))
    assert meshes is not None
    ids = [sorted(d.id for d in m.devices.flatten()) for m in meshes]
    assert ids[0] != ids[1], "stages should land on distinct islands"
    eng = PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, 2),
                          stage_meshes=meshes, allocator=alloc, n_slots=2,
                          max_seq_len=MAX_SEQ)
    _equal(_drain(eng, prompts), ref, "fragmented pp replica")
    eng.release_devices()
    alloc.release(holds[0])
    alloc.release(holds[2])
    assert alloc.free_devices == alloc.total_devices, "submesh leaked"
    print(f"PASS fragmented alloc {arch} (islands={frags})")


def check_sharded_paged_kernel(c: Checks, arch: str) -> None:
    """tp 2 serves from the head-sharded pool with the paged decode per
    shard, token-identical to the contiguous cache; at tp 4 the 2 KV heads
    do not divide, the pool replicates and the fallback is recorded."""
    cfg, model = c.setup(arch)
    prompts = _prompts(cfg)
    kw = dict(n_slots=2, max_seq_len=MAX_SEQ)
    ref = _drain(c.engine(arch, paged=False, **kw), prompts)
    alloc = c.alloc()
    fused = ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc, **kw)
    assert fused.paged and fused.paged_kernel_fused and fused._paged_shard_flag is not None
    _equal(_drain(fused, prompts), ref, f"{arch} tp=2 head-sharded paged")
    fused.release_devices()
    contig = ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc,
                           paged=False, **kw)
    _equal(_drain(contig, prompts), ref, f"{arch} tp=2 contiguous")
    contig.release_devices()
    print(f"PASS sharded paged kernel {arch} tp=2 (paged == contiguous)")
    wide = ShardedEngine(cfg, model, alloc.alloc((1, 4)), allocator=alloc, **kw)
    assert not wide.paged_kernel_fused, "kv heads don't divide tp=4"
    recs = [f for f in wide.decision.fallbacks if "paged_kernel" in f.path]
    assert recs and recs[0].axis_size == 4, \
        f"paged-kernel fallback not recorded: {wide.decision.fallbacks}"
    _equal(_drain(wide, prompts), ref, f"{arch} tp=4 replicated pool")
    wide.release_devices()
    assert alloc.free_devices == alloc.total_devices, "submesh leaked"
    print(f"PASS paged kernel fallback {arch} tp=4 (recorded, replicated pool)")


def check_pipelined_paged_prefix(c: Checks, arch: str, pp: int = 2) -> None:
    cfg, model = c.setup(arch)
    prompts = _prompts(cfg, n=2)
    shared = prompts[0][:8]
    prompts = [shared + p[8:] for p in prompts]          # page-aligned overlap
    ref = _drain(c.engine(arch, paged=False, n_slots=2, max_seq_len=MAX_SEQ), prompts)
    alloc = c.alloc()
    eng = PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, pp),
                          stage_meshes=alloc.alloc_stages(pp, (1, 2)), allocator=alloc,
                          n_slots=2, max_seq_len=MAX_SEQ, page_size=4)
    assert eng.paged, "pipelined engines default to the paged pool"
    _equal(_drain(eng, prompts), ref, f"{arch} pp={pp} paged")
    _equal(_drain(eng, prompts), ref, f"{arch} pp={pp} paged, second round")
    hits = eng.prefix_index.hits
    assert hits >= 1, "second round should hit the per-stage prefix tries"
    leaked = eng.release_all_pages()
    assert leaked == 0, f"{leaked} pages leaked from the staged pools"
    eng.release_devices()
    assert alloc.free_devices == alloc.total_devices, "stage submesh leaked"
    print(f"PASS pipelined paged prefix {arch} pp={pp} (hits={hits}, leaked=0)")


def check_paged_migration(c: Checks, arch: str) -> None:
    cfg, model = c.setup(arch)
    prompt = _prompts(cfg, n=1, length=10)[0]
    kw = dict(n_slots=1, max_seq_len=MAX_SEQ, page_size=4)
    ref = _drain(c.engine(arch, **kw), [prompt])[0]
    for label in ("tp2->tp4", "pp2->plain"):
        alloc = c.alloc()
        if label == "tp2->tp4":
            src = ShardedEngine(cfg, model, alloc.alloc((1, 2)), allocator=alloc, **kw)
            dst_fn = lambda: ShardedEngine(cfg, model, alloc.alloc((1, 4)),
                                           allocator=alloc, **kw)
        else:
            src = PipelinedEngine(cfg, model, default_stage_cuts(cfg.n_layers, 2),
                                  stage_meshes=alloc.alloc_stages(2, (1, 2)),
                                  allocator=alloc, **kw)
            dst_fn = lambda: c.engine(arch, **kw)
        assert src.paged
        _head_then_rest(src, dst_fn, prompt, ref, f"{arch} {label}")
        assert alloc.free_devices == alloc.total_devices, "submesh leaked"
    print(f"PASS paged migration {arch} tp2->tp4, pp2->plain (leaked=0)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device holding the logical devices (default: the card)")
    args = ap.parse_args(argv)
    c = Checks(resolve_device(args.device))
    check_parity(c, "qwen2-1.5b", (1, 2))
    check_parity(c, "qwen2-1.5b", (2, 2))          # TP×DP replica
    check_parity(c, "mixtral-8x7b", (1, 2))        # expert parallel
    check_cross_tp_migration(c, "qwen2-1.5b")
    check_pool_failover(c, "qwen2-1.5b")
    check_pipeline_parity(c, "qwen2-1.5b", pp=2, tp=1)
    check_pipeline_parity(c, "qwen2-1.5b", pp=2, tp=2)   # pp×tp = 2×2
    check_stage_recut(c, "qwen2-1.5b")
    check_fragmented_alloc(c, "qwen2-1.5b")
    check_sharded_paged_kernel(c, "qwen2-1.5b")
    check_pipelined_paged_prefix(c, "qwen2-1.5b", pp=2)
    check_paged_migration(c, "qwen2-1.5b")
    print("sharded_check: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
