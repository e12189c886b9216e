"""Shape-only dry run of every (architecture × input shape) cell on the
production meshes (port of ``src/repro/launch/dryrun.py``).

``python -m repro_torch.launch.dryrun [--arch A,B|all] [--shape S|all]
[--mesh single|multi|both] [--moe-impl dense|dispatch]
[--remat full|dots|none] [--replicate-batch] [--tag T] [--force]
[--out DIR]`` writes one JSON record per cell into ``DIR`` (default
``build/dryrun_torch/``, git-ignored).

Everything is built on ``meta`` tensors over a mesh of placeholder devices:
the step's inputs (:func:`repro_torch.models.zoo.input_specs`), their
placements (:func:`repro_torch.distributed.sharding.step_shardings`) and
each device's shard of them.  No weight is allocated and no device is
touched, so the run is the same on the CPU and on the card.

The reference lowers and compiles each cell and reads XLA's memory and cost
analyses.  The port runs eagerly and lowers to no HLO, so a record's
roofline takes the model's useful FLOPs (:func:`model_flops`) over the
devices as its FLOPs (``flops_per_device``, ``flops_source: "model"``) and
each device's argument bytes as its HBM bytes (``bytes_per_device``,
``bytes_source: "arguments"``), at the H100's datasheet peaks
(:class:`repro_torch.distributed.hlo_analysis.RooflineTerms`).  With no
executed FLOPs to divide by, ``useful_flops_ratio`` and
``roofline_fraction`` are null, as are ``temp_bytes`` and
``collective_bytes``, each with its reason.  A train cell also records
``working_copy_bytes``: the bf16 weights the port's trainer keeps beside
its f32 masters.  ``--moe-impl`` and ``--remat`` set the flags for the run
and label its records; no number of a shape-only record depends on them.
The reference's ``--q-chunk`` and ``--attn-scores`` choose the lowering of
its jnp attention and have no counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.hlo_analysis import RooflineTerms
from repro_torch.distributed.sharding import (ShardingFallback, activation_shard_flags,
                                              make_policy, param_pspecs, shard_bytes,
                                              step_shardings)
from repro_torch.launch.mesh import LogicalDevice, Mesh, make_production_mesh
from repro_torch.models import flags, zoo

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
NO_TEMP = ("nothing is compiled: the port runs its steps eagerly, so no "
           "compiler reports temporaries")
NO_COLLECTIVE = ("no HLO to read collectives from, and the card runs alone: "
                 "no interconnect to model")
NO_RATIO = ("the FLOPs are the model's, not executed ones: nothing is "
            "compiled to count what a step runs")
ARGS = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
        "decode": ("params", "cache", "tokens", "positions")}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful whole-step FLOPs: 6·N·D train, 2·N·D forward (MoE: N_active)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def one_device_mesh() -> Mesh:
    """A (data 1, model 1) mesh of one placeholder device."""
    return Mesh(np.array([LogicalDevice(0, None)], dtype=object).reshape(1, 1),
                ("data", "model"))


def _output_specs(cfg: ModelConfig, shape: ShapeSpec, specs: Dict[str, Any]):
    """The step's outputs as meta tensors, matching ``step_shardings``' out
    tree: train (loss, params, opt_state), prefill the last-token f32
    logits, decode (next tokens, cache)."""
    if shape.kind == "train":
        return (torch.empty((), dtype=torch.float32, device="meta"),
                specs["params"], specs["opt_state"])
    B = shape.global_batch
    if shape.kind == "prefill":
        return torch.empty((B, cfg.vocab_size), dtype=torch.float32, device="meta")
    return (torch.empty((B,), dtype=torch.int32, device="meta"), specs["cache"])


def working_copy_bytes(cfg: ModelConfig, pol, mesh: Mesh) -> int:
    """Per device: the port's model weights that are not f32 (the working
    copy its trainer keeps beside the f32 masters), placed as the
    parameters are."""
    stored = zoo.stored_param_specs(cfg)
    specs = param_pspecs(cfg, pol, stored)

    def walk(node, spec):
        if isinstance(node, torch.Tensor):
            return 0 if node.dtype == torch.float32 else shard_bytes(mesh, node, spec)
        return sum(walk(node[k], spec[k]) for k in node)
    return walk(stored, specs)


def cell_record(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, name: str,
                replicate_batch: bool = False, arch: Optional[str] = None
                ) -> Dict[str, Any]:
    """The record of one cell on ``mesh`` (called ``name``)."""
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch or cfg.name, "shape": shape.name, "mesh": name,
                           "moe_impl": flags.get_flag("moe_impl"),
                           "remat": flags.get_flag("remat"),
                           "status": "skipped", "skip_reason": why}
    if not ok:
        return rec
    t0 = time.time()
    pol = make_policy(mesh, cfg)
    if replicate_batch:
        pol = dataclasses.replace(pol, replicate_batch=True)
    s_act = shape.seq_len if shape.kind != "decode" else 1
    act = activation_shard_flags(pol, shape.global_batch, s_act)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ShardingFallback)
        specs = zoo.input_specs(cfg, shape)
        in_sh, out_sh = step_shardings(cfg, shape, pol, specs)
        args = tuple(specs[k] for k in ARGS[shape.kind])
        arg_bytes = shard_bytes(mesh, args, in_sh)
        out_bytes = shard_bytes(mesh, _output_specs(cfg, shape, specs), out_sh)
        copy_bytes = (working_copy_bytes(cfg, pol, mesh) if shape.kind == "train"
                      else None)
    n, flops = mesh.size, model_flops(cfg, shape)
    terms = RooflineTerms(hlo_flops=flops / n, hlo_bytes=arg_bytes, collective_bytes=0.0,
                          n_chips=n, model_flops=flops)
    roof = {"model_flops": flops, "flops_per_device": flops / n, "flops_source": "model",
            "bytes_per_device": arg_bytes, "bytes_source": "arguments",
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": None, "dominant": terms.dominant,
            "useful_flops_ratio": None, "roofline_fraction": None,
            "ratio_reason": NO_RATIO, "n_chips": n,
            "peak_flops": terms.peak_flops, "hbm_bw": terms.hbm_bw}
    memory: Dict[str, Any] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                              "temp_bytes": None, "temp_bytes_reason": NO_TEMP}
    if copy_bytes is not None:
        memory["working_copy_bytes"] = copy_bytes
    rec.update({
        "status": "ok", "sharding_mode": pol.mode, "replicate_batch": replicate_batch,
        "act_shard": act, "n_chips": n, "build_s": round(time.time() - t0, 3),
        "memory": memory,
        "collectives": {"collective_bytes": None, "reason": NO_COLLECTIVE},
        "roofline": roof,
    })
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             replicate_batch: bool = False) -> Dict[str, Any]:
    """One cell on the production mesh (16 × 16, or 2 × 16 × 16)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = cell_record(get_config(arch), SHAPES[shape_name], mesh, mesh_name(multi_pod),
                      replicate_batch, arch)
    if verbose and rec["status"] == "ok":
        m, r = rec["memory"], rec["roofline"]
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: "
              f"args/dev={m['argument_bytes'] / 2 ** 30:.2f}GiB "
              f"out/dev={m['output_bytes'] / 2 ** 30:.2f}GiB "
              f"flops/dev={r['flops_per_device']:.3e} (model) dominant={r['dominant']} "
              f"mode={rec['sharding_mode']}")
    elif verbose:
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: skipped "
              f"({rec['skip_reason']})")
    return rec


def cell_path(out: Path, arch: str, shape_name: str, mesh: str, tag: str = "") -> Path:
    suffix = f"__{tag}" if tag else ""
    return Path(out) / f"{arch}__{shape_name}__{mesh}{suffix}.json"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="shape-only dry run of the port's cells")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--moe-impl", default=None, choices=[None, "dense", "dispatch"])
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots", "none"])
    ap.add_argument("--replicate-batch", action="store_true",
                    help="decode-2D-TP: replicate the decode batch")
    ap.add_argument("--tag", default="", help="record filename suffix")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records (default build/dryrun_torch)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    chosen = {k: v for k, v in (("moe_impl", args.moe_impl), ("remat", args.remat)) if v}
    with flags.scoped(**chosen):
        return _run(args)


def _run(args) -> int:
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                path = cell_path(out, arch, shape_name, mesh_name(multi_pod), args.tag)
                if path.exists() and not args.force:
                    print(f"[dryrun] cached: {path.name}")
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi_pod,
                                   replicate_batch=args.replicate_batch)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures.append((arch, shape_name, mesh_name(multi_pod)))
                path.write_text(json.dumps(rec, indent=2))
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print(f"[dryrun] all requested cells done: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
