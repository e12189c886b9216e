"""The plain references against the program at cut-down widths on the CPU:
the program's full forward in float32 equals the reference's logits, the
program's served tokens (paged engine, chunked prefill, decode through the
cache, prefix hits) read no gap against it, and the float8 control reads a
wider gap than the program in bf16 does."""
import dataclasses

import pytest
import torch

import harness
import judge
import tiny
import weights

CELLS = ["mixtral.chat", "minicpm3.docqa"]


def program(c, dtype, seed):
    from repro_torch.models import lm
    cfg = dataclasses.replace(harness.family(c).program_config(c), dtype=dtype)
    model = lm.LM(cfg, device="cpu")
    weights.load_program(model, harness.family(c).param_groups(c), seed, "cpu")
    return cfg, model


@pytest.mark.parametrize("cell", CELLS)
def test_program_forward_equals_the_reference(cell):
    from repro_torch.models import lm
    c = tiny.config(cell)
    cfg, model = program(c, "float32", tiny.SEED)
    g = torch.Generator().manual_seed(1)
    seqs = [torch.randint(0, c["vocab_size"], (n,), generator=g).tolist() for n in (37, 20)]
    with torch.no_grad():
        got = [lm.forward(model, cfg, torch.tensor([s]))[0] for s in seqs]
    picked = [judge.Served(i, s[:1], s[1:] + [0]) for i, s in enumerate(seqs)]
    ref = judge.reference_logits(c, tiny.SEED, picked, "cpu")
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, atol=2e-5, rtol=1e-5), (a - b).abs().max()


def served(cell, seed, dtype="float32", seconds=tiny.SECONDS):
    """Requests the program's pool served at the cell's cut-down size."""
    c, mix = tiny.config(cell), {**harness.cell_files(cell)[2], **tiny.mix(cell)}
    from repro_torch.models import lm
    from repro_torch.serving.backend import TorchBackend
    import time
    cfg, model = program(c, dtype, seed)
    plan = mix["plan"]
    backend = TorchBackend(cfg, model, max_seq_len=plan["max_seq_len"], slots_cap=plan["batch"],
                           max_replicas_per_group=1, page_size=plan["page_size"], device="cpu")
    from repro_torch.core.plan import Plan, ReplicaGroup
    backend.apply_plan(Plan((ReplicaGroup(cfg.name, "H100-80G", tp=1, batch=plan["batch"],
                                          count=1),)), None)
    run = harness.new_run(c, mix, seconds)
    drv = harness.Stepper(backend, run)
    stream = harness.prepare(drv, run, seed, False)
    harness.serve(drv, run, seed, False, time.monotonic(), stream)
    return c, mix, run


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_of_the_f32_program_read_no_gap(cell):
    c, mix, run = served(cell, tiny.SEED)
    picked = judge.sample(harness.finished_in_window(run), tiny.SEED, 8, 10_000)
    assert picked and sum(len(s.tokens) for s in picked) >= 20
    if cell == "minicpm3.docqa":
        assert run.saved_tokens > 0            # prefix hits were served
    ref = judge.reference_logits(c, tiny.SEED, picked, "cpu")
    assert float(judge.served_gaps(ref, picked).max()) < 1e-4


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 3_000_000_001])
def test_float8_control_reads_wider_than_the_bf16_program(cell, seed):
    """The control at a size a test run holds: at every position of the same
    sequences, the float8 control's first token is judged by the float32
    reference, as is the bf16 program's (its full forward); the control's
    widest gap is the wider."""
    from repro_torch.models import lm
    c = tiny.config(cell)
    cfg, model = program(c, "bfloat16", seed)
    g = torch.Generator().manual_seed(seed % 1000)
    seqs = [torch.randint(0, c["vocab_size"], (64,), generator=g).tolist() for _ in range(4)]
    with torch.no_grad():
        prog = [lm.forward(model, cfg, torch.tensor([s]))[0].float() for s in seqs]
    picked = [judge.Served(i, s[:1], s[1:] + [0]) for i, s in enumerate(seqs)]
    ref = judge.reference_logits(c, seed, picked, "cpu")
    ctrl = judge.reference_logits(c, seed, picked, "cpu", control=True)
    number = judge.NUMBERS[harness.cell_files(cell)[3]["number"]]
    assert number(judge.control_gaps(ref, ctrl)) > 2 * number(judge.control_gaps(ref, prog))
