"""How ``correct`` is decided: after the window, a sample drawn from the seed
of the requests the program finished in it (the one with the most served
tokens always among them) is run through the plain float32 reference over
each prompt and its served tokens.  At each served position the gap is the
reference's best logit minus the reference's logit of the served token; the
number compared, named by the cell's check file (``servebench/checks/``), is
the widest gap or the mean gap over the sample.  The control puts the
reference, with its weights rounded to float8
(``reference.common.fp8_round``), in the program's place: at the same
positions it reads the gap of the token the control ranks first."""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Sequence

import torch

import traffic
import weights
from reference.common import f32_group, no_tf32

NUMBERS = {"widest_logit_gap": lambda g: float(g.max()),
           "mean_logit_gap": lambda g: float(g.mean())}


@dataclass
class Served:
    rid: int
    prompt: List[int]
    tokens: List[int]


def sample(done: Sequence[Served], seed: int, max_requests: int,
           max_tokens: int) -> List[Served]:
    """The longest finished request, then others in an order drawn from the
    seed, until ``max_requests`` or ``max_tokens`` served tokens."""
    if not done:
        return []
    done = sorted(done, key=lambda s: s.rid)
    first = max(done, key=lambda s: len(s.tokens))
    rest = [s for s in done if s is not first]
    order = traffic.rng_for(seed, 9).permutation(len(rest)) if rest else []
    out, n = [first], len(first.tokens)
    for i in order:
        if len(out) >= max_requests or n >= max_tokens:
            break
        out.append(rest[int(i)])
        n += len(rest[int(i)].tokens)
    return out


def reference_logits(c: dict, seed: int, picked: Sequence[Served], device,
                     control: bool = False) -> List[torch.Tensor]:
    """float32 logits (one row per served token) of the plain reference, or
    of the control with ``control``, drawing the weights again from the
    seed one group at a time."""
    no_tf32()
    fam = importlib.import_module(f"families.{c['model_type']}")
    ref = importlib.import_module(f"reference.{c['model_type']}")
    groups = fam.param_groups(c)
    get = f32_group(lambda gi: weights.draw_group(groups[gi], seed, gi, device), control)
    seqs = [s.prompt + s.tokens[:-1] for s in picked]
    want = [range(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.tokens)) for s in picked]
    with torch.no_grad():
        return ref.logits(c, get, seqs, want, device)


def gaps(ref: Sequence[torch.Tensor], tokens: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per position: reference best - reference logit of the given token."""
    return torch.cat([lg.max(dim=-1).values - lg.gather(1, t.to(lg.device)[:, None])[:, 0]
                      for lg, t in zip(ref, tokens)])


def served_gaps(ref: Sequence[torch.Tensor], picked: Sequence[Served]) -> torch.Tensor:
    return gaps(ref, [torch.as_tensor(s.tokens) for s in picked])


def control_gaps(ref: Sequence[torch.Tensor], ctrl: Sequence[torch.Tensor]) -> torch.Tensor:
    """The gaps of the tokens the control ranks first, judged by the
    reference."""
    return gaps(ref, [cl.argmax(dim=-1) for cl in ctrl])
