"""Runtime implementation switches (port of ``src/repro/models/flags.py``).

* ``moe_impl`` — ``"dense"`` (every expert on every token, mixed by the
  gates; the default, as in the JAX package) or ``"dispatch"``
  (capacity-based scatter dispatch), from ``REPRO_MOE_IMPL``;
* ``remat`` — how the full-sequence forward keeps its activations for the
  backward, from ``REPRO_REMAT`` with the reference's default ``"full"``:
  ``"full"`` recomputes each layer unit in the backward, ``"dots"`` keeps
  the outputs of the matrix products without batch dimensions and
  recomputes the rest, ``"none"`` keeps every activation
  (:func:`repro_torch.models.lm.forward`);
* the sharded routes ``ep_shard`` and ``paged_shard``.

The reference's ``attn_impl``, ``q_chunk`` and ``attn_scores`` choose how
its jnp attention lowers; the port's attention is its kernels, so they have
no counterpart.  Its ``act_shard`` places the activations of a step that
XLA partitions; the port's model places nothing, so the dry run only
records the value (:func:`repro_torch.distributed.sharding.activation_shard_flags`).  JAX reads its flags when a step is traced; the port runs
eagerly and reads them on every call.
"""
from __future__ import annotations

import contextlib
import os

_FLAGS = {
    # "dense"   : compute-all-experts weighted mix (baseline)
    # "dispatch": capacity-based scatter dispatch (optimized)
    "moe_impl": os.environ.get("REPRO_MOE_IMPL", "dense"),
    # remat policy of the layer units: "full" | "dots" | "none"
    "remat": os.environ.get("REPRO_REMAT", "full"),
    # expert-parallel MoE routing: None or {"mesh": repro_torch Mesh,
    # "axis": str} — when set, the MoE FFN runs
    # distributed.expert_parallel.ep_moe_mix with the expert axis split over
    # the mesh's `axis` devices (dense-mix semantics)
    "ep_shard": None,
    # head-sharded paged decode: None or {"mesh": Mesh, "axis": str} — when
    # set, a paged decode step runs sharded_paged_flash_decode, each shard of
    # `axis` decoding its own KV-head slice of the pool (pages replicated)
    "paged_shard": None,
}


def get_flag(name: str):
    return _FLAGS[name]


def set_flag(name: str, value) -> None:
    if name not in _FLAGS:
        raise KeyError(name)
    _FLAGS[name] = value


@contextlib.contextmanager
def scoped(**kw):
    """Temporarily override flags for the duration of a ``with`` block."""
    saved = {k: _FLAGS[k] for k in kw}
    for k, v in kw.items():
        set_flag(k, v)
    try:
        yield
    finally:
        _FLAGS.update(saved)
