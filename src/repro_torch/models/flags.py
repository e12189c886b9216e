"""Runtime implementation switches (port of ``src/repro/models/flags.py``).

Only the subset the port reads: ``moe_impl`` — ``"dense"`` (every expert on
every token, mixed by the gates; the default, as in the JAX package) or
``"dispatch"`` (capacity-based scatter dispatch) — with the same
environment variable, ``REPRO_MOE_IMPL``.  JAX reads its flags when a step
is traced; the port runs eagerly and reads them on every call.
"""
from __future__ import annotations

import contextlib
import os

_FLAGS = {
    # "dense"   : compute-all-experts weighted mix (baseline)
    # "dispatch": capacity-based scatter dispatch (optimized)
    "moe_impl": os.environ.get("REPRO_MOE_IMPL", "dense"),
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
