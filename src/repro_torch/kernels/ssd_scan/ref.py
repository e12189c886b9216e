"""Plain PyTorch Mamba-2 SSD chunked scan (port of
``src/repro/kernels/ssd_scan/ref.py``, which delegates to
``src/repro/models/ssd.py::ssd_chunked``).

The specification the CUDA kernel is held to, and what the op runs for
tensors on the CPU.  Unlike the Pallas kernel it takes an initial state and
returns the final state, as ``ssd_chunked(initial_state=…)`` does: chunked
prefill continues a slot's recurrent state from one dispatch to the next.
All arithmetic is f32; y and the final state come back in x's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p); dt (b, s, h); A (h,) negative decay rates; B, C
    (b, s, 1, n); initial_state (b, h, p, n) or None (zeros).  ``s`` must
    be a multiple of ``chunk``.  Returns y (b, s, h, p) and the final state
    (b, h, p, n)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk <= 0 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    dtf = dt.float()
    xd = x.float() * dtf[..., None]                        # dt-weighted input
    dA = dtf * A.float()[None, None, :]                    # (b, s, h), negative
    xc = xd.reshape(b, nc, chunk, h, p)
    Bc = B.float()[:, :, 0].reshape(b, nc, chunk, n)
    Cc = C.float()[:, :, 0].reshape(b, nc, chunk, n)
    cum = torch.cumsum(dA.reshape(b, nc, chunk, h), dim=2)  # (b, c, l, h)

    # 1. intra-chunk: L[l, m] = exp(cum_l − cum_m) for l ≥ m, else 0
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b, c, l, m, h)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~tri[:, :, None], float("-inf")))
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    y_diag = torch.einsum("bclm,bclmh,bcmhp->bclhp", scores, Lmat, xc)

    # 2. per-chunk end states
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (b, c, l, h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence, seeded with the carried state
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b, c, h)
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b, c, h, p, n)

    # 4. carried state -> output
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), st.to(x.dtype)
