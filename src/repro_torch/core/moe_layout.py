"""MoE expert-weight layout conversion: device-major PGL <-> logical — the
twin of ``repro/core/moe_layout.py``, in numpy.

Device-major layout over a model axis of size M with ep·tp_ff = M:
  w1/w3: (M, E_loc, d, ff_loc)   rank r -> experts [(r//tp_ff)·E_loc, ...),
  w2:    (M, E_loc, ff_loc, d)          ff slice (r % tp_ff)·ff_loc.
Logical layout: (E, d, ff) / (E, ff, d).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.moe import ep_tp_split


def dm_to_logical(w: np.ndarray, n_experts: int, *, w2: bool = False):
    """(M, E_loc, A, B) -> logical (E, d, ff) [or (E, ff, d) if w2]."""
    m, e_loc = w.shape[0], w.shape[1]
    ep, tp_ff = ep_tp_split(n_experts, m)
    if e_loc != n_experts // ep:
        raise ValueError(f"{w.shape} is not a device-major layout of "
                         f"{n_experts} experts")
    if not w2:  # (M, E_loc, d, ff_loc)
        d, ff_loc = w.shape[2], w.shape[3]
        x = w.reshape(ep, tp_ff, e_loc, d, ff_loc)
        x = np.transpose(x, (0, 2, 3, 1, 4))          # (ep,E_loc,d,tp,ff_loc)
        return x.reshape(n_experts, d, tp_ff * ff_loc)
    ff_loc, d = w.shape[2], w.shape[3]
    x = w.reshape(ep, tp_ff, e_loc, ff_loc, d)
    x = np.transpose(x, (0, 2, 1, 3, 4))              # (ep,E_loc,tp,ff_loc,d)
    return x.reshape(n_experts, tp_ff * ff_loc, d)


def logical_to_dm(w: np.ndarray, model_size: int, *, w2: bool = False):
    """logical (E, d, ff) [or (E, ff, d)] -> (M, E_loc, ...)."""
    e = w.shape[0]
    ep, tp_ff = ep_tp_split(e, model_size)
    e_loc = e // ep
    if not w2:
        d, ff = w.shape[1], w.shape[2]
        ff_loc = ff // tp_ff
        x = w.reshape(ep, e_loc, d, tp_ff, ff_loc)
        x = np.transpose(x, (0, 3, 1, 2, 4))          # (ep,tp,E_loc,d,ff_loc)
        return x.reshape(model_size, e_loc, d, ff_loc)
    ff, d = w.shape[1], w.shape[2]
    ff_loc = ff // tp_ff
    x = w.reshape(ep, e_loc, tp_ff, ff_loc, d)
    x = np.transpose(x, (0, 2, 1, 3, 4))              # (ep,tp,E_loc,ff_loc,d)
    return x.reshape(model_size, e_loc, ff_loc, d)
