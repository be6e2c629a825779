"""State carried across from the JAX package.

The port's counterpart of loading weights: the JAX package's ``Curves`` and
``FpnState`` (taken out as numpy arrays, e.g. ``np.asarray(field)``) become
the port's on an explicit device, and back.  Only numpy crosses the
boundary, so neither package imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .params import Curves, FpnState


def curves_from_numpy(fields: Dict[str, Optional[np.ndarray]], device) -> Curves:
    """Curves field name -> array (or None) to the port's Curves, every
    array a tensor on ``device``."""
    names = {f.name for f in dataclasses.fields(Curves)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"not Curves fields: {sorted(unknown)}")
    return Curves(**{name: None if arr is None else torch.tensor(np.asarray(arr), device=device)
                     for name, arr in fields.items()})


def fpn_state_from_numpy(mean_line: np.ndarray, determined: bool, device) -> FpnState:
    """A planar (2, half) mean line and its flag to the port's FpnState."""
    mean = np.ascontiguousarray(mean_line, dtype=np.float32)
    if mean.ndim != 2 or mean.shape[0] != 2:
        raise ValueError(f"mean_line must be planar (2, half), got {mean.shape}")
    return FpnState(mean_line=torch.tensor(mean, device=device), determined=bool(determined))


def to_numpy(obj):
    """Port state back to numpy: a tensor -> array; Curves -> dict of
    arrays (None kept; ``depth_parts``, ``prep_parts`` and
    ``depth_concat_parts`` left out, as they are derived from ``depth_op_*``
    and ``prep_operator``); FpnState -> (mean_line, determined)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    if isinstance(obj, FpnState):
        return to_numpy(obj.mean_line), bool(obj.determined)
    if isinstance(obj, Curves):
        out = {}
        for f in dataclasses.fields(Curves):
            if f.name in ("depth_parts", "prep_parts", "depth_concat_parts"):
                continue
            v = getattr(obj, f.name)
            out[f.name] = None if v is None else to_numpy(v) \
                if isinstance(v, torch.Tensor) else np.asarray(v)
        return out
    raise TypeError(f"no numpy form for {type(obj).__name__}")
