"""Parameter initialisation (port of ``repro/models/params.py:52-76``).

Only the init rule is ported: a truncated normal on [-2, 2] times
``fan_in ** -0.5`` (or an explicit ``scale``), drawn in float32 from an
explicit ``torch.Generator`` on the tensor's device and cast to the
parameter's dtype. The reference's ``Boxed`` leaves carry their logical
axis names; the port keeps them in a table beside the model
(``models/transformer.param_axes``). The draws differ
from ``jax.random``'s for the same seed; the tests carry the reference's
weights across with ``repro_torch.convert.lm_params_from_numpy``.
"""
from __future__ import annotations

from typing import Optional

import torch


@torch.no_grad()
def winit_(
    p: torch.Tensor, generator: torch.Generator, scale: Optional[float] = None
) -> torch.Tensor:
    """Fill ``p`` in place with the reference's truncated-normal weight."""
    fan_in = p.shape[0] if p.ndim > 1 else p.shape[-1]
    s = scale if scale is not None else fan_in**-0.5
    w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p.copy_(w.mul_(s))
    return p
