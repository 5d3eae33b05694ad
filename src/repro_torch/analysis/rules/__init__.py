"""The port's rule catalog (port of ``repro/analysis/rules``). Each rule
fossilises one shipped bug class (its ``bug`` attribute). The reference's
PB003 and PB008 key on JAX APIs with no torch counterpart and have no
twin (``rules/calls.py``)."""
from __future__ import annotations

from repro_torch.analysis.rules.calls import PB001HardcodedMethod, PB007UnattestedSortedClaim
from repro_torch.analysis.rules.hygiene import (
    PB004AssertBeforeEmptyGuard,
    PB005EqualityRemoveOnSinkList,
    PB006SilentBroadExcept,
)
from repro_torch.analysis.rules.timing import PB002NonMonotonicTime

ALL_RULES = (
    PB001HardcodedMethod,
    PB002NonMonotonicTime,
    PB004AssertBeforeEmptyGuard,
    PB005EqualityRemoveOnSinkList,
    PB006SilentBroadExcept,
    PB007UnattestedSortedClaim,
)

__all__ = ["ALL_RULES"] + [cls.__name__ for cls in ALL_RULES]
