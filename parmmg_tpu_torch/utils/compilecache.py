"""Shape bucketing (the port's copy of ``bucket`` from the JAX package's
``utils/compilecache.py``, its geometric ladder only; the compile ledger
and governor are not ported).  The narrow-cycle row budget
(``ops/active.narrow_rows``) rounds through it, so the sub-mesh widths
follow the same ladder as the JAX package's."""
from __future__ import annotations


def bucket(n: int, floor: int = 256, cap: int | None = None) -> int:
    """Round ``n`` up the geometric 1.5x ladder from ``floor``
    (``b -> 3b//2 + 1``).  ``cap`` clamps the result, which may then be
    smaller than ``n``."""
    n = max(int(n), 1)
    b = max(int(floor), 1)
    while b < n:
        b = b * 3 // 2 + 1
    if cap is not None:
        b = min(b, int(cap))
    return b
