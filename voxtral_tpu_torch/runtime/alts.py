"""Host-side tail of the alt-token selection: a copy of
`voxtral_tpu/runtime/alts.py`.

The device step emits, per decoded token, the top-k candidates over the
alt-masked logits (models/decoder.py:alt_candidates — exact equivalent of
the reference's full-vocab softmax scan, voxtral.c:955-1010) plus the
emitted token's own logit. This module applies the reference's cutoff walk:
accept candidates in descending probability while 1 - p_i/p_best <= cutoff,
stop at the first failure, cap at n_alt - 1 alternatives.

p_i / p_best == exp(l_i - l_best) exactly, so no softmax is materialized.
"""

from __future__ import annotations

import math


def select_alts(best_logit: float, vals, idxs, n_alt: int,
                cutoff: float) -> list[int]:
    """Token ids of the qualifying alternatives, in the reference's order.

    vals/idxs: descending top-(>= n_alt-1) masked logits/ids from
    alt_candidates (a -inf val means candidates ran out — break, like the
    reference's best_idx < 0)."""
    out: list[int] = []
    best = float(best_logit)
    for v, j in zip(vals, idxs):
        if len(out) >= n_alt - 1:
            break
        v = float(v)
        if math.isinf(v):
            break                    # no real candidates left
        r = 1.0 - math.exp(v - best)
        if r > cutoff:
            break
        out.append(int(j))
    return out
