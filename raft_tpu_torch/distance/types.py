"""Distance metric enumeration — mirrors ``distance/distance_types.hpp:23-67``.

Same names and integer values as the reference (and as the JAX
package), so serialized indexes carry the same metric ids.
``is_min_close`` reproduces ``distance_types.hpp:72-86``: for similarity
metrics (InnerProduct) nearest neighbors are the *largest* values.
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """All 20 metric identifiers of the reference (+ Precomputed)."""

    L2Expanded = 0          # sum(x^2) + sum(y^2) - 2 sum(x*y)   (squared L2)
    L2SqrtExpanded = 1      # sqrt of the above
    CosineExpanded = 2      # 1 - <x,y> / (|x| |y|)
    L1 = 3                  # sum |x - y|
    L2Unexpanded = 4        # sum (x - y)^2
    L2SqrtUnexpanded = 5    # sqrt of the above
    InnerProduct = 6        # <x,y>  (similarity: larger = closer)
    Linf = 7                # max |x - y|  (Chebyshev)
    Canberra = 8            # sum |x-y| / (|x| + |y|)
    LpUnexpanded = 9        # (sum |x-y|^p)^(1/p), p = metric_arg
    CorrelationExpanded = 10
    JaccardExpanded = 11    # 1 - ip / (|x|^2 + |y|^2 - ip)
    HellingerExpanded = 12  # sqrt(1 - sum sqrt(x*y))
    Haversine = 13          # great-circle distance over (lat, lon) pairs
    BrayCurtis = 14         # sum |x-y| / sum |x+y|
    JensenShannon = 15      # sqrt(0.5 (KL(x|m) + KL(y|m))), m = (x+y)/2
    HammingUnexpanded = 16  # mean(x_i != y_i)
    KLDivergence = 17       # sum x log(x/y)
    RusselRaoExpanded = 18  # (k - ip) / k  (binary data)
    DiceExpanded = 19       # 1 - 2 ip / (|x|^2 + |y|^2)
    Precomputed = 100


def is_min_close(metric: DistanceType) -> bool:
    """True if smaller distance means more similar (``distance_types.hpp:72``)."""
    return metric != DistanceType.InnerProduct


#: The metrics whose pairwise form is one product and an epilog (the
#: reference's "expanded" family, ``distance/detail/distance_ops/``).
EXPANDED_METRICS = frozenset({
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.CosineExpanded,
    DistanceType.InnerProduct,
    DistanceType.CorrelationExpanded,
    DistanceType.JaccardExpanded,
    DistanceType.HellingerExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.DiceExpanded,
    DistanceType.KLDivergence,
})
