"""ML evaluation metrics — port of ``raft_tpu/stats/metrics.py``
(reference ``stats/accuracy.cuh``, ``r2_score.cuh``, ``entropy.cuh``,
``kl_divergence.cuh``, ``contingency_matrix.cuh``, ``rand_index.cuh``,
``adjusted_rand_index.cuh``, ``mutual_info_score.cuh``,
``homogeneity_score.cuh``, ``completeness_score.cuh``, ``v_measure.cuh``,
``silhouette_score.cuh``, ``trustworthiness_score.cuh``,
``information_criterion.cuh``, ``dispersion.cuh``).

Clustering-comparison metrics all flow through one contingency-matrix
builder (a ``bincount`` of label pairs) the way the reference funnels
them through ``contingencyMatrix``; labels outside the class range count
nowhere, as the JAX package's one-hot rows of zeros. Silhouette and
trustworthiness take their distances from the port's
``distance.pairwise._pairwise_distance_impl`` at full float32.
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType

_EPS = 1e-12


def _put(res, x) -> torch.Tensor:
    return ensure_resources(res).put(x)


def accuracy(res: Optional[Resources], predictions, labels):
    """Fraction of exact matches — ``stats::accuracy``."""
    return torch.mean((_put(res, predictions) == _put(res, labels))
                      .to(torch.float32))


def r2_score(res: Optional[Resources], y, y_hat):
    """Coefficient of determination — ``stats::r2_score``."""
    y = _put(res, y).to(torch.float32)
    y_hat = _put(res, y_hat).to(torch.float32)
    ss_res = torch.sum((y - y_hat) ** 2)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=_EPS)


def _xlogx_guarded(p: torch.Tensor) -> torch.Tensor:
    return torch.where(p > 0, p * torch.log(torch.clamp(p, min=_EPS)),
                       torch.zeros_like(p))


def entropy(res: Optional[Resources], labels, n_classes: int):
    """Shannon entropy (nats) of a label set — ``stats::entropy``."""
    lab = _put(res, labels).to(torch.int64)
    ok = (lab >= 0) & (lab < n_classes)
    counts = torch.bincount(torch.where(ok, lab, n_classes),
                            minlength=n_classes + 1)[:n_classes]
    p = counts.to(torch.float32) / torch.clamp(torch.sum(counts), min=1)
    return -torch.sum(_xlogx_guarded(p))


def kl_divergence(res: Optional[Resources], p, q):
    """KL(p ‖ q) over two distributions — ``stats::kl_divergence``."""
    p = _put(res, p).to(torch.float32)
    q = _put(res, q).to(torch.float32)
    return torch.sum(torch.where(
        p > 0, p * torch.log(torch.clamp(p, min=_EPS)
                             / torch.clamp(q, min=_EPS)),
        torch.zeros_like(p)))


def contingency_matrix(
    res: Optional[Resources],
    labels_a,
    labels_b,
    n_classes_a: Optional[int] = None,
    n_classes_b: Optional[int] = None,
):
    """(n_classes_a, n_classes_b) co-occurrence counts, int32 —
    ``stats::contingencyMatrix``."""
    la = _put(res, labels_a).to(torch.int64)
    lb = _put(res, labels_b).to(torch.int64)
    na = n_classes_a if n_classes_a is not None else int(la.max()) + 1
    nb = n_classes_b if n_classes_b is not None else int(lb.max()) + 1
    ok = (la >= 0) & (la < na) & (lb >= 0) & (lb < nb)
    pair = torch.where(ok, la * nb + lb, na * nb)
    counts = torch.bincount(pair, minlength=na * nb + 1)[:na * nb]
    return counts.reshape(na, nb).to(torch.int32)


def _comb2(x):
    x = x.to(torch.float32)
    return x * (x - 1.0) / 2.0


def _pair_sums(res, labels_a, labels_b):
    cm = contingency_matrix(res, labels_a, labels_b).to(torch.float32)
    n = torch.sum(cm)
    sum_ij = torch.sum(_comb2(cm))
    sum_a = torch.sum(_comb2(torch.sum(cm, dim=1)))
    sum_b = torch.sum(_comb2(torch.sum(cm, dim=0)))
    return n, sum_ij, sum_a, sum_b


def rand_index(res: Optional[Resources], labels_a, labels_b):
    """Rand index — ``stats::rand_index``."""
    n, sum_ij, sum_a, sum_b = _pair_sums(res, labels_a, labels_b)
    total = _comb2(n)
    return (total + 2.0 * sum_ij - sum_a - sum_b) / torch.clamp(total,
                                                                min=_EPS)


def adjusted_rand_index(res: Optional[Resources], labels_a, labels_b):
    """Adjusted Rand index — ``stats::adjusted_rand_index``."""
    n, sum_ij, sum_a, sum_b = _pair_sums(res, labels_a, labels_b)
    total = torch.clamp(_comb2(n), min=_EPS)
    expected = sum_a * sum_b / total
    max_index = 0.5 * (sum_a + sum_b)
    return (sum_ij - expected) / torch.clamp(max_index - expected, min=_EPS)


def mutual_info_score(res: Optional[Resources], labels_a, labels_b):
    """Mutual information (nats) — ``stats::mutual_info_score``."""
    cm = contingency_matrix(res, labels_a, labels_b).to(torch.float32)
    n = torch.clamp(torch.sum(cm), min=1.0)
    p_ij = cm / n
    p_a = torch.sum(p_ij, dim=1, keepdim=True)
    p_b = torch.sum(p_ij, dim=0, keepdim=True)
    ratio = p_ij / torch.clamp(p_a * p_b, min=_EPS)
    return torch.sum(torch.where(
        p_ij > 0, p_ij * torch.log(torch.clamp(ratio, min=_EPS)),
        torch.zeros_like(p_ij)))


def homogeneity_score(res: Optional[Resources], labels_true, labels_pred,
                      n_classes: Optional[int] = None):
    """``stats::homogeneity_score``: 1 - H(C|K)/H(C)."""
    labels_true = _put(res, labels_true)
    nc = n_classes or int(labels_true.max()) + 1
    mi = mutual_info_score(res, labels_true, labels_pred)
    h_c = entropy(res, labels_true, nc)
    return torch.where(h_c > _EPS, mi / torch.clamp(h_c, min=_EPS),
                       torch.ones_like(mi))


def completeness_score(res: Optional[Resources], labels_true, labels_pred,
                       n_classes: Optional[int] = None):
    """``stats::completeness_score``: 1 - H(K|C)/H(K)."""
    labels_pred = _put(res, labels_pred)
    nk = n_classes or int(labels_pred.max()) + 1
    mi = mutual_info_score(res, labels_true, labels_pred)
    h_k = entropy(res, labels_pred, nk)
    return torch.where(h_k > _EPS, mi / torch.clamp(h_k, min=_EPS),
                       torch.ones_like(mi))


def v_measure(res: Optional[Resources], labels_true, labels_pred,
              beta: float = 1.0):
    """``stats::v_measure``: weighted harmonic mean of homogeneity and
    completeness."""
    h = homogeneity_score(res, labels_true, labels_pred)
    c = completeness_score(res, labels_true, labels_pred)
    return torch.where(h + c > _EPS,
                       (1 + beta) * h * c / torch.clamp(beta * h + c,
                                                        min=_EPS),
                       torch.zeros_like(h))


def silhouette_score(
    res: Optional[Resources],
    x,
    labels,
    n_clusters: Optional[int] = None,
    metric: DistanceType = DistanceType.L2SqrtExpanded,
    *,
    tile: int = 4096,
):
    """Mean silhouette coefficient — ``stats::silhouette_score`` (and its
    ``batched::`` variant: ``tile`` bounds the distance buffer at
    ``tile × n``, the reference's chunking knob).

    Per-sample mean distance to every cluster is one distance-tile ×
    one-hot product; a(i)/b(i) then come from the (tile, n_clusters)
    matrix.
    """
    from raft_tpu_torch.distance.pairwise import _pairwise_distance_impl

    res = ensure_resources(res)
    x = res.put(x)
    labels = res.put(labels).to(torch.int64)
    n = x.shape[0]
    k = n_clusters or int(labels.max()) + 1
    expect(k >= 2, "silhouette_score requires >= 2 clusters")
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
    counts = torch.sum(onehot, dim=0)                        # (k,)

    scores = []
    for start in range(0, n, tile):
        stop = min(start + tile, n)
        d = _pairwise_distance_impl(x[start:stop], x, metric, 2.0, "highest",
                                    res.workspace_limit_bytes)
        # sum distance from each row to every cluster: (t, n) @ (n, k)
        sums = d @ onehot
        lt = labels[start:stop]
        own = counts[lt]                                     # cluster sizes
        own_sum = torch.gather(sums, 1, lt[:, None])[:, 0]
        a = own_sum / torch.clamp(own - 1.0, min=1.0)        # excl. self
        other_mean = sums / torch.clamp(counts[None, :], min=1.0)
        other_mean = torch.where(onehot[start:stop] > 0, math.inf,
                                 other_mean)
        b = torch.amin(other_mean, dim=1)
        s = (b - a) / torch.clamp(torch.maximum(a, b), min=_EPS)
        s = torch.where(own <= 1.0, torch.zeros_like(s), s)  # singletons
        scores.append(s)
    return torch.mean(torch.cat(scores))


def trustworthiness(
    res: Optional[Resources],
    x,
    x_embedded,
    k: int,
    metric: DistanceType = DistanceType.L2SqrtExpanded,
):
    """Trustworthiness of an embedding — ``stats::trustworthiness_score``:
    penalizes embedded-space neighbors that are far in the original space
    by their original-space rank. Both orders are stable sorts (ties to
    the smaller index, as the JAX package's ``argsort`` and
    ``lax.top_k``)."""
    from raft_tpu_torch.distance.pairwise import _pairwise_distance_impl

    res = ensure_resources(res)
    x = res.put(x)
    xe = res.put(x_embedded)
    n = x.shape[0]
    expect(k < n / 2, "trustworthiness: k must be < n/2")

    ws = res.workspace_limit_bytes
    d_orig = _pairwise_distance_impl(x, x, metric, 2.0, "highest", ws)
    d_emb = _pairwise_distance_impl(xe, xe, metric, 2.0, "highest", ws)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d_orig = torch.where(eye, math.inf, d_orig)
    d_emb = torch.where(eye, math.inf, d_emb)

    # original-space rank of every pair (0 = nearest)
    order_orig = torch.sort(d_orig, dim=1, stable=True).indices
    ar = torch.arange(n, dtype=torch.int32, device=x.device)
    ranks = torch.empty((n, n), dtype=torch.int32, device=x.device)
    ranks.scatter_(1, order_orig, ar[None, :].expand(n, n).contiguous())

    # k nearest in embedded space
    nn_emb = torch.sort(d_emb, dim=1, stable=True).indices[:, :k]
    r = torch.gather(ranks, 1, nn_emb)                       # (n, k)
    penalty = torch.sum(torch.clamp(r - k + 1, min=0).to(torch.float32))
    norm = 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
    return 1.0 - norm * penalty


class ICType(enum.IntEnum):
    """``stats::IC_Type`` (``stats/information_criterion.cuh``)."""

    AIC = 0
    AICc = 1
    BIC = 2


def information_criterion(
    res: Optional[Resources],
    log_likelihood,
    ic_type: ICType,
    n_params: int,
    n_samples: int,
):
    """Batched AIC/AICc/BIC — ``stats::information_criterion_batched``."""
    ll = _put(res, log_likelihood).to(torch.float32)
    d = float(n_params)
    n = float(n_samples)
    if ic_type == ICType.AIC:
        pen = 2.0 * d
    elif ic_type == ICType.AICc:
        pen = 2.0 * d + 2.0 * d * (d + 1.0) / max(n - d - 1.0, 1e-6)
    elif ic_type == ICType.BIC:
        pen = float(torch.log(torch.tensor(n, dtype=torch.float32))) * d
    else:
        raise ValueError(f"unknown IC type: {ic_type}")
    return -2.0 * ll + pen


def dispersion(
    res: Optional[Resources],
    centroids,
    cluster_sizes,
    global_centroid=None,
):
    """Cluster dispersion sqrt(Σ_c n_c ‖μ_c − μ‖²) — ``stats::dispersion``
    (used by kmeans ``find_k``)."""
    c = _put(res, centroids).to(torch.float32)
    sz = _put(res, cluster_sizes).to(torch.float32)
    if global_centroid is None:
        global_centroid = (sz @ c) / torch.clamp(torch.sum(sz), min=1.0)
    else:
        global_centroid = _put(res, global_centroid).to(torch.float32)
    diff = c - global_centroid[None, :]
    return torch.sqrt(torch.sum(sz * torch.sum(diff * diff, dim=1)))
