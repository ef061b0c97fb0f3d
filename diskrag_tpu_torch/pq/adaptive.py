"""Adaptive PQ parameter recommendation.

Behavior-parity reimplementation of the reference's AdaptivePQCalculator
(pydiskann/pq/adaptive_pq.py:24-260): recommend m from the candidate set
{4,8,16,32,48,64,96,128} given dataset size, dimension and a target
accuracy tier; datasets under 1000 points get brute_force; sub_dim must
land in [2, 64]; expected quality comes from the same hard-coded baseline
table with linear interpolation.
"""

from __future__ import annotations

import dataclasses

SUBVECTOR_CANDIDATES = [4, 8, 16, 32, 48, 64, 96, 128]

# expected-quality table ("based on test results" in the reference,
# adaptive_pq.py:32-40)
PERFORMANCE_BASELINE = {
    4: {"recall": 0.20, "spearman": 0.96, "compression": 128.0},
    8: {"recall": 0.50, "spearman": 0.98, "compression": 64.0},
    16: {"recall": 0.60, "spearman": 0.99, "compression": 32.0},
    32: {"recall": 0.90, "spearman": 1.00, "compression": 16.0},
    48: {"recall": 0.85, "spearman": 0.99, "compression": 10.7},
    64: {"recall": 0.90, "spearman": 1.00, "compression": 8.0},
    96: {"recall": 0.88, "spearman": 0.99, "compression": 5.3},
}


@dataclasses.dataclass
class PQRecommendation:
    n_subvectors: int
    n_centroids: int
    sub_dimension: int
    recommendation: str
    compression_ratio: float
    expected_recall: float
    expected_spearman: float
    reasoning: str


def _valid_subvectors(dimension: int) -> list[int]:
    out = []
    for m in SUBVECTOR_CANDIDATES:
        if dimension % m == 0 and 2 <= dimension // m <= 64:
            out.append(m)
    return out


def _predict_performance(m: int) -> dict:
    if m in PERFORMANCE_BASELINE:
        return dict(PERFORMANCE_BASELINE[m])
    keys = sorted(PERFORMANCE_BASELINE)
    if m < keys[0]:
        return dict(PERFORMANCE_BASELINE[keys[0]])
    if m > keys[-1]:
        return dict(PERFORMANCE_BASELINE[keys[-1]])
    for lo, hi in zip(keys, keys[1:]):
        if lo <= m <= hi:
            t = (m - lo) / (hi - lo)
            a, b = PERFORMANCE_BASELINE[lo], PERFORMANCE_BASELINE[hi]
            return {
                k: a[k] + t * (b[k] - a[k])
                for k in ("recall", "spearman", "compression")
            }
    return {"recall": 0.8, "spearman": 0.95, "compression": 16.0}


def calculate_adaptive_pq_params(
    n_points: int, dimension: int, target_accuracy: str = "balanced"
) -> PQRecommendation:
    """Recommend PQ params; same decision tree as the reference
    (adaptive_pq.py:42-150)."""
    if n_points < 1000:
        return PQRecommendation(
            n_subvectors=0, n_centroids=0, sub_dimension=0,
            recommendation="brute_force", compression_ratio=1.0,
            expected_recall=1.0, expected_spearman=1.0,
            reasoning="dataset too small; use brute-force search",
        )

    cands = _valid_subvectors(dimension)
    if not cands:
        # no grid candidate divides the dimension (e.g. D=50): widen to
        # any divisor with a legal sub_dim rather than returning an m
        # that would crash ProductQuantizer.fit downstream
        cands = [
            m for m in range(2, dimension + 1)
            if dimension % m == 0 and 2 <= dimension // m <= 64
        ]
    if not cands:
        # prime/awkward dimension: nothing divides it legally
        return PQRecommendation(
            n_subvectors=0, n_centroids=0, sub_dimension=0,
            recommendation="brute_force", compression_ratio=1.0,
            expected_recall=1.0, expected_spearman=1.0,
            reasoning=f"no subvector count divides dimension {dimension}; "
            "use brute-force search",
        )

    if n_points <= 50_000:
        if target_accuracy == "high_accuracy":
            m, rec = max(cands), "high_accuracy"
            why = f"small/medium dataset ({n_points:,} pts), high accuracy"
        else:
            m, rec = cands[len(cands) // 2], "balanced"
            why = f"small/medium dataset ({n_points:,} pts), balanced"
    elif n_points <= 500_000:
        if target_accuracy == "space_saving":
            m, rec = min(cands), "space_saving"
            why = f"large dataset ({n_points:,} pts), space saving"
        else:
            m, rec = cands[len(cands) // 2], "balanced"
            why = f"large dataset ({n_points:,} pts), balanced"
    elif n_points <= 2_000_000:
        if target_accuracy == "high_accuracy":
            m, rec = cands[len(cands) // 3], "balanced"
            why = f"very large dataset ({n_points:,} pts), accuracy/space balance"
        else:
            m, rec = min(cands), "space_saving"
            why = f"very large dataset ({n_points:,} pts), space saving"
    else:
        m, rec = min(cands), "space_saving"
        why = f"huge dataset ({n_points:,} pts), maximum compression"

    perf = _predict_performance(m)
    return PQRecommendation(
        n_subvectors=m,
        n_centroids=256,
        sub_dimension=dimension // m,
        recommendation=rec,
        compression_ratio=perf["compression"],
        expected_recall=perf["recall"],
        expected_spearman=perf["spearman"],
        reasoning=why,
    )


def validate_recommendation(
    rec: PQRecommendation, n_points: int, dimension: int
) -> tuple[bool, str]:
    """Sanity checks mirroring the reference's validate_recommendation."""
    if rec.recommendation == "brute_force":
        return True, "dataset too small; brute force"
    if rec.sub_dimension < 2:
        return False, f"sub-dimension too small: {rec.sub_dimension}"
    if rec.sub_dimension > 64:
        return False, f"sub-dimension too large: {rec.sub_dimension}"
    if rec.compression_ratio < 2:
        return False, f"compression too low: {rec.compression_ratio:.1f}x"
    if rec.expected_recall < 0.1:
        return False, f"expected recall too low: {rec.expected_recall:.1%}"
    return True, "ok"


def get_recommendation_summary(rec: PQRecommendation) -> str:
    """Human-readable recommendation summary (reference
    adaptive_pq.py:186-200 format, without the emoji markers)."""
    if rec.recommendation == "brute_force":
        return f"recommendation: {rec.reasoning}"
    return (
        f"PQ parameters: {rec.n_subvectors}x{rec.n_centroids}\n"
        f"sub-dimension: {rec.sub_dimension}\n"
        f"expected top-10 recall: {rec.expected_recall:.1%}\n"
        f"expected rank correlation: {rec.expected_spearman:.1%}\n"
        f"compression: {rec.compression_ratio:.1f}x\n"
        f"strategy: {rec.reasoning}"
    )


def get_pq_recommendation_summary(
    n_points: int, dimension: int, target_accuracy: str = "balanced"
) -> str:
    """One-call summary (reference adaptive_pq.py:254-259)."""
    return get_recommendation_summary(
        calculate_adaptive_pq_params(n_points, dimension, target_accuracy)
    )
