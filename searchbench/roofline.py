"""The least time of B1, the pair-distance kernel, on one H100.

B1 gives, for ``N`` feature rows of width ``K``, the least squared
distance to ``A`` archive rows and to ``F`` failure rows. Whatever
implements it, the work is ``2 N (A + F) K`` operations at float32
accuracy, priced as three TF32 tensor-core products (a split of each
float32 operand into a TF32 high and low part) at the published TF32
peak; the bytes are the feature, archive and failure rows read once and
the two ``[N]`` results written once, at the published HBM bandwidth.
The least time is the larger of the two. ``A`` and ``F`` count the rows
the inputs need: the distinct rows the rings hold, not their allocated
sizes (unwritten slots are one neutral row, identical to each other).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOP_PER_S = 495e12
TF32_SPLIT_PRODUCTS = 3


def b1_least_seconds(N: int, A: int, F: int, K: int) -> float:
    nbytes = 4 * (N * K + (A + F) * K + 2 * N)
    flops = 2 * N * (A + F) * K
    return max(nbytes / PEAK_BYTES_PER_S,
               TF32_SPLIT_PRODUCTS * flops / PEAK_TF32_FLOP_PER_S)


def ring_rows(distinct: int, written: int, size: int) -> int:
    """Rows a ring's content needs: its distinct written rows, plus one
    neutral row while some slot is unwritten."""
    return min(distinct, size) + (1 if written < size else 0)
