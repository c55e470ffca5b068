"""Causality guidance: relation coverage as the search's objective. The
port's own copy of ``namazu_tpu/guidance`` (signatures and the coverage
map; numpy only, so the same results as the reference's on the same
encoded traces).

* :mod:`namazu_tpu_torch.guidance.signature`: a run's relation-coverage
  signature (occurrence-indexed bucket pairs hashed into a bitmap) and
  its DAG-shape feature fragment;
* :mod:`namazu_tpu_torch.guidance.coverage`: the per-campaign
  :class:`CoverageMap` (novelty, candidate gain, one-sided frontier,
  per-bucket mutation bias).

``models/search.py`` wires a map with ``enable_guidance`` (the guided
candidate pick and the biased mutation); ``models/ingest.py`` rebuilds it
from the stored history on each ingest and pools its bits through the
knowledge service.
"""

from __future__ import annotations

from namazu_tpu_torch.guidance.coverage import (  # noqa: F401
    CoverageDelta,
    CoverageMap,
    MAX_PAIRS,
)
from namazu_tpu_torch.guidance.signature import (  # noqa: F401
    DEFAULT_WIDTH,
    DEFAULT_WINDOW,
    GUIDANCE_DIMS,
    SCAN_CAP,
    bucket_sequence_from_docs,
    bucket_sequence_from_encoded,
    bucket_sequence_from_trace,
    dag_shape_features,
    hint_bucket,
    occurrence_index,
    pair_bit,
    relation_pairs,
    reverse_signature_bits,
    signature_bits,
)
