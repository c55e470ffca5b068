"""namazu_tpu_torch: the search plane of namazu_tpu on PyTorch and CUDA.

The JAX package ``namazu_tpu`` is the reference; this package is its
port to one NVIDIA H100 and imports nothing of it (nor JAX). Scoring
(``ops.schedule``), the pair-distance kernel (``ops.pair_distance`` over
``csrc/min_sq_pair.cu``), the GA (``models.ga``), the island step
(``parallel.islands``) and ``ScheduleSearch`` (``models.search``) keep the
reference's module names.
"""

from namazu_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
