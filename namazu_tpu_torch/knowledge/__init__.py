"""The knowledge plane on the port's sidecar: the counterpart of
``namazu_tpu/knowledge``.

* :mod:`namazu_tpu_torch.knowledge.service`: :class:`KnowledgeService`,
  the multi-tenant hub the sidecar hosts with ``--pool-dir``: a
  content-keyed failure pool, per-scenario best tables, pooled relation
  coverage, triage dossiers and shared surrogates on the card;
* :mod:`namazu_tpu_torch.knowledge.client`: :class:`KnowledgeClient`,
  the campaign side (ingest and the remote surrogate), which degrades to
  local-only search on an outage and never raises into the search.

Wire ops (the reference's, wire version 3): ``pool_push``,
``pool_pull``, ``surrogate_predict``, ``stats``, ``triage_push``,
``triage_pull``.
"""

from namazu_tpu_torch.knowledge.client import (  # noqa: F401
    KnowledgeClient,
    pairs_fingerprint,
    shared_client,
)
from namazu_tpu_torch.knowledge.service import KnowledgeService  # noqa: F401

KNOWLEDGE_OPS = KnowledgeService.OPS
