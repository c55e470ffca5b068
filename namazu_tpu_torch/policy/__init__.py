"""The search half of the reference's ``tpu_search`` policy on the port
(``policy/tpu.py``); the ``torch_search`` policy that runs it registers
from ``namazu_tpu_torch_policy.py`` at the repository root."""
