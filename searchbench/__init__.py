"""The benchmark of namazu_tpu_torch's search sidecar on an H100: a
fleet of campaigns searching through the sidecar (``run.py``), with its
plain reference (``reference/``). Run it as ``python3 -m searchbench``."""
