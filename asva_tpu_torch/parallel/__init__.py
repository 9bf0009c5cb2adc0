"""Multi-process helpers of the CLIs (port of asva_tpu/parallel/multihost.py),
in their one-process forms; see `multihost`."""
