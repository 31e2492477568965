"""Contrib layer of the port (counterpart of ``apex_tpu/contrib``): so far
``contrib.fmha``, packed variable-length attention over the varlen flash
kernels."""
