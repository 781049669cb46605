"""Device ops of the port, in PyTorch: the one-sort BWT (``bwt_fast``)
and the narrow MTF (``mtf_narrow``, a hand-written CUDA kernel on a CUDA
device).  Counterparts of ``starch3_tpu/ops`` of the same names."""
