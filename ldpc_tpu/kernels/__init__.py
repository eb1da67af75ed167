"""Hand-written device kernels: the CUDA min-sum decoder for QC codes
(minsum_cuda), called through jax.ffi."""
