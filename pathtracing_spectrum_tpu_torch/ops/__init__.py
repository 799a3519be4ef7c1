"""Device ops: plain torch functions and the CUDA kernel wrappers."""
