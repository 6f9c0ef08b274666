"""Signal processing, vector quantization and the CUDA kernels."""
