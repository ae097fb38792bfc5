"""Hand-written CUDA kernels of the device search path (`csrc/`), their
ctypes build (`_build`), thin wrappers (`chunk_adc`, `pq_lut`, `pq_adc`,
`rerank`), plain PyTorch versions (`ref`) and backend dispatch (`ops`)."""
