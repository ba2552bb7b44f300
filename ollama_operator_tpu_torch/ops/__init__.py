"""Numerics: norms, rope, attention, quantized weights and KV cache, paged
decode, sampling, and the CUDA kernels behind them."""
