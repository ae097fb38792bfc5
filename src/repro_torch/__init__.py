"""PyTorch/CUDA port of the AiSAQ device search path (`repro` is the JAX
reference; module names mirror it so each counterpart is easy to find).

The package imports torch and numpy only — never jax, never `repro`.
Entry points place their tensors on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""
