"""PyTorch + CUDA port of the scene-text-detection system in ``repro``.

The JAX package ``repro`` is the reference; this package computes the same
functions with torch ops and hand-written Hopper (sm_90a) kernels, and
never imports JAX or ``repro``.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
