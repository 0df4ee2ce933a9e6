"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference: it imports ``torch`` and nothing
of ``jax`` or ``repro`` (modules it needs from there are kept as trimmed
copies under the same relative path). This slice carries the serving main
path: full-width qwen3 served by a window+overlap :class:`~repro_torch.serve.
Replica`, with hand-written ``sm_90a`` kernels for flash attention and the
fault probe (``repro_torch.kernels``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
