"""PyTorch/CUDA port of the ``repro`` package (queueing-aware reasoning-token
allocation), laid out module for module like ``repro``.

It imports ``torch`` and numpy and nothing of JAX or ``repro``. Entry points
take an explicit ``device`` (default ``"cuda"``); the hand-written Hopper
kernels live in ``kernels/`` with their CUDA sources in ``csrc/``.
"""
