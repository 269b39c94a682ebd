"""PyTorch/CUDA port of the distributed-CNN system in ``repro``.

The package mirrors ``src/repro/`` module for module, so each file names
the JAX file it must match (``repro_torch/dist/conv2d.py`` against
``repro/dist/conv2d.py``).  It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.

What this port covers is CNN inference on the paper's 5-axis grid:
``models.cnn.forward_cnn(..., dist_mesh=...)`` routes every conv through
``dist.conv2d.conv2d_distributed`` and the classifier head through
``dist.matmul.matmul_distributed``; their per-rank contractions land on
hand-written CUDA kernels (``kernels/csrc``) on the card and on the
kernels' plain PyTorch versions on the CPU.  The slice is forward-only:
a tensor that requires grad is refused (``device.forward_only``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""
