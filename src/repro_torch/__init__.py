"""PyTorch/CUDA port of the distributed-CNN system in ``repro``.

The package mirrors ``src/repro/`` module for module, so each file names
the JAX file it must match (``repro_torch/dist/conv2d.py`` against
``repro/dist/conv2d.py``).  It imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``.

What this port covers is CNN inference and training on the paper's
5-axis grid: ``models.cnn.forward_cnn(..., dist_mesh=...)`` routes every
conv through ``dist.conv2d.conv2d_distributed`` and the classifier head
through ``dist.matmul.matmul_distributed``, both differentiable, and
``dist.train.make_grid_train_step`` runs the loss, its gradients and
AdamW (``train.optim``) through them.  Their per-rank contractions go
through the autotuned menu of ``kernels.ops`` and land on hand-written
CUDA kernels (``kernels/csrc``) on the card and on the kernels' plain
PyTorch versions on the CPU.  The LM families dense, moe and vlm
(``configs``, ``models.lm``) serve through a continuous-batching engine
(``launch.serve``) whose every projection runs on the ``(Pm,Pn,Pc)``
matmul grid (``dist.lm``) and so on the same hand-written GEMM.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""
