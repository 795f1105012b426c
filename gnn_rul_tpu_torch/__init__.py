"""gnn_rul_tpu_torch — the PyTorch/CUDA port of gnn_rul_tpu for NVIDIA Hopper.

Same sub-package layout as ``gnn_rul_tpu``: each module's counterpart sits at
the same relative path. The port imports ``torch`` and numpy only, never JAX
and nothing of ``gnn_rul_tpu``. Every TPU (Pallas) kernel on a ported path is
a hand-written CUDA kernel under ``csrc/``, wrapped in ``ops/kernels/``.
"""

__version__ = "0.1.0"
