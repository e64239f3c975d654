"""dlrover_tpu_torch — the PyTorch and CUDA port of ``dlrover_tpu``.

The JAX package ``dlrover_tpu`` is the reference; this package mirrors its
module layout one module per module (``dlrover_tpu_torch/models/
llama_infer.py`` answers to ``dlrover_tpu/models/llama_infer.py``) and is
held against it by the ``tests/test_torch_*.py`` parity tests.  It imports
``torch`` and never ``jax`` or ``dlrover_tpu``: host code it needs from the
reference is kept here as its own copy.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`dlrover_tpu_torch.common.device`).  Every TPU
kernel on a ported path is a hand-written Hopper kernel under
``ops/csrc/`` with a plain PyTorch version beside it; the plain version runs
only for tensors that lie on the CPU.
"""
