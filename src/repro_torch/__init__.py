"""PyTorch / CUDA port of the ``repro`` package.

The JAX package ``repro`` is the reference: each module here sits at the same
relative path as its counterpart there and keeps its names.  The port imports
``torch`` and never ``jax``, and nothing of ``repro``; what it needs from the
reference (the model configs, the analytical model in ``core`` and
``obs.metrics``) it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).  Every Pallas TPU kernel on a ported path is a
kernel written by hand for Hopper, under ``csrc/``, with its plain PyTorch
version beside it in ``kernels/<name>/ref.py``.
"""
