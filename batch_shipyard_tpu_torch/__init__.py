"""PyTorch/CUDA port of batch_shipyard_tpu's serving path for NVIDIA
Hopper (H100).

The JAX package (``batch_shipyard_tpu``) is the reference; this package
mirrors its layout (``ops/``, ``models/``, ``workloads/``, ``trace/``)
so each module has a named counterpart there. It imports ``torch`` and
never ``jax``/``flax`` or any module of ``batch_shipyard_tpu``.

Every Pallas TPU kernel on the ported path is a hand-written CUDA
kernel for ``sm_90a`` (``ops/csrc/``), built with ``nvcc`` at first use
and bound with ``ctypes`` (``ops/_build.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; they never fall back
to the CPU on their own (``device.resolve_device``).
"""
