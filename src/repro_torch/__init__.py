"""repro_torch — the PyTorch + CUDA port of the SLTrain system.

A second package beside the JAX reference (``repro``), mirroring it module
for module so each port module is held against its reference counterpart
(tests/test_torch_*.py). It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use and bound with
``ctypes``; each has a plain PyTorch version beside it that runs for
tensors on the CPU. Entry points take a ``device`` argument that defaults
to ``"cuda"`` and raise when no card is present unless the caller asks for
``device="cpu"`` (see :func:`repro_torch.device.resolve`).
"""
