"""tlie_tpu_torch: the PyTorch/CUDA port of tlie_tpu, for one NVIDIA H100.

It mirrors ``tlie_tpu``'s layout (``config``, ``data``, ``models``, ``ops``,
``training``, ``analysis``, ``inference``, ``parallel``) and imports neither JAX nor any module of
``tlie_tpu``.  Entry points take ``device="cuda"`` by default; the CPU runs
only when the caller asks for it, as the tests do.  On CUDA tensors the hot
ops launch hand-written kernels (``ops/csrc``), built with ``nvcc`` at first
use.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
