"""lazzaro_tpu_torch: the PyTorch/CUDA port of lazzaro_tpu.

Same ``MemorySystem`` API and arena layout as the JAX package, with state in
torch tensors on the card and the TPU kernels rewritten by hand for Hopper
(``csrc/``). Entry points run on CUDA unless the caller passes
``device="cpu"``; nothing falls back silently.
"""

from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.core.memory_system import MemorySystem

__all__ = ["MemoryConfig", "MemoryIndex", "MemorySystem"]
