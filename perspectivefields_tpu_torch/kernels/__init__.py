"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Sources live in ``perspectivefields_tpu_torch/csrc``.

``fused_attention`` and ``decoder_tail`` are exported as functions, as the
JAX package exports them; so ``kernels.fused_attention`` is the function,
and its module (launch counter, plain version, route) is reached by
``importlib.import_module("perspectivefields_tpu_torch.kernels.fused_attention")``
(likewise ``decoder_tail``), or in ``MODULES``.
"""

import importlib

from .decoder_tail import decoder_tail
from .fused_attention import fused_attention

# The six kernel modules, each counting its launches in ``LAUNCHES``
MODULES = tuple(
    importlib.import_module(f"{__name__}.{name}")
    for name in ("fused_attention", "stage1_attention", "mixffn", "convnext_block",
                 "decoder_tail", "fused_block")
)

__all__ = ["fused_attention", "decoder_tail", "MODULES"]
