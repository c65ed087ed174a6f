"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Sources live in ``perspectivefields_tpu_torch/csrc``.

``decoder_tail`` is exported as a function, as the JAX package exports it;
its module (launch counter, plain version) is reached by
``importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")``.
"""

from .decoder_tail import decoder_tail

__all__ = ["decoder_tail"]
