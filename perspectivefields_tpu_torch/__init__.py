"""PerspectiveFields on PyTorch and CUDA (NVIDIA Hopper).

A port of ``perspectivefields_tpu`` (JAX on a TPU), which stays beside it as
the reference. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package that the port has taken over is a hand-written CUDA kernel here
(``kernels/<name>.py`` beside ``csrc/<name>.cu``): the attention sub-block,
the stage-1 attention, the MixFFN, the ConvNeXt block and the whole MiT
block. The package imports neither jax nor flax.
"""

from .api import PerspectiveFields

__all__ = ["PerspectiveFields"]
