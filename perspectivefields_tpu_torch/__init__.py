"""PerspectiveFields on PyTorch and CUDA (NVIDIA Hopper).

A port of ``perspectivefields_tpu`` (JAX on a TPU), which stays beside it as
the reference. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package that the port has taken over is a hand-written CUDA kernel here
(``kernels/<name>.py`` beside ``csrc/<name>.cu``): the attention sub-block,
the stage-1 attention, the MixFFN, the ConvNeXt block and the whole MiT
block. The package imports neither jax nor flax.
"""

__all__ = ["PerspectiveFields", "ResizeTransform", "PanoCam", "model_zoo"]


def __getattr__(name):
    # imported at first use, as the JAX package does, so that
    # ``perspectivefields_tpu_torch.ops`` loads without the models
    if name in ("PerspectiveFields", "ResizeTransform"):
        from . import api

        return getattr(api, name)
    if name == "model_zoo":
        from .config import model_zoo

        return model_zoo
    if name == "PanoCam":
        from .pano_camera import PanoCam

        return PanoCam
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
