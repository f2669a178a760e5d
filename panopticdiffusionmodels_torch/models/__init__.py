from .unet import UNet2DCondition
from .uvit import UViT
from .uvit_t2i import UViTT2I

# Config fields the port's constructors do not take: `scan_blocks` is a JAX
# compile-time layout (the port unrolls), `use_ground_truth` a call-time mode
# the loss passes per forward.
TRAINING_ONLY_FIELDS = ("scan_blocks", "use_ground_truth")


def get_nnet(name: str, **kwargs):
    """Model factory over a config's `nnet` fields."""
    for k in TRAINING_ONLY_FIELDS:
        kwargs.pop(k, None)
    if name == "uvit_t2i":
        return UViTT2I(**kwargs)
    if name == "uvit":
        return UViT(**kwargs)
    if name == "unet_t2i":
        return UNet2DCondition(**kwargs)
    raise NotImplementedError(name)
