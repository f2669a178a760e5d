from .uvit_t2i import UViTT2I

# Config fields that steer the JAX package's training and compilation only
# (activation remat, scanned block stacks); inference ignores them.
TRAINING_ONLY_FIELDS = ("use_checkpoint", "remat_policy", "scan_blocks", "use_ground_truth")


def get_nnet(name: str, **kwargs):
    """Model factory over a config's `nnet` fields."""
    for k in TRAINING_ONLY_FIELDS:
        kwargs.pop(k, None)
    if name == "uvit_t2i":
        return UViTT2I(**kwargs)
    if name == "uvit":
        raise NotImplementedError("models/uvit.py comes with the ImageNet-256 slice")
    if name == "unet_t2i":
        raise NotImplementedError("models/unet.py comes with the UNet-family slice")
    raise NotImplementedError(name)
