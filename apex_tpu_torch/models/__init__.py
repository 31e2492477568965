"""The model zoo of the examples (counterpart of ``apex_tpu/models``): the
NHWC ResNet of the imagenet example over ``SyncBatchNorm``'s one-device
path, and the DCGAN generator / discriminator, with flax's parameter
names (``models.layers``)."""

from apex_tpu_torch.models.dcgan import Discriminator, Generator  # noqa: F401
from apex_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet50,
    make_norm,
)
