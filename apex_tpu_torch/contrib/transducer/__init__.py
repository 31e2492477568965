"""RNN-T joint and loss (counterpart of ``apex_tpu/contrib/transducer``)."""

from apex_tpu_torch.contrib.transducer.transducer import (  # noqa: F401
    TransducerJoint,
    TransducerLoss,
    transducer_joint,
    transducer_loss,
    unpack_transducer_input,
)

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss", "unpack_transducer_input"]
