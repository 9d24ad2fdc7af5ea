"""Wire transport (reference src/msg/): denc encoding, msgr2-style
frames, cephx-style auth, the asyncio messenger, and the typed message
set: the counterpart of ``ceph_tpu/msg/``, with the same wire bytes."""

from ceph_tpu_torch.msg.denc import Decoder, Encoder, EncodingError
from ceph_tpu_torch.msg.messenger import Connection, Message, Messenger

__all__ = [
    "Connection",
    "Decoder",
    "Encoder",
    "EncodingError",
    "Message",
    "Messenger",
]
