"""Wire transport (reference src/msg/): so far the denc encoding, which
FileStore's journal and the tracing wire context write.  The messenger,
its frames, auth and the typed message set of the JAX package's
ceph_tpu/msg/ come with the port's daemons."""

from ceph_tpu_torch.msg.denc import Decoder, Encoder, EncodingError

__all__ = [
    "Decoder",
    "Encoder",
    "EncodingError",
]
