"""Batched device dispatch for the storage data plane: the recovery-decode
aggregator (``decode_batcher``), the deep-scrub verifier
(``scrub_batcher``), and the encode service (``encode_service``) with its
farm over an in-process mesh of devices (``encode_farm``)."""

from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator  # noqa: F401
from ceph_tpu_torch.parallel.encode_farm import (  # noqa: F401
    Mesh,
    batch_encode_dp,
    sharded_encode_tp,
)
from ceph_tpu_torch.parallel.encode_service import (  # noqa: F401
    DEFAULT_MIN_BYTES,
    EncodeService,
    reset_shared,
    shared,
)
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier  # noqa: F401
