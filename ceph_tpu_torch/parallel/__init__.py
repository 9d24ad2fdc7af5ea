"""Batched device dispatch for the storage data plane: the recovery-decode
aggregator (``decode_batcher``) and the deep-scrub verifier
(``scrub_batcher``)."""

from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator  # noqa: F401
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier  # noqa: F401
