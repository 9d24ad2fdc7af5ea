"""Batched device dispatch for the storage data plane: the recovery-decode
aggregator (``decode_batcher``)."""

from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator  # noqa: F401
