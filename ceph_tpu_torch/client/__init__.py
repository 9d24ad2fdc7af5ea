"""Client access library (reference src/librados + src/osdc)."""

from ceph_tpu_torch.client.rados import IoCtx, RadosClient, RadosError

__all__ = ["IoCtx", "RadosClient", "RadosError"]
