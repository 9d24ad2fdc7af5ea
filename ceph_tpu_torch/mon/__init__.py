"""Cluster control plane (reference src/mon/): the map-authority
monitor of the mini-cluster."""

from ceph_tpu_torch.mon.monitor import Monitor

__all__ = ["Monitor"]
