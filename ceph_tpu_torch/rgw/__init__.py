"""RGW-lite: the S3 object gateway on RADOS.

Twin of the reference's largest service (src/rgw/, 257 kLoC):
a REST frontend (rgw_asio_frontend.cc -> :mod:`frontend` here), S3 op
dispatch (rgw_op.cc -> :mod:`frontend` handlers), SigV4 auth
(rgw_auth_s3.cc -> :mod:`sigv4`), and a RADOS store driver
(rgw/driver/rados/rgw_rados.cc -> :mod:`store`) keeping bucket indexes
as omap via the in-OSD ``rgw`` object class (src/cls/rgw).

Counterpart of ``ceph_tpu/rgw/__init__.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from .store import RGWStore, RGWError  # noqa: F401
from .frontend import S3Frontend  # noqa: F401
from .sigv4 import sign_request, SigV4Error  # noqa: F401
