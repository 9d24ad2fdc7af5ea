"""ctlint rule families.  Each module contributes one Rule subclass;
``ALL_RULES`` is the suite ``python -m ceph_tpu_torch.tools.lint`` and
the tier-1 gate run.  The 16 rule ids are the JAX package's; where a
rule's premise was JAX's (a jit compile, ``device_put``,
``block_until_ready``), its module's docstring says what it means on
this card."""

from ceph_tpu_torch.analysis.rules.configrule import ConfigRegistryRule
from ceph_tpu_torch.analysis.rules.determinism import DeterminismRule
from ceph_tpu_torch.analysis.rules.device import DeviceDisciplineRule
from ceph_tpu_torch.analysis.rules.locks import LockOrderRule
from ceph_tpu_torch.analysis.rules.transfer import TransferRule
from ceph_tpu_torch.analysis.rules.wire import WireProtocolRule

ALL_RULES = (
    DeviceDisciplineRule,
    LockOrderRule,
    WireProtocolRule,
    ConfigRegistryRule,
    DeterminismRule,
    TransferRule,
)

#: rule-id -> one-line description (the catalog the lint prints)
RULE_CATALOG: dict[str, str] = {}
for _cls in ALL_RULES:
    RULE_CATALOG.update(_cls.catalog)
