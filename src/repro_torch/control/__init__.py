# The control plane's durable topology journal (DESIGN.md §10), copied from
# the reference: ``python -m repro_torch.index_io log`` reads it. The rest of
# the reference's control plane (health ledger, reshard, replica groups,
# ControlPlane) is not ported yet.
from repro_torch.control.journal import JOURNAL_NAME, TopologyJournal  # noqa: F401
