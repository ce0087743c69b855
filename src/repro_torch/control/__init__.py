# Anytime serving control plane (DESIGN.md §9, §10), on one card: health-
# ledger-driven degraded failover, online reshard with a staged live
# cutover, replica groups (served through the sharded engine until the mesh
# paths are ported), all above the port's serving engines, plus the durable
# topology journal replayed across process restarts.
from repro_torch.control.health import HealthEvent, HealthLedger  # noqa: F401
from repro_torch.control.journal import JOURNAL_NAME, TopologyJournal  # noqa: F401
from repro_torch.control.plane import ControlPlane  # noqa: F401
from repro_torch.control.replica import ReplicaGroupEngine  # noqa: F401
from repro_torch.control.reshard import ReshardPlanner, ReshardTask  # noqa: F401
