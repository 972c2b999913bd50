"""Checking-as-a-service: a multi-tenant pool over one card, and a fleet
of such pools.

Counterpart of ``stateright_tpu/service``: :class:`CheckerService` owns
the card and serves N concurrent checking jobs -- batch jobs in supervised
worker subprocesses (per-job heartbeat, auto-checkpoint, span trace; a
wedge quarantines one job, never the pool) and interactive Explorer
sessions as registered in-process clients -- behind admission control,
with a breaker that degrades the pool to the host engine instead of dying,
and a journal that a restarted pool replays. :class:`FleetService` fronts
N such pools, one per device, with least-loaded routing, per-device
breaker state, failover migration and a routing journal of its own
(``service/fleet.py``).
"""

from .core import (
    SERVICE_COUNTERS,
    AdmissionError,
    CheckerService,
    Job,
    ServiceConfig,
)
from .fleet import FLEET_COUNTERS, FleetConfig, FleetJob, FleetService
from .journal import Journal, JournalTorn, read_journal
from .registry import SHIPPED, resolve

__all__ = [
    "AdmissionError",
    "CheckerService",
    "FLEET_COUNTERS",
    "FleetConfig",
    "FleetJob",
    "FleetService",
    "Job",
    "Journal",
    "JournalTorn",
    "read_journal",
    "SERVICE_COUNTERS",
    "ServiceConfig",
    "SHIPPED",
    "resolve",
]
