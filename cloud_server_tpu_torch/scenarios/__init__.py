"""Scenario harness: trace-driven workloads for an elastic fleet.

A copy of the reference's `scenarios/` package. Its layers:

  * ``workload``   — seeded, composable generators (arrival processes,
    length mixtures, multi-turn sessions with shared system prefixes,
    tenant mixes) emitting a DETERMINISTIC event stream.
  * ``replay``     — fires an event stream against a live target:
    ``ReplicatedRouter.submit()`` / ``PagedInferenceServer.submit()``
    directly, or the HTTP frontend over the wire.
  * ``simulator``  — a host-only discrete-event model of the mixed
    scheduler + router, calibrated from flight-recorder iteration
    costs, for policy search at scales a live test cannot reach.
  * ``autoscaler`` — the SLO-burn-rate policy loop that closes the
    loop from ``ReplicatedRouter.slo_report()`` burn rates to the
    runtime fleet-mutation APIs (``add_replica``/``remove_replica``).

Nothing in this package is imported by the serving path; an
unconfigured deployment is byte-identical with or without it (the
port's tests count one program launch and one sync per replayed
iteration).
"""

from cloud_server_tpu_torch.scenarios.workload import (  # noqa: F401
    Event, LengthMixture, MMPPArrivals, PoissonArrivals, Scenario,
    SessionShape, TenantMix, TraceArrivals, diurnal_burst,
    stream_bytes)
from cloud_server_tpu_torch.scenarios.replay import (  # noqa: F401
    HttpTarget, ReplayDriver)
from cloud_server_tpu_torch.scenarios.simulator import (  # noqa: F401
    CostModel, FleetSim, SimReplica)
from cloud_server_tpu_torch.scenarios.autoscaler import (  # noqa: F401
    AutoscalerConfig, SLOBurnAutoscaler)
