"""Fleet supervision: health monitoring, fault injection, recovery (port
of ``repro/fleet``).

The subsystem splits by dependency weight so chaos *plans* stay data:

* ``faults.py``  — ``FaultPlan`` / ``FaultEvent`` (stdlib only)
* ``health.py``  — per-island ALIVE/SUSPECT/DEAD detector (stdlib + obs)
* ``controller.py`` — ``FleetConfig``, the engine-level
  ``IslandSupervisor`` and the service-level ``FleetController``
  (imports torch and the checkpoint store — loaded lazily here so
  ``from repro_torch.fleet import FaultPlan`` stays light)
"""
from repro_torch.fleet.faults import (CORRUPT, DELAY, KILL,    # noqa: F401
                                      FaultEvent, FaultPlan)
from repro_torch.fleet.health import (ALIVE, DEAD,             # noqa: F401
                                      SUSPECT, FleetHealth, HealthConfig,
                                      IslandHealth)

_LAZY = ("FleetConfig", "FleetController", "IslandSupervisor",
         "occupancy_skew")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.fleet import controller
        return getattr(controller, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FaultEvent", "FaultPlan", "KILL", "DELAY", "CORRUPT",
           "FleetHealth", "HealthConfig", "IslandHealth",
           "ALIVE", "SUSPECT", "DEAD", *_LAZY]
