"""The request plane of the port: so far its lowest layer, `ScenarioSpec`
(`serve/spec.py`), which the memo plane plans over.  The registry,
scheduler, service, fleet and journal wait for ROADMAP.md A14."""

from .spec import (ATTACK_KEYS, ENGINES, OBS_PLANES,  # noqa: F401
                   ROUTE_KERNELS, ScenarioSpec, int_env)

__all__ = ["ScenarioSpec", "ENGINES", "OBS_PLANES", "ROUTE_KERNELS",
           "ATTACK_KEYS", "int_env"]
