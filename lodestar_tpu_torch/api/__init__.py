"""Eth Beacon API: typed routes shared by client and server (layer L3).

Reference: `packages/api` — route definitions (`api/src/beacon/routes/*`)
consumed by both the REST client (validator) and the fastify server glue
(beacon node). Here: `routes` declares the typed surface, `server` exposes
it over stdlib http.server, `client` speaks it over http.client — the same
route table drives both sides (single source of truth, like the reference).

The port's copy of the JAX package's `api/`, over the port's chain; the
keymanager API (`keymanager.py`) serves a validator client's keys.
"""

from .routes import API_ROUTES, Route  # noqa: F401
from .server import BeaconApiServer  # noqa: F401
from .client import BeaconApiClient  # noqa: F401
