"""REST-driven light-client follower (the port's copy of the JAX
package's `light_client/rest_follow.py`, over the port's `api/client.py`).

Reference: `light-client/src/index.ts` `Lightclient.start` (SURVEY §3.5):
bootstrap from a trusted block root over the Beacon API, replay
sync-committee-period updates, then follow the head via the SSE event
stream's light-client optimistic/finality updates.
"""

from __future__ import annotations

from ..utils.logger import get_logger
from .client import Lightclient, LightClientError

log = get_logger("lightclient")


class RestLightclientFollower:
    """Wires a verifying `Lightclient` to a node's REST + SSE surface."""

    def __init__(self, config, types, preset, client, host: str, port: int):
        self.lc = Lightclient(config, types, preset)
        self.client = client  # BeaconApiClient
        self.host = host
        self.port = port
        self.types = types

    def start(self, trusted_block_root: bytes) -> None:
        """Bootstrap + catch up on period updates (reference start())."""
        boot_obj = self.client.getLightClientBootstrap(
            "0x" + trusted_block_root.hex()
        )
        bootstrap = self.types.LightClientBootstrap.from_obj(boot_obj)
        self.lc.bootstrap(trusted_block_root, bootstrap)
        self._catch_up()

    def _catch_up(self) -> None:
        period = self.lc._period(int(self.lc.finalized_header.slot))
        while True:
            updates = self.client.getLightClientUpdatesByRange(
                query={"start_period": str(period), "count": "8"}
            ) or []
            if not updates:
                return
            for obj in updates:
                update = self.types.LightClientUpdate.from_obj(obj)
                try:
                    self.lc.process_update(update)
                except LightClientError as e:
                    log.warning("update rejected: %s", e)
                    return
            if len(updates) < 8:
                return
            period += 8

    def follow(self, max_events: int | None = None, timeout: float = 30.0) -> int:
        """Consume SSE light-client events, verifying each; returns the
        number of applied updates (runs until the stream closes, the
        timeout passes without frames, or max_events is reached)."""
        from ..api.client import stream_events

        applied = 0
        for name, payload in stream_events(
            self.host,
            self.port,
            topics=["light_client_optimistic_update", "light_client_finality_update"],
            timeout=timeout,
        ):
            try:
                if name == "light_client_optimistic_update":
                    update = self.types.LightClientOptimisticUpdate.from_obj(payload)
                    self.lc.process_optimistic_update(update)
                else:
                    update = self.types.LightClientFinalityUpdate.from_obj(payload)
                    self.lc.process_finality_update(update)
                applied += 1
            except LightClientError as e:
                log.warning("streamed update rejected: %s", e)
            if max_events is not None and applied >= max_events:
                break
        return applied
