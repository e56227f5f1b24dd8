"""Server-side req/resp handlers against the chain/db.

Reference: `network/reqresp/handlers/` — status from chain state,
beaconBlocksByRange streaming from hot + archived blocks, byRoot lookups,
ping/metadata from the local metadata object.

(The port's copy of the JAX package's `network/reqresp/handlers.py`.)
"""

from __future__ import annotations

from .codec import RespCode, encode_error_chunk, encode_response_chunk

MAX_REQUEST_BLOCKS = 1024


class ReqRespHandlers:
    def __init__(self, config, types, chain, metadata=None):
        self.config = config
        self.types = types
        self.chain = chain
        self.metadata = metadata if metadata is not None else types.Metadata()
        self.seq_number = 0

    # -- payload producers (SSZ objects in, SSZ objects out) -----------------

    def local_status(self):
        chain = self.chain
        fin_epoch, fin_root = chain.finalized_checkpoint
        genesis_root = b"\x00" * 32
        return self.types.Status(
            fork_digest=self.config.fork_digest(
                self.config.get_fork_name_at_slot(chain.head_state.state.slot)
            ),
            finalized_root=fin_root if fin_epoch > 0 else genesis_root,
            finalized_epoch=fin_epoch,
            head_root=chain.head_root,
            head_slot=chain.head_state.state.slot,
        )

    def on_status(self, request) -> bytes:
        return encode_response_chunk(self.local_status().serialize())

    def on_ping(self, request) -> bytes:
        from ...ssz import uint64

        return encode_response_chunk(uint64.serialize(self.seq_number))

    def on_metadata(self, request) -> bytes:
        return encode_response_chunk(self.metadata.serialize())

    def on_goodbye(self, request) -> bytes:
        from ...ssz import uint64

        return encode_response_chunk(uint64.serialize(0))

    def on_beacon_blocks_by_range(self, start_slot: int, count: int) -> bytes:
        """Stream canonical blocks in [start_slot, start_slot+count) —
        archived (finalized) first, then hot chain blocks."""
        if count < 1 or count > MAX_REQUEST_BLOCKS:
            return encode_error_chunk(RespCode.INVALID_REQUEST, "bad count")
        chain = self.chain
        out = bytearray()
        end_slot = start_slot + count
        # archived range (slot-ordered repository scan)
        for key in chain.db.block_archive.keys_stream():
            slot = int.from_bytes(key, "big")
            if start_slot <= slot < end_slot:
                raw = chain.db.block_archive.get_binary(key)
                out += encode_response_chunk(raw)
        # hot canonical chain via fork choice ancestry from head
        hot = []
        for node in chain.fork_choice.proto.iter_ancestors(chain.head_root):
            if start_slot <= node.slot < end_slot:
                signed = chain.blocks.get(node.root)
                if signed is not None:
                    hot.append(signed)
        for signed in reversed(hot):  # ascending slot order
            out += encode_response_chunk(signed.serialize())
        return bytes(out)

    # -- light client server protocols (reference reqresp/types.ts:55-67) ---

    def _lc_server(self):
        return getattr(self.chain, "light_client_server", None)

    def on_light_client_bootstrap(self, block_root: bytes) -> bytes:
        lc = self._lc_server()
        bootstrap = lc.get_bootstrap(block_root) if lc is not None else None
        if bootstrap is None:
            return encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "no bootstrap")
        return encode_response_chunk(bootstrap.serialize())

    def on_light_client_updates_by_range(self, start_period: int, count: int) -> bytes:
        lc = self._lc_server()
        if lc is None or count < 1 or count > 128:
            return encode_error_chunk(RespCode.INVALID_REQUEST, "bad range")
        out = bytearray()
        for update in lc.get_updates(start_period, count):
            out += encode_response_chunk(update.serialize())
        return bytes(out)

    def on_light_client_finality_update(self) -> bytes:
        lc = self._lc_server()
        update = getattr(lc, "latest_finality_update", None) if lc is not None else None
        if update is None:
            return encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "none yet")
        return encode_response_chunk(update.serialize())

    def on_light_client_optimistic_update(self) -> bytes:
        lc = self._lc_server()
        update = getattr(lc, "latest_optimistic_update", None) if lc is not None else None
        if update is None:
            return encode_error_chunk(RespCode.RESOURCE_UNAVAILABLE, "none yet")
        return encode_response_chunk(update.serialize())

    def on_beacon_blocks_by_root(self, roots: list[bytes]) -> bytes:
        if len(roots) > MAX_REQUEST_BLOCKS:
            return encode_error_chunk(RespCode.INVALID_REQUEST, "too many roots")
        chain = self.chain
        out = bytearray()
        for root in roots:
            signed = chain.blocks.get(root) or chain.finalized_blocks.get(root)
            if signed is None:
                signed = chain.db.get_archived_block_by_root(root)
            if signed is not None:
                out += encode_response_chunk(signed.serialize())
        return bytes(out)
