"""Server-side implementation of the Beacon API against a BeaconChain.

Reference: `beacon-node/src/api/impl/` — the same separation: route
handlers take parsed params and return JSON-able dicts; SSZ containers
cross the boundary via to_obj/from_obj (the reference's json types).

The port's copy of the JAX package's `api/impl.py`: the same routes and
JSON shapes, and the same version string, so the two serve equal bodies.
"""

from __future__ import annotations



class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class BeaconApiImpl:
    VERSION = "lodestar-tpu/0.1.0"

    def __init__(self, config, types, chain, validator_service=None):
        self.config = config
        self.types = types
        self.chain = chain
        self.validator_service = validator_service

    # -- state resolution ----------------------------------------------------

    def _resolve_state(self, state_id: str):
        chain = self.chain
        if state_id == "head":
            return chain.head_state
        if state_id == "finalized":
            _, root = chain.finalized_checkpoint
            st = chain.state_cache.get_by_block_root(root)
            if st is None:
                raise ApiError(404, "finalized state not in hot cache")
            return st
        if state_id == "genesis":
            raise ApiError(501, "genesis state queries not retained")
        if state_id.startswith("0x"):
            st = chain.state_cache.get(bytes.fromhex(state_id[2:]))
            if st is None:
                raise ApiError(404, "state not found")
            return st
        raise ApiError(400, f"unsupported state_id {state_id}")

    def _resolve_block(self, block_id: str):
        chain = self.chain
        if block_id == "head":
            root = chain.head_root
        elif block_id == "finalized":
            _, root = chain.finalized_checkpoint
        elif block_id.startswith("0x"):
            root = bytes.fromhex(block_id[2:])
        else:
            raise ApiError(400, f"unsupported block_id {block_id}")
        signed = chain.blocks.get(root) or chain.finalized_blocks.get(root)
        if signed is None:
            signed = self.chain.db.get_archived_block_by_root(root)
        if signed is None:
            raise ApiError(404, "block not found")
        return root, signed

    # -- beacon --------------------------------------------------------------

    def getGenesis(self, params, query, body):
        state = self.chain.head_state.state
        return {
            "genesis_time": str(state.genesis_time),
            "genesis_validators_root": "0x" + bytes(state.genesis_validators_root).hex(),
            "genesis_fork_version": "0x" + self.config.GENESIS_FORK_VERSION.hex(),
        }

    def getStateRoot(self, params, query, body):
        st = self._resolve_state(params["state_id"])
        return {"root": "0x" + st.state.hash_tree_root().hex()}

    def getStateFinalityCheckpoints(self, params, query, body):
        st = self._resolve_state(params["state_id"]).state
        cp = lambda c: {"epoch": str(c.epoch), "root": "0x" + bytes(c.root).hex()}
        return {
            "previous_justified": cp(st.previous_justified_checkpoint),
            "current_justified": cp(st.current_justified_checkpoint),
            "finalized": cp(st.finalized_checkpoint),
        }

    def _validator_entry(self, st, idx: int):
        v = st.state.validators[idx]
        return {
            "index": str(idx),
            "balance": str(st.state.balances[idx]),
            "status": _validator_status(v, st.current_epoch),
            "validator": v.to_obj(),
        }

    def getStateValidators(self, params, query, body):
        st = self._resolve_state(params["state_id"])
        return [self._validator_entry(st, i) for i in range(len(st.state.validators))]

    def getStateValidator(self, params, query, body):
        st = self._resolve_state(params["state_id"])
        vid = params["validator_id"]
        if vid.startswith("0x"):
            idx = st.epoch_ctx.pubkey_to_index.get(bytes.fromhex(vid[2:]))
            if idx is None:
                raise ApiError(404, "unknown pubkey")
        else:
            idx = int(vid)
            if idx >= len(st.state.validators):
                raise ApiError(404, "index out of range")
        return self._validator_entry(st, idx)

    def getBlockHeader(self, params, query, body):
        root, signed = self._resolve_block(params["block_id"])
        msg = signed.message
        return {
            "root": "0x" + root.hex(),
            "canonical": True,
            "header": {
                "message": {
                    "slot": str(msg.slot),
                    "proposer_index": str(msg.proposer_index),
                    "parent_root": "0x" + bytes(msg.parent_root).hex(),
                    "state_root": "0x" + bytes(msg.state_root).hex(),
                    "body_root": "0x" + msg.body.hash_tree_root().hex(),
                },
                "signature": "0x" + bytes(signed.signature).hex(),
            },
        }

    def getBlockV2(self, params, query, body):
        _, signed = self._resolve_block(params["block_id"])
        version = self.config.get_fork_name_at_slot(signed.message.slot)
        return {"version": version, "data": signed.to_obj()}

    def getBlockRoot(self, params, query, body):
        root, _ = self._resolve_block(params["block_id"])
        return {"root": "0x" + root.hex()}

    def publishBlock(self, params, query, body):
        # decode with the fork's container for the block's slot (the wire
        # shape changes across forks)
        from ..types import get_types

        slot = int(body["message"]["slot"])
        fork = self.config.get_fork_name_at_slot(slot)
        types = get_types(self.config.preset).by_fork.get(fork, self.types)
        signed = types.SignedBeaconBlock.from_obj(body)
        self.chain.process_block(signed)
        return None

    def submitPoolAttestations(self, params, query, body):
        errors = []
        for i, obj in enumerate(body):
            try:
                att = self.types.Attestation.from_obj(obj)
                self.chain.on_aggregated_attestation(
                    att, att.data.hash_tree_root()
                )
            except Exception as e:  # collect per-item failures like the spec
                errors.append({"index": i, "message": str(e)})
        if errors:
            raise ApiError(400, f"{len(errors)} attestations failed")
        return None

    def submitPoolVoluntaryExit(self, params, query, body):
        """Validated like the gossip path (an
        unvalidated REST submission could poison the pool and invalidate
        the next produced block; reference runs the same validation in
        the pool API)."""
        from ..chain.validation import GossipAction, validate_gossip_voluntary_exit

        exit_ = self.types.SignedVoluntaryExit.from_obj(body)
        result = validate_gossip_voluntary_exit(self.chain, self.types, exit_)
        if result.action is GossipAction.REJECT:
            raise ApiError(400, f"invalid voluntary exit: {result.reason}")
        if result.action is GossipAction.ACCEPT:
            self.chain.op_pool.add_voluntary_exit(exit_)
        return None

    def submitPoolProposerSlashings(self, params, query, body):
        from ..chain.validation import (
            GossipAction,
            validate_gossip_proposer_slashing,
        )

        slashing = self.types.ProposerSlashing.from_obj(body)
        result = validate_gossip_proposer_slashing(self.chain, self.types, slashing)
        if result.action is GossipAction.REJECT:
            raise ApiError(400, f"invalid proposer slashing: {result.reason}")
        if result.action is GossipAction.ACCEPT:
            self.chain.op_pool.add_proposer_slashing(slashing)
        return None

    def submitPoolAttesterSlashings(self, params, query, body):
        from ..chain.validation import (
            GossipAction,
            validate_gossip_attester_slashing,
        )

        slashing = self.types.AttesterSlashing.from_obj(body)
        result = validate_gossip_attester_slashing(self.chain, self.types, slashing)
        if result.action is GossipAction.REJECT:
            raise ApiError(400, f"invalid attester slashing: {result.reason}")
        if result.action is GossipAction.ACCEPT:
            self.chain.op_pool.add_attester_slashing(slashing)
        return None

    def prepareBeaconProposer(self, params, query, body):
        """Fee-recipient registrations ahead of proposals (validator.ts
        prepareBeaconProposer → beaconProposerCache)."""
        epoch = self.chain.clock.current_epoch
        for entry in body or []:
            try:
                fee_recipient = bytes.fromhex(
                    entry["fee_recipient"].removeprefix("0x")
                )
                index = int(entry["validator_index"])
            except (KeyError, ValueError, AttributeError, TypeError) as e:
                raise ApiError(400, f"malformed preparation: {e}")
            if len(fee_recipient) != 20:
                raise ApiError(400, "fee_recipient must be 20 bytes")
            self.chain.beacon_proposer_cache.add(epoch, index, fee_recipient)
        return None

    def getPoolProposerSlashings(self, params, query, body):
        return [s.to_obj() for s in list(self.chain.op_pool.proposer_slashings.values())]

    def getPoolAttesterSlashings(self, params, query, body):
        return [s.to_obj() for s in list(self.chain.op_pool.attester_slashings)]

    # -- node ----------------------------------------------------------------

    def getNodeVersion(self, params, query, body):
        return {"version": self.VERSION}

    def getNodeIdentity(self, params, query, body):
        """Peer id + shareable ENR of the attached network (routes/node.ts
        getNetworkIdentity)."""
        network = getattr(self, "network", None)
        if network is None:
            return {"peer_id": "", "enr": "", "p2p_addresses": []}
        enr_text = ""
        if network.discovery is not None:
            from ..network.discovery import enr_to_text

            enr_text = enr_to_text(network.discovery.local_enr)
        addr = network.transport.listen_addr
        return {
            "peer_id": network.peer_id,
            "enr": enr_text,
            "p2p_addresses": [f"{addr[0]}:{addr[1]}"] if addr else [],
        }

    def getNodePeers(self, params, query, body):
        network = getattr(self, "network", None)
        if network is None:
            return []
        out = []
        for pid, info in network.peer_manager.peers.items():
            out.append(
                {
                    "peer_id": pid,
                    "state": "connected" if pid in network.transport.connections else "disconnected",
                    "direction": info.direction,
                }
            )
        return out

    def getSyncingStatus(self, params, query, body):
        head_slot = self.chain.head_state.state.slot
        clock_slot = self.chain.clock.current_slot
        return {
            "head_slot": str(head_slot),
            "sync_distance": str(max(0, clock_slot - head_slot)),
            "is_syncing": clock_slot > head_slot + 1,
            "is_optimistic": False,
        }

    def getHealth(self, params, query, body):
        return None  # 200

    # -- config --------------------------------------------------------------

    def getSpec(self, params, query, body):
        p = self.config.preset
        return {
            "SECONDS_PER_SLOT": str(self.config.SECONDS_PER_SLOT),
            "SLOTS_PER_EPOCH": str(p.SLOTS_PER_EPOCH),
            "MAX_EFFECTIVE_BALANCE": str(p.MAX_EFFECTIVE_BALANCE),
            "PRESET_BASE": p.PRESET_BASE,
            "DEPOSIT_CONTRACT_ADDRESS": "0x" + "00" * 20,
        }

    def getDepositContract(self, params, query, body):
        return {"chain_id": "1", "address": "0x" + "00" * 20}

    # -- validator -----------------------------------------------------------

    def getAttesterDuties(self, params, query, body):
        """Committee assignments for the requested validator indices,
        computed from the head epoch context (reference
        getAttesterDuties → getCommitteeAssignments)."""
        epoch = int(params["epoch"])
        wanted = {int(i) for i in body} if body else None
        st = self.chain.head_state
        ctx = st.epoch_ctx
        spe = self.config.preset.SLOTS_PER_EPOCH
        out = []
        try:
            count = ctx.get_committee_count_per_slot(epoch)
        except ValueError:
            raise ApiError(400, f"epoch {epoch} outside cached shuffling range")
        for slot in range(epoch * spe, (epoch + 1) * spe):
            for cidx in range(count):
                committee = ctx.get_beacon_committee(slot, cidx)
                for pos, vidx in enumerate(committee):
                    vidx = int(vidx)
                    if wanted is not None and vidx not in wanted:
                        continue
                    out.append(
                        {
                            "pubkey": "0x" + bytes(st.flat.pubkeys[vidx]).hex(),
                            "validator_index": str(vidx),
                            "committee_index": str(cidx),
                            "committee_length": str(len(committee)),
                            "committees_at_slot": str(count),
                            "validator_committee_index": str(pos),
                            "slot": str(slot),
                        }
                    )
        return out

    def getProposerDuties(self, params, query, body):
        st = self.chain.head_state
        epoch = int(params["epoch"])
        spe = self.config.preset.SLOTS_PER_EPOCH
        if epoch != st.epoch_ctx.current_epoch:
            # duties may be requested before the head crosses the epoch
            # boundary: advance a copy (reference: regen + proposer cache;
            # the prepared next-slot state usually makes this cheap)
            prepared = self.chain.prepare_next_slot.get_prepared(
                epoch * spe, self.chain.head_root
            )
            if prepared is not None:
                st = prepared
            elif epoch == st.epoch_ctx.current_epoch + 1:
                from ..state_transition import process_slots

                st = st.copy()
                process_slots(st, self.types, epoch * spe)
            else:
                raise ApiError(400, f"epoch {epoch} not derivable from head")
        ctx = st.epoch_ctx
        out = []
        for i, proposer in enumerate(ctx.proposers):
            pk = st.flat.pubkeys[proposer]
            out.append(
                {
                    "pubkey": "0x" + bytes(pk).hex(),
                    "validator_index": str(proposer),
                    "slot": str(epoch * spe + i),
                }
            )
        return out

    def produceBlockV2(self, params, query, body):
        slot = int(params["slot"])
        reveal = bytes.fromhex(query.get("randao_reveal", "")[2:])
        block = self.chain.produce_block(slot, randao_reveal=reveal)
        version = self.config.get_fork_name_at_slot(slot)
        return {"version": version, "data": block.to_obj()}

    def produceAttestationData(self, params, query, body):
        slot = int(query["slot"])
        index = int(query["committee_index"])
        st = self.chain.head_state
        epoch = slot // self.config.preset.SLOTS_PER_EPOCH
        start = epoch * self.config.preset.SLOTS_PER_EPOCH
        head_root = self.chain.head_root
        if start == st.state.slot:
            target_root = head_root
        else:
            target_root = bytes(
                st.state.block_roots[
                    start % self.config.preset.SLOTS_PER_HISTORICAL_ROOT
                ]
            )
        data = self.types.AttestationData(
            slot=slot,
            index=index,
            beacon_block_root=head_root,
            source=st.state.current_justified_checkpoint.copy(),
            target=self.types.Checkpoint(epoch=epoch, root=target_root),
        )
        return data.to_obj()

    def getAggregatedAttestation(self, params, query, body):
        slot = int(query["slot"])
        data_root = bytes.fromhex(query["attestation_data_root"][2:])
        got = self.chain.attestation_pool.get_aggregate(slot, data_root)
        if got is None:
            raise ApiError(404, "no aggregate for data root")
        data, bits, sig = got
        att = self.types.Attestation(
            aggregation_bits=bits, data=data.copy(), signature=sig.to_bytes()
        )
        return att.to_obj()

    def publishAggregateAndProofs(self, params, query, body):
        for obj in body:
            signed = self.types.SignedAggregateAndProof.from_obj(obj)
            agg = signed.message.aggregate
            self.chain.on_aggregated_attestation(agg, agg.data.hash_tree_root())
        return None

    def getLiveness(self, params, query, body):
        """Per-epoch liveness from the seen-caches (reference: lodestar's
        /eth/v1/validator/liveness used by doppelganger protection)."""
        epoch = int(params["epoch"])
        out = []
        for idx in body or []:
            idx = int(idx)
            live = self.chain.seen_attesters.is_known(epoch, idx)
            if not live:
                spe = self.config.preset.SLOTS_PER_EPOCH
                live = any(
                    self.chain.seen_block_proposers.is_known(slot, idx)
                    for slot in range(epoch * spe, (epoch + 1) * spe)
                )
            out.append({"index": str(idx), "is_live": live})
        return out

    # -- light client (reference routes/lightclient.ts over the chain's
    # LightClientServer) ------------------------------------------------------

    def getLightClientBootstrap(self, params, query, body):
        root = bytes.fromhex(params["block_root"].removeprefix("0x"))
        boot = self.chain.light_client_server.get_bootstrap(root)
        if boot is None:
            raise ApiError(404, "no bootstrap for block root")
        return boot.to_obj()

    def getLightClientUpdatesByRange(self, params, query, body):
        start = int(query.get("start_period", 0))
        count = min(int(query.get("count", 1)), 128)
        return [u.to_obj() for u in self.chain.light_client_server.get_updates(start, count)]

    def getLightClientFinalityUpdate(self, params, query, body):
        update = getattr(self.chain.light_client_server, "latest_finality_update", None)
        if update is None:
            raise ApiError(404, "no finality update available")
        return update.to_obj()

    def getLightClientOptimisticUpdate(self, params, query, body):
        update = getattr(self.chain.light_client_server, "latest_optimistic_update", None)
        if update is None:
            raise ApiError(404, "no optimistic update available")
        return update.to_obj()

    # -- debug ---------------------------------------------------------------

    def getStateV2(self, params, query, body):
        """Full SSZ state, hex-wrapped in JSON (reference serves
        application/octet-stream; same bytes either way). Checkpoint sync
        downloads its anchor through this route."""
        # serialize a private copy: sync_flat() writes flat columns back into
        # the state, and the live head may be mid-transition on another thread
        st = self._resolve_state(params["state_id"]).copy()
        st.sync_flat()
        return {
            "version": st.fork,
            "ssz": "0x" + type(st.state).ssz_type.serialize(st.state).hex(),
        }

    def getDebugChainHeadsV2(self, params, query, body):
        out = []
        for node in self.chain.fork_choice.proto.nodes:
            if node.best_child is None:
                out.append(
                    {
                        "slot": str(node.slot),
                        "root": "0x" + node.root.hex(),
                        "execution_optimistic": node.execution_status == "syncing",
                    }
                )
        return out


def _validator_status(v, epoch: int) -> str:
    """Condensed validator status (spec status taxonomy)."""
    from ..params import FAR_FUTURE_EPOCH

    if v.activation_epoch > epoch:
        return (
            "pending_queued"
            if v.activation_eligibility_epoch != FAR_FUTURE_EPOCH
            else "pending_initialized"
        )
    if epoch < v.exit_epoch:
        return "active_slashed" if v.slashed else "active_ongoing"
    if epoch < v.withdrawable_epoch:
        return "exited_slashed" if v.slashed else "exited_unslashed"
    return "withdrawal_possible"
