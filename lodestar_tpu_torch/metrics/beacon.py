"""Beacon metric set: the interop-standard gauges plus the lodestar-
specific BLS-pool/block-processor metrics our services emit.

The port's copy of the JAX package's `metrics/beacon.py`: every family
with its name, help, labels and buckets. The batching facades' seven
`lodestar_bls_verifier_*` families come from `metrics/bls.py` (declared
once, so a stack built over this registry reuses them), and `pipeline`
is the port's `PipelineMetrics` on the same registry.

Reference: `metrics/metrics/beacon.ts` (official interop names) and
`metrics/metrics/lodestar.ts` (lodestar_* namespace; blsThreadPool.* at
:412 — mapped here to the device-verifier equivalents).
"""

from __future__ import annotations

from .bls import create_bls_metrics
from .registry import MetricsRegistry


def create_beacon_metrics(registry: MetricsRegistry | None = None):
    r = registry if registry is not None else MetricsRegistry()

    class M:
        pass

    m = M()
    m.registry = r
    bls = create_bls_metrics(r)
    # interop-standard (beacon.ts)
    m.head_slot = r.gauge("beacon_head_slot", "slot of the chain head")
    m.finalized_epoch = r.gauge("beacon_finalized_epoch", "latest finalized epoch")
    m.current_justified_epoch = r.gauge(
        "beacon_current_justified_epoch", "current justified epoch"
    )
    m.proposed_blocks_total = r.counter(
        "beacon_blocks_proposed_total", "blocks proposed by this node"
    )
    m.processed_blocks_total = r.counter(
        "beacon_processed_blocks_total", "blocks imported"
    )
    m.gossip_attestations_total = r.counter(
        "beacon_gossip_attestation_total", "gossip attestations by outcome",
        label_names=("outcome",),
    )
    # lodestar_* equivalents (lodestar.ts) — the device verifier pool
    m.bls_batches_total = bls.bls_batches_total
    m.bls_sets_total = bls.bls_sets_total
    m.bls_batch_fallbacks_total = bls.bls_batch_fallbacks_total
    m.bls_verify_seconds = r.histogram(
        "lodestar_bls_verifier_seconds", "device batch verification latency"
    )
    m.block_import_seconds = r.histogram(
        "lodestar_block_processor_import_seconds", "block import pipeline latency"
    )
    m.state_cache_size = r.gauge("lodestar_state_cache_size", "hot states cached")
    m.fork_choice_nodes = r.gauge(
        "lodestar_fork_choice_nodes", "proto-array node count"
    )
    # network (gossipsub / reqresp / discovery — reference lodestar.ts
    # gossipsub.* / reqResp.* metric families)
    m.peers_connected = r.gauge("lodestar_peers_connected", "live transport connections")
    m.gossip_mesh_peers = r.gauge(
        "lodestar_gossip_mesh_peers", "mesh size per topic kind",
        label_names=("kind",),
    )
    m.gossip_rx_total = r.counter(
        "lodestar_gossip_messages_received_total", "gossip messages received by outcome",
        label_names=("outcome",),
    )
    m.gossip_tx_total = r.counter(
        "lodestar_gossip_messages_sent_total", "gossip messages published"
    )
    m.gossip_queue_length = r.gauge(
        "lodestar_gossip_validation_queue_length", "validation queue depth",
        label_names=("topic",),
    )
    m.gossip_queue_dropped_total = r.counter(
        "lodestar_gossip_validation_queue_dropped_total", "jobs dropped at full queues",
        label_names=("topic",),
    )
    m.reqresp_seconds = r.histogram(
        "lodestar_reqresp_request_seconds", "outbound req/resp latency",
        label_names=("protocol",),
    )
    m.discovery_table_size = r.gauge(
        "lodestar_discovery_table_size", "routing table entries"
    )

    # --- discv5 detail (reference lodestar_discv5_* dashboard families) --
    m.discv5_rx_total = r.counter(
        "lodestar_discv5_messages_received_total",
        "discovery packets handled by type",
        label_names=("type",),
    )
    m.discv5_tx_total = r.counter(
        "lodestar_discv5_messages_sent_total",
        "discovery packets sent by type",
        label_names=("type",),
    )
    m.discv5_endpoint_proofs = r.gauge(
        "lodestar_discv5_endpoint_proofs",
        "peers with a completed endpoint proof (anti-reflection)",
    )
    m.discv5_pending_challenges = r.gauge(
        "lodestar_discv5_pending_challenges",
        "FINDNODE challenges awaiting their PONG",
    )
    m.discv5_challenge_drops_total = r.counter(
        "lodestar_discv5_challenge_drops_total",
        "challenge pings refused by the token bucket / live-challenge cap",
    )
    m.discv5_lookups_total = r.counter(
        "lodestar_discv5_lookups_total", "recursive FINDNODE lookups started"
    )
    m.discv5_liveness_evictions_total = r.counter(
        "lodestar_discv5_liveness_evictions_total",
        "table entries evicted by failed liveness pings",
    )

    # --- BLS verifier pipeline (reference blsThreadPool.* lodestar.ts:412+;
    # the "zero backlog" dashboard rows) ----------------------------------
    m.bls_buffer_depth = bls.bls_buffer_depth
    m.bls_buffer_wait_seconds = bls.bls_buffer_wait_seconds
    m.bls_job_sets = bls.bls_job_sets
    m.bls_marshal_seconds = r.histogram(
        "lodestar_bls_verifier_marshal_seconds", "host marshalling latency per batch"
    )
    m.bls_h2c_cache_hits_total = r.counter(
        "lodestar_bls_verifier_h2c_cache_hits_total", "hash-to-curve cache hits"
    )
    m.bls_h2c_cache_misses_total = r.counter(
        "lodestar_bls_verifier_h2c_cache_misses_total", "hash-to-curve cache misses"
    )
    m.bls_main_thread_sets_total = bls.bls_main_thread_sets_total

    # --- block processor stages (reference lodestar.ts blockProcessor.* +
    # verifyBlock stage timers) ------------------------------------------
    m.block_stf_seconds = r.histogram(
        "lodestar_block_processor_stf_seconds", "state transition latency"
    )
    m.block_sig_seconds = r.histogram(
        "lodestar_block_processor_signatures_seconds",
        "block signature batch latency",
    )
    m.block_payload_seconds = r.histogram(
        "lodestar_block_processor_payload_seconds",
        "execution payload verification latency",
    )
    m.block_import_errors_total = r.counter(
        "lodestar_block_processor_errors_total", "failed imports by reason",
        label_names=("reason",),
    )
    m.blocking_wait_timeouts_total = r.counter(
        "lodestar_chain_blocking_wait_timeouts_total",
        "serving-path future waits that hit LODESTAR_TPU_IMPORT_WAIT_TIMEOUT",
        label_names=("site",),
    )

    # --- regen / caches (reference regen.* stateCache.*) ----------------
    m.regen_replays_total = r.counter(
        "lodestar_regen_replays_total", "state replays (cache misses)"
    )
    m.regen_queue_pending = r.gauge(
        "lodestar_regen_queue_pending", "pending replay requests"
    )
    m.regen_rejections_total = r.counter(
        "lodestar_regen_rejections_total", "replays rejected at the 256 bound"
    )
    m.state_cache_hits_total = r.counter(
        "lodestar_state_cache_hits_total", "hot state cache hits"
    )
    m.state_cache_misses_total = r.counter(
        "lodestar_state_cache_misses_total", "hot state cache misses"
    )
    m.checkpoint_cache_size = r.gauge(
        "lodestar_checkpoint_state_cache_size", "checkpoint states cached"
    )

    # --- op pools (reference opPool.*) ----------------------------------
    m.op_pool_size = r.gauge(
        "lodestar_op_pool_size", "pool entry count by kind",
        label_names=("kind",),
    )

    # --- sync (reference sync.* backfill.*) -----------------------------
    m.sync_range_batches_total = r.counter(
        "lodestar_sync_range_batches_total", "range-sync batches by outcome",
        label_names=("outcome",),
    )
    m.sync_unknown_block_fetches_total = r.counter(
        "lodestar_sync_unknown_block_fetches_total", "unknown-block root fetches"
    )
    m.backfill_slot = r.gauge(
        "lodestar_backfill_earliest_slot", "earliest backfilled slot"
    )

    # --- db / storage engine (reference db.* + native kvstore stats) ----
    m.db_ops_total = r.counter(
        "lodestar_db_ops_total", "db operations by kind",
        label_names=("op",),
    )
    m.db_entries = r.gauge("lodestar_db_entries", "KV entries")
    m.db_live_bytes = r.gauge("lodestar_db_live_bytes", "live bytes on disk")
    m.db_dead_bytes = r.gauge(
        "lodestar_db_dead_bytes", "dead bytes awaiting compaction"
    )

    # --- eth1 (reference eth1.*) ----------------------------------------
    m.eth1_deposits_total = r.counter(
        "lodestar_eth1_deposit_logs_total", "deposit logs ingested"
    )
    m.eth1_synced_block = r.gauge(
        "lodestar_eth1_synced_block", "latest eth1 block ingested"
    )
    m.eth1_request_errors_total = r.counter(
        "lodestar_eth1_request_errors_total", "eth1 RPC failures"
    )

    # --- clock / validator interop extras (beacon.ts) -------------------
    m.clock_slot = r.gauge("beacon_clock_slot", "wall-clock slot")
    m.reorgs_total = r.counter("beacon_reorgs_total", "head reorg events")
    m.head_root_changes_total = r.counter(
        "beacon_head_changes_total", "head updates"
    )
    m.proposer_boost_active = r.gauge(
        "lodestar_fork_choice_proposer_boost_active",
        "1 while a proposer boost is applied",
    )
    m.fork_choice_votes = r.gauge(
        "lodestar_fork_choice_tracked_votes", "validators with live LMD votes"
    )

    # --- gossipsub detail (reference lodestar.ts gossipsub.* — per-topic
    # accept/reject/ignore, control traffic, mesh churn, score buckets) ---
    m.gossip_validation_total = r.counter(
        "lodestar_gossip_validation_total",
        "validation results per topic kind",
        label_names=("kind", "outcome"),
    )
    m.gossip_duplicates_total = r.counter(
        "lodestar_gossip_duplicate_messages_total",
        "messages already seen (dropped pre-validation)",
    )
    m.gossip_graft_rx_total = r.counter(
        "lodestar_gossip_graft_received_total", "GRAFT control messages received"
    )
    m.gossip_prune_rx_total = r.counter(
        "lodestar_gossip_prune_received_total", "PRUNE control messages received"
    )
    m.gossip_ihave_rx_total = r.counter(
        "lodestar_gossip_ihave_received_total", "IHAVE ids advertised to us"
    )
    m.gossip_iwant_rx_total = r.counter(
        "lodestar_gossip_iwant_received_total", "IWANT ids requested from us"
    )
    m.gossip_iwant_served_total = r.counter(
        "lodestar_gossip_iwant_served_total", "IWANT ids answered from mcache"
    )
    m.gossip_iwant_budget_drops_total = r.counter(
        "lodestar_gossip_iwant_budget_drops_total",
        "IWANT ids dropped by the per-peer budget/score gate",
    )
    m.gossip_peers_by_score = r.gauge(
        "lodestar_gossip_peers_by_score",
        "peer count per score band",
        label_names=("band",),
    )
    m.gossip_score_min = r.gauge(
        "lodestar_gossip_peer_score_min", "lowest peer score"
    )
    m.gossip_score_max = r.gauge(
        "lodestar_gossip_peer_score_max", "highest peer score"
    )
    m.gossip_mesh_churn_total = r.counter(
        "lodestar_gossip_mesh_churn_total",
        "mesh membership changes",
        label_names=("direction",),
    )
    m.gossip_validation_seconds = r.histogram(
        "lodestar_gossip_validation_seconds",
        "validator latency per topic kind",
        label_names=("kind",),
    )

    # --- reqresp detail (reference lodestar.ts reqResp.* — per-protocol
    # request/byte/error counters, rate limits) ---------------------------
    m.reqresp_incoming_requests_total = r.counter(
        "lodestar_reqresp_incoming_requests_total",
        "inbound requests per protocol",
        label_names=("protocol",),
    )
    m.reqresp_incoming_errors_total = r.counter(
        "lodestar_reqresp_incoming_errors_total",
        "inbound requests that errored per protocol",
        label_names=("protocol",),
    )
    m.reqresp_outgoing_requests_total = r.counter(
        "lodestar_reqresp_outgoing_requests_total",
        "outbound requests per protocol",
        label_names=("protocol",),
    )
    m.reqresp_outgoing_errors_total = r.counter(
        "lodestar_reqresp_outgoing_errors_total",
        "outbound requests that errored per protocol",
        label_names=("protocol",),
    )
    m.reqresp_bytes_sent_total = r.counter(
        "lodestar_reqresp_bytes_sent_total",
        "response bytes written per protocol",
        label_names=("protocol",),
    )
    m.reqresp_bytes_received_total = r.counter(
        "lodestar_reqresp_bytes_received_total",
        "response bytes read per protocol",
        label_names=("protocol",),
    )
    m.reqresp_rate_limited_total = r.counter(
        "lodestar_reqresp_rate_limited_total",
        "requests refused by rate limiters",
        label_names=("limiter",),
    )
    m.reqresp_response_chunks_total = r.counter(
        "lodestar_reqresp_response_chunks_total",
        "response chunks received per result code",
        label_names=("code",),
    )

    # --- sync detail (reference lodestar.ts sync.* — batch states,
    # processed-block rate, peer counts per sync kind) --------------------
    m.sync_batches_in_state = r.gauge(
        "lodestar_sync_batches_in_state",
        "range-sync batches per state",
        label_names=("state",),
    )
    m.sync_blocks_imported_total = r.counter(
        "lodestar_sync_blocks_imported_total", "blocks imported by range sync"
    )
    m.sync_segment_seconds = r.histogram(
        "lodestar_sync_segment_import_seconds", "segment import latency"
    )
    m.sync_peers = r.gauge(
        "lodestar_sync_peers", "peers usable per sync kind",
        label_names=("kind",),
    )
    m.sync_status = r.gauge(
        "lodestar_sync_status", "0 stalled / 1 syncing / 2 synced"
    )
    m.backfill_batches_total = r.counter(
        "lodestar_backfill_batches_total", "backfill batches by outcome",
        label_names=("outcome",),
    )

    # --- eth1 detail (reference lodestar.ts eth1.*) ----------------------
    m.eth1_follow_distance = r.gauge(
        "lodestar_eth1_follow_distance_blocks",
        "blocks between eth1 head and our synced block",
    )
    m.eth1_request_seconds = r.histogram(
        "lodestar_eth1_request_seconds", "eth1 JSON-RPC latency",
        label_names=("method",),
    )
    m.eth1_logs_batch_size = r.histogram(
        "lodestar_eth1_logs_batch_size", "deposit logs per getLogs window"
    )

    # --- execution engine (reference lodestar.ts executionEngine.*) ------
    m.engine_requests_total = r.counter(
        "lodestar_engine_http_requests_total",
        "engine API calls by method and outcome",
        label_names=("method", "outcome"),
    )
    m.engine_request_seconds = r.histogram(
        "lodestar_engine_http_seconds", "engine API latency",
        label_names=("method",),
    )
    m.engine_payload_status_total = r.counter(
        "lodestar_engine_payload_status_total",
        "newPayload verdicts",
        label_names=("status",),
    )

    # --- REST API server (reference lodestar.ts restApi.*) ---------------
    m.api_requests_total = r.counter(
        "lodestar_api_requests_total",
        "REST requests by namespace and status class",
        label_names=("namespace", "status"),
    )
    m.api_request_seconds = r.histogram(
        "lodestar_api_request_seconds", "REST handler latency",
        label_names=("namespace",),
    )
    m.api_sse_subscribers = r.gauge(
        "lodestar_api_sse_subscribers", "open event-stream connections"
    )

    # --- chain internals (epoch transitions, caches, archiver) -----------
    m.epoch_transition_seconds = r.histogram(
        "lodestar_stfn_epoch_transition_seconds", "epoch processing latency"
    )
    m.state_hash_seconds = r.histogram(
        "lodestar_stfn_hash_tree_root_seconds",
        "incremental state hashing latency",
    )
    m.state_hash_dirty_validators = r.histogram(
        "lodestar_stfn_hash_dirty_validators",
        "validator rows re-hashed per state root",
    )
    m.shuffling_cache_hits_total = r.counter(
        "lodestar_shuffling_cache_hits_total", "epoch shuffling cache hits"
    )
    m.shuffling_cache_misses_total = r.counter(
        "lodestar_shuffling_cache_misses_total", "epoch shuffling cache builds"
    )
    m.attestation_pool_inserts_total = r.counter(
        "lodestar_attestation_pool_inserts_total",
        "attestation pool insert outcomes",
        label_names=("outcome",),
    )
    m.archiver_states_total = r.counter(
        "lodestar_archiver_states_written_total", "states archived"
    )
    m.archiver_blocks_total = r.counter(
        "lodestar_archiver_blocks_migrated_total",
        "finalized blocks migrated to cold storage",
    )
    m.seen_cache_size = r.gauge(
        "lodestar_seen_cache_size", "entries per seen-cache kind",
        label_names=("kind",),
    )

    # --- validator client (reference lodestar.ts validator.*) ------------
    m.vc_duties_total = r.counter(
        "lodestar_vc_duties_total", "duties performed by kind and outcome",
        label_names=("kind", "outcome"),
    )
    m.vc_signer_seconds = r.histogram(
        "lodestar_vc_signer_seconds", "signing latency",
        label_names=("kind",),
    )

    # --- process health (reference nodejs.* equivalents) -----------------
    m.event_loop_lag_seconds = r.gauge(
        "lodestar_event_loop_lag_seconds", "asyncio scheduling lag"
    )
    m.process_rss_bytes = r.gauge(
        "lodestar_process_rss_bytes", "resident set size"
    )
    m.open_fds = r.gauge("lodestar_process_open_fds", "open file descriptors")
    m.clock_epoch = r.gauge("beacon_clock_epoch", "wall-clock epoch")
    m.active_validators = r.gauge(
        "beacon_current_active_validators", "active validator count"
    )
    m.head_distance = r.gauge(
        "lodestar_head_slot_distance",
        "slots between wall clock and head (sync lag)",
    )
    m.db_compactions_total = r.counter(
        "lodestar_db_compactions_total", "KV log compactions run"
    )
    m.h2c_cache_size = r.gauge(
        "lodestar_bls_verifier_h2c_cache_size", "hash-to-curve cache entries"
    )

    # --- slot-milestone lifecycle (observability.spans; reference: the
    # validator-monitor timeliness metrics + "delay from slot start"
    # dashboard rows). One histogram family labeled by milestone so a
    # slow slot decomposes into receive/validate/verify/import/head.
    m.slot_milestone_seconds = r.histogram(
        "lodestar_slot_milestone_delay_seconds",
        "delay from slot start to each block lifecycle milestone",
        label_names=("milestone",),
        buckets=(0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0),
    )
    m.slot_milestone_last = r.gauge(
        "lodestar_slot_milestone_last_delay_seconds",
        "latest observed per-milestone delay from slot start",
        label_names=("milestone",),
    )
    m.lifecycle_traces_total = r.counter(
        "lodestar_lifecycle_traces_total",
        "completed lifecycle traces by root span kind",
        label_names=("kind",),
    )

    # --- BLS pipeline telemetry (observability.stages) ------------------
    # stage timers, planner-decision counters, flush/queue gauges, device
    # busy fraction — registered on THIS registry so the families render
    # on /metrics; verifier wiring takes the bundle via `m.pipeline`
    # (node.py builds the serving stack over it).
    from ..observability.stages import create_pipeline_metrics

    m.pipeline = create_pipeline_metrics(r)
    return m
