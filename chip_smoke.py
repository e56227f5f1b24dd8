"""Smoke run of the PyTorch/CUDA port (`lodestar_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; every phase
but the mesh and fleet phases builds its verifiers with `mesh=None`, so
it runs the single-device path it names on a host of any card count):

1. env    the card's name and power limit, the torch and CUDA versions, the
          per-thread stack limit (`cudaLimitStackSize`, read through the
          CUDA runtime with ctypes); no phase may raise it.
2. build  K1 (`csrc/mont_mul.cu`), K2/K2p/K3/K3-fe (`csrc/tower.cu`) and K4
          (`csrc/mxu_mont.cu`), each with nvcc for sm_90a, the C host tier
          (`csrc/host/`, cc) and the K2/K3 host harness (`csrc/tower_host.cpp`,
          c++) from the checkout, all at once, into build/lodestar_tpu_torch/;
          ptxas's registers, stack and spills of every kernel.
3. k1     K1, a half-warp per product, against its plain PyTorch version
          on the card, limb for limb (tolerance 0): the 36 pairs of the
          edges 0, 1, p−1, p, 2p−1 and 2^381 − 1 (all ones below 2p), then
          random values in [0, 2p) at 1, 13 (a tail that is not a multiple
          of its 8 products per block), 128 and 2,048 (the grouped
          verdict's smallest and largest counts), 4096 and 589,824
          products; at each its device time (launches captured in a CUDA
          graph, replayed between two events: the host's wrapper left
          out), its call time (Python calls back to back between two
          events), the plain version's time, the byte bound and the share;
          ptxas's registers, shared memory, stack and spills of
          `mont_mul_kernel`.
4. k4     K4, the integer-tensor-core multiply, against its plain version
          and against K1, limb for limb, on the 36 edge pairs (padded to
          4096 products) and at 4096, 4097 (a partial warp tile), 8,192,
          65,536, 262,144 and 589,824 products; the device and call times
          of K4 and K1 side by side and the plain version's time beside
          K4's bound.
4a. fe    K3-fe, the final exponentiation with one warp per lane (before
          any other tower kernel, so that its first-launch memory is its
          own), against `final_exp_plain` (the batch form, one shared
          inversion) at 1, 16 (the bisection's probe) and 256 lanes of
          random Fp12 values in [0, 2p), with a zero lane and an identity
          lane from 16 lanes up: equal canonical values, zero to zero, the
          identity to one; ptxas's registers, shared memory, stack and
          spills of `final_exp_warp_kernel`, the device memory its first
          launch takes (no stack limit is raised for it), its device time
          (CUDA-graph replay) and call time, the plain version's time, the
          bound (the fewest Fp multiplies the function needs per lane,
          from the host build; the schedule's own count is reported
          beside it) and the time per dependent round (the host build's
          count of rounds).
4b. k2p   K2p, the projective Miller loop of the batch verdicts with one
          warp per lane (before K3 and K2, so that its first-launch memory
          is its own), against `miller_loop_proj_plain` at 8 and 192 lanes
          (the grouped verdict's 2R + 64): G1 pubkeys and H(m) points from
          the host tier times random Z (Zp ∈ Fp, Zq ∈ Fp2), every
          coordinate in [p, 2p); lane 0 with Zp = 0 and lane 1 with Zq = 0
          must only not fault and are left out of the comparison. Equal
          canonical values (tolerance 0); ptxas's figures of
          `miller_proj_warp_kernel` (it fails on a stack frame or a
          spill), first-launch memory, device and call times, the bound
          (the fewer Fp multiplies per lane of the one-thread lane and the
          warp schedule) and the time per round, as for K3-fe.
4c. k3    K3, the fused per-set pairing (two warps per set run K2p's Miller
          program at unit Z, then one of them the product and K3-fe's final
          exponentiation): against `pairing_fused_plain` on 4 and
          128 marshalled sets with three invalid sets and one zero lane,
          equal canonical values and verdicts equal to the host tier's;
          ptxas's figures of `pairing_warp_kernel` (it fails on a stack
          frame or a spill), first-launch memory, device time (graph
          replay) and call time, the plain version's time, the bound (the
          fewest Fp multiplies a set needs) and the time per round (the
          host build's count: one Miller warp's, the product's and the
          final exponentiation's rounds).
5. k2     K2, the affine Miller loop (one warp per lane running K2p's
          Miller program at unit Z), against `miller_loop_plain` on G1
          pubkeys and H(m) points made with the host tier, the odd lanes'
          coordinates in [p, 2p), plus one all-zero lane (f = 0), at 8 and
          256 lanes (the 2 × 128 Miller lanes of a 128-set per-set batch):
          equal canonical values (tolerance 0); ptxas's figures of
          `miller_warp_kernel` (it fails on a stack frame or a spill),
          first-launch memory, device time (graph replay) and call time,
          the plain version's time, the bound (the fewer Fp multiplies per
          lane of the one-thread lane and the schedule) and the time per
          round; it fails if the stack limit is above its start value.
6. slice  4096 signature sets over 64 signing roots (one slot of mainnet
          attestation gossip) made from a fixed seed with the host tier,
          verified by `TorchBlsVerifier` at the (64, 64) configuration:
          True on the valid batch, False on four tampered ones, each equal
          to the host tier's CPU verdict; the same for 128 sets over 16
          roots, the (16, 8) configuration.
7. pk-grouped  4096 sets over 4096 unique roots signed by 128 keys (the
          default (128, 32) configuration): the valid batch (first call, and
          warm with the hash-to-G2 cache emptied, as a flood of unique roots
          always finds it) and three tampered ones (a wrong message, two
          signatures swapped, bad flag bits), each equal to the host tier's
          verdict.
8. flat   128 sets over 128 roots and 128 keys (valid, one wrong message)
          and 200 such sets (two chunks).
9. split  64 sets over 8 shared roots plus 64 sets over 64 unique roots,
          from 2 keys (the rest goes pk-grouped) or from 64 keys (flat); each
          valid and with one tampered set in the unique part.
10. per-set  128 sets over 128 signing roots (a block's attestations),
          `verify_signature_sets_individual` on the card: (a) the valid
          batch, all True by the root alone; (b) three tampered sets,
          found by bisection; (c) `verify_individual` on the tampered
          bucket, one K3 launch; (d) 16 sets with one bad encoding, one
          set at a time (`_verify_one`). Every list equals the host tier's
          per-set verdicts.
11. pairing-check  `pairing.pairing_check`, the multi-pairing primitive, over
          the 2 × 128 affine pairs of the valid and of the tampered batch:
          the path that runs K2 (one launch per check) and K3-fe.
12. serve  the port's `DeviceBlsVerifier` facade with a recording observer:
          `epoch_table_populate` with the phase's 128 keys (rows, device
          bytes, seconds), `warm_h2c` over its 16 roots, one full 128-set
          job (grouped 16 × 8) valid and with three bad signatures, then
          `verify_signature_sets_individual` on the tampered job. Every
          verdict equals the host tier's; no pubkey is decompressed (a spy
          on `native.g1_decompress`: the table serves them all); the
          observer sees two root-grouped and one individual planner path,
          every stage, a bisection with rounds, hash-cache hits and 128
          epoch-table hits; K2p and K3-fe launch once per batch verdict.
12a. observe  the port's observability: serve's valid 128-set job through
          `DeviceBlsVerifier(device="cuda")` with a `PipelineMetrics` (A)
          and with `NullObserver` (B), in the order A B B A B A A B
          (4 jobs a side, each counted), the two medians and their
          difference; the host cost of observing one job, replayed (its
          observer calls on a fresh `PipelineMetrics`, 7 named scopes and
          one ledger-wrapped call, each timed over 2,000 repetitions);
          the stage histogram must
          count marshal, rand, dispatch and device_wait. Then one job
          under `start_profiling` / `stop_profiling`: its Chrome trace
          must hold the scopes bls/g2_decompress, bls/msm_planes,
          bls/miller_loop, bls/product_tree and bls/final_exp_batch, and
          every K2p (K3-fe) launch the job counted, issued inside
          bls/miller_loop (bls/final_exp_batch). The device ledger must
          read the card's in-use and total bytes, and the compile ledger
          hold one event (hit or miss) per library built or found.
12b. node  the port's serving stack (`node/bls_stack.py`: lanes over the
          supervisor over the facade, with the host tier) on cuda:0.
          (a) boot: `python3 -m lodestar_tpu_torch.warmup` in a subprocess
          (the extensions already built): its rungs, serving_ready against
          the 10 s SLO, peak device memory (measured, not asserted); its
          preload from the ahead-of-time store must find every serving
          library a `hit` and launch all six kernels once (their
          first-launch seconds and the `aot_load` mark are printed).
          (b) one slot of gossip through `build_bls_stack` at the JAX
          defaults: the epoch table populated on its daemon thread with
          32,768 keys (the slice phase's 4096, 28,672 from sk_to_pk, the
          block job's 128) while the calls arrive; the slice's 4096 sets as
          one-set attestation calls, uniform over 4 s, from 1024 caller
          threads, of which the first 2 s run (2048 calls, cut from the
          whole slot of PRs 14–17 to make room for the capella phase), the
          set arriving 1000th carrying another key's signature; serve-128's
          job on the block lane at 0 s and 2 s, each run as block import
          runs a block (a root `chain/process_block` span, its context
          handed to a worker thread that opens `chain/bls_verify` around
          the call): `/debug/traces` must show `bls/supervised_batch`
          under `chain/bls_verify` in each, and `/metrics`
          `lodestar_lifecycle_traces_total` equal to the traces finished.
          Every verdict the host
          tier's (exactly the tampered call False), no block shed, no
          waiter timeout, every shed under 1 s, K1, K2p and K3-fe launched;
          reports the makespan against 12 s, attestation sets/s, block p50
          and max, sheds, coalesced batch sizes, lane_overlap_fraction, the
          device ledger's utilisation, the epoch table's misses and hits and
          what the tampered sets cost (per-set re-verification, host-tier
          audit), and how the device calls' time splits between waiting
          for the supervisor's one dispatch worker and running on it. The
          calls arrive in a seeded shuffle (the 64 committees' roots
          interleaved, as on mainnet). The card must have done the work:
          the supervisor's only fallbacks are the two negative audits of
          the batch that held the tampered set, with no verdict mismatch,
          deadline, retry or double failure, the breaker closed, and K2p
          launched at least once per 128-set job the facade ran. (Its
          twin at coalescing 4096, cut to 512 calls where no batch can
          pass 512, is gone: it no longer showed coalescing past the main
          slot's cap, and its time went to the network phase.)
          (c) drills through the port's supervisor on serve-128's job
          (cooldown 2 s, deadline 5 s, an injected fault seam): exceptions
          (the host tier serves, the breaker opens on the third, the canary
          re-closes it), a host-side latency past the deadline (counted, the
          host tier serves), flaky verdicts (the audit overturns them,
          verdict_mismatch ticks), serve-128's job with three bad
          signatures and its per-set verdicts, each job run as block import
          runs one; the exact per-set route (K3); then the
          mesh drill: the stack over two workers on cuda:0, worker 2
          killed, `MeshWorkerError` naming chip 1 evicted by the supervisor
          within the pool's timeout (serving size 1, the pool stopped), the
          same call served single-device, the host tier called 0 times, the
          breaker closed, the canary re-admitting the chip and a new pool
          serving sharded again, no worker process left (the mesh phase's
          eviction drill); each pool's workers must report only `hit`s
          from the store and six first launches at their start.
          (d) `/metrics` and `/debug/{breaker,lanes,slo,device,epoch_table,
          compiles,traces}` over loopback: every `metrics/bls.py` family and the
          lane, supervisor and slo families present, `zero_block_sheds`
          ok and the breaker closed after the drills; each drill job's
          trace with `bls/supervised_batch` under `chain/bls_verify` (the
          per-set call's `bls/supervised_individual`), the exception
          jobs' `bls/cpu_fallback` spans and the breaker's
          `bls/breaker_transition` event, and the lifecycle counter equal
          to the traces finished.
          (e) the ahead-of-time store on a temporary copy of the build
          directory: one byte of K1's library (`mont_mul`, the cheapest
          kernel library to rebuild) flipped counts `corrupt`, is moved
          aside, rebuilt and never opened (a spy on `build._open`), and
          serve-128's job through the rebuilt K1 is the host tier's
          verdict; the host tier's header given another compiler counts
          `version_mismatch` and is rebuilt. Then the host microseconds
          of one lifecycle span (enabled against the disabled tracer's
          shared null span, replayed).
12c. mesh  the sharded verdicts: `TorchBlsVerifier(mesh=...)` over a
          `BlsMeshDispatcher(["cuda:0", "cuda:0"])`, two worker processes
          on the one card (even where more are visible; the device count
          is logged): grouped 64 x 64 (the slice phase's batch: valid, one
          bad signature and one undecodable signature in the second
          worker's rows), pk-grouped 128 x 32 (the pk-grouped phase's
          batch: valid with the hash cache emptied; the fleet phase holds
          its wrong message) and per-set 128 by bisection (valid, three
          invalid at 5, 64 and 127). Each verdict equals the host tier's
          (the per-set vectors set for set), the dispatcher's count
          of each chip rises by one, the single-device verdict is never
          called, and each worker launches K2p once and the first K3-fe
          once (the workers' counts zeroed just before and read just
          after through the pool; the controller launches nothing but
          bisection's probes). Each cell's walls are printed beside the
          same batch's single-device walls; no worker process may be left.
          (Its eviction drill moved into the node phase's mesh drill, which
          makes every one of its checks through the port's supervisor.)
12d. fleet  the two-level fleet (hosts x GPUs per host) on cuda:0: a
          `BlsMeshDispatcher` of hosts [[0, 1], [2, 3]], host 0's two
          workers spawned by this process, host 1's two started by a
          `lodestar_tpu_torch.parallel.fleet_host` agent subprocess that
          joins the hub over TCP on 127.0.0.1 with a temporary authkey
          file (host 1 emulated on this machine, as a second host would
          run it). The mesh phase's grouped and pk-grouped batches and the
          per-set batches through `TorchBlsVerifier(mesh=...)`: grouped
          64 x 64 (valid, one bad signature in host 1's rows), pk-grouped
          128 x 32 (valid with the hash cache emptied, one wrong message in
          host 1's rows), per-set 128 by bisection (valid, three invalid).
          Each verdict equals the host tier's, goes through the fleet once
          (each host's and chip's dispatch count rises by one, never the
          single-device verdict), launches K2p once on each of the four
          workers and K3-fe once on worker 0 only. Each cell's walls are
          printed beside the mesh phase's single-level and single-device
          walls of the same batch. Then the host drill: the agent killed,
          the next grouped dispatch raises `MeshWorkerError` with host 1,
          `mesh_evict_host(1)` serves from a single-level pool of host 0's
          two workers, the attached `FleetRouter` moved only host 1's
          subnets, a new agent (started after the raise) and
          `mesh_readmit()` serve the two-level verdict again; the seconds
          of each step are printed, and no worker or agent process may be
          left. To stay in its time, the mesh phase reuses the slice and
          pk-grouped phases' batches, its pk-grouped cell is the valid
          batch alone, each of its cells times one verdict a side (mesh,
          then single-device) and no cell repeats a warm single-device
          first call; each fleet cell times one warm verdict after its
          first call.
12e. block_import  block import's producer side (`profile_block.run`) on
          the mainnet preset, `MAINNET_CHAIN_CONFIG` with Altair at epoch
          1: an interop genesis of 16,384 validators (4 committees of 128
          per slot), full-participation blocks at slots 1-3 (phase0, each
          with the previous slot's 4 aggregates), the first block of epoch
          1 (Altair: 128 aggregates, one per committee of slots 1-32, and a
          512-key sync aggregate: 131 sets) and a tampered copy of it (two
          aggregates' signatures swapped, re-rooted and re-signed), made
          with the C host tier; each imported through a cold
          `build_bls_stack(device="cuda")` (one lane worker flushing at 64
          sets, for the chain phase's gossip) as block import runs a block
          (the pre-state advanced, the sets built, the verdict with
          `batchable=False` on a worker thread beside the state
          transition), the epoch table populated with the state's keys at
          the Altair boundary first. Every valid block: verdict True and
          the host tier's, post-state root the block's, and given by the
          card (no host-tier fallback of the supervisor, every 128-set
          facade job run, K2p and K3-fe launched at least once per job);
          the tampered block: False as on the host tier, the supervisor's
          only host-tier calls the negative audits of that verdict and of
          its per-set verdicts, which blame exactly the two swapped sets
          with K2p or K3 launched per facade job, its state transition
          with the host tier's inline checks refused; no overturned
          verdict, deadline, retry or double failure, and the breaker
          closed. Prints each block's sets, seconds of pre-state, sets,
          state transition and verdict, import wall, planner path,
          supervisor counts and launches, the per-set blame's seconds,
          paths and launches, and the setup's seconds. It leaves its stack
          (epoch table populated) and its genesis and blocks to the chain
          phase.
12f. chain  the port's chain (`profile_chain.run`) on block_import's
          genesis, blocks and stack: a `BeaconChain` on the genesis with a
          `ManualClock`, serving through the stack's lane dispatcher.
          (a) blocks 1-3 through `process_block_segment` (18 sets, one
          verdict); (b) the tampered Altair block refused
          (`BlockImportError`, head and blocks unchanged); (c) the Altair
          block ACCEPTed by `validate_gossip_block`, then imported (head
          its root, post-state root the block's); (d) one single-bit
          attestation from each of committee 0's 128 members (cut
          from the slot's 512 to pay for the network phase, which
          carries the whole slot from the wire) through
          `validate_gossip_attestation` from 64 threads (the attestation
          lane), with two signed by another validator (REJECT), a replay
          (IGNORE) and one on the wrong subnet (REJECT), all four among
          those members; (e) a `SignedAggregateAndProof` from every
          aggregator of committee 0 (by selection proof; each leaves out a
          different member) from 16 threads on the aggregate lane, plus
          one with another aggregator's selection proof (REJECT), then the
          head the Altair block, its weight the 128 votes and the proposer
          boost; (f) at slot 34 `produce_block` from the pools, signed by
          its proposer, ACCEPTed as gossip, imported, carrying committee
          0's aggregate, the new head. Fails unless every action and reason
          is the expected one, every verdict the host tier's on the same
          sets, and the card gave every verdict: the supervisor's only
          host-tier calls the negative audits of the refused verdicts (one
          for the tampered block, those of the batches holding the bad
          gossip sets), no overturned verdict, deadline, retry or double
          failure, K2p and K3-fe launched at least once per 128-set
          facade job and a Miller kernel per per-set job, the breaker
          closed at the end. Prints per step its seconds (for blocks the
          chain's spans: pre-state, verdict, state transition, fork choice,
          import), for (d) and (e) the makespan, validations per second,
          p50, p99 and max latency, the coalesced batches and their sizes,
          the planner paths, launches, epoch-table hits and misses, the
          first checkpoint-state regen; the chain's launches on a line of
          their own, and the card line. It leaves its stack, its chain and
          the whole slot's messages (every committee's) to the network
          phase.
12h. network  the network (`profile_network.run`), after the chain phase
          and before capella, on block_import's genesis and the chain
          phase's stack, in one process on loopback: P, a `Network` over
          the chain phase's chain (blocks 1-3, 33 and 34 already verified
          on the card, so P costs no verdict), serving status and
          `beacon_blocks_by_range` and answering discovery, subscribed to
          no gossip topic; R, a new `BeaconChain` on the genesis (manual
          clock) behind a `Network` with every subnet's topic, whose
          router runs on a manual clock; Q1-Q32, each a `Transport`,
          `GossipsubService` and `Gossipsub` with its own identity and no
          subscriptions. During each flood the stack's lane flushes at
          its cohort, or after 1 s: the messages in flight (one per peer,
          at most the topic queue's concurrency) times a message's sets,
          32 for the attestations, 16 x 3 for the aggregates. (a) R finds P by discovery
          over UDP from P's
          record and dials it (the handshake both ways, then status);
          Q1-Q32 dial R; the dial seconds and the host us of Ed25519 sign
          and verify, X25519, HKDF, the AEAD and snappy are printed. (b)
          R range-syncs slots 1-33 from P (blocks 1-3 and 33 as
          ssz_snappy chunks) and imports them with
          `process_block_segment`: one verdict of 149 sets; R's head is
          P's block 33. (c) slot 33's 512 attestations spread round-robin
          over Q1-Q32 on their subnets' topics, with the chain phase's two
          bad signatures and wrong subnet (REJECT), a second vote of one
          attester on block 3 (IGNORE), and after the flood a
          byte-identical replay from a second peer: counted by R's router
          as a duplicate, never validated; every other ACCEPT; each
          peer's gossipsub score on R equal to what `score.py` gives for
          the deliveries and REJECTs it sent; the makespan,
          validations/s, publish-to-result p50, p99 and max, the coalesced
          batches and their flush reasons, planner paths and epoch-table
          hits printed. (d) every aggregator's aggregate of the slot the
          same way, one with another's selection proof (REJECT). (e)
          block 34 published by Q1: ACCEPT, imported; R's head and its
          weight are P's. Fails unless every action is the expected one,
          every verdict the host tier's and the card's (the supervisor's
          only host-tier calls negative audits; the facade's batch and
          per-set jobs those the sent sets and coalesced batches imply;
          K1, K2p and K3-fe launched in every job), the breaker closed,
          and no node, connection, socket or thread left; prints the
          phase's seconds against its 150 s bound. It leaves its stack to
          the capella phase.
12g. capella  a post-merge Capella chain (`profile_capella.run`), after
          the network phase, on block_import's genesis and stack: (a) a copy of the genesis
          under Altair at 1, Bellatrix at 2 and Capella at 3 advanced by
          `process_slots` to slot 96 (each epoch transition timed): fork
          Capella, the default payload header, withdrawal cursors 0; then
          the genesis upgraded at slot 0 to Altair, Bellatrix and Capella
          (all at epoch 0), the header anchored at an EL genesis hash and
          the genesis time, validators 0-63 given an excess of 1,000,000
          Gwei, and a `BeaconChain` with an `ExecutionEngineMock` on the
          stack. (b) slot 1: 32 signed BLS-to-execution changes
          (validators 0-31) and the 512-member sync contributions in the
          pools; `produce_block` builds the payload through the engine;
          the block (16 changes, a full sync aggregate: 19 sets) ACCEPTed
          as gossip and imported: validators 0-15 hold 0x01 credentials,
          the engine's head is the payload's hash. (c) slot 2: one
          aggregate per committee of slot 1 through the attestation pool,
          a block with them and changes 16-31 whose payload withdraws the
          excess of validators 0-15 (16 withdrawals after a timed sweep
          over 16,384 validators): the amounts, the debited balances and
          `next_withdrawal_index` 16. (d) a slot-3 block one of whose
          changes carries another change's signature, re-rooted and
          re-signed: verdict False as on the host tier, the per-set
          verdicts blaming exactly that set, the import refused, the head
          kept. (e) a slot-3 block whose payload the engine calls
          INVALID: the import refused on the payload with the verdict
          True, fork choice without the block. (f) `prepare_next_slot`
          opens a building session for slot 3; the block produced from the
          prepared state imports as head and the engine's head follows.
          Every step with a verdict: each verdict the host tier's, the
          card's (the supervisor's only host-tier calls the negative
          audits of the tampered step, the facade's jobs those the set
          counts imply, K2p and K3-fe launched at least once per job), the
          breaker closed at the end; closes the stack. Prints each step's
          seconds (produce, gossip, import and the chain's spans), the
          sweep's, the planner paths and launches, and a `[summary]
          capella` line with the card.

The main-path verdicts of phases 6-12h run with the launch counts of K1-K4,
K2p and K3-fe reset just before and read just after, and fail if a kernel
of their path was launched no time: K2p and K3-fe once per batch verdict
(per part of a split one, per chunk of a flat one, per worker in phases
12c and 12d, where K3-fe runs on the first worker only), both on bisection;
every verdict of phases 7-9 is counted so and also checks which planner
paths ran.

13. the `kernels` line, the card line, and the last line
          {"ok": true, "device": {"platform": "gpu", ...}}. K1's and K4's
          entries give their device times (`ms`) and call times
          (`call_ms`) per launch over the product counts that their
          main-path verdict gave them (the grouped (64, 64) verdict for K1,
          the pk-grouped one for K4), each count checked limb for limb and
          timed anew. K2's entry is timed at 256 lanes, K2p's at 192,
          K3-fe's at 1 and K3's at 128 sets, their main-path shapes; the
          four also give their call time, rounds, µs per round and their
          schedule's Fp multiplies per lane.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 20261017
THREADS = os.cpu_count() or 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT32_OPS_PER_S = 67e12  # the published non-tensor float32 peak, no int32 entry


def log(*args):
    print(*args, flush=True)


PHASE_SECONDS: dict[str, float] = {}


def timed(name: str, fn, *args):
    """fn(*args), its wall seconds kept in PHASE_SECONDS and logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[time] {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env(torch):
    log("[env] card:", card_line())
    log("[env] torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0], "host threads", THREADS)


def phase_build():
    """Build every library at once; returns ptxas's figures per kernel."""
    from lodestar_tpu_torch import build

    t0 = time.perf_counter()
    builds = (build.mont_mul_cuda, build.tower_cuda, build.mxu_cuda, build.host_tier,
              build.tower_host)
    with ThreadPoolExecutor(len(builds)) as pool:
        for job in [pool.submit(b) for b in builds]:
            job.result()
    log(f"[build] K1, K2/K2p/K3/K3-fe, K4, host tier and tower host harness built in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, (secs, text) in sorted(build.BUILD_LOG.items()):
        log(f"[build] {name}: {secs:.1f} s")
        funcs = build.ptxas_summary(text)
        for fn, figs in sorted(funcs.items()):
            if figs.get("entry"):
                ptxas[fn] = figs
                log(f"[build]   kernel {fn}: {json.dumps(figs)}")
        calls = [f for f in funcs.values() if not f.get("entry")]
        if calls:
            log(f"[build]   {len(calls)} device functions: largest stack frame "
                f"{max(f.get('stack', 0) for f in calls)} B, spill stores "
                f"{sum(f.get('spill_stores', 0) for f in calls)} B, spill loads "
                f"{sum(f.get('spill_loads', 0) for f in calls)} B")
    return ptxas


def _random_limbs(rng, n: int):
    """(n, 32) int32 limbs in [0, 2p): half below 2^381 (< 2p), half
    p + v with v < 2^380 (in [p, 2p)), and the five edge values first."""
    import numpy as np

    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import P_LIMBS, int_to_limbs

    limbs = rng.integers(0, 4096, size=(n, 32), dtype=np.int64)
    limbs[:, 31] = rng.integers(0, 512, size=n)
    high = np.arange(n) % 2 == 1
    limbs[high, 31] = rng.integers(0, 256, size=int(high.sum()))
    carry = np.zeros(int(high.sum()), np.int64)
    for i in range(32):  # v + p for the [p, 2p) half
        s = limbs[high, i] + P_LIMBS[i] + carry
        limbs[high, i] = s & 4095
        carry = s >> 12
    edges = [0, 1, P - 1, P, 2 * P - 1]
    for i, v in enumerate(edges[:n]):
        limbs[i] = int_to_limbs(v)
    return limbs.astype(np.int32)


def _time_ms(torch, fn, iters: int) -> float:
    """Call time: milliseconds per Python call of `fn`, back to back between
    two events (the wrapper's checks, allocation and launch included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int) -> float:
    """Device time: milliseconds per call of `fn` with the host's wrapper
    left out, from `iters` calls captured in one CUDA graph and replayed
    between two events (the kernels and the gaps between them)."""
    fn()  # warm: the build, the cached constants, the launch shape
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _iters(n: int) -> int:
    return 200 if n <= 8192 else 50 if n <= 65536 else 20


# products: one; a tail that is not a multiple of K1's 8 per block; the
# grouped verdict's smallest and largest counts (128, 2,048); the lane
# rule's switch to K4 (4,096); the pk-grouped path's largest count
K1_SIZES = (1, 13, 128, 2048, 4096, 589824)


def phase_k1(torch, np, ptxas: dict):
    """K1 against its plain version, limb for limb, on the edge pairs and at
    K1_SIZES, with its device and call times, the plain version's time and
    the bound; returns (max_err, {products: row}, ptxas figures)."""
    from lodestar_tpu_torch.ops import cuda_fp

    figs = _kernel_ptxas(ptxas, "mont_mul_kernel")
    log(f"[k1] mont_mul_kernel (a half-warp per product): {figs.get('registers')} registers, "
        f"{figs.get('smem', 0)} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    a_np, b_np = _edge_pairs(np, rng, 64)
    cases = [("edges", a_np, b_np)]
    for n in K1_SIZES:
        cases.append((str(n), _random_limbs(rng, n), _random_limbs(rng, n)[::-1].copy()))
    max_err = 0
    rows = {}
    for name, a_np, b_np in cases:
        a, b = torch.as_tensor(a_np).to(dev), torch.as_tensor(b_np).to(dev)
        n = a.shape[0]
        got = cuda_fp.mont_mul_cuda(a, b)
        want = cuda_fp.mont_mul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K1 differs from its plain version at {name} products")
        if name == "edges":
            log(f"[k1] the {len(_edge_values()) ** 2} edge pairs (padded to {n}): match=exact")
            continue
        iters = _iters(n)
        ms = _device_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        call_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        plain_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_plain(a, b), max(3, iters // 10))
        bound_ms, bound_by = k1_bound(n)
        rows[n] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[k1] products={n} match=exact device_ms={ms:.6f} call_ms={call_ms:.6f} "
            f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.6f}")
    return max_err, rows, figs


def k1_bound(lanes: int):
    """K1's (bound_ms, bound_by) at `lanes` products: 384 B moved and the
    2·12² int32 products of its 12 × 12 digit schoolbook, each a mul.lo and
    a mul.hi, per product."""
    bytes_ms = 384 * lanes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 12 * 12 * 2 * lanes / INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _tampered(sets, per_root: int):
    """The four tampered batches; each keeps the multiset of roots (so
    the grouped planner keeps its layout) and names the sets it changed."""
    from lodestar_tpu_torch.bls.api import SignatureSet
    from lodestar_tpu_torch.bls.fields import P

    i, j = 3, 3 + per_root  # sets of two different roots
    out = []
    s = list(sets)  # wrong message: sets i and j trade signing roots
    s[i] = SignatureSet(sets[i].pubkey, sets[j].message, sets[i].signature)
    s[j] = SignatureSet(sets[j].pubkey, sets[i].message, sets[j].signature)
    out.append(("wrong_message", s, (i, j)))
    s = list(sets)  # one signature swapped with another set's
    s[i] = SignatureSet(sets[i].pubkey, sets[i].message, sets[j].signature)
    s[j] = SignatureSet(sets[j].pubkey, sets[j].message, sets[i].signature)
    out.append(("swapped_signature", s, (i, j)))
    s = list(sets)  # one pubkey swapped
    s[i] = SignatureSet(sets[j].pubkey, sets[i].message, sets[i].signature)
    s[j] = SignatureSet(sets[i].pubkey, sets[j].message, sets[j].signature)
    out.append(("swapped_pubkey", s, (i, j)))
    s = list(sets)  # bad encoding: x.c1 = p (x >= p) under valid flags
    bad = bytearray(sets[i].signature)
    bad[:48] = P.to_bytes(48, "big")
    bad[0] |= 0x80 | (sets[i].signature[0] & 0x20)
    s[i] = SignatureSet(sets[i].pubkey, sets[i].message, bytes(bad))
    out.append(("bad_encoding", s, (i,)))
    return out


def _host_verdicts(sets):
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.bls.api import DST_G2

    return native.verify_sets(
        b"".join(s.pubkey.to_bytes() for s in sets), [s.message for s in sets],
        b"".join(s.signature for s in sets), DST_G2, threads=THREADS,
    )


def phase_slice(torch, np, n_roots: int, per_root: int):
    """Drive TorchBlsVerifier on one batch shape; returns the launch counts
    of the main-path verdict, its wall time, the batch's size, its products
    per launch and the batch with its host tier verdicts."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier
    from lodestar_tpu_torch.profile_verdict import make_sets

    tag = f"[slice {n_roots}x{per_root}]"
    t0 = time.perf_counter()
    sets = make_sets(n_roots, per_root, seed=SEED + n_roots, threads=THREADS)
    log(f"{tag} made {len(sets)} sets in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    per_set = _host_verdicts(sets)
    host_valid = all(per_set)
    log(f"{tag} host tier verdict {host_valid} in {time.perf_counter() - t0:.1f} s")
    if not host_valid:
        raise AssertionError("the host tier rejects the valid batch")

    v = TorchBlsVerifier(device="cuda", mesh=None, grouped_configs=((16, 8), (64, 64)),
                         rng=np.random.default_rng(SEED))
    t0 = time.perf_counter()
    cold = v.verify_signature_sets(sets)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    cold_stages = dict(v.stage_seconds)
    log(f"{tag} cold verdict {cold} in {cold_s:.3f} s; stages {json.dumps(cold_stages)}")
    if cold is not True:
        raise AssertionError("the port rejects the valid batch")

    # main path, warm caches: counts reset just before, read just after
    torch.cuda.reset_peak_memory_stats()
    with _products_per_launch() as products:
        verdict, wall, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v)
    _check_products(products, counts, tag)
    stages = dict(v.stage_seconds)
    if verdict is not True:
        raise AssertionError("the port rejects the valid batch (warm)")
    _need(counts, f"{tag} main path", "K1")
    _need_main(counts, f"{tag} main path")
    host_s = stages.get("marshal", 0.0) + stages.get("rand", 0.0)
    log(f"{tag} warm verdict True in {wall:.3f} s = {len(sets) / wall:.1f} sets/s; "
        f"launches {json.dumps(counts)}; host marshal+rand share {host_s / wall:.6f} "
        f"(hash-to-curve {stages.get('hash_to_curve', 0.0):.6f} s); "
        f"stages {json.dumps(stages)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for name, bad, changed in _tampered(sets, per_root):
        # the host tier's batch verdict is the AND of its per-set verdicts:
        # unchanged sets keep theirs, the changed ones are verified anew
        host = list(per_set)
        fresh = _host_verdicts([bad[k] for k in changed])
        for k, ok in zip(changed, fresh):
            host[k] = ok
        want = all(host)
        t0 = time.perf_counter()
        got = v.verify_signature_sets(bad)
        secs = time.perf_counter() - t0
        log(f"{tag} {name}: port {got}, host tier {want} ({secs:.3f} s)")
        if got is not False or want is not False:
            raise AssertionError(f"{name}: the tampered batch was not rejected by both")
    return counts, wall, len(sets), products, (sets, per_set)


# K4 computes K1's function, REDC(a·b), with its constant products on the
# integer tensor cores. The ceiling of what the function needs there: three
# 32 × 32 limb-product contractions (a·b, t·N′, m·p), each limb product four
# u8 × u8 multiply-adds of its lo/hi bytes. K4 issues 6,656 per product (its
# a·b runs on the CUDA cores, t·N′ and m·p on bytes; `csrc/mxu_mont.cuh`), its
# TPU formulation 208,896 (a dense contraction with the 0/1 matrix S). Every
# shape is bytes-bound either way.
K4_MACS_PER_PRODUCT = 3 * 4 * 32 * 32
INT8_MMA_OPS_PER_S = 1979e12  # dense int8 tensor-core peak


def k4_bound(lanes: int):
    """K4's (bound_ms, bound_by) at `lanes` products: the larger of its
    384 B moved and the multiply-adds REDC(a·b) needs."""
    ops_ms = 2 * K4_MACS_PER_PRODUCT * lanes / INT8_MMA_OPS_PER_S * 1e3
    bytes_ms = 384 * lanes / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# products: the main path's 4096; 4097, a partial warp tile; the pk-grouped
# path's 8,192 and 589,824; and sizes between
K4_SIZES = (4096, 4097, 8192, 65536, 262144, 589824)


def _edge_values():
    """0, 1, p−1, p, 2p−1 and 2^381 − 1, the all-ones value below 2p (its
    words give the largest word products)."""
    from lodestar_tpu_torch.bls.fields import P

    return (0, 1, P - 1, P, 2 * P - 1, 2**381 - 1)


def _edge_pairs(np, rng, n: int):
    """The 36 pairs of `_edge_values()`, padded with random values in [0, 2p) to
    n products."""
    from lodestar_tpu_torch.ops.limbs import int_to_limbs

    edges = [int_to_limbs(v) for v in _edge_values()]
    k = len(edges) ** 2
    a = _random_limbs(rng, n)
    b = _random_limbs(rng, n)
    a[:k] = [x for x in edges for _ in edges]
    b[:k] = [y for _ in edges for y in edges]
    return a, b


def phase_k4(torch, np):
    """K4 against its plain version and against K1, limb for limb, then the
    device and call times of K4 and K1 and the plain version's time beside
    K4's bound; returns (max_err, {products: row})."""
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device("cuda")
    cases = [("edges", *_edge_pairs(np, rng, 4096))]
    for n in K4_SIZES:
        cases.append((str(n), _random_limbs(rng, n), _random_limbs(rng, n)[::-1].copy()))
    max_err = 0
    rows = {}
    for name, a_np, b_np in cases:
        a, b = torch.as_tensor(a_np).to(dev), torch.as_tensor(b_np).to(dev)
        n = a.shape[0]
        got = cuda_mxu.mont_mul_mxu_cuda(a, b)
        plain = cuda_mxu.mont_mul_mxu_plain(a, b)
        k1 = cuda_fp.mont_mul_cuda(a, b)
        torch.cuda.synchronize()
        err = max(int((got.long() - plain.long()).abs().max()),
                  int((got.long() - k1.long()).abs().max()))
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K4 differs from its plain version or K1 at {name} products")
        if name == "edges":
            log(f"[k4] the {len(_edge_values()) ** 2} edge pairs (padded to {n}): match=exact "
                f"against plain and K1")
            continue
        iters = _iters(n)
        ms = _device_ms(torch, lambda: cuda_mxu.mont_mul_mxu_cuda(a, b), iters)
        k1_ms = _device_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        call_ms = _time_ms(torch, lambda: cuda_mxu.mont_mul_mxu_cuda(a, b), iters)
        k1_call_ms = _time_ms(torch, lambda: cuda_fp.mont_mul_cuda(a, b), iters)
        plain_ms = _time_ms(torch, lambda: cuda_mxu.mont_mul_mxu_plain(a, b), 3)
        bound_ms, bound_by = k4_bound(n)
        rows[n] = dict(ms=ms, call_ms=call_ms, k1_ms=k1_ms, k1_call_ms=k1_call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[k4] products={n} match=exact device_ms={ms:.6f} call_ms={call_ms:.6f} "
            f"k1_device_ms={k1_ms:.6f} k1_call_ms={k1_call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"k1_share_of_bound={bound_ms / k1_ms:.6f}")
    return max_err, rows


PER_SET_N = 128  # the largest per-set bucket: a block's attestations
K2_LANES = (8, 2 * PER_SET_N)  # 2 × 128: the Miller lanes of a 128-set batch


OPS_PER_FP_MUL = 576  # int32 operations per Fp multiply: 2·12² products, each a mul.lo and a mul.hi
K2_BYTES_PER_LANE = 4 * (32 + 32 + 64 + 64 + 384)  # xp, yp, xq, yq in; the Fp12 out
K3_BYTES_PER_SET = 4 * (32 + 32 + 4 * 64 + 384)  # pk, H(m), sig in; the Fp12 out


def _bound(fp_muls_per_lane: int, bytes_per_lane: int, lanes: int):
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    ops_ms = fp_muls_per_lane * OPS_PER_FP_MUL * lanes / INT32_OPS_PER_S * 1e3
    bytes_ms = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _event_ms(torch, fn, iters: int = 1) -> float:
    """CUDA-event milliseconds per call of `fn`, already warm."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_bytes_taken(torch, fn):
    """(fn(), device bytes that the call took outside PyTorch's allocator).
    Around a tower kernel's first launch this is the memory the launch
    itself takes: a raised per-thread stack limit would reserve local
    memory for every resident thread; the lazily loaded code of the
    module's kernel takes one 2 MiB granule or nothing."""
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    free1, reserved1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    return out, (free0 - free1) - (reserved1 - reserved0)


def _canonical_err(torch, got, want) -> int:
    """Largest limb difference between a kernel's canonical output and the
    canonical form of the plain version's lazy one."""
    from lodestar_tpu_torch.ops import fp

    return int((got.long() - fp.canonical(want).long()).abs().max())


def _miller_inputs(np, n: int, seed: int):
    """n affine Miller lanes: G1 pubkeys and H(m) points from the host tier,
    lane 0 all zero."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.bls.api import DST_G2

    rng = np.random.default_rng(seed)
    sks = [(int.from_bytes(rng.bytes(31), "big") + 1).to_bytes(32, "big") for _ in range(n)]
    msgs = [rng.bytes(32) for _ in range(n)]

    def one(i):
        rc1, pk = native.sk_to_pk(sks[i])
        rc2, p = native.g1_decompress(pk)
        rc3, q = native.hash_to_g2(msgs[i], DST_G2)
        if rc1 or rc2 or rc3:
            raise RuntimeError("host tier failed to make a Miller lane")
        return p, q

    with ThreadPoolExecutor(THREADS) as pool:
        pts = list(pool.map(one, range(n)))
    xp = np.stack([p[0] for p, _ in pts])
    yp = np.stack([p[1] for p, _ in pts])
    xq = np.stack([q[0] for _, q in pts])
    yq = np.stack([q[1] for _, q in pts])
    for a in (xp, yp, xq, yq):
        a[0] = 0
    return xp, yp, xq, yq


def stack_limit() -> int:
    """The current device's per-thread stack limit (`cudaLimitStackSize`),
    read through the CUDA runtime that this process loaded."""
    import ctypes

    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f if "libcudart" in line})
    lib = ctypes.CDLL(paths[0] if paths else "libcudart.so")
    value = ctypes.c_size_t(0)
    rc = lib.cudaDeviceGetLimit(ctypes.byref(value), 0)  # 0: cudaLimitStackSize
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetLimit failed: CUDA error {rc}")
    return int(value.value)


def _high_half(np, cols):
    """The odd lanes' coordinates as their value plus p, in [p, 2p)."""
    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import int_to_limbs, limbs_to_int

    for a in cols:
        flat = a.reshape(a.shape[0], -1, 32)
        for i in range(1, a.shape[0], 2):
            for j in range(flat.shape[1]):
                flat[i, j] = int_to_limbs(limbs_to_int(flat[i, j]) + P)
    return cols


def phase_k2(torch, np, muls: dict, ptxas: dict, stack_at_start: int):
    """K2 against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower

    figs = _kernel_ptxas(ptxas, "miller_warp_kernel")
    rounds = muls["miller_loop_warp_rounds"]
    log(f"[k2] miller_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['miller_loop_warp']} Fp multiplies and {rounds} dependent rounds per lane in "
        f"its schedule, {muls['miller_loop']} in the one-thread lane; the bound counts the "
        f"fewer, {muls['miller_loop_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K2's kernel uses a stack or spills: its launcher raises no limit")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in K2_LANES:
        cols = _high_half(np, list(_miller_inputs(np, n, SEED + n)))
        args = [torch.as_tensor(a).to(dev) for a in cols]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.miller_loop_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k2] first launch took {taken} B of device memory ({taken / 2**20:.1f} MiB)")
        want = cuda_tower.miller_loop_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K2 differs from its plain version at {n} lanes")
        if not bool((got[0] == 0).all()):
            raise AssertionError("K2's all-zero lane did not give 0")
        ms = _device_ms(torch, lambda: cuda_tower.miller_loop_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.miller_loop_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.miller_loop_plain(*args))
        bound_ms, bound_by = _bound(muls["miller_loop_fewest"], K2_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["miller_loop_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[k2] lanes={n} match=canonical (zero lane 0, odd lanes in [p, 2p)) "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    limit = stack_limit()
    log(f"[k2] stack limit {limit} B after the phase, {stack_at_start} B at the start")
    if limit > stack_at_start:
        raise AssertionError("the per-thread stack limit was raised")
    return max_err, rows


def _tamper_one(sets, k: int, field: str, donor: int):
    """A copy of `sets` with set k's `field` taken from set `donor`."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    parts = {"pubkey": sets[k].pubkey, "message": sets[k].message,
             "signature": sets[k].signature}
    parts[field] = getattr(sets[donor], field)
    out[k] = SignatureSet(parts["pubkey"], parts["message"], parts["signature"])
    return out


def per_set_tamper(n: int):
    """The tampered positions of an n-set batch and what each takes from
    the set before it."""
    return ((5, "message"), (n // 2, "signature"), (n - 1, "pubkey"))


def per_set_batches(np):
    """PER_SET_N sets over as many signing roots and the same with three
    sets tampered (a wrong message, another set's signature, another set's
    pubkey), with the host tier's per-set verdicts of both."""
    from lodestar_tpu_torch.profile_verdict import make_sets

    sets = make_sets(PER_SET_N, 1, seed=SEED + 7, threads=THREADS)
    bad = sets
    for k, field in per_set_tamper(PER_SET_N):
        bad = _tamper_one(bad, k, field, k - 1)
    return sets, _host_verdicts(sets), bad, _host_verdicts(bad)


def phase_k3(torch, np, muls: dict, ptxas: dict, bad, host_bad):
    """K3 against its plain version and the host tier's verdicts; returns
    (max_err, {sets: row})."""
    from lodestar_tpu_torch.ops import cuda_tower, fp12
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    figs = _kernel_ptxas(ptxas, "pairing_warp_kernel")
    rounds = muls["pairing_warp_rounds"]
    log(f"[k3] pairing_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['pairing_warp']} Fp multiplies and {rounds} dependent rounds per set in its "
        f"schedule, {muls['pairing_fused']} in the one-thread set; the bound counts the "
        f"fewest a set needs, {muls['pairing_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K3's kernel uses a stack or spills: its launcher raises no limit")
    arrs = TorchBlsVerifier(device="cpu")._marshal(bad)
    if arrs is None:
        raise AssertionError("the tampered per-set batch did not marshal")
    dev = torch.device("cuda")
    zero = 3  # one all-zero lane beside the three tampered sets
    names = ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")
    cols = {k: getattr(arrs, k).copy() for k in names}
    for a in cols.values():
        a[zero] = 0
    want_ok = np.array(host_bad, bool)
    want_ok[zero] = False
    max_err = 0
    rows = {}
    first_bytes = None
    for lanes in (slice(3, 7), slice(0, PER_SET_N)):
        args = [torch.as_tensor(cols[k][lanes]).to(dev) for k in names]
        n = args[0].shape[0]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.pairing_fused_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k3] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB)")
        want = cuda_tower.pairing_fused_plain(*args)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K3 differs from its plain version at {n} sets")
        ok = fp12.is_one(got).cpu().numpy()
        if not (ok == want_ok[lanes]).all():
            raise AssertionError(f"K3's verdicts differ from the host tier's at {n} sets")
        ms = _device_ms(torch, lambda: cuda_tower.pairing_fused_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.pairing_fused_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.pairing_fused_plain(*args))
        bound_ms, bound_by = _bound(muls["pairing_fewest"], K3_BYTES_PER_SET, n)
        rows[n] = dict(sets=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["pairing_warp"], first_launch_bytes=first_bytes,
                       ptxas=figs)
        log(f"[k3] sets={n} match=canonical verdicts=host_tier invalid={int((~ok).sum())} "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


K2P_LANES = (8, 2 * 64 + 64)  # the grouped (64, 64) verdict's 2R + 64 Miller lanes
K2P_BYTES_PER_LANE = 4 * (3 * 32 + 3 * 64 + 384)  # P and Q projective in; the Fp12 out
FE_LANES = (1, 16, 256)  # a batch verdict's one product; the bisection probe; 256
FE_BYTES_PER_LANE = 4 * (384 + 384)  # the Fp12 in and out


def _projective_inputs(np, n: int, seed: int):
    """n projective Miller lanes: `_miller_inputs`'s affine points times
    random Z (Zp ∈ Fp, Zq ∈ Fp2, Montgomery form), every coordinate as
    its value plus p, in [p, 2p); lane 0 gets Zp = 0, lane 1 Zq = 0."""
    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.ops.limbs import R_MONT, int_to_limbs, limbs_to_int

    xp, yp, xq, yq = _miller_inputs(np, n, seed)
    rng = np.random.default_rng(seed + 1)
    r = R_MONT % P

    def rand_fp() -> int:
        return int.from_bytes(rng.bytes(48), "little") % (P - 1) + 1

    def high(v: int):
        return int_to_limbs(v % P + P)

    p_out = [np.empty_like(xp) for _ in range(3)]
    q_out = [np.empty_like(xq) for _ in range(3)]
    for i in range(n):
        z = rand_fp()
        for c, a in ((0, xp), (1, yp)):
            p_out[c][i] = high(limbs_to_int(a[i]) * z)
        p_out[2][i] = high(z * r)
        z0, z1 = rand_fp(), rand_fp()
        for c, a in ((0, xq), (1, yq)):
            a0, a1 = limbs_to_int(a[i, 0]), limbs_to_int(a[i, 1])
            q_out[c][i] = [high(a0 * z0 - a1 * z1), high(a0 * z1 + a1 * z0)]
        q_out[2][i] = [high(z0 * r), high(z1 * r)]
    p_out[2][0] = 0
    q_out[2][1] = 0
    return p_out + q_out


def _kernel_ptxas(ptxas: dict, kernel: str) -> dict:
    """ptxas's figures for one kernel (registers, shared memory, stack
    frame, spill stores and loads)."""
    for name, figs in ptxas.items():
        if kernel in name:
            return figs
    raise AssertionError(f"ptxas reported no figures for {kernel}")


def phase_k2p(torch, np, muls: dict, ptxas: dict):
    """K2p against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower

    figs = _kernel_ptxas(ptxas, "miller_proj_warp_kernel")
    rounds = muls["miller_loop_proj_warp_rounds"]
    log(f"[k2p] miller_proj_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['miller_loop_proj_warp']} Fp multiplies and {rounds} dependent rounds per lane "
        f"in its schedule, {muls['miller_loop_proj']} in the one-thread lane; the bound counts "
        f"the fewer, {muls['miller_loop_proj_fewest']} (host counts)")
    if figs.get("stack", 0) or figs.get("spill_stores", 0) or figs.get("spill_loads", 0):
        raise AssertionError("K2p's kernel uses a stack or spills: its launcher raises no limit")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in K2P_LANES:
        args = [torch.as_tensor(a).to(dev) for a in _projective_inputs(np, n, SEED + 30 + n)]
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args))
        if first_bytes is None:
            first_bytes = taken
            log(f"[k2p] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB)")
        want = cuda_tower.miller_loop_proj_plain(*args)
        torch.cuda.synchronize()
        if not bool((got[:2] >= 0).all() & (got[:2] < 4096).all()):
            raise AssertionError("K2p's Zp = 0 / Zq = 0 lanes returned no limbs")
        err = _canonical_err(torch, got[2:], want[2:])
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K2p differs from its plain version at {n} lanes")
        ms = _device_ms(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.miller_loop_proj_cuda(*args), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.miller_loop_proj_plain(*args))
        bound_ms, bound_by = _bound(muls["miller_loop_proj_fewest"], K2P_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["miller_loop_proj_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[k2p] lanes={n} match=canonical (lanes 2..{n - 1}; Zp = 0, Zq = 0 lanes ran) "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


def _fp12_inputs(np, n: int, seed: int):
    """n Fp12 lanes of random values in [0, 2p) (the edges 0, 1, p−1, p and
    2p−1 among lane 0's coefficients); from 16 lanes up, lane 1 is zero and
    lane 2 the identity."""
    from lodestar_tpu_torch.ops.limbs import ONE_MONT_LIMBS

    fs = _random_limbs(np.random.default_rng(seed), 12 * n).reshape(n, 2, 3, 2, 32)
    if n >= 16:
        fs[1] = 0
        fs[2] = 0
        fs[2, 0, 0, 0] = ONE_MONT_LIMBS
    return fs


def phase_fe(torch, np, muls: dict, ptxas: dict):
    """K3-fe against its plain version; returns (max_err, {lanes: row})."""
    from lodestar_tpu_torch.ops import cuda_tower, fp12

    figs = _kernel_ptxas(ptxas, "final_exp_warp_kernel")
    rounds = muls["final_exp_warp_rounds"]
    log(f"[fe] final_exp_warp_kernel: {figs.get('registers')} registers, "
        f"{figs.get('smem')} B shared, {figs.get('stack')} B stack frame, "
        f"{figs.get('spill_stores')} B spill stores, {figs.get('spill_loads')} B spill loads; "
        f"{muls['final_exp_warp']} Fp multiplies and {rounds} dependent rounds per lane in "
        f"its schedule, {muls['final_exp_fewest']} the fewest the function needs (the "
        f"bound's count; host counts)")
    dev = torch.device("cuda")
    max_err = 0
    rows = {}
    first_bytes = None
    for n in FE_LANES:
        fs = torch.as_tensor(_fp12_inputs(np, n, SEED + 40 + n)).to(dev)
        got, taken = _device_bytes_taken(torch, lambda: cuda_tower.final_exp_cuda(fs))
        if first_bytes is None:
            first_bytes = taken
            log(f"[fe] first launch took {taken} B of device memory "
                f"({taken / 2**20:.1f} MiB), before any other tower kernel ran")
        want = cuda_tower.final_exp_plain(fs)
        torch.cuda.synchronize()
        err = _canonical_err(torch, got, want)
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"K3-fe differs from its plain version at {n} lanes")
        if n >= 16 and not (bool((got[1] == 0).all()) and bool(fp12.is_one(got[2]))):
            raise AssertionError("K3-fe: the zero lane or the identity lane went astray")
        ms = _device_ms(torch, lambda: cuda_tower.final_exp_cuda(fs), 20)
        call_ms = _time_ms(torch, lambda: cuda_tower.final_exp_cuda(fs), 20)
        plain_ms = _event_ms(torch, lambda: cuda_tower.final_exp_plain(fs))
        bound_ms, bound_by = _bound(muls["final_exp_fewest"], FE_BYTES_PER_LANE, n)
        rows[n] = dict(lanes=n, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, rounds=rounds, us_per_round=ms * 1e3 / rounds,
                       schedule_fp_muls=muls["final_exp_warp"],
                       first_launch_bytes=first_bytes, ptxas=figs)
        log(f"[fe] lanes={n} match=canonical{' (zero and identity lanes held)' if n >= 16 else ''} "
            f"device_ms={ms:.6f} call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} "
            f"bound_ms={bound_ms:.8f} ({bound_by}) share_of_bound={bound_ms / ms:.6f} "
            f"us_per_round={ms * 1e3 / rounds:.4f}")
    return max_err, rows


def _counts():
    """This process's launch counts of K1-K4, K2p and K3-fe."""
    from lodestar_tpu_torch.parallel.mesh_pool import launch_counts

    return launch_counts()


def _reset_counts():
    from lodestar_tpu_torch.parallel.mesh_pool import launch_counts

    launch_counts(reset=True)


def _run_counted(torch, fn, verifier=None):
    """fn() with every launch count (and the verifier's stage clock) set to
    0 just before and read just after; returns (result, seconds, counts)."""
    torch.cuda.synchronize()
    if verifier is not None:
        verifier.stage_seconds.clear()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts()


@contextmanager
def _products_per_launch():
    """{"K1": Counter, "K4": Counter}: the products of every K1 and K4
    launch made inside the block, seen by wrapping the two wrappers (which
    still count the launches)."""
    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    seen = {"K1": Counter(), "K4": Counter()}
    wrapped = [(cuda_fp, "mont_mul_cuda", "K1"), (cuda_mxu, "mont_mul_mxu_cuda", "K4")]
    saved = [getattr(mod, name) for mod, name, _ in wrapped]
    for (mod, name, key), fn in zip(wrapped, saved):
        def spy(a, b, _fn=fn, _seen=seen[key]):
            out = _fn(a, b)
            if a.numel():  # an empty call launches nothing
                _seen[a.numel() // 32] += 1
            return out

        setattr(mod, name, spy)
    try:
        yield seen
    finally:
        for (mod, name, _), fn in zip(wrapped, saved):
            setattr(mod, name, fn)


def _check_products(products: dict, counts: dict, tag: str):
    for k, seen in products.items():
        if sum(seen.values()) != counts[k]:
            raise AssertionError(f"{tag}: {counts[k]} {k} launches, {sum(seen.values())} seen")
    log(f"{tag} products per launch -> launches: "
        + "; ".join(f"{k} {json.dumps(dict(sorted(v.items())))}" for k, v in products.items()))


def launch_mix(torch, np, name: str, mix: Counter, kernel, plain, bound):
    """The device and call times per launch of `kernel`, the plain version's
    time and the bound, each the mean over the main path's launches (`mix`:
    products → launches); every product count checked limb for limb
    against the plain version and timed anew on random operands."""
    rng = np.random.default_rng(SEED + 21)
    dev = torch.device("cuda")
    total = sum(mix.values())
    ms = call_ms = plain_ms = bound_ms = 0.0
    bound_parts = Counter()  # the mean bound, split by what bounds each count
    for n, k in sorted(mix.items()):
        a = torch.as_tensor(_random_limbs(rng, n)).to(dev)
        b = torch.as_tensor(_random_limbs(rng, n)[::-1].copy()).to(dev)
        if not torch.equal(kernel(a, b), plain(a, b)):
            raise AssertionError(f"[{name}] the kernel differs from its plain version at "
                                 f"{n} products")
        t = _device_ms(torch, lambda: kernel(a, b), 50)
        tc = _time_ms(torch, lambda: kernel(a, b), 50)
        tp = _time_ms(torch, lambda: plain(a, b), 3)
        bd, by = bound(n)
        log(f"[{name}] products={n} launches={k} match=exact device_ms={t:.6f} call_ms={tc:.6f} "
            f"plain_ms={tp:.6f} bound_ms={bd:.8f} ({by})")
        ms += k * t / total
        call_ms += k * tc / total
        plain_ms += k * tp / total
        bound_ms += k * bd / total
        bound_parts[by] += k * bd / total
    by = max(bound_parts, key=bound_parts.get)
    log(f"[{name}] per launch over {total} main-path launches: device_ms={ms:.6f} "
        f"call_ms={call_ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} ({by}) "
        f"share_of_bound={bound_ms / ms:.6f}")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)


def _need(counts: dict, route: str, *kernels):
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{route}: the route launched {k} no time")


def _need_main(counts: dict, route: str, verdicts: int = 1):
    """A batch verdict's Miller stage and final exponentiation: K2p and
    K3-fe launched once per verdict (per part or chunk)."""
    for k in ("K2p", "K3-fe"):
        if counts[k] != verdicts:
            raise AssertionError(f"{route}: {counts[k]} {k} launches, expected {verdicts}")


def phase_per_set(torch, np, sets, host_ok, bad, host_bad):
    """The per-set verdict path on the card; returns its launch counts and
    wall times by route."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[per-set]"
    v = TorchBlsVerifier(device="cuda", mesh=None, rng=np.random.default_rng(SEED))
    out = {}

    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(sets), v)
    if got != host_ok or not all(got):
        raise AssertionError("(a) the valid batch's per-set verdicts differ from the host tier's")
    _need(counts, "(a) bisection, valid", "K1", "K2p", "K3-fe")
    if counts["K3"] != 0:
        raise AssertionError("(a) the root passed, yet K3 was launched")
    out["a"] = dict(seconds=secs, counts=counts, **v.last_bisect)
    log(f"{tag} (a) {PER_SET_N} valid sets: all True in {secs:.3f} s (first call); "
        f"launches {json.dumps(counts)}; rounds {v.last_bisect['rounds']}; "
        f"stages {json.dumps(v.stage_seconds)}")

    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(bad), v)
    if got != host_bad:
        raise AssertionError("(b) the tampered batch's per-set verdicts differ from the host tier's")
    _need(counts, "(b) bisection, three invalid", "K1", "K2p", "K3-fe")
    out["b"] = dict(seconds=secs, counts=counts, **v.last_bisect)
    log(f"{tag} (b) 3 tampered of {PER_SET_N}: invalid at {[i for i, ok in enumerate(got) if not ok]} "
        f"= host tier, in {secs:.3f} s; rounds {v.last_bisect['rounds']}, probes "
        f"{v.last_bisect['probes']}; launches {json.dumps(counts)}; "
        f"stages {json.dumps(v.stage_seconds)}")

    arrs = v._marshal(bad)
    got, secs, counts = _run_counted(torch, lambda: v.verify_individual(arrs).cpu().numpy())
    if list(map(bool, got[:PER_SET_N])) != host_bad:
        raise AssertionError("(c) verify_individual's verdicts differ from the host tier's")
    if counts["K3"] != 1:
        raise AssertionError(f"(c) expected one K3 launch, got {counts['K3']}")
    out["c"] = dict(seconds=secs, counts=counts)
    log(f"{tag} (c) verify_individual on the tampered bucket: = host tier in {secs:.6f} s; "
        f"launches {json.dumps(counts)}")

    sixteen = list(sets[:16])
    bad_enc = bytearray(sixteen[7].signature)
    from lodestar_tpu_torch.bls.api import SignatureSet
    from lodestar_tpu_torch.bls.fields import P

    bad_enc[:48] = P.to_bytes(48, "big")  # x.c1 = p under valid flags
    bad_enc[0] |= 0x80 | (sixteen[7].signature[0] & 0x20)
    sixteen[7] = SignatureSet(sixteen[7].pubkey, sixteen[7].message, bytes(bad_enc))
    host16 = _host_verdicts(sixteen)
    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets_individual(sixteen))
    if got != host16 or got[7]:
        raise AssertionError("(d) the one-at-a-time verdicts differ from the host tier's")
    # the bad encoding fails to marshal on its own too, so it launches nothing
    if counts["K3"] != 15:
        raise AssertionError(f"(d) expected 15 K3 launches, got {counts['K3']}")
    out["d"] = dict(seconds=secs, counts=counts)
    log(f"{tag} (d) 16 sets, one bad encoding: {sum(got)} True, set 7 False = host tier, "
        f"in {secs:.3f} s; launches {json.dumps(counts)}")
    return out


def phase_pairing_check(torch, np, sets, host_ok, bad, host_bad):
    """Π e(pk_i, H_i)·e(−g1, sig_i) == 1 through `pairing.pairing_check`
    (K2, then K3-fe on the product); returns the launches of each check."""
    from lodestar_tpu_torch.ops import cuda_tower, pairing
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    dev = torch.device("cuda")
    marshal = TorchBlsVerifier(device="cpu")._marshal
    result = {}
    for name, batch, want in (("valid", sets, all(host_ok)), ("tampered", bad, all(host_bad))):
        arrs = marshal(batch)
        t = [torch.as_tensor(getattr(arrs, k)).to(dev)
             for k in ("pk_x", "pk_y", "msg_x", "msg_y", "sig_x", "sig_y")]
        xs, ys, qx, qy = cuda_tower.pairing_lanes(*t)
        valid = torch.ones(xs.shape[0], dtype=torch.bool, device=dev)
        got, secs, counts = _run_counted(
            torch, lambda: bool(pairing.pairing_check((xs, ys), (qx, qy), valid)))
        if got != want:
            raise AssertionError(f"pairing_check on the {name} batch: {got}, host tier {want}")
        _need(counts, f"pairing_check ({name})", "K2", "K3-fe")
        if counts["K2p"] != 0:
            raise AssertionError(f"pairing_check ({name}): K2p launched on an affine route")
        result[name] = dict(seconds=secs, counts=counts)
        log(f"[pairing-check] {name}: {got} = host tier, {xs.shape[0]} Miller lanes in "
            f"{secs:.3f} s; launches {json.dumps(counts)}")
    return result


SERVE_ROOTS, SERVE_PER_ROOT = 16, 8  # one full 128-set job: the grouped (16, 8) shape


class ServeObserver:
    """A recording observer for the facade: counts of planner paths,
    stages, cache and epoch-table events, and the bisection outcomes.
    Thread-safe: the marshal pool's threads call it."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.counts = Counter()
        self.bisects = []

    def _add(self, key, n: int = 1):
        with self._lock:
            self.counts[key] += n

    def stage(self, name):
        from contextlib import nullcontext

        self._add(("stage", name))
        return nullcontext()

    def observe_stage(self, name, seconds):
        self._add(("stage", name))

    def planner(self, path, n_sets, group_sizes=None):
        self._add(("planner", path))

    def cache_event(self, cache, hit, n=1):
        self._add((cache, "hit" if hit else "miss"), n)

    def epoch_table_event(self, hit, n=1):
        self._add(("epoch_table", "hit" if hit else "miss"), n)

    def epoch_table_occupancy(self, rows):
        self._add(("epoch_table", "occupancy_updates"))

    def epoch_table_eviction(self, n=1):
        self._add(("epoch_table", "eviction"), n)

    def bisect(self, rounds, probes):
        with self._lock:
            self.bisects.append((rounds, probes))

    def device_busy_sample(self, busy_s):
        self._add(("device_busy_sample",))

    def decompress_fallback(self, n=1):
        self._add(("decompress_fallback",), n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"/".join(k): v for k, v in sorted(self.counts.items())}


def phase_serve(torch, np):
    """The port's `DeviceBlsVerifier` on the card, as a serving stack calls
    it: the epoch table populated with the phase's 128 keys, the hash
    cache warmed over its 16 roots, then one full 128-set job (grouped
    16 × 8) valid and with three bad signatures, and the per-set verdicts
    of the tampered job. Every verdict equals the host tier's, every
    pubkey comes from the table (no G1 decompression), and the observer
    sees the planner paths and the stage, bisect and cache events."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
    from lodestar_tpu_torch.profile_verdict import make_sets

    tag = "[serve]"
    sets = make_sets(SERVE_ROOTS, SERVE_PER_ROOT, seed=SEED + 50, threads=THREADS)
    bad = sets
    for k in (5, 64, 127):  # another key's signature over the same root
        bad = _tamper_one(bad, k, "signature", k - 1)
    host_ok, host_bad = _host_verdicts(sets), _host_verdicts(bad)
    if not all(host_ok) or [i for i, ok in enumerate(host_bad) if not ok] != [5, 64, 127]:
        raise AssertionError(f"{tag} the host tier's verdicts are not the expected ones")
    obs = ServeObserver()
    dev = DeviceBlsVerifier(device="cuda", mesh=None, observer=obs,
                            rng=np.random.default_rng(SEED))
    out = {}

    t0 = time.perf_counter()
    rows = dev.epoch_table_populate(0, [s.pubkey.to_bytes() for s in sets])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snap = dev.epoch_table_snapshot()
    table = dev._inner._epoch_table
    out["populate"] = dict(rows=rows, device_bytes=table.device_bytes(), seconds=secs)
    log(f"{tag} epoch_table_populate: {rows} rows, {table.device_bytes()} B on the device, "
        f"{secs:.6f} s; snapshot {json.dumps(snap)}")
    if rows != len(sets) or not snap["entries"][0]["device_resident"]:
        raise AssertionError(f"{tag} the epoch table does not hold every key on the device")
    gathered = table.gather_device(0, [0, rows - 1])
    want = []
    for s in (sets[0], sets[-1]):
        rc, limbs = native.g1_decompress(s.pubkey.to_bytes(), check_subgroup=False)
        want.append(np.concatenate(limbs))
    if rc != 0 or not np.array_equal(gathered.cpu().numpy(), np.stack(want)):
        raise AssertionError(f"{tag} the device rows differ from the decompressed keys")

    t0 = time.perf_counter()
    hashed = dev.warm_h2c({s.message for s in sets})
    secs = time.perf_counter() - t0
    out["warm_h2c"] = dict(hashed=hashed, seconds=secs)
    log(f"{tag} warm_h2c: {hashed} roots hashed in {secs:.6f} s; cache {dev.h2c_cache_size()}")
    if hashed != SERVE_ROOTS:
        raise AssertionError(f"{tag} warm_h2c hashed {hashed} roots, expected {SERVE_ROOTS}")

    decompressions = Counter()
    real = native.g1_decompress

    def spy(*args, **kwargs):
        decompressions["g1"] += 1
        return real(*args, **kwargs)

    native.g1_decompress = spy
    try:
        for name, batch, want in (("valid", sets, True), ("three bad signatures", bad, False)):
            got, secs, counts = _run_counted(
                torch, lambda: dev.verify_signature_sets(batch), dev._inner)
            log(f"{tag} {len(batch)}-set job, {name}: port {got}, host tier {want}, "
                f"{secs:.3f} s; launches {json.dumps(counts)}")
            if got is not want:
                raise AssertionError(f"{tag} {name}: the port says {got}, the host tier {want}")
            _need_main(counts, f"{tag} {name}")
            out[name] = dict(seconds=secs, counts=counts)
        got, secs, counts = _run_counted(
            torch, lambda: dev.verify_signature_sets_individual(bad), dev._inner)
        log(f"{tag} verify_signature_sets_individual: invalid at "
            f"{[i for i, ok in enumerate(got) if not ok]} = host tier, {secs:.3f} s; "
            f"bisection {json.dumps(dev._inner.last_bisect)}; launches {json.dumps(counts)}")
        if got != host_bad:
            raise AssertionError(f"{tag} the per-set verdicts differ from the host tier's")
        _need(counts, f"{tag} individual", "K2p", "K3-fe")
        out["individual"] = dict(seconds=secs, counts=counts, **dev._inner.last_bisect)
    finally:
        native.g1_decompress = real
    seen = obs.snapshot()
    log(f"{tag} observer {json.dumps(seen)}; bisections {obs.bisects}; "
        f"G1 decompressions during the verdicts {decompressions['g1']}")
    if decompressions["g1"] != 0:
        raise AssertionError(f"{tag} a pubkey was decompressed: the table did not serve it")
    need = {"planner/root_grouped": 2, "planner/individual": 1,
            "epoch_table/hit": len(sets), "epoch_table/miss": 0}
    for key, n in need.items():
        if seen.get(key, 0) != n:
            raise AssertionError(f"{tag} observer {key} = {seen.get(key, 0)}, expected {n}")
    for key in ("stage/marshal", "stage/rand", "stage/dispatch", "stage/device_wait",
                "stage/bisect", "stage/hash_to_curve", "h2c/hit"):
        if not seen.get(key):
            raise AssertionError(f"{tag} the observer saw no {key}")
    if len(obs.bisects) != 1 or obs.bisects[0][0] <= 0:
        raise AssertionError(f"{tag} expected one bisection with rounds, got {obs.bisects}")
    out["observer"] = seen
    out["batch"] = (sets, host_ok)
    return out


OBSERVE_ORDER = "ABBABAAB"  # A: PipelineMetrics, B: NullObserver; 4 jobs a side
OBSERVE_SCOPES = ("bls/g2_decompress", "bls/msm_planes", "bls/miller_loop",
                  "bls/product_tree", "bls/final_exp_batch")
# kernel -> (its name in the trace, the scope its launch must lie in)
OBSERVE_KERNELS = {"K2p": ("miller_proj_warp_kernel", "bls/miller_loop"),
                   "K3-fe": ("final_exp_warp_kernel", "bls/final_exp_batch")}


def _median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


class _CallLog:
    """An observer that forwards every call to `target` and logs it
    (method, args, kwargs), to replay one job's calls. Thread-safe: the
    marshal pool's threads call the observer."""

    def __init__(self, target):
        import threading

        self._target = target
        self._lock = threading.Lock()
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._target, name)

        def call(*args, **kwargs):
            with self._lock:
                self.calls.append((name, args, kwargs))
            return fn(*args, **kwargs)

        return call


def _host_cost_us(torch, calls, reps: int = 2000) -> dict:
    """What observing one job costs the host, in µs: its observer calls
    replayed on a fresh `PipelineMetrics` (stage timers entered and
    left), one `named_scope` (record_function + NVTX) entered and left,
    and one call through the compile ledger's wrap of a function that
    does nothing, on the 8 tensors of a (16, 8) grouped verdict, less the
    same call unwrapped; each the mean over `reps`."""
    from lodestar_tpu_torch.observability import PipelineMetrics, compile_ledger, trace

    pm = PipelineMetrics()
    t0 = time.perf_counter()
    for _ in range(reps):
        for name, args, kwargs in calls:
            out = getattr(pm, name)(*args, **kwargs)
            if name == "stage":
                with out:
                    pass
    observer = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        with trace.named_scope("bls/miller_loop"):
            pass
    scope = (time.perf_counter() - t0) / reps
    args = [torch.zeros((16, 8, 32), dtype=torch.int32, device="cuda") for _ in range(7)]
    args.append(torch.zeros((16, 8), dtype=torch.bool, device="cuda"))
    fn = lambda *a: None  # noqa: E731
    wrapped = compile_ledger.CompileLedger().wrap(fn, "grouped_raw")
    wrapped(*args)  # the first call is the event
    t0 = time.perf_counter()
    for _ in range(reps):
        wrapped(*args)
    t1 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    ledger = ((t1 - t0) - (time.perf_counter() - t1)) / reps
    return {"observer_calls": len(calls), "observer_us": observer * 1e6,
            "scope_us": scope * 1e6, "ledger_call_us": ledger * 1e6}


def _trace_check(path: str) -> dict:
    """The scopes and kernels of one exported Chrome trace: per scope its
    host spans (`user_annotation`), per kernel its launches and how many
    of them were issued inside the scope it belongs to (the launch's
    runtime call, matched by correlation id, inside one of the scope's
    spans)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {s: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == s and e.get("cat") == "user_annotation" and "dur" in e]
             for s in OBSERVE_SCOPES}
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {"scopes": {s: len(v) for s, v in spans.items()}, "kernels": {}}
    for k, (name, scope) in OBSERVE_KERNELS.items():
        launches = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
        inside = sum(
            1 for e in launches
            if any(a <= issued.get(e.get("args", {}).get("correlation"), -1) <= b
                   for a, b in spans[scope]))
        out["kernels"][k] = {"launches": len(launches), "in_scope": inside, "scope": scope}
    out["categories"] = sorted({str(e.get("cat")) for e in events})
    return out


def phase_observe(torch, np):
    """The port's observability on the card: serve-128's valid 128-set job
    (grouped 16 × 8) through `DeviceBlsVerifier(device="cuda")` with a
    `PipelineMetrics` and with `NullObserver`, alternating (A B B A B A A
    B: 4 jobs a side, each counted), then one job under
    `start_profiling` / `stop_profiling`; the device and compile ledgers
    after. Fails unless every verdict is the host tier's, the stage
    histogram counts marshal, rand, dispatch and device_wait, the trace
    holds the verdict's five scopes and K2p and K3-fe launched inside
    theirs, the device ledger reads the card's in-use and total bytes,
    and the compile ledger holds one event per library built or found."""
    from lodestar_tpu_torch import build
    from lodestar_tpu_torch.chain.bls_verifier import DeviceBlsVerifier
    from lodestar_tpu_torch.observability import (
        NULL_OBSERVER,
        PipelineMetrics,
        compile_ledger,
        device_ledger,
        runtime_info,
    )
    from lodestar_tpu_torch.profile_verdict import make_sets

    tag = "[observe]"
    sets = make_sets(SERVE_ROOTS, SERVE_PER_ROOT, seed=SEED + 50, threads=THREADS)
    if not all(_host_verdicts(sets)):
        raise AssertionError(f"{tag} the host tier rejects the valid job")
    pm = PipelineMetrics()
    pm.set_build_info(runtime_info())
    arms = {"A": DeviceBlsVerifier(device="cuda", mesh=None, observer=pm,
                                   rng=np.random.default_rng(SEED)),
            "B": DeviceBlsVerifier(device="cuda", mesh=None, observer=NULL_OBSERVER,
                                   rng=np.random.default_rng(SEED))}
    log_obs = _CallLog(PipelineMetrics())
    arms["log"] = DeviceBlsVerifier(device="cuda", mesh=None, observer=log_obs,
                                    rng=np.random.default_rng(SEED))
    for v in arms.values():  # as serve: the table, the roots, one warm job
        v.epoch_table_populate(0, [s.pubkey.to_bytes() for s in sets])
        v.warm_h2c({s.message for s in sets})
        if v.verify_signature_sets(sets) is not True:
            raise AssertionError(f"{tag} the warm-up job was rejected")
    pm_warm = {k: v["count"] for k, v in pm.stage_snapshot().items()}
    log_obs.calls.clear()  # one warm job's observer calls, for the replay
    if arms.pop("log").verify_signature_sets(sets) is not True:
        raise AssertionError(f"{tag} the logged job was rejected")
    cost = _host_cost_us(torch, log_obs.calls)
    # a grouped job enters 7 named scopes (g2_decompress, msm_g1, msm_g2,
    # miller_loop, product_tree, final_exp, plane_subgroup) and makes one
    # ledger-wrapped call (grouped_raw)
    cost["job_us"] = cost["observer_us"] + 7 * cost["scope_us"] + cost["ledger_call_us"]
    log(f"{tag} host cost of observing one job: {cost['observer_calls']} observer calls "
        f"{cost['observer_us']:.1f} us replayed on PipelineMetrics; a named scope "
        f"{cost['scope_us']:.2f} us; a ledger-wrapped call {cost['ledger_call_us']:.2f} us over "
        f"the unwrapped one; {cost['job_us']:.1f} us per job in all")
    secs = {"A": [], "B": []}
    for arm in OBSERVE_ORDER:
        v = arms[arm]
        got, t, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v._inner)
        if got is not True:
            raise AssertionError(f"{tag} arm {arm}: the port says {got}, the host tier True")
        _need_main(counts, f"{tag} arm {arm}")
        secs[arm].append(t)
    med = {arm: _median(ts) for arm, ts in secs.items()}
    log(f"{tag} 128-set job, PipelineMetrics: median {med['A']:.6f} s of "
        f"{json.dumps([round(t, 6) for t in secs['A']])}")
    log(f"{tag} 128-set job, NullObserver: median {med['B']:.6f} s of "
        f"{json.dumps([round(t, 6) for t in secs['B']])}")
    log(f"{tag} observer cost: median difference {med['A'] - med['B']:+.6f} s per job "
        f"(PipelineMetrics - NullObserver), order {OBSERVE_ORDER}")
    stages = pm.stage_snapshot()
    log(f"{tag} stage histogram {json.dumps(stages)}")
    for stage in ("marshal", "rand", "dispatch", "device_wait"):
        if stages.get(stage, {}).get("count", 0) - pm_warm.get(stage, 0) < len(secs["A"]):
            raise AssertionError(f"{tag} the stage histogram did not count {stage} per job")
    log(f"{tag} planner {json.dumps(pm.planner_snapshot())}")

    v = arms["A"]
    trace_dir = os.path.join(build.BUILD_DIR, "observe_trace")
    if v.start_profiling(trace_dir) != trace_dir:
        raise AssertionError(f"{tag} the profiler did not start")
    try:
        got, t, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v._inner)
    finally:
        stopped = v.stop_profiling()
    traces = sorted(
        (os.path.join(stopped, f) for f in os.listdir(stopped) if f.endswith(".json")),
        key=os.path.getmtime)
    t0 = time.perf_counter()
    seen = _trace_check(traces[-1])
    log(f"{tag} profiled job: {got}, {t:.3f} s; launches {json.dumps(counts)}; trace "
        f"{os.path.getsize(traces[-1])} B, read in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(seen)}")
    if got is not True:
        raise AssertionError(f"{tag} the profiled job was rejected")
    missing = [s for s, n in seen["scopes"].items() if n == 0]
    if missing:
        raise AssertionError(f"{tag} the trace lacks the scopes {missing}")
    for k, row in seen["kernels"].items():
        if row["launches"] != counts[k] or row["in_scope"] != row["launches"]:
            raise AssertionError(f"{tag} {k}: {row} in the trace, {counts[k]} launches counted")

    led = device_ledger.ledger()
    led.sample_memory(force=True)
    dev_snap = led.snapshot()
    log(f"{tag} device ledger memory {json.dumps(dev_snap['memory'])}")
    card = dev_snap["memory"].get("0", {})
    if not (card.get("in_use", 0) > 0 and card.get("limit", 0) > 0):
        raise AssertionError(f"{tag} the device ledger read no in_use or limit bytes")

    events = compile_ledger.ledger().snapshot()["events"]
    libs = sorted(build._LIBS)
    builds = {name: [e["cache"] for e in events if e["kernel"] == f"build/{name}"]
              for name in libs}
    firsts = [(e["kernel"], e["key"], e["seconds"], e["cache"]) for e in events
              if not e["kernel"].startswith("build/")]
    log(f"{tag} compile ledger: builds {json.dumps(builds)}; first calls {json.dumps(firsts)}")
    for name, outcomes in builds.items():
        if len(outcomes) != 1 or outcomes[0] not in ("hit", "miss"):
            raise AssertionError(f"{tag} library {name}: ledger events {outcomes}")
    build_info = [ln for ln in pm.registry.expose().splitlines()
                  if ln.startswith("lodestar_tpu_build_info")]
    log(f"{tag} {build_info[0]}")
    return dict(median_s=med, seconds=secs, trace=seen, builds=builds, host_cost_us=cost)


# -- 12b. node: the serving stack ------------------------------------------------

NODE_KEYS = 32768  # one slot's committees at 2^20 active validators (2^20 / 32)
NODE_WINDOW_S = 4.0  # attestations arrive over the first third of the 12 s slot
NODE_SLOT_S = 12.0
NODE_CALLERS = 1024  # gossip validation threads, each blocked in its call
NODE_TAMPERED = (1000, 3000)  # carry the next set's signature (same root, another key)
NODE_MAIN_CALLS = 2048  # the coalesce-512 slot: its first 2 s, to make room for the capella phase
NODE_MAIN_TAMPERED_AT = 1000  # the arrival whose set is tampered among those 2048 calls
NODE_BLOCK_AT = (0.0, 2.0)  # the 128-set block job's arrivals
NODE_BOOT_SLO_S = 10.0  # dashboards/slo_rules.json `serving_ready`
NODE_SIZE_BINS = (1, 32, 64, 128, 256, 512, 1024, 2048, 4096)
NODE_KERNELS = ("K1", "K4", "K2", "K2p", "K3", "K3-fe")  # the preload launches each once


class DrillFaults:
    """The fault seam the drills inject into the facade (duck-typed as the
    JAX package's `testing.faults`): `exception` raises on every device
    dispatch, `latency` sleeps `latency_s` on the host before it, `flaky`
    turns every True verdict False."""

    def __init__(self):
        self.mode = None
        self.latency_s = 0.0
        self.injected = Counter()

    def on_device_dispatch(self, n_sets: int) -> None:
        if self.mode == "exception":
            self.injected["exception"] += 1
            raise RuntimeError("injected device exception")
        if self.mode == "latency":
            self.injected["latency"] += 1
            time.sleep(self.latency_s)

    def flaky_verdict(self, verdict: bool) -> bool:
        if self.mode == "flaky" and verdict:
            self.injected["flaky"] += 1
            return False
        return verdict

    def flaky_verdicts(self, verdicts):
        return [self.flaky_verdict(v) for v in verdicts]

    def snapshot(self) -> dict:
        return {"active": self.mode is not None,
                "modes": {self.mode: 1.0} if self.mode else {},
                "injected": dict(self.injected)}

    def configure(self, spec):
        self.mode = spec or None
        return self.snapshot()

    def clear(self, reset_counters: bool = False) -> None:
        self.mode = None
        if reset_counters:
            self.injected.clear()


def _counting(obj, *names):
    """Wrap methods of one instance so their calls and seconds are counted
    (the wrappers pass every call through); returns the Counter."""
    seen = Counter()
    for name in names:
        real = getattr(obj, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                seen[_name] += 1
                seen[_name + "_s"] += time.perf_counter() - t0

        setattr(obj, name, wrapped)
    return seen


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] if xs else None


def _traced_block(call, n_sets: int, slot: int, root: bytes):
    """`call()` run as block import runs a block's signature batch (the JAX
    package's `chain/chain.py:278-372`): a root `chain/process_block` span
    with the slot and the block root on the calling thread, its live
    context handed to a worker thread that attaches it and opens
    `chain/bls_verify` around the call. Returns (the result, the trace
    id)."""
    from lodestar_tpu_torch.observability import spans

    tracer = spans.tracer
    box = {}
    with tracer.span("chain/process_block", slot=slot, root=root.hex()) as blk:
        ctx = tracer.context()

        def verify():
            try:
                with tracer.attach(ctx), tracer.span("chain/bls_verify", sets=n_sets):
                    box["out"] = call()
            except BaseException as e:  # re-raised on the caller's thread
                box["error"] = e

        worker = threading.Thread(target=verify, name="block-verify")
        worker.start()
        worker.join()
    if "error" in box:
        raise box["error"]
    return box["out"], blk.trace_id


def _block_root(tag: str) -> bytes:
    import hashlib

    return hashlib.sha256(tag.encode()).digest()


def _tree(doc: dict) -> dict:
    """name -> [parent names] of a trace document's spans, and its events
    by span name."""
    names = {s["span_id"]: s["name"] for s in doc["spans"]}
    parents, events = {}, {}
    for s in doc["spans"]:
        parents.setdefault(s["name"], []).append(names.get(s["parent_id"]))
        events.setdefault(s["name"], []).extend(e["name"] for e in s.get("events", ()))
    return {"parents": parents, "events": events}


def _check_traces(tag: str, docs: list, ids: dict) -> dict:
    """Every trace of `ids` (name -> trace id) among the scraped `docs`,
    as `_tree`s; fails if one is missing."""
    by_id = {d["trace_id"]: d for d in docs}
    missing = [name for name, tid in ids.items() if tid not in by_id]
    if missing:
        raise AssertionError(f"{tag} /debug/traces lacks the traces of {missing}")
    return {name: _tree(by_id[tid]) for name, tid in ids.items()}


def _lifecycle_total(text: str) -> float:
    """The sum over kinds of `lodestar_lifecycle_traces_total` in a scrape."""
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("lodestar_lifecycle_traces_total{"))


def _span_cost_us(reps: int = 2000, rounds: int = 5) -> dict:
    """The host microseconds of one span (`with tracer.span(...)`, nested in
    a live trace, attributes given) on an enabled tracer and on a disabled
    one (the shared `_NULL`), replayed `reps` times a round; the medians of
    `rounds` rounds in turns, and their difference."""
    from lodestar_tpu_torch.observability.spans import Tracer

    def run(t):
        t0 = time.perf_counter()
        for _ in range(reps // 100):
            with t.trace("bench/trace"):
                for _ in range(100):
                    with t.span("bls/supervised_batch", sets=128):
                        pass
        return (time.perf_counter() - t0) / reps * 1e6

    on, off = Tracer(capacity=4), Tracer(enabled=False)
    times = {"enabled": [], "null": []}
    for _ in range(rounds):
        times["enabled"].append(run(on))
        times["null"].append(run(off))
        times["null"].append(run(off))
        times["enabled"].append(run(on))
    med = {k: _median(v) for k, v in times.items()}
    return {"enabled_us": med["enabled"], "null_us": med["null"],
            "span_us": med["enabled"] - med["null"]}


def _node_keys(np, slice_sets, block_sets):
    """The epoch table's keys: the slice phase's 4096, 28,672 more from
    seeded scalars (the host tier's sk_to_pk on THREADS threads) and the
    block job's 128."""
    from lodestar_tpu_torch import native
    from lodestar_tpu_torch.profile_verdict import secret_keys

    t0 = time.perf_counter()
    sks = secret_keys(np.random.default_rng(SEED + 70), NODE_KEYS - len(slice_sets))
    with ThreadPoolExecutor(THREADS) as pool:
        made = list(pool.map(native.sk_to_pk, sks))
    if any(rc for rc, _ in made):
        raise AssertionError("[node] the host tier failed to make a key")
    keys = ([s.pubkey.to_bytes() for s in slice_sets] + [pk for _, pk in made]
            + [s.pubkey.to_bytes() for s in block_sets])
    log(f"[node] {len(keys)} epoch-table keys ({len(made)} made with sk_to_pk on {THREADS} "
        f"threads in {time.perf_counter() - t0:.3f} s)")
    return keys


def _node_boot(torch):
    """(a) `python3 -m lodestar_tpu_torch.warmup` in a subprocess, the
    extensions already built: its rungs, serving_ready and peak memory."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lodestar_tpu_torch.warmup"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[node] the warm-boot ladder failed:\n{proc.stderr[-4000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    ready = doc["serving_ready_seconds"]
    doc["slo_met"] = ready is not None and ready <= NODE_BOOT_SLO_S
    doc["wall_s"] = wall
    pre = doc["preload"]
    log(f"[node] (a) boot: serving_ready {ready} s since process start (SLO <= "
        f"{NODE_BOOT_SLO_S} s {'met' if doc['slo_met'] else 'missed'}), subprocess wall "
        f"{wall:.3f} s, peak device memory {doc['peak_device_bytes']} B; builds "
        f"{json.dumps(doc['build_seconds'])}; rungs {json.dumps(doc['rung_seconds'])}; marks "
        f"{json.dumps(doc['marks'])}; card: {card_line()}")
    log(f"[node] (a) preload from the store: outcomes {json.dumps(pre['outcomes'])}, load "
        f"seconds {json.dumps(pre['load_seconds'])}, first-launch seconds "
        f"{json.dumps(pre['launch_seconds'])}, {pre['seconds']} s in all; aot_load mark "
        f"{doc['marks'].get('aot_load')} s since process start")
    # the extensions were built by this process: every library is in the store
    from lodestar_tpu_torch.build import SERVING

    if pre["outcomes"] != {name: "hit" for name in SERVING["cuda"]} or \
            sorted(pre["launch_seconds"]) != sorted(NODE_KERNELS) or "aot_load" not in doc["marks"]:
        raise AssertionError(f"[node] (a) the warm boot's preload: {json.dumps(pre)}")
    return doc


def _node_order(np, n: int):
    """(order, times) of a slot's n one-set calls: order[j] is the set that
    arrives j-th, at times[j] seconds, over the gossip window, in a seeded
    shuffle (the committees' roots interleaved)."""
    rng = np.random.default_rng(SEED + 80)
    times = np.sort(rng.uniform(0.0, NODE_WINDOW_S, n))
    return rng.permutation(n), times


def _node_slot(torch, np, tag, slice_sets, slice_host, block_sets, keys,
               calls: int | None = None, tampered_at=NODE_TAMPERED):
    """(b) one slot of gossip through a fresh `build_bls_stack` on cuda:0:
    4096 one-set attestation calls arriving uniformly over 4 s from a pool
    of 1024 caller threads, two of them tampered, and the 128-set block
    job at 0 s and 2 s, while the epoch table is populated.

    The sets arrive in a seeded shuffle, the 64 committees' roots
    interleaved, as on mainnet, where every committee attests at about the
    same moment. `calls` keeps the first calls of that stream only (the same arrival rate) and the tampered sets among them;
    `tampered_at` names the sets that carry another set's signature.

    Fails unless every verdict is the host tier's, the block lane shed
    nothing, no waiter timed out, every shed was prompt, and the card did
    the work: the supervisor fell back only for the negative audits of the
    batches that held a tampered set (two each: the merged batch, then its
    per-set verdicts' rejected sets), with no verdict mismatch, deadline,
    retry or double failure, the breaker closed, and K2p launched at least
    once per 128-set job the facade ran. Returns the figures, with the
    split of the device calls' time between waiting for the supervisor's
    one dispatch worker and running on it."""
    from lodestar_tpu_torch.chain.bls_verifier import BlsShedError
    from lodestar_tpu_torch.node.bls_stack import build_bls_stack
    from lodestar_tpu_torch.observability import device_ledger

    att = list(slice_sets)
    for k in tampered_at:
        att = _tamper_one(att, k, "signature", k + 1)
    want = list(slice_host)
    for k, ok in zip(tampered_at, _host_verdicts([att[k] for k in tampered_at])):
        want[k] = ok
    if [k for k, ok in enumerate(want) if not ok] != list(tampered_at):
        raise AssertionError(f"{tag} the host tier does not reject exactly the tampered sets")
    order, times = _node_order(np, len(att))
    calls = calls or len(att)
    order, times = [int(i) for i in order[:calls]], times[:calls]
    arrived = set(order)
    tampered = [k for k in tampered_at if k in arrived]
    bad_ids = {id(att[k]) for k in tampered}

    stack = build_bls_stack(device="cuda:0", mesh=None, metrics_port=0)
    traces0 = stack.tracer.completed_total
    pm, lanes, sup = stack.pipeline, stack.verifier, stack.supervisor
    batches = []  # (sets, reason, overlapped, seconds, held a tampered set)
    real_dispatch = lanes._dispatch_batch

    def dispatch(entries, n_sets, reason, overlapped):
        t0 = time.perf_counter()
        held = any(id(s) in bad_ids for e in entries for s in e[0])
        try:
            real_dispatch(entries, n_sets, reason, overlapped)
        finally:
            batches.append((n_sets, reason, overlapped, time.perf_counter() - t0, held))

    lanes._dispatch_batch = dispatch
    device_calls = []  # (seconds queued for the dispatch worker, seconds run on it)
    real_run = sup._dispatcher.run

    def run(fn, deadline_s):
        t_put = time.perf_counter()

        def timed_fn():
            t_run = time.perf_counter()
            try:
                return fn()
            finally:
                device_calls.append((t_run - t_put, time.perf_counter() - t_run))

        return real_run(timed_fn, deadline_s)

    sup._dispatcher.run = run
    per_set = _counting(sup, "verify_signature_sets_individual")
    cpu = _counting(stack.cpu, "verify_signature_sets", "verify_signature_sets_individual")
    jobs = _counting(stack.device._inner, "verify_signature_sets",
                     "verify_signature_sets_individual")
    h2c = _counting(stack.device, "warm_h2c")
    led0 = device_ledger.ledger().snapshot()
    results = {}
    blocks = []
    torch.cuda.synchronize()
    _reset_counts()
    t_start = time.perf_counter() + 0.05
    if not stack.populate_epoch_async(0, keys):
        raise AssertionError(f"{tag} the epoch population did not start")

    def attest(j):
        i = order[j]
        delay = t_start + times[j] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t0 = time.perf_counter()
        try:
            out = ("ok", lanes.verify_signature_sets([att[i]], lane="attestation"))
        except BlsShedError as e:
            out = ("shed", e.lane)
        results[i] = out + (t0 - t_start, time.perf_counter() - t_start)

    def block(at):
        delay = t_start + at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t0 = time.perf_counter()
        ok, trace_id = _traced_block(
            lambda: lanes.verify_signature_sets(block_sets, lane="block"), len(block_sets),
            NODE_BLOCK_AT.index(at), _block_root(f"{tag} block at {at}"))
        blocks.append((ok, t0 - t_start, time.perf_counter() - t_start, trace_id))

    block_threads = [threading.Thread(target=block, args=(at,)) for at in NODE_BLOCK_AT]
    for t in block_threads:
        t.start()
    with ThreadPoolExecutor(NODE_CALLERS) as pool:
        for f in [pool.submit(attest, j) for j in range(len(order))]:
            f.result()
    for t in block_threads:
        t.join()
    torch.cuda.synchronize()
    counts = _counts()
    stack.wait_populated()
    led1 = device_ledger.ledger().snapshot()
    lane_snap = pm.lanes_snapshot()
    sup_snap = pm.supervisor_snapshot()
    breaker = sup.breaker_state
    hits, misses = pm.epoch_table_hits.value(), pm.epoch_table_misses.value()
    t0 = time.perf_counter()
    docs = _scrape(stack.server.port, ("/debug/traces?limit=256", "/metrics"))
    scrape_s = time.perf_counter() - t0
    finished = stack.tracer.completed_total - traces0
    stack.close()
    trees = _check_traces(tag, docs["/debug/traces?limit=256"]["traces"],
                          {f"block at {b[1]:.3f} s": b[3] for b in blocks})
    counted = _lifecycle_total(docs["/metrics"])
    for name, tree in trees.items():
        if tree["parents"].get("bls/supervised_batch") != ["chain/bls_verify"]:
            raise AssertionError(f"{tag} the trace of the {name} job: {json.dumps(tree)}")
    if counted != finished or finished != len(blocks):
        raise AssertionError(f"{tag} lodestar_lifecycle_traces_total {counted}, traces finished "
                             f"{finished}, block jobs {len(blocks)}")
    log(f"{tag} /debug/traces (scraped with /metrics in {scrape_s:.3f} s): each block job's "
        f"trace holds bls/supervised_batch under chain/bls_verify "
        f"{json.dumps({n: t['parents'] for n, t in trees.items()})}; "
        f"lodestar_lifecycle_traces_total {counted:.0f} = {finished} traces finished")

    wrong = [i for i in order if results[i][0] == "ok" and results[i][1] != want[i]]
    sheds = [r for r in results.values() if r[0] == "shed"]
    slow_sheds = [r for r in sheds if r[3] - r[2] >= 1.0]
    if wrong:
        raise AssertionError(f"{tag} calls {wrong[:10]} differ from the host tier")
    if [b[0] for b in blocks] != [True] * len(NODE_BLOCK_AT):
        raise AssertionError(f"{tag} the block jobs: {blocks}")
    if lane_snap["sheds"].get("block", 0) or sup_snap["waiter_timeouts"] or slow_sheds:
        raise AssertionError(f"{tag} block sheds {lane_snap['sheds']}, waiter timeouts "
                             f"{sup_snap['waiter_timeouts']}, slow sheds {len(slow_sheds)}")
    false_calls = sorted(i for i in order if results[i][0] == "ok" and results[i][1] is False)
    if false_calls != [k for k in tampered if results[k][0] == "ok"]:
        raise AssertionError(f"{tag} False verdicts at {false_calls}")
    # the card did the work: the host tier only audited the tampered batches
    held = sum(1 for b in batches if b[4])
    fallbacks = {k: v for k, v in sup_snap["fallbacks"].items() if v}
    if fallbacks != ({"negative_audit": 2 * held} if held else {}) or breaker != "closed" \
            or any(sup_snap[k] for k in ("verdict_mismatches", "deadline_exceeded", "retries",
                                         "both_tiers_failed")):
        raise AssertionError(
            f"{tag} the host tier served more than the audits of the {held} tampered batches: "
            f"fallbacks {fallbacks}, breaker {breaker}, supervisor {json.dumps(sup_snap)}")
    n_jobs = jobs["verify_signature_sets"] + jobs["verify_signature_sets_individual"]
    _need(counts, f"{tag} slot", "K1", "K2p", "K3-fe")
    if counts["K2p"] < n_jobs:
        raise AssertionError(f"{tag} K2p launched {counts['K2p']} times for {n_jobs} jobs")
    ends = [r[3] for r in results.values()] + [b[2] for b in blocks]
    att_done = max(r[3] for r in results.values())
    block_lat = [b[2] - b[1] for b in blocks]
    sizes = [b[0] for b in batches]
    hist = Counter(next(f"<={b}" for b in NODE_SIZE_BINS if n <= b) for n in sizes)
    busy = led1["busy_wall_s"] - led0["busy_wall_s"]
    uptime = led1["uptime_s"] - led0["uptime_s"]
    waits = [w for w, _ in device_calls]
    ran = sum(r for _, r in device_calls)
    out = dict(
        order="interleaved",
        makespan_s=max(ends), slot_s=NODE_SLOT_S, att_sets_per_s=len(order) / att_done,
        att_done_s=att_done, block_p50_s=_pct(block_lat, 0.5), block_max_s=max(block_lat),
        att_sheds=len(sheds), shed_max_s=max((r[3] - r[2] for r in sheds), default=0.0),
        batches=len(sizes), batch_sizes=dict(sorted(hist.items(), key=lambda kv: int(kv[0][2:]))),
        batch_max=max(sizes), batch_reasons=dict(Counter(b[1] for b in batches)),
        overlap_fraction=lane_snap["overlap_fraction"], utilization=busy / uptime if uptime else 0,
        per_set_calls=per_set["verify_signature_sets_individual"],
        per_set_s=per_set["verify_signature_sets_individual_s"],
        audit_batch_calls=cpu["verify_signature_sets"], audit_batch_s=cpu["verify_signature_sets_s"],
        audit_set_calls=cpu["verify_signature_sets_individual"],
        audit_set_s=cpu["verify_signature_sets_individual_s"],
        device_calls=len(device_calls), device_wait_s=sum(waits),
        device_wait_max_s=max(waits, default=0.0), device_run_s=ran,
        worker_busy=ran / max(ends), jobs=jobs["verify_signature_sets"],
        jobs_s=jobs["verify_signature_sets_s"],
        set_jobs=jobs["verify_signature_sets_individual"],
        set_jobs_s=jobs["verify_signature_sets_individual_s"],
        warm_h2c_calls=h2c["warm_h2c"], warm_h2c_s=h2c["warm_h2c_s"],
        table_misses=misses, table_hits=hits, populate=stack.last_populate,
        calls=calls, tampered=[results[k][:2] for k in tampered], tampered_batches=held,
        launches=counts, fallbacks=fallbacks, mismatches=sup_snap["verdict_mismatches"])
    log(f"{tag} {out['order']} arrivals; makespan {out['makespan_s']:.3f} s against the "
        f"{NODE_SLOT_S:.0f} s slot (attestations done at {att_done:.3f} s: "
        f"{out['att_sets_per_s']:.1f} sets/s); block p50 {out['block_p50_s']:.3f} s, max "
        f"{out['block_max_s']:.3f} s; attestation sheds {len(sheds)} (slowest "
        f"{out['shed_max_s']:.6f} s); {len(sizes)} coalesced batches, sizes "
        f"{json.dumps(out['batch_sizes'])}, largest {out['batch_max']}, reasons "
        f"{json.dumps(out['batch_reasons'])}; lane_overlap_fraction {out['overlap_fraction']}; "
        f"device-ledger utilisation {out['utilization']:.4f} ({busy:.3f} of {uptime:.3f} s)")
    log(f"{tag} {len(device_calls)} supervised device calls ran {ran:.3f} s on the one dispatch "
        f"worker ({out['worker_busy']:.4f} of the makespan) and waited for it {sum(waits):.3f} s "
        f"in all (longest {out['device_wait_max_s']:.3f} s); inside them the facade ran "
        f"{out['jobs']} batch jobs in {out['jobs_s']:.3f} s ({out['jobs_s'] / max(1, out['jobs']):.3f}"
        f" s each) and {out['set_jobs']} per-set jobs in {out['set_jobs_s']:.3f} s; warm_h2c on "
        f"the lane threads {out['warm_h2c_calls']} calls {out['warm_h2c_s']:.3f} s")
    log(f"{tag} {calls} calls; the tampered sets {tampered} in {held} batches: {out['tampered']}; "
        f"per-set re-verification {out['per_set_calls']} calls {out['per_set_s']:.3f} s; host-tier "
        f"negative audit {out['audit_batch_calls']} batches {out['audit_batch_s']:.3f} s and "
        f"{out['audit_set_calls']} per-set {out['audit_set_s']:.3f} s; supervisor fallbacks "
        f"{json.dumps(fallbacks)} (only the audits), mismatches 0, breaker {breaker}")
    log(f"{tag} epoch table: {misses:.0f} misses, then {hits:.0f} hits; populate "
        f"{json.dumps(stack.last_populate)}; launches {json.dumps(counts)} (K2p >= {n_jobs} jobs);"
        f" card: {card_line()}")
    if "error" in (stack.last_populate or {}):
        raise AssertionError(f"{tag} the epoch population failed")
    return out


def _wait_for(cond, timeout_s: float, step_s: float = 0.05) -> float | None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if cond():
            return time.perf_counter() - t0
        time.sleep(step_s)
    return None


def _scrape(port: int, routes) -> dict:
    import urllib.request

    docs = {}
    for route in routes:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as r:
            body = r.read().decode()
            docs[route] = body if route == "/metrics" else json.loads(body)
    return docs


def _node_drills(torch, np, serve_sets, per_set_sets):
    """(c) the port's supervisor under injected faults on serve-128's job
    (cooldown 2 s, deadline 5 s), the exact per-set route, then (d) the
    scrape of the same stack over loopback."""
    from lodestar_tpu_torch.bls.api import SignatureSet
    from lodestar_tpu_torch.bls.fields import P
    from lodestar_tpu_torch.metrics.bls import FAMILIES
    from lodestar_tpu_torch.node.bls_stack import build_bls_stack

    tag = "[node] (c)"
    faults = DrillFaults()
    stack = build_bls_stack(device="cuda:0", mesh=None, faults=faults, metrics_port=0,
                            supervisor_args={"cooldown_s": 2.0, "deadline_s": 5.0})
    sup, lanes, pm = stack.supervisor, stack.verifier, stack.pipeline
    traces0 = stack.tracer.completed_total
    cpu = _counting(stack.cpu, "verify_signature_sets", "verify_signature_sets_individual")
    out = {}
    traced = {}  # job name -> trace id: every job runs as block import runs it

    def job(name, sets=serve_sets, want=True, call=None):
        call = call or (lambda: lanes.verify_signature_sets(sets, lane="block"))
        t0 = time.perf_counter()
        ok, traced[name] = _traced_block(call, len(sets), len(traced),
                                         _block_root(f"{tag} {name}"))
        secs = time.perf_counter() - t0
        if ok != want:
            raise AssertionError(f"{tag} {name}: verdict {ok}, the host tier {want}")
        return secs

    out["clean_s"] = job("clean")
    # exceptions: the host tier serves, three failures open the breaker,
    # the canary re-closes it once the faults are cleared
    faults.configure("exception")
    states, secs = [], []
    for i in range(3):
        secs.append(job(f"exception {i}"))
        states.append(sup.breaker_state)
    if states != ["closed", "closed", "open"] or cpu["verify_signature_sets"] != 3:
        raise AssertionError(f"{tag} exceptions: breaker {states}, host-tier calls {cpu}")
    faults.clear()
    reclosed = _wait_for(lambda: sup.breaker_state == "closed", 30.0)
    if reclosed is None:
        raise AssertionError(f"{tag} the canary did not re-close the breaker")
    out["exception"] = dict(seconds=secs, states=states, reclose_s=reclosed)
    log(f"{tag} exceptions: host tier served {secs}; breaker {states}; re-closed by the canary "
        f"{reclosed:.3f} s after the faults were cleared")
    # a host-side latency beyond the deadline: counted, the host tier serves
    faults.latency_s = 6.0
    faults.configure("latency")
    deadlines0 = pm.supervisor_snapshot()["deadline_exceeded"]
    secs = job("latency")
    faults.clear()
    deadlines = pm.supervisor_snapshot()["deadline_exceeded"] - deadlines0
    if deadlines != 1 or pm.supervisor_snapshot()["fallbacks"].get("deadline") != 1:
        raise AssertionError(f"{tag} latency: {deadlines} deadlines counted")
    out["latency_s"] = secs
    t0 = time.perf_counter()
    for t in list(sup._dispatcher._abandoned):  # wait out the abandoned worker's late call
        t.join(60.0)
    out["abandoned_s"] = time.perf_counter() - t0
    log(f"{tag} latency 6 s > deadline 5 s: the host tier served in {secs:.3f} s; deadline "
        f"counted once; the abandoned worker finished its call {out['abandoned_s']:.3f} s later")
    # flaky: the negative audit overturns the device's False
    faults.configure("flaky")
    secs = job("flaky")
    faults.clear()
    snap = pm.supervisor_snapshot()
    if snap["verdict_mismatches"] != 1 or snap["fallbacks"].get("negative_audit") != 1:
        raise AssertionError(f"{tag} flaky: {json.dumps(snap)}")
    out["flaky_s"] = secs
    log(f"{tag} flaky: the audit overturned the device's False in {secs:.3f} s; "
        f"verdict_mismatch {snap['verdict_mismatches']}")
    out["clean_after_s"] = job("clean after")
    # serve-128's tampered job, then its per-set verdicts through the
    # supervisor, each run as a block's batch is
    bad = serve_sets
    for k in (5, 64, 127):
        bad = _tamper_one(bad, k, "signature", k - 1)
    host_bad = _host_verdicts(bad)
    out["tampered_s"] = job("tampered", bad, False)
    out["tampered_per_set_s"] = job("tampered per-set", bad, host_bad,
                                    lambda: sup.verify_signature_sets_individual(bad))
    log(f"{tag} serve-128's job with three bad signatures: False in {out['tampered_s']:.3f} s, "
        f"its per-set verdicts (the host tier's) in {out['tampered_per_set_s']:.3f} s")
    # the exact per-set route (K3): 16 sets, one bad encoding, one at a time
    sixteen = list(per_set_sets[:16])
    bad_enc = bytearray(sixteen[7].signature)
    bad_enc[:48] = P.to_bytes(48, "big")
    bad_enc[0] |= 0x80 | (sixteen[7].signature[0] & 0x20)
    sixteen[7] = SignatureSet(sixteen[7].pubkey, sixteen[7].message, bytes(bad_enc))
    host16 = _host_verdicts(sixteen)
    got, secs, counts = _run_counted(torch, lambda: sup.verify_signature_sets_individual(sixteen))
    if got != host16 or got[7]:
        raise AssertionError(f"{tag} the exact route's verdicts {got} differ from the host "
                             f"tier's {host16}")
    _need(counts, f"{tag} exact per-set route", "K3")
    out["exact"] = dict(seconds=secs, counts=counts)
    log(f"{tag} exact per-set route through the supervisor: 16 sets, set 7 False = host tier, "
        f"{secs:.3f} s; launches {json.dumps(counts)}")
    # (d) the scrape
    routes = ("/metrics", "/debug/breaker", "/debug/lanes", "/debug/slo", "/debug/device",
              "/debug/epoch_table", "/debug/compiles", "/debug/traces?limit=256")
    finished = stack.tracer.completed_total - traces0
    t0 = time.perf_counter()
    docs = _scrape(stack.server.port, routes)
    scrape_s = time.perf_counter() - t0
    trees = _check_traces(f"{tag} scrape", docs["/debug/traces?limit=256"]["traces"], traced)
    counted = _lifecycle_total(docs["/metrics"])
    wrong = {name: t for name, t in trees.items()
             if name != "tampered per-set"
             and t["parents"].get("bls/supervised_batch") != ["chain/bls_verify"]}
    per_set = trees["tampered per-set"]["parents"].get("bls/supervised_individual")
    fallbacks = [trees[f"exception {i}"]["parents"].get("bls/cpu_fallback") for i in range(3)]
    transitions = [e for t in trees.values() for ev in t["events"].values() for e in ev
                   if e == "bls/breaker_transition"]
    opened = sum(trees["exception 2"]["events"].values(), [])
    if wrong or per_set != ["chain/bls_verify"] or counted != finished \
            or counted != len(traced) or fallbacks != [["chain/bls_verify"]] * 3 \
            or "bls/breaker_transition" not in opened:
        raise AssertionError(
            f"{tag} traces: {json.dumps(trees)}; lodestar_lifecycle_traces_total {counted}, "
            f"traces finished {finished}, jobs {len(traced)}")
    out["traces"] = dict(jobs=len(traced), counted=counted, transitions=len(transitions))
    log(f"[node] (d) /debug/traces: {len(traced)} traced block jobs, each with "
        f"bls/supervised_batch under chain/bls_verify (the tampered per-set call "
        f"bls/supervised_individual under it); the three exception jobs' bls/cpu_fallback "
        f"spans and {len(transitions)} bls/breaker_transition event(s); "
        f"lodestar_lifecycle_traces_total {counted:.0f} = {finished} traces finished; the "
        f"exception drill's trace {json.dumps(trees['exception 2'])}")
    text = docs["/metrics"]
    missing = [name for _, _, name, _ in FAMILIES if f"# TYPE {name} " not in text]
    missing += [p for p in ("lodestar_bls_lane_", "lodestar_bls_supervisor_", "lodestar_slo_")
                if f"# TYPE {p}" not in text]
    slo_state = {o["name"]: o["state"] for o in docs["/debug/slo"]["objectives"]}
    if missing or slo_state.get("zero_block_sheds") != "ok" or \
            docs["/debug/breaker"]["state"] != "closed":
        raise AssertionError(f"{tag} scrape: missing {missing}, slo {slo_state}, breaker "
                             f"{docs['/debug/breaker']['state']}")
    out["scrape"] = dict(seconds=scrape_s, slo=slo_state, metrics_bytes=len(text))
    log(f"[node] (d) scrape of {len(routes)} routes over loopback in {scrape_s:.3f} s: every "
        f"facade, lane, supervisor and slo family present; breaker "
        f"{docs['/debug/breaker']['state']}; slo {json.dumps(slo_state)}; lanes "
        f"{json.dumps({k: v for k, v in docs['/debug/lanes'].items() if k != 'lanes'})}; device "
        f"utilisation {docs['/debug/device']['utilization']}")
    stack.close()
    return out


def _node_aot_drill(torch, np, serve_sets):
    """(e) the ahead-of-time store's drill, on a temporary copy of the build
    directory: one byte of K1's library (`mont_mul`: one small source, the
    cheapest kernel library to rebuild) flipped must count `corrupt`, be
    moved aside, rebuilt and never opened, and serve-128's job through the
    rebuilt library (K1 launched from it) must be the host tier's verdict;
    the host tier's header given another compiler in its fingerprint must
    count `version_mismatch` and be rebuilt. Every library opened meanwhile
    is seen by a spy on the one opener, `build._open`."""
    import hashlib
    import shutil
    import tempfile

    from lodestar_tpu_torch import build
    from lodestar_tpu_torch.observability import compile_ledger
    from lodestar_tpu_torch.ops.aot_store import MAGIC, AotStore
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[node] (e) aot"
    out = {}
    tmp = tempfile.mkdtemp(prefix="aot-drill-", dir=build.BUILD_DIR)
    try:
        shutil.copytree(build.BUILD_DIR, tmp, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("*.lock", "aot-drill-*", "*trace*"))
        st = AotStore(tmp)
        led = compile_ledger.ledger()
        opened, real_open = [], build._open

        def spy(path):
            with open(path, "rb") as f:
                opened.append((path, hashlib.sha256(f.read()).hexdigest()))
            return real_open(path)

        def outcomes(name, since):
            return [e["outcome"] for e in led.snapshot()["aot"]["events"][since:]
                    if e["kernel"] == f"build/{name}"]

        # (1) a flipped byte in K1's library
        lib = build.LIBRARIES["mont_mul"]
        digest = lib.digest()
        path = st.library_path("mont_mul", digest)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x10]))
        with open(path, "rb") as f:
            bad_sha = hashlib.sha256(f.read()).hexdigest()
        since = len(led.snapshot()["aot"]["events"])
        # the process loads K1 anew from the copy, through the serving path
        saved_dir, real_lib = build.BUILD_DIR, build._LIBS.pop("mont_mul")
        build.BUILD_DIR, build._open = tmp, spy
        try:
            t0 = time.perf_counter()
            build.mont_mul_cuda()
            out["rebuild_s"] = time.perf_counter() - t0
            rebuilt = build.load("mont_mul")._name
            v = TorchBlsVerifier(device="cuda:0", mesh=None, grouped_configs=((16, 8),))
            ok, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets(serve_sets))
        finally:
            build.BUILD_DIR, build._open = saved_dir, real_open
            build._LIBS["mont_mul"] = real_lib
        with open(st.header_path("mont_mul", digest), "rb") as f:
            new_sha = json.loads(f.read()[len(MAGIC) + 1:])["payload_sha256"]
        seen = outcomes("mont_mul", since)
        if seen != ["corrupt", "export"] or not os.path.exists(path + ".corrupt") \
                or opened != [(rebuilt, new_sha)] or new_sha == bad_sha or rebuilt != path:
            raise AssertionError(f"{tag} corrupt: outcomes {seen}, opened {opened}, flipped "
                                 f"{bad_sha}")
        if ok is not True or counts["K1"] < 1:
            raise AssertionError(f"{tag} the verdict through the rebuilt K1: {ok}, launches "
                                 f"{counts}")
        out.update(corrupt=seen, verdict_s=secs, k1_launches=counts["K1"])
        log(f"{tag}: one byte of mont_mul's library flipped (sha256 {bad_sha[:16]}...): "
            f"outcomes {seen}, moved aside to .corrupt, rebuilt in {out['rebuild_s']:.3f} s "
            f"(nvcc {build.BUILD_LOG['mont_mul'][0]:.3f} s), never opened (opened only the "
            f"rebuilt {new_sha[:16]}...); serve-128's job through it True = the host tier's in "
            f"{secs:.3f} s, K1 launched {counts['K1']} times from it")
        # (2) the host tier's header stamped by another compiler
        host = build.LIBRARIES["bls12_host"]
        hdr = st.header_path("bls12_host", host.digest())
        with open(hdr, "rb") as f:
            header = json.loads(f.read()[len(MAGIC) + 1:])
        header["fingerprint"]["compiler"] = "cc (an older release) 4.8.5"
        with open(hdr, "wb") as f:
            f.write(MAGIC + b"\n" + json.dumps(header, sort_keys=True).encode())
        since = len(led.snapshot()["aot"]["events"])
        saved_dir, build.BUILD_DIR = build.BUILD_DIR, tmp
        try:
            t0 = time.perf_counter()
            host.build()
            out["mismatch_rebuild_s"] = time.perf_counter() - t0
        finally:
            build.BUILD_DIR = saved_dir
        seen = outcomes("bls12_host", since)
        with open(hdr, "rb") as f:
            fp = json.loads(f.read()[len(MAGIC) + 1:])["fingerprint"]
        if seen != ["version_mismatch", "export"] or fp["compiler"] == header["fingerprint"][
                "compiler"] or not os.path.exists(hdr + ".version_mismatch"):
            raise AssertionError(f"{tag} foreign fingerprint: outcomes {seen}, now {fp}")
        out["version_mismatch"] = seen
        log(f"{tag}: the host tier's header given another compiler: outcomes {seen}, moved "
            f"aside, rebuilt in {out['mismatch_rebuild_s']:.3f} s with fingerprint "
            f"{json.dumps(fp)}; build seconds of this run "
            f"{json.dumps({k: round(v[0], 3) for k, v in build.BUILD_LOG.items()})}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _check_pool_preload(tag: str, pool) -> list:
    """Every worker of `pool` found each library in the store and launched
    each kernel once at its start: only `hit`s."""
    outcomes = [p["outcomes"] for p in pool.preload]
    if any(set(o.values()) != {"hit"} for o in outcomes) or \
            any(sorted(p["launch_seconds"]) != sorted(NODE_KERNELS) for p in pool.preload):
        raise AssertionError(f"{tag} the workers' preload: {json.dumps(pool.preload)}")
    log(f"{tag} workers' preload: outcomes {json.dumps(outcomes)}; first launches "
        f"{json.dumps([p['launch_seconds'] for p in pool.preload])}; "
        f"{[p['seconds'] for p in pool.preload]} s")
    return pool.preload


def _node_mesh_drill(torch, np, serve_sets):
    """(c) the mesh drill through the port's supervisor: the stack over a
    two-worker pool on cuda:0 serves serve-128's job sharded; worker 2
    killed, the same call raises `MeshWorkerError` naming chip 1 inside
    the supervisor, which evicts it and serves the call single-device:
    the host tier is called 0 times and the breaker stays closed; the
    canary re-admits the chip and a new pool serves sharded again; no
    worker process is left. (The checks of the mesh phase's eviction
    drill.)"""
    import multiprocessing

    from lodestar_tpu_torch.observability.stages import PipelineMetrics
    from lodestar_tpu_torch.parallel.mesh import BlsMeshDispatcher
    from lodestar_tpu_torch.node.bls_stack import build_bls_stack

    tag = "[node] (c) mesh"
    pm = PipelineMetrics()
    d = BlsMeshDispatcher(list(MESH_DEVICES), observer=pm)
    stack = build_bls_stack(device="cuda:0", mesh=d, observer=pm,
                            supervisor_args={"cooldown_s": 2.0, "deadline_s": 120.0})
    sup, dev = stack.supervisor, stack.device
    cpu = _counting(stack.cpu, "verify_signature_sets", "verify_signature_sets_individual")
    v = dev._inner
    single = []
    inner = v._kernels["grouped_raw"]
    v._kernels["grouped_raw"] = lambda *a: single.append(1) or inner(*a)
    evicted, readmitted = [], []
    real_evict, real_readmit = dev.mesh_evict, dev.mesh_readmit

    def evict(chip=None, reason="failure"):
        t0 = time.perf_counter()
        size = real_evict(chip=chip, reason=reason)
        evicted.append(dict(chip=chip, reason=reason, at=t0, size=size,
                            seconds=time.perf_counter() - t0, pool_stopped=d.pool is None))
        return size

    def readmit():
        n = real_readmit()
        readmitted.append(n)
        return n

    dev.mesh_evict, dev.mesh_readmit = evict, readmit
    out = {}
    pool = d.start_pool()
    out["start_s"] = pool.start_seconds
    out["preload"] = _check_pool_preload(tag, pool)

    def call(name):
        got, secs, counts = _run_counted(
            torch, lambda: stack.verifier.verify_signature_sets(serve_sets, lane="block"))
        if got is not True:
            raise AssertionError(f"{tag} {name}: {got}, the host tier True")
        return secs, counts

    out["sharded_s"], _ = call("sharded")
    if single or d.snapshot()["dispatches"] != 1:
        raise AssertionError(f"{tag} the first verdict was not sharded: {d.snapshot()}")
    pool.kill(1)
    t_kill = time.perf_counter()
    out["evicted_served_s"], counts = call("after the kill")
    ev = evicted[0] if len(evicted) == 1 else {}
    if ev.get("chip") != 1 or ev.get("reason") != "MeshWorkerError" or ev.get("size") != 1 \
            or not ev.get("pool_stopped"):
        raise AssertionError(f"{tag} eviction {evicted}")
    out["raise_s"], out["evict_s"] = ev["at"] - t_kill, ev["seconds"]
    if out["raise_s"] > pool.timeout_s or single != [1] or any(pool.alive()):
        raise AssertionError(f"{tag} raise after {out['raise_s']:.3f} s, single-device "
                             f"{single}, pool alive {pool.alive()}")
    _need_main(counts, f"{tag} single-device")
    snap = sup.breaker_snapshot()
    if cpu["verify_signature_sets"] or cpu["verify_signature_sets_individual"] or \
            snap["state"] != "closed":
        raise AssertionError(f"{tag} host tier {dict(cpu)}, breaker {snap['state']}")
    log(f"{tag}: worker 2 killed; MeshWorkerError named chip 1 after {out['raise_s']:.6f} s "
        f"(pool timeout {pool.timeout_s:.0f} s), the supervisor evicted it (mesh_evict "
        f"{out['evict_s']:.6f} s: serving size 1, the pool stopped) and served the call "
        f"single-device in {out['evicted_served_s']:.3f} s; host tier called 0 times, breaker "
        f"closed; launches {json.dumps(counts)}")
    out["readmit_s"] = _wait_for(lambda: d.size == 2 and readmitted == [1], 60.0)
    if out["readmit_s"] is None:
        raise AssertionError(f"{tag} the canary did not re-admit the chip: {d.snapshot()}")
    single.clear()
    dispatches = d.snapshot()["dispatches"]
    out["served_again_s"], _ = call("after readmission")
    if single or d.pool is None or d.snapshot()["dispatches"] != dispatches + 1:
        raise AssertionError(f"{tag} the verdict after readmission was not sharded")
    out["restart_s"] = d.pool.start_seconds
    out["restart_preload"] = _check_pool_preload(f"{tag} (the new pool)", d.pool)
    log(f"{tag}: the canary re-admitted the chip {out['readmit_s']:.3f} s after; a new pool "
        f"(started in {out['restart_s']:.3f} s) served sharded again in "
        f"{out['served_again_s'] - out['restart_s']:.3f} s of {out['served_again_s']:.3f} s; "
        f"snapshot {json.dumps(d.snapshot())}")
    stack.close()
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"{tag} worker processes left: {left}")
    return out


def phase_node(torch, np, grouped, serve_batch, per_set_sets):
    """12b. the port's serving stack: (a) the warm-boot ladder in a
    subprocess, (b) the first 2 s of one slot of gossip at the JAX
    defaults, (c) the supervisor's drills and the mesh drill,
    (d) the scrape, (e) the ahead-of-time store's drill, and the host cost
    of a lifecycle span."""
    tag = "[node]"
    slice_sets, slice_host = grouped
    block_sets, block_host = serve_batch
    if not all(block_host):
        raise AssertionError(f"{tag} the host tier rejects the block job")
    out = {"boot": timed("node (a) boot", _node_boot, torch)}
    keys = _node_keys(np, slice_sets, block_sets)
    # the slot's first 2 s (2048 calls, one tampered), cut to keep the
    # script's time
    order, _ = _node_order(np, len(slice_sets))
    out["slot"] = timed("node (b) slot 512", _node_slot, torch, np,
                        f"{tag} (b) slot's first 2 s (cut), max_coalesce 512:", slice_sets,
                        slice_host, block_sets, keys, NODE_MAIN_CALLS,
                        (int(order[NODE_MAIN_TAMPERED_AT]),))
    out["drills"] = timed("node (c) drills", _node_drills, torch, np, block_sets, per_set_sets)
    out["mesh_drill"] = timed("node (c) mesh drill", _node_mesh_drill, torch, np, block_sets)
    out["aot_drill"] = timed("node (e) aot drill", _node_aot_drill, torch, np, block_sets)
    out["span_cost"] = _span_cost_us()
    log(f"{tag} host cost of one lifecycle span: {out['span_cost']['span_us']:.3f} us "
        f"(enabled {out['span_cost']['enabled_us']:.3f} us against the disabled tracer's "
        f"shared null span {out['span_cost']['null_us']:.3f} us, 2,000 spans a round, the "
        f"medians of 10 rounds)")
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("bls-lane-worker", "bls-canary", "bls-device-dispatch",
                                  "epoch-table-fill"))]
    if left:
        raise AssertionError(f"{tag} threads left after close(): {left}")
    return out


def make_key_sets(np, key_ids, roots, seed: int):
    """Sets signed by key key_ids[i] over roots[i], with the secret keys
    drawn from `seed`, signed by the host tier."""
    from lodestar_tpu_torch import profile_verdict

    sks = profile_verdict.secret_keys(np.random.default_rng(seed), max(key_ids) + 1)
    return profile_verdict.make_key_sets(key_ids, roots, sks, threads=THREADS)


def _wrong_message(sets, k: int, root: bytes):
    """Set k's signing root replaced by a fresh one (its signature no longer
    matches; every root of the batch keeps its count of sets)."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    out[k] = SignatureSet(sets[k].pubkey, root, sets[k].signature)
    return out


def _swap_signatures(sets, i: int, j: int):
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    out[i] = SignatureSet(sets[i].pubkey, sets[i].message, sets[j].signature)
    out[j] = SignatureSet(sets[j].pubkey, sets[j].message, sets[i].signature)
    return out


def _bad_flags(sets, k: int):
    """Set k's signature with its compression flag cleared: it does not
    decode."""
    from lodestar_tpu_torch.bls.api import SignatureSet

    out = list(sets)
    raw = bytearray(sets[k].signature)
    raw[0] &= 0x7F
    out[k] = SignatureSet(sets[k].pubkey, sets[k].message, bytes(raw))
    return out


def _host_after(host, bad, changed):
    """The host tier's per-set verdicts of `bad`: the unchanged sets keep
    those of `host`, the changed ones are verified anew."""
    out = list(host)
    for k, ok in zip(changed, _host_verdicts([bad[k] for k in changed])):
        out[k] = ok
    return out


def _spy_routes(v):
    """Record which submit paths the verifier takes (appended in order)."""
    routes = []
    for name in ("_submit_grouped", "_submit_pk_grouped", "_submit_flat"):
        fn = getattr(v, name)

        def spy(*args, _fn=fn, _name=name[len("_submit_"):]):
            routes.append(_name)
            return _fn(*args)

        setattr(v, name, spy)
    return routes


def _verdict(torch, v, routes, tag, name, sets, want: bool, route: list):
    """One counted verdict: equal to the host tier's, through `route`."""
    routes.clear()
    got, secs, counts = _run_counted(torch, lambda: v.verify_signature_sets(sets), v)
    log(f"{tag} {name}: port {got}, host tier {want}, routes {routes}, {secs:.3f} s; "
        f"launches {json.dumps(counts)}; stages {json.dumps(v.stage_seconds)}")
    if got is not want:
        raise AssertionError(f"{tag} {name}: the port says {got}, the host tier {want}")
    if routes != route:
        raise AssertionError(f"{tag} {name}: routes {routes}, expected {route}")
    return secs, counts


PK_KEYS, PK_ROOTS = 128, 32  # the default pk-grouped configuration (128, 32)


def phase_pk_grouped(torch, np):
    """4096 sets over 4096 unique roots from 128 keys: the valid batch and
    three tampered ones through the pk-grouped verdict."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[pk-grouped]"
    n = PK_KEYS * PK_ROOTS
    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    sets = make_key_sets(np, [i // PK_ROOTS for i in range(n)],
                         [rng.bytes(32) for _ in range(n)], SEED + 12)
    host = _host_verdicts(sets)
    log(f"{tag} made {n} sets ({PK_KEYS} keys x {PK_ROOTS} unique roots each) and the host "
        f"tier's verdicts in {time.perf_counter() - t0:.1f} s")
    if not all(host):
        raise AssertionError("the host tier rejects the valid pk-grouped batch")
    v = TorchBlsVerifier(device="cuda", mesh=None, rng=np.random.default_rng(SEED))
    routes = _spy_routes(v)
    out = {}
    secs, counts = _verdict(torch, v, routes, tag, "(a) valid, first call", sets, True,
                            ["pk_grouped"])
    _need(counts, f"{tag} valid", "K4")  # every multiply here is ≥ 4096 products
    _need_main(counts, f"{tag} valid")
    out["cold"] = dict(seconds=secs, counts=counts)
    # a flood of unique roots never hits the hash-to-G2 cache: empty it,
    # so that the warm verdict hashes its 4096 roots as the first did
    v._h2c_cache.clear()
    with _products_per_launch() as products:
        secs, counts = _verdict(torch, v, routes, tag, "(a) valid, warm, hash cache emptied",
                                sets, True, ["pk_grouped"])
    _need(counts, f"{tag} valid (warm)", "K4")
    _need_main(counts, f"{tag} valid (warm)")
    _check_products(products, counts, tag)
    out["warm"] = dict(seconds=secs, counts=counts, stages=dict(v.stage_seconds),
                       products=products)
    log(f"{tag} warm: {n / secs:.1f} sets/s")
    i, j = 5, n // 2 + 3  # sets of two different keys
    for name, bad, changed in (
        ("(b) wrong message", _wrong_message(sets, i, rng.bytes(32)), (i,)),
        ("(c) swapped signature", _swap_signatures(sets, i, j), (i, j)),
        ("(d) bad flag bits", _bad_flags(sets, i), (i,)),
    ):
        want = all(_host_after(host, bad, changed))
        if want:
            raise AssertionError(f"{tag} {name}: the host tier accepts the tampered batch")
        _verdict(torch, v, routes, tag, name, bad, False, ["pk_grouped"])
    out["batch"] = (sets, host)
    return out


def phase_flat(torch, np):
    """128 sets over 128 roots and 128 keys, valid and with one wrong
    message, and 200 such sets (two chunks): the flat verdict."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[flat]"
    rng = np.random.default_rng(SEED + 13)
    t0 = time.perf_counter()
    sets = make_key_sets(np, list(range(200)), [rng.bytes(32) for _ in range(200)], SEED + 14)
    host = _host_verdicts(sets)
    log(f"{tag} made 200 sets and the host tier's verdicts in {time.perf_counter() - t0:.1f} s")
    if not all(host):
        raise AssertionError("the host tier rejects the valid flat batch")
    v = TorchBlsVerifier(device="cuda", mesh=None, rng=np.random.default_rng(SEED))
    routes = _spy_routes(v)
    out = {}
    head = sets[:PER_SET_N]
    _verdict(torch, v, routes, tag, "128 valid, first call", head, True, ["flat"])
    secs, counts = _verdict(torch, v, routes, tag, "128 valid, warm", head, True, ["flat"])
    _need(counts, f"{tag} valid", "K1")
    _need_main(counts, f"{tag} valid")
    out["128"] = dict(seconds=secs, counts=counts)
    bad = _wrong_message(head, 9, rng.bytes(32))
    if all(_host_after(host[:PER_SET_N], bad, (9,))):
        raise AssertionError(f"{tag} the host tier accepts the tampered batch")
    _verdict(torch, v, routes, tag, "128, one wrong message", bad, False, ["flat"])
    secs, counts = _verdict(torch, v, routes, tag, "200 valid (chunks of 128 and 72)", sets,
                            True, ["flat"])
    _need_main(counts, f"{tag} 200 valid", verdicts=2)
    out["200"] = dict(seconds=secs, counts=counts)
    return out


def phase_split(torch, np):
    """The two split compositions: 64 sets over 8 shared roots (64 keys)
    plus 64 sets over 64 unique roots from 2 keys (pk-grouped rest) or
    from 64 keys (flat rest); each valid and with one tampered unique-part
    set."""
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[split]"
    rng = np.random.default_rng(SEED + 15)
    shared_roots = [rng.bytes(32) for _ in range(8)]
    unique_roots = [rng.bytes(32) for _ in range(64)]
    roots = [shared_roots[i // 8] for i in range(64)] + unique_roots
    out = {}
    for rest, keys, route in (("pk-grouped", [64 + i % 2 for i in range(64)], "pk_grouped"),
                              ("flat", [64 + i for i in range(64)], "flat")):
        sets = make_key_sets(np, list(range(64)) + keys, roots, SEED + 16)
        host = _host_verdicts(sets)
        if not all(host):
            raise AssertionError(f"{tag} the host tier rejects the valid batch")
        v = TorchBlsVerifier(device="cuda", mesh=None, rng=np.random.default_rng(SEED))
        routes = _spy_routes(v)
        secs, counts = _verdict(torch, v, routes, tag, f"grouped + {rest}, valid", sets, True,
                                ["grouped", route])
        _need_main(counts, f"{tag} grouped + {rest}", verdicts=2)
        out[rest] = dict(seconds=secs, counts=counts)
        k = 64 + 7  # a set of the unique part
        bad = _wrong_message(sets, k, rng.bytes(32))
        if all(_host_after(host, bad, (k,))):
            raise AssertionError(f"{tag} the host tier accepts the tampered batch")
        _verdict(torch, v, routes, tag, f"grouped + {rest}, one tampered unique set", bad, False,
                 ["grouped", route])
    return out


def _verdict_text(v) -> str:
    """A batch verdict as it is, a per-set vector as its invalid sets."""
    if isinstance(v, list):
        return f"{len(v)} sets, invalid at {[i for i, ok in enumerate(v) if not ok]}"
    return str(v)


def _sharded_verdict(tag, d, obs, spied, name, fn, want, controller_idle=True):
    """One verdict through the pool of the dispatcher `d`: it must equal the
    host tier's (`want`), go through the mesh once (each serving chip's
    dispatch count rises by one, and on a fleet each serving host's) and
    never through the single-device verdict (`spied`: the calls seen
    there), and launch K2p once on every worker and K3-fe once on worker 0
    only (the workers' counts zeroed just before and read just after,
    through the pool); the controller launches nothing, bisection's probes
    aside (`controller_idle=False`: anything but K2p). Returns (wall,
    every worker's launch counts)."""
    pool = d.pool
    chips = [str(c) for c in d.snapshot()["serving"]]
    layout = (d.fleet_snapshot() or {}).get("layout", {})
    hosts = list(layout) if len(layout) > 1 else []
    chips_before = dict(obs.mesh_snapshot()["chip_dispatches"])
    hosts_before = dict(obs.fleet_snapshot()["host_dispatches"]) if hosts else {}
    pool.counts(reset=True)
    _reset_counts()
    t0 = time.perf_counter()
    got = fn()
    wall = time.perf_counter() - t0
    workers = pool.counts()
    controller = _counts()
    chips_after = obs.mesh_snapshot()["chip_dispatches"]
    hosts_after = obs.fleet_snapshot()["host_dispatches"] if hosts else {}
    log(f"{tag} {name}: mesh {_verdict_text(got)}, host tier {_verdict_text(want)}, "
        f"{wall:.3f} s; worker launches {json.dumps(workers)}; controller launches "
        f"{json.dumps(controller)}")
    if got != want:
        raise AssertionError(f"{tag} {name}: the mesh says {got}, the host tier {want}")
    if spied:
        raise AssertionError(f"{tag} {name}: NOT_SHARDED taken ({spied})")
    for c in chips:
        if chips_after.get(c, 0) - chips_before.get(c, 0) != 1:
            raise AssertionError(f"{tag} {name}: chip {c} dispatches {chips_before} -> "
                                 f"{chips_after}")
    for h in hosts:
        if hosts_after.get(h, 0) - hosts_before.get(h, 0) != 1:
            raise AssertionError(f"{tag} {name}: host {h} dispatches {hosts_before} -> "
                                 f"{hosts_after}")
    if len(workers) != len(chips):
        raise AssertionError(f"{tag} {name}: {len(workers)} workers for chips {chips}")
    for k, counts in enumerate(workers):
        if counts["K2p"] != 1:
            raise AssertionError(f"{tag} {name}: worker {k} launched K2p {counts['K2p']} times")
        if counts["K3-fe"] != (1 if k == 0 else 0):
            raise AssertionError(f"{tag} {name}: worker {k} launched K3-fe "
                                 f"{counts['K3-fe']} times")
    busy = [kk for kk, n in controller.items() if n and (controller_idle or kk == "K2p")]
    if busy:
        raise AssertionError(f"{tag} {name}: the controller launched {busy}")
    return wall, workers


MESH_DEVICES = ("cuda:0", "cuda:0")  # two workers on the one card, even where more are visible


def phase_mesh(torch, np, grouped_batch, pk_batch, per_set_sets, per_set_host, per_set_bad,
               per_set_host_bad):
    """The sharded verdicts over a `BlsMeshDispatcher` of two worker
    processes on cuda:0, behind `TorchBlsVerifier(mesh=...)`: grouped
    64 x 64 (valid, one bad signature in the second worker's rows, one
    undecodable signature there too), pk-grouped 128 x 32 (valid) and
    per-set 128 by bisection (valid, three invalid at 5, 64 and 127).
    Every verdict equals the host tier's, goes through the mesh once (the
    dispatcher's per-chip count rises by one, the
    single-device verdict is never called) and launches K2p once on each
    worker and K3-fe once on the first (counts zeroed just before, read
    just after, in the workers through the pool); no worker process is
    left. The eviction drill is the node phase's mesh drill."""
    import multiprocessing

    from lodestar_tpu_torch.observability.stages import PipelineMetrics
    from lodestar_tpu_torch.parallel.mesh import BlsMeshDispatcher
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[mesh]"
    log(f"{tag} torch.cuda.device_count() = {torch.cuda.device_count()}; the mesh runs two "
        f"workers on {MESH_DEVICES[0]}; card: {card_line()}")
    # the slice and pk-grouped phases' batches, with their host tier verdicts
    (grouped, grouped_host), (pk_sets, pk_host) = grouped_batch, pk_batch
    obs = PipelineMetrics()
    d = BlsMeshDispatcher(list(MESH_DEVICES), observer=obs)
    v = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED), mesh=d)
    single = TorchBlsVerifier(device="cuda", rng=np.random.default_rng(SEED), mesh=None)
    sharded_off = []  # single-device verdicts called on the mesh verifier
    for kind in ("grouped_raw", "pk_grouped_raw", "bisect_tree"):
        inner = v._kernels[kind]
        v._kernels[kind] = lambda *a, _k=kind, _f=inner: sharded_off.append(_k) or _f(*a)
    pool = d.start_pool()
    log(f"{tag} pool of {pool.size} workers (pids {pool.pids}) started in "
        f"{pool.start_seconds:.3f} s")
    out = {"start_s": pool.start_seconds, "cells": {},
           "batches": dict(grouped=grouped, grouped_host=grouped_host, pk=pk_sets,
                           pk_host=pk_host)}

    def mesh_verdict(name, fn, want, clear_h2c=False, controller_idle=True):
        if clear_h2c:
            v._h2c_cache.clear()
        return _sharded_verdict(tag, d, obs, sharded_off, name, fn, want, controller_idle)

    def single_wall(name, fn, want, clear_h2c=False):
        if clear_h2c:
            single._h2c_cache.clear()
        got, wall, counts = _run_counted(torch, fn, single)
        log(f"{tag} {name} single-device: {_verdict_text(got)}, {wall:.3f} s; launches "
            f"{json.dumps(counts)}")
        if got != want:
            raise AssertionError(f"{tag} {name} single-device: {got}, host tier {want}")
        return wall

    def cell_walls(cell, name, method, sets, want, order=("mesh", "single"), **kw):
        """A first (cold) sharded call, then the sharded and the
        single-device verdict of the same batch in `order`; the cell keeps
        the walls of each side (the single-device verdicts are warm from
        the earlier phases)."""
        mesh_fn = lambda: getattr(v, method)(sets)  # noqa: E731
        mesh_verdict(f"{name}, first call", mesh_fn, want, **kw)
        cell.update(mesh_s=[], single_s=[], order=" ".join(order))
        for side in order:
            if side == "mesh":
                wall, cell["workers"] = mesh_verdict(name, mesh_fn, want, **kw)
                cell["mesh_s"].append(wall)
            else:
                cell["single_s"].append(single_wall(name, lambda: getattr(single, method)(sets),
                                                    want, kw.get("clear_h2c", False)))

    # grouped-64x64: rows are roots, sets [64j, 64j + 64) in row j; the
    # second worker owns rows 32..63
    cell = out["cells"]["grouped-64x64"] = {}
    cell_walls(cell, "grouped-64x64 valid", "verify_signature_sets", grouped, True,
               order=("mesh", "single"))
    k = 40 * 64 + 3
    bad_sig = _tamper_one(grouped, k, "signature", 10)
    cell["bad_signature_s"], _ = mesh_verdict(
        "grouped-64x64 one bad signature (row 40, worker 2)",
        lambda: v.verify_signature_sets(bad_sig), all(_host_after(grouped_host, bad_sig, (k,))))
    k = 50 * 64 + 7
    undecodable = _bad_flags(grouped, k)
    cell["undecodable_s"], _ = mesh_verdict(
        "grouped-64x64 one undecodable signature (row 50, worker 2)",
        lambda: v.verify_signature_sets(undecodable),
        all(_host_after(grouped_host, undecodable, (k,))))

    # pk-grouped-128x32: rows are keys; the second worker owns keys 64..127;
    # every verdict hashes its 4096 roots anew, as a flood always does (the
    # valid batch alone, one wall a side: the fleet phase holds a wrong
    # message)
    cell = out["cells"]["pk-grouped-128x32"] = {}
    cell_walls(cell, "pk-grouped-128x32 valid", "verify_signature_sets", pk_sets, True,
               clear_h2c=True)

    # per-set-128 by bisection: lanes [0, 64) on the first worker; the
    # probes run on the controller (one wall a side)
    cell = out["cells"]["per-set-128"] = {}
    cell_walls(cell, "per-set-128 valid", "verify_signature_sets_individual", per_set_sets,
               per_set_host, controller_idle=False)
    bad_at = [i for i, ok in enumerate(per_set_host_bad) if not ok]
    if bad_at != [5, 64, 127]:
        raise AssertionError(f"the tampered per-set batch is invalid at {bad_at}")
    cell["three_invalid_s"], _ = mesh_verdict(
        "per-set-128 three invalid (5; 64, 127)",
        lambda: v.verify_signature_sets_individual(per_set_bad), per_set_host_bad,
        controller_idle=False)
    for name, c in out["cells"].items():
        c["ratio"] = sum(c["mesh_s"]) / sum(c["single_s"])
        log(f"{tag} {name}: mesh {' / '.join(f'{w:.3f}' for w in c['mesh_s'])} s, "
            f"single-device {' / '.join(f'{w:.3f}' for w in c['single_s'])} s (order "
            f"{c['order']}), ratio of the sums {c['ratio']:.3f}; per-worker launches "
            f"{json.dumps(c['workers'])}")

    v.close()
    single.close()
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"{tag} worker processes left: {left}")
    log(f"{tag} snapshot {json.dumps(d.snapshot())}; no worker process left")
    return out


FLEET_HOSTS = [[0, 1], [2, 3]]  # host 0: two workers of the controller; host 1: the agent's two
FLEET_DEVICE = "cuda:0"  # every worker of both hosts on the one card


def _start_agent(coordinator: str, key_file: str):
    """Host 1's agent, as a second host would run it: its own process,
    reaching the controller over TCP on the loopback interface."""
    return subprocess.Popen(
        [sys.executable, "-m", "lodestar_tpu_torch.parallel.fleet_host", "--coordinator",
         coordinator, "--rank", "1", "--devices", f"{FLEET_DEVICE},{FLEET_DEVICE}",
         "--authkey-file", key_file],
        cwd=ROOT)


def _left(pids, wait_s: float = 10.0) -> list:
    """The processes of `pids` still running after up to `wait_s`."""
    deadline = time.monotonic() + wait_s
    while True:
        left = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                left.append(pid)
            except ProcessLookupError:
                pass
        if not left or time.monotonic() >= deadline:
            return left
        time.sleep(0.1)


def phase_fleet(torch, np, mesh, per_set_sets, per_set_host, per_set_bad, per_set_host_bad):
    """The two-level fleet: `TorchBlsVerifier(mesh=...)` over a
    `BlsMeshDispatcher` of hosts [[0, 1], [2, 3]] on cuda:0, host 0's two
    workers spawned by this process, host 1's two started by a
    `fleet_host` agent subprocess that joins the hub over TCP on
    127.0.0.1 with a temporary authkey file. The verdicts: grouped 64 x 64
    (valid, one bad signature in host 1's rows), pk-grouped 128 x 32
    (valid with the hash cache emptied, one wrong message in host 1's
    rows) and per-set 128 by bisection (valid, three invalid at 5, 64 and
    127). Each equals the host tier's, goes through the fleet once (each
    host's dispatch count rises by one, the single-device verdict is
    never called), launches K2p once on each of the four workers and
    K3-fe once on worker 0 only. Each cell's walls are printed beside the
    mesh phase's single-level and single-device walls of the same batch.
    Then the host drill: the agent killed (host 1's workers exit with
    it), the next grouped dispatch raises `MeshWorkerError` with host 1
    within the pool's timeout, `mesh_evict_host(1)` serves from a
    single-level pool of host 0's two workers, the attached `FleetRouter`
    moved only host 1's subnets, a new agent (started after the raise, so
    that it joins while host 0 serves alone) and `mesh_readmit()` serve
    the two-level verdict again; no worker or agent process is left."""
    import multiprocessing
    import socket
    import tempfile

    from lodestar_tpu_torch.observability.stages import PipelineMetrics
    from lodestar_tpu_torch.parallel.fleet import FleetRouter, FleetTopology
    from lodestar_tpu_torch.parallel.mesh import BlsMeshDispatcher
    from lodestar_tpu_torch.parallel.mesh_pool import MeshWorkerError
    from lodestar_tpu_torch.parallel.verifier import TorchBlsVerifier

    tag = "[fleet]"
    b = mesh["batches"]
    grouped, grouped_host, pk_sets, pk_host = b["grouped"], b["grouped_host"], b["pk"], b["pk_host"]
    key_dir = tempfile.mkdtemp(prefix="lodestar-fleet-")
    key_file = os.path.join(key_dir, "authkey")
    with open(key_file, "wb") as f:
        f.write(os.urandom(32).hex().encode())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    topo = FleetTopology.parse(coordinator, hosts=2, rank=0, authkey_file=key_file)
    agents = [_start_agent(coordinator, key_file)]
    pids, d, v = set(), None, None
    out = {"cells": {}, "drill": {}}
    try:
        t0 = time.perf_counter()
        if not topo.ensure_initialized(300):
            raise AssertionError(f"{tag} host 1's agent did not join {coordinator}")
        out["join_s"] = time.perf_counter() - t0
        devices = [FLEET_DEVICE, FLEET_DEVICE] + topo.hub.devices()
        hosts = topo.group_devices(devices)
        if hosts != FLEET_HOSTS:
            raise AssertionError(f"{tag} census {devices} grouped as {hosts}")
        obs = PipelineMetrics()
        router = FleetRouter(2, 0, observer=obs)
        d = BlsMeshDispatcher(devices, observer=obs, hosts=hosts, hub=topo.hub, router=router)
        v = TorchBlsVerifier(device=torch.device(FLEET_DEVICE).type,
                             rng=np.random.default_rng(SEED + 31), mesh=d)
        spied = []  # single-device verdicts called on the fleet verifier
        for kind in ("grouped_raw", "pk_grouped_raw", "bisect_tree"):
            inner = v._kernels[kind]
            v._kernels[kind] = lambda *a, _k=kind, _f=inner: spied.append(_k) or _f(*a)
        pool = d.start_pool()
        pids.update(pool.pids)
        out["start_s"] = pool.start_seconds
        log(f"{tag} agent of host 1 joined {coordinator} in {out['join_s']:.3f} s; census "
            f"{devices}, hosts {hosts}; pool of {pool.size} workers (pids {pool.pids}, places "
            f"{pool.places()}) started in {pool.start_seconds:.3f} s; card: {card_line()}")

        def verdict(name, fn, want, clear_h2c=False, controller_idle=True):
            if clear_h2c:
                v._h2c_cache.clear()
            return _sharded_verdict(tag, d, obs, spied, name, fn, want, controller_idle)

        def cell(name, method, sets, want, bad_name, bad_sets, bad_want, **kw):
            """A first call, one more of the valid batch and the tampered one."""
            c = out["cells"][name] = {}
            fn = lambda: getattr(v, method)(sets)  # noqa: E731
            c["first_s"], _ = verdict(f"{name} valid, first call", fn, want, **kw)
            c["fleet_s"] = [verdict(f"{name} valid", fn, want, **kw)[0]]
            c["bad_s"], c["workers"] = verdict(f"{name} {bad_name}",
                                               lambda: getattr(v, method)(bad_sets), bad_want,
                                               **kw)
            return c

        # grouped-64x64: rows are roots, host 1's workers own the second half
        # of them: a bad signature in row 40 of 64 (set 40·64 + 3)
        k = len(grouped) * 5 // 8 + 3
        bad_sig = _tamper_one(grouped, k, "signature", 10)
        cell("grouped-64x64", "verify_signature_sets", grouped, True,
             f"one bad signature (set {k}, host 1)", bad_sig,
             all(_host_after(grouped_host, bad_sig, (k,))))
        # pk-grouped-128x32: rows are keys, host 1 owns the second half: a
        # wrong message under key 100 of 128 (set 100·32 + 1)
        k = len(pk_sets) * 25 // 32 + 1
        wrong = _wrong_message(pk_sets, k, np.random.default_rng(SEED + 32).bytes(32))
        cell("pk-grouped-128x32", "verify_signature_sets", pk_sets, True,
             f"one wrong message (set {k}, host 1)", wrong,
             all(_host_after(pk_host, wrong, (k,))), clear_h2c=True)
        # per-set-128 by bisection: the first half of the lanes on host 0;
        # the probes run on the controller
        bad_at = [i for i, ok in enumerate(per_set_host_bad) if not ok]
        cell("per-set-128", "verify_signature_sets_individual", per_set_sets, per_set_host,
             f"three invalid {bad_at}", per_set_bad, per_set_host_bad, controller_idle=False)
        for name, c in out["cells"].items():
            m = mesh["cells"][name]
            c["single_level_s"], c["single_device_s"] = min(m["mesh_s"]), min(m["single_s"])
            log(f"{tag} {name}: fleet (2 hosts x 2 workers) {c['fleet_s'][0]:.3f} s, "
                f"first call {c['first_s']:.3f} s; single-level "
                f"(2 workers) {c['single_level_s']:.3f} s, single-device "
                f"{c['single_device_s']:.3f} s (the mesh phase's, same batch); "
                f"per-worker launches {json.dumps(c['workers'])}; card: {card_line()}")

        # the host drill
        drill = out["drill"]
        owners = [router.owner(s) for s in range(router.subnet_count)]
        agents[0].kill()
        agents[0].wait(30)
        t0 = time.perf_counter()
        try:
            v.verify_signature_sets(grouped)
        except MeshWorkerError as e:
            drill["raise_s"] = time.perf_counter() - t0
            log(f"{tag} drill: host 1's agent killed; the next grouped dispatch raised in "
                f"{drill['raise_s']:.6f} s (pool timeout {pool.timeout_s:.0f} s): host {e.host}, "
                f"chip {e.chip}: {str(e).splitlines()[0]}")
            if e.host != 1 or drill["raise_s"] > pool.timeout_s:
                raise AssertionError(f"{tag} drill: raised for host {e.host} after "
                                     f"{drill['raise_s']:.3f} s")
        else:
            raise AssertionError(f"{tag} drill: the dispatch over a dead host did not raise")
        t_rejoin = time.perf_counter()
        agents.append(_start_agent(coordinator, key_file))  # joins while host 0 serves alone
        t0 = time.perf_counter()
        size = v.mesh_evict_host(1, reason="drill")
        drill["evict_s"] = time.perf_counter() - t0
        if size != 2 or d.pool is not None or d.hosts_serving != 1:
            raise AssertionError(f"{tag} drill: evict_host left size {size}, pool {d.pool}")
        moved = [s for s, (a, b2) in enumerate(zip(owners, [router.owner(s) for s in
                                                           range(router.subnet_count)]))
                 if a != b2]
        if moved != [s for s, o in enumerate(owners) if o == 1] or not moved:
            raise AssertionError(f"{tag} drill: the router moved subnets {moved}")
        single_pool = d.start_pool()
        pids.update(single_pool.pids)
        drill["single_level_start_s"] = single_pool.start_seconds
        if single_pool.layout != ((FLEET_DEVICE, FLEET_DEVICE),):
            raise AssertionError(f"{tag} drill: the pool after eviction is {single_pool.layout}")
        drill["single_level_s"], _ = verdict("grouped-64x64 valid on host 0 alone",
                                             lambda: v.verify_signature_sets(grouped), True)
        log(f"{tag} drill: mesh_evict_host(1) in {drill['evict_s']:.6f} s; the router moved "
            f"host 1's {len(moved)} subnets and no other; host 0's single-level pool started "
            f"in {drill['single_level_start_s']:.3f} s and served in "
            f"{drill['single_level_s']:.3f} s")
        if not topo.hub.wait_agents(300):
            raise AssertionError(f"{tag} drill: the new agent did not join")
        drill["rejoin_s"] = time.perf_counter() - t_rejoin
        if v.mesh_readmit() != 1 or d.hosts_serving != 2:
            raise AssertionError(f"{tag} drill: readmit did not restore host 1")
        if router.snapshot()["evicted_hosts"]:
            raise AssertionError(f"{tag} drill: the router kept host 1 evicted")
        pool = d.start_pool()
        pids.update(pool.pids)
        drill["restart_s"] = pool.start_seconds
        drill["served_s"], _ = verdict("grouped-64x64 valid after readmission",
                                       lambda: v.verify_signature_sets(grouped), True)
        log(f"{tag} drill: a new agent (started after the raise) had joined by "
            f"{drill['rejoin_s']:.3f} s after its start (while host 0 served alone), "
            f"mesh_readmit() "
            f"started a two-level pool in {drill['restart_s']:.3f} s, served again in "
            f"{drill['served_s']:.3f} s; card: {card_line()}")
        out["snapshot"] = d.fleet_snapshot()
    finally:
        if d is not None:
            d.close()
        if topo.hub is not None:
            topo.hub.close()  # each agent stops its workers and exits
        for agent in agents:
            try:
                agent.wait(30)
            except subprocess.TimeoutExpired:
                agent.kill()
                agent.wait(30)
        import shutil

        shutil.rmtree(key_dir, ignore_errors=True)
    codes = [a.returncode for a in agents]
    left = _left(pids) + multiprocessing.active_children()
    if left:
        raise AssertionError(f"{tag} processes left: {left}")
    log(f"{tag} agents exited with {codes}; no worker or agent left ({len(pids)} workers "
        f"started); fleet snapshot {json.dumps(out['snapshot'])}")
    return out


BLOCK_VALIDATORS = 16384  # 4 committees of 128 per slot on the mainnet preset
BLOCK_PHASE0 = 3  # phase0 blocks at slots 1..3
CHAIN_DISPATCHER = {"workers": 1, "max_sigs": 64}  # profile_chain.GOSSIP_THREADS callers


def phase_block_import(torch, np):
    """Block import's producer side: the port's params, config, SSZ, types
    and phase0/Altair state transition on the host, each block's signature
    sets verified by the port's serving stack on the card
    (`profile_block.run`). Fails unless every valid block's verdict is
    True and the host tier's, its post-state root the block's, and the
    card gave the verdict: no host-tier fallback of the supervisor, K2p
    and K3-fe launched at least once per 128-set facade job, every job
    run; the tampered block False as on the host tier, the supervisor's
    only host-tier calls the negative audits of its verdict and of its
    per-set verdicts, those per-set verdicts blaming exactly the two
    swapped aggregates with a Miller kernel (K2p or K3) launched per job,
    and its state transition with inline checks on the host tier refused;
    in every call no overturned verdict, deadline, retry or double
    failure, and the breaker closed at the end; and the epoch table
    populated at the Altair boundary. Returns the summary, and the stack
    (open), the scenario and the facade's job counter for the chain
    phase; the stack is closed here only when the phase fails."""
    from lodestar_tpu_torch import profile_block
    from lodestar_tpu_torch.native import install_ssz_backend
    from lodestar_tpu_torch.node.bls_stack import build_bls_stack

    install_ssz_backend()
    t0 = time.perf_counter()
    # one lane worker flushing at 64 sets: the chain phase's 64 gossip
    # callers coalesce into one batch while a verdict runs (the supervisor
    # serves one batch at a time, so a second worker, or a flush at the
    # default 32, splits them in two); block import goes past the lanes
    stack = build_bls_stack(device="cuda", dispatcher_args=CHAIN_DISPATCHER)
    build_s = time.perf_counter() - t0
    jobs = _counting(stack.device._inner, "verify_signature_sets",
                     "verify_signature_sets_individual")
    per_job = stack.device.max_sets_per_job
    try:
        out = profile_block.run(stack.verifier, validators=BLOCK_VALIDATORS, blocks=BLOCK_PHASE0,
                                populate=profile_block.stack_populate(stack, 120),
                                observer=stack.pipeline, sync=torch.cuda.synchronize,
                                probe=lambda: {k: v for k, v in jobs.items()
                                               if not k.endswith("_s")},
                                log=log)
        breaker = stack.supervisor.breaker_state
        summary = _check_block_import(out, breaker, per_job, build_s)
    except BaseException:
        stack.close()
        raise
    return summary, stack, out["scenario"], jobs


def _check_block_import(out, breaker, per_job, build_s):
    from lodestar_tpu_torch import profile_block

    pop = out["populate"]
    if "error" in pop or pop.get("rows") != BLOCK_VALIDATORS:
        raise AssertionError(f"block_import: epoch table population {pop}")
    if breaker != "closed":
        raise AssertionError(f"block_import: the supervisor's breaker is {breaker}")
    *valid, bad = out["blocks"]
    for rec in valid:
        tag = f"block_import slot {rec['slot']}"
        if rec["verdict"] is not True or not all(rec["host"]):
            raise AssertionError(f"{tag}: verdict {rec['verdict']}, host tier {all(rec['host'])}")
        if not rec["state_root_ok"]:
            raise AssertionError(f"{tag}: post-state root is not the block's")
        n_jobs = rec["probe"].get("verify_signature_sets", 0)
        if rec["supervisor"] or n_jobs != -(-rec["sets"] // per_job):
            raise AssertionError(f"{tag}: the card did not give the verdict: supervisor "
                                 f"{rec['supervisor']}, facade jobs {rec['probe']}")
        _need(rec["launches"], tag, "K2p", "K3-fe")
        if min(rec["launches"]["K2p"], rec["launches"]["K3-fe"]) < n_jobs:
            raise AssertionError(f"{tag}: launches {rec['launches']} for {n_jobs} facade jobs")
    altair = valid[-1]
    tag = "block_import tampered"
    blamed = [k for k, ok in enumerate(bad["individual"]) if not ok]
    host_blamed = [k for k, ok in enumerate(bad["host"]) if not ok]
    if bad["verdict"] is not False or all(bad["host"]):
        raise AssertionError(f"{tag}: verdict {bad['verdict']}, host tier {all(bad['host'])}")
    if blamed != bad["swapped_sets"] or host_blamed != bad["swapped_sets"]:
        raise AssertionError(f"{tag}: blamed {blamed}, host tier {host_blamed}, "
                             f"swapped {bad['swapped_sets']}")
    audit = {"fallback_negative_audit": 1}
    n_jobs = bad["probe"].get("verify_signature_sets", 0)
    if bad["supervisor"] != audit or not n_jobs:
        raise AssertionError(f"{tag}: the verdict's supervisor {bad['supervisor']} (only its "
                             f"audit expected), facade jobs {bad['probe']}")
    _need(bad["launches"], tag, "K2p", "K3-fe")
    if min(bad["launches"]["K2p"], bad["launches"]["K3-fe"]) < n_jobs:
        raise AssertionError(f"{tag}: launches {bad['launches']} for {n_jobs} facade jobs")
    n_jobs = bad["individual_probe"].get("verify_signature_sets_individual", 0)
    miller = bad["individual_launches"]["K2p"] + bad["individual_launches"]["K3"]
    if bad["individual_supervisor"] != audit or n_jobs != -(-bad["sets"] // per_job) \
            or miller < n_jobs:
        raise AssertionError(f"{tag}: the per-set verdicts' supervisor "
                             f"{bad['individual_supervisor']} (only its audit expected), facade "
                             f"jobs {bad['individual_probe']}, launches "
                             f"{bad['individual_launches']}")
    if not bad["host_stf_error"]:
        raise AssertionError(f"{tag}: the host tier's state transition passed")
    log(f"[block] stack built in {build_s:.3f} s (cold); slot {altair['slot']}: {altair['sets']} "
        f"sets through {sorted(altair['paths'])} in {altair['probe']['verify_signature_sets']} "
        f"facade jobs with the epoch table warm ({pop['rows']} rows, {pop['seconds']:.3f} s; "
        f"this verdict's lookups {json.dumps(altair['epoch_table'])}); no host-tier fallback "
        f"but the tampered block's two audits, breaker {breaker}; card: {card_line()}")
    return {**profile_block.summary(out), "stack_build_s": build_s}


def _chain_jobs(rec, tag, audits):
    """The card gave the step's verdicts: the supervisor moved no count but
    negative audits (exactly `audits` of them when it is an int, at least
    one when it is "some", none when 0), K2p and K3-fe launched at least
    once per facade batch job and K2p or K3 once per per-set job."""
    sup = dict(rec["supervisor"])
    n_audits = sup.pop("fallback_negative_audit", 0)
    if sup or (n_audits != audits if isinstance(audits, int) else not n_audits):
        raise AssertionError(f"chain {tag}: the supervisor {rec['supervisor']} "
                             f"(negative audits expected: {audits})")
    jobs = rec["probe"].get("verify_signature_sets", 0)
    per_set = rec["probe"].get("verify_signature_sets_individual", 0)
    if not jobs:
        raise AssertionError(f"chain {tag}: no facade job ran ({rec['probe']})")
    _need(rec["launches"], f"chain {tag}", "K2p", "K3-fe")
    miller = rec["launches"]["K2p"] + rec["launches"]["K3"]
    if min(rec["launches"]["K2p"], rec["launches"]["K3-fe"]) < jobs or miller < jobs + per_set:
        raise AssertionError(f"chain {tag}: launches {rec['launches']} for {jobs} facade jobs "
                             f"and {per_set} per-set jobs")


CHAIN_FLOOD_COMMITTEES = 1  # the chain phase's floods: committee 0 of the slot


def phase_chain(torch, np, stack, scenario, jobs):
    """The chain (`profile_chain.run`) on block_import's genesis, blocks
    and stack, every check of the module docstring's 12f; leaves the stack
    and its chain (with the whole slot's gossip) to the network phase
    (closes both only when this phase fails)."""
    out = {}
    try:
        return _chain_phase(torch, stack, scenario, jobs, out)
    except BaseException:
        if out.get("chain") is not None:
            out["chain"].close()
        stack.close()
        raise


def _chain_phase(torch, stack, scenario, jobs, out):
    from lodestar_tpu_torch import profile_chain

    out.update(profile_chain.run(stack.verifier, scenario=scenario, observer=stack.pipeline,
                                 sync=torch.cuda.synchronize,
                                 probe=lambda: {k: v for k, v in jobs.items()
                                                if not k.endswith("_s")},
                                 flood_committees=CHAIN_FLOOD_COMMITTEES, keep=True, log=log))
    breaker = stack.supervisor.breaker_state
    profile_chain.log_steps(out, log)
    if out["failures"]:
        raise AssertionError(f"chain: {out['failures']}")
    if breaker != "closed":
        raise AssertionError(f"chain: the supervisor's breaker is {breaker}")
    steps = out["steps"]
    for name, audits in (("segment", 0), ("tampered", 1), ("altair", 0),
                         ("attestations", "some"), ("aggregates", "some"), ("produce", 0)):
        _chain_jobs(steps[name], name, audits)
    att = steps["attestations"]
    if "root_grouped" not in att["paths"]:
        log(f"[chain] the attestation batches did not go root_grouped: paths {att['paths']}")
    launches = Counter()
    for rec in steps.values():
        launches.update(rec["launches"])
    log(f"[chain] launches in the chain phase: {json.dumps(dict(launches))}; card: {card_line()}")
    return out


NETWORK_STEPS = (("range_sync", 0), ("attestations", "some"), ("aggregates", "some"),
                 ("block", 0))  # the steps with verdicts and their negative audits
NETWORK_BOUND_S = 150.0


def _jobs_of(sets, per_job: int) -> int:
    return sum(-(-n // per_job) for n in sets)


def phase_network(torch, np, stack, scenario, jobs, chain_out):
    """12h. the network (`profile_network.run`) on the chain phase's chain
    and stack, every check of the module docstring's 12h; leaves the stack
    to the capella phase (closes it only when this phase fails)."""
    from lodestar_tpu_torch import profile_network

    per_job = stack.device.max_sets_per_job
    try:
        out = profile_network.run(stack.verifier, scenario=scenario, chain_out=chain_out,
                                  observer=stack.pipeline, sync=torch.cuda.synchronize,
                                  probe=lambda: {k: v for k, v in jobs.items()
                                                 if not k.endswith("_s")},
                                  log=log)
        breaker = stack.supervisor.breaker_state
        profile_network.log_steps(out, log)
        if out["failures"]:
            raise AssertionError(f"network: {out['failures']}")
        if breaker != "closed":
            raise AssertionError(f"network: the supervisor's breaker is {breaker}")
        steps = out["steps"]
        for name, audits in NETWORK_STEPS:
            rec = steps[name]
            _chain_jobs(rec, f"network {name}", audits)
            if "batch_sets" in rec:  # a flood: its coalesced batches
                want = {"verify_signature_sets": _jobs_of(rec["batch_sets"], per_job),
                        "verify_signature_sets_individual": _jobs_of(rec["failed_batch_sets"],
                                                                     per_job)}
            else:
                want = {"verify_signature_sets": _jobs_of(rec["call_sets"], per_job),
                        "verify_signature_sets_individual": 0}
            got = {k: rec["probe"].get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"network {name}: facade jobs {got}, the sets it sent "
                                     f"imply {want}")
            if rec["launches"]["K1"] < got["verify_signature_sets"]:
                raise AssertionError(f"network {name}: launches {rec['launches']} for "
                                     f"{got} facade jobs")
    except BaseException:
        stack.close()
        raise
    launches = Counter()
    for name, _ in NETWORK_STEPS:
        launches.update(out["steps"][name]["launches"])
    out["launches"] = dict(launches)
    log(f"[network] launches in the network phase: {json.dumps(dict(launches))}; "
        f"card: {card_line()}")
    return out


CAPELLA_STEPS = (("slot1", 0), ("slot2", 0), ("tampered", 2), ("invalid_payload", 0),
                 ("prepare", 0))  # the step and its negative audits: the verdict's and the blame's


def phase_capella(torch, np, stack, scenario, jobs):
    """12g. a post-merge Capella chain (`profile_capella.run`) on
    block_import's genesis and the chain phase's stack, every check of the
    module docstring's 12g; closes the stack."""
    from lodestar_tpu_torch import profile_capella
    from lodestar_tpu_torch.params import MAINNET

    per_job = stack.device.max_sets_per_job
    try:
        out = profile_capella.run(stack.verifier, scenario=scenario, observer=stack.pipeline,
                                  sync=torch.cuda.synchronize,
                                  probe=lambda: {k: v for k, v in jobs.items()
                                                 if not k.endswith("_s")},
                                  log=log)
        breaker = stack.supervisor.breaker_state
    finally:
        stack.close()
    profile_capella.log_steps(out, log)
    if out["failures"]:
        raise AssertionError(f"capella: {out['failures']}")
    if breaker != "closed":
        raise AssertionError(f"capella: the supervisor's breaker is {breaker}")
    steps = out["steps"]
    for name, audits in CAPELLA_STEPS:
        rec = steps[name]
        _chain_jobs(rec, f"capella {name}", audits)
        want = {"verify_signature_sets": sum(-(-n // per_job) for n in rec["batch_call_sets"]),
                "verify_signature_sets_individual": sum(
                    -(-n // per_job) for n in rec["individual_call_sets"])}
        got = {k: rec["probe"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"capella {name}: facade jobs {got}, the set counts imply {want}")
    p, slot2 = MAINNET, steps["slot2"]
    if steps["slot1"]["sets"] != 3 + p.MAX_BLS_TO_EXECUTION_CHANGES:
        raise AssertionError(f"capella slot1: {steps['slot1']['sets']} sets")
    if len(slot2["withdrawals"]) != p.MAX_WITHDRAWALS_PER_PAYLOAD \
            or slot2["sweep_validators"] != BLOCK_VALIDATORS:
        raise AssertionError(f"capella slot2: {len(slot2['withdrawals'])} withdrawals after a "
                             f"sweep of {slot2['sweep_validators']} validators")
    launches = Counter()
    for name, _ in CAPELLA_STEPS:
        launches.update(steps[name]["launches"])
    log(f"[capella] launches in the capella phase: {json.dumps(dict(launches))}; "
        f"card: {card_line()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import lodestar_tpu_torch  # noqa: F401  (fails outside a checkout)
    from lodestar_tpu_torch.ops import cuda_tower

    t_start = time.perf_counter()
    phase_env(torch)
    torch.cuda.init()
    stack_at_start = stack_limit()
    log(f"[env] per-thread stack limit at the start: {stack_at_start} B")
    ptxas = timed("build", phase_build)
    muls = cuda_tower.fp_muls_per_lane()
    log(f"[build] Fp multiplies per lane (host harness): {json.dumps(muls)}")
    max_err, k1_rows, k1_ptxas = timed("k1", phase_k1, torch, np, ptxas)
    k4_err, k4_rows = timed("k4", phase_k4, torch, np)
    fe_err, fe_rows = timed("fe", phase_fe, torch, np, muls, ptxas)
    k2p_err, k2p_rows = timed("k2p", phase_k2p, torch, np, muls, ptxas)
    k2p_row = k2p_rows[K2P_LANES[-1]]
    sets, host_ok, bad, host_bad = per_set_batches(np)
    k3_err, k3_rows = timed("k3", phase_k3, torch, np, muls, ptxas, bad, host_bad)
    k3_row = k3_rows[PER_SET_N]
    k2_err, k2_rows = timed("k2", phase_k2, torch, np, muls, ptxas, stack_at_start)
    k2_row = k2_rows[K2_LANES[-1]]
    grouped_counts, wall, n_sets, grouped_products, grouped = timed(
        "slice 64x64", phase_slice, torch, np, 64, 64)
    log(f"[slice] main path (64, 64): {wall:.3f} s per {n_sets}-set verdict, "
        f"{n_sets / wall:.1f} sets/s, launches per verdict {json.dumps(grouped_counts)}")
    timed("slice 16x8", phase_slice, torch, np, 16, 8)
    pk = timed("pk-grouped", phase_pk_grouped, torch, np)
    flat = timed("flat", phase_flat, torch, np)
    split = timed("split", phase_split, torch, np)
    per_set = timed("per-set", phase_per_set, torch, np, sets, host_ok, bad, host_bad)
    checks = timed("pairing-check", phase_pairing_check, torch, np, sets, host_ok, bad, host_bad)
    serve = timed("serve", phase_serve, torch, np)
    observe = timed("observe", phase_observe, torch, np)
    node = timed("node", phase_node, torch, np, grouped, serve["batch"], sets)
    mesh = timed("mesh", phase_mesh, torch, np, grouped, pk["batch"], sets, host_ok, bad, host_bad)
    fleet = timed("fleet", phase_fleet, torch, np, mesh, sets, host_ok, bad, host_bad)
    blocks, chain_stack, scenario, chain_jobs = timed("block_import", phase_block_import, torch, np)
    chain = timed("chain", phase_chain, torch, np, chain_stack, scenario, chain_jobs)
    network = timed("network", phase_network, torch, np, chain_stack, scenario, chain_jobs,
                    chain)
    capella = timed("capella", phase_capella, torch, np, chain_stack, scenario, chain_jobs)
    log(f"[summary] pk-grouped {PK_KEYS * PK_ROOTS} sets: {pk['warm']['seconds']:.3f} s warm, "
        f"its roots hashed anew ({PK_KEYS * PK_ROOTS / pk['warm']['seconds']:.1f} sets/s), first call "
        f"{pk['cold']['seconds']:.3f} s; flat 128 {flat['128']['seconds']:.3f} s, 200 "
        f"{flat['200']['seconds']:.3f} s; split + pk-grouped {split['pk-grouped']['seconds']:.3f} s, "
        f"split + flat {split['flat']['seconds']:.3f} s")
    log(f"[summary] per-set {PER_SET_N}: bisection valid {per_set['a']['seconds']:.3f} s, "
        f"bisection 3 invalid {per_set['b']['seconds']:.3f} s, K3 route "
        f"{per_set['c']['seconds']:.6f} s; script {time.perf_counter() - t_start:.1f} s")
    log(f"[summary] serve: populate {serve['populate']['rows']} rows "
        f"{serve['populate']['seconds']:.6f} s, warm_h2c {serve['warm_h2c']['hashed']} roots; "
        f"128-set job valid {serve['valid']['seconds']:.3f} s, three bad "
        f"{serve['three bad signatures']['seconds']:.3f} s, per-set "
        f"{serve['individual']['seconds']:.3f} s")
    log(f"[summary] observe: 128-set job median {observe['median_s']['A']:.6f} s with "
        f"PipelineMetrics, {observe['median_s']['B']:.6f} s with NullObserver; observing "
        f"costs the host {observe['host_cost_us']['job_us']:.1f} us per job")
    boot, s = node["boot"], node["slot"]
    log(f"[summary] node: boot serving_ready {boot['serving_ready_seconds']} s (SLO "
        f"{'met' if boot['slo_met'] else 'missed'}), peak {boot['peak_device_bytes']} B; "
        f"slot max_coalesce 512 ({s['calls']} calls, {s['order']}): makespan "
        f"{s['makespan_s']:.3f} s, {s['att_sets_per_s']:.1f} attestation sets/s, block p50 "
        f"{s['block_p50_s']:.3f} max {s['block_max_s']:.3f} s, sheds {s['att_sheds']}, "
        f"{s['batches']} batches (largest {s['batch_max']}), overlap "
        f"{s['overlap_fraction']}, utilisation {s['utilization']:.4f}, tampered cost "
        f"{s['per_set_s']:.3f} s per-set + {s['audit_batch_s']:.3f} s audit, "
        f"dispatch worker busy {s['worker_busy']:.4f}, queued {s['device_wait_s']:.3f} s"
        f"; drills: breaker re-closed {node['drills']['exception']['reclose_s']:.3f} s after "
        f"clearing, latency {node['drills']['latency_s']:.3f} s, flaky "
        f"{node['drills']['flaky_s']:.3f} s; mesh drill raise {node['mesh_drill']['raise_s']:.6f} s, "
        f"served single-device {node['mesh_drill']['evicted_served_s']:.3f} s, re-admitted "
        f"{node['mesh_drill']['readmit_s']:.3f} s; card: {card_line()}")
    pre, aot, span = boot["preload"], node["aot_drill"], node["span_cost"]
    log(f"[summary] node store and spans: preload outcomes {json.dumps(pre['outcomes'])}, load "
        f"seconds {json.dumps(pre['load_seconds'])}, first launches "
        f"{json.dumps(pre['launch_seconds'])}, {pre['seconds']} s in all, aot_load at "
        f"{boot['marks'].get('aot_load')} s; workers' preload "
        f"{[p['seconds'] for p in node['mesh_drill']['preload']]} s; store drill: corrupt "
        f"mont_mul rebuilt in {aot['rebuild_s']:.3f} s, its verdict {aot['verdict_s']:.3f} s, "
        f"foreign host tier rebuilt in {aot['mismatch_rebuild_s']:.3f} s; a lifecycle span "
        f"{span['span_us']:.3f} us on the host; {node['drills']['traces']['jobs']} drill traces "
        f"counted {node['drills']['traces']['counted']:.0f}; card: {card_line()}")
    log(f"[summary] mesh (two workers on cuda:0): pool start {mesh['start_s']:.3f} s; "
        + "; ".join(f"{n} {min(c['mesh_s']):.3f} s against single-device "
                    f"{min(c['single_s']):.3f} s (best of {len(c['mesh_s'])} each)"
                    for n, c in mesh["cells"].items())
)
    log(f"[summary] fleet (2 hosts x 2 workers on cuda:0, host 1 over TCP): agent join "
        f"{fleet['join_s']:.3f} s, pool start {fleet['start_s']:.3f} s; "
        + "; ".join(f"{n} {min(c['fleet_s']):.3f} s against single-level "
                    f"{c['single_level_s']:.3f} s and single-device {c['single_device_s']:.3f} s"
                    for n, c in fleet["cells"].items())
        + f"; drill raise {fleet['drill']['raise_s']:.6f} s, evict_host "
        f"{fleet['drill']['evict_s']:.6f} s, single-level start "
        f"{fleet['drill']['single_level_start_s']:.3f} s, rejoined by {fleet['drill']['rejoin_s']:.3f} s, "
        f"restart {fleet['drill']['restart_s']:.3f} s; script {time.perf_counter() - t_start:.1f} s; "
        f"card: {card_line()}")
    setup = blocks["setup"]
    log(f"[summary] block_import ({blocks['validators']} validators, {blocks['preset']}): setup "
        f"{setup['total_s']:.3f} s (deposits {setup['deposits_s']:.3f}, genesis "
        f"{setup['genesis_s']:.3f}, blocks {setup['blocks_s']:.3f}); "
        + "; ".join(f"slot {r['slot']}{' tampered' if r.get('tampered') else ''} {r['sets']} sets: "
                    f"pre-state {r['pre_state_s']:.3f} s, sets {r['sets_s']:.3f} s, state "
                    f"transition {r['stf_s']:.3f} s, verdict {r['verdict_s']:.3f} s, import "
                    f"{r['import_s']:.3f} s, paths {sorted(r['paths'])}, launches "
                    f"{json.dumps(r['launches'])}"
                    + (f", per-set blame {r['individual_s']:.3f} s, paths "
                       f"{sorted(r['individual_paths'])}, launches "
                       f"{json.dumps(r['individual_launches'])}" if r.get("tampered") else "")
                    for r in blocks["blocks"])
        + f"; epoch table {blocks['populate']['rows']} rows in {blocks['populate']['seconds']:.3f} s"
        f"; script {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    st = chain["steps"]
    log(f"[summary] chain ({chain['validators']} validators, {chain['preset']}): init "
        f"{chain['chain_init_s']:.3f} s; "
        + "; ".join(f"{k} {st[k]['seconds']:.3f} s" for k in st)
        + "; " + "; ".join(
            f"{k} {st[k]['calls']} calls in {st[k]['makespan_s']:.3f} s "
            f"({st[k]['validations_per_s']:.1f}/s, p50 {st[k]['latency_p50_s']:.4f} p99 "
            f"{st[k]['latency_p99_s']:.4f} max {st[k]['latency_max_s']:.4f} s, "
            f"{st[k]['batches']} batches, largest {max(st[k]['batch_sizes'], default=0)})"
            for k in ("attestations", "aggregates"))
        + f"; script {time.perf_counter() - t_start:.1f} s; card: {card_line()}")
    st = network["steps"]
    log(f"[summary] network ({network['validators']} validators, {network['peers']} peers on "
        f"loopback): connect {st['connect']['seconds']:.3f} s (dial p50 "
        f"{st['connect']['dial_p50_ms']:.1f} ms, ed25519 sign "
        f"{st['connect']['primitive_us']['ed25519_sign']:.1f} us, verify "
        f"{st['connect']['primitive_us']['ed25519_verify']:.1f} us); range sync "
        f"{st['range_sync']['seconds']:.3f} s (blocks {st['range_sync']['blocks']}, "
        f"{st['range_sync']['sets']} sets); "
        + "; ".join(
            f"{k} {st[k]['calls']} validated in {st[k]['makespan_s']:.3f} s "
            f"({st[k]['validations_per_s']:.1f}/s, p50 {st[k]['latency_p50_s']:.4f} p99 "
            f"{st[k]['latency_p99_s']:.4f} max {st[k]['latency_max_s']:.4f} s, "
            f"{st[k]['batches']} batches, largest {max(st[k]['batch_sizes'], default=0)})"
            for k in ("attestations", "aggregates"))
        + f"; block {st['block']['seconds']:.3f} s, weight {st['block']['weight'][0]}; phase "
        f"{PHASE_SECONDS['network']:.1f} s (bound {NETWORK_BOUND_S:.0f} s"
        f"{'' if PHASE_SECONDS['network'] <= NETWORK_BOUND_S else ', OVER'}); launches "
        f"{json.dumps(network['launches'])}; script {time.perf_counter() - t_start:.1f} s; "
        f"card: {card_line()}")
    st, setup = capella["steps"], capella["setup"]
    log(f"[summary] capella ({capella['validators']} validators, {capella['preset']}): upgrades "
        + ", ".join(f"epoch {e['epoch']} {e['seconds']:.3f} s" for e in st["upgrades"]["epochs"])
        + f"; capella state {setup['capella_state_s']:.3f} s, chain init "
        f"{setup['chain_init_s']:.3f} s; "
        + "; ".join(f"{k} {st[k]['seconds']:.3f} s ({st[k]['sets']} sets"
                    + (f", produce {st[k]['produce_s']:.3f} s" if "produce_s" in st[k] else "")
                    + (f", verdict {st[k]['bls_verify_s']:.3f} s" if "bls_verify_s" in st[k]
                       else "")
                    + (f", process_block {st[k]['process_block_s']:.3f} s"
                       if "process_block_s" in st[k] else "")
                    + f", paths {sorted(st[k]['paths'])})"
                    for k, _ in CAPELLA_STEPS)
        + f"; sweep of {st['slot2']['sweep_validators']} validators "
        f"{st['slot2']['sweep_s']:.4f} s, {len(st['slot2']['withdrawals'])} withdrawals; phase "
        f"{PHASE_SECONDS['capella']:.1f} s; script {time.perf_counter() - t_start:.1f} s; "
        f"card: {card_line()}")
    log(f"[summary] phase seconds {json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})}")
    log(f"[summary] ptxas {json.dumps(ptxas)}")
    log(f"[summary] k1 by products (device and call ms): {json.dumps(k1_rows)}; "
        f"ptxas {json.dumps(k1_ptxas)}")
    log(f"[summary] k4 and k1 by products (device and call ms): {json.dumps(k4_rows)}")
    stack_end = stack_limit()
    log(f"[summary] per-thread stack limit {stack_end} B at the end, {stack_at_start} B at "
        f"the start; the first launches of K3-fe, K2p, K3 and K2 took "
        f"{fe_rows[FE_LANES[0]]['first_launch_bytes']} B, {k2p_row['first_launch_bytes']} B, "
        f"{k3_row['first_launch_bytes']} B and {k2_row['first_launch_bytes']} B")
    if stack_end > stack_at_start:
        raise AssertionError("the per-thread stack limit was raised")
    log(f"[summary] k3-fe by lanes: {json.dumps(fe_rows)}")
    log(f"[summary] k2p by lanes: {json.dumps(k2p_rows)}")
    log(f"[summary] k3 by sets: {json.dumps(k3_rows)}")
    log(f"[summary] k2 by lanes: {json.dumps(k2_rows)}")

    from lodestar_tpu_torch.ops import cuda_fp, cuda_mxu

    k1_mix = launch_mix(torch, np, "k1 main path", grouped_products["K1"],
                        cuda_fp.mont_mul_cuda, cuda_fp.mont_mul_plain, k1_bound)
    k4_mix = launch_mix(torch, np, "k4 main path", pk["warm"]["products"]["K4"],
                        cuda_mxu.mont_mul_mxu_cuda, cuda_mxu.mont_mul_mxu_plain, k4_bound)
    kernels = {"kernels": [
        {
            "name": "mont_mul",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/mont_mul.cu",
            "replaces": "lodestar_tpu/ops/pallas_fp.py:52",
            "launches": grouped_counts["K1"],
            "max_abs_err": max_err,
            "ms": k1_mix["ms"],
            "call_ms": k1_mix["call_ms"],
            "plain_ms": k1_mix["plain_ms"],
            "bound_ms": k1_mix["bound_ms"],
            "bound_by": k1_mix["bound_by"],
            "library_ms": None,
        },
        {
            "name": "mont_mul_mxu",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/mxu_mont.cu",
            "replaces": "lodestar_tpu/ops/pallas_mxu.py:124",
            "launches": pk["warm"]["counts"]["K4"],
            "max_abs_err": k4_err,
            "ms": k4_mix["ms"],
            "call_ms": k4_mix["call_ms"],
            "plain_ms": k4_mix["plain_ms"],
            "bound_ms": k4_mix["bound_ms"],
            "bound_by": k4_mix["bound_by"],
            "library_ms": None,
        },
        {
            "name": "miller_loop",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:120",
            "launches": checks["valid"]["counts"]["K2"],
            "max_abs_err": k2_err,
            "ms": k2_row["ms"],
            "call_ms": k2_row["call_ms"],
            "rounds": k2_row["rounds"],
            "us_per_round": k2_row["us_per_round"],
            "schedule_fp_muls": k2_row["schedule_fp_muls"],
            "plain_ms": k2_row["plain_ms"],
            "bound_ms": k2_row["bound_ms"],
            "bound_by": k2_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "miller_loop_proj",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:120",
            "serves": "lodestar_tpu/ops/pairing.py:225",
            "launches": grouped_counts["K2p"],
            "max_abs_err": k2p_err,
            "ms": k2p_row["ms"],
            "call_ms": k2p_row["call_ms"],
            "rounds": k2p_row["rounds"],
            "us_per_round": k2p_row["us_per_round"],
            "schedule_fp_muls": k2p_row["schedule_fp_muls"],
            "plain_ms": k2p_row["plain_ms"],
            "bound_ms": k2p_row["bound_ms"],
            "bound_by": k2p_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "final_exp",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:240",
            "serves": "lodestar_tpu/ops/pairing.py:343",
            "launches": grouped_counts["K3-fe"],
            "max_abs_err": fe_err,
            "ms": fe_rows[1]["ms"],
            "call_ms": fe_rows[1]["call_ms"],
            "rounds": fe_rows[1]["rounds"],
            "us_per_round": fe_rows[1]["us_per_round"],
            "schedule_fp_muls": fe_rows[1]["schedule_fp_muls"],
            "plain_ms": fe_rows[1]["plain_ms"],
            "bound_ms": fe_rows[1]["bound_ms"],
            "bound_by": fe_rows[1]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "pairing_fused",
            "route": "cuda",
            "source": "lodestar_tpu_torch/csrc/tower.cu",
            "replaces": "lodestar_tpu/ops/pallas_tower.py:240",
            "launches": per_set["d"]["counts"]["K3"],
            "max_abs_err": k3_err,
            "ms": k3_row["ms"],
            "call_ms": k3_row["call_ms"],
            "rounds": k3_row["rounds"],
            "us_per_round": k3_row["us_per_round"],
            "schedule_fp_muls": k3_row["schedule_fp_muls"],
            "plain_ms": k3_row["plain_ms"],
            "bound_ms": k3_row["bound_ms"],
            "bound_by": k3_row["bound_by"],
            "library_ms": None,
        },
    ]}
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
