"""Slashing protection: the only stateful safety gate a validator has (the
port's copy of the JAX package's `validator/slashing_protection.py`, over
the port's `db/repository.py`).

Reference: `validator/src/slashingProtection/` — block-by-slot repository,
attestation-by-target repository, and the min/max-surround algorithm
(`minMaxSurround/minMaxSurround.ts`) detecting surround votes in O(1) per
check via distance spans; interchange = EIP-3076 JSON.

This implementation keeps the same safety conditions:
  blocks: a second block at slot <= max(signed slots) is refused unless it
          is the identical signing root at the same slot.
  attestations: refuse double votes (same target, different root),
          surrounding votes (s < s', t > t') and surrounded votes
          (s > s', t < t'), via min/max distance spans per validator.

Surround detection is the reference's min-max-surround algorithm
(`minMaxSurround/minMaxSurround.ts`): per validator,
  max_span[e] = max{t' − e : recorded votes (s', t') with s' < e}
  min_span[e] = min{t' − e : recorded votes (s', t') with s' > e}
so a new vote (s, t) is surrounded iff s + max_span[s] > t and surrounds
a recorded vote iff s + min_span[s] < t — O(1) per check regardless of
how many targets were pruned from the exact-root history. Span updates
walk outward from the new vote and stop at the first epoch whose stored
span already dominates (the monotonicity early-break of the reference's
update loops), bounded by `max_epoch_lookback`. Votes whose source falls
below the maintained span floor are refused conservatively (the safety
direction of EIP-3076: never sign when history is unknown).
"""

from __future__ import annotations

import json

from ..db.repository import Bucket, Repository


class SlashingError(ValueError):
    pass


class _U64:
    @staticmethod
    def serialize(v: int) -> bytes:
        return int(v).to_bytes(8, "big")

    @staticmethod
    def deserialize(b: bytes) -> int:
        return int.from_bytes(b, "big")


class _Json:
    @staticmethod
    def serialize(v) -> bytes:
        return json.dumps(v, sort_keys=True).encode()

    @staticmethod
    def deserialize(b: bytes):
        return json.loads(b.decode())


class _SpanStore:
    """Chunked distance-span storage for one (repo, pubkey).

    Spans live in per-1024-epoch chunk records (key = pubkey ‖ u32 chunk
    index) so a signature only rewrites the chunks its walk touched —
    the reference stores per-epoch span records for the same reason
    (`minMaxSurround/`: O(changed epochs), not O(lookback), per update).
    The owning attestation record tracks which chunk ids exist."""

    CHUNK = 1024

    def __init__(self, repo, pubkey: bytes, chunk_ids: list[int]):
        self.repo = repo
        self.pk = pubkey
        self.chunk_ids = set(chunk_ids)
        self._loaded: dict[int, dict] = {}
        self._dirty: set[int] = set()

    def _key(self, cid: int) -> bytes:
        return self.pk + cid.to_bytes(4, "big")

    def _chunk(self, cid: int) -> dict:
        c = self._loaded.get(cid)
        if c is None:
            c = (self.repo.get(self._key(cid)) or {}) if cid in self.chunk_ids else {}
            self._loaded[cid] = c
        return c

    def get(self, epoch: int):
        return self._chunk(epoch // self.CHUNK).get(str(epoch % self.CHUNK))

    def set(self, epoch: int, dist: int) -> None:
        cid = epoch // self.CHUNK
        self._chunk(cid)[str(epoch % self.CHUNK)] = dist
        self._dirty.add(cid)
        self.chunk_ids.add(cid)

    def prune_below(self, floor: int) -> None:
        """Drop whole chunks strictly below the floor (boundary-chunk
        entries below the floor are unreachable — floor-rejected — and
        bounded by one chunk, so they are left in place)."""
        for cid in [c for c in self.chunk_ids if (c + 1) * self.CHUNK <= floor]:
            self.repo.delete(self._key(cid))
            self.chunk_ids.discard(cid)
            self._loaded.pop(cid, None)
            self._dirty.discard(cid)

    def flush(self) -> None:
        for cid in self._dirty:
            self.repo.put(self._key(cid), self._loaded[cid])
        self._dirty.clear()


class SlashingProtection:
    """Per-pubkey protection DB over the shared KV store (buckets 20-24 in
    the reference schema).

    `max_epoch_lookback` bounds how far span updates walk (reference:
    `minMaxSurround.ts` `maxEpochLookback`); spans older than
    `max_target − lookback` are pruned and the floor advances — votes
    reaching below the floor are refused rather than guessed at."""

    def __init__(self, db, max_epoch_lookback: int = 8192):
        self.blocks = Repository(
            db, Bucket.validator_slashingProtectionBlockBySlot, _Json
        )
        self.atts = Repository(
            db, Bucket.validator_slashingProtectionAttestationByTarget, _Json
        )
        self.spans_min = Repository(
            db, Bucket.validator_slashingProtectionMinSpanDistance, _Json
        )
        self.spans_max = Repository(
            db, Bucket.validator_slashingProtectionMaxSpanDistance, _Json
        )
        self.max_epoch_lookback = max_epoch_lookback

    # -- blocks --------------------------------------------------------------

    def check_and_insert_block_proposal(
        self, pubkey: bytes, slot: int, signing_root: bytes
    ) -> None:
        rec = self.blocks.get(pubkey) or {}
        max_slot = rec.get("max_slot", -1)
        roots = rec.get("roots", {})
        if slot <= max_slot:
            prev = roots.get(str(slot))
            if prev != signing_root.hex():
                raise SlashingError(
                    f"block proposal at slot {slot} <= previously signed {max_slot}"
                )
            return  # identical re-sign is safe
        roots[str(slot)] = signing_root.hex()
        # keep a bounded window of recent roots
        if len(roots) > 64:
            for k in sorted(roots, key=int)[: len(roots) - 64]:
                del roots[k]
        self.blocks.put(pubkey, {"max_slot": slot, "roots": roots})

    # -- attestations --------------------------------------------------------

    def check_and_insert_attestation(
        self, pubkey: bytes, source_epoch: int, target_epoch: int, signing_root: bytes
    ) -> None:
        if source_epoch > target_epoch:
            raise SlashingError("source after target")
        rec = self.atts.get(pubkey) or {}
        targets = rec.get("targets", {})

        # double vote against the exact-root window
        prev = targets.get(str(target_epoch))
        if prev is not None:
            if prev["root"] != signing_root.hex():
                raise SlashingError(f"double vote at target {target_epoch}")
            return
        # a target at or below the pruned exact-root window cannot be
        # double-vote-checked — refuse rather than guess (EIP-3076 safety)
        if target_epoch <= rec.get("pruned_below", -1):
            raise SlashingError(
                f"target {target_epoch} below retained history"
            )

        # one-time migration: records from before the span rewrite have
        # targets but no span data — rebuild spans by replaying the
        # retained votes (surround info for already-pruned votes is gone,
        # so the floor starts at the lowest retained source: older votes
        # are refused, never guessed at)
        if targets and "span_floor" not in rec:
            replay = sorted(
                ((v["source"], int(t), v["root"]) for t, v in targets.items()),
                key=lambda x: x[1],
            )
            self.atts.put(
                pubkey,
                {
                    "targets": {},
                    "span_floor": max(0, min(s for s, _, _ in replay)),
                    "min_chunks": [],
                    "max_chunks": [],
                    "max_target": rec.get("max_target", -1),
                    "min_source": rec.get("min_source", 0),
                    "pruned_below": rec.get("pruned_below", -1),
                },
            )
            # A retained vote wider than max_epoch_lookback (long
            # non-finality) can make a later replayed vote's source fall
            # below the advancing span floor and fail mid-replay. Such
            # votes must not vanish silently: raise pruned_below to the
            # highest lost target so future votes at (or below) those
            # targets are refused instead of passing the double-vote
            # check against an emptied window.
            lost_targets = []
            for s, t, root in replay:
                try:
                    self.check_and_insert_attestation(
                        pubkey, s, t, bytes.fromhex(root)
                    )
                except SlashingError:
                    lost_targets.append(t)
            if lost_targets:
                poisoned = self.atts.get(pubkey) or {}
                poisoned["pruned_below"] = max(
                    poisoned.get("pruned_below", -1), max(lost_targets)
                )
                self.atts.put(pubkey, poisoned)
            rec = self.atts.get(pubkey) or {}
            targets = rec.get("targets", {})
            # the in-flight vote must re-pass the prune gate against the
            # migrated record (pruned_below may have advanced just now)
            if target_epoch <= rec.get("pruned_below", -1):
                raise SlashingError(
                    f"target {target_epoch} below retained history"
                )

        # min-max-surround in O(1): spans answer both directions without
        # consulting (possibly pruned) individual votes
        mins = _SpanStore(self.spans_min, pubkey, rec.get("min_chunks", []))
        maxs = _SpanStore(self.spans_max, pubkey, rec.get("max_chunks", []))
        floor = rec.get("span_floor")
        if floor is not None and source_epoch < floor:
            raise SlashingError(
                f"source {source_epoch} below span floor {floor}: "
                "history unknown, refusing to sign"
            )
        # wide votes (span > lookback) are kept verbatim: the bounded span
        # walks cannot encode them, and they only arise in extreme
        # non-finality, so a direct scan over the handful of them is exact
        wide = [tuple(w) for w in rec.get("wide", [])]
        for ws, wt in wide:
            if ws < source_epoch and target_epoch < wt:
                raise SlashingError(f"surrounded by wide vote ({ws},{wt})")
            if source_epoch < ws and wt < target_epoch:
                raise SlashingError(f"surrounding wide vote ({ws},{wt})")
        d_max = maxs.get(source_epoch)
        if d_max is not None and source_epoch + d_max > target_epoch:
            raise SlashingError(
                f"surrounded by a recorded vote reaching target "
                f"{source_epoch + d_max}"
            )
        d_min = mins.get(source_epoch)
        if d_min is not None and source_epoch + d_min < target_epoch:
            raise SlashingError(
                f"surrounding a recorded vote with target {source_epoch + d_min}"
            )

        # record: exact-root window (bounded, tracks its prune floor) …
        targets[str(target_epoch)] = {
            "source": source_epoch,
            "root": signing_root.hex(),
        }
        pruned_below = rec.get("pruned_below", -1)
        if len(targets) > 512:
            drop = sorted(targets, key=int)[: len(targets) - 512]
            pruned_below = max(pruned_below, int(drop[-1]))
            for k in drop:
                del targets[k]
        # … and the spans (reference update loops with the monotonicity
        # early break: stop at the first epoch whose stored span already
        # dominates — see minMaxSurround.ts updateMinSpan/updateMaxSpan).
        # BOTH walks are bounded by the lookback; a vote too wide for the
        # max walk goes on the wide list instead, so nothing is silently
        # dropped.
        lo_bound = max(0, source_epoch - self.max_epoch_lookback)
        for e in range(source_epoch - 1, lo_bound - 1, -1):
            d = mins.get(e)
            new = target_epoch - e
            if d is not None and d <= new:
                break
            mins.set(e, new)
        hi_bound = min(target_epoch, source_epoch + 1 + self.max_epoch_lookback)
        for e in range(source_epoch + 1, hi_bound):
            d = maxs.get(e)
            new = target_epoch - e
            if d is not None and d >= new:
                break
            maxs.set(e, new)
        if target_epoch - source_epoch > self.max_epoch_lookback:
            wide.append((source_epoch, target_epoch))
            # drop wide votes made redundant by the new one (surrounded
            # wide votes can never trigger again once a wider one exists)
            wide = [
                (ws, wt)
                for ws, wt in wide
                if not (source_epoch < ws and wt < target_epoch)
            ]

        max_target = max(target_epoch, rec.get("max_target", -1))
        new_floor = max(0, max_target - self.max_epoch_lookback)
        if floor is None:
            floor = lo_bound
        if new_floor > floor:
            mins.prune_below(new_floor)
            maxs.prune_below(new_floor)
            floor = new_floor

        mins.flush()
        maxs.flush()
        self.atts.put(
            pubkey,
            {
                "targets": targets,
                "pruned_below": pruned_below,
                "max_target": max_target,
                "min_source": min(source_epoch, rec.get("min_source", source_epoch)),
                "span_floor": floor,
                "min_chunks": sorted(mins.chunk_ids),
                "max_chunks": sorted(maxs.chunk_ids),
                "wide": [list(w) for w in wide],
            },
        )

    # -- EIP-3076 interchange ------------------------------------------------

    def export_interchange(self, genesis_validators_root: bytes, pubkeys) -> dict:
        data = []
        for pk in pubkeys:
            blocks_rec = self.blocks.get(pk) or {}
            atts_rec = self.atts.get(pk) or {}
            data.append(
                {
                    "pubkey": "0x" + pk.hex(),
                    "signed_blocks": [
                        {"slot": str(s), "signing_root": "0x" + r}
                        for s, r in sorted(
                            blocks_rec.get("roots", {}).items(), key=lambda kv: int(kv[0])
                        )
                    ],
                    "signed_attestations": [
                        {
                            "source_epoch": str(v["source"]),
                            "target_epoch": t,
                            "signing_root": "0x" + v["root"],
                        }
                        for t, v in sorted(
                            atts_rec.get("targets", {}).items(), key=lambda kv: int(kv[0])
                        )
                    ],
                }
            )
        return {
            "metadata": {
                "interchange_format_version": "5",
                "genesis_validators_root": "0x" + genesis_validators_root.hex(),
            },
            "data": data,
        }

    def import_interchange(self, obj: dict) -> None:
        for entry in obj.get("data", []):
            pk = bytes.fromhex(entry["pubkey"][2:])
            for b in entry.get("signed_blocks", []):
                try:
                    self.check_and_insert_block_proposal(
                        pk,
                        int(b["slot"]),
                        bytes.fromhex(b.get("signing_root", "0x")[2:] or "00"),
                    )
                except SlashingError:
                    continue
            for a in entry.get("signed_attestations", []):
                try:
                    self.check_and_insert_attestation(
                        pk,
                        int(a["source_epoch"]),
                        int(a["target_epoch"]),
                        bytes.fromhex(a.get("signing_root", "0x")[2:] or "00"),
                    )
                except SlashingError:
                    continue
