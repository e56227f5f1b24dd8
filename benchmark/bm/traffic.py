"""The general traffic generator: a configuration file (the deployment's
sizes) and a traffic file (how the cell visits them) make, from the seed,
a pool of items and the sequence of units the callers take.

An item is a list of signature sets (pk bytes, 32 B signing root, sig
bytes) with its invalid variant beside it. Unit k visits item
`order[k % pool_size]`, in its invalid variant when k % every == offset
(the traffic file fixes both, so every seed's window holds as many
invalid units at the same places),
and makes the traffic's calls from it in order: `"sets": "all"` hands the
call every set of the item, `"first"` the first set alone.

Pool kinds:

- `committee_attestations`: one slot's committees, `committee_members`
  validators held of each, every member's attestation over its
  committee's AttestationData root; the invalid variant carries another
  member of the same committee's signature over the same root.
- `blocks`: `distinct_blocks` consecutive Altair blocks, each one's sets
  in the order the state transition emits them: the proposer's, RANDAO,
  one aggregate per committee of `aggregate_slots` previous slots (each
  key one summed key), and a full sync aggregate; the invalid variant has
  one aggregate, at a seeded position among the sets the traffic's
  `invalid.set_range` [first, end) names (every aggregate without it),
  signed over another committee's root.

Every seed gives the same sizes, counts, call shapes and invalid units;
the seed draws keys, roots, the visiting order and, in a block, which
aggregate is the invalid one.
"""

from __future__ import annotations

import hashlib
import random

from . import roots, signer

INVALID_KIND = {"committee_attestations": "other_member_signature",
                "blocks": "aggregate_other_root"}
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def _hex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


class Seeded:
    """Independent deterministic streams from one seed, by purpose."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def digest(self, *parts) -> bytes:
        text = ":".join(str(p) for p in (self.seed,) + parts)
        return hashlib.sha256(text.encode()).digest()

    def scalar(self, *parts) -> int:
        """A secret scalar in [1, r)."""
        return 1 + int.from_bytes(self.digest("scalar", *parts) * 2, "big") % (R - 1)

    def rng(self, *parts) -> random.Random:
        return random.Random(int.from_bytes(self.digest("rng", *parts), "big"))


class Mix:
    """The cell's pool, its order and its units, made from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, threads: int = 8):
        self.config = config
        self.traffic = traffic
        self.s = Seeded(seed)
        self.threads = threads
        self.calls = traffic["calls"]
        kind = traffic["pool"]
        if kind == "committee_attestations":
            self.items, self.bad_items, self.table_keys = self._committee_attestations()
        elif kind == "blocks":
            self.items, self.bad_items, self.table_keys = self._blocks()
        else:
            raise ValueError(f"unknown pool kind {kind!r}")
        if len(self.items) != traffic["pool_size"]:
            raise ValueError(f"the configuration makes {len(self.items)} items, the traffic "
                             f"asks for {traffic['pool_size']}")
        self.order = list(range(len(self.items)))
        if traffic["order"] == "shuffled":
            self.s.rng("order").shuffle(self.order)
        elif traffic["order"] != "sequential":
            raise ValueError(f"unknown order {traffic['order']!r}")
        inv = traffic["invalid"]
        if inv["kind"] != INVALID_KIND[kind]:
            raise ValueError(f"a {kind} pool's invalid variant is {INVALID_KIND[kind]!r}")
        self.every = int(inv["every"])
        self.offset = int(inv["offset"])

    # -- units -------------------------------------------------------------

    def invalid(self, k: int) -> bool:
        return k % self.every == self.offset

    def unit(self, k: int, force_invalid: bool = False):
        """(item index, invalid, [sets of each call]) of unit k."""
        idx = self.order[k % len(self.order)]
        bad = force_invalid or self.invalid(k)
        sets = (self.bad_items if bad else self.items)[idx]
        out = []
        for call in self.calls:
            if call["sets"] == "all":
                out.append(sets)
            elif call["sets"] == "first":
                out.append(sets[:1])
            else:
                raise ValueError(f"unknown call sets {call['sets']!r}")
        return idx, bad, out

    # -- pools -------------------------------------------------------------

    def _domain(self, key: str) -> bytes:
        c = self.config
        return roots.compute_domain(_hex(c[key]), _hex(c["fork_version"]),
                                    _hex(c["genesis_validators_root"]))

    def _att_root(self, slot: int, index: int) -> bytes:
        spe = self.config["preset"]["SLOTS_PER_EPOCH"]
        epoch = slot // spe
        data = roots.attestation_data_root(
            slot, index, self.s.digest("head", slot),
            (epoch - 1, self.s.digest("checkpoint", epoch - 1)),
            (epoch, self.s.digest("checkpoint", epoch)))
        return roots.signing_root(data, self._domain("domain_beacon_attester"))

    def _committee_attestations(self):
        c = self.config
        committees, members = c["committees_per_slot"], c["committee_members"]
        if self.traffic["roots"] != committees:
            raise ValueError("the traffic's roots are the configuration's committees")
        slot = c["slot"]
        validators = self.s.rng("validators").sample(range(c["active_validators"]),
                                                     committees * members)
        sks = [self.s.scalar("validator", v) for v in validators]
        pks = signer.pubkeys(sks, self.threads)
        att_roots = [self._att_root(slot, i) for i in range(committees)]
        jobs = [(sks[i * members + j], att_roots[i])
                for i in range(committees) for j in range(members)]
        sigs = signer.signatures(jobs, self.threads)
        items, bad = [], []
        for i in range(committees):
            for j in range(members):
                n = i * members + j
                other = i * members + (j + 1) % members
                items.append([(pks[n], att_roots[i], sigs[n])])
                bad.append([(pks[n], att_roots[i], sigs[other])])
        return items, bad, pks

    def _blocks(self):
        c = self.config
        spe = c["preset"]["SLOTS_PER_EPOCH"]
        committees = c["committees_per_slot"]
        n_agg, agg_slots = c["aggregates_per_block"], c["aggregate_slots"]
        if n_agg != committees * agg_slots:
            raise ValueError("aggregates_per_block is one per committee of aggregate_slots slots")
        d_prop, d_randao = self._domain("domain_beacon_proposer"), self._domain("domain_randao")
        d_sync = self._domain("domain_sync_committee")
        lo, hi = self.traffic["invalid"].get("set_range", (2, 2 + n_agg))
        if not 2 <= lo < hi <= 2 + n_agg:
            raise ValueError(f"invalid.set_range [{lo}, {hi}) is not within the aggregates' "
                             f"sets [2, {2 + n_agg})")
        pick = self.s.rng("proposers")
        plans, keys, jobs = [], [], []  # per block: [(scalar, root)] and its bad aggregate
        for b in range(c["distinct_blocks"]):
            slot = c["slot"] + b
            proposer = pick.randrange(c["active_validators"])
            sk = self.s.scalar("validator", proposer)
            parent = self.s.digest("head", slot - 1)
            header = roots.block_header_root(slot, proposer, parent, self.s.digest("state", slot),
                                             self.s.digest("body", slot))
            plan = [(sk, roots.signing_root(header, d_prop)),
                    (sk, roots.signing_root(roots.epoch_root(slot // spe), d_randao))]
            agg_roots = [self._att_root(slot - 1 - t, i)
                         for t in range(agg_slots) for i in range(committees)]
            for a, root in enumerate(agg_roots):
                plan.append((self.s.scalar("aggregate", b, a), root))
            plan.append((self.s.scalar("sync", b), roots.signing_root(parent, d_sync)))
            pos = self.s.rng("bad_aggregate", b).randrange(lo - 2, hi - 2)
            wrong = agg_roots[(pos // committees) * committees + (pos + 1) % committees]
            bad_job = (plan[2 + pos][0], wrong)
            plans.append((plan, pos))
            keys.append(sk)
            jobs.extend(plan)
            jobs.append(bad_job)
        scalars = [j[0] for j in jobs]
        unique = list(dict.fromkeys(scalars))
        pk_of = dict(zip(unique, signer.pubkeys(unique, self.threads)))
        sigs = signer.signatures(jobs, self.threads)
        items, bad, n = [], [], 0
        for plan, pos in plans:
            sets = [(pk_of[sk], root, sigs[n + i]) for i, (sk, root) in enumerate(plan)]
            n += len(plan)
            bad_set = (sets[2 + pos][0], sets[2 + pos][1], sigs[n])
            n += 1
            items.append(sets)
            bad.append(sets[:2 + pos] + [bad_set] + sets[3 + pos:])
        return items, bad, [pk_of[k] for k in keys]
