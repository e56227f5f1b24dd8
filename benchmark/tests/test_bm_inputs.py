"""The generator: the same seed gives the same inputs, and the invalid
units fall where the traffic file puts them."""

import json

import pytest

from bm import paths, traffic


def _mix(name, seed):
    cell = json.load(open(paths.traffic_file(name)))
    cfg_name = {"att-committees-64": "mainnet-allsubnets", "blocks-full-131": "mainnet-node"}[name]
    cfg = json.load(open(paths.config_file(cfg_name)))
    if cell["pool"] == "committee_attestations":
        cfg = dict(cfg, committees_per_slot=8, committee_members=4)
        cell = dict(cell, pool_size=32, roots=8)
    else:
        cfg = dict(cfg, committees_per_slot=4, aggregates_per_block=8)
        cell = dict(cell, invalid=dict(cell["invalid"], set_range=[6, 10]))
    return traffic.Mix(cfg, cell, seed, threads=2)


@pytest.mark.parametrize("name", ["att-committees-64", "blocks-full-131"])
def test_same_seed_same_inputs(name):
    a, b = _mix(name, 2**31 + 11), _mix(name, 2**31 + 11)
    assert a.items == b.items and a.bad_items == b.bad_items
    assert a.order == b.order and a.table_keys == b.table_keys
    c = _mix(name, 2**31 + 12)
    assert c.items != a.items
    assert [len(i) for i in c.items] == [len(i) for i in a.items]


def test_attestation_invalid_units():
    m = _mix("att-committees-64", 7)
    assert m.offset == 104 and m.every == 256  # fixed by the traffic file
    for k in range(600):
        idx, bad, calls = m.unit(k)
        assert bad == (k % 256 == m.offset)
        assert len(calls) == 1 and len(calls[0]) == 1
        pk, root, sig = calls[0][0]
        good = m.items[idx][0]
        assert (pk, root) == good[:2]
        assert (sig != good[2]) == bad
    assert {m.unit(k)[0] for k in range(32)} == set(range(32))  # the pool, shuffled


def test_block_invalid_units():
    m = _mix("blocks-full-131", 7)
    assert m.offset == 3 and m.every == 8
    sizes = [len(i) for i in m.items]
    assert sizes == [1 + 1 + 8 + 1] * 8
    for k in range(24):
        idx, bad, calls = m.unit(k)
        assert idx == k % 8 and bad == (idx == m.offset)
        assert [len(c) for c in calls] == [1, 11]
        assert calls[0][0] == m.items[idx][0]  # the gossip check is always valid
    diff = [i for i, (a, b) in enumerate(zip(m.items[m.offset], m.bad_items[m.offset])) if a != b]
    assert len(diff) == 1 and 6 <= diff[0] < 10  # one aggregate, in the range given
    a, b = m.items[m.offset][diff[0]], m.bad_items[m.offset][diff[0]]
    assert a[:2] == b[:2] and a[2] != b[2]


def test_full_sizes_from_files():
    """The committed files make the published shapes (without signing)."""
    att = json.load(open(paths.config_file("mainnet-allsubnets")))
    assert att["committees_per_slot"] * att["committee_members"] == 4096
    node = json.load(open(paths.config_file("mainnet-node")))
    assert node["aggregates_per_block"] == node["preset"]["MAX_ATTESTATIONS"] == 128
    assert 2 + node["aggregates_per_block"] + 1 == 131


@pytest.mark.parametrize("seed", [2**31 + 13, 3_000_000_017])
def test_block_invalid_aggregate_in_the_first_jobs_later_half(seed):
    """At the cell's own size the bad aggregate lies in sets 64..127 of the
    import: the later half of the facade's first 128-set job."""
    cell = json.load(open(paths.traffic_file("blocks-full-131")))
    cfg = json.load(open(paths.config_file("mainnet-node")))
    m = traffic.Mix(cfg, cell, seed, threads=2)
    good, bad = m.items[m.offset], m.bad_items[m.offset]
    diff = [i for i, (a, b) in enumerate(zip(good, bad)) if a != b]
    assert len(good) == 131 and len(diff) == 1 and 64 <= diff[0] < 128


def test_set_range_outside_the_aggregates_is_refused():
    with pytest.raises(ValueError):
        cell = json.load(open(paths.traffic_file("blocks-full-131")))
        cell = dict(cell, invalid=dict(cell["invalid"], set_range=[1, 10]))
        cfg = json.load(open(paths.config_file("mainnet-node")))
        traffic.Mix(dict(cfg, committees_per_slot=4, aggregates_per_block=8), cell, 1, threads=1)
