"""Cells cut to a size a CPU test run holds, or at their own size, and a
stack of stand-ins."""

import time

from bm import harness, standins, traffic


def small_cell(name: str) -> harness.Cell:
    """The cell with its configuration and traffic shrunk: 8 committees of
    4 members (32 sets, 1 in 32 invalid, 8 callers) or 8 blocks of 11 sets,
    the invalid aggregate in the later half of the import's sets."""
    cell = harness.Cell(name)
    if cell.traffic["pool"] == "committee_attestations":
        cell.config = dict(cell.config, committees_per_slot=8, committee_members=4)
        cell.traffic = dict(cell.traffic, pool_size=32, roots=8, callers=8,
                            invalid=dict(cell.traffic["invalid"], every=32, offset=13),
                            warmup={"units": 8, "with_invalid": True})
    else:
        cell.config = dict(cell.config, committees_per_slot=4, aggregates_per_block=8)
        cell.traffic = dict(cell.traffic,
                            invalid=dict(cell.traffic["invalid"], set_range=[6, 10]))
    return cell


class StackOf:
    """A stack factory over the run's own pool: `make(mix)` gives the stack."""

    def __init__(self, make):
        self.make, self.mix = make, None

    def __call__(self):
        return self.make(self.mix)


def run_small(monkeypatch, name: str, seed: int, seconds: float, make,
              full: bool = False) -> dict:
    """The result of one run of the small cell (with `full`, of the cell at
    its own size) with `make(mix)` as its stack."""
    factory = StackOf(make)
    real_mix = traffic.Mix

    def mix_hook(*a, **k):
        factory.mix = real_mix(*a, **k)
        return factory.mix

    monkeypatch.setattr(harness.traffic, "Mix", mix_hook)
    cell = harness.Cell(name) if full else small_cell(name)
    run = harness.Run(cell, seed, seconds, False, time.perf_counter(),
                      stack_factory=factory, log=lambda msg: None, ref_workers=2)
    result, _ = run.execute()
    return result


def port_stack(fault=None):
    """The port's lanes and supervisor over a table device with `fault`."""
    def make(mix):
        valid = {s for item in mix.items for s in item}
        return standins.PortStack(standins.TableDevice(valid, fault), valid)
    return make
