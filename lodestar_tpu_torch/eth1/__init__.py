"""Eth1 deposit tracking and eth1-data voting (the port's copy of
`lodestar_tpu/eth1`).

Reference: `eth1/` — deposit-contract follower (`provider/eth1Provider.ts`
JSON-RPC, `provider.py`), `eth1DepositsCache` / `eth1DataCache`, eth1-data
vote picking (the spec's majority rule), deposit-root tracking, and the
terminal PoW block tracker of the merge (`merge_tracker.py`). The dev
path uses `Eth1ProviderMock`, as the reference's injects deposits.
"""

from .deposit_tracker import Eth1DepositTracker, Eth1ProviderMock  # noqa: F401
