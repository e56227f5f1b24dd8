"""Runtime config (layer L1) — equivalent of @lodestar/config."""

from .beacon_config import (  # noqa: F401
    BeaconConfig,
    ChainForkConfig,
    compute_domain,
    compute_fork_data_root,
    compute_fork_digest,
    compute_signing_root,
    create_beacon_config,
    create_chain_fork_config,
    get_network_config,
)
from .chain_config import (  # noqa: F401
    MAINNET_CHAIN_CONFIG,
    MINIMAL_CHAIN_CONFIG,
    NETWORK_CONFIGS,
    ChainConfig,
)
from .fork_config import ForkConfig, ForkInfo  # noqa: F401
