"""Spec presets, constants, and fork names (layer L0).

The port's copy of `lodestar_tpu/params` (the reference package
`@lodestar/params`, packages/params). The active preset is ``mainnet``;
no environment variable is read. Call :func:`set_active_preset` to change
the default, or pass a preset explicitly (every consensus object takes its
preset from its `BeaconConfig`).
"""

from __future__ import annotations

from .constants import *  # noqa: F401,F403
from .fork_name import EXECUTION_FORKS, FORK_ORDER, ForkName, ForkSeq, fork_seq  # noqa: F401
from .presets import MAINNET, MINIMAL, PRESETS, Preset  # noqa: F401

ACTIVE_PRESET: Preset = MAINNET


def set_active_preset(name_or_preset: str | Preset) -> Preset:
    """Override the process-default preset (call before building any state).

    Mirrors `setActivePreset` in the reference (params/src/setPreset.ts); unlike
    the reference we do not hard-fail on late calls because all consensus code
    receives its preset through the BeaconConfig object rather than via module
    globals — this only changes the *default*.
    """
    global ACTIVE_PRESET
    preset = PRESETS[name_or_preset] if isinstance(name_or_preset, str) else name_or_preset
    ACTIVE_PRESET = preset
    return preset
