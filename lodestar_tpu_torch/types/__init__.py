"""Per-fork SSZ types (layer L1) — equivalent of @lodestar/types.

``get_types(preset)`` builds (and caches) the full namespace of container
classes for every fork, e.g.::

    t = get_types(MAINNET)
    block = t.phase0.SignedBeaconBlock(...)
    t.capella.BeaconState.deserialize(data)

``ssz`` is the namespace for the process-default preset (reference exposes a
module-level ``ssz`` object: types/src/index.ts).
"""

from __future__ import annotations

from types import SimpleNamespace

from .. import params as _params
from ..params import ForkName
from ..params.presets import Preset
from . import altair as _altair
from . import bellatrix as _bellatrix
from . import capella as _capella
from . import phase0 as _phase0

_cache: dict[int, SimpleNamespace] = {}


def get_types(preset: Preset | None = None) -> SimpleNamespace:
    # Read the active preset at call time so set_active_preset() is honored.
    preset = preset or _params.ACTIVE_PRESET
    key = id(preset)
    cached = _cache.get(key)
    if cached is not None:
        return cached

    phase0 = _phase0.make_types(preset)
    altair = _altair.make_types(preset, phase0)
    bellatrix = _bellatrix.make_types(preset, phase0, altair)
    capella = _capella.make_types(preset, phase0, altair, bellatrix)
    namespace = SimpleNamespace(
        preset=preset,
        phase0=phase0,
        altair=altair,
        bellatrix=bellatrix,
        capella=capella,
        by_fork={
            ForkName.phase0: phase0,
            ForkName.altair: altair,
            ForkName.bellatrix: bellatrix,
            ForkName.capella: capella,
        },
    )
    _cache[key] = namespace
    return namespace


def __getattr__(name: str):
    # Lazy default-preset namespace (reference: `ssz` export of
    # @lodestar/types) — resolved on first access so late
    # set_active_preset() calls are honored and import stays cheap.
    if name == "ssz":
        return get_types()
    raise AttributeError(name)
