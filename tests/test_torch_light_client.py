"""The port's light client (`light_client/client.py`, `rest_follow.py`,
the `lightclient` command) against the JAX package's, on one chain: the
JAX light-client tests' fixture (the minimal preset, 16 interop
validators, Altair from genesis, 3 epochs of blocks with the previous
slot's aggregates and full sync aggregates), made once by the port's
`profile_block.light_client_chain` and imported into a port
`BeaconChain` (its signatures checked on the host tier) and a JAX one
(as the JAX fixture imports, without them). The two servers' updates are
byte-equal, the two clients fed the same updates end equal, and both
refuse the same tampered inputs with the same message."""

import logging
import signal
import threading
import time

import pytest

from lodestar_tpu.chain import BeaconChain as JBeaconChain
from lodestar_tpu.config.beacon_config import BeaconConfig as JBeaconConfig
from lodestar_tpu.config.beacon_config import ChainForkConfig as JChainForkConfig
from lodestar_tpu.config.chain_config import MINIMAL_CHAIN_CONFIG as J_MINIMAL_CC
from lodestar_tpu.light_client import Lightclient as JLightclient
from lodestar_tpu.light_client import LightClientError as JLightClientError
from lodestar_tpu.params.presets import MINIMAL as JMINIMAL
from lodestar_tpu.state_transition import interop_genesis_state as j_interop_genesis
from lodestar_tpu.state_transition.altair import upgrade_state_to_altair as j_upgrade
from lodestar_tpu.types import get_types as jget_types
from lodestar_tpu_torch.bls import api as bls
from lodestar_tpu_torch.chain import BeaconChain
from lodestar_tpu_torch.chain.bls_verifier import CpuBlsVerifier
from lodestar_tpu_torch.convert import ssz_to_jax
from lodestar_tpu_torch.light_client import Lightclient, LightClientError
from lodestar_tpu_torch.params.presets import MINIMAL
from lodestar_tpu_torch.profile_block import GENESIS_TIME, light_client_chain
from lodestar_tpu_torch.types import get_types

N = 16
SPE = MINIMAL.SLOTS_PER_EPOCH


@pytest.fixture(scope="module")
def chains():
    config, genesis, blocks = light_client_chain(N, 3 * SPE, threads=2)
    types = get_types(MINIMAL).altair
    chain = BeaconChain(config, types, genesis.copy(), verifier=CpuBlsVerifier())

    jt = jget_types(JMINIMAL)
    jpre = j_interop_genesis(JChainForkConfig(J_MINIMAL_CC, JMINIMAL), jt.phase0, N,
                             genesis_time=GENESIS_TIME)
    jconfig = JBeaconConfig(J_MINIMAL_CC, bytes(jpre.genesis_validators_root), JMINIMAL)
    jstate = j_upgrade(jconfig, JMINIMAL, jpre, jt.altair)
    assert jstate.hash_tree_root() == genesis.hash_tree_root()
    jchain = JBeaconChain(jconfig, jt.altair, jstate)
    for signed in blocks:
        slot = int(signed.message.slot)
        chain.clock.set_slot(slot)
        chain.process_block(signed)
        jchain.clock.set_slot(slot)
        jchain.process_block(ssz_to_jax(signed, jt.altair.SignedBeaconBlock),
                             verify_signatures=False)
    assert jchain.head_root == chain.head_root
    roots = [b.message.hash_tree_root() for b in blocks]
    yield config, types, chain, jconfig, jt.altair, jchain, roots
    chain.close()


def _bytes(x):
    return None if x is None else x.serialize()


def test_server_produces_updates_and_bootstrap(chains):
    config, types, chain, jconfig, jtypes, jchain, roots = chains
    server, jserver = chain.light_client_server, jchain.light_client_server
    assert server.best_update_by_period
    assert sorted(server.best_update_by_period) == sorted(jserver.best_update_by_period)
    for period, update in server.best_update_by_period.items():
        assert update.serialize() == jserver.best_update_by_period[period].serialize()
    assert server.latest_optimistic_update is not None
    assert _bytes(server.latest_optimistic_update) == _bytes(jserver.latest_optimistic_update)
    assert _bytes(getattr(server, "latest_finality_update", None)) == \
        _bytes(getattr(jserver, "latest_finality_update", None))
    for root in (roots[0], roots[SPE], roots[-2]):
        boot = server.get_bootstrap(root)
        assert boot is not None and len(boot.current_sync_committee_branch) == 5
        assert boot.serialize() == jserver.get_bootstrap(root).serialize()


def _state(client):
    return (client.finalized_header.serialize(), client.optimistic_header.serialize(),
            _bytes(client.current_sync_committee), _bytes(client.next_sync_committee))


def test_client_follows_chain(chains):
    config, types, chain, jconfig, jtypes, jchain, roots = chains
    server, jserver = chain.light_client_server, jchain.light_client_server
    client, jclient = Lightclient(config, types, MINIMAL), JLightclient(jconfig, jtypes, JMINIMAL)
    client.bootstrap(roots[0], server.get_bootstrap(roots[0]))
    jclient.bootstrap(roots[0], jserver.get_bootstrap(roots[0]))
    assert client.finalized_header.slot == 1 and _state(client) == _state(jclient)
    for period in sorted(server.best_update_by_period):
        client.process_update(server.best_update_by_period[period])
        jclient.process_update(jserver.best_update_by_period[period])
    assert client.optimistic_header.slot > 1 and _state(client) == _state(jclient)
    client.process_optimistic_update(server.latest_optimistic_update)
    jclient.process_optimistic_update(jserver.latest_optimistic_update)
    assert client.optimistic_header.slot == 3 * SPE - 1  # the head's parent
    assert _state(client) == _state(jclient)


def _refusal(fn, error):
    with pytest.raises(error) as e:
        fn()
    return str(e.value)


def test_client_rejects_tampered_proofs(chains):
    config, types, chain, jconfig, jtypes, jchain, roots = chains
    server = chain.light_client_server
    client, jclient = Lightclient(config, types, MINIMAL), JLightclient(jconfig, jtypes, JMINIMAL)
    trusted = roots[0]
    boot = server.get_bootstrap(trusted)

    bad_boot = types.LightClientBootstrap.deserialize(boot.serialize())
    bad_boot.current_sync_committee.pubkeys[0] = bls.interop_secret_key(77).to_public_key() \
        .to_bytes()
    assert _refusal(lambda: client.bootstrap(trusted, bad_boot), LightClientError) == _refusal(
        lambda: jclient.bootstrap(trusted, ssz_to_jax(bad_boot, jtypes.LightClientBootstrap)),
        JLightClientError) == "invalid current sync committee proof"

    client.bootstrap(trusted, boot)
    jclient.bootstrap(trusted, ssz_to_jax(boot, jtypes.LightClientBootstrap))
    update = server.best_update_by_period[min(server.best_update_by_period)]

    bad = types.LightClientUpdate.deserialize(update.serialize())
    bad.next_sync_committee_branch = [b"\x00" * 32] * 5
    bad2 = types.LightClientUpdate.deserialize(update.serialize())
    bad2.sync_aggregate.sync_committee_signature = bls.interop_secret_key(7).sign(b"x") \
        .to_bytes()
    for tampered, message in ((bad, "invalid next sync committee proof"),
                              (bad2, "bad sync signature")):
        assert _refusal(lambda: client.process_update(tampered), LightClientError) == _refusal(
            lambda: jclient.process_update(ssz_to_jax(tampered, jtypes.LightClientUpdate)),
            JLightClientError) == message
    assert _state(client) == _state(jclient)


def test_rest_follower_bootstraps_and_streams(chains):
    """`RestLightclientFollower` over the port's Beacon API: bootstrap and
    the period catch-up over REST, then one optimistic update over SSE."""
    from lodestar_tpu_torch.api import BeaconApiServer
    from lodestar_tpu_torch.api.client import BeaconApiClient
    from lodestar_tpu_torch.api.impl import BeaconApiImpl
    from lodestar_tpu_torch.chain.emitter import ChainEvent
    from lodestar_tpu_torch.light_client.rest_follow import RestLightclientFollower

    config, types, chain, *_, roots = chains
    rest = BeaconApiServer(BeaconApiImpl(config, types, chain), port=0)
    rest.start()
    try:
        api = BeaconApiClient("127.0.0.1", rest.port)
        follower = RestLightclientFollower(config, types, MINIMAL, api, "127.0.0.1", rest.port)
        follower.start(roots[0])
        assert follower.lc.finalized_header.slot == 1
        assert follower.lc.optimistic_header.slot > 1
        done = {}
        t = threading.Thread(target=lambda: done.update(
            applied=follower.follow(max_events=1, timeout=10)), daemon=True)
        t.start()
        time.sleep(0.3)
        chain.emitter.emit(ChainEvent.lightclient_optimistic_update,
                           chain.light_client_server.latest_optimistic_update.to_obj())
        t.join(timeout=15)
        assert done.get("applied") == 1
        assert follower.lc.optimistic_header.slot == 3 * SPE - 1
    finally:
        rest.close()


def test_client_processes_finality_update(chains):
    config, types, chain, jconfig, jtypes, jchain, roots = chains
    server, jserver = chain.light_client_server, jchain.light_client_server
    fin = getattr(server, "latest_finality_update", None)
    jfin = getattr(jserver, "latest_finality_update", None)
    assert _bytes(fin) == _bytes(jfin)
    if fin is None:
        best = server.best_update_by_period[max(server.best_update_by_period)]
        if not any(bytes(b) != b"\x00" * 32 for b in best.finality_branch):
            pytest.skip("fixture chain has no finalized checkpoint yet")
        fin = types.LightClientFinalityUpdate(
            attested_header=best.attested_header.copy(),
            finalized_header=best.finalized_header.copy(),
            finality_branch=[bytes(b) for b in best.finality_branch],
            sync_aggregate=best.sync_aggregate.copy(),
            signature_slot=best.signature_slot,
        )
    jfin = ssz_to_jax(fin, jtypes.LightClientFinalityUpdate)
    clients = []
    for lc, srv, upd in ((Lightclient(config, types, MINIMAL), server, fin),
                         (JLightclient(jconfig, jtypes, JMINIMAL), jserver, jfin)):
        lc.bootstrap(roots[0], srv.get_bootstrap(roots[0]))
        before = int(lc.finalized_header.slot)
        lc.process_finality_update(upd)
        assert int(lc.finalized_header.slot) >= before
        clients.append(lc)
    assert _state(clients[0]) == _state(clients[1])
    bad = types.LightClientFinalityUpdate.deserialize(fin.serialize())
    bad.finalized_header.state_root = b"\xff" * 32
    client2 = Lightclient(config, types, MINIMAL)
    client2.bootstrap(roots[0], server.get_bootstrap(roots[0]))
    jclient2 = JLightclient(jconfig, jtypes, JMINIMAL)
    jclient2.bootstrap(roots[0], jserver.get_bootstrap(roots[0]))
    if int(bad.finalized_header.slot) > int(client2.finalized_header.slot):
        assert _refusal(lambda: client2.process_finality_update(bad), LightClientError) == \
            _refusal(lambda: jclient2.process_finality_update(
                ssz_to_jax(bad, jtypes.LightClientFinalityUpdate)), JLightClientError)


def test_lightclient_command_follows_a_node(chains, caplog):
    """`lightclient --run-seconds` against an in-process Beacon API: it
    bootstraps from block 1, applies the period's update and logs the
    optimistic slot the JAX client reaches on the same update."""
    from lodestar_tpu_torch.api import BeaconApiServer
    from lodestar_tpu_torch.api.impl import BeaconApiImpl
    from lodestar_tpu_torch.cli.__main__ import main

    config, types, chain, jconfig, jtypes, jchain, roots = chains
    jclient = JLightclient(jconfig, jtypes, JMINIMAL)
    jclient.bootstrap(roots[0], jchain.light_client_server.get_bootstrap(roots[0]))
    for period in sorted(jchain.light_client_server.best_update_by_period):
        jclient.process_update(jchain.light_client_server.best_update_by_period[period])
    rest = BeaconApiServer(BeaconApiImpl(config, types, chain), port=0)
    rest.start()
    handler = signal.getsignal(signal.SIGINT)
    try:
        with caplog.at_level(logging.INFO, logger="lodestar_tpu_torch"):
            rc = main(["lightclient", "--beacon-url", f"127.0.0.1:{rest.port}",
                       "--trusted-block-root", "0x" + roots[0].hex(), "--run-seconds", "1",
                       "--poll-seconds", "0.2"])
    finally:
        signal.signal(signal.SIGINT, handler)
        rest.close()
    assert rc == 0
    lines = [r.getMessage() for r in caplog.records if r.name.endswith("lightclient-cli")]
    assert lines[0] == "bootstrapped at slot 1"
    assert f"optimistic slot {int(jclient.optimistic_header.slot)}  finalized slot " \
        f"{int(jclient.finalized_header.slot)}" in lines[-1]
