"""Mesh-sharded batch verification (the JAX package's
`parallel/sharded.py`), over the worker processes of `parallel/mesh_pool.py`.

Where the JAX package shards ONE batch across the chips of a
`jax.sharding.Mesh` with `shard_map`, the port runs the same per-chip
bodies in one worker process per GPU, each on its row slice of the
batch:

- every worker runs the MSMs, scalar multiplications and Miller lanes of
  its slice (pure data parallelism: no communication),
- the signature bit-plane sums are combined with one all_gather of 64
  projective G2 points per worker, the Fp12 pair-products are gathered
  on the first worker, and the tail (the cross-worker product, one final
  exponentiation, the plane subgroup check) runs there only: the JAX
  package's "chip 0 owns the tail",
- a collective is `torch.distributed` over the workers' gloo group on
  host tensors: a worker copies its partial to the host before it and
  uploads what it received,
- over a two-level pool (hosts × chips per host, the JAX `(dcn, ici)`
  mesh) every combine runs within each host first: one Fp12 per host
  and one set of 64 combined plane sums per host and chip position cross
  hosts (the bisection's leaves cross whole, as in the JAX twin).

Each verdict function here runs on every worker, in the same order of
collectives, and returns the verdict on the first worker and None on the
others. The `Sharded*Verifier` classes are the host wrappers of the JAX
package, bound to a chip set: their `submit` scatters a marshalled batch
over the pool of that set and returns the first worker's reply.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..observability.trace import device_stage, observing
from ..ops import fp, fp2, fp12, msm
from ..ops.g2_decompress import decompress as _g2_decompress
from ..ops.g2_decompress import planes_in_subgroup as _planes_in_subgroup
from ..ops.pairing import final_exponentiation_one, miller_loop_proj_pq
from ..ops.points import G1_GEN_X, G1_GEN_Y, NEG_G1_POW2_X, NEG_G1_POW2_Y, g1, g2, g2_psi
from .mesh import CONSTANT_LANES
from .mesh_pool import CollectiveError, PoolSlot

HALF_BITS = 32  # the a/b halves of the r = a + z·b split (parallel/verifier)
N_LIMBS = 32

__all__ = [
    "Shard",
    "ShardedBisectVerifier",
    "ShardedBlsVerifier",
    "ShardedGroupedRawVerifier",
    "ShardedGroupedVerifier",
    "ShardedPkGroupedRawVerifier",
    "ShardedPkGroupedVerifier",
    "VERIFIERS",
    "local_parts",
    "run_shard",
]


def _collective(fn, *args, **kwargs) -> None:
    """Run a collective of the workers' group; its failure (a peer that
    hung or died) raises `CollectiveError`, which the pool blames on the
    peer."""
    try:
        fn(*args, **kwargs)
    except RuntimeError as e:
        raise CollectiveError(str(e)) from e


class Shard:
    """One worker's place in the pool: its index (0 owns the tail), the
    pool's size, the workers' process group and the worker's device.

    A two-level pool (`hosts` > 1, `per` = size / hosts workers per host)
    places worker `index` on host index // per at position index % per
    (DCN-major, the JAX `_mesh_index`) and gives it two more groups: `ici`,
    its host's workers, and `dcn`, the workers at its position on every
    host. One host: `ici` is the whole group and there is no `dcn`. The
    collectives stage their payloads through the host."""

    def __init__(self, index: int, size: int, group, device, hosts: int = 1,
                 ici=None, dcn=None):
        self.index = index
        self.size = size
        self.group = group
        self.device = torch.device(device)
        self.hosts = hosts
        self.per = size // hosts
        self.host, self.local = divmod(index, self.per)
        self.ici = group if hosts == 1 else ici
        self.dcn = dcn

    @classmethod
    def join(cls, index: int, size: int, hosts: int, device, timeout) -> Shard:
        """This worker's shard of the initialised default group. Every
        worker creates every host's group and every position's group, in
        the same order (a group's creation is collective over all)."""
        world = dist.group.WORLD
        if hosts == 1:
            return cls(index, size, world, device)
        per = size // hosts
        ici = [dist.new_group(list(range(h * per, (h + 1) * per)), timeout=timeout)
               for h in range(hosts)]
        dcn = [dist.new_group([h * per + j for h in range(hosts)], timeout=timeout)
               for j in range(per)]
        host, local = divmod(index, per)
        return cls(index, size, world, device, hosts, ici[host], dcn[local])

    def _all_gather(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        h = t.detach().cpu().contiguous()
        out = [torch.empty_like(h) for _ in range(n)]
        _collective(dist.all_gather, out, h, group=group)
        return torch.stack(out).to(self.device)

    def _gather(self, t: torch.Tensor, group, n: int, root: int, at_root: bool):
        """(n, *t.shape) on the group's member `root` (a global rank),
        None on the others."""
        h = t.detach().cpu().contiguous()
        out = [torch.empty_like(h) for _ in range(n)] if at_root else None
        _collective(dist.gather, h, gather_list=out, dst=root, group=group)
        return None if out is None else torch.stack(out).to(self.device)

    def all_gather_in_host(self, t: torch.Tensor) -> torch.Tensor:
        """(per, *t.shape): the host's workers' `t`, on each of them."""
        return self._all_gather(t, self.ici, self.per)

    def gather_in_host(self, t: torch.Tensor):
        """(per, *t.shape): the host's workers' `t` on its first worker,
        None on the others."""
        return self._gather(t, self.ici, self.per, self.host * self.per, self.local == 0)

    def gather_across_hosts(self, t: torch.Tensor):
        """(hosts, *t.shape): the hosts' first workers' `t` on worker 0,
        None on the others; only first workers call it."""
        return self._gather(t, self.dcn, self.hosts, 0, self.index == 0)

    def gather_to_root(self, t: torch.Tensor):
        """(size, *t.shape) on worker 0, in worker order, None on the
        others: within each host first, then across hosts."""
        part = self.gather_in_host(t)
        if self.hosts == 1 or part is None:
            return part
        out = self.gather_across_hosts(part)
        return None if out is None else out.reshape((self.size,) + tuple(t.shape))

    def combine(self, t: torch.Tensor, reduce):
        """`reduce` over axis 0 of every worker's `t`, on every worker:
        an all_gather and `reduce` within the host, then across hosts."""
        out = reduce(self.all_gather_in_host(t))
        if self.hosts > 1:
            out = reduce(self._all_gather(out, self.dcn, self.hosts))
        return out

    def any(self, flag: torch.Tensor) -> bool:
        """True when `flag` is set on any worker (an all-reduce of max)."""
        h = flag.detach().to(torch.int32).cpu().reshape(1)
        _collective(dist.all_reduce, h, op=dist.ReduceOp.MAX, group=self.group)
        return bool(h[0])


def _g2_sum_tree(ps):
    """log2-depth complete-add reduction of G2 projective points over axis
    0 (the JAX package's `parallel/verifier._g2_sum_tree`)."""
    x, y, z = ps
    n = x.shape[0]
    while n > 1:
        half = n // 2
        a = (x[:half], y[:half], z[:half])
        b = (x[half:2 * half], y[half:2 * half], z[half:2 * half])
        hx, hy, hz = g2.add(a, b)
        if n % 2 != 0:
            hx = torch.cat([hx, x[2 * half:]], 0)
            hy = torch.cat([hy, y[2 * half:]], 0)
            hz = torch.cat([hz, z[2 * half:]], 0)
        x, y, z = hx, hy, hz
        n = x.shape[0]
    return x[0], y[0], z[0]


def _gather_fp12_partials(f_loc, shard: Shard):
    """The workers' Fp12 pair-product partials on worker 0 for the tail,
    None elsewhere: (size, 2, 3, 2, 32) on one host; on several, each
    host's product first (`fp12.product_tree` on its first worker), so
    one Fp12 per host crosses hosts: (hosts, 2, 3, 2, 32)."""
    if shard.hosts == 1:
        return shard.gather_to_root(f_loc)
    f_host = shard.gather_in_host(f_loc)
    if f_host is None:
        return None
    return shard.gather_across_hosts(fp12.product_tree(f_host))


def _plane_tree_sum(u_all):
    """(n, 3, 64, 2, 32) stacked plane sums → their (3, 64, 2, 32) sum."""
    return torch.stack(msm.tree_sum(g2, tuple(torch.movedim(u_all[:, i], 0, 1)
                                              for i in range(3))))


def _combine_plane_sums(u_part, shard: Shard):
    """Combine each worker's 64 partial G2 bit-plane sums into the (64,)
    totals every worker holds: an all_gather of the three coordinates and
    a tree sum within the host, then the same across hosts, so one set of
    64 sums per host crosses hosts."""
    return tuple(shard.combine(torch.stack(u_part), _plane_tree_sum))


def _tail_on_root(shard: Shard, tail_fn):
    """Run the sequential tail on the first worker only: its verdict as a
    bool there, None on the others (the controller reads the first
    worker's reply)."""
    if shard.index != 0:
        return None
    return bool(tail_fn())


# --- flat tier --------------------------------------------------------------


def _local_body(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid):
    """One worker's slice of the flat batch equation: (local Fp12 pair
    product, local G2 signature sum r_i·sig_i), the two values that cross
    between workers. The Miller lanes run K2p at Zq = 1."""
    n_loc = pk_x.shape[0]
    dev = pk_x.device
    rpk = g1.scalar_mul_bits(r_bits, (pk_x, pk_y))
    rsig = g2.scalar_mul_bits(r_bits, (sig_x, sig_y))
    rsig = g2.select(valid, rsig, g2.infinity((n_loc,), dev))
    s_part = _g2_sum_tree(rsig)
    fs = miller_loop_proj_pq(rpk, (msg_x, msg_y, fp2.one((n_loc,), dev)))
    fs = fp12.select(valid, fs, fp12.one((n_loc,), dev))
    return fp12.product_tree(fs), s_part


def _sharded_verify(shard: Shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid):
    dev = pk_x.device
    f_loc, s_part = _local_body(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid)
    f_all = _gather_fp12_partials(f_loc, shard)
    s_all = shard.gather_to_root(torch.stack(s_part))  # (n, 3, 2, 32)

    def tail():
        s = _g2_sum_tree(tuple(s_all[:, i] for i in range(3)))
        s_inf = g2.is_infinity(s)
        # e(−g1, S): S stays projective (K2p's lane), equal after the
        # final exponentiation to the JAX package's affine lane
        p = (fp.const(G1_GEN_X, dev)[None], fp.neg(fp.const(G1_GEN_Y, dev))[None],
             fp.one((1,), dev))
        f_tail = miller_loop_proj_pq(p, tuple(c[None] for c in s))[0]
        f_tail = fp12.select(~s_inf, f_tail, fp12.one((), dev))
        f = fp12.mul(fp12.product_tree(f_all), f_tail)
        with device_stage("bls/final_exp_batch"):
            return fp12.is_one(final_exponentiation_one(f))

    return _tail_on_root(shard, tail)


# --- grouped (shared-signing-root) tier ---------------------------------------


def _constant_lanes(shard: Shard, u_planes, dev):
    """This worker's 64/n of the constant lanes (−[2^b]g1, U_b) and
    (−[2^b]g1, ψU'_b), lanes [k·per, (k+1)·per) in plane order."""
    per = CONSTANT_LANES // shard.size
    start = shard.index * per
    u_a = tuple(c[:HALF_BITS] for c in u_planes)
    u_b = g2_psi(tuple(c[HALF_BITS:] for c in u_planes))
    uq_loc = tuple(torch.cat([ca, cb], 0)[start:start + per] for ca, cb in zip(u_a, u_b))
    neg_x = fp.const(NEG_G1_POW2_X, dev)
    neg_y = fp.const(NEG_G1_POW2_Y, dev)
    cx_loc = torch.cat([neg_x, neg_x], 0)[start:start + per]
    cy_loc = torch.cat([neg_y, neg_y], 0)[start:start + per]
    return (cx_loc, cy_loc, fp.one((per,), dev)), uq_loc


def _signature_plane_parts(sig_x, sig_y, bits, valid):
    """The 64 signature bit-plane sums of this worker's slice."""
    dev = sig_x.device
    n_loc = valid.numel()
    sig = (sig_x.reshape((n_loc, 2, N_LIMBS)), sig_y.reshape((n_loc, 2, N_LIMBS)),
           fp2.one((n_loc,), dev))
    sig = g2.select(valid.reshape(n_loc), sig, g2.infinity((n_loc,), dev))
    return msm.masked_plane_sums(g2, sig, bits.reshape(n_loc, 2 * HALF_BITS))


def _signature_planes(shard: Shard, sig_x, sig_y, bits, valid):
    """The signature bit-plane sums of this worker's slice, combined over
    the workers: (64,) projective G2 points."""
    return _combine_plane_sums(_signature_plane_parts(sig_x, sig_y, bits, valid), shard)


def _grouped_local(shard: Shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid):
    """One worker's slice of the GROUPED batch equation.

    The root axis R is sharded: each worker owns R/n rows, their pubkey
    bit-plane MSMs, Horner combines and (A_j, H_j)/(B_j, ψH_j) Miller
    lanes. The signature aggregate's bit-plane sums span the whole batch:
    each worker reduces its slice to 64 partial plane sums, one all_gather
    combines them, and the 64 constant lanes are split 64/n per worker.
    K2p runs 2·r_loc + 64/n lanes.

    Returns (local Fp12 pair product, combined u_planes): the raw twin's
    subgroup check needs the combined plane sums."""
    dev = pk_x.device
    r_loc, lanes = pk_x.shape[0], pk_x.shape[1]
    pk = (pk_x, pk_y, fp.one((r_loc, lanes), dev))
    pk = g1.select(valid, pk, g1.infinity((r_loc, lanes), dev))
    bits = torch.cat([a_bits, b_bits], dim=-1)

    with device_stage("bls/msm_planes"):
        t_planes = msm.masked_plane_sums(g1, pk, bits)  # (64, r_loc)
        tp = tuple(c.reshape((2, HALF_BITS) + tuple(c.shape[1:])) for c in t_planes)
        tp = tuple(torch.movedim(c, 1, 0) for c in tp)
        ab = msm.horner_pow2(g1, tp)  # (2, r_loc)
        a_pt = tuple(c[0] for c in ab)
        b_pt = tuple(c[1] for c in ab)
        u_planes = _signature_planes(shard, sig_x, sig_y, bits, valid)
    (cx, cy, cz), uq = _constant_lanes(shard, u_planes, dev)

    with device_stage("bls/miller_loop"):
        h = (msg_x, msg_y, fp2.one((r_loc,), dev))
        psi_h = g2_psi(h)
        px = torch.cat([a_pt[0], b_pt[0], cx], 0)
        py = torch.cat([a_pt[1], b_pt[1], cy], 0)
        pz = torch.cat([a_pt[2], b_pt[2], cz], 0)
        qx = torch.cat([h[0], psi_h[0], uq[0]], 0)
        qy = torch.cat([h[1], psi_h[1], uq[1]], 0)
        qz = torch.cat([h[2], psi_h[2], uq[2]], 0)
        lane_ok = ~g1.is_infinity((px, py, pz)) & ~g2.is_infinity((qx, qy, qz))
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
        fs = fp12.select(lane_ok, fs, fp12.one((px.shape[0],), dev))
    with device_stage("bls/product_tree"):
        return fp12.product_tree(fs), u_planes


def _final_exp_tail(f_all, u_planes=None):
    """The tail on the first worker: the product of the gathered
    partials, one final exponentiation, and for the raw twins the plane
    subgroup check."""
    def tail():
        with device_stage("bls/final_exp_batch"):
            ok = fp12.is_one(final_exponentiation_one(fp12.product_tree(f_all)))
        if u_planes is None:
            return ok
        with device_stage("bls/plane_subgroup"):
            return ok & _planes_in_subgroup(u_planes)

    return tail


def _sharded_grouped_verify(shard: Shard, *args):
    f_loc, _ = _grouped_local(shard, *args)
    f_all = _gather_fp12_partials(f_loc, shard)
    return _tail_on_root(shard, _final_exp_tail(f_all))


def _sharded_raw(local, shard: Shard, pk_x, pk_y, msg_x, msg_y, sig_raw, a_bits, b_bits, valid):
    """The raw twins: each worker decompresses its own slice of the wire
    bytes; lanes that fail to decode are masked out of the pairing, a
    failed VALID lane on any worker forces the verdict False, and the
    combined plane sums get the subgroup check in the tail."""
    with device_stage("bls/g2_decompress"):
        sig_x, sig_y, dec_ok = _g2_decompress(sig_raw)
        fail_loc = torch.any(valid & ~dec_ok)
    f_loc, u_planes = local(shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits,
                            valid & dec_ok)
    f_all = _gather_fp12_partials(f_loc, shard)
    decode_fail = shard.any(fail_loc)
    verdict = _tail_on_root(shard, _final_exp_tail(f_all, u_planes))
    return None if verdict is None else verdict and not decode_fail


def _sharded_grouped_raw_verify(shard: Shard, *args):
    return _sharded_raw(_grouped_local, shard, *args)


# --- pk-grouped (shared-pubkey) tier ------------------------------------------


def _pk_grouped_local(shard: Shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits,
                      valid):
    """One worker's slice of the PK-GROUPED batch equation: its R/n
    pubkey rows' G2 message MSMs, Horner combines and (pk_k, Σ r_i·H_i)
    lanes; the signature aggregate and the constant lanes as in
    `_grouped_local`. K2p runs r_loc + 64/n lanes."""
    dev = msg_x.device
    r_loc, lanes = msg_x.shape[0], msg_x.shape[1]
    msgs = (msg_x, msg_y, fp2.one((r_loc, lanes), dev))
    msgs = g2.select(valid, msgs, g2.infinity((r_loc, lanes), dev))
    bits = torch.cat([a_bits, b_bits], dim=-1)

    with device_stage("bls/msm_planes"):
        m_planes = msm.masked_plane_sums(g2, msgs, bits)  # (64, r_loc)
        tp = tuple(c.reshape((2, HALF_BITS) + tuple(c.shape[1:])) for c in m_planes)
        tp = tuple(torch.movedim(c, 1, 0) for c in tp)
        ab = msm.horner_pow2(g2, tp)  # (2, r_loc)
        q_row = g2.add(tuple(c[0] for c in ab), g2_psi(tuple(c[1] for c in ab)))
        u_planes = _signature_planes(shard, sig_x, sig_y, bits, valid)
    (cx, cy, cz), uq = _constant_lanes(shard, u_planes, dev)

    with device_stage("bls/miller_loop"):
        px = torch.cat([pk_x, cx], 0)
        py = torch.cat([pk_y, cy], 0)
        pz = torch.cat([fp.one((r_loc,), dev), cz], 0)
        qx = torch.cat([q_row[0], uq[0]], 0)
        qy = torch.cat([q_row[1], uq[1]], 0)
        qz = torch.cat([q_row[2], uq[2]], 0)
        lane_ok = ~g1.is_infinity((px, py, pz)) & ~g2.is_infinity((qx, qy, qz))
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
        fs = fp12.select(lane_ok, fs, fp12.one((px.shape[0],), dev))
    with device_stage("bls/product_tree"):
        return fp12.product_tree(fs), u_planes


def _sharded_pk_grouped_verify(shard: Shard, *args):
    f_loc, _ = _pk_grouped_local(shard, *args)
    f_all = _gather_fp12_partials(f_loc, shard)
    return _tail_on_root(shard, _final_exp_tail(f_all))


def _sharded_pk_grouped_raw_verify(shard: Shard, *args):
    return _sharded_raw(_pk_grouped_local, shard, *args)


# --- bisection-verdict tier ---------------------------------------------------


def _bisect_local(pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, r_bits, valid):
    """One worker's leaf terms of the bisection tree: the scalar ladders
    and both Miller lanes of its slice, f_i = ML(r_i·pk_i, H_i)·
    ML(−g1, r_i·sig_i), identity for padding."""
    n_loc = pk_x.shape[0]
    dev = pk_x.device
    with device_stage("bls/scalar_mul"):
        rpk = g1.scalar_mul_bits(r_bits, (pk_x, pk_y))
        rsig = g2.scalar_mul_bits(r_bits, (sig_x, sig_y))
    gx = fp.const(G1_GEN_X, dev).expand(n_loc, N_LIMBS)
    neg_gy = fp.neg(fp.const(G1_GEN_Y, dev)).expand(n_loc, N_LIMBS)
    px = torch.cat([rpk[0], gx], 0)
    py = torch.cat([rpk[1], neg_gy], 0)
    pz = torch.cat([rpk[2], fp.one((n_loc,), dev)], 0)
    qx = torch.cat([msg_x, rsig[0]], 0)
    qy = torch.cat([msg_y, rsig[1]], 0)
    qz = torch.cat([fp2.one((n_loc,), dev), rsig[2]], 0)
    with device_stage("bls/miller_loop"):
        fs = miller_loop_proj_pq((px, py, pz), (qx, qy, qz))
    f = fp12.mul(fs[:n_loc], fs[n_loc:])
    return fp12.select(valid, f, fp12.one((n_loc,), dev))


def _sharded_bisect_verify(shard: Shard, *args):
    """The leaves are gathered on the first worker in worker order (worker
    k owns rows [k·n/size, (k+1)·n/size), so the host's set order comes
    back); it builds every level of the product tree and the root's final
    exponentiation and returns (root_ok, levels as host arrays)."""
    leaves = shard.gather_to_root(_bisect_local(*args))
    if leaves is None:
        return None
    leaves = leaves.reshape((-1,) + tuple(leaves.shape[2:]))
    with device_stage("bls/product_tree"):
        levels = [leaves]
        g = leaves
        while g.shape[0] > 1:
            g = fp12.mul(g[0::2], g[1::2])
            levels.append(g)
    with device_stage("bls/final_exp_batch"):
        root_ok = fp12.is_one(final_exponentiation_one(levels[-1][0]))
    return bool(root_ok), [lvl.cpu().numpy() for lvl in levels]


# --- the worker's entry -------------------------------------------------------


def _local_probe(local):
    """Instrumentation (tests): every worker's (f_loc, u_planes) of the
    grouped or pk-grouped local body, as host arrays."""
    def run(shard: Shard, *args):
        f_loc, u_planes = local(shard, *args)
        return f_loc.cpu().numpy(), torch.stack(u_planes).cpu().numpy()

    return run


def _combine_probe(shard: Shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits, b_bits, valid):
    """Instrumentation (tests): the two-level combines around the grouped
    local body, as host arrays: (the host's Fp12 product on its first
    worker, else None; the host's 64 plane sums; the 64 totals; the
    per-host products gathered on worker 0, else None)."""
    f_loc, u_planes = _grouped_local(shard, pk_x, pk_y, msg_x, msg_y, sig_x, sig_y, a_bits,
                                     b_bits, valid)
    f_host = shard.gather_in_host(f_loc)
    if f_host is not None:
        f_host = fp12.product_tree(f_host).cpu().numpy()
    u_part = torch.stack(_signature_plane_parts(sig_x, sig_y, torch.cat([a_bits, b_bits], -1),
                                                valid))
    u_host = _plane_tree_sum(shard.all_gather_in_host(u_part))
    f_all = _gather_fp12_partials(f_loc, shard)
    return (f_host, u_host.cpu().numpy(), torch.stack(u_planes).cpu().numpy(),
            None if f_all is None else f_all.cpu().numpy())


_RUNNERS = {
    "flat": _sharded_verify,
    "grouped": _sharded_grouped_verify,
    "grouped_raw": _sharded_grouped_raw_verify,
    "pk_grouped": _sharded_pk_grouped_verify,
    "pk_grouped_raw": _sharded_pk_grouped_raw_verify,
    "bisect": _sharded_bisect_verify,
    "grouped_local": _local_probe(_grouped_local),
    "pk_grouped_local": _local_probe(_pk_grouped_local),
    "grouped_combine": _combine_probe,
}


class _StageSeconds:
    """A worker's observer for one request: host seconds per device stage."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def observe_stage(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


def run_shard(kind: str, shard: Shard, arrays):
    """A worker's part of the sharded verdict `kind` on its row slice of
    host arrays (uploaded to the worker's device here): (its reply, the
    host seconds of each device stage it opened, by scope name)."""
    tensors = [torch.as_tensor(a).to(shard.device) for a in arrays]
    stages = _StageSeconds()
    with observing(stages):
        reply = _RUNNERS[kind](shard, *tensors)
    return reply, stages.seconds


# --- host wrappers --------------------------------------------------------------


class _Sharded:
    """A sharded verifier bound to a chip set, or to rows of chips (one
    per host) under the factory interface's ("dcn", "ici") `axis`.
    `pools` is the slot of the pool it runs on (the dispatcher's; by
    default one of its own, which `close()` stops)."""

    kind = ""
    splits_constant_lanes = True

    def __init__(self, devices, axis="dp", pools: PoolSlot | None = None):
        self.devices = list(devices)
        rows = [self.devices] if isinstance(axis, str) else self.devices
        self.ndev = sum(len(r) for r in rows)
        if self.splits_constant_lanes and CONSTANT_LANES % self.ndev:
            # a non-dividing mesh would drop constant Miller lanes and
            # reject every valid batch: refuse loudly instead
            raise ValueError(f"mesh size {self.ndev} must divide {CONSTANT_LANES} "
                             f"(constant lanes)")
        self._own_pools = pools is None
        self._pools = PoolSlot() if pools is None else pools

    @property
    def pool(self):
        """The pool of this chip set (started on first use)."""
        return self._pools.acquire(self.devices)

    def _run(self, *arrays):
        return self.pool.run(self.kind, arrays)[0]

    def close(self) -> None:
        if self._own_pools:
            self._pools.close()


class ShardedGroupedVerifier(_Sharded):
    """The sharded grouped verdict on (R, L) limb arrays (signatures
    decoded), root-sharded over the workers."""

    kind = "grouped"

    def submit(self, g, a_bits, b_bits) -> bool:
        return self._run(g.pk_x, g.pk_y, g.msg_x, g.msg_y, g.sig_x, g.sig_y, a_bits, b_bits,
                         g.valid)


class ShardedGroupedRawVerifier(_Sharded):
    """The sharded grouped RAW verdict: the signatures are the (R, L, 96)
    wire bytes of `_marshal_grouped`, decompressed by their worker."""

    kind = "grouped_raw"

    def submit(self, g, sig_raw, a_bits, b_bits) -> bool:
        return self._run(g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)


class ShardedPkGroupedVerifier(_Sharded):
    """The sharded pk-grouped verdict: (R,) pubkey rows and (R, L)
    message/signature arrays, row-sharded."""

    kind = "pk_grouped"

    def submit(self, g, a_bits, b_bits) -> bool:
        return self._run(g.pk_x, g.pk_y, g.msg_x, g.msg_y, g.sig_x, g.sig_y, a_bits, b_bits,
                         g.valid)


class ShardedPkGroupedRawVerifier(_Sharded):
    """The sharded pk-grouped RAW verdict (wire-byte signatures)."""

    kind = "pk_grouped_raw"

    def submit(self, g, sig_raw, a_bits, b_bits) -> bool:
        return self._run(g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_raw, a_bits, b_bits, g.valid)


class ShardedBisectVerifier(_Sharded):
    """The sharded bisection tree: padded per-set arrays lane-sharded;
    the batch must be a power of two divisible by the mesh size. Returns
    (root_ok, levels) with the level layout of `bisect_tree_kernel`, the
    levels as host arrays."""

    kind = "bisect"
    splits_constant_lanes = False

    def submit(self, arrs, r_bits):
        n = arrs.pk_x.shape[0]
        if n & (n - 1):
            raise ValueError(f"sharded bisect needs a power-of-two batch, got {n}")
        return self._run(arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y, arrs.sig_x, arrs.sig_y,
                         r_bits, arrs.valid)


class ShardedBlsVerifier(_Sharded):
    """The sharded flat verdict: padded per-set arrays lane-sharded (the
    lane count a multiple of the mesh size)."""

    kind = "flat"
    splits_constant_lanes = False

    def verify_arrays(self, arrs, r_bits) -> bool:
        return bool(self._run(arrs.pk_x, arrs.pk_y, arrs.msg_x, arrs.msg_y, arrs.sig_x,
                              arrs.sig_y, r_bits, arrs.valid))


VERIFIERS = {
    "grouped": ShardedGroupedVerifier,
    "grouped_raw": ShardedGroupedRawVerifier,
    "pk_grouped": ShardedPkGroupedVerifier,
    "pk_grouped_raw": ShardedPkGroupedRawVerifier,
    "bisect": ShardedBisectVerifier,
}


def local_parts(pool, kind: str, g, sig_x, sig_y, a_bits, b_bits):
    """Instrumentation (tests): every worker's (f_loc, u_planes) of the
    grouped (`kind` "grouped") or pk-grouped ("pk_grouped") local body on
    a marshalled batch with decoded signatures, as host arrays."""
    return pool.run(f"{kind}_local",
                    (g.pk_x, g.pk_y, g.msg_x, g.msg_y, sig_x, sig_y, a_bits, b_bits, g.valid))
