"""Batched CRUSH mapper: whole-pool placement as torch ops on the card.

Counterpart of ``ceph_tpu/crush/mapper.py``.  Every PG is a lane, and the
firstn/indep retry loops of reference mapper.c (crush_do_rule :883,
crush_choose_firstn :443, crush_choose_indep :638) become masked lane
loops: a Python ``while`` that runs while any lane is live, one host sync
per trip.  Exactness contract: identical outputs to ScalarMapper (and so
to the reference C) for straw2 maps with zero local retries, the
reference's 'optimal' tunables profile.

The straw2 draw is computed directly in int64: ``q = ln_neg[u] // w``
with ``ln_neg[u] = 2^48 - crush_ln(u)`` (non-negative, below 2^49)
gathered from a 64 Ki-entry table, so ``q`` is minus C's truncating
``div64_s64(crush_ln(u) - 2^48, w)`` and the winner is the FIRST index of
the least ``q`` (mapper.c:322-367 keeps the first strict maximum).
Weight-0 and padding slots are invalid and get ``INT64_MAX``, so a bucket
whose weights are all 0 picks slot 0, as C does.  The reference's uint32
pair arithmetic with reciprocals (``ops/u64pair.py``), its select-tree
|ln| lookup and its uniform-weight plateau tables worked around a TPU
without s64 and with slow gathers; the card has both, so none of them is
ported.

Supported: straw2 buckets; TAKE / CHOOSE(LEAF)_FIRSTN / CHOOSE(LEAF)_INDEP
/ EMIT / SET_* steps; vary_r / stable / descend_once semantics;
choose_args weight sets and id remaps.  Other map shapes raise
``NotImplementedError`` (``unsupported_reason`` names the cause); the
OSDMap and crushtool layers then use the scalar oracle, the reference's
semantics for such maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.crush.ln import crush_ln
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CrushMap,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSELEAF_VARY_R,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES,
    RULE_TAKE,
)
from ceph_tpu_torch.ops import jenkins
from ceph_tpu_torch.utils.device import resolve_device
from ceph_tpu_torch.utils.perf import KERNELS

I64 = torch.int64
INT64_MAX = (1 << 63) - 1

# 2^48 - crush_ln(u) for every 16-bit straw2 draw u: the one table the
# device gathers from (512 KiB as int64)
_LN_NEG = np.array([0x1000000000000 - crush_ln(u) for u in range(0x10000)],
                   dtype=np.int64)


class TensorMapper:
    @staticmethod
    def unsupported_reason(cmap: CrushMap) -> Optional[str]:
        """None when this map can run batched, else why not: the same
        conditions ``__init__`` enforces, without building anything."""
        t = cmap.tunables
        if t.choose_local_tries or t.choose_local_fallback_tries:
            return "legacy tunables (local retries)"
        ids = sorted(cmap.buckets, reverse=True)
        if ids != [-1 - i for i in range(len(ids))]:
            return "sparse bucket ids"
        for b in cmap.buckets.values():
            if b.alg != "straw2":
                return f"non-straw2 bucket ({b.alg})"
        return None

    def __init__(self, cmap: CrushMap, chunk: int = 1 << 16, device=None):
        reason = self.unsupported_reason(cmap)
        if reason is not None:
            raise NotImplementedError(
                f"batched mapper cannot run this map: {reason}; use "
                "ScalarMapper")
        self.map = cmap
        self.device = resolve_device(device)
        self.nb = len(cmap.buckets)
        max_sz = max((b.size for b in cmap.buckets.values()), default=1)
        max_sz = max(max_sz, 1)
        items = np.zeros((self.nb, max_sz), dtype=np.int64)
        weights = np.zeros((self.nb, max_sz), dtype=np.int64)
        sizes = np.zeros(self.nb, dtype=np.int64)
        btypes = np.zeros(self.nb, dtype=np.int64)
        for bid, b in cmap.buckets.items():
            row = -1 - bid
            sizes[row] = b.size
            btypes[row] = b.type
            items[row, : b.size] = b.items
            weights[row, : b.size] = b.weights
        self._items_np = items
        self._iweights_np = weights
        self.items = self._dev(items)
        self.iweights = self._dev(weights)
        self.sizes = self._dev(sizes)
        self.btypes = self._dev(btypes)
        self.ln_neg = self._dev(_LN_NEG)
        self.pos = self._dev(np.arange(max_sz, dtype=np.int64))
        self.max_devices = cmap.max_devices
        self.max_depth = cmap.max_depth()
        # reweight vector and choose_args tensors of the running rule
        # (choose_args None: the buckets' own weights)
        self._w: Optional[torch.Tensor] = None
        self._ca: Optional[Dict[str, torch.Tensor]] = None
        self._ca_pdim = 1
        self._ca_cache: Dict = {}
        # bound per-chunk memory: a (lanes, max bucket size) int64
        # temporary stays under 512 MiB (a straw2 draw holds a dozen)
        self.chunk = max(512, min(chunk, (1 << 26) // max_sz))

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------- choose_args

    def _build_ca_tensors(self, cargs) -> Tuple[Dict[str, torch.Tensor], int]:
        """Device tensors for a choose_args set (reference crush.h:273-278
        crush_choose_arg: per-bucket weight_set positions + id remaps,
        consumed by bucket_straw2_choose via mapper.c:302-320).

        Layout: ids (nb, S) replace the HASH input (chosen items stay the
        bucket's real items); weights flatten to (nb*P, S) rows indexed by
        bno*P + min(position, pmax[bno])."""
        nb, S = self._items_np.shape
        P = 1
        for a in cargs.values():
            if a.weight_set:
                P = max(P, len(a.weight_set))
        ids = self._items_np.copy()
        w = np.repeat(self._iweights_np[:, None, :], P, axis=1).copy()
        pmax = np.zeros(nb, dtype=np.int64)
        for bid, arg in cargs.items():
            row = -1 - bid
            if not (0 <= row < nb):
                continue
            if arg.ids:
                ids[row, :len(arg.ids)] = arg.ids
            if arg.weight_set:
                # positions beyond len(weight_set) are never selected:
                # _straw2 clamps with pmax, so no padding is needed
                for p, ws in enumerate(arg.weight_set):
                    w[row, p, :len(ws)] = ws
                pmax[row] = len(arg.weight_set) - 1
        tensors = {"ids": self._dev(ids),
                   "w": self._dev(w.reshape(nb * P, S)),
                   "pmax": self._dev(pmax)}
        return tensors, P

    def _resolve_choose_args(self, choose_args):
        """-> (tensors, P) for a name or {bucket_id: ChooseArg}."""
        if isinstance(choose_args, str):
            cargs = self.map.choose_args[choose_args]
            key = choose_args
        else:
            cargs = choose_args
            # content-addressed: a balancer loop passing fresh weights for
            # the same buckets must never hit a stale tensor set
            key = ("dict", tuple(sorted(
                (bid,
                 tuple(a.ids) if a.ids else None,
                 tuple(tuple(ws) for ws in a.weight_set)
                 if a.weight_set else None)
                for bid, a in cargs.items())))
        cached = self._ca_cache.get(key)
        if cached is None:
            cached = self._ca_cache[key] = self._build_ca_tensors(cargs)
            # bound the cache (balancer loops mint a fresh weight set per
            # iteration)
            while len(self._ca_cache) > 16:
                self._ca_cache.pop(next(iter(self._ca_cache)))
        return cached

    # -------------------------------------------------------------- straw2

    def _straw2(self, bno, x, r, wpos=None):
        """bucket_straw2_choose (mapper.c:322-367) over a lane batch.

        bno, x, r (L,) int64 -> chosen item (L,) int64.  ``wpos`` (L,) is
        the output position selecting the choose_args weight_set row
        (mapper.c:302-320); ignored without choose_args."""
        it = self.items[bno]                      # (L, S)
        sz = self.sizes[bno]
        if self._ca is not None:
            # choose_args: alternate ids feed the hash (the chosen item
            # stays the bucket's real item), alternate weights feed the
            # draws
            hash_ids = self._ca["ids"][bno]
            p = torch.zeros_like(bno) if wpos is None else wpos
            p = torch.minimum(p, self._ca["pmax"][bno])
            wt = self._ca["w"][bno * self._ca_pdim + p]
        else:
            hash_ids = it
            wt = self.iweights[bno]
        u = jenkins.hash3(x[:, None], hash_ids, r[:, None]) & 0xFFFF
        invalid = (wt == 0) | (self.pos[None, :] >= sz[:, None])
        q = self.ln_neg[u] // wt.clamp(min=1)
        q = q.masked_fill(invalid, INT64_MAX)
        idx = torch.argmin(q, dim=1)              # first index of the least
        return it.gather(1, idx[:, None])[:, 0]

    # ------------------------------------------------------------- helpers

    def _is_out(self, item, x):
        """is_out (mapper.c:407-421); item (L,) device ids."""
        w = self._w[item.clamp(0, self.max_devices - 1)]
        over = item >= self.max_devices
        hashed = (jenkins.hash2(x, item) & 0xFFFF) >= w
        return over | (w == 0) | ((w < 0x10000) & hashed)

    def _descend(self, start, x, r, type_, wpos=None):
        """Descend intervening buckets until an item of type_ (or a dead
        end).  Returns (item, hit_empty).  Mirrors the retry_bucket descent
        of choose_firstn/indep (the same r at every level of a straw2
        map): the start bucket is always drawn from, whatever its own
        type, and only the drawn items' types are tested
        (``scalar.py:235-257``, ``:326-340``)."""
        cur = start
        hit_empty = torch.zeros_like(x, dtype=torch.bool)
        for depth in range(self.max_depth):
            bno = (-1 - cur).clamp(0, self.nb - 1)
            need = cur < 0
            if depth:
                need = need & (self.btypes[bno] != type_)
            empty = need & (self.sizes[bno] == 0)
            hit_empty = hit_empty | empty
            nxt = self._straw2(bno, x, r, wpos)
            cur = torch.where(need & ~empty, nxt, cur)
        return cur, hit_empty

    def _bad_item(self, cur, type_):
        bno = (-1 - cur).clamp(0, self.nb - 1)
        wrong_bucket = (cur < 0) & (self.btypes[bno] != type_)
        wrong_dev = (cur >= 0) & ((type_ != 0) | (cur >= self.max_devices))
        return wrong_bucket | wrong_dev

    # -------------------------------------------------------------- firstn

    def _leaf_firstn(self, host, x, inner_rep, sub_r, tries, out2, cnt, act):
        """Recursive chooseleaf descent (one stable rep), the recursive
        crush_choose_firstn call at mapper.c:556-573.  Returns (leaf, ok)."""
        already = host >= 0                       # "we already have a leaf"
        leaf = torch.where(already, host, torch.full_like(host, CRUSH_ITEM_NONE))
        done = ~act | already
        lftotal = torch.zeros_like(x)
        slots = torch.arange(out2.shape[1], device=x.device)
        below = slots[None, :] < cnt[:, None]
        while True:
            live = ~done & (lftotal < tries)
            if not bool(live.any()):
                break
            r2 = inner_rep + sub_r + lftotal
            # choose_args position: the recursing slot (the scalar passes
            # the outer outpos through to the leaf's bucket_choose)
            cur, hit_empty = self._descend(host, x, r2, 0, cnt)
            bad = self._bad_item(cur, 0) & ~hit_empty
            coll = ((out2 == cur[:, None]) & below).any(dim=1)
            rej = self._is_out(cur, x) | hit_empty
            ok = live & ~bad & ~coll & ~rej
            leaf = torch.where(ok, cur, leaf)
            done = done | ok | (live & bad)       # bad -> inner skip_rep
            lftotal = lftotal + (live & ~ok & ~bad).long()
        ok = act & (already | (leaf != CRUSH_ITEM_NONE))
        return leaf, ok

    def _choose_firstn_vec(self, take, x, numrep, type_, tries, recurse_tries,
                           recurse_to_leaf, vary_r, stable, lane_mask):
        """crush_choose_firstn (mapper.c:443-631), zero local retries."""
        L = x.shape[0]
        out = torch.full((L, numrep), CRUSH_ITEM_NONE, dtype=I64,
                         device=x.device)
        out2 = out.clone()
        cnt = torch.zeros(L, dtype=I64, device=x.device)
        slots = torch.arange(numrep, device=x.device)
        for rep in range(numrep):
            ftotal = torch.zeros_like(cnt)
            done = ~lane_mask
            while True:
                live = ~done & (ftotal < tries)
                if not bool(live.any()):
                    break
                r = rep + ftotal
                # choose_args position = the slot being filled (outpos)
                cur, hit_empty = self._descend(take, x, r, type_, cnt)
                bad = live & self._bad_item(cur, type_) & ~hit_empty
                coll = ((out == cur[:, None])
                        & (slots[None, :] < cnt[:, None])).any(dim=1)
                reject = hit_empty
                leaf = cur
                if recurse_to_leaf:
                    sub_r = (r >> (vary_r - 1)) if vary_r else \
                        torch.zeros_like(r)
                    inner_rep = torch.zeros_like(cnt) if stable else cnt
                    leaf, leaf_ok = self._leaf_firstn(
                        cur, x, inner_rep, sub_r, recurse_tries, out2, cnt,
                        live & ~bad & ~coll & (cur < 0))
                    leaf = torch.where(cur >= 0, cur, leaf)
                    reject = reject | ((cur < 0) & ~leaf_ok)
                if type_ == 0:
                    reject = reject | self._is_out(cur, x)
                success = live & ~bad & ~coll & ~reject
                put = (slots[None, :] == cnt[:, None]) & success[:, None]
                out = torch.where(put, cur[:, None], out)
                out2 = torch.where(put, leaf[:, None], out2)
                cnt = cnt + success.long()
                done = done | success | bad
                ftotal = ftotal + (live & ~success & ~bad).long()
        return (out2 if recurse_to_leaf else out), cnt

    # --------------------------------------------------------------- indep

    def _leaf_indep(self, host, x, rep, numrep, parent_r, tries, act):
        """Recursive chooseleaf for indep (mapper.c:767-786)."""
        already = host >= 0
        leaf = torch.where(already & act, host,
                           torch.full_like(host, CRUSH_ITEM_UNDEF))
        done = ~act | already
        ftotal = torch.zeros_like(x)
        slot = torch.full_like(host, rep)
        while True:
            live = ~done & (ftotal < tries)
            if not bool(live.any()):
                break
            r = rep + parent_r + numrep * ftotal
            # the scalar's indep leaf recursion passes its slot as outpos
            cur, hit_empty = self._descend(host, x, r, 0, slot)
            bad = self._bad_item(cur, 0)
            rej = self._is_out(cur, x) | hit_empty
            ok = live & ~bad & ~rej
            leaf = torch.where(ok, cur, leaf)
            leaf = leaf.masked_fill(live & bad, CRUSH_ITEM_NONE)
            done = done | ok | (live & bad)
            ftotal = ftotal + live.long()
        return leaf.masked_fill(leaf == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE)

    def _choose_indep_vec(self, take, x, out_size, numrep, type_, tries,
                          recurse_tries, recurse_to_leaf, lane_mask):
        """crush_choose_indep (mapper.c:638-826), parent_r = 0.

        ``out_size`` (L,) is each lane's segment room, min(numrep,
        result_max - osize): slots past it start NONE, so they are never
        filled and never collide, as in the scalar's shorter segment."""
        L = x.shape[0]
        cols = torch.arange(numrep, device=x.device)
        room = lane_mask[:, None] & (cols[None, :] < out_size[:, None])
        out = torch.where(room, CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE).to(I64)
        out2 = out.clone()
        ftotal = torch.zeros(L, dtype=I64, device=x.device)
        while True:
            lane_live = (out == CRUSH_ITEM_UNDEF).any(dim=1) & (ftotal < tries)
            if not bool(lane_live.any()):
                break
            for rep in range(numrep):
                act = lane_live & (out[:, rep] == CRUSH_ITEM_UNDEF)
                r = rep + numrep * ftotal
                cur, hit_empty = self._descend(take, x, r, type_)
                bad = act & self._bad_item(cur, type_) & ~hit_empty
                coll = (out == cur[:, None]).any(dim=1)
                leaf = cur
                leaf_fail = torch.zeros_like(bad)
                if recurse_to_leaf:
                    leaf = self._leaf_indep(
                        cur, x, rep, numrep, r, recurse_tries,
                        act & ~bad & ~coll & (cur < 0))
                    leaf = torch.where(cur >= 0, cur, leaf)
                    leaf_fail = (cur < 0) & (leaf == CRUSH_ITEM_NONE)
                rej = self._is_out(cur, x) if type_ == 0 else \
                    torch.zeros_like(bad)
                success = act & ~bad & ~coll & ~leaf_fail & ~rej & ~hit_empty
                col = cols[None, :] == rep
                put, drop = col & success[:, None], col & bad[:, None]
                out = torch.where(put, cur[:, None], out)
                out = out.masked_fill(drop, CRUSH_ITEM_NONE)
                if recurse_to_leaf:
                    # a device drawn at type 0 is the slot's leaf before
                    # its is_out test (``scalar.py:358-365``): a slot that
                    # uses up its tries on out devices keeps the last one
                    drawn = act & ~bad & ~coll & ~hit_empty & (cur >= 0)
                    out2 = torch.where(col & drawn[:, None], cur[:, None],
                                       out2)
                out2 = torch.where(put, leaf[:, None], out2)
                out2 = out2.masked_fill(drop, CRUSH_ITEM_NONE)
            ftotal = ftotal + lane_live.long()
        out = out.masked_fill(out == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE)
        out2 = out2.masked_fill(out2 == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE)
        return out2 if recurse_to_leaf else out

    # ------------------------------------------------------------- rule VM

    def _run_rule(self, xs, rule, result_max: int):
        t = self.map.tunables
        L = xs.shape[0]
        dev = xs.device
        choose_tries = t.choose_total_tries + 1
        choose_leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable
        slots = torch.arange(result_max, device=dev)
        none = torch.full((L, result_max), CRUSH_ITEM_NONE, dtype=I64,
                          device=dev)
        w_items = none
        wsize = torch.zeros(L, dtype=I64, device=dev)
        # a host-side bound on wsize: working-vector entries past it are
        # empty on every lane, so their choose calls are skipped
        wmax = 0
        result = none
        rlen = torch.zeros(L, dtype=I64, device=dev)
        for op, arg1, arg2 in rule.steps:
            if op == RULE_TAKE:
                if not (0 <= arg1 < self.max_devices
                        or arg1 in self.map.buckets):
                    continue
                w_items = none.clone()
                w_items[:, 0] = arg1
                wsize = torch.ones_like(wsize)
                wmax = 1
            elif op == RULE_SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == RULE_SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    choose_leaf_tries = arg1
            elif op == RULE_SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == RULE_SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = arg1
            elif op in (RULE_SET_CHOOSE_LOCAL_TRIES,
                        RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
                if arg1 > 0:
                    raise NotImplementedError("local retries not batched")
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                        RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
                firstn = op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
                recurse = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        # every input is skipped and the empty output
                        # becomes the working vector (``scalar.py:439-444``,
                        # ``:482-485``)
                        w_items = none
                        wsize = torch.zeros_like(wsize)
                        wmax = 0
                        continue
                o_items = none
                osize = torch.zeros_like(wsize)
                # each W entry gets an independent output segment (the
                # reference passes o+osize per input bucket)
                for i in range(wmax):
                    mask = (i < wsize) & (w_items[:, i] < 0)
                    take = w_items[:, i]
                    if firstn:
                        if choose_leaf_tries:
                            recurse_tries = choose_leaf_tries
                        elif t.chooseleaf_descend_once:
                            recurse_tries = 1
                        else:
                            recurse_tries = choose_tries
                        vals, cnt = self._choose_firstn_vec(
                            take, xs, numrep, arg2, choose_tries,
                            recurse_tries, recurse, vary_r, stable, mask)
                        cnt = torch.where(mask, cnt, 0)
                    else:
                        out_size = (result_max - osize).clamp(0, numrep)
                        vals = self._choose_indep_vec(
                            take, xs, out_size, numrep, arg2, choose_tries,
                            choose_leaf_tries if choose_leaf_tries else 1,
                            recurse, mask)
                        cnt = torch.where(mask, out_size, 0)
                    for j in range(numrep):
                        valid = (j < cnt) & (osize < result_max)
                        put = (slots[None, :] == osize[:, None]) & \
                            valid[:, None]
                        o_items = torch.where(put, vals[:, j:j + 1], o_items)
                        osize = osize + valid.long()
                w_items = o_items
                wsize = osize
                wmax = min(result_max, wmax * numrep)
            elif op == RULE_EMIT:
                for j in range(wmax):
                    valid = (j < wsize) & (rlen < result_max)
                    put = (slots[None, :] == rlen[:, None]) & valid[:, None]
                    result = torch.where(put, w_items[:, j:j + 1], result)
                    rlen = rlen + valid.long()
                wsize = torch.zeros_like(wsize)
                wmax = 0
            else:
                raise NotImplementedError(f"rule op {op}")
        return result, rlen

    def compiled_rule(self, ruleno: int, result_max: int, choose_args=None):
        """The rule as a callable ``(xs, weights) -> (result, lens)`` on
        device tensors (xs int64 (L,), weights int64 (max_devices,)): the
        seam an external dispatcher (a sharded mapper) calls per shard.
        ``choose_args``: a name registered in map.choose_args or a
        {bucket_id: ChooseArg} dict, whose weights and ids the straw2
        draws use (mapper.c:302-320).  Nothing is compiled: the torch ops
        run as they are issued."""
        rule = self.map.rules[ruleno]
        ca, pdim = (None, 1) if choose_args is None else \
            self._resolve_choose_args(choose_args)

        def run(xs, weights):
            self._w, self._ca, self._ca_pdim = weights, ca, pdim
            try:
                return self._run_rule(xs, rule, result_max)
            finally:
                self._w, self._ca, self._ca_pdim = None, None, 1

        return run

    def do_rule_batch(self, ruleno: int, xs, result_max: int, weights,
                      choose_args=None):
        """Map a batch of x values: returns ((N, result_max) int64 device
        tensor with CRUSH_ITEM_NONE padding, (N,) lengths), matching
        crush_do_rule per x.  ``xs`` are uint32 values (numpy or a
        tensor), ``weights`` the 16.16 reweight vector (uint32 numpy or
        a tensor); devices past its end count as out."""
        fn = self.compiled_rule(ruleno, result_max, choose_args)
        if isinstance(xs, torch.Tensor):
            xs = xs.to(self.device, I64) & 0xFFFFFFFF
        else:
            xs = self._dev(np.asarray(xs).astype(np.int64) & 0xFFFFFFFF)
        # one entry at least: a map without devices still indexes it
        w = np.zeros(max(self.max_devices, 1), dtype=np.int64)
        if isinstance(weights, torch.Tensor):
            weights = weights.cpu().numpy()
        weights = np.asarray(weights).astype(np.int64)[: self.max_devices]
        w[: len(weights)] = weights
        w = self._dev(w)
        n = xs.shape[0]
        KERNELS.inc("crush_map_calls")
        KERNELS.inc("crush_map_pgs", int(n))
        outs, lens = [], []
        for start in range(0, n, self.chunk):
            part = xs[start : start + self.chunk]
            pad = 0
            if part.shape[0] < self.chunk and n > self.chunk:
                # the last chunk runs at the full chunk width, as the
                # reference's fixed-shape dispatch does; padded lanes run
                # the whole rule for discarded output
                pad = self.chunk - part.shape[0]
                part = torch.cat([part, part.new_zeros(pad)])
                KERNELS.inc("crush_map_pad_lanes", pad)
            res, rl = fn(part, w)
            if pad:
                res, rl = res[:-pad], rl[:-pad]
            outs.append(res)
            lens.append(rl)
        if len(outs) == 1:
            return outs[0], lens[0]
        return torch.cat(outs), torch.cat(lens)
