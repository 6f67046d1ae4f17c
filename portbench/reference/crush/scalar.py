"""Scalar CRUSH mapper: the benchmark's frozen plain reference.

A frozen copy of the port's ``crush/scalar.py`` (itself a copy of
``ceph_tpu/crush/scalar.py``), importing nothing of either package: its
hash is ``jenkins.py`` beside it, on plain Python ints.  Later changes to
the program's CRUSH code do not reach this file.

A faithful Python mirror of the reference rule VM and selection loops
(src/crush/mapper.c): crush_do_rule (:883-1088), crush_choose_firstn (:443),
crush_choose_indep (:638), ALL five bucket algorithms — uniform
(bucket_perm_choose :73), list (:141), tree (:195), straw (:224), straw2
(:322 incl. choose_args weight/id overrides :302-320) — and is_out (:407).
Golden-tested against vectors generated by compiling the reference C
(tests/golden/crush_golden.jsonl).  The batched mapper (mapper.py) is
validated against this oracle on randomized maps (in the port's tests).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench.reference.crush.ln import crush_ln
from portbench.reference.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    Bucket,
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
from portbench.reference.crush import jenkins

S64_MIN = -(2**63)


def _div64(a: int, b: int) -> int:
    """C-style truncating division."""
    q = abs(a) // b
    return -q if a < 0 else q


class _PermState:
    """Per-bucket permutation state (crush_work_bucket)."""

    def __init__(self):
        self.perm_x = 0
        self.perm_n = 0
        self.perm: List[int] = []


class ScalarMapper:
    def __init__(self, cmap: CrushMap):
        self.map = cmap
        self._derived: Dict = {}  # per-bucket builder-derived data
        self._cargs = None        # active choose_args during do_rule

    # -- bucket choose methods --------------------------------------------

    def _straw2_choose(self, bucket: Bucket, x: int, r: int,
                       arg=None, position: int = 0) -> int:
        weights = bucket.weights
        ids = bucket.items
        if arg is not None:
            # choose_args overrides (reference get_choose_arg_weights/ids,
            # mapper.c:302-320)
            if arg.weight_set:
                pos = min(position, len(arg.weight_set) - 1)
                weights = arg.weight_set[pos]
            if arg.ids:
                ids = arg.ids
        high = 0
        high_draw = 0
        for i in range(bucket.size):
            w = weights[i]
            if w:
                u = int(jenkins.hash3(x & 0xFFFFFFFF, ids[i] & 0xFFFFFFFF,
                                      r & 0xFFFFFFFF)) & 0xFFFF
                ln = crush_ln(u) - 0x1000000000000
                draw = _div64(ln, w)
            else:
                draw = S64_MIN
            if i == 0 or draw > high_draw:
                high = i
                high_draw = draw
        return bucket.items[high]

    def _list_choose(self, bucket: Bucket, x: int, r: int) -> int:
        # reference bucket_list_choose (mapper.c:141-166)
        sums = self._derived.get(("list", bucket.id))
        if sums is None:
            sums = self._derived[("list", bucket.id)] = bucket.sum_weights
        for i in range(bucket.size - 1, -1, -1):
            w = int(jenkins.hash4(x & 0xFFFFFFFF,
                                  bucket.items[i] & 0xFFFFFFFF,
                                  r & 0xFFFFFFFF,
                                  bucket.id & 0xFFFFFFFF)) & 0xFFFF
            w = (w * sums[i]) >> 16
            if w < bucket.weights[i]:
                return bucket.items[i]
        return bucket.items[0]

    def _tree_choose(self, bucket: Bucket, x: int, r: int) -> int:
        # reference bucket_tree_choose (mapper.c:195-222)
        num_nodes, nw = self._tree_cache(bucket)
        n = num_nodes >> 1
        while not (n & 1):
            w = nw[n]
            t = (int(jenkins.hash4(x & 0xFFFFFFFF, n & 0xFFFFFFFF,
                                   r & 0xFFFFFFFF,
                                   bucket.id & 0xFFFFFFFF)) * w) >> 32
            h = 0
            m = n
            while (m & 1) == 0:
                h += 1
                m >>= 1
            left = n - (1 << (h - 1))
            n = left if t < nw[left] else n + (1 << (h - 1))
        return bucket.items[n >> 1]

    def _straw_choose(self, bucket: Bucket, x: int, r: int) -> int:
        # reference bucket_straw_choose (mapper.c:224-243)
        straws = self._straw_cache(bucket)
        high = 0
        high_draw = 0
        for i in range(bucket.size):
            draw = int(jenkins.hash3(x & 0xFFFFFFFF,
                                     bucket.items[i] & 0xFFFFFFFF,
                                     r & 0xFFFFFFFF)) & 0xFFFF
            draw *= straws[i]
            if i == 0 or draw > high_draw:
                high = i
                high_draw = draw
        return bucket.items[high]

    def _tree_cache(self, bucket: Bucket):
        c = self._derived.get(("tree", bucket.id))
        if c is None:
            c = self._derived[("tree", bucket.id)] = bucket.tree_data
        return c

    def _straw_cache(self, bucket: Bucket):
        c = self._derived.get(("straw", bucket.id))
        if c is None:
            c = self._derived[("straw", bucket.id)] = bucket.straws(
                self.map.straw_calc_version)
        return c

    def _perm_choose(self, bucket: Bucket, work: _PermState, x: int, r: int) -> int:
        # reference bucket_perm_choose (mapper.c:73-131)
        pr = r % bucket.size
        if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
            work.perm_x = x & 0xFFFFFFFF
            if pr == 0:
                s = int(jenkins.hash3(x & 0xFFFFFFFF, bucket.id & 0xFFFFFFFF, 0)
                        ) % bucket.size
                work.perm = [0] * bucket.size
                work.perm[0] = s
                work.perm_n = 0xFFFF
                return bucket.items[s]
            work.perm = list(range(bucket.size))
            work.perm_n = 0
        elif work.perm_n == 0xFFFF:
            for i in range(1, bucket.size):
                work.perm[i] = i
            work.perm[work.perm[0]] = 0
            work.perm_n = 1
        while work.perm_n <= pr:
            p = work.perm_n
            if p < bucket.size - 1:
                i = int(jenkins.hash3(x & 0xFFFFFFFF, bucket.id & 0xFFFFFFFF, p)
                        ) % (bucket.size - p)
                if i:
                    work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
            work.perm_n += 1
        return bucket.items[work.perm[pr]]

    def _bucket_choose(self, bucket: Bucket, work: Dict[int, _PermState],
                       x: int, r: int, arg=None, position: int = 0) -> int:
        # reference crush_bucket_choose dispatch (mapper.c:370-401)
        if bucket.alg == "straw2":
            return self._straw2_choose(bucket, x, r, arg, position)
        if bucket.alg == "uniform":
            return self._perm_choose(
                bucket, work.setdefault(bucket.id, _PermState()), x, r)
        if bucket.alg == "list":
            return self._list_choose(bucket, x, r)
        if bucket.alg == "tree":
            return self._tree_choose(bucket, x, r)
        if bucket.alg == "straw":
            return self._straw_choose(bucket, x, r)
        raise NotImplementedError(f"bucket alg {bucket.alg}")

    def _is_out(self, weights, item: int, x: int) -> bool:
        # reference is_out (mapper.c:407-421)
        if item >= len(weights):
            return True
        w = weights[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return (int(jenkins.hash2(x & 0xFFFFFFFF, item & 0xFFFFFFFF)) & 0xFFFF) >= w

    # -- firstn ------------------------------------------------------------

    def _choose_firstn(self, bucket: Bucket, weights, x: int, numrep: int,
                       type: int, out: List[int], outpos: int, out_size: int,
                       tries: int, recurse_tries: int, local_retries: int,
                       local_fallback_retries: int, recurse_to_leaf: bool,
                       vary_r: int, stable: int, out2: Optional[List[int]],
                       parent_r: int, work: Dict[int, _PermState]) -> int:
        m = self.map
        count = out_size
        rep = 0 if stable else outpos
        while rep < numrep and count > 0:
            ftotal = 0
            skip_rep = False
            retry_descent = True
            item = 0
            while retry_descent:
                retry_descent = False
                inb = bucket
                flocal = 0
                retry_bucket = True
                while retry_bucket:
                    retry_bucket = False
                    collide = False
                    r = rep + parent_r + ftotal
                    if inb.size == 0:
                        reject = True
                    else:
                        if (local_fallback_retries > 0
                                and flocal >= (inb.size >> 1)
                                and flocal > local_fallback_retries):
                            item = self._perm_choose(
                                inb, work.setdefault(inb.id, _PermState()), x, r)
                        else:
                            item = self._bucket_choose(
                                inb, work, x, r,
                                self._arg_for(inb), outpos)
                        if item >= m.max_devices:
                            skip_rep = True
                            break
                        itemtype = m.buckets[item].type if item < 0 else 0
                        if itemtype != type:
                            if item >= 0 or item not in m.buckets:
                                skip_rep = True
                                break
                            inb = m.buckets[item]
                            retry_bucket = True
                            continue
                        for i in range(outpos):
                            if out[i] == item:
                                collide = True
                                break
                        reject = False
                        if not collide and recurse_to_leaf:
                            if item < 0:
                                sub_r = r >> (vary_r - 1) if vary_r else 0
                                if self._choose_firstn(
                                        m.buckets[item], weights, x,
                                        1 if stable else outpos + 1, 0,
                                        out2, outpos, count,
                                        recurse_tries, 0,
                                        local_retries, local_fallback_retries,
                                        False, vary_r, stable, None, sub_r,
                                        work) <= outpos:
                                    reject = True
                            else:
                                out2[outpos] = item
                        if not reject and not collide:
                            if itemtype == 0:
                                reject = self._is_out(weights, item, x)
                    if reject or collide:
                        ftotal += 1
                        flocal += 1
                        if collide and flocal <= local_retries:
                            retry_bucket = True
                        elif (local_fallback_retries > 0
                              and flocal <= inb.size + local_fallback_retries):
                            retry_bucket = True
                        elif ftotal < tries:
                            retry_descent = True
                        else:
                            skip_rep = True
            if skip_rep:
                rep += 1
                continue
            out[outpos] = item
            outpos += 1
            count -= 1
            rep += 1
        return outpos

    # -- indep -------------------------------------------------------------

    def _choose_indep(self, bucket: Bucket, weights, x: int, left: int,
                      numrep: int, type: int, out: List[int], outpos: int,
                      tries: int, recurse_tries: int, recurse_to_leaf: bool,
                      out2: Optional[List[int]], parent_r: int,
                      work: Dict[int, _PermState]) -> None:
        m = self.map
        endpos = outpos + left
        for rep in range(outpos, endpos):
            out[rep] = CRUSH_ITEM_UNDEF
            if out2 is not None:
                out2[rep] = CRUSH_ITEM_UNDEF
        ftotal = 0
        while left > 0 and ftotal < tries:
            for rep in range(outpos, endpos):
                if out[rep] != CRUSH_ITEM_UNDEF:
                    continue
                inb = bucket
                while True:
                    r = rep + parent_r
                    if inb.alg == "uniform" and inb.size % numrep == 0:
                        r += (numrep + 1) * ftotal
                    else:
                        r += numrep * ftotal
                    if inb.size == 0:
                        break
                    item = self._bucket_choose(inb, work, x, r,
                                               self._arg_for(inb), outpos)
                    if item >= m.max_devices:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    itemtype = m.buckets[item].type if item < 0 else 0
                    if itemtype != type:
                        if item >= 0 or item not in m.buckets:
                            out[rep] = CRUSH_ITEM_NONE
                            if out2 is not None:
                                out2[rep] = CRUSH_ITEM_NONE
                            left -= 1
                            break
                        inb = m.buckets[item]
                        continue
                    collide = False
                    for i in range(outpos, endpos):
                        if out[i] == item:
                            collide = True
                            break
                    if collide:
                        break
                    if recurse_to_leaf:
                        if item < 0:
                            self._choose_indep(
                                m.buckets[item], weights, x, 1, numrep, 0,
                                out2, rep, recurse_tries, 0, False, None, r,
                                work)
                            if out2[rep] == CRUSH_ITEM_NONE:
                                break
                        else:
                            out2[rep] = item
                    if itemtype == 0 and self._is_out(weights, item, x):
                        break
                    out[rep] = item
                    left -= 1
                    break
            ftotal += 1
        for rep in range(outpos, endpos):
            if out[rep] == CRUSH_ITEM_UNDEF:
                out[rep] = CRUSH_ITEM_NONE
            if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
                out2[rep] = CRUSH_ITEM_NONE

    # -- rule VM -----------------------------------------------------------

    def _arg_for(self, bucket: Bucket):
        if self._cargs is None:
            return None
        return self._cargs.get(bucket.id)

    def do_rule(self, ruleno: int, x: int, result_max: int,
                weights, choose_args=None) -> List[int]:
        """Mirror of crush_do_rule (mapper.c:883-1088).  ``choose_args``:
        a name registered in map.choose_args, or a {bucket_id: ChooseArg}
        dict (reference crush_do_rule's choose_args parameter)."""
        if isinstance(choose_args, str):
            # unknown names raise: a typo silently computing raw-weight
            # placements would defeat the balancer
            choose_args = self.map.choose_args[choose_args]
        self._cargs = choose_args
        m = self.map
        t = m.tunables
        rule = m.rules[ruleno]
        choose_tries = t.choose_total_tries + 1
        choose_leaf_tries = 0
        choose_local_retries = t.choose_local_tries
        choose_local_fallback_retries = t.choose_local_fallback_tries
        vary_r = t.chooseleaf_vary_r
        stable = t.chooseleaf_stable
        result: List[int] = []
        w: List[int] = [0] * result_max
        o: List[int] = [0] * result_max
        c: List[int] = [0] * result_max
        wsize = 0
        work: Dict[int, _PermState] = {}

        for op, arg1, arg2 in rule.steps:
            if op == RULE_TAKE:
                if (0 <= arg1 < m.max_devices) or arg1 in m.buckets:
                    w[0] = arg1
                    wsize = 1
            elif op == RULE_SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == RULE_SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    choose_leaf_tries = arg1
            elif op == RULE_SET_CHOOSE_LOCAL_TRIES:
                if arg1 >= 0:
                    choose_local_retries = arg1
            elif op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if arg1 >= 0:
                    choose_local_fallback_retries = arg1
            elif op == RULE_SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == RULE_SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = arg1
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                        RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
                if wsize == 0:
                    continue
                firstn = op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
                recurse_to_leaf = op in (RULE_CHOOSELEAF_FIRSTN,
                                         RULE_CHOOSELEAF_INDEP)
                osize = 0
                for i in range(wsize):
                    numrep = arg1
                    if numrep <= 0:
                        numrep += result_max
                        if numrep <= 0:
                            continue
                    if w[i] >= 0 or w[i] not in m.buckets:
                        continue
                    bucket = m.buckets[w[i]]
                    # the reference hands each input bucket the output
                    # slice o+osize (and c+osize), so collisions and
                    # replica numbering are per-segment
                    seg = result_max - osize
                    o_seg = [0] * seg
                    c_seg = [0] * seg
                    if firstn:
                        if choose_leaf_tries:
                            recurse_tries = choose_leaf_tries
                        elif t.chooseleaf_descend_once:
                            recurse_tries = 1
                        else:
                            recurse_tries = choose_tries
                        n = self._choose_firstn(
                            bucket, weights, x, numrep, arg2,
                            o_seg, 0, seg,
                            choose_tries, recurse_tries,
                            choose_local_retries,
                            choose_local_fallback_retries,
                            recurse_to_leaf, vary_r, stable,
                            c_seg, 0, work)
                        o[osize:osize + n] = o_seg[:n]
                        c[osize:osize + n] = c_seg[:n]
                        osize += n
                    else:
                        out_size = min(numrep, seg)
                        self._choose_indep(
                            bucket, weights, x, out_size, numrep, arg2,
                            o_seg, 0, choose_tries,
                            choose_leaf_tries if choose_leaf_tries else 1,
                            recurse_to_leaf, c_seg, 0, work)
                        o[osize:osize + out_size] = o_seg[:out_size]
                        c[osize:osize + out_size] = c_seg[:out_size]
                        osize += out_size
                if recurse_to_leaf:
                    o[:osize] = c[:osize]
                w, o = o, w
                wsize = osize
            elif op == RULE_EMIT:
                for i in range(wsize):
                    if len(result) < result_max:
                        result.append(w[i])
                wsize = 0
            else:
                raise NotImplementedError(f"rule op {op}")
        return result
