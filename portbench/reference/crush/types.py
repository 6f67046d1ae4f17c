"""CRUSH map data structures and builder (frozen copy of the port's
``crush/types.py`` for the benchmark's reference).

Mirrors reference src/crush/crush.h (map/bucket/rule structs, :229-366) and
the builder API (src/crush/builder.c): buckets have negative ids, devices
non-negative; rules are step programs for the crush_do_rule VM.  Tunable
defaults are the reference's "optimal" (jewel) profile, which OSDMaps of the
reference era deploy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

CRUSH_ITEM_NONE = 0x7FFFFFFF
CRUSH_ITEM_UNDEF = 0x7FFFFFFE

# rule step opcodes (reference crush.h:55-69)
RULE_NOOP = 0
RULE_TAKE = 1
RULE_CHOOSE_FIRSTN = 2
RULE_CHOOSE_INDEP = 3
RULE_EMIT = 4
RULE_CHOOSELEAF_FIRSTN = 6
RULE_CHOOSELEAF_INDEP = 7
RULE_SET_CHOOSE_TRIES = 8
RULE_SET_CHOOSELEAF_TRIES = 9
RULE_SET_CHOOSE_LOCAL_TRIES = 10
RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
RULE_SET_CHOOSELEAF_VARY_R = 12
RULE_SET_CHOOSELEAF_STABLE = 13

BUCKET_UNIFORM = 1
BUCKET_LIST = 2
BUCKET_TREE = 3
BUCKET_STRAW = 4
BUCKET_STRAW2 = 5

_ALG_NAMES = {
    "uniform": BUCKET_UNIFORM,
    "list": BUCKET_LIST,
    "tree": BUCKET_TREE,
    "straw": BUCKET_STRAW,
    "straw2": BUCKET_STRAW2,
}


@dataclass
class Tunables:
    """Reference 'optimal' (jewel) profile; crush_do_rule semantics at
    mapper.c:904-918."""

    choose_total_tries: int = 50
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    @classmethod
    def legacy(cls) -> "Tunables":
        """crush_create() defaults (argonaut-era)."""
        return cls(
            choose_total_tries=19,
            choose_local_tries=2,
            choose_local_fallback_tries=5,
            chooseleaf_descend_once=0,
            chooseleaf_vary_r=0,
            chooseleaf_stable=0,
        )


@dataclass
class Bucket:
    id: int  # negative
    type: int  # 0 = device, >0 = bucket level
    alg: str = "straw2"
    hash: int = 0  # CRUSH_HASH_RJENKINS1
    items: List[int] = field(default_factory=list)
    weights: List[int] = field(default_factory=list)  # 16.16 fixed per item

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    # -- derived per-alg data (reference builder.c constructions) ----------

    @property
    def sum_weights(self) -> List[int]:
        """List bucket prefix sums (crush_make_list_bucket,
        builder.c:259-272)."""
        out, w = [], 0
        for wi in self.weights:
            w += wi
            out.append(w)
        return out

    @property
    def tree_data(self):
        """(num_nodes, node_weights) for a tree bucket
        (crush_make_tree_bucket, builder.c:352-392): item i lives at node
        (i+1)*2-1; internal nodes sum their subtree weights."""
        size = self.size
        if size == 0:
            return 0, []
        depth = 1
        t = size - 1
        while t:
            t >>= 1
            depth += 1
        num_nodes = 1 << depth
        nw = [0] * num_nodes
        for i, wi in enumerate(self.weights):
            node = ((i + 1) << 1) - 1
            nw[node] = wi
            for _ in range(1, depth):
                node = _tree_parent(node)
                nw[node] += wi
        return num_nodes, nw

    def straws(self, straw_calc_version: int = 1) -> List[int]:
        """Classic straw scaling factors (crush_calc_straw,
        builder.c:427-540, both calc versions)."""
        size = self.size
        weights = self.weights
        # reverse sort by weight, stable insertion (builder.c:436-454)
        reverse = [0] if size else []
        for i in range(1, size):
            for j in range(i):
                if weights[i] < weights[reverse[j]]:
                    reverse.insert(j, i)
                    break
            else:
                reverse.append(i)
        straws = [0] * size
        numleft = size
        straw = 1.0
        wbelow = 0.0
        lastw = 0.0
        i = 0
        while i < size:
            if straw_calc_version == 0:
                if weights[reverse[i]] == 0:
                    straws[reverse[i]] = 0
                    i += 1
                    continue
                straws[reverse[i]] = int(straw * 0x10000)
                i += 1
                if i == size:
                    break
                if weights[reverse[i]] == weights[reverse[i - 1]]:
                    continue
                wbelow += (weights[reverse[i - 1]] - lastw) * numleft
                j = i
                while j < size:
                    if weights[reverse[j]] == weights[reverse[i]]:
                        numleft -= 1
                    else:
                        break
                    j += 1
                wnext = numleft * (weights[reverse[i]] -
                                   weights[reverse[i - 1]])
                pbelow = wbelow / (wbelow + wnext)
                straw *= (1.0 / pbelow) ** (1.0 / numleft)
                lastw = weights[reverse[i - 1]]
            else:
                if weights[reverse[i]] == 0:
                    straws[reverse[i]] = 0
                    i += 1
                    numleft -= 1
                    continue
                straws[reverse[i]] = int(straw * 0x10000)
                i += 1
                if i == size:
                    break
                wbelow += (weights[reverse[i - 1]] - lastw) * numleft
                numleft -= 1
                wnext = numleft * (weights[reverse[i]] -
                                   weights[reverse[i - 1]])
                pbelow = wbelow / (wbelow + wnext)
                straw *= (1.0 / pbelow) ** (1.0 / numleft)
                lastw = weights[reverse[i - 1]]
        return straws


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_parent(n: int) -> int:
    h = _tree_height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


@dataclass
class ChooseArg:
    """Per-bucket straw2 overrides (reference crush_choose_arg,
    crush.h:273-278): pg-upmap/balancer-era weight sets + id remaps."""

    ids: Optional[List[int]] = None
    weight_set: Optional[List[List[int]]] = None  # per-position weights


@dataclass
class Rule:
    steps: List[Tuple[int, int, int]]
    ruleset: int = 0
    type: int = 1  # pg_pool type: 1 replicated, 3 erasure
    min_size: int = 1
    max_size: int = 10


class CrushMap:
    def __init__(self, tunables: Optional[Tunables] = None):
        self.buckets: Dict[int, Bucket] = {}
        self.rules: List[Rule] = []
        self.max_devices = 0
        self.tunables = tunables or Tunables()
        self.type_names: Dict[int, str] = {0: "osd", 1: "host", 2: "rack", 3: "root"}
        self.item_names: Dict[int, str] = {}
        self.straw_calc_version = 1
        # named choose_args sets: name -> {bucket_id: ChooseArg}
        # (reference crush_choose_arg_map, CrushWrapper choose_args)
        self.choose_args: Dict[str, Dict[int, "ChooseArg"]] = {}
        # device classes (reference CrushWrapper class_map + shadow trees)
        self.device_class: Dict[int, str] = {}
        self._class_shadow: Dict[Tuple[int, str], int] = {}

    # -- builder (reference builder.c semantics) ---------------------------

    def add_bucket(self, bucket: Bucket, name: Optional[str] = None) -> int:
        if bucket.id >= 0:
            bucket.id = -1 - len(self.buckets)
        self.buckets[bucket.id] = bucket
        for item in bucket.items:
            if item >= 0:
                self.max_devices = max(self.max_devices, item + 1)
        if name:
            self.item_names[bucket.id] = name
        return bucket.id

    def make_straw2(
        self,
        type: int,
        items: List[int],
        weights: List[int],
        name: Optional[str] = None,
    ) -> int:
        return self.add_bucket(
            Bucket(id=0, type=type, alg="straw2", items=list(items),
                   weights=list(weights)),
            name,
        )

    # -- device classes (reference CrushWrapper device classes: shadow
    #    per-class hierarchies so rules can take "root~class") -------------

    def set_device_class(self, dev: int, cls: str) -> None:
        self.device_class[dev] = cls
        # class changes invalidate every shadow tree (reference rebuilds
        # them on map mutation); stale shadows would place data on the
        # wrong class silently.  Old shadow buckets stay in the map
        # (ids must remain dense) but are no longer reachable.
        self._class_shadow.clear()

    def class_root(self, root_id: int, cls: str) -> int:
        """Shadow bucket id for ``root~cls``: a copy of the subtree keeping
        only devices of the class, weights recomputed bottom-up (the
        reference's class shadow trees, CrushWrapper::populate_classes)."""
        key = (root_id, cls)
        cached = self._class_shadow.get(key)
        if cached is not None:
            return cached
        shadow = self._build_class_shadow(root_id, cls)
        if shadow is None:
            raise ValueError(f"no devices of class {cls!r} under {root_id}")
        self._class_shadow[key] = shadow
        return shadow

    def _build_class_shadow(self, bid: int, cls: str) -> Optional[int]:
        b = self.buckets[bid]
        items: List[int] = []
        weights: List[int] = []
        for item, w in zip(b.items, b.weights):
            if item >= 0:
                if self.device_class.get(item) == cls:
                    items.append(item)
                    weights.append(w)
            else:
                sub = self._build_class_shadow(item, cls)
                if sub is not None:
                    items.append(sub)
                    weights.append(self.buckets[sub].weight)
        if not items:
            return None
        name = self.item_names.get(bid)
        return self.add_bucket(
            Bucket(id=0, type=b.type, alg=b.alg, hash=b.hash,
                   items=items, weights=weights),
            name=f"{name}~{cls}" if name else None)

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    # -- elastic mutation (reference CrushWrapper insert_item /
    #    remove_item: grow adds device-bearing host buckets under an
    #    existing root; drain unlinks a purged device and reweights the
    #    ancestor chain).  Bucket ids stay DENSE — nothing is ever
    #    deleted from ``buckets`` (the set_device_class shadow-tree
    #    rule), only unlinked — so the vectorized mapper's dense-id
    #    assumption survives every reshape.

    def parent_of(self, item: int) -> Optional[int]:
        for bid, b in self.buckets.items():
            if item in b.items:
                return bid
        return None

    def _reweight_item(self, parent: int, item: int, weight: int) -> None:
        b = self.buckets[parent]
        i = b.items.index(item)
        if b.weights[i] == weight:
            return
        b.weights[i] = weight
        gp = self.parent_of(parent)
        if gp is not None:
            self._reweight_item(gp, parent, b.weight)

    def add_host(self, name: str, devices: List[int],
                 weights: Optional[List[int]] = None,
                 root: str = "default") -> int:
        """Grow: a new host bucket holding ``devices``, linked under the
        named root with the ancestor weights bumped (CrushWrapper
        insert_item semantics: weights propagate to the top)."""
        weights = weights or [0x10000] * len(devices)
        root_id = next((bid for bid, n in self.item_names.items()
                        if n == root), None)
        if root_id is None:
            raise KeyError(f"no root bucket named {root!r}")
        hid = self.make_straw2(1, devices, weights, name=name)
        rb = self.buckets[root_id]
        rb.items.append(hid)
        rb.weights.append(self.buckets[hid].weight)
        gp = self.parent_of(root_id)
        if gp is not None:
            self._reweight_item(gp, root_id, rb.weight)
        self._class_shadow.clear()
        return hid

    def remove_device(self, dev: int) -> bool:
        """Drain: unlink a purged device from its holding bucket and
        reweight the chain above it; a host left empty is unlinked from
        its parent too (but stays in ``buckets`` — dense ids).  Returns
        whether anything was unlinked."""
        holder = self.parent_of(dev)
        if holder is None:
            return False
        b = self.buckets[holder]
        i = b.items.index(dev)
        del b.items[i]
        del b.weights[i]
        parent = self.parent_of(holder)
        if parent is not None:
            if b.items:
                self._reweight_item(parent, holder, b.weight)
            else:
                pb = self.buckets[parent]
                j = pb.items.index(holder)
                del pb.items[j]
                del pb.weights[j]
                gp = self.parent_of(parent)
                if gp is not None:
                    self._reweight_item(gp, parent, pb.weight)
        self.device_class.pop(dev, None)
        self._class_shadow.clear()
        return True

    def bucket(self, item_id: int) -> Bucket:
        return self.buckets[item_id]

    def max_depth(self) -> int:
        """Longest bucket chain (for bounding vectorized descents)."""

        def depth(bid: int) -> int:
            b = self.buckets[bid]
            best = 1
            for item in b.items:
                if item < 0:
                    best = max(best, 1 + depth(item))
            return best

        return max((depth(bid) for bid in self.buckets), default=0)


def build_three_level(
    n_racks: int,
    hosts_per_rack: int,
    osds_per_host: int,
    numrep: int = 3,
    weight: int = 0x10000,
) -> Tuple[CrushMap, int]:
    """root -> rack -> host -> osd map + chooseleaf-firstn rule (the
    deployment shape of large clusters; keeps bucket fanouts narrow)."""
    cmap = CrushMap()
    rack_ids, rack_w = [], []
    dev = 0
    for r in range(n_racks):
        host_ids, host_w = [], []
        for h in range(hosts_per_rack):
            items = list(range(dev, dev + osds_per_host))
            dev += osds_per_host
            weights = [weight] * osds_per_host
            hid = cmap.make_straw2(1, items, weights, name=f"host{r}-{h}")
            host_ids.append(hid)
            host_w.append(sum(weights))
        rid = cmap.make_straw2(2, host_ids, host_w, name=f"rack{r}")
        rack_ids.append(rid)
        rack_w.append(sum(host_w))
    root = cmap.make_straw2(3, rack_ids, rack_w, name="default")
    steps = [(RULE_TAKE, root, 0), (RULE_CHOOSELEAF_FIRSTN, numrep, 1),
             (RULE_EMIT, 0, 0)]
    ruleno = cmap.add_rule(Rule(steps=steps))
    return cmap, ruleno


def build_hierarchy(
    n_hosts: int,
    osds_per_host: int,
    numrep: int = 3,
    weight: int = 0x10000,
    chooseleaf: bool = True,
    firstn: bool = True,
) -> Tuple[CrushMap, int]:
    """Standard root->host->osd map + rule (the shape OSDMaps deploy)."""
    cmap = CrushMap()
    host_ids, host_weights = [], []
    dev = 0
    for h in range(n_hosts):
        items = list(range(dev, dev + osds_per_host))
        dev += osds_per_host
        weights = [weight] * osds_per_host
        hid = cmap.make_straw2(1, items, weights, name=f"host{h}")
        host_ids.append(hid)
        host_weights.append(sum(weights))
    root = cmap.make_straw2(3, host_ids, host_weights, name="default")
    if chooseleaf:
        op = RULE_CHOOSELEAF_FIRSTN if firstn else RULE_CHOOSELEAF_INDEP
        steps = [(RULE_TAKE, root, 0), (op, numrep, 1), (RULE_EMIT, 0, 0)]
    else:
        op = RULE_CHOOSE_FIRSTN if firstn else RULE_CHOOSE_INDEP
        steps = [(RULE_TAKE, root, 0), (op, numrep, 0), (RULE_EMIT, 0, 0)]
    ruleno = cmap.add_rule(Rule(steps=steps))
    return cmap, ruleno
