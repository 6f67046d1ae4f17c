"""What the port's client-layer tests share: ``run_both`` for scenarios
that store pickled metadata.

RBD image headers, RGW bucket-index objects and CephFS directory objects
hold pickles of each package's own classes (``ImageHeader``, ``Inode``)
and wall-clock stamps, so their bytes differ between the packages however
equal the scenario.  ``run_both_clients`` holds every other object and
read to equal bytes, as ``tests/test_torch_cluster.run_both`` does, and
these metadata objects to equal names, shards and layouts; the reads of
them to equal names and arguments.  Their contents are held through what
the scenario reads back and returns.
"""

from tests.test_torch_cluster import BOUND, PORT, REF, run_one

# object-name prefixes of pickled metadata: rbd.py's image header,
# rgw.py's bucket index, fs.py's directory objects
META_PREFIXES = ("rbd_header.", ".bucket.index.", "dir.")


def is_metadata(oid) -> bool:
    return isinstance(oid, str) and oid.startswith(META_PREFIXES)


def _reads(rec):
    """Client reads and stats; a metadata object's digest dropped."""
    return sorted({r[:-1] + ("<metadata>",) if is_metadata(r[2]) else r
                   for r in rec["reads"]}, key=repr)


def _stores(rec):
    """Each stopped cluster's objects; a metadata object's digest
    dropped."""
    return [sorted({s[:-1] + ("<metadata>",) if is_metadata(s[1]) else s
                    for s in stores}, key=repr)
            for stores in rec["stores"]]


def run_both_clients(scenario, reads: bool = True, stores: bool = True,
                     bound: float = BOUND):
    """``scenario(P)`` on the reference, then on the port, each under its
    own ``bound``: equal returns and, unless the caller says the
    scenario depends on timing, equal reads and stored objects up to the
    metadata objects' bytes.  Returns the port's result."""
    ref, ref_rec = run_one(scenario, REF, bound)
    got, got_rec = run_one(scenario, PORT, bound)
    assert got == ref
    if reads:
        assert _reads(got_rec) == _reads(ref_rec)
    if stores:
        assert _stores(got_rec) == _stores(ref_rec)
    return got
