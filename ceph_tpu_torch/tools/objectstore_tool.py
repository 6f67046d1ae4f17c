"""ceph-objectstore-tool analog: offline FileStore inspection.

Reference: src/tools/ceph_objectstore_tool.cc (--op list / info / dump
against a stopped OSD's store).  Counterpart of
``ceph_tpu/tools/objectstore_tool.py``; host only.
"""

from __future__ import annotations

import argparse
import pickle
import sys

from ceph_tpu_torch.cluster.filestore import FileStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore-tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--op", choices=["list", "info", "dump", "meta"],
                    default="list")
    ap.add_argument("--collection")
    ap.add_argument("--object")
    args = ap.parse_args(argv)

    store = FileStore(args.data_path)
    store.mount()
    try:
        if args.op == "list":
            for coll in store.list_collections():
                if args.collection and coll != args.collection:
                    continue
                for oid in store.list_objects(coll):
                    print(f"{coll}/{oid}")
        elif args.op == "info":
            size = store.stat(args.collection, args.object)
            ver = store.get_version(args.collection, args.object)
            xattrs = store.get_xattrs(args.collection, args.object)
            print(f"{args.collection}/{args.object} size {size} "
                  f"version {ver} xattrs {sorted(xattrs)}")
        elif args.op == "dump":
            sys.stdout.buffer.write(store.read(args.collection, args.object))
        elif args.op == "meta":
            # the persisted pg log of a collection (pgmeta omap)
            from ceph_tpu_torch.cluster.osd import PGMETA

            coll = args.collection
            lu = store.getattr(coll, PGMETA, "last_update")
            print("last_update", pickle.loads(lu) if lu else None)
            for k, v in sorted(store.omap_get(coll, PGMETA).items()):
                e = pickle.loads(v)
                print(f"  {e.version} {e.op} {e.oid}")
        return 0
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
