"""RGW-lite: an S3-shaped object gateway over RADOS.

Behavioral analog of the reference radosgw core data model (src/rgw/):
buckets are omap-backed index objects (one entry per key, exactly how
cls_rgw maintains bucket indexes), object payloads live in the data pool
via the librados surface, and the API mirrors the S3 verbs the reference
gateway serves — create/delete bucket, put/get/head/delete object,
prefix+marker listing with truncation, and basic user metadata.  The
HTTP frontend (civetweb/Beast in the reference) is out of scope; this is
the gateway's storage core as a library.  Counterpart of
``ceph_tpu/cluster/rgw.py``.
"""

from __future__ import annotations

import hashlib
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.utils.deadline import deadline_of, remaining

from ceph_tpu_torch.cluster.objecter import IoCtx


def _chaos(io: IoCtx, name: str) -> None:
    """Client-library chaos seam: interrupt this gateway op
    AT THIS INSTANT when the client config arms ``name`` (the gateway
    process "died" mid-transaction; reclaim_multipart is the recovery
    pass).  One falsy test when unarmed — the no-op contract."""
    if not io.objecter.config.chaos_crash_point:
        return
    from ceph_tpu_torch.chaos.points import maybe_interrupt

    maybe_interrupt(io.objecter.config, name)


@dataclass
class ObjectMeta:
    """Bucket-index entry (cls_rgw rgw_bucket_dir_entry analog)."""

    key: str
    size: int
    etag: str
    mtime: float
    content_type: str = "application/octet-stream"
    user_meta: Dict[str, str] = field(default_factory=dict)


@dataclass
class ListResult:
    keys: List[ObjectMeta]
    is_truncated: bool
    next_marker: Optional[str]


class RGW:
    """Gateway handle (the radosgw storage core as a library).

    ``zone`` names this gateway's zone for multisite sync (reference
    rgw_zone): every index mutation also appends to the bucket's index
    LOG (cls_rgw bilog analog) and registers the bucket in the zone
    datalog, which RGWSyncAgent (rgw_sync.py) replays into peer zones.
    """

    def __init__(self, ioctx: IoCtx, zone: str = "default"):
        self.ioctx = ioctx
        self.zone = zone
        # gateway telemetry + admin surface (reference radosgw perf
        # counters 'rgw.*' + its admin socket): the frontend and sync
        # agent share this gateway's counters
        from ceph_tpu_torch.utils import AdminSocket, PerfCounters
        from ceph_tpu_torch.utils import perf as perfmod

        self.perf = PerfCounters(f"rgw.{zone}")
        self.perf.add_u64("rgw_put", desc="object puts")
        self.perf.add_u64("rgw_get", desc="object gets")
        self.perf.add_u64("rgw_mp_created", desc="multipart initiates")
        self.perf.add_u64("rgw_mp_parts", desc="multipart parts recorded")
        self.perf.add_u64("rgw_mp_completed", desc="multipart completes")
        self.perf.add_u64("rgw_mp_aborted", desc="multipart aborts")
        self.perf.add_u64("rgw_mp_rolled_forward",
                          desc="interrupted completes finished by reclaim")
        self.perf.add_u64("rgw_mp_orphan_parts",
                          desc="orphaned part objects garbage-collected")
        self.perf.add_u64("rgw_index_repaired",
                          desc="index entries dropped for missing payloads")
        self.perf.add_histogram(
            "rgw_obj_bytes_hist", unit=perfmod.UNIT_BYTES,
            desc="object payload size, log2 byte buckets")
        self.asok = AdminSocket()
        self.asok.register_common(self.perf)

    BUCKETS_OID = ".buckets.list"   # registry of buckets (omap)
    DATALOG_OID = ".datalog"        # bucket -> latest bilog seq (omap)
    BILOG_MAX = 1000                # trimmed window; older -> full sync

    @staticmethod
    def _index_oid(bucket: str) -> str:
        return f".bucket.index.{bucket}"

    @staticmethod
    def _bilog_oid(bucket: str) -> str:
        return f".bucket.log.{bucket}"

    # -- bucket index log (bilog) -------------------------------------------

    async def _bilog_append(self, bucket: str, op: str, key: str,
                            origin: Optional[str] = None) -> None:
        """Append one change record (reference cls_rgw bilog entry) and
        bump the bucket's datalog cursor.  ``origin`` is the zone the
        change FIRST happened in — the sync agent skips entries that
        originated in its own destination, which is what breaks the
        active-active echo loop."""
        log_oid = self._bilog_oid(bucket)
        entry = pickle.dumps({"op": op, "key": key,
                              "origin": origin or self.zone,
                              "stamp": time.time()})
        # cls-atomic append (cls_rgw bilog semantics): the exec txn
        # touches (auto-creates) the log object; seq allocation +
        # entry + trim run as one transaction under PG serialization, so
        # concurrent index mutations never collide or lose entries
        seq = int(await self.ioctx.execute(
            log_oid, "rgw_bilog", "append",
            pickle.dumps({"entry": entry, "max": self.BILOG_MAX})))
        await self.ioctx.omap_set(self.DATALOG_OID,
                                  {bucket: str(seq).encode()})

    async def bilog_window(self, bucket: str) -> Tuple[int, int]:
        """(tail, head) seq bounds of the retained log (0, 0) = empty."""
        log_oid = self._bilog_oid(bucket)
        try:
            head = int(await self.ioctx.getxattr(log_oid, "bilog.head"))
        except (KeyError, FileNotFoundError, IOError):
            return 0, 0
        try:
            tail = int(await self.ioctx.getxattr(log_oid, "bilog.tail"))
        except (KeyError, FileNotFoundError, IOError):
            tail = 0
        return tail, head

    async def bilog_entries(self, bucket: str, after: int) -> List[Tuple[int, Dict]]:
        """Entries with seq > after, oldest first."""
        try:
            om = await self.ioctx.omap_get(self._bilog_oid(bucket))
        except (FileNotFoundError, IOError):
            return []
        out = []
        for k, blob in sorted(om.items()):
            seq = int(k)
            if seq > after:
                out.append((seq, pickle.loads(blob)))
        return out

    async def datalog(self) -> Dict[str, int]:
        """bucket -> latest change seq (reference data changes log)."""
        try:
            om = await self.ioctx.omap_get(self.DATALOG_OID)
        except (FileNotFoundError, IOError):
            return {}
        return {b: int(v) for b, v in om.items()}

    @staticmethod
    def _data_oid(bucket: str, key: str) -> str:
        # length-prefixed: unambiguous for ANY bucket/key bytes (S3 keys
        # may contain any separator we could pick)
        return f"{len(bucket)}:{bucket}:{key}"

    # -- buckets ------------------------------------------------------------

    async def create_bucket(self, bucket: str) -> None:
        try:
            await self.ioctx.stat(self._index_oid(bucket))
            raise FileExistsError(bucket)
        except FileNotFoundError:
            pass
        await self.ioctx.write_full(self._index_oid(bucket),
                                    pickle.dumps({"created": time.time()}))
        await self.ioctx.omap_set(self.BUCKETS_OID, {bucket: b"1"})

    async def delete_bucket(self, bucket: str) -> None:
        idx = await self._index(bucket)
        if idx:
            raise OSError(39, "bucket not empty", bucket)
        await self.ioctx.remove(self._index_oid(bucket))
        await self.ioctx.omap_rmkeys(self.BUCKETS_OID, [bucket])

    async def list_buckets(self) -> List[str]:
        # O(buckets) via the registry omap, not O(pool objects)
        try:
            return sorted(await self.ioctx.omap_get(self.BUCKETS_OID))
        except (FileNotFoundError, IOError):
            return []

    async def _index(self, bucket: str,
                     timeout: float = None) -> Dict[str, bytes]:
        dl = deadline_of(timeout)
        try:
            await self.ioctx.stat(self._index_oid(bucket),
                                  timeout=remaining(dl))
        except FileNotFoundError:
            raise FileNotFoundError(f"bucket {bucket}")
        return await self.ioctx.omap_get(self._index_oid(bucket),
                                         timeout=remaining(dl))

    # -- objects ------------------------------------------------------------

    async def put_object(self, bucket: str, key: str, data: bytes,
                         content_type: str = "application/octet-stream",
                         user_meta: Optional[Dict[str, str]] = None,
                         origin: Optional[str] = None,
                         meta: Optional[ObjectMeta] = None,
                         timeout: float = None) -> str:
        """``origin``/``meta`` are the multisite apply path: the sync
        agent preserves the source zone's metadata (etag/mtime) and
        stamps the entry's TRUE origin for echo suppression."""
        dl = deadline_of(timeout)
        try:
            await self.ioctx.stat(self._index_oid(bucket),
                                  timeout=remaining(dl))  # must exist
        except FileNotFoundError:
            raise FileNotFoundError(f"bucket {bucket}")
        if meta is None:
            etag = hashlib.md5(data).hexdigest()
            meta = ObjectMeta(key=key, size=len(data), etag=etag,
                              mtime=time.time(),
                              content_type=content_type,
                              user_meta=dict(user_meta or {}))
        await self.ioctx.write_full(self._data_oid(bucket, key), data,
                                    timeout=remaining(dl))
        self.perf.inc("rgw_put")
        self.perf.hinc("rgw_obj_bytes_hist", len(data))
        # index update AFTER the payload lands (cls_rgw prepares/completes
        # around the data write for the same reason)
        await self.ioctx.omap_set(self._index_oid(bucket),
                                  {key: pickle.dumps(meta)},
                                  timeout=remaining(dl))
        await self._bilog_append(bucket, "put", key, origin)
        return meta.etag

    async def head_object(self, bucket: str, key: str,
                          timeout: float = None) -> ObjectMeta:
        idx = await self._index(bucket, timeout=timeout)
        blob = idx.get(key)
        if blob is None:
            raise FileNotFoundError(f"{bucket}/{key}")
        return pickle.loads(blob)

    async def get_object(self, bucket: str, key: str,
                         timeout: float = None
                         ) -> Tuple[ObjectMeta, bytes]:
        dl = deadline_of(timeout)
        meta = await self.head_object(bucket, key, timeout=remaining(dl))
        data = await self.ioctx.read(self._data_oid(bucket, key),
                                     timeout=remaining(dl))
        self.perf.inc("rgw_get")
        return meta, data

    async def delete_object(self, bucket: str, key: str,
                            origin: Optional[str] = None,
                            timeout: float = None) -> None:
        dl = deadline_of(timeout)
        await self.head_object(bucket, key,
                               timeout=remaining(dl))  # 404 when absent
        await self.ioctx.remove(self._data_oid(bucket, key),
                                timeout=remaining(dl))
        await self.ioctx.omap_rmkeys(self._index_oid(bucket), [key],
                                     timeout=remaining(dl))
        await self._bilog_append(bucket, "delete", key, origin)

    # -- multipart uploads --------------------------------------------------
    #
    # Reference rgw_op.cc RGWInitMultipart / RGWPutObj (part) /
    # RGWCompleteMultipart / RGWAbortMultipart, made DURABLE: the upload
    # registry is an omap object in RADOS (one record per in-flight
    # upload: key, recorded parts, state machine open -> completing |
    # aborting), part payloads are ordinary pool objects, and every
    # multi-step transition writes its intent record FIRST — so a
    # gateway process dying at any named seam leaves a state
    # ``reclaim_multipart`` can always finish:
    #
    #   rgw_part_mid      part payload landed, registry not updated ->
    #                     an orphaned part object (reclaim GCs it)
    #   rgw_complete_mid  final payload landed, bucket index not
    #                     updated -> the object is INVISIBLE (complete
    #                     is all-or-nothing); the 'completing' record
    #                     lets reclaim roll the complete FORWARD
    #   rgw_abort_mid     'aborting' record written, parts not yet
    #                     deleted -> reclaim finishes the abort
    #
    # Part objects and registry records never collide with client keys:
    # both live under dot-prefixed, length-prefixed names like the
    # bucket index itself.

    @staticmethod
    def _uploads_oid(bucket: str) -> str:
        return f".uploads.{len(bucket)}:{bucket}"

    @staticmethod
    def _mp_prefix(bucket: str) -> str:
        return f".mp.{len(bucket)}:{bucket}:"

    @classmethod
    def _mp_part_oid(cls, bucket: str, upload_id: str, n: int) -> str:
        return f"{cls._mp_prefix(bucket)}{upload_id}.{int(n):05d}"

    async def _mp_record(self, bucket: str, upload_id: str,
                         timeout: float = None) -> Dict:
        try:
            om = await self.ioctx.omap_get(self._uploads_oid(bucket),
                                           timeout=timeout)
        except (FileNotFoundError, IOError):
            raise FileNotFoundError(f"upload {upload_id}")
        blob = om.get(upload_id)
        if blob is None:
            raise FileNotFoundError(f"upload {upload_id}")
        return pickle.loads(blob)

    async def _mp_save(self, bucket: str, upload_id: str, rec: Dict,
                       timeout: float = None) -> None:
        await self.ioctx.omap_set(self._uploads_oid(bucket),
                                  {upload_id: pickle.dumps(rec)},
                                  timeout=timeout)

    async def create_multipart(self, bucket: str, key: str,
                               timeout: float = None) -> str:
        """InitMultipartUpload: allocate an id (cls-atomic counter) and
        write the durable 'open' record.  Until complete lands the
        index, the key stays invisible."""
        dl = deadline_of(timeout)
        try:
            await self.ioctx.stat(self._index_oid(bucket),
                                  timeout=remaining(dl))
        except FileNotFoundError:
            raise FileNotFoundError(f"bucket {bucket}")
        seq = int(await self.ioctx.execute(
            self._uploads_oid(bucket), "rgw_mp", "alloc",
            timeout=remaining(dl)))
        upload_id = f"{seq:06d}{hashlib.md5(key.encode()).hexdigest()[:8]}"
        rec = {"key": key, "state": "open", "parts": {},
               "started": time.time()}
        await self._mp_save(bucket, upload_id, rec,
                            timeout=remaining(dl))
        self.perf.inc("rgw_mp_created")
        return upload_id

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part_num: int, data: bytes,
                          timeout: float = None) -> str:
        """UploadPart: part payload first, registry record second — a
        crash between the two (``rgw_part_mid``) orphans the payload
        object, which is exactly what the reclaim pass garbage-collects
        (an unrecorded part never happened, S3 semantics).  Re-uploading
        a part number overwrites (last write wins, as in S3)."""
        dl = deadline_of(timeout)
        rec = await self._mp_record(bucket, upload_id,
                                    timeout=remaining(dl))
        if rec["key"] != key:
            raise FileNotFoundError(f"upload {upload_id} is not {key}")
        if rec["state"] != "open":
            raise IOError(f"upload {upload_id} is {rec['state']}")
        etag = hashlib.md5(data).hexdigest()
        await self.ioctx.write_full(
            self._mp_part_oid(bucket, upload_id, part_num), data,
            timeout=remaining(dl))
        _chaos(self.ioctx, "rgw_part_mid")
        rec["parts"][int(part_num)] = (etag, len(data))
        await self._mp_save(bucket, upload_id, rec,
                            timeout=remaining(dl))
        self.perf.inc("rgw_mp_parts")
        return etag

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 timeout: float = None) -> str:
        """CompleteMultipartUpload, all-or-nothing visible: (1) persist
        the 'completing' intent (the manifest is the recorded part set);
        (2) assemble and land the final payload; (3) update the bucket
        index — THE visibility point; (4) clean up parts + record.  A
        crash before (3) leaves the key invisible and a reclaim pass
        rolls the complete forward from the intent record; a crash
        after (3) leaves it visible and reclaim merely finishes the
        cleanup.  Partial visibility does not exist: readers resolve
        through the index, which flips in one omap write."""
        dl = deadline_of(timeout)
        rec = await self._mp_record(bucket, upload_id,
                                    timeout=remaining(dl))
        if rec["key"] != key:
            raise FileNotFoundError(f"upload {upload_id} is not {key}")
        if rec["state"] == "aborting":
            raise IOError(f"upload {upload_id} is aborting")
        if not rec["parts"]:
            raise ValueError(f"upload {upload_id} has no parts")
        if rec["state"] != "completing":   # retry keeps the intent
            rec["state"] = "completing"
            await self._mp_save(bucket, upload_id, rec,
                                timeout=remaining(dl))
        # S3 multipart etag: md5 over the part etags, dash part count —
        # computable from the RECORDED manifest alone, which is what
        # makes the roll-forward idempotence check below possible
        etags = [rec["parts"][n][0] for n in sorted(rec["parts"])]
        etag = (hashlib.md5("".join(etags).encode()).hexdigest()
                + f"-{len(etags)}")
        idx = await self.ioctx.omap_get(self._index_oid(bucket),
                                        timeout=remaining(dl))
        prior = idx.get(key)
        if prior is not None and pickle.loads(prior).etag == etag:
            # the index already flipped for THIS manifest: a previous
            # complete died mid-CLEANUP (some parts may already be
            # gone, so re-assembly is impossible and unnecessary) —
            # skip straight to finishing the cleanup
            pass
        else:
            data = bytearray()
            for n in sorted(rec["parts"]):
                data += await self.ioctx.read(
                    self._mp_part_oid(bucket, upload_id, n),
                    timeout=remaining(dl))
            await self.ioctx.write_full(self._data_oid(bucket, key),
                                        bytes(data),
                                        timeout=remaining(dl))
            _chaos(self.ioctx, "rgw_complete_mid")
            meta = ObjectMeta(key=key, size=len(data), etag=etag,
                              mtime=time.time())
            await self.ioctx.omap_set(self._index_oid(bucket),
                                      {key: pickle.dumps(meta)},
                                      timeout=remaining(dl))
            await self._bilog_append(bucket, "put", key, None)
            self.perf.inc("rgw_put")
            self.perf.hinc("rgw_obj_bytes_hist", len(data))
        for n in sorted(rec["parts"]):
            try:
                await self.ioctx.remove(
                    self._mp_part_oid(bucket, upload_id, n),
                    timeout=remaining(dl))
            except FileNotFoundError:
                pass
        await self.ioctx.omap_rmkeys(self._uploads_oid(bucket),
                                     [upload_id], timeout=remaining(dl))
        self.perf.inc("rgw_mp_completed")
        return etag

    async def abort_multipart(self, bucket: str, key: str,
                              upload_id: str,
                              timeout: float = None) -> None:
        """AbortMultipartUpload: persist the 'aborting' intent, then
        delete parts and the record.  A crash mid-abort
        (``rgw_abort_mid``) leaves the intent + some parts; reclaim
        finishes the abort."""
        dl = deadline_of(timeout)
        rec = await self._mp_record(bucket, upload_id,
                                    timeout=remaining(dl))
        if rec["key"] != key:
            raise FileNotFoundError(f"upload {upload_id} is not {key}")
        rec["state"] = "aborting"
        await self._mp_save(bucket, upload_id, rec,
                            timeout=remaining(dl))
        _chaos(self.ioctx, "rgw_abort_mid")
        for n in sorted(rec["parts"]):
            try:
                await self.ioctx.remove(
                    self._mp_part_oid(bucket, upload_id, n),
                    timeout=remaining(dl))
            except FileNotFoundError:
                pass
        await self.ioctx.omap_rmkeys(self._uploads_oid(bucket),
                                     [upload_id], timeout=remaining(dl))
        self.perf.inc("rgw_mp_aborted")

    async def list_multipart_uploads(self, bucket: str) -> Dict[str, Dict]:
        """upload_id -> record for every registered in-flight upload."""
        try:
            om = await self.ioctx.omap_get(self._uploads_oid(bucket))
        except (FileNotFoundError, IOError):
            return {}
        return {uid: pickle.loads(blob) for uid, blob in om.items()
                if not uid.startswith("_")}

    async def reclaim_multipart(self, bucket: str,
                                abort_open: bool = False) -> Dict[str, int]:
        """The multipart garbage collector + index repair pass
        (reference RGW GC / radosgw-admin bucket check --fix).  Resolves
        every interrupted transaction to a consistent end state:

        - 'completing' records ROLL FORWARD — the complete becomes
          visible exactly once (parts survive until the index flips;
          past the flip, a crash mid-cleanup is detected by the
          recorded manifest's etag already sitting in the index, and
          roll-forward skips straight to finishing the cleanup);
        - 'aborting' records finish their abort;
        - 'open' records are kept (or aborted with ``abort_open=True``,
          the lifecycle-expiry analog a judge pass uses);
        - part objects belonging to NO registered upload are orphans
          (a client died at ``rgw_part_mid``) and are deleted;
        - index entries whose payload object is gone (a client died
          mid-delete, between payload remove and index cleanup) are
          dropped — the bucket listing again matches readable objects.
        """
        stats = {"rolled_forward": 0, "aborts_finished": 0,
                 "orphan_parts": 0, "index_repaired": 0}
        for uid, rec in sorted(
                (await self.list_multipart_uploads(bucket)).items()):
            if rec["state"] == "completing":
                await self.complete_multipart(bucket, rec["key"], uid)
                stats["rolled_forward"] += 1
            elif rec["state"] == "aborting" or abort_open:
                await self.abort_multipart(bucket, rec["key"], uid)
                stats["aborts_finished"] += 1
        live = set()
        for uid, rec in (await self.list_multipart_uploads(bucket)).items():
            live.update(self._mp_part_oid(bucket, uid, n)
                        for n in rec["parts"])
            # recorded-or-not, a surviving upload's id prefix is live
            # (an unrecorded part may be re-recorded by a retry)
            live.add(uid)
        prefix = self._mp_prefix(bucket)
        for oid in await self.ioctx.list_objects():
            if not oid.startswith(prefix):
                continue
            uid = oid[len(prefix):].rsplit(".", 1)[0]
            if uid in live or oid in live:
                continue
            try:
                await self.ioctx.remove(oid)
                stats["orphan_parts"] += 1
            except FileNotFoundError:
                pass
        idx = await self._index(bucket)
        for key in sorted(idx):
            try:
                await self.ioctx.stat(self._data_oid(bucket, key))
            except FileNotFoundError:
                await self.ioctx.omap_rmkeys(self._index_oid(bucket),
                                             [key])
                await self._bilog_append(bucket, "delete", key, None)
                stats["index_repaired"] += 1
        for stat, counter in (("rolled_forward", "rgw_mp_rolled_forward"),
                              ("orphan_parts", "rgw_mp_orphan_parts"),
                              ("index_repaired", "rgw_index_repaired")):
            if stats[stat]:
                self.perf.inc(counter, stats[stat])
        return stats

    async def list_objects(self, bucket: str, prefix: str = "",
                           marker: str = "",
                           max_keys: int = 1000) -> ListResult:
        """S3 ListObjects semantics: lexicographic, after ``marker``,
        filtered by ``prefix``, truncated at ``max_keys``."""
        idx = await self._index(bucket)
        keys = sorted(k for k in idx
                      if k.startswith(prefix) and k > marker)
        page = keys[:max_keys]
        return ListResult(
            keys=[pickle.loads(idx[k]) for k in page],
            is_truncated=len(keys) > max_keys,
            next_marker=page[-1] if len(keys) > max_keys else None)
