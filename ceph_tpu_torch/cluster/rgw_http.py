"""RGW HTTP frontend: an S3-shaped REST gateway over the RGW core.

Counterpart of ``ceph_tpu/cluster/rgw_http.py``.  The reference serves
S3 through an
embedded HTTP frontend (src/rgw/rgw_civetweb_frontend.cc) with REST op
dispatch (rgw_rest_s3.cc) and signature auth (rgw_auth_s3.cc).  This is
that stack's analog on asyncio TCP: request parsing, signature-v2-style
HMAC auth, bucket/object REST verbs with S3 XML bodies, x-amz-meta-*
user metadata, and MULTIPART uploads (initiate/part/complete/abort,
rgw_op.cc RGWInitMultipart/RGWCompleteMultipart) assembled into the
final RADOS object.

Auth-lite, documented: AWS signature VERSION 2 shape over
(method, path, x-amz-date) with HMAC-SHA256 — per-account secrets, the
presented signature proves key possession; v4's canonical-request/
scope derivation is not implemented.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster.rgw import RGW


def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


class S3Request:
    def __init__(self, method, path, query, headers, body):
        self.method = method
        self.path = path
        self.query: Dict[str, str] = query
        self.headers: Dict[str, str] = headers
        self.body = body


class RGWFrontend:
    """The civetweb-frontend analog: accept loop + REST dispatch."""

    def __init__(self, rgw: RGW,
                 accounts: Optional[Dict[str, str]] = None):
        self.rgw = rgw
        # access key -> secret (RGWUserInfo keys analog); None = no auth
        self.accounts = accounts
        self._server = None
        self.addr: Optional[Tuple[str, int]] = None
        self._conns: List = []

    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._server = await asyncio.start_server(self._serve, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # close live keep-alive connections, or wait_closed()
            # (which since py3.12 awaits every handler) blocks on
            # clients parked in their next readline
            for w in self._conns:
                try:
                    w.close()
                except (ConnectionError, OSError, RuntimeError):
                    pass  # best-effort close of a dying keep-alive
            await self._server.wait_closed()

    # -- HTTP plumbing -----------------------------------------------------

    async def _serve(self, reader, writer) -> None:
        self._conns.append(writer)
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except ValueError:
                    # malformed request line/header: answer 400, drop
                    body = self._error_xml("BadRequest", "malformed")
                    writer.write(
                        (f"HTTP/1.1 400 Bad Request\r\nContent-Length: "
                         f"{len(body)}\r\nConnection: close\r\n\r\n"
                         ).encode() + body)
                    await writer.drain()
                    break
                if req is None:
                    break
                status, headers, body = await self._dispatch(req)
                resp = [f"HTTP/1.1 {status}"]
                headers.setdefault("Content-Length", str(len(body)))
                headers.setdefault("Connection", "keep-alive")
                for k, v in headers.items():
                    resp.append(f"{k}: {v}")
                writer.write(("\r\n".join(resp) + "\r\n\r\n").encode()
                             + body)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
            try:
                self._conns.remove(writer)
            except ValueError:
                pass

    async def _read_request(self, reader) -> Optional[S3Request]:
        line = await reader.readline()
        if not line:
            return None
        method, target, _ = line.decode().split(" ", 2)
        headers: Dict[str, str] = {}
        while True:
            h = (await reader.readline()).decode().strip()
            if not h:
                break
            k, v = h.split(":", 1)
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0"))
        body = await reader.readexactly(n) if n else b""
        parsed = urllib.parse.urlsplit(target)
        query = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query,
                                       keep_blank_values=True).items()}
        path = urllib.parse.unquote(parsed.path)
        return S3Request(method, path, query, headers, body)

    # -- auth (signature-v2-lite) ------------------------------------------

    # replay window for x-amz-date (the reference allows 15 min skew,
    # rgw_auth_s3.cc RGW_AUTH_GRACE)
    AUTH_GRACE_SECS = 900.0

    @staticmethod
    def _string_to_sign(method: str, path: str, query: Dict[str, str],
                        date: str, body: bytes) -> str:
        """Binds method, path, the FULL query string, the date, and a
        body digest (signing only method/path/date let one
        captured PUT signature replay forever with arbitrary content)."""
        # percent-encode keys/values so distinct query dicts can never
        # collide to one canonical string (e.g. {"a": "1&b=2"} vs
        # {"a": "1", "b": "2"})
        canon_q = "&".join(
            f"{urllib.parse.quote(k, safe='')}="
            f"{urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items()))
        return "\n".join([method, path, canon_q, date,
                          hashlib.sha256(body).hexdigest()])

    def _authenticate(self, req: S3Request) -> Optional[str]:
        """-> error string, or None when authorized."""
        if self.accounts is None:
            return None
        auth = req.headers.get("authorization", "")
        if not auth.startswith("AWS "):
            return "missing AWS authorization"
        try:
            access, sig = auth[4:].split(":", 1)
        except ValueError:
            return "malformed authorization"
        secret = self.accounts.get(access)
        if secret is None:
            return "unknown access key"
        date = req.headers.get("x-amz-date", "")
        try:
            skew = abs(time.time() - float(date))
        except ValueError:
            return "bad x-amz-date"
        # inverted comparison so a NaN date can never pass the window
        if not (skew <= self.AUTH_GRACE_SECS):
            return "request time too skewed"
        want = hmac.new(
            secret.encode(),
            self._string_to_sign(req.method, req.path, req.query,
                                 date, req.body).encode(),
            hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            return "signature mismatch"
        return None

    @classmethod
    def sign(cls, method: str, path: str, date: str, access: str,
             secret: str, body: bytes = b"",
             query: Optional[Dict[str, str]] = None) -> str:
        """Client-side signer (the boto analog for tests/tools)."""
        sig = hmac.new(
            secret.encode(),
            cls._string_to_sign(method, path, query or {}, date,
                                body).encode(),
            hashlib.sha256).hexdigest()
        return f"AWS {access}:{sig}"

    # -- REST dispatch (rgw_rest_s3.cc op table) ---------------------------

    async def _dispatch(self, req: S3Request):
        if req.path == "/swift/auth" and "x-auth-user" in req.headers:
            # tempauth's GET /auth/v1.0: X-Auth-User/X-Auth-Key in,
            # time-limited X-Auth-Token out.  Conditional on the tempauth
            # header so an S3 object at bucket 'swift', key 'auth' stays
            # reachable through the S3 path
            return self._swift_issue_token(req)
        if req.path == "/swift/v1" or req.path.startswith("/swift/v1/"):
            # exact-prefix guard: an S3 bucket named 'swift' with key
            # 'v1.txt' must stay on the S3 path (and its auth)
            return await self._dispatch_swift(req)
        err = self._authenticate(req)
        if err is not None:
            return "403 Forbidden", {}, self._error_xml(
                "AccessDenied", err)
        parts = req.path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        try:
            if not bucket:
                return await self._list_buckets()
            if not key:
                return await self._bucket_op(req, bucket)
            return await self._object_op(req, bucket, key)
        except FileNotFoundError as e:
            return "404 Not Found", {}, self._error_xml("NoSuchKey", str(e))
        except Exception as e:  # noqa: BLE001 — 500 with the error body
            return ("500 Internal Server Error", {},
                    self._error_xml("InternalError", repr(e)))

    # -- Swift API (the reference gateway's second protocol,
    #    rgw_rest_swift.cc: same RGW core, container/object dialect) ----

    def _swift_auth(self, req: S3Request) -> Optional[str]:
        """Swift tempauth-lite: X-Auth-Token =
        '<access>:<expiry>:<hmac(secret, access:expiry)>' — time-limited
        (the old static per-account token was valid forever).
        Tokens come from GET /swift/auth (tempauth's /auth/v1.0) or the
        swift_token helper."""
        if self.accounts is None:
            return None
        token = req.headers.get("x-auth-token", "")
        parts = token.split(":")
        if len(parts) != 3:
            return "missing or malformed X-Auth-Token"
        access, expiry, proof = parts
        secret = self.accounts.get(access)
        if secret is None:
            return "unknown account"
        try:
            if float(expiry) < time.time():
                return "token expired"
        except ValueError:
            return "malformed token expiry"
        want = hmac.new(secret.encode(),
                        f"{access}:{expiry}".encode(),
                        hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, proof):
            return "bad token"
        return None

    @staticmethod
    def swift_token(access: str, secret: str, ttl: float = 3600.0) -> str:
        expiry = f"{time.time() + ttl:.0f}"
        proof = hmac.new(secret.encode(), f"{access}:{expiry}".encode(),
                         hashlib.sha256).hexdigest()
        return f"{access}:{expiry}:{proof}"

    def _swift_issue_token(self, req: S3Request):
        user = req.headers.get("x-auth-user", "")
        key = req.headers.get("x-auth-key", "")
        secret = (self.accounts or {}).get(user)
        # compare as bytes: str compare_digest raises on non-ASCII input
        if secret is None or not hmac.compare_digest(
                secret.encode(), key.encode()):
            return "401 Unauthorized", {}, b"bad credentials"
        return "200 OK", {
            "X-Auth-Token": self.swift_token(user, secret),
            "X-Storage-Url": "/swift/v1",
        }, b""

    async def _dispatch_swift(self, req: S3Request):
        err = self._swift_auth(req)
        if err is not None:
            return "401 Unauthorized", {}, err.encode()
        # strip the prefix + ONE leading slash: a trailing '/' is part of
        # the object name (Swift pseudo-directory markers)
        rest = req.path[len("/swift/v1"):]
        if rest.startswith("/"):
            rest = rest[1:]
        parts = rest.split("/", 1)
        container = parts[0]
        obj = parts[1] if len(parts) > 1 else ""
        try:
            if not container:
                if req.method != "GET":
                    return "405 Method Not Allowed", {}, b""
                # account GET: newline-separated container listing
                names = await self.rgw.list_buckets()
                return ("200 OK", {"Content-Type": "text/plain"},
                        ("\n".join(names) + "\n").encode()
                        if names else b"")
            if not obj:
                return await self._swift_container_op(req, container)
            return await self._object_core(
                req, container, obj, meta_prefix="x-object-meta-",
                created_status="201 Created", quote_etag=False)
        except FileNotFoundError as e:
            return "404 Not Found", {}, str(e).encode()
        except ValueError as e:
            return "412 Precondition Failed", {}, str(e).encode()
        except OSError as e:
            if e.errno == 39:   # ENOTEMPTY: Swift's delete-conflict
                return "409 Conflict", {}, b"container not empty"
            raise
        except Exception as e:  # noqa: BLE001
            return "500 Internal Server Error", {}, repr(e).encode()

    async def _swift_container_op(self, req: S3Request, container: str):
        if req.method == "PUT":
            try:
                await self.rgw.create_bucket(container)
                return "201 Created", {}, b""
            except FileExistsError:
                return "202 Accepted", {}, b""
        if req.method == "DELETE":
            await self.rgw.delete_bucket(container)
            return "204 No Content", {}, b""
        if req.method in ("GET", "HEAD"):
            try:
                limit = int(req.query.get("limit", "10000"))
            except ValueError:
                raise ValueError("limit must be an integer")
            res = await self.rgw.list_objects(
                container,
                prefix=req.query.get("prefix", ""),
                marker=req.query.get("marker", ""),
                max_keys=limit)
            # the header is the container's TOTAL object count, not the
            # returned page's
            total = len((await self.rgw._index(container)))
            body = ("\n".join(m.key for m in res.keys)
                    + ("\n" if res.keys else "")).encode()
            hdrs = {"Content-Type": "text/plain",
                    "X-Container-Object-Count": str(total)}
            return "200 OK", hdrs, (b"" if req.method == "HEAD" else body)
        return "405 Method Not Allowed", {}, b""

    async def _object_core(self, req: S3Request, bucket: str, key: str,
                           meta_prefix: str, created_status: str,
                           quote_etag: bool):
        """Object verbs shared by BOTH protocol dialects (the reference
        routes S3 and Swift into the same RGWPutObj/RGWGetObj ops);
        dialects differ only in meta-header prefix, ETag quoting, and
        the created status line."""
        def etag_hdr(e):
            return f'"{e}"' if quote_etag else e

        if req.method == "PUT":
            user_meta = {k[len(meta_prefix):]: v
                         for k, v in req.headers.items()
                         if k.startswith(meta_prefix)}
            etag = await self.rgw.put_object(
                bucket, key, req.body,
                content_type=req.headers.get(
                    "content-type", "application/octet-stream"),
                user_meta=user_meta)
            return created_status, {"ETag": etag_hdr(etag)}, b""
        if req.method in ("GET", "HEAD"):
            meta = await self.rgw.head_object(bucket, key)
            hdrs = {
                "ETag": etag_hdr(meta.etag),
                "Content-Type": meta.content_type,
                "Last-Modified": time.strftime(
                    "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(meta.mtime)),
            }
            for k, v in meta.user_meta.items():
                hdrs[meta_prefix.title().rstrip("-") + "-" + k] = v
            if req.method == "HEAD":
                hdrs["Content-Length"] = str(meta.size)
                return "200 OK", hdrs, b""
            _, data = await self.rgw.get_object(bucket, key)
            return "200 OK", hdrs, data
        if req.method == "DELETE":
            await self.rgw.delete_object(bucket, key)
            return "204 No Content", {}, b""
        return "405 Method Not Allowed", {}, b""

    @staticmethod
    def _error_xml(code: str, msg: str) -> bytes:
        return (f"<?xml version='1.0'?><Error><Code>{code}</Code>"
                f"<Message>{_xml_escape(msg)}</Message></Error>").encode()

    async def _list_buckets(self):
        names = await self.rgw.list_buckets()
        inner = "".join(
            f"<Bucket><Name>{_xml_escape(n)}</Name></Bucket>"
            for n in names)
        body = (f"<?xml version='1.0'?><ListAllMyBucketsResult>"
                f"<Buckets>{inner}</Buckets>"
                f"</ListAllMyBucketsResult>").encode()
        return "200 OK", {"Content-Type": "application/xml"}, body

    async def _bucket_op(self, req: S3Request, bucket: str):
        if req.method == "PUT":
            await self.rgw.create_bucket(bucket)
            return "200 OK", {}, b""
        if req.method == "DELETE":
            await self.rgw.delete_bucket(bucket)
            return "204 No Content", {}, b""
        if req.method == "GET":
            res = await self.rgw.list_objects(
                bucket,
                prefix=req.query.get("prefix", ""),
                marker=req.query.get("marker", ""),
                max_keys=int(req.query.get("max-keys", "1000")))
            rows = "".join(
                f"<Contents><Key>{_xml_escape(m.key)}</Key>"
                f"<Size>{m.size}</Size><ETag>&quot;{m.etag}&quot;</ETag>"
                f"</Contents>" for m in res.keys)
            trunc = "true" if res.is_truncated else "false"
            nm = (f"<NextMarker>{_xml_escape(res.next_marker)}</NextMarker>"
                  if res.next_marker else "")
            body = (f"<?xml version='1.0'?><ListBucketResult>"
                    f"<Name>{_xml_escape(bucket)}</Name>"
                    f"<IsTruncated>{trunc}</IsTruncated>{nm}{rows}"
                    f"</ListBucketResult>").encode()
            return "200 OK", {"Content-Type": "application/xml"}, body
        return "405 Method Not Allowed", {}, b""

    async def _object_op(self, req: S3Request, bucket: str, key: str):
        # -- multipart sub-protocol (rgw_op.cc multipart ops), served
        #    by the DURABLE core: the upload registry lives
        #    in RADOS, so a frontend restart mid-upload loses nothing
        #    and reclaim_multipart can always finish an interrupted
        #    complete/abort --
        if "uploads" in req.query and req.method == "POST":
            upload_id = await self.rgw.create_multipart(bucket, key)
            body = (f"<?xml version='1.0'?><InitiateMultipartUploadResult>"
                    f"<Bucket>{_xml_escape(bucket)}</Bucket>"
                    f"<Key>{_xml_escape(key)}</Key>"
                    f"<UploadId>{upload_id}</UploadId>"
                    f"</InitiateMultipartUploadResult>").encode()
            return "200 OK", {"Content-Type": "application/xml"}, body
        if "uploadId" in req.query:
            return await self._multipart_op(req, bucket, key,
                                            req.query["uploadId"])

        return await self._object_core(
            req, bucket, key, meta_prefix="x-amz-meta-",
            created_status="200 OK", quote_etag=True)

    # -- multipart ---------------------------------------------------------

    async def _multipart_op(self, req: S3Request, bucket: str, key: str,
                            upload_id: str):
        try:
            if req.method == "PUT":
                n = int(req.query["partNumber"])
                etag = await self.rgw.upload_part(bucket, key,
                                                  upload_id, n, req.body)
                return "200 OK", {"ETag": f'"{etag}"'}, b""
            if req.method == "POST":
                etag = await self.rgw.complete_multipart(bucket, key,
                                                         upload_id)
                body = (f"<?xml version='1.0'?>"
                        f"<CompleteMultipartUploadResult>"
                        f"<Key>{_xml_escape(key)}</Key>"
                        f"<ETag>&quot;{etag}&quot;</ETag>"
                        f"</CompleteMultipartUploadResult>").encode()
                return ("200 OK", {"Content-Type": "application/xml"},
                        body)
            if req.method == "DELETE":   # abort
                await self.rgw.abort_multipart(bucket, key, upload_id)
                return "204 No Content", {}, b""
        except FileNotFoundError:
            return "404 Not Found", {}, self._error_xml(
                "NoSuchUpload", upload_id)
        return "405 Method Not Allowed", {}, b""
