"""CephX-lite: mon-issued time-limited tickets, per-entity keys,
per-session signing keys, and capability enforcement.

Behavioral analog of the reference cephx protocol
(src/auth/cephx/CephxProtocol.h:412 CephXTicketBlob/CephXAuthorizer,
CephxServiceHandler.h:23): the monitor authenticates an entity with its
per-entity key and issues a TICKET — {entity, caps, session key, expiry}
sealed under the SERVICE key — which services validate OFFLINE (no mon
round-trip per connection, cephx's core design).  A connection presents
the ticket plus an authorizer proof of the session key; all subsequent
frames on the session are HMAC-signed with the session key.

Lite-ness, documented: (a) per-entity keys derive from the cluster
master key (HMAC(master, entity)) instead of a provisioned keyring — the
keys are still distinct per entity and never travel in clear, but there
is no external keyring file; (b) sealing uses an HMAC-SHA256 keystream
(hashlib/hmac are the only crypto primitives in this environment)
instead of AES; (c) "rotation" is ticket expiry + renewal rather than
rotating service keys.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

SIG_LEN = 16


# -- key derivation ---------------------------------------------------------

def entity_key(master: bytes, name: str) -> bytes:
    """Per-entity secret (keyring analog): distinct per entity name."""
    return hmac.new(master, b"entity:" + name.encode(),
                    hashlib.sha256).digest()


def service_key(master: bytes) -> bytes:
    """Shared mon/daemon key sealing tickets (the rotating service
    secret's stand-in)."""
    return hmac.new(master, b"service", hashlib.sha256).digest()


# -- sealed boxes (HMAC-CTR keystream + MAC) --------------------------------

def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += hmac.new(key, nonce + ctr.to_bytes(8, "big"),
                        hashlib.sha256).digest()
        ctr += 1
    return out[:n]


def seal(key: bytes, obj) -> bytes:
    """Encrypt-then-MAC a pickled payload."""
    plain = pickle.dumps(obj)
    nonce = os.urandom(16)
    ks = _keystream(key, nonce, len(plain))
    ct = bytes(a ^ b for a, b in zip(plain, ks))
    mac = hmac.new(key, nonce + ct, hashlib.sha256).digest()[:SIG_LEN]
    return nonce + ct + mac


def unseal(key: bytes, blob: bytes):
    """Verify + decrypt; raises ValueError on tamper/garbage."""
    if len(blob) < 16 + SIG_LEN:
        raise ValueError("short sealed blob")
    nonce, ct, mac = blob[:16], blob[16:-SIG_LEN], blob[-SIG_LEN:]
    want = hmac.new(key, nonce + ct, hashlib.sha256).digest()[:SIG_LEN]
    if not hmac.compare_digest(mac, want):
        raise ValueError("sealed blob MAC mismatch")
    ks = _keystream(key, nonce, len(ct))
    return pickle.loads(bytes(a ^ b for a, b in zip(ct, ks)))


# -- tickets ----------------------------------------------------------------

@dataclass
class Ticket:
    """CephXTicketBlob analog (the decrypted view)."""

    entity: str
    caps: Dict[str, str]          # service -> "r" | "rw" | ""
    session_key: bytes = b""
    valid_until: float = 0.0

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.time()) > self.valid_until


def issue_ticket(master: bytes, entity: str, caps: Dict[str, str],
                 ttl: float) -> Tuple[bytes, bytes, bytes]:
    """Mon side: -> (ticket_blob sealed under the service key,
    session_key sealed under the ENTITY key, session_key) — the client
    can open only the second; services only the first
    (CephxServiceHandler::handle_request)."""
    skey = os.urandom(32)
    t = Ticket(entity=entity, caps=dict(caps), session_key=skey,
               valid_until=time.time() + ttl)
    blob = seal(service_key(master), t)
    for_client = seal(entity_key(master, entity), skey)
    return blob, for_client, skey


def validate_ticket(master: bytes, blob: bytes) -> Ticket:
    """Service side, OFFLINE: unseal + expiry check; raises ValueError
    for tampered/expired tickets."""
    t = unseal(service_key(master), blob)
    if not isinstance(t, Ticket):
        raise ValueError("not a ticket")
    if t.expired():
        raise ValueError(f"ticket for {t.entity} expired")
    return t


# -- authorizers (per-connection proof of the session key) ------------------

def make_authorizer(ticket_blob: bytes, session_key: bytes) -> bytes:
    """Fixed binary layout (u32 ticket_len | ticket | nonce16 | proof16):
    an authorizer arrives on an UNauthenticated connection, so its outer
    framing must be parseable without a deserializer; the only pickled
    content sits inside the sealed ticket, whose MAC `unseal` verifies
    before decoding."""
    nonce = os.urandom(16)
    proof = hmac.new(session_key, b"authorizer:" + nonce,
                     hashlib.sha256).digest()[:SIG_LEN]
    return struct.pack("<I", len(ticket_blob)) + ticket_blob + nonce + proof


def verify_authorizer(master: bytes, authorizer: bytes) -> Ticket:
    """Service side: validate the ticket, then the possession proof.
    Returns the ticket (entity + caps + session key) on success."""
    if len(authorizer) < 4:
        raise ValueError("short authorizer")
    (tl,) = struct.unpack_from("<I", authorizer)
    if len(authorizer) != 4 + tl + 16 + SIG_LEN:
        raise ValueError("malformed authorizer")
    ticket = authorizer[4:4 + tl]
    nonce = authorizer[4 + tl:4 + tl + 16]
    proof = authorizer[4 + tl + 16:]
    t = validate_ticket(master, ticket)
    want = hmac.new(t.session_key, b"authorizer:" + nonce,
                    hashlib.sha256).digest()[:SIG_LEN]
    if not hmac.compare_digest(proof, want):
        raise ValueError("authorizer proof mismatch")
    return t


# -- capability checks ------------------------------------------------------

def allows(caps: Dict[str, str], service: str, access: str) -> bool:
    """access "r" or "rw" against this entity's grant for a service
    (MonCap/OSDCap's role, radically simplified to r/rw grants)."""
    grant = caps.get(service, "")
    if access == "r":
        return "r" in grant
    return grant == "rw" or "w" in grant


DEFAULT_CAPS = {
    # entity-type prefix -> caps granted by the mon at authentication
    # (reference: default profiles, e.g. 'profile osd')
    "client": {"mon": "r", "osd": "rw", "mds": "rw"},
    "osd": {"mon": "rw", "osd": "rw"},
    "mon": {"mon": "rw", "osd": "rw"},
    "mds": {"mon": "rw", "osd": "rw", "mds": "rw"},
    "mgr": {"mon": "rw", "osd": "r"},
}


def default_caps_for(entity: str) -> Dict[str, str]:
    if entity == "client.admin":
        # the admin keyring's 'allow *' analog
        return {"mon": "rw", "osd": "rw", "mds": "rw"}
    kind = entity.split(".", 1)[0]
    return dict(DEFAULT_CAPS.get(kind, {"mon": "r"}))


class CephxContext:
    """Per-messenger auth state.

    Daemons hold the cluster MASTER key and self-issue their tickets
    (they could mint anything anyway — possession of the master key IS
    cluster membership, as with the reference's mon./osd. keyring
    entries).  Clients hold only their per-entity key and must bootstrap
    a ticket from a monitor (Messenger.cephx_bootstrap)."""

    def __init__(self, entity: str, master: Optional[bytes] = None,
                 entity_secret: Optional[bytes] = None,
                 ttl: float = 3600.0,
                 caps: Optional[Dict[str, str]] = None):
        self.entity = entity
        self.master = master
        self.entity_secret = entity_secret if entity_secret is not None \
            else (entity_key(master, entity) if master else None)
        self.ttl = ttl
        self.caps = caps
        self.ticket_blob: Optional[bytes] = None
        self.session_key: Optional[bytes] = None
        self.valid_until: float = 0.0

    def ticket_expired(self) -> bool:
        return time.time() > self.valid_until - 1.0

    def ensure_ticket(self) -> None:
        """Self-issue (master holders); clients must have bootstrapped."""
        if self.ticket_blob is not None and not self.ticket_expired():
            return
        if self.master is None:
            raise PermissionError(
                f"{self.entity}: no valid ticket (bootstrap from a mon)")
        self.ticket_blob, _, self.session_key = issue_ticket(
            self.master, self.entity,
            self.caps or default_caps_for(self.entity), self.ttl)
        self.valid_until = time.time() + self.ttl

    def adopt(self, ticket_blob: bytes, sealed_key: bytes,
              ttl_hint: float) -> None:
        """Client side: accept a mon-issued ticket."""
        self.session_key = unseal(self.entity_secret, sealed_key)
        self.ticket_blob = ticket_blob
        self.valid_until = time.time() + ttl_hint
