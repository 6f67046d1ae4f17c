"""ErasureCodeInterface: the contract every codec implements.

Behavioral mirror of reference src/erasure-code/ErasureCodeInterface.h:170-462
(copy of ``ceph_tpu/ec/interface.py``).
Chunks are numpy uint8 arrays keyed by chunk id (0..k+m-1, post-mapping);
profiles are str->str dicts exactly like the reference's ErasureCodeProfile.
"""

from __future__ import annotations

import abc
from typing import Dict, Iterable, List, Mapping, Set, Tuple

import numpy as np

ErasureCodeProfile = Dict[str, str]


class ECError(Exception):
    """Raised where the reference returns a negative errno."""

    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(f"errno {errno_}: {msg}")
        self.errno = errno_


class ErasureCodeInterface(abc.ABC):
    """Abstract codec API (reference ErasureCodeInterface.h:170-462)."""

    @abc.abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from a profile; raises ECError on invalid parameters."""

    @abc.abstractmethod
    def get_profile(self) -> ErasureCodeProfile:
        ...

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Chunk size for a given object size, honoring alignment rules."""

    @abc.abstractmethod
    def get_chunk_mapping(self) -> List[int]:
        ...

    @abc.abstractmethod
    def minimum_to_decode(
        self, want_to_read: Set[int], available_chunks: Set[int]
    ) -> Set[int]:
        """Minimum chunk set needed to reconstruct want_to_read."""

    def minimum_to_decode_with_cost(
        self, want_to_read: Set[int], available: Mapping[int, int]
    ) -> Set[int]:
        return self.minimum_to_decode(want_to_read, set(available))

    @abc.abstractmethod
    def encode(
        self, want_to_encode: Iterable[int], data: bytes
    ) -> Dict[int, np.ndarray]:
        """Split + pad ``data`` and produce the requested chunks."""

    @abc.abstractmethod
    def encode_chunks(self, chunks: Dict[int, np.ndarray]) -> None:
        """In-place: fill coding chunks from data chunks (all k+m present)."""

    @abc.abstractmethod
    def decode(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        """Reconstruct the wanted chunk ids from the available ``chunks``."""

    @abc.abstractmethod
    def decode_chunks(
        self,
        want_to_read: Set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        """In-place reconstruction given pre-allocated output chunks."""

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        """Reconstruct and concatenate the data chunks in mapped order."""
        want = {self.chunk_index(i) for i in range(self.get_data_chunk_count())}
        decoded = self.decode(want, chunks)
        out = b"".join(
            decoded[self.chunk_index(i)].tobytes()
            for i in range(self.get_data_chunk_count())
        )
        return out

    def chunk_index(self, i: int) -> int:
        mapping = self.get_chunk_mapping()
        return mapping[i] if len(mapping) > i else i

    # Batched device path (extension; not in the reference API).
    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(batch, k, chunk) uint8 -> (batch, m, chunk) parity on device."""
        raise NotImplementedError

    def decode_batch(
        self, erasures: Tuple[int, ...], chunks: np.ndarray
    ) -> np.ndarray:
        """Reconstruct erased chunks for a batch sharing one erasure pattern."""
        raise NotImplementedError
