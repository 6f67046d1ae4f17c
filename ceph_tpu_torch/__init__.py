"""PyTorch/CUDA port of ceph_tpu's erasure-code hot path.

The package mirrors ``ceph_tpu``'s module names (``ops/gf8.py``,
``ec/codec.py``, ``ec/stripe.py``, ...) so each counterpart is easy to
find, but it imports nothing of ``ceph_tpu`` and nothing of JAX: what it
needs from the reference package it keeps as its own copy.

Entry points run on the CUDA card by default (``ec.factory(profile)``);
only an explicit ``device="cpu"`` runs the plain PyTorch versions of the
kernels, which is how the CPU tests hold the port against the reference.
"""
