"""Mesh-level convenience API for distributed polynomial pipelines.

The framework's three parallel axes (SURVEY.md §2 closing note):
  * "batch" — data parallelism over leading batch dims of Poly tensors;
  * "rns"   — tensor parallelism over RNS residue channels (the reference's
              independent `cm` loops, core.hpp:597,610, as a mesh axis);
  * "deg"   — degree (sequence-parallel analog) via the four-step NTT
              (ntt_dist.py), whose only communication is an all-to-all.

batch/rns sharding is zero-communication: every op in ops/modops.py and the
NTT is elementwise or within-channel, so jit with NamedSharding
propagates the sharding with no collectives.
"""
from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..poly import Poly


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kw):
    """Multi-host entry point: initialize the JAX distributed runtime so
    jax.devices() spans every host's devices and shard_map collectives
    span them.

    Call once per process before any other JAX API, mirroring
    jax.distributed.initialize's contract.  Arguments default to the
    standard environment (JAX_COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID, or the cluster's automatic discovery when all are None).  Returns (process_index, process_count).

    The reference has no multi-process story at all (its only scaling axis
    is SIMD width, SURVEY.md §2 note); this is the slot for it.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id, **kw)
    return jax.process_index(), jax.process_count()


def make_mesh(shape=None, axis_names=("batch", "rns", "deg"), devices=None):
    """Build a Mesh over the available devices.

    shape=None factors the device count over the given axes (powers of two
    round-robin, mirroring __graft_entry__.dryrun_multichip)."""
    devices = list(jax.devices() if devices is None else devices)
    if shape is None:
        ndev = len(devices)
        sizes = [1] * len(axis_names)
        i = 0
        while ndev % 2 == 0 and ndev > 1:
            sizes[i % len(axis_names)] *= 2
            ndev //= 2
            i += 1
        sizes[0] *= ndev
        shape = tuple(sizes)
    count = int(np.prod(shape))
    return Mesh(np.array(devices[:count]).reshape(shape), axis_names)


def poly_sharding(mesh: Mesh, batch_axes=("batch",), rns_axis="rns",
                  batch_ndim=1) -> NamedSharding:
    """NamedSharding for a [batch..., m, n] Poly tensor: batch dims over the
    batch axes, channels over `rns`, coefficients replicated."""
    spec = list(batch_axes[:batch_ndim])
    spec += [None] * (batch_ndim - len(spec))
    spec += [rns_axis, None]
    return NamedSharding(mesh, P(*spec))


def shard_poly(p: Poly, mesh: Mesh, **kw) -> Poly:
    """Place a Poly's residue tensor with poly_sharding."""
    batch_ndim = len(p.batch_shape)
    sh = poly_sharding(mesh, batch_ndim=batch_ndim, **kw)
    return Poly(jax.device_put(p.data, sh), p.ring)
