"""Per-host product staging and sub-box ownership (counterpart of
pinocchio_tpu/parallel/multihost.py, without the process layer).

The reference's process model is MPI_Init and the hypercube exchange of the
products (pinocchio.c:41-52, distribute.c:58-175).  Here a host owns the
fragmentation sub-boxes dealt to it round-robin and takes its products from
the exchange (parallel/exchange.py), or, where the exchange does not apply,
from its own devices' shards of the deferred hand-off.  One process mocks
the hosts of a cluster as contiguous blocks of the mesh's flat device
order (exchange.host_of_device_default).  Each host writes its outputs as
.out.<host> chunks through a staging directory of its own, and
scripts/torch_merge_chunks.py reassembles them.
"""

from __future__ import annotations

from typing import Callable

from ..fmax import ensure_host_products


def host_subboxes(geoms: list, host_id: int, nhosts: int) -> list:
    """Round-robin sub-box ownership (the task-to-sub-box assignment of
    initialization.c:995-1009)."""
    return geoms[host_id::nhosts]


def fetch_local_sparse(fmax_result, device_filter: Callable = None):
    """A host's share of the products: the needed rows of the shards whose
    mesh position i passes device_filter(i) (every shard when None), from
    the deferred hand-off of a mesh run, with global cell indices in the
    sweep's order and every displacement set.  Without a deferred hand-off
    (one device, a dump) the whole host products; a filter there raises."""
    handoff = fmax_result.handoff
    if handoff is None:
        if device_filter is not None:
            raise ValueError("a device filter needs a mesh run's deferred "
                             "hand-off")
        return ensure_host_products(fmax_result)
    from .driver import merge_parts
    own = [i for i in range(handoff.decomp.p)
           if device_filter is None or device_filter(i)]
    if not own:
        raise ValueError("the device filter keeps no shard")
    return merge_parts([handoff.shard_products(i) for i in own],
                       handoff.decomp.N)
