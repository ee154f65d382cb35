"""The request-routing plane (counterpart of ``ringpop_tpu/models/route``).

- :mod:`ring_kernel` — the incremental hash-prefix-bucketed ring;
- :mod:`traffic` — Zipf traffic (threefry draws, :mod:`..ops.threefry`);
- :mod:`reqtrace` — sampled per-request trace records;
- :mod:`plane` — the routing tick and the :class:`~plane.RoutedStorm`
  driver over the scalable churn storm.
"""

from ringpop_tpu_torch.models.route.plane import (  # noqa: F401
    RoutedStorm,
    RouteMetrics,
    RouteParams,
    RouteState,
    init_route_state,
    resolve_ring_impl,
    resolve_route_params,
    route_tick,
)
from ringpop_tpu_torch.models.route.ring_kernel import (  # noqa: F401
    RingBuckets,
    RingState,
    build_buckets,
    default_bucket_bits,
    full_rebuild,
    lookup,
    lookup_n_fixed,
    materialize,
    update,
)
