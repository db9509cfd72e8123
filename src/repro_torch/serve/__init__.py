"""The serve stack of the port: the continuous-batching engine over the slot
or paged KV arena (eager or lazy reservation, the host tier, the content
prefix cache, sync or async ticks, ``pass_budget="auto"``), the
framework-free copies (queue, scheduler, page allocator, metrics and the
event trace), the budget autotuner, the offline simulator, ``ServeFleet``
with the fleet router and simulator, and the Chrome-trace export.
The pooled arenas' partition-spec helpers place the pools on a mesh
(``repro_torch.dist``). Counterpart of ``repro.serve``."""

from repro_torch.serve.autotune import BudgetAutotuner
from repro_torch.serve.engine import COMBINE_MODES, TICK_MODES, ContinuousEngine
from repro_torch.serve.fleet import (FLEET_COUNTERS, ROUTE_POLICIES, FleetReport,
                                     FleetRouter, ServeFleet, fleet_summary, simulate_fleet)
from repro_torch.serve.metrics import RequestTimeline, ServeMetrics, TickRecord
from repro_torch.serve.obs import (Event, EventTrace, Log2Histogram, TickTimer, TickTiming,
                                   fleet_chrome_trace, fold_counters, to_chrome_trace,
                                   write_chrome_trace)
from repro_torch.serve.queue import ArrivalQueue, ServeRequest
from repro_torch.serve.scheduler import (PassRow, Scheduler, TickPlan, admission_cutoff,
                                         bucket_pow2, provision_growth, victim_key)
from repro_torch.serve.sim import (SimRequest, compare_policies, poisson_arrivals,
                                   poisson_trace, simulate)
from repro_torch.serve.state import (ContentPrefixRegistry, HostPagePool, PageAllocator,
                                     PrefixShareRegistry, StatePool, content_key,
                                     fresh_lazy_needs, host_pages_for_bytes, kv_page_bytes,
                                     page_nbytes, paged_partition_specs, paged_pool_shardings,
                                     pages_for, pages_for_pool_bytes, pages_shard_count,
                                     plan_swap_out, pool_partition_specs, pooled_cache_axes,
                                     resume_lazy_needs, stream_page_needs)

__all__ = [
    "ArrivalQueue", "BudgetAutotuner", "COMBINE_MODES", "ContentPrefixRegistry", "ContinuousEngine", "Event",
    "EventTrace", "FLEET_COUNTERS", "FleetReport", "FleetRouter", "HostPagePool",
    "Log2Histogram", "PageAllocator", "PassRow", "PrefixShareRegistry", "ROUTE_POLICIES",
    "RequestTimeline", "Scheduler", "ServeFleet", "ServeMetrics", "ServeRequest", "SimRequest", "StatePool",
    "TICK_MODES", "TickPlan", "TickRecord", "TickTimer", "TickTiming", "admission_cutoff",
    "bucket_pow2", "compare_policies", "content_key", "fleet_chrome_trace", "fleet_summary",
    "fold_counters", "fresh_lazy_needs", "host_pages_for_bytes", "kv_page_bytes",
    "page_nbytes", "paged_partition_specs", "paged_pool_shardings", "pages_for",
    "pages_for_pool_bytes", "pages_shard_count", "plan_swap_out", "poisson_arrivals",
    "poisson_trace", "pool_partition_specs", "pooled_cache_axes", "provision_growth", "resume_lazy_needs", "simulate", "simulate_fleet",
    "stream_page_needs", "to_chrome_trace", "victim_key", "write_chrome_trace",
]
