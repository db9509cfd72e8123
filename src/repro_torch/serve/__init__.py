"""The serve stack of the port: the continuous-batching engine over the
paged KV arena and its framework-free copies (queue, scheduler, page
allocator, metrics and the event trace). Counterpart of ``repro.serve``
for eager reservation and synchronous ticks; the slot arena, lazy
reservation, the host tier, async ticks, the simulator and the fleet are
not ported yet (ROADMAP A9-A11)."""

from repro_torch.serve.engine import COMBINE_MODES, TICK_MODES, ContinuousEngine
from repro_torch.serve.metrics import RequestTimeline, ServeMetrics, TickRecord
from repro_torch.serve.obs import (Event, EventTrace, Log2Histogram, TickTimer, TickTiming,
                                   fold_counters)
from repro_torch.serve.queue import ArrivalQueue, ServeRequest
from repro_torch.serve.scheduler import (PassRow, Scheduler, TickPlan, bucket_pow2,
                                         provision_growth)
from repro_torch.serve.state import (ContentPrefixRegistry, HostPagePool, PageAllocator,
                                     PrefixShareRegistry, StatePool, content_key,
                                     kv_page_bytes, page_nbytes, pages_for,
                                     pages_for_pool_bytes, plan_swap_out,
                                     stream_page_needs)

__all__ = [
    "COMBINE_MODES", "TICK_MODES", "ContinuousEngine", "RequestTimeline", "ServeMetrics",
    "TickRecord", "Event", "EventTrace", "Log2Histogram", "TickTimer", "TickTiming",
    "fold_counters", "ArrivalQueue", "ServeRequest", "PassRow", "Scheduler", "TickPlan",
    "bucket_pow2", "provision_growth", "ContentPrefixRegistry", "HostPagePool",
    "PageAllocator", "PrefixShareRegistry", "StatePool", "content_key", "kv_page_bytes",
    "page_nbytes", "pages_for", "pages_for_pool_bytes", "plan_swap_out", "stream_page_needs",
]
