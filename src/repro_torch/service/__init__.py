"""Campaign service: multi-tenant streaming optimization as a service
(port of ``repro/service``).  Independent jobs are admitted as they
arrive, join a running bucketed segment family at its boundaries without a
new program, retire early, stream results, and survive crashes through
snapshots (``service/server.py``)."""
from repro_torch.service.allocator import SlotAllocator, lane_key  # noqa: F401
from repro_torch.service.queue import (AdmissionQueue,  # noqa: F401
                                       CampaignRequest, CampaignTicket,
                                       QueueFull, JOB_CANCELLED, JOB_DONE,
                                       JOB_EXPIRED, JOB_QUARANTINED,
                                       JOB_QUEUED, JOB_REJECTED, JOB_RUNNING,
                                       JOB_SHED, TERMINAL_STATUSES)
from repro_torch.service.server import (CampaignServer,  # noqa: F401
                                        FitnessRegistry, run_service_single)
