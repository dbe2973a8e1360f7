"""Cross-request serving: the query scheduler in front of the fused kernel."""

from lazzaro_tpu_torch.serve.scheduler import (QueryScheduler,
                                               RetrievalRequest,
                                               RetrievalResult)

__all__ = ["QueryScheduler", "RetrievalRequest", "RetrievalResult"]
