# Zero-sync round telemetry: typed per-round records (record.py), the
# device ring buffer (ringbuf.py), host-side metrics channels
# (metrics.py), stage spans (trace.py), and the JSONL sink and run
# manifest (sink.py).
from repro_torch.obs.record import (  # noqa: F401
    SCALAR_KEYS, VECTOR_KEYS, RoundTelemetry, round_scalars,
    sign_agreement, to_row,
)
from repro_torch.obs.ringbuf import (  # noqa: F401
    TelemetryRing, flush, ring_init, ring_push,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, MetricsRegistry, ReservoirHistogram,
)
from repro_torch.obs.trace import STAGES, StageTrace, stage_scope  # noqa: F401
from repro_torch.obs.sink import (  # noqa: F401
    JsonlSink, config_hash, git_sha, read_jsonl, run_manifest,
)
