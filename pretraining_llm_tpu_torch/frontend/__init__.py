"""Online serving front end: the request-lifecycle layer over ServingEngine
(the JAX package's ``frontend/``).

The engine (generation/serving.py) is a scheduler: it knows rows, pages
and windows, but nothing about arrival, waiting clients, deadlines or
load. This package adds the online half:

  engine_loop  — a long-lived thread driving ``ServingEngine.pipeline_tick``
                 that drains a submission inbox, admits requests mid-flight
                 between scheduler turns, streams committed tokens to
                 per-request queues, and applies cancellation/deadlines
                 (releasing rows and pool blocks immediately);
  admission    — backpressure policy: bounded in-system request depth and
                 an outstanding-token budget (-> 429 Retry-After), plus
                 deadline-aware shedding of requests that cannot finish in
                 time (-> 504);
  gateway      — a stdlib ThreadingHTTPServer exposing POST /v1/generate
                 (JSON in; full response or SSE token streaming out),
                 GET /healthz, /readyz, /metrics, /slo, /metricsz and the
                 /debug views;
  loadgen      — open-loop (Poisson) and closed-loop load generators
                 reporting TTFT/TPOT/e2e percentiles and goodput-under-SLO,
                 and timed fleet plans (kill, drain, restore, upgrade);
  replica      — one restartable engine replica (engine factory +
                 EngineLoop + per-replica registry/admission/fault clock);
  router       — the fleet tier over N replicas: prefix-affinity routing
                 with spill, health-based ejection with backoff, brownout
                 shedding, drain/redrive of in-flight requests, golden
                 probes and disaggregated prefill;
  journal      — the router's write-ahead journal, replayed by --recover;
  kv_transfer  — KV pages of a cached prefix serialized, framed, verified
                 and adopted into another replica's pool;
  wire         — length-prefixed JSON frames, the worker socket protocol;
  worker       — one replica in a process of its own behind a socket
                 (``python -m pretraining_llm_tpu_torch.frontend.worker``),
                 spawned by its parent or started with ``--listen``;
  remote_replica — the parent's side of a worker, presented to the router
                 as a replica: timeouts, retries, leases, fencing, clock
                 sync, KV-page fetch and push, the process fault drills.

``python -m pretraining_llm_tpu_torch.serve --http`` wires them over one
engine, with ``--replicas N`` over N replicas in this process, or with
``--replica_mode process`` over worker processes. ``WorkerServer`` is
imported from ``frontend.worker`` itself: the package must not import the
module that ``python -m`` runs.
"""

from pretraining_llm_tpu_torch.frontend.admission import (  # noqa: F401
    AdmissionController,
    RejectedBusy,
    RejectedInfeasible,
)
from pretraining_llm_tpu_torch.frontend.engine_loop import (  # noqa: F401
    EngineLoop,
    FrontendRequest,
)
from pretraining_llm_tpu_torch.frontend.gateway import ServingGateway  # noqa: F401
from pretraining_llm_tpu_torch.frontend.loadgen import (  # noqa: F401
    FleetAction,
    LoadReport,
    LoadSpec,
    build_schedule,
    rolling_restart_plan,
    run_engine_loop,
    run_fleet_plan,
    run_http,
)
from pretraining_llm_tpu_torch.frontend.replica import (  # noqa: F401
    Replica,
    ReplicaUnavailable,
)
from pretraining_llm_tpu_torch.frontend.router import (  # noqa: F401
    Router,
    RouterRequest,
)
from pretraining_llm_tpu_torch.frontend.remote_replica import RemoteReplica  # noqa: F401
from pretraining_llm_tpu_torch.frontend.wire import (  # noqa: F401
    MAX_FRAME_BYTES,
    PROTO_VERSION,
    ConnectionLost,
    ProtocolError,
    encode_frame,
    recv_frame,
    send_frame,
)
