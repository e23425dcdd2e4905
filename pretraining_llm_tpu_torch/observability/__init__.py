"""Run-wide observability: events, spans, goodput, metrics, device memory
and build telemetry for training, and request traces, capacity and SLOs
for the online server (the JAX package's ``observability/``).

  - events.py   stamped run events on an ``EventBus`` (in-process
                subscribers and an optional JSONL sink); the rest of the
                package folds over that stream;
  - spans.py    nested host timers exported as Chrome trace-event JSON;
                the serving engine's dispatch, reap and host-blocked spans
                land in the module's default recorder;
  - goodput.py  folds the event stream into productive / replay / eval /
                checkpoint / restore / idle / other wall seconds;
  - metrics.py  typed counters, gauges and histograms;
  - export.py   the Prometheus textfile (atomic write) and its lint;
  - device.py   ``torch.cuda`` memory samples and the port's kernel builds
                as compile telemetry;
  - hub.py      ``ObservabilityHub``, what the trainer wires in;
  - tracing.py  per-request span trees (W3C ``traceparent``) on the
                spans recorder's virtual tracks;
  - capacity.py the serving engine's occupancy sampler and scheduler
                decision log;
  - sketches.py mergeable, windowed percentile sketches;
  - slo.py      the live SLO engine: error budgets and burn-rate alerts
                over the ``req_*`` events.

Everything is host-side; nothing here syncs the device between log
boundaries. ``python -m pretraining_llm_tpu_torch.obs_report`` reads the
JSONL this package writes.
  - clocksync.py the min-RTT offset estimator that maps a worker
                process's span timestamps onto the router's clock.
"""

from pretraining_llm_tpu_torch.observability.clocksync import ClockSync  # noqa: F401
