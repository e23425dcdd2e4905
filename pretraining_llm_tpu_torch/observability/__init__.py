"""Run-wide observability for training: events, spans, goodput, metrics,
device memory and build telemetry (the training side of the JAX package's
``observability/``).

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
  - hub.py      ``ObservabilityHub``, what the trainer wires in.

Everything is host-side; nothing here syncs the device between log
boundaries. ``scripts/obs_report.py`` reads the JSONL this package writes.
The serving fleet's pieces (request traces, capacity, SLOs, sketches,
clock sync) are not ported.
"""
