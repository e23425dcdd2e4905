"""Resilience: from fault detection to recovery, the port's copy of
``pretraining_llm_tpu/resilience/``.

  - anomaly.py    rolling-window detector over the log-boundary metrics the
                  trainer already fetched (NaN/Inf, loss spike, grad spike);
  - rollback.py   on an anomaly: restore the newest good checkpoint, move the
                  data frontier past the poison window, cool down, spend a
                  bounded budget;
  - watchdog.py   host thread that notices steps stopped completing, dumps
                  every thread's stack, attempts an emergency checkpoint and
                  exits EXIT_WEDGED;
  - faults.py     deterministic fault drills (``nan``, ``sigterm``, ``hang``,
                  ``ckpt_truncate``) so every recovery path runs in tests;
  - integrity.py  the serving engine's KV page digests.

``pretraining_llm_tpu_torch/supervisor.py`` is the out-of-process half: it
relaunches the training command by these return codes:

  0              clean completion: not relaunched;
  EXIT_PREEMPTED SIGTERM stop, checkpoint written: relaunched at once;
  EXIT_ANOMALY   rollback budget spent, or an anomaly with no loadable
                 checkpoint: fatal, never relaunched;
  EXIT_WEDGED    the watchdog fired on a hung step: relaunched with backoff;
  anything else  a crash: relaunched with backoff.
"""

EXIT_CLEAN = 0
EXIT_PREEMPTED = 43
EXIT_ANOMALY = 44
EXIT_WEDGED = 45
