"""Chaos data plane: deterministic network fault injection, the port's
copy of ``rabit_tpu/chaos/``.

An in-process TCP proxy (:mod:`rabit_tpu_torch.chaos.proxy`) sits between
workers and the tracker or their peers and executes a declarative, seeded
schedule (:mod:`rabit_tpu_torch.chaos.schedule`) of delays, mid-transfer
connection resets, partial writes, temporary partitions, tracker
blackouts, tracker kills and partitions, and bit flips -- so every
recovery path can be exercised deterministically from pytest, without
real hardware faults.

The launcher integrates it end to end: ``tracker.launch.launch(...,
chaos=spec)`` interposes one proxy in front of the tracker and one per
worker link listener (the tracker rewrites advertised peer addresses
through them). The front proxy's ``tracker_kill`` crashes the tracker
through the launcher's supervisor, and ``retarget`` repoints it at a
promoted hot standby (``tracker/standby.py``).

A ``job_storm`` rule fires its rogue ``submit`` connections at the
multi-job tracker's front (``proxy.run_job_storm``). ``python -m
rabit_tpu_torch.chaos --smoke`` runs one round of each of the reset,
tracker_kill, tracker_partition, bitflip and job_storm rules
(``__main__.py``). Stdlib-only.
"""

from .schedule import Rule, Schedule  # noqa: F401  (re-export)
from .proxy import ChaosProxy  # noqa: F401  (re-export)
