"""Uniform key=value configuration, mirroring the reference's parameter
system: registered env vars first, then argv overrides
(allreduce_base.cc:42-68 env list + SetParam chains .cc:182-217), with
B/K/M/G size-suffix parsing (.cc:156-176) and the documented parameter set
(doc/parameters.md:1-21).

The port's own copy of ``rabit_tpu/utils/config.py``; it adds
``RABIT_DEVICE`` (the torch engine's device) and ``RABIT_SLAVE_PORT``
(the native core's link port, which the port's launcher sets) to the env
list."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

# Env vars consulted at init, in reference order (allreduce_base.cc:42-49
# plus robust extras allreduce_robust.cc:34-35 and mock's DMLC_NUM_ATTEMPT,
# allreduce_mock.h:34-35).
ENV_VARS = [
    "DMLC_TASK_ID",
    "DMLC_ROLE",
    "DMLC_NUM_ATTEMPT",
    "DMLC_TRACKER_URI",
    "DMLC_TRACKER_PORT",
    "DMLC_WORKER_CONNECT_RETRY",
    "DMLC_WORKER_STOP_PROCESS_ON_ERROR",
    "RABIT_TASK_ID",
    "RABIT_TRACKER_URI",
    "RABIT_TRACKER_PORT",
    "RABIT_NUM_TRIAL",
    "RABIT_BOOTSTRAP_CACHE",
    "RABIT_DEBUG",
    "RABIT_SLAVE_PORT",
    "RABIT_DEVICE",
    "RABIT_ENGINE",
    "RABIT_DATAPLANE",
    "RABIT_DATAPLANE_MINBYTES",
    "RABIT_DATAPLANE_WIRE",
    "RABIT_DATAPLANE_WIRE_MINCOUNT",
    "RABIT_WIRE_BLOCK",
    "RABIT_WIRE_RS",
    "RABIT_WIRE_AG",
    "RABIT_WIRE_ADAPTIVE",
    "RABIT_REDUCE_METHOD",
    "RABIT_HIER",
    "RABIT_HIER_GROUP",
    "RABIT_HIER_PHASE_DEADLINE_SCALE",
    "RABIT_SKEW_ADAPT",
    "RABIT_SKEW_PREAGG_MS",
    "RABIT_SKEW_POLL_MS",
    "RABIT_TELEMETRY",
    "RABIT_TELEMETRY_BUFFER",
    "RABIT_TELEMETRY_EXPORT",
    "RABIT_PROFILE",
    "RABIT_PROFILE_MEMORY_POLL_MS",
    "RABIT_TRACKER_READY_TIMEOUT",
    "RABIT_DATAPLANE_INIT_TIMEOUT",
    "RABIT_DEADLINE_MS",
    "RABIT_DEADLINE_MS_PER_MB",
    "RABIT_WATCHDOG_ABORT",
    "RABIT_CKPT_DIR",
    "RABIT_CKPT_KEEP",
    "RABIT_CHAOS",
    "RABIT_METRICS_PORT",
    "RABIT_METRICS_POLL_MS",
    "RABIT_FLIGHT_DIR",
    "RABIT_FLIGHT_KEEP",
    "RABIT_EVENTS",
    "RABIT_EVENTS_BUFFER",
    "RABIT_INCIDENT_WINDOW_MS",
    "RABIT_WORLD_SIZE",
    "RABIT_RANK",
    "rabit_world_size",
    "rabit_reduce_ring_mincount",
    "rabit_reduce_buffer",
    "rabit_global_replica",
    "rabit_local_replica",
    "rabit_mock",
]

_SIZE_SUFFIX = {"B": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30}

# Keys where repeated argv occurrences accumulate instead of overriding
# (the reference accepts repeated ``mock=r,v,s,n``, allreduce_mock.h:38-44).
REPEATABLE_KEYS = frozenset({"rabit_mock", "mock"})


def parse_size(value: str) -> int:
    """Parse ``"256MB"``/``"1G"``/``"1024"`` into bytes
    (reference ParseUnit, allreduce_base.cc:156-176)."""
    s = str(value).strip().upper()
    if s.endswith("B") and len(s) > 1 and s[-2] in _SIZE_SUFFIX:
        s = s[:-1]
    if s and s[-1] in _SIZE_SUFFIX:
        return int(float(s[:-1]) * _SIZE_SUFFIX[s[-1]])
    return int(float(s))


class Config:
    """Case-normalised key=value store with env seeding and argv override."""

    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values: Dict[str, str] = {}
        if values:
            for k, v in values.items():
                self.set(k, v)

    @classmethod
    def from_args(cls, args: List[str], **kwargs) -> "Config":
        cfg = cls()
        for name in ENV_VARS:
            val = os.environ.get(name)
            if val is not None:
                cfg.set(name, val)
        for a in args:
            if "=" in a:
                k, v = a.split("=", 1)
                if cls._norm(k) in REPEATABLE_KEYS:
                    cfg.append(k, v)
                else:
                    cfg.set(k, v)
        for k, v in kwargs.items():
            cfg.set(k, v)
        return cfg

    @staticmethod
    def _norm(key: str) -> str:
        key = key.lower()
        # DMLC_* and RABIT_* env aliases collapse onto rabit_* keys, the way
        # the reference maps env names in SetParam (allreduce_base.cc:56-68).
        if key.startswith("dmlc_"):
            key = "rabit_" + key[len("dmlc_"):]
        return key

    def set(self, key: str, value) -> None:
        self._values[self._norm(key)] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._values.get(self._norm(key), default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else int(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return v.lower() in ("1", "true", "yes", "on")

    def get_size(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else parse_size(v)

    def get_all(self, key: str) -> List[str]:
        """All argv occurrences of a repeatable key (the reference allows
        repeated ``mock=r,v,s,n`` params, allreduce_mock.h:38-44). Stored
        semicolon-joined under the hood."""
        v = self.get(key)
        return [] if v is None else v.split(";")

    def append(self, key: str, value: str) -> None:
        cur = self.get(key)
        self.set(key, value if cur is None else cur + ";" + value)

    def as_args(self) -> List[str]:
        return [f"{k}={v}" for k, v in sorted(self._values.items())]

    def __contains__(self, key: str) -> bool:
        return self._norm(key) in self._values
