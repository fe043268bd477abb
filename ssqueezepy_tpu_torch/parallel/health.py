# -*- coding: utf-8 -*-
"""Multi-rank failure detection and recovery hooks.

Counterpart of `ssqueezepy_tpu/parallel/health.py`. The failure that
matters across ranks is a lost peer: every collective then blocks until
its group's timeout, so liveness cannot be observed from inside the hung
step. Hence

  1. a collective heartbeat: a one-element `all_reduce(async_op=True)`
     over every rank of the mesh, waited on a side thread under a
     wall-clock timeout, so that the caller's thread never wedges; if a
     rank is gone it cannot complete, and the timeout fires on every
     surviving rank;
  2. fail-fast and a supervisor's restart: the transforms keep no state
     between calls but the streaming plans', which save and restore it
     (`state_dict` / `load_state`), so recovery is a rerun on a reformed
     world.

The heartbeat runs on a process group of its own (gloo, on a CPU tensor),
made collectively when the monitor is made (or at the first
`collective_heartbeat` of a mesh, which every rank must then make): a
beat from the monitor's thread then never interleaves with a transform's
collectives on the mesh's groups (ranks would issue those in different
orders and hang), and it puts no work on a card's streams. Each rank
issues the same sequence of beats; a rank that misses beats stalls its
peers' beats until it catches up.
"""
import datetime
import logging
import os
import threading
import time

import torch
import torch.distributed as dist

from .distributed import GROUP_TIMEOUT_S

__all__ = ['collective_heartbeat', 'HealthMonitor']

_GROUPS = {}


def heartbeat_group(mesh):
    """The heartbeat's own gloo group over every rank of `mesh`, made once
    per mesh (collectively: every rank of the world calls it)."""
    key = id(mesh)
    hit = _GROUPS.get(key)
    if hit is None or hit[0] is not mesh:
        if len(_GROUPS) >= 8:            # meshes are few and long-lived
            _GROUPS.clear()
        hit = _GROUPS[key] = (mesh, dist.new_group(
            ranks=sorted(mesh.mesh.flatten().tolist()), backend='gloo',
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S)))
    return hit[1]


def collective_heartbeat(mesh, timeout=10.0, group=None):
    """One all-rank sum over `mesh` (on `group`, by default its heartbeat
    group) under a wall-clock timeout. Returns ``(ok, seconds or None)``:
    ok=False means it did not complete within `timeout` (the sign of a
    lost or partitioned peer) or did not count every rank. A beat that
    completes after its timeout is harmless."""
    group = group if group is not None else heartbeat_group(mesh)
    t = torch.ones(1)
    t0 = time.monotonic()
    work = dist.all_reduce(t, group=group, async_op=True)
    done, err = threading.Event(), []

    def wait():
        try:
            work.wait()
        except Exception as e:           # the group's timeout, a lost peer
            err.append(e)
        done.set()

    threading.Thread(target=wait, daemon=True).start()
    if not done.wait(timeout) or err:
        return False, None
    if int(t.item()) != dist.get_world_size(group):
        return False, None
    return True, time.monotonic() - t0


class HealthMonitor:
    """Background mesh-liveness monitor, made on every rank.

    >>> mon = HealthMonitor(mesh, interval=30, timeout=10,
    ...                     max_failures=2, on_failure=HealthMonitor.EXIT)
    >>> mon.start()
    ... # the transform loop ...
    >>> mon.stop()

    `on_failure(monitor)` fires after `max_failures` CONSECUTIVE heartbeat
    timeouts (one slow step does not trip it). `EXIT` ends the process
    with status 42, the fail-fast half of a supervisor's restart. A
    heartbeat that succeeds resets the count, re-arms the trip and records
    its latency in `last_latency`. `heartbeat`, a callable returning
    (ok, seconds), replaces the collective one (no group is made then)."""

    @staticmethod
    def EXIT(monitor):                    # pragma: no cover - terminates
        logging.getLogger(__name__).error(
            "mesh heartbeat failed %d times; exiting for supervisor "
            "restart", monitor.failures)
        os._exit(42)

    def __init__(self, mesh, interval=30.0, timeout=10.0, max_failures=2,
                 on_failure=None, heartbeat=None):
        self.mesh = mesh
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.max_failures = int(max_failures)
        self.on_failure = on_failure or self._log_failure
        if heartbeat is None:
            group = heartbeat_group(mesh)

            def heartbeat():
                return collective_heartbeat(mesh, self.timeout, group)
        self._heartbeat = heartbeat
        self.failures = 0
        self.beats = 0
        self.last_latency = None
        self.tripped = False
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _log_failure(monitor):
        logging.getLogger(__name__).error(
            "mesh heartbeat failed %d consecutive times (mesh=%s): a peer "
            "is likely lost; collectives will hang", monitor.failures,
            getattr(monitor.mesh, 'shape', None))

    def poll_once(self):
        """One heartbeat now (also used by the loop). Returns ok."""
        ok, dt = self._heartbeat()
        self.beats += 1
        if ok:
            self.failures = 0
            self.tripped = False          # recovery re-arms the trip
            self.last_latency = dt
        else:
            self.failures += 1
            if self.failures >= self.max_failures and not self.tripped:
                self.tripped = True
                self.on_failure(self)
        return ok

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.poll_once()

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
