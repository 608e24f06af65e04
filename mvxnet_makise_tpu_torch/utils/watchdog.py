"""Stage watchdogs and a salvaging subprocess supervisor for benches.

Port of ``mvxnet_makise_tpu/utils/watchdog.py`` (which imports no JAX;
the port keeps its own copy):

  * :class:`StageWatchdog` — one SIGALRM budget per named stage, so a
    wedged stage is *diagnosed* ("stage 'serve_measure' exceeded 240s"),
    not just killed;
  * a partial-results protocol — the child appends one JSON line to a
    side file the moment each stage's number exists;
  * :func:`supervise` — runs the child, retries once on failure, and
    always returns ONE final record: the child's final result when it
    finishes, otherwise the newest salvaged partial (flagged
    ``"partial": true`` with the failure reason), otherwise an error
    record.  The caller decides the exit code from it
    (``tools/bench.py`` exits nonzero on anything but a full result).

The records carry no ``vs_baseline``: the port's bench has no target
rate.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence


class StageStall(SystemExit):
    """Raised (as an exit) when a stage exceeds its budget."""


class StageWatchdog:
    """Sequential per-stage SIGALRM budgets.

    Usage::

        wd = StageWatchdog({"compile": 600, "measure": 240})
        wd.enter("compile"); ...; wd.enter("measure"); ...; wd.cancel()

    On expiry the handler prints an error JSON naming the stage and
    exits with code 2 (the supervisor's retry/salvage trigger).  The
    ``BENCH_FORCE_STALL=<stage>`` env var makes ``enter(stage)`` sleep
    past its budget — the forced-stall hook the tests use.
    """

    def __init__(self, budgets: Dict[str, int], metric: str,
                 default_budget: int = 300):
        self.budgets = dict(budgets)
        self.default_budget = default_budget
        self.metric = metric
        self.stage = "<init>"
        self._t0 = time.time()
        signal.signal(signal.SIGALRM, self._fire)

    def _fire(self, signum, frame):
        print(json.dumps({
            "metric": self.metric, "value": 0.0, "unit": "frames/s",
            "error": f"watchdog: stage '{self.stage}' exceeded "
                     f"{self.budgets.get(self.stage, self.default_budget)}s",
            "stage": self.stage,
            "elapsed_s": round(time.time() - self._t0, 1),
        }), flush=True)
        raise StageStall(2)

    def enter(self, stage: str) -> None:
        self.stage = stage
        signal.alarm(int(self.budgets.get(stage, self.default_budget)))
        if os.environ.get("BENCH_FORCE_STALL") == stage:
            # test hook: wedge inside this stage until the alarm fires
            while True:
                time.sleep(1)

    def cancel(self) -> None:
        signal.alarm(0)


class PartialWriter:
    """Append-one-JSON-line-per-completed-stage side channel."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def emit(self, record: dict) -> None:
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())


def _read_partials(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
    except OSError:
        pass
    return out


def _last_json_line(text: str) -> Optional[dict]:
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def supervise(child_cmd: Sequence[str], *, metric: str,
              attempt_timeout: int, retries: int = 1,
              partial_env: str = "BENCH_PARTIALS") -> dict:
    """Run ``child_cmd`` (+ retries), salvage partials, return ONE record.

    The child receives the partials path via ``partial_env`` and must
    append stage results there as they land; its final result is its
    last stdout JSON line.  Success on any attempt returns that final
    record.  Otherwise the newest salvaged partial is returned with
    ``partial: true`` and the failure reason, and only if no stage ever
    produced a number does an error record come back.
    """
    errors: List[str] = []
    partials: List[dict] = []
    for attempt in range(retries + 1):
        fd, ppath = tempfile.mkstemp(prefix="bench_partials_",
                                     suffix=".jsonl")
        os.close(fd)
        env = dict(os.environ, **{partial_env: ppath})
        try:
            proc = subprocess.run(
                list(child_cmd), env=env, timeout=attempt_timeout,
                capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            final = _last_json_line(proc.stdout)
            partials.extend(_read_partials(ppath))
            if proc.returncode == 0 and final is not None \
                    and "error" not in final:
                if attempt or errors:
                    final = dict(final, retried=attempt)
                return final
            reason = (final or {}).get(
                "error", f"child exited rc={proc.returncode}")
            errors.append(f"attempt {attempt}: {reason}")
        except subprocess.TimeoutExpired:
            partials.extend(_read_partials(ppath))
            errors.append(f"attempt {attempt}: supervisor timeout "
                          f"after {attempt_timeout}s")
        finally:
            try:
                os.unlink(ppath)
            except OSError:
                pass
    if partials:
        best = partials[-1]
        return dict(best, partial=True,
                    error="; ".join(errors),
                    salvaged_from=best.get("metric", metric))
    return {"metric": metric, "value": 0.0, "unit": "frames/s",
            "error": "; ".join(errors)}
