"""Fault-tolerant training supervisor (``repro/launch/supervisor.py``).

Every trainer runs under a supervisor that (a) restarts a crashed trainer,
which resumes from the latest checkpoint, (b) detects hangs through a
heartbeat file (stragglers and partitions look like silence, not crashes),
and (c) bounds restart storms with a budget. The trainer is
``python -m repro_torch.launch.train``; the arguments after ``--`` go to it.

Fault injection for drills and tests: ``--fail-at-step N`` makes the
trainer raise mid-run; the supervisor must resume it to completion.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


class Supervisor:
    def __init__(self, cmd: list[str], *, heartbeat_path: str,
                 hang_timeout: float = 600.0, max_restarts: int = 5,
                 poll_s: float = 1.0):
        self.cmd = cmd
        self.heartbeat_path = heartbeat_path
        self.hang_timeout = hang_timeout
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.restarts = 0
        self.events: list[str] = []

    def _heartbeat_age(self) -> float:
        try:
            return time.time() - os.path.getmtime(self.heartbeat_path)
        except OSError:
            return 0.0

    def run(self) -> int:
        while True:
            self.events.append(f"launch attempt {self.restarts + 1}")
            proc = subprocess.Popen(self.cmd)
            rc = None
            while rc is None:
                time.sleep(self.poll_s)
                rc = proc.poll()
                if rc is None and self._heartbeat_age() > self.hang_timeout:
                    self.events.append("hang detected (heartbeat stale); killing")
                    proc.kill()
                    proc.wait()
                    rc = -9
            if rc == 0:
                self.events.append("trainer exited cleanly")
                return 0
            self.restarts += 1
            self.events.append(f"trainer died rc={rc}; restart {self.restarts}")
            if self.restarts > self.max_restarts:
                self.events.append("restart budget exhausted")
                return rc
            # resume comes free: the trainer always restores the latest checkpoint


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hang-timeout", type=float, default=600.0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--heartbeat",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_heartbeat"))
    ap.add_argument("trainer_args", nargs=argparse.REMAINDER,
                    help="-- args passed to repro_torch.launch.train")
    args = ap.parse_args()
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--heartbeat", args.heartbeat] + [a for a in args.trainer_args if a != "--"]
    sup = Supervisor(cmd, heartbeat_path=args.heartbeat,
                     hang_timeout=args.hang_timeout, max_restarts=args.max_restarts)
    rc = sup.run()
    for e in sup.events:
        print(f"[supervisor] {e}")
    sys.exit(rc)


if __name__ == "__main__":
    main()
