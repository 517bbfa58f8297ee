"""Worker log capture and the tail to the driver (counterpart of
``ray_tpu/_private/log_monitor.py``).

- each worker process points fds 1 and 2 at
  ``<log_dir>/worker-<pid>.{out,err}`` when it boots (worker_process.py);
- a ``LogMonitor`` thread in the host process (the driver, or a node
  daemon in the cluster) tails the directory and hands new lines to a
  sink;
- the driver prints them as ``(worker pid=N) line``; daemons forward their
  lines over the wire (the ``worker_log`` push), and the driver prints
  those as ``(worker node=XX pid=N) line``.

Disable with ``RAY_TPU_LOG_TO_DRIVER=0`` (worker output then goes to the
parent's terminal as before).
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Tuple

_FILE_RE = re.compile(r"worker-(\d+)\.(out|err)$")

# A daemon's worker writes this, then a driver's token, as a line of its own
# whenever a thread of another driver than the last line's writes to the
# stream: the lines that follow belong to that driver (an empty token: to
# every attached driver). The monitor hands the token to ``on_owner`` and
# never passes the marker on as output.
OWNER_MARK = "\x1eray_tpu_torch:owner="


class OwnerMarkedStream:
    """Worker side: a text stream that puts an owner marker before a write
    whose thread's driver (``owner()``) differs from the last write's. A
    marker after a write without a newline starts a line of its own."""

    def __init__(self, raw, owner: Callable[[], Optional[str]]):
        self._raw = raw
        self._owner = owner
        self._last = ""         # no marker yet: every attached driver
        self._at_line_start = True
        self._lock = threading.RLock()

    def write(self, text: str) -> int:
        own = self._owner() or ""
        with self._lock:
            if own != self._last:
                self._raw.write(("" if self._at_line_start else "\n")
                                + OWNER_MARK + own + "\n")
                self._last = own
                self._at_line_start = True
            n = self._raw.write(text)
            if text:
                self._at_line_start = text.endswith("\n")
            return n

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    def __getattr__(self, name):
        return getattr(self._raw, name)


_session_dir: Optional[str] = None
_session_lock = threading.Lock()


def log_to_driver_enabled() -> bool:
    from ray_tpu_torch._private.config import cfg
    return cfg().log_to_driver


def session_log_dir(create: bool = True) -> Optional[str]:
    """This process's worker-log directory (one per driver/daemon)."""
    global _session_dir
    with _session_lock:
        if _session_dir is None and create:
            from ray_tpu_torch._private.config import cfg
            _session_dir = cfg().log_dir
            if not _session_dir:
                # a dir of this process's own, removed at its exit
                _session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_logs_")
                import atexit
                import shutil
                atexit.register(shutil.rmtree, _session_dir, True)
            os.makedirs(_session_dir, exist_ok=True)
        return _session_dir


def set_session_log_dir(path: str) -> None:
    global _session_dir
    os.makedirs(path, exist_ok=True)
    with _session_lock:
        _session_dir = path


def redirect_process_output(
        log_dir: str, owner: Optional[Callable[[], Optional[str]]] = None
) -> None:
    """Point THIS process's fds 1/2 at per-pid log files (worker boot).
    fd-level dup2 so C/extension writes land there too; line-buffered so
    the monitor sees prints promptly. With ``owner`` (the calling thread's
    driver token), ``sys.stdout``/``sys.stderr`` mark each change of
    driver (``OwnerMarkedStream``)."""
    import sys

    pid = os.getpid()
    for stream, name in ((sys.stdout, "out"), (sys.stderr, "err")):
        path = os.path.join(log_dir, f"worker-{pid}.{name}")
        fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        try:
            stream.flush()
        except Exception:
            pass
        os.dup2(fd, stream.fileno())
        os.close(fd)
    try:
        sys.stdout.reconfigure(line_buffering=True)
        sys.stderr.reconfigure(line_buffering=True)
    except Exception:
        pass
    if owner is not None:
        sys.stdout = OwnerMarkedStream(sys.stdout, owner)
        sys.stderr = OwnerMarkedStream(sys.stderr, owner)


class LogMonitor:
    """Tails ``worker-*.{out,err}`` files in a directory, delivering each
    new complete line to ``sink(pid, stream, line)``, and each owner marker's
    token to ``on_owner(pid, stream, token)``."""

    def __init__(self, log_dir: str,
                 sink: Callable[[int, str, str], None],
                 interval: float = 0.2, start_at_end: bool = False,
                 on_owner: Optional[Callable[[int, str, str], None]] = None):
        self.log_dir = log_dir
        self.sink = sink
        self.on_owner = on_owner
        self.interval = interval
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, str] = {}
        self._gone: List[int] = []      # pids whose owner to forget
        if start_at_end:
            # Skip lines from a previous runtime in this process (the
            # worker pool and its log files outlive init/shutdown).
            try:
                for name in os.listdir(log_dir):
                    if _FILE_RE.search(name):
                        try:
                            self._offsets[name] = os.path.getsize(
                                os.path.join(log_dir, name))
                        except OSError:
                            pass
            except OSError:
                pass
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="log-monitor")
        self._thread.start()

    def stop(self) -> None:
        """Stop and join: the loop's final drain runs on the monitor
        thread, so callers never race it with their own poll_once()."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def forget(self, pid: int) -> None:
        """A worker died: after the scan that reads its last lines, its
        files' owner is reset (``on_owner(pid, stream, "")``)."""
        self._gone.append(pid)

    def poll_once(self) -> None:
        """One scan (also used directly by tests for determinism)."""
        gone, self._gone = self._gone, []
        try:
            self._scan()
        finally:
            if self.on_owner is not None:
                for pid in gone:
                    for stream in ("out", "err"):
                        self.on_owner(pid, stream, "")

    def _scan(self) -> None:
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return
        for name in names:
            m = _FILE_RE.search(name)
            if not m:
                continue
            pid, stream = int(m.group(1)), m.group(2)
            path = os.path.join(self.log_dir, name)
            off = self._offsets.get(name, 0)
            try:
                with open(path, "r", errors="replace") as f:
                    f.seek(off)
                    chunk = f.read()
                    self._offsets[name] = f.tell()
            except OSError:
                continue
            if not chunk:
                continue
            chunk = self._partial.pop(name, "") + chunk
            lines = chunk.split("\n")
            if lines and lines[-1]:
                self._partial[name] = lines[-1]   # incomplete tail
            for line in lines[:-1]:
                if not line:
                    continue
                try:
                    # a marker after a write of C code without a newline
                    # ends that line: its text goes before the new owner
                    at = line.find(OWNER_MARK)
                    if at < 0:
                        self.sink(pid, stream, line)
                        continue
                    if at > 0:
                        self.sink(pid, stream, line[:at])
                    if self.on_owner is not None:
                        self.on_owner(pid, stream,
                                      line[at + len(OWNER_MARK):])
                except Exception:
                    pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()
        self.poll_once()  # final drain


def make_driver_printer(node_tag: str = ""
                        ) -> Callable[[int, str, str], None]:
    """The driver-side sink: reference ``print_worker_logs`` format."""
    import sys

    prefix = f"{node_tag}, " if node_tag else ""

    def sink(pid: int, stream: str, line: str) -> None:
        out = sys.stderr if stream == "err" else sys.stdout
        print(f"(worker {prefix}pid={pid}) {line}", file=out)

    return sink
