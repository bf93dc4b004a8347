"""ascii-query: attach-to-live-PID inspector (ascii-query-server analog).

The reference tool attaches LLDB to a running ascii-chat process and serves
variable inspection over HTTP (src/tooling/query/main.cpp:1-60). This is
the same role without a debugger on the box, against a process that was
NOT started with `--inspect-port`:

- kernel-side state straight from /proc — works on ANY pid with no
  cooperation at all: status (State/FDSize/VmRSS/Threads), per-task kernel
  stacks + wchan (what each thread is blocked in, even for a fully hung
  process), current syscall, open fds;
- Python-level thread stacks via the ambient SIGUSR1 faulthandler channel
  every asciichat process registers at startup (utils/dumps.py) — the dump
  is written at C signal level without the GIL, so it works when all
  Python threads are deadlocked.

Modes: one-shot report to stdout, or `--serve PORT` for the HTTP surface
(/, /status, /kstacks, /pystacks, /fds), mirroring the reference's server.

The port's copy of ``asciichat_tpu/apps/query.py``, which reads
the port's dump file (``utils/dumps.py``). One change: where /proc reports
no signal dispositions (no SigCgt line, as under some user-space kernels), the
JAX package's copy never signals and so never returns Python stacks; this
one takes the line that the target appends to its own dump file once its
handler is registered (``dumps.registered_line``), written since the target
started, as the sign that the channel is registered (:func:`_catches_sigusr1`).
"""

from __future__ import annotations

import json
import os
import signal
import stat
import time

from asciichat_tpu_torch.utils.dumps import dump_path, registered_line


def _read(path: str) -> str:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def proc_status(pid: int) -> dict:
    """Selected /proc/<pid>/status fields + cmdline."""
    fields = {}
    for line in _read(f"/proc/{pid}/status").splitlines():
        k, _, v = line.partition(":")
        if k in ("Name", "State", "Threads", "VmRSS", "VmSize", "FDSize"):
            fields[k] = v.strip()
    cmdline = _read(f"/proc/{pid}/cmdline").replace("\0", " ").strip()
    return {"pid": pid, "cmdline": cmdline, **fields}


def kernel_stacks(pid: int) -> dict:
    """Per-task kernel stacks + wchan: where each thread sits in the kernel
    (futex_wait, poll_schedule_timeout, ...) — readable for hung processes
    that cannot run any userspace code at all."""
    tasks = {}
    try:
        tids = sorted(int(t) for t in os.listdir(f"/proc/{pid}/task"))
    except OSError:
        return {}
    for tid in tids:
        base = f"/proc/{pid}/task/{tid}"
        name = ""
        for line in _read(f"{base}/status").splitlines():
            if line.startswith("Name:"):
                name = line.split(":", 1)[1].strip()
                break
        tasks[str(tid)] = {
            "name": name,
            "wchan": _read(f"{base}/wchan") or "?",
            "syscall": _read(f"{base}/syscall").strip(),
            "kstack": [ln.strip() for ln in _read(f"{base}/stack").splitlines()],
        }
    return tasks


def open_fds(pid: int) -> dict:
    fds = {}
    try:
        for fd in sorted(os.listdir(f"/proc/{pid}/fd"), key=int):
            try:
                fds[fd] = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                fds[fd] = "?"
    except OSError:
        pass
    return fds


def _looks_like_asciichat(pid: int) -> bool:
    """Cheap identity check before signalling: a mistyped pid that happens
    to catch SIGUSR1 (nginx/postgres reopen logs on it) would perform its
    REAL handler action as a side effect of mere inspection."""
    cmdline = _read(f"/proc/{pid}/cmdline").replace("\0", " ")
    return "asciichat" in cmdline or "ascii-chat" in cmdline


def _target_dump_path(pid: int) -> str:
    """The dump file as the TARGET resolved it: dumps.py uses the target's
    tempfile.gettempdir(), so a target started with its own TMPDIR writes
    somewhere this process's gettempdir() never looks. Mirror the stdlib
    lookup order against /proc/<pid>/environ; fall back to our own view
    when environ is unreadable (different user)."""
    env = _read(f"/proc/{pid}/environ")
    if env:
        entries = dict(e.split("=", 1) for e in env.split("\0") if "=" in e)
        for var in ("TMPDIR", "TEMP", "TMP"):  # tempfile.gettempdir() order
            d = entries.get(var)
            if d:
                return os.path.join(d, f"asciichat-dump-{pid}.txt")
    return dump_path(pid)


def _catches_sigusr1(pid: int) -> bool:
    """True iff the target has a SIGUSR1 handler installed (SigCgt bit in
    /proc/<pid>/status). MUST be checked before signalling: SIGUSR1's
    default disposition is Term, so poking a process that never registered
    the faulthandler channel (non-asciichat pid, or dumps.py's best-effort
    registration failed) would KILL the process this tool exists to
    inspect. Where /proc reports no SigCgt line at all, the target's dump
    file decides (:func:`_dump_channel_opened`)."""
    status = _read(f"/proc/{pid}/status")
    for line in status.splitlines():
        if line.startswith("SigCgt:"):
            try:
                mask = int(line.split(":", 1)[1].strip(), 16)
            except ValueError:
                return False
            return bool(mask & (1 << (signal.SIGUSR1 - 1)))
    return bool(status) and _dump_channel_opened(pid)


def _start_time(pid: int) -> float | None:
    """The target's start on the wall clock: its starttime (clock ticks
    after boot, field 22 of /proc/<pid>/stat) plus the boot time (btime of
    /proc/stat, whole seconds, so at most 1 s early); None where either is
    unreadable."""
    btime = [line.split()[1] for line in _read("/proc/stat").splitlines()
             if line.startswith("btime ")]
    try:
        ticks = int(_read(f"/proc/{pid}/stat").rsplit(")", 1)[1].split()[19])
        return int(btime[0]) + ticks / os.sysconf("SC_CLK_TCK")
    except (IndexError, ValueError, OSError):
        return None


def _dump_channel_opened(pid: int) -> bool:
    """True iff the target's dump file is a regular file of the target's
    uid, written no earlier than the target started, that holds the target's
    :func:`dumps.registered_line`: the channel appends it only once the
    handler is registered, so neither a file that a failed registration
    created nor one left by an earlier process of the same pid passes."""
    uid = [line.split()[1] for line in _read(f"/proc/{pid}/status").splitlines()
           if line.startswith("Uid:")]
    start = _start_time(pid)
    path = _target_dump_path(pid)
    try:
        st = os.lstat(path)
    except OSError:
        return False
    return (stat.S_ISREG(st.st_mode) and bool(uid) and str(st.st_uid) == uid[0]
            and start is not None and st.st_mtime >= start
            and registered_line(pid) in _read(path).splitlines(keepends=True))


def python_stacks(pid: int, timeout: float = 5.0, force: bool = False) -> str:
    """Trigger the ambient SIGUSR1 faulthandler dump and return the new
    content of the per-pid dump file ('' if the process never registered
    the channel, is not an asciichat process, or does not respond)."""
    if not _catches_sigusr1(pid):
        return ""  # no handler: signalling would terminate the target
    if not force and not _looks_like_asciichat(pid):
        return ""  # don't fire foreign SIGUSR1 handlers (--force overrides)
    path = _target_dump_path(pid)
    try:
        before = os.path.getsize(path)
    except OSError:
        before = 0
    try:
        os.kill(pid, signal.SIGUSR1)
    except (OSError, ProcessLookupError):
        return ""
    deadline = time.monotonic() + timeout
    grown = 0
    while time.monotonic() < deadline:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size > before:
            # wait until the dump STOPS growing (two stable polls): a
            # fixed grace can truncate a many-threaded dump mid-write on
            # a loaded 1-core box, silently omitting the deadlocked thread
            if size == grown:
                try:
                    with open(path, "rb") as f:
                        f.seek(before)
                        return f.read().decode(errors="replace")
                except OSError:
                    return ""
            grown = size
        time.sleep(0.05)
    return ""


def collect(pid: int, force: bool = False) -> dict:
    """Full attach report for a live pid."""
    return {
        "status": proc_status(pid),
        "kstacks": kernel_stacks(pid),
        "fds": open_fds(pid),
        "pystacks": python_stacks(pid, force=force),
    }


def serve(pid: int, port: int, host: str = "127.0.0.1", force: bool = False):
    """HTTP surface over a live pid (the query-server shape). Returns the
    bound server; caller runs serve_forever/shutdown."""
    import http.server

    routes = {
        "/": lambda: collect(pid, force),
        "/status": lambda: proc_status(pid),
        "/kstacks": lambda: kernel_stacks(pid),
        "/fds": lambda: open_fds(pid),
        "/pystacks": lambda: {"dump": python_stacks(pid, force=force)},
    }

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            fn = routes.get(self.path)
            if not fn:
                self.send_response(404)
                self.end_headers()
                return
            try:
                body = json.dumps(fn(), indent=2).encode()
                code = 200
            except Exception as e:  # target vanished mid-collect, etc.:
                # a clean 500 beats a dropped socket with no status line
                body = json.dumps({"error": repr(e)}).encode()
                code = 500
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(args) -> int:
    pid = args.pid
    if not os.path.isdir(f"/proc/{pid}"):
        print(f"no such process: {pid}")
        return 1
    force = getattr(args, "force", False)
    if args.serve is not None:
        httpd = serve(pid, args.serve, force=force)
        print(f"ascii-query serving pid {pid} on "
              f"http://127.0.0.1:{httpd.server_address[1]}/")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    report = collect(pid, force)
    print(json.dumps(report, indent=2))
    return 0
