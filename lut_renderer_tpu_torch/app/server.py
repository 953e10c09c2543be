"""Warm render service: a long-lived daemon over the task queue.

The port's counterpart of lut_renderer_tpu/app/server.py, with the same
protocol and client: one process owns the card, keeps the built kernels,
the render functions and the uploaded LUTs warm, and accepts jobs over a
Unix domain socket so per-job cost is pure render time instead of process
startup and kernel build. It differs in one place: ``QueueServer`` takes
the render ``device`` and hands it to the port's TaskManager.

Protocol: JSON lines (one request object per line, one response per line).

  {"op": "submit", "files": [...], "lut": "look.cube",
   "params": {...ProcessingParams fields...}, "out_dir": "...",
   "master_dir": "..."}                -> {"ok": true, "task_ids": [...],
                                           "logs": [...], "warnings": [...]}
  {"op": "status"}                     -> {"ok": true, "tasks": [...],
                                           "queue_progress": N,
                                           "lut_cache": {"hits", "misses",
                                           "evictions", "entries"},
                                           "launches_by_interp": {interp:
                                           N} (kernel B on the card since
                                           the process started; only once
                                           it has launched)}
  {"op": "status", "task_id": "..."}   -> single-task view incl. "logs":
                                          the runtime log tail (policy
                                          decision notes, stage progress,
                                          errors — what the CLI prints)
  {"op": "cancel", "task_id": "..."}   -> {"ok": true}
  {"op": "config", "concurrency": N}   -> {"ok": true, "concurrency": N}
                                          (live, clamped to the reference's
                                          1-16 spinner range)
  {"op": "ping"}                       -> {"ok": true, "tasks": N}
  {"op": "shutdown"}                   -> {"ok": true} then the server stops
                                          accepting; running tasks cancel

Start via `python -m lut_renderer_tpu_torch.app.cli serve --socket PATH`;
drive ad hoc with its `client --socket PATH '<json>'` or any socket
client.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from pathlib import Path
from typing import Optional

from ..models import ProcessingParams
from ..ops import fused420
from ..tasks import TaskManager
from ..tasks.runner import lut_cache_stats
from .defaults import mode_template
from .taskfactory import create_tasks


def _task_view(task) -> dict:
    return {
        "task_id": task.task_id,
        "name": task.display_name(),
        "source": str(task.source_path),
        "output": str(task.output_path),
        "status": task.status.value,
        "progress": task.progress,
        "error": task.error,
    }


class QueueServer:
    """Owns a TaskManager and serves the JSON-lines protocol. ``device``
    is the render device ("cuda", "cuda:N" or "cpu"); ``lut_strategy`` is
    accepted for parity with the JAX server."""

    def __init__(self, socket_path, max_concurrency: int = 1,
                 lut_strategy: str = "mxu", queue_file=None,
                 device="cuda"):
        self.socket_path = Path(socket_path)
        self.manager = TaskManager(max_concurrency=max_concurrency,
                                   lut_strategy=lut_strategy, device=device)
        self._lock = threading.Lock()
        self._server: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._thread: Optional[threading.Thread] = None
        self.shutdown_requested = threading.Event()
        self._draining = False
        # Per-task runtime log tail (policy decision notes, stage progress,
        # errors) so daemon clients can read the notes the CLI prints — the
        # reference surfaces these in its task detail dialog. Bounded.
        self._task_logs: dict = {}
        self.manager.task_log.connect(self._record_log)
        # Optional durable queue: restore on start (interrupted RUNNING
        # entries come back PENDING and resume), persist atomically on
        # every task state change — daemon restart/crash recovery for the
        # serving deployment (the reference's in-memory queue dies with
        # the app; SURVEY §5.4). The CLI analog is `render --save-queue`
        # + `resume`.
        self.queue_file = Path(queue_file) if queue_file else None
        self.restore_error = ""
        self._persist_lock = threading.Lock()
        if self.queue_file is not None:
            if self.queue_file.exists():
                try:
                    restored = self.manager.load_queue(self.queue_file)
                except Exception as exc:
                    self.restore_error = f"queue restore failed: {exc}"[:300]
                    # keep the evidence: later persists must not overwrite
                    # the unreadable file
                    try:
                        self.queue_file.replace(
                            self.queue_file.with_name(
                                self.queue_file.name + ".corrupt"))
                    except OSError:
                        pass
                else:
                    if restored:
                        self.manager.start_all()
            self.manager.task_added.connect(lambda *_: self._persist())
            self.manager.task_updated.connect(lambda *_: self._persist())
            self.manager.queue_finished.connect(lambda *_: self._persist())

    def _persist(self) -> None:
        if self.queue_file is None:
            return
        with self._persist_lock:
            try:
                self.manager.save_queue(self.queue_file)
            except OSError:
                pass  # disk hiccup: next state change retries

    _LOG_TAIL = 200

    def _record_log(self, task_id: str, message: str) -> None:
        buf = self._task_logs.setdefault(task_id, [])
        buf.append(message)
        if len(buf) > self._LOG_TAIL:
            del buf[:len(buf) - self._LOG_TAIL]

    # -- request handling -----------------------------------------------------
    def handle_request(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            out = {"ok": True, "tasks": len(self.manager.tasks)}
            if self.restore_error:
                out["restore_error"] = self.restore_error
            return out
        if op == "submit":
            return self._submit(req)
        if op == "status":
            return self._status(req.get("task_id"))
        if op == "cancel":
            task_id = req.get("task_id", "")
            if task_id not in self.manager.tasks:
                return {"ok": False, "error": f"unknown task {task_id!r}"}
            self.manager.cancel_task(task_id)
            return {"ok": True}
        if op == "reprocess":
            # re-enqueue a finished task with a fresh output name and
            # optionally fresh params (reference: _reprocess_selected
            # re-snapshots the full param set — the headless analog is a
            # PARTIAL overlay on the task's current params; building a bare
            # ProcessingParams from the partial dict would resurrect the
            # libx264 dataclass default the submit path already guards
            # against, failing at encode open — caught live-driving serve)
            task_id = req.get("task_id", "")
            params = None
            if req.get("params"):
                task = self.manager.tasks.get(task_id)
                if task is None:
                    return {"ok": False,
                            "error": f"unknown task {task_id!r}"}
                merged = task.params.to_dict()
                merged.update(req["params"])
                params = ProcessingParams.from_dict(merged)
            ok = self.manager.reprocess_task(task_id, params=params)
            if not ok:
                return {"ok": False,
                        "error": f"cannot reprocess {task_id!r} (unknown or "
                                 f"running)"}
            self.manager.start_all()
            return {"ok": True}
        if op == "clear":
            # drop finished tasks from the table (reference: clear_completed)
            before = len(self.manager.tasks)
            self.manager.clear_completed()
            return {"ok": True, "removed": before - len(self.manager.tasks)}
        if op == "config":
            # live queue reconfiguration — the reference's concurrency
            # spinner applies immediately (main_window.py:856-860, UI range
            # 1-16); out-of-range values clamp like the spinner would
            if "concurrency" in req:
                try:
                    value = int(req["concurrency"])
                except (TypeError, ValueError):
                    return {"ok": False,
                            "error": "concurrency must be an integer"}
                self.manager.set_max_concurrency(max(1, min(16, value)))
            return {"ok": True, "concurrency": self.manager.max_concurrency}
        if op == "shutdown":
            # refuse new work at once, but DEFER the shutdown signal: the
            # CLI daemon os._exit()s as soon as wait() wakes, and setting
            # the event here raced the handler's response write — the
            # reply was observably lost in a live drive. Transports pop the
            # private `_then_shutdown` marker and call finalize_shutdown()
            # AFTER flushing the reply (deterministic, however slow the
            # client is); the timer is only a backstop for direct
            # handle_request callers that never flush a transport.
            self._draining = True
            for task_id in list(self.manager.tasks):
                self.manager.cancel_task(task_id)
            timer = threading.Timer(2.0, self.finalize_shutdown)
            timer.daemon = True
            timer.start()
            self._shutdown_timer = timer
            return {"ok": True, "_then_shutdown": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def finalize_shutdown(self) -> None:
        """Signal shutdown and stop accepting. Called by a transport after
        it has flushed the shutdown reply (or by the backstop timer)."""
        timer = getattr(self, "_shutdown_timer", None)
        if timer is not None:
            timer.cancel()
        self.shutdown_requested.set()
        self.stop()

    def _submit(self, req: dict) -> dict:
        if self._draining or self.shutdown_requested.is_set():
            return {"ok": False, "error": "server is shutting down"}
        files = [Path(f) for f in req.get("files", [])]
        if not files:
            return {"ok": False, "error": "no files given"}
        lut = req.get("lut")
        if lut and not Path(lut).exists():
            return {"ok": False, "error": f"LUT not found: {lut}"}
        # Overlay request params on the mode template, exactly like the CLI
        # (app/cli.py): the bare dataclass default is libx264, which the
        # bundled libavcodec does not ship — a client that names no codec
        # must get the first AVAILABLE one, not a guaranteed encode failure.
        req_params = dict(req.get("params") or {})
        base = mode_template(req_params.get("processing_mode", "fast"))
        merged = base.to_dict()
        merged.update(req_params)
        params = ProcessingParams.from_dict(merged)
        try:
            with self._lock:
                batch = create_tasks(
                    files, params,
                    lut_path=Path(lut) if lut else None,
                    out_dir=Path(req["out_dir"]) if req.get("out_dir") else None,
                    master_dir=(Path(req["master_dir"])
                                if req.get("master_dir") else None),
                )
                self.manager.add_tasks(batch.tasks)
                self.manager.start_all()
        except (ValueError, OSError) as exc:
            return {"ok": False, "error": str(exc)}
        return {
            "ok": True,
            "task_ids": [t.task_id for t in batch.tasks],
            "logs": batch.logs,
            "warnings": batch.warnings,
        }

    def _status(self, task_id: Optional[str]) -> dict:
        tasks = self.manager.tasks
        if task_id is not None:
            task = tasks.get(task_id)
            if task is None:
                return {"ok": False, "error": f"unknown task {task_id!r}"}
            view = _task_view(task)
            view["logs"] = list(self._task_logs.get(task_id, []))
            if task.source_info is not None:
                # the probe detail the reference shows in its info dialog
                # (main_window.py:1979-2119), minus empty fields
                import dataclasses

                view["source_info"] = {
                    k: v for k, v in
                    dataclasses.asdict(task.source_info).items()
                    if v not in (None, "", {}, [])
                }
            return {"ok": True, "task": view}
        views = [_task_view(t) for t in tasks.values()]
        agg = (sum(t.progress for t in tasks.values()) // len(tasks)
               if tasks else 0)
        out = {"ok": True, "tasks": views, "queue_progress": agg,
               "lut_cache": lut_cache_stats()}
        kernel_b = {k: n for k, n in fused420.launches_by_interp.items()
                    if n}
        if kernel_b:
            out["launches_by_interp"] = kernel_b
        return out

    # -- socket plumbing -------------------------------------------------------
    def start(self) -> None:
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        resp = outer.handle_request(req)
                    except json.JSONDecodeError as exc:
                        resp = {"ok": False, "error": f"bad json: {exc}"}
                    except Exception as exc:  # never kill the connection
                        resp = {"ok": False, "error": str(exc)[:300]}
                    then_shutdown = (isinstance(resp, dict)
                                     and resp.pop("_then_shutdown", False))
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode("utf-8"))
                    self.wfile.flush()
                    if then_shutdown:
                        # reply is on the wire: now the signal is race-free
                        outer.finalize_shutdown()
                        return

        self.socket_path.parent.mkdir(parents=True, exist_ok=True)
        if self.socket_path.exists():
            self.socket_path.unlink()
        srv = socketserver.ThreadingUnixStreamServer(str(self.socket_path),
                                                     Handler)
        srv.daemon_threads = True
        self._server = srv
        self._thread = threading.Thread(target=srv.serve_forever,
                                        name="lut-torch-serve", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._persist()  # final state (no-op without a queue file)
        with self._lock:  # shutdown-op thread and owner may both call stop
            srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        try:
            self.socket_path.unlink()
        except OSError:
            pass

    def wait(self) -> None:
        """Block until shutdown is requested and the queue drains."""
        self.shutdown_requested.wait()
        self.manager.wait_all(timeout=300)


def request(socket_path, payload: dict, timeout: float = 60.0) -> dict:
    """One-shot client: send a request object, return the response object."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(str(socket_path))
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode("utf-8"))
